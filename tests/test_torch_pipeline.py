"""The port's pipeline (`launch.pipeline`) against its own one-process step,
over gloo on the CPU: worlds of 2, 4 and 8 ranks, each started once
(`tests/pipeline_worker.py`, a module fixture), and a world of one in this
process.

Every scenario: `tests/mesh_worker.py`'s 3 steps of the pipeline's 8 x 32
batches from the smoke config's seed-0 draws at `common.fan_in_init`,
AdamW at lr 1e-3, q_block 16, 4 microbatches, held to the one-process
`make_train_step` (grad_accum 1: the same function, the cross entropy
over the whole batch), and `pp_forward`'s logits of the first batch to
`lm.forward`'s (no remat):

  * world 2: yi-6b and smollm-360m (tied embeddings: stage 0's lookup and
    the last stage's unembedding add into one leaf) on 2 stages;
  * world 4: yi-6b at 4 layers on 4 stages, yi-6b at 2 x 2 x 1 stage x
    data, smollm at 2 x 1 x 2 stage x model (its 3 heads and 1 kv head do
    not divide 2: its attention computes whole, its MLP width and
    vocabulary split);
  * world 8: yi-6b at 2 x 2 x 2 stage x data x model, the mesh whose
    reference aborts XLA:CPU (`tests/pipeline_reference.py`);
  * world 1 (this process): one stage, ("stage",) and 1 x 1 x 1, the
    card's phase 4s at smoke size.

Each in float32 (the parameters cast, AdamW handing them back in f32),
where the pipeline can only differ by the order of f32 sums: the metrics
{loss, grad_norm, lr} within 1e-5 relative and every leaf of the
parameters, master, m and v within 1e-4 relative L2; and in bf16 within
`tests/test_torch_mesh_step.py`'s bounds (`mesh_worker.check`): the
metrics within 2e-3, parameters and master 1.5e-2 relative L2 (2e-2 for
the leaves summed over every token), m and v 2.5e-2.  A stage's group
gradients add over its 4 microbatches in f32, where the one process takes
one bf16 gradient of the whole batch; CHANGES.md records the readings.
The logits: bitwise where no `model` axis splits a product; on a model
axis of 2 within 1e-6 (f32) or one bf16 ulp (bf16) of the largest.

Then the stage moves on 2 and 4 stages (`parallel.stage_hop` forward and
backward, `from_last_stage`), and the refusals: the MoE, SSM, hybrid and
encoder-decoder archs, groups that do not split over the stages, rows
that do not split into the microbatches (over the data ranks), and a
differentiable `pp_forward` across stages.
"""

import numpy as np
import pytest

from tests import mesh_worker as mw
from tests import pipeline_worker as pw
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

DTYPES = ("float32", "bfloat16")
WORLD2 = [("yi-6b", "2", None), ("smollm-360m", "2", None)]
WORLD4 = [("yi-6b", "4", 4), ("yi-6b", "2x2x1", None), ("smollm-360m", "2x1x2", None)]
WORLD8 = [("yi-6b", "2x2x2", None)]
LOGITS_F32, LOGITS_BF16 = 1e-6, 2 ** -8      # of the largest logit, on a model axis


def _job(case, dtype):
    arch, layout, n_layers = case
    return f"pp:{arch}:{layout}:{dtype}" + (f":{n_layers}" if n_layers else "")


def _ids(case):
    return "-".join(str(c) for c in case if c)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return pw.launch(2, tmp_path_factory.mktemp("pp2") / "out.pkl",
                     [_job(c, d) for c in WORLD2 for d in DTYPES] + ["hop", "refusals"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return pw.launch(4, tmp_path_factory.mktemp("pp4") / "out.pkl",
                     [_job(c, d) for c in WORLD4 for d in DTYPES] + ["hop", "refusals"])


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return pw.launch(8, tmp_path_factory.mktemp("pp8") / "out.pkl",
                     [_job(c, d) for c in WORLD8 for d in DTYPES])


def check(got, case, dtype):
    arch, layout, n_layers = case
    want = pw.one_process(arch, dtype, n_layers)
    mw.check(got, want, dtype)
    assert [sorted(m) for m in got["metrics"]] == [sorted(pw.PP_METRICS)] * mw.STEPS
    model = pw.pp_layout(layout)[2]
    if model == 1:
        np.testing.assert_array_equal(got["logits"], want["logits"])
    else:
        tol = LOGITS_F32 if dtype == "float32" else LOGITS_BF16
        assert np.abs(got["logits"] - want["logits"]).max() <= tol * np.abs(want["logits"]).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WORLD2, ids=_ids)
def test_pipelined_step_matches_one_process_world2(world2, case, dtype):
    check(world2[_job(case, dtype)], case, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WORLD4, ids=_ids)
def test_pipelined_step_matches_one_process_world4(world4, case, dtype):
    check(world4[_job(case, dtype)], case, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WORLD8, ids=_ids)
def test_pipelined_step_matches_one_process_world8(world8, case, dtype):
    check(world8[_job(case, dtype)], case, dtype)


@pytest.mark.parametrize("world", ("world2", "world4"))
def test_stage_hop_and_broadcast(world, request):
    """hop(x) on stage s is stage s - 1's x (a ring) and its gradient the
    next stage's upstream gradient; from_last_stage(x) is the last stage's
    x everywhere."""
    every = request.getfixturevalue(world)["hop"]
    n = len(every)
    for s in range(n):
        mine = every[s]
        np.testing.assert_array_equal(mine["hop"], every[(s - 1) % n]["x"])
        np.testing.assert_array_equal(mine["g_hop"], every[(s + 1) % n]["w"])
        np.testing.assert_array_equal(mine["last"], every[n - 1]["x"])


REFUSED_ARCHS = {"deepseek-v2-lite-16b": "MoE", "deepseek-moe-16b": "MoE",
                 "mamba2-2.7b": "SSM layers", "jamba-v0.1-52b": "MoE",
                 "seamless-m4t-medium": "encoder-decoder"}


@pytest.mark.parametrize("world", ("world2", "world4"))
def test_refusals(world, request):
    out = request.getfixturevalue(world)["refusals"]
    for arch, cause in REFUSED_ARCHS.items():
        for key in (arch, f"forward:{arch}"):
            assert out[key] and arch in out[key] and cause in out[key], (key, out[key])
    n = 2 if world == "world2" else 4
    assert out["groups"] == f"yi-6b-smoke: {n + 1} layer groups do not split over {n} stages"
    for key in ("rows", "step_rows"):
        assert out[key] == ("a batch of 6 rows does not split into 4 microbatches over 1 "
                            "data-parallel ranks")
    assert "not differentiable across stages" in out["differentiable"]
    assert out["data_rows"] == ("batch 12 in 4 microbatches does not divide the 2 "
                                "data-parallel ranks")


# ---- one stage, in this process ---------------------------------------------------------

@pytest.fixture(scope="module")
def world1():
    """The `pp:` jobs on one-stage meshes, here: ("stage",) and 1 x 1 x 1."""
    import torch.distributed as dist
    out = {}
    try:
        for case in (("yi-6b", "1", None), ("smollm-360m", "1x1x1", None)):
            for dtype in DTYPES:
                out[_job(case, dtype)] = pw.run_job(_job(case, dtype))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [("yi-6b", "1", None), ("smollm-360m", "1x1x1", None)],
                         ids=_ids)
def test_one_stage_matches_one_process(world1, case, dtype):
    """At one stage every hop is the identity and no collective runs."""
    check(world1[_job(case, dtype)], case, dtype)
