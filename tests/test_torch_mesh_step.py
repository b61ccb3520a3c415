"""The port's train step on a mesh (`make_train_step(..., mesh=)`) against
its one-process step, over gloo on the CPU.

Each world size's ranks start once (`tests/mesh_worker.py`, a module
fixture) and run every scenario of that size; the one-process steps run
here.  Every scenario: 3 steps of the pipeline's 8 x 32 batches from the
smoke config's seed-0 draws at `common.fan_in_init`, AdamW at lr 1e-3:

  * world 2: yi-6b at 2 x 1 and 1 x 2, grad_accum 1 and 2; smollm-360m at
    1 x 2, whose 3 heads and 1 kv head do not divide 2 (its attention runs
    whole on both model ranks) while its MLP width and vocabulary split;
  * world 4: yi-6b at 2 x 2, grad_accum 1 and 2; mamba2-2.7b,
    seamless-m4t-medium and llava-next-34b at 2 x 2 (the SSD mixer, the
    cross-attention and the frontend projection gather their `model`
    blocks and compute whole, ROADMAP.md §3); DeepSeek-V2-Lite at 2 x 2
    in float32 (its MLA heads and experts split over `model`, the aux
    statistics over the global batch) at a capacity where no pair drops
    (`mesh_worker.smoke_cfg`), so that the mesh's per-rank capacity and
    the one process's compute one function (reading: 2.7e-6).  Its bf16
    run is left to `tests/test_torch_mesh_moe.py`, against the JAX mesh
    step: on DeepSeek's smoke config the one-process bf16 step's own m
    and v move by up to 8.5e-2 against its f32 run and 7.3e-2 between
    grad_accum 2 and 1, beyond the 2.5e-2 below (the mesh's bf16 run read
    2.8e-2 against the one process, m of `w_q_pe`).

The others run twice.  In float32 (the parameters cast, AdamW handing them back
in f32) a sharded step can only differ from the one-process step by f32
sums in another order: every metric within 1e-5 relative and every leaf
of the parameters, the master, m and v within 1e-4 relative L2 (readings:
4.5e-6 at most, mamba2's m of A_log).  In bf16, the training dtype: the
losses and metrics within 2e-3 relative (readings: 1.1e-3 at most,
the pod mesh's grad norm at 4-way data), the parameters and the f32
master within 1.5e-2 relative L2 per leaf (2e-2 for
`tests/train_parity.py`'s SUMMED leaves), as
`tests/test_torch_train_families.py` holds the port to the reference;
m and v within 2.5e-2 (`mesh_worker.check`).  A data-parallel gradient
sums each rank's bf16-rounded part (the reference's GSPMD reduce-scatter
does the same), a split product's backward sums its ranks' parts in f32
where the whole one rounds each part, and after 3 steps these reach m and
v as far as another microbatch count does: the one-process step itself
at grad_accum 2 against 1 differs by up to 1.5e-2 there (yi-6b and smollm
smoke, v of the embedding, on random tokens).  Readings: parameters and
master within 3e-4; m and v up to 1.56e-2 (mamba2's m of A_log).
"""

import pytest

from repro_torch import configs, tree
from repro_torch.launch import steps
from tests import mesh_worker as mw
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

WORLD2 = [("yi-6b", "2x1", 1), ("yi-6b", "2x1", 2), ("yi-6b", "1x2", 1), ("yi-6b", "1x2", 2),
          ("smollm-360m", "1x2", 1)]
WORLD4 = [("yi-6b", "2x2", 1), ("yi-6b", "2x2", 2), ("mamba2-2.7b", "2x2", 1),
          ("seamless-m4t-medium", "2x2", 1), ("llava-next-34b", "2x2", 1)]
WORLD4_F32 = [("deepseek-v2-lite-16b", "2x2", 1)]
DTYPES = ("float32", "bfloat16")


def _job(case, dtype):
    arch, mesh, accum = case
    return f"step:{arch}:{mesh}:{accum}:{dtype}"


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return mw.launch(2, tmp_path_factory.mktemp("mesh2") / "out.pkl",
                     [_job(c, d) for c in WORLD2 for d in DTYPES])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return mw.launch(4, tmp_path_factory.mktemp("mesh4") / "out.pkl",
                     [_job(c, d) for c in WORLD4 for d in DTYPES]
                     + [_job(c, "float32") for c in WORLD4_F32])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WORLD2, ids=lambda c: "-".join(map(str, c)))
def test_sharded_step_matches_one_process_world2(world2, case, dtype):
    arch, _, accum = case
    mw.check(world2[_job(case, dtype)], mw.one_process(arch, accum, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WORLD4, ids=lambda c: "-".join(map(str, c)))
def test_sharded_step_matches_one_process_world4(world4, case, dtype):
    arch, _, accum = case
    mw.check(world4[_job(case, dtype)], mw.one_process(arch, accum, dtype), dtype)


@pytest.mark.parametrize("case", WORLD4_F32, ids=lambda c: "-".join(map(str, c)))
def test_sharded_step_matches_one_process_world4_f32(world4, case):
    arch, _, accum = case
    mw.check(world4[_job(case, "float32")], mw.one_process(arch, accum, "float32"), "float32")


def test_smollm_heads_fall_back_to_replication():
    """smollm's smoke attention (3 heads, 1 kv head) keeps no `model` block
    on a 2-way axis, while its MLP width and vocabulary split."""
    from repro_torch.launch import sharding as shd

    class Mesh:
        axis_names, shape = ("data", "model"), {"data": 1, "model": 2}
    cfg = configs.get_arch("smollm-360m", smoke=True)
    named = dict(zip([n for n, _ in tree.named_leaves(steps.registry.schema(cfg))],
                     shd.spec_leaves(shd.param_pspecs(cfg, Mesh()))))
    assert "model" not in named["groups/sub0/attn/wq"] + named["groups/sub0/attn/wk"]
    assert "model" in named["groups/sub0/mlp/w_gate"] and "model" in named["embed"]
