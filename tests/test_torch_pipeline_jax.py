"""The port's pipeline against the JAX package's (`repro.launch.pipeline`),
run through the `shard_map` shim of `tests/pipeline_reference.py` in
child processes on 8 fake devices, while the port runs the same scenarios
over gloo: yi-6b smoke at 2 stages, yi-6b at 4 layers on 4 stages, and
smollm-360m smoke (tied embeddings) at 2 stages; a batch of 8 x 64, 4
microbatches, q_block 32, AdamW's defaults; the parameters and batch drawn
here by the JAX package and handed to both sides.

  * The reference test's own init (`materialize_params(cfg, 0)`) and the
    same draws at `common.fan_in_init` (`<job>@fan_in`).
  * Forward: the JAX `pp_forward`'s logits are bitwise its `lm.forward`'s,
    and the port's bitwise the port's `lm.forward` on the same parameters,
    so the pipelines add nothing to the two forwards' difference.  That
    difference (the blocked attention's f32 sums in another order than
    XLA's fused ones, ROADMAP.md §3) stays within 1.2e-2 of the largest
    logit (readings 3.1e-3 to 1.0e-2), and each forward's cross entropy,
    the first step's loss, within 2e-3 relative (readings: 1.5e-5 at most).
  * 3 pipelined steps: every loss within 2e-3 relative (readings: 2.1e-4
    at most), every parameter leaf within 1.5e-2 relative L2 (5.7e-4 at
    most), the grad norm within 2e-3 relative at every step from the
    fan-in init (7.3e-4 at most) and at the first step from the
    reference's (3.5e-4 at most).  At the reference's init the bf16
    gradients are rounding noise (ROADMAP.md §3): the second and third
    grad norms move by percents with the order of any bf16 sum, the
    reference's own pipelined step against its plain step too (2.0% on
    yi-6b at 4 layers), so they are held to the fan-in run instead.
  * The metrics are the reference's: {grad_norm, loss, lr}.
"""

import concurrent.futures
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import blocks, lm, registry
from tests import mesh_worker as mw
from tests import pipeline_reference as pr
from tests import pipeline_worker as pw
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

WORLDS = {2: ("yi2", "smol2", "yi2@fan_in", "smol2@fan_in"), 4: ("yi4", "yi4@fan_in")}
JOBS = [j for jobs in WORLDS.values() for j in jobs]
# the JAX jobs' child processes, run at once: one per program set (an init
# reuses the other's compiled programs through the persistent cache)
REF_GROUPS = (("yi2", "yi2@fan_in"), ("smol2", "smol2@fan_in"), ("yi4", "yi4@fan_in"))
LOSS_REL, NORM_REL, LEAF_REL_L2, LOGITS_OF_MAX = 2e-3, 2e-3, 1.5e-2, 1.2e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{job: (the JAX run, the port's run, the inputs)}: the JAX children
    run while the port's worlds run one after the other."""
    d = tmp_path_factory.mktemp("ppjax")
    inputs = pr.inputs(JOBS)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with concurrent.futures.ThreadPoolExecutor(len(REF_GROUPS)) as pool:
        ref = [pool.submit(pr.run, d / f"ref{i}.pkl", d / "in.pkl", jobs)
               for i, jobs in enumerate(REF_GROUPS)]
        port = {k: v for world, jobs in WORLDS.items()
                for k, v in pw.launch(world, d / f"port{world}.pkl",
                                      [f"jax:{d / 'in.pkl'}:{j}" for j in jobs]).items()}
        ref = {k: v for r in ref for k, v in r.result().items()}
    return {j: (ref[j], port[f"jax:{d / 'in.pkl'}:{j}"], inputs[j]) for j in JOBS}


def _f32(words):
    return words.view(ml_dtypes.bfloat16).astype(np.float32)


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("job", JOBS)
def test_forward_matches_reference(runs, job):
    ref, port, inp = runs[job]
    np.testing.assert_array_equal(ref["pp_logits"], ref["logits"])
    arch, n_layers, _ = pr.JOBS[job.partition("@")[0]]
    cfg = pr.cfg_of(configs, arch, n_layers)
    params = pr.to_port(inp["params"], registry.materialize_params(cfg, 0, device="cpu"))
    tokens = torch.from_numpy(inp["batch"]["tokens"])
    with torch.no_grad():
        mine = lm.forward(params, tokens, cfg, blocks.RunCtx(q_block=pr.Q_BLOCK),
                          remat=False).logits
    np.testing.assert_array_equal(port["logits"], mine.view(torch.int16).numpy().view(np.uint16))
    got, want = _f32(port["logits"]), _f32(ref["pp_logits"])
    assert np.abs(got - want).max() <= LOGITS_OF_MAX * np.abs(want).max()
    assert _rel(port["losses"][0], ref["losses"][0]) <= LOSS_REL


@pytest.mark.parametrize("job", JOBS)
def test_pipelined_steps_match_reference(runs, job):
    ref, port, _ = runs[job]
    assert port["metric_keys"] == ref["metric_keys"] == ["grad_norm", "loss", "lr"]
    for got, want in zip(port["losses"], ref["losses"]):
        assert _rel(got, want) <= LOSS_REL, (port["losses"], ref["losses"])
    held = port["grad_norms"] if job.endswith("@fan_in") else port["grad_norms"][:1]
    for got, want in zip(held, ref["grad_norms"]):
        assert _rel(got, want) <= NORM_REL, (port["grad_norms"], ref["grad_norms"])
    assert len(port["params"]) == len(ref["params"])
    for got, want in zip(port["params"], ref["params"]):
        assert got.shape == want.shape
        assert mw.rel_l2(got, want) <= LEAF_REL_L2
