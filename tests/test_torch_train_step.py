"""The port's train step (`launch.steps.make_train_step`) against the JAX
package's, on the CPU, and `pick_grad_accum` against the reference's.

smollm-360m's smoke config (tied embeddings) from the reference's seeded
parameters, AdamW at lr 1e-3 under a cosine schedule (warmup 1, 3 steps),
three steps on the synthetic pipeline's batches (4 x 32 tokens), with
`grad_accum` 1 (bf16 gradients) and 2 (f32 accumulators); the reference
jitted in a child process with excess precision and the algebraic
simplifier off (`tests/train_reference.py`).  Tolerances:

  * every step's loss and ce within 1e-3 relative, aux 0, lr exact; the
    first step's gradient norm within 1e-3 relative (later steps start
    from parameters a few bf16 ulps apart, and this tiny model's random
    init, loss ~19 over near one-hot softmaxes, moves its gradient norm
    by up to 11% for that);
  * after three steps, each f32 master leaf within 5e-4 relative L2, and
    each bf16 parameter leaf equal but for at most 1% of its elements,
    each of those within one bf16 ulp of the reference's or 2e-3 of it
    (AdamW moves an element by about lr a step whatever its gradient's
    size, so where a near-zero gradient element differs in sign, the two
    move apart by up to 2 lr; a small weight spans many ulps of that).

Readings (this image): losses equal to the bit on steps 1-2, step 3 within
8.4e-4 (grad_accum 1) and 2.8e-5 (2); the first gradient norm within
1.6e-4; masters within 1.9e-4 relative L2; at most 0.63% of a leaf's bf16
parameters apart, the largest gap 1.95e-3 (one ulp in [0.25, 0.5); up
to 170 ulps only at weights near 0).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import steps as jsteps
from repro_torch import configs, convert, tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from tests import train_reference as tr
from tests.torch_parity import to_np, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("train_step") / "refs.pkl", ["step:1", "step:2"])


def _close(a: np.ndarray, b: np.ndarray, atol: float) -> bool:
    """Every differing pair of bf16 values (as f32) adjacent or within atol."""
    d = a != b
    lo = np.minimum(a[d], b[d]).astype(ml_dtypes.bfloat16)
    hi = np.maximum(a[d], b[d])
    adjacent = np.nextafter(lo, np.array(np.inf, ml_dtypes.bfloat16)).astype(np.float32) == hi
    return bool(np.all(adjacent | (hi - lo.astype(np.float32) <= atol)))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(refs, grad_accum):
    ref = refs[f"step:{grad_accum}"]
    cfg = configs.get_arch(tr.STEP_ARCH, smoke=True)
    params = convert.from_jax_params(ref["params0"], cfg, device="cpu")
    opt = adamw_init(params)
    step = steps.make_train_step(
        cfg, AdamWConfig(schedule=cosine_schedule(1, tr.STEP_N), **tr.STEP_OPT),
        grad_accum=grad_accum, q_block=tr.STEP_Q_BLOCK)
    for i, batch in enumerate(tr.step_batches(pipeline, cfg.vocab)):
        params, opt, met = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = ref["metrics"][i]
        assert sorted(met) == sorted(want)
        for k in ("loss", "ce"):
            assert abs(met[k].item() - want[k]) <= 1e-3 * abs(want[k]), (i, k)
        assert met["aux"].item() == want["aux"] == 0.0
        assert met["lr"].item() == np.float32(want["lr"])
        if i == 0:
            assert abs(met["grad_norm"].item() - want["grad_norm"]) <= 1e-3 * want["grad_norm"]
    assert int(opt.count) == tr.STEP_N
    want_params = convert.from_jax_params(ref["params"], cfg, device="cpu")
    for (name, got), want in zip(tree.named_leaves(params), tree.leaves(want_params)):
        assert got.dtype == torch.bfloat16
        g, w = to_np(got), to_np(want)
        assert np.mean(g != w) <= 0.01 and _close(g, w, 2 * tr.STEP_OPT["lr"]), name
    # the reference's state leaves: master, m, v, count
    masters = ref["opt"][:len(tree.leaves(params))]
    for (name, got), want in zip(tree.named_leaves(opt.master), masters):
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 5e-4, (name, rel)


def test_grad_accum_splits_the_batch_in_order():
    """grad_accum 2 on a batch equals the mean of two grad_accum-1 steps'
    gradients on its halves: the accumulated f32 sums divided by 2, fed to
    AdamW (the step after sees the same parameters: compared through the
    loss and gradient norm of the half batches)."""
    cfg = configs.get_arch("yi-6b", smoke=True)
    from repro_torch.models import registry
    params = registry.materialize_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt_cfg = AdamWConfig(lr=1e-3)
    fresh = lambda: tree.tree_map(torch.clone, params)   # a step updates its state in place
    p = fresh()
    _, _, met2 = steps.make_train_step(cfg, opt_cfg, grad_accum=2)(p, adamw_init(p), batch)
    one = steps.make_train_step(cfg, opt_cfg, grad_accum=1)
    halves = []
    for i in range(2):
        p = fresh()
        halves.append(one(p, adamw_init(p), {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}))
    mean_loss = (halves[0][2]["loss"] + halves[1][2]["loss"]) / 2
    assert abs(met2["loss"].item() - mean_loss.item()) <= 1e-6 * mean_loss.item()


@pytest.mark.parametrize("arch", sorted(jconfigs.all_archs()))
def test_pick_grad_accum_matches_reference(arch):
    for smoke in (False, True):
        jcfg, cfg = jconfigs.get_arch(arch, smoke=smoke), configs.get_arch(arch, smoke=smoke)
        for batch in (1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 256):
            want = jsteps.pick_grad_accum(jcfg, JShapeConfig("t", 128, batch, "train"), None)
            got = steps.pick_grad_accum(cfg, ShapeConfig("t", 128, batch, "train"))
            assert got == want, (arch, smoke, batch)


def test_pick_grad_accum_refuses_a_mesh():
    """The mesh form (the name is the one-card port's, which refused a
    mesh): over the data axes of a mesh it equals the reference's, pod
    counted as data, and smollm-360m at 8 sequences takes 4 microbatches
    without a mesh."""
    class Mesh:
        def __init__(self, shape, axes):
            self.axis_names, self.shape = axes, dict(zip(axes, shape))

    cfg, jcfg = configs.get_arch("smollm-360m"), jconfigs.get_arch("smollm-360m")
    assert steps.pick_grad_accum(cfg, ShapeConfig("t", 2048, 8, "train")) == 4
    for mesh in (Mesh((2, 1), ("data", "model")), Mesh((4, 2), ("data", "model")),
                 Mesh((2, 2, 2), ("pod", "data", "model"))):
        for batch in (4, 8, 16, 48):
            want = jsteps.pick_grad_accum(jcfg, JShapeConfig("t", 2048, batch, "train"), mesh)
            assert steps.pick_grad_accum(cfg, ShapeConfig("t", 2048, batch, "train"),
                                         mesh) == want, (mesh.shape, batch)
