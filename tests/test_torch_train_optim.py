"""The port's optimizer against the JAX package (`repro.optim`), on the CPU.

  * `linear_warmup` and `cosine_schedule` at steps 0-30, for several warmup
    and total lengths: within 2 f32 ulps of the reference's (`cos` may
    round differently);
  * `adamw_update` on smollm-360m's smoke tree (tied embeddings), two
    updates in a row under a cosine schedule, with the clip active (a
    gradient norm far above `grad_clip`) and inactive: `grad_norm` within
    1e-5 relative (each leaf's f32 sum of squares runs in another order
    than XLA's), `lr` within 2 f32 ulps, `count` exact; the f32 master, m
    and v within 1e-6 relative plus, with the clip active, once (m) and
    twice (v) the relative gap between the two clip factors, which scale
    every gradient; the master and m, whose sums can cancel to near zero
    (`p32 - lr * step`, `b1 * m + (1 - b1) * g`), within that tolerance of
    their leaf's largest magnitude where they do; the bf16 parameters equal, except
    where the new master lies at a bf16 rounding tie (within 1e-6 relative
    of the midpoint of two bf16 neighbours), and there within one bf16
    ulp.  The reference runs op by op: each f32 operation rounds on its
    own, as the port's do.  The port's update is in place (the state and
    parameters given up to it), as the CLI runs it;
  * the in-place update's flat chunks change no bit: three updates of
    DeepSeek-V2-Lite's smoke tree (its f32 router made anew in bf16) with
    `_CHUNK` at 97 elements equal those with every leaf in one chunk
    (master, m, v, parameters, count, metrics).

Readings (this image): the schedules agree to the bit at every step;
`grad_norm` within 1.7e-6 relative; the masters within 1e-6; no bf16
parameter differs.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import configs, convert, tree
from repro_torch.optim import adamw, schedule
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
STEPS = np.arange(31, dtype=np.int32)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 ulps (ordered-integer difference)."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("warmup", [0, 1, 7])
def test_linear_warmup_matches_reference(warmup):
    want = np.asarray(jschedule.linear_warmup(warmup)(jnp.asarray(STEPS)))
    got = schedule.linear_warmup(warmup)(torch.from_numpy(STEPS)).numpy()
    assert got.dtype == np.float32
    assert _ulps(want, got).max() <= 2


@pytest.mark.parametrize("warmup,total,final", [(0, 20, 0.1), (5, 20, 0.1), (10, 10, 0.1),
                                                (3, 25, 0.0), (2, 8, 0.1)])
def test_cosine_schedule_matches_reference(warmup, total, final):
    want = np.asarray(jschedule.cosine_schedule(warmup, total, final)(jnp.asarray(STEPS)))
    got = schedule.cosine_schedule(warmup, total, final)(torch.from_numpy(STEPS)).numpy()
    assert got.dtype == np.float32
    assert _ulps(want, got).max() <= 2, (want, got)


@pytest.fixture(scope="module")
def smoke_tree():
    jcfg = jconfigs.get_arch("smollm-360m", smoke=True)
    with jax.threefry_partitionable(True):
        params = jax.device_get(jregistry.materialize_params(jcfg, seed=0))
    return params, configs.get_arch("smollm-360m", smoke=True)


def _grads(params, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(np.shape(p)) * scale).astype(ml_dtypes.bfloat16), params)


def _bf16_equal_but_ties(want_bf16, got_bf16, master):
    """bf16 parameters equal, but where `master` (the reference's f32) is
    within 1e-6 relative of the midpoint of two bf16 neighbours; there the
    two differ by at most one bf16 ulp."""
    w = np.asarray(want_bf16).astype(np.float32)
    g = got_bf16.float().numpy()
    diff = w != g
    if not diff.any():
        return 0
    m = np.asarray(master)[diff]
    mid = (w[diff] + g[diff]) / 2
    assert np.all(np.abs(m - mid) <= 1e-6 * np.abs(m)), "a bf16 parameter differs off a tie"
    lo, hi = np.minimum(w[diff], g[diff]), np.maximum(w[diff], g[diff])
    assert np.all(np.nextafter(lo.astype(ml_dtypes.bfloat16), np.inf).astype(np.float32)
                  >= hi), "a bf16 parameter differs by more than one ulp"
    return int(diff.sum())


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_update_matches_reference(smoke_tree, clip):
    jparams, cfg = smoke_tree
    scale = 1.0 if clip == "active" else 1e-4        # norms ~60 and ~6e-3 against clip 1
    kw = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    jcfg_opt = jadamw.AdamWConfig(schedule=jschedule.cosine_schedule(1, 4), **kw)
    tcfg_opt = adamw.AdamWConfig(schedule=schedule.cosine_schedule(1, 4), **kw)
    jstate = jadamw.adamw_init(jparams)
    params = convert.from_jax_params(jparams, cfg, device="cpu")
    state = adamw.adamw_init(params)
    for k in range(2):
        g = _grads(jparams, scale, seed=k)
        jp, jstate, jmet = jadamw.adamw_update(jcfg_opt, g, jstate)
        p, state, met = adamw.adamw_update(tcfg_opt, jax.tree_util.tree_map(to_torch, g),
                                           state, params)
        params = p
        gn = float(jmet["grad_norm"])
        assert (gn > 1.0) == (clip == "active")
        np.testing.assert_allclose(met["grad_norm"].item(), gn, rtol=1e-5)
        # the clip factor scales m once and v twice
        r_clip = (abs(met["grad_norm"].item() - gn) / gn) * 1.01 if clip == "active" else 0.0
        rtol = {"master": 1e-6, "m": 1e-6 + r_clip, "v": 1e-6 + 2 * r_clip}
        assert _ulps(np.float32(jmet["lr"]), met["lr"].numpy()).max() <= 2
        assert int(state.count) == int(jstate.count) == k + 1
        for field in ("master", "m", "v"):
            for (name, got), want in zip(tree.named_leaves(getattr(state, field)),
                                         jax.tree_util.tree_leaves(getattr(jstate, field))):
                want = np.asarray(want)
                atol = 0.0 if field == "v" else rtol[field] * np.abs(want).max()
                np.testing.assert_allclose(got.numpy(), want, rtol=rtol[field], atol=atol,
                                           err_msg=f"{field}/{name}")
        for got, want, master in zip(tree.leaves(p), jax.tree_util.tree_leaves(jp),
                                     jax.tree_util.tree_leaves(jstate.master)):
            assert got.dtype == torch.bfloat16
            _bf16_equal_but_ties(want, got, master)


def test_adamw_init_and_global_norm(smoke_tree):
    jparams, cfg = smoke_tree
    params = convert.from_jax_params(jparams, cfg, device="cpu")
    state = adamw.adamw_init(params)
    assert state._fields == jadamw.AdamWState._fields
    assert state.count.dtype == torch.int32 and int(state.count) == 0
    for p, m32, m, v in zip(*(tree.leaves(t) for t in (params, state.master, state.m,
                                                       state.v))):
        assert m32.dtype == m.dtype == v.dtype == torch.float32
        assert torch.equal(m32, p.float()) and not m.any() and not v.any()
    g = _grads(jparams, 1.0, seed=3)
    np.testing.assert_allclose(adamw.global_norm(jax.tree_util.tree_map(to_torch, g)).item(),
                               float(jadamw.global_norm(g)), rtol=1e-5)
    assert to_np(adamw.global_norm(params)).dtype == np.float32


def test_chunked_update_is_bitwise_one_chunk(monkeypatch):
    from repro_torch.models import registry
    cfg = configs.get_arch("deepseek-v2-lite-16b", smoke=True)
    params0 = registry.materialize_params(cfg, seed=0, device="cpu")
    assert {t.dtype for t in tree.leaves(params0)} == {torch.bfloat16, torch.float32}
    gen = torch.Generator().manual_seed(4)
    grads = [tree.tree_map(lambda t: (torch.randn(t.shape, generator=gen) * 0.3).to(t.dtype),
                           params0) for _ in range(3)]
    opt_cfg = adamw.AdamWConfig(lr=1e-2, schedule=schedule.cosine_schedule(1, 3))
    runs = {}
    for chunk in (97, 1 << 40):
        monkeypatch.setattr(adamw, "_CHUNK", chunk)
        params = tree.tree_map(torch.clone, params0)
        state = adamw.adamw_init(params)
        mets = []
        for g in grads:
            params, state, met = adamw.adamw_update(opt_cfg, g, state, params)
            mets.append(met)
        runs[chunk] = (params, state, mets)
    (p7, s7, m7), (p1, s1, m1) = runs.values()
    assert int(s7.count) == int(s1.count) == 3
    for field in ("master", "m", "v"):
        for (name, a), b in zip(tree.named_leaves(getattr(s7, field)),
                                tree.leaves(getattr(s1, field))):
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), (field, name)
    for (name, a), b in zip(tree.named_leaves(p7), tree.leaves(p1)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), name
    for a, b in zip(m7, m1):
        assert all(torch.equal(a[k], b[k]) for k in ("grad_norm", "lr"))
    assert not torch.equal(s7.master["embed"], params0["embed"].float())
