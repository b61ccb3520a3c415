"""Port parity for the fine-grained MoE FFN (`repro_torch.models.mlp`) and the
DeepSeek-V2-Lite smoke model on the continuous engine.

  * `_dispatch_compute` and `moe_ffn` against the JAX package's on the same
    numpy inputs: f32 within the reference's own 2e-4 (tests/test_moe.py),
    bf16 within one bf16 ulp of the largest value (the dense FFN's
    tolerance in tests/test_torch_slice.py's logits).  Which pairs each
    expert keeps and drops shows in the outputs: a dropped pair adds
    nothing.  At capacity 1 (a decode step of 4 rows at DeepSeek-V2-Lite's
    64 experts, top 6), with pairs crowding one expert, and with a router
    tie (the lower expert first, as `jax.lax.top_k`);
  * the capacity rule's values at the full config's shapes;
  * `active`: a decode batch's empty rows take no expert slot, so the live
    rows' outputs are those of the batch without them;
  * the smoke model on the continuous engine over the paged free list:
    greedy tokens equal the JAX engine's on the same layout (jitted in a
    child process, `tests/serving_reference.py`, excess precision and the
    algebraic simplifier off: the op-by-op run's tokens), across
    admissions, probe steps and folds; and the
    port's mixed layout equal to its paged one.  The JAX package's
    ContinuousEngine refuses MoE archs (its dispatch lets empty slots take
    expert slots); its one check is hidden while the reference engine is
    built (`_moe_admitted`).  At two slots and the smoke config's capacity
    (2 per expert at a decode step) no decode pair can be dropped, so the
    port's masked dispatch and the reference's agree there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mlp as jmlp
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import mlp
from repro_torch.serving import ContinuousEngine, Request, ServeConfig
from tests import serving_reference as sr
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ARCH = "deepseek-v2-lite-16b"
DTYPES = {"f32": (jnp.float32, 2e-4), "bf16": (jnp.bfloat16, None)}


def _close(got, want, tol):
    """f32: atol = rtol = tol; bf16 (tol None): one bf16 ulp of the largest."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if tol is None:
        assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _experts(rng, n_exp, e, f, dtype):
    return {name: jnp.asarray(rng.standard_normal(shape) * 0.2, dtype)
            for name, shape in (("w_gate", (n_exp, e, f)), ("w_up", (n_exp, e, f)),
                                ("w_down", (n_exp, f, e)))}


def _dispatch_both(x, gates, eidx, w, capacity):
    with jax.disable_jit():
        want = jmlp._dispatch_compute(x, gates, eidx, w["w_gate"], w["w_up"], w["w_down"],
                                      jnp.zeros((), jnp.int32), capacity)
    got = mlp._dispatch_compute(to_torch(x), to_torch(gates), to_torch(eidx),
                                *(to_torch(w[k]) for k in ("w_gate", "w_up", "w_down")),
                                capacity)
    return got, want


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("capacity", [1, 2, 40])
def test_dispatch_keeps_and_drops_as_reference(dtype, capacity):
    """12 tokens, top 3 of 4 experts, most pairs on experts 0 and 1: at
    capacity 1 and 2 every expert drops pairs past its first ones in sorted
    (expert, then token) order, at 40 nothing drops."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    n, k, n_exp, e, f = 12, 3, 4, 16, 8
    eidx = np.stack([rng.permutation([0, 1, 2 + (i % 2)]) for i in range(n)]).astype(np.int32)
    gates = rng.uniform(0.1, 1.0, size=(n, k)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((n, e)), jdt)
    w = _experts(rng, n_exp, e, f, jdt)
    got, want = _dispatch_both(x, jnp.asarray(gates), jnp.asarray(eidx), w, capacity)
    _close(got, want, tol)
    full, _ = _dispatch_both(x, jnp.asarray(gates), jnp.asarray(eidx), w, 40)
    # token 0 comes first on every expert it picks: it keeps all its pairs
    # (the products differ in shape, so in the last bits only)
    torch.testing.assert_close(got[0].float(), full[0].float(), atol=1e-2, rtol=1e-2)
    # below capacity 12, the later tokens lose pairs on the crowded experts
    assert ((got.float() - full.float()).abs().amax(dim=1) > 1e-2).sum() == (
        0 if capacity == 40 else n - capacity)


def _moe_params(rng, cfg, dtype):
    e, f, n_exp = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {"router": jnp.asarray(rng.standard_normal((e, n_exp)) * 0.3, jnp.float32),
         **_experts(rng, n_exp, e, f, dtype)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared"] = {name: jnp.asarray(rng.standard_normal(shape) * 0.2, dtype)
                       for name, shape in (("w_gate", (e, fs)), ("w_up", (e, fs)),
                                           ("w_down", (fs, e)))}
    return p


def _moe_both(cfgs, params, x):
    jcfg, tcfg = cfgs
    with jax.disable_jit():
        want = jmlp.moe_ffn(params, x, jcfg)
    got = mlp.moe_ffn(jax.tree_util.tree_map(to_torch, params), to_torch(x), tcfg)
    return got, want


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.get_arch(ARCH, smoke=True), **kw),
            dataclasses.replace(configs.get_arch(ARCH, smoke=True), **kw))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 9), (4, 1)], ids=["prefill", "decode"])
def test_moe_ffn_matches_reference(dtype, shape):
    """The smoke config's router, 4 experts top 2 and a shared expert, at a
    prefill and a decode shape; the aux loss too."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    cfgs = _cfgs()
    params = _moe_params(rng, cfgs[0], jdt)
    x = jnp.asarray(rng.standard_normal((*shape, cfgs[0].d_model)), jdt)
    got, want = _moe_both(cfgs, params, x)
    _close(got, want.y, tol)
    _, aux = mlp.moe_ffn(jax.tree_util.tree_map(to_torch, params), to_torch(x), cfgs[1],
                         with_aux=True)
    np.testing.assert_allclose(float(aux), float(want.aux_loss), rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_ffn_at_decode_capacity_one(dtype):
    """DeepSeek-V2-Lite's routing (64 experts, top 6) at a decode step of 4
    rows: capacity 1, so a second row on an expert is dropped.  Rows 0 and 1
    are one token twice: every one of row 1's pairs is dropped, and its
    output is the shared expert's alone."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    cfgs = _cfgs(n_experts=64, top_k=6, moe_d_ff=8)
    assert mlp.capacity(cfgs[1], 4) == 1
    params = _moe_params(rng, cfgs[0], jdt)
    x = rng.standard_normal((4, 1, cfgs[0].d_model))
    x[1] = x[0]
    x = jnp.asarray(x, jdt)
    got, want = _moe_both(cfgs, params, x)
    _close(got, want.y, tol)
    shared = mlp.dense_mlp(jax.tree_util.tree_map(to_torch, params["shared"]), to_torch(x))
    assert torch.equal(got[1], shared[1])
    assert not torch.equal(got[0], shared[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_router_tie_takes_the_lower_expert(dtype):
    """Router columns 1 and 2 equal: every token ties its 2nd and 3rd
    choices, and top 2 takes expert 1 (the lower), as jax.lax.top_k."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(4)
    cfgs = _cfgs()
    params = _moe_params(rng, cfgs[0], jdt)
    router = np.asarray(params["router"]).copy()
    router[:, 0] = np.abs(router[:, 0]) * 4
    router[:, 2] = router[:, 1]
    router[:, 3] = -np.abs(router[:, 3]) * 4
    params["router"] = jnp.asarray(router)
    x = jnp.asarray(np.abs(rng.standard_normal((2, 5, cfgs[0].d_model))), jdt)
    got, want = _moe_both(cfgs, params, x)
    _close(got, want.y, tol)
    # the same tokens with expert 2's weights swapped for expert 1's would
    # give the same output only if expert 2 were never picked
    swapped = dict(params, **{w: params[w].at[2].set(1.0) for w in ("w_gate", "w_up", "w_down")})
    got2, _ = _moe_both(cfgs, swapped, x)
    assert torch.equal(got, got2)


def test_inactive_rows_take_no_expert_slot():
    """At capacity 1 (64 experts, top 6, 4 rows), rows 1 and 3 inactive: the
    live rows' outputs equal those of a batch of the live rows alone (whose
    capacity is also 1), though rows 1 and 3 repeat the live tokens."""
    rng = np.random.default_rng(6)
    cfg = dataclasses.replace(configs.get_arch(ARCH, smoke=True), n_experts=64, top_k=6,
                              moe_d_ff=8)
    params = jax.tree_util.tree_map(to_torch, _moe_params(rng, cfg, jnp.float32))
    live = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
    x = torch.cat([live[:1], live[:1], live[1:], live[1:]])
    assert mlp.capacity(cfg, 4) == mlp.capacity(cfg, 2) == 1
    masked = mlp.moe_ffn(params, x, cfg, active=torch.tensor([True, False, True, False]))
    alone = mlp.moe_ffn(params, live, cfg)
    unmasked = mlp.moe_ffn(params, x, cfg)

    def differ(a, b):   # beyond f32 products of other shapes
        return (a - b).abs().max().item() > 1e-3

    assert not differ(masked[0::2], alone)
    # unmasked, row 1 (row 0's token, after it) loses every pair to row 0
    assert not differ(unmasked[0], alone[0]) and differ(unmasked[1], alone[0])


def test_capacity_at_full_width():
    """ceil(b*s*k/E * 1.25): 1 per expert at a decode step of 4 rows, 480
    for a lockstep prefill of 4 x 1024, 120 for one 1024-token admission."""
    cfg = configs.get_arch(ARCH)
    assert [mlp.capacity(cfg, n) for n in (4, 4 * 1024, 1024)] == [1, 480, 120]


# ---- the smoke model on the continuous engine --------------------------------

PROMPT_LEN, MAX_NEW = sr.MOE_PROMPT_LEN, sr.MOE_NEW
FREELIST = sr.MOE_FREELIST


def _prompts(vocab):
    return sr.moe_prompts(vocab)


def _scenario(eng, request, prompts):
    return sr.moe_scenario(eng, request, prompts)


@pytest.fixture(scope="module")
def continuous_reference(tmp_path_factory):
    """The JAX engine's run, jitted in a child process (`tests/serving_reference.py`)."""
    return sr.run(tmp_path_factory.mktemp("moe_continuous") / "ref.pkl", "moe_continuous")


def _port_run(reference, **layout):
    cfg = configs.get_arch(ARCH, smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")
    eng = ContinuousEngine(cfg, ccfg, ServeConfig(batch_size=2, prompt_len=PROMPT_LEN,
                                                  max_new_tokens=MAX_NEW, **layout),
                           params, device="cpu")
    return _scenario(eng, Request, _prompts(cfg.vocab)), eng


def test_continuous_tokens_match_reference(continuous_reference):
    """Paged free list (pools at 0.75 of the worst case): tokens, finish
    reasons, the deferrals and every page back, as the JAX engine's."""
    got, eng = _port_run(continuous_reference, **FREELIST)
    assert got == continuous_reference["tokens"]
    assert [len(t) for t, _ in got] == [MAX_NEW, 3, MAX_NEW]
    stats, want = eng.pool_stats(), continuous_reference["stats"]
    assert stats["deferrals"] == want["deferrals"] and stats["folds"] >= 1
    for seg in ("hi", "lo", "win"):
        assert stats[seg] == want[seg] and stats[seg]["used"] == 0


def test_continuous_mixed_equals_paged(continuous_reference):
    """The port's mixed layout gives the paged layouts' tokens (MLA reads
    the paged cache through its dense view).  Page 8 on every layout: it
    sets the admission buckets, and a prompt's padding takes expert slots."""
    mixed, _ = _port_run(continuous_reference, backend="mixed", page_size=8)
    paged, _ = _port_run(continuous_reference, backend="paged", page_size=8)
    assert mixed == paged == continuous_reference["tokens"]
