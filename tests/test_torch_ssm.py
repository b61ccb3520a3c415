"""Port parity for the Mamba2 SSD mixer (`repro_torch.models.ssm`) against the
JAX package's `repro.models.ssm`, on the same numpy inputs made from a seed.

The JAX functions run op by op (`jax.disable_jit()`): each bf16 operation
then rounds on its own, as the port's do.  Tolerances, on the largest magnitude m of the reference's
result:

  * f32 outputs and states: 1e-5 x max(m, 1) (the scan's f32 sums in
    another order);
  * bf16 outputs and conv tails: 2**-7 x m, one bf16 ulp at the top; the
    f32 SSM state of a bf16 run: 1e-5 x max(m, 1).

Covered: `ssm_forward` and `ssm_decode` in f32 and bf16, from a zero and
from a given state; the conv tails (`_causal_conv`, `_conv_step`); one
decode step equal to forwarding that token; and the ragged last chunk
(the port's one departure: a length that is not a multiple of the chunk).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import ssm
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ARCH = "mamba2-2.7b"    # Jamba's smoke SSM layers have the same shapes
GROUPS = (1, 2)         # B and C shared by all 8 heads, or by 4 heads each
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.get_arch(ARCH, smoke=True), **kw),
            dataclasses.replace(configs.get_arch(ARCH, smoke=True), **kw))


def _close(got, want, dtype):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    top = np.abs(want).max()
    tol = 2 ** -7 * top if dtype == "bf16" else 1e-5 * max(top, 1.0)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _params(rng, cfg, jdt):
    """Random SSM weights in the schema's shapes: projections at 0.2, conv
    weights at 0.3, and A_log, D, dt_bias away from their constant inits."""
    out = {}
    for name, p in ssm.ssm_schema(cfg).items():
        scale = 0.3 if name.startswith("conv") or name in ("A_log", "D", "dt_bias") else 0.2
        out[name] = jnp.asarray(rng.standard_normal(p.shape) * scale, jdt)
    return out


def _state(rng, cfg, b, jdt):
    """A nonzero state: f32 SSM state, tails in the activations' dtype."""
    z = ssm.init_state(cfg, b)
    return jssm.SSMState(*(jnp.asarray(rng.standard_normal(t.shape) * 0.5,
                                       jnp.float32 if name == "ssm" else jdt)
                           for name, t in zip(("ssm", "conv_x", "conv_B", "conv_C"),
                                              (z.ssm, z.conv_x, z.conv_B, z.conv_C))))


def _to_port(tree):
    return jax.tree_util.tree_map(to_torch, tree)


def _state_close(got, want, dtype):
    _close(got.ssm, want.ssm, "f32")
    for name in ("conv_x", "conv_B", "conv_C"):
        _close(getattr(got, name), getattr(want, name), dtype)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("init", ["zero", "given"])
def test_ssm_forward_matches_reference(groups, dtype, init):
    """Two chunks of 32 (l = 64): the within-chunk term, the carried state,
    the final state and its conv tails."""
    jcfg, cfg = _cfgs(ssm_n_groups=groups)
    jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    params = _params(rng, cfg, jdt)
    x = jnp.asarray(rng.standard_normal((2, 64, cfg.d_model)), jdt)
    st = _state(rng, cfg, 2, jdt) if init == "given" else None
    with jax.disable_jit():
        want_y, want_st = jssm.ssm_forward(params, x, jcfg, state=st)
    got_y, got_st = ssm.ssm_forward(_to_port(params), to_torch(x), cfg,
                                    state=None if st is None else ssm.SSMState(*_to_port(st)))
    assert got_y.dtype == to_torch(want_y).dtype and got_st.ssm.dtype == torch.float32
    _close(got_y, want_y, dtype)
    _state_close(got_st, want_st, dtype)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_decode_matches_reference(groups, dtype):
    """One recurrence step from a nonzero state."""
    jcfg, cfg = _cfgs(ssm_n_groups=groups)
    jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    params = _params(rng, cfg, jdt)
    st = _state(rng, cfg, 3, jdt)
    x_t = jnp.asarray(rng.standard_normal((3, cfg.d_model)), jdt)
    with jax.disable_jit():
        want_y, want_st = jssm.ssm_decode(params, x_t, jcfg, st)
    got_y, got_st = ssm.ssm_decode(_to_port(params), to_torch(x_t), cfg,
                                   ssm.SSMState(*_to_port(st)))
    _close(got_y, want_y, dtype)
    _state_close(got_st, want_st, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_tails_match_reference(dtype):
    """The depthwise causal conv over a sequence and over one token: outputs
    and the new tails (the last d_conv - 1 inputs)."""
    jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 9, 24)), jdt)
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.3, jdt)
    b_ = jnp.asarray(rng.standard_normal((24,)) * 0.3, jdt)
    tail = jnp.asarray(rng.standard_normal((2, 3, 24)), jdt)
    with jax.disable_jit():
        want = jssm._causal_conv(x, w, b_, tail)
        want_t = jssm._conv_step(x[:, 0], w, b_, tail)
    got = ssm._causal_conv(*map(to_torch, (x, w, b_, tail)))
    got_t = ssm._conv_step(*map(to_torch, (x[:, 0], w, b_, tail)))
    for g, w_ in zip((*got, *got_t), (*want, *want_t)):
        _close(g, w_, dtype)
    # the sequence's tail is its last three inputs
    assert torch.equal(got[1], to_torch(x)[:, -3:])


@pytest.mark.parametrize("groups", GROUPS)
def test_decode_step_equals_forwarding_the_token(groups):
    """ssm_decode from the state after l tokens gives the output and state
    of ssm_forward over l + 1 tokens (f32: the chunked sum and the
    recurrence differ in order only)."""
    _, cfg = _cfgs(ssm_n_groups=groups)
    rng = np.random.default_rng(4)
    params = _to_port(_params(rng, cfg, jnp.float32))
    x = torch.from_numpy(rng.standard_normal((2, 41, cfg.d_model)).astype(np.float32))
    _, st = ssm.ssm_forward(params, x[:, :40], cfg)
    y_t, st_t = ssm.ssm_decode(params, x[:, 40], cfg, st)
    y_all, st_all = ssm.ssm_forward(params, x, cfg)
    _close(y_t, y_all[:, -1], "f32")
    _state_close(st_t, st_all, "f32")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_last_chunk(dtype):
    """l = 48 at chunk 32, which the reference refuses (its assert): the port
    runs a chunk of 32 and one of 16.  It equals the reference at chunk 16
    (a chunk that divides 48), and the port at chunk 16."""
    jcfg, cfg = _cfgs()
    assert cfg.ssm_chunk == 32
    jdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    params = _params(rng, cfg, jdt)
    x = jnp.asarray(rng.standard_normal((2, 48, cfg.d_model)), jdt)
    with jax.disable_jit():
        with pytest.raises(AssertionError):
            jssm.ssm_forward(params, x, jcfg)
        want_y, want_st = jssm.ssm_forward(params, x, dataclasses.replace(jcfg, ssm_chunk=16))
    tp, tx = _to_port(params), to_torch(x)
    got_y, got_st = ssm.ssm_forward(tp, tx, cfg)
    _close(got_y, want_y, dtype)
    _state_close(got_st, want_st, dtype)
    by16_y, by16_st = ssm.ssm_forward(tp, tx, dataclasses.replace(cfg, ssm_chunk=16))
    _close(got_y, by16_y, dtype)
    _state_close(got_st, by16_st, dtype)
