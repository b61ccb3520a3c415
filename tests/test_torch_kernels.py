"""Port parity for the kernels' plain versions (what a wrapper runs on CPU
tensors) against the JAX package: probe_flash against `blocked_attention`
and the Pallas wrapper in interpret mode, decode_qattn against
`kvcache.attend_decode` and the Pallas `decode_attend_mixed`.

Tolerances: float32 scores and softmax summed in another order, 1e-5
(absolute on outputs and column sums of probabilities <= 1)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkvc
from repro.core import saliency as jsal
from repro.core.policy import CompressionConfig as JCompression
from repro.kernels.decode_qattn import ops as jdq_ops
from repro.kernels.probe_flash import ops as jpf_ops
from repro.models import attention as jattn
from repro_torch.core import kvcache as kvc
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.decode_qattn import kernel as dq_kernel
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.probe_flash import kernel as pf_kernel
from repro_torch.kernels.probe_flash import ops as pf_ops
from repro_torch.models import attention
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
TOL = 1e-5


def _qkv(rng, b=2, h=4, hk=2, l=48, d=16):
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))
    return f(b, h, l, d), f(b, hk, l, d), f(b, hk, l, d)


def _spec(positions):
    pos = np.array(positions, np.int32)
    return jsal.ProbeSpec(jnp.asarray(pos), 0, len(pos)), sal.ProbeSpec(torch.from_numpy(pos), 0, len(pos))


@pytest.mark.parametrize("q_block", [16, 48])
def test_blocked_attention_matches_reference(q_block, rng):
    q, k, v = _qkv(rng)
    jspec, spec = _spec(np.asarray(jsal.select_probes(48).positions))
    wo, wc = jattn.blocked_attention(q, k, v, q_block=q_block, probe=jspec)
    go, gc = attention.blocked_attention(to_torch(q), to_torch(k), to_torch(v),
                                         q_block=q_block, probe=spec)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=TOL)


@pytest.mark.parametrize("positions", [
    "select_probes(48)",
    [3, 3, 7, 10, 10, 10, 30, 47],         # repeats, as select_probes makes at long prompts
])
def test_probe_flash_plain_version_follows_blocked_attention(positions, rng):
    q, k, v = _qkv(rng)
    if isinstance(positions, str):
        positions = np.asarray(jsal.select_probes(48).positions)
    jspec, spec = _spec(positions)
    wo, wc = jattn.blocked_attention(q, k, v, q_block=48, probe=jspec)
    launches = (pf_kernel.FLASH.launches, pf_kernel.COLSUM.launches)
    go, gc = pf_ops.probe_flash_attention(to_torch(q), to_torch(k), to_torch(v), probe=spec)
    assert (pf_kernel.FLASH.launches, pf_kernel.COLSUM.launches) == launches
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=TOL)


def test_repeated_probe_rows_diverge_from_the_pallas_wrapper(rng):
    """The reference's Pallas wrapper gathers rows by position, so a repeated
    probe counts twice there; the port (and blocked_attention) count it once."""
    q, k, v = _qkv(rng, b=1)
    jspec, spec = _spec([5, 5, 20, 47])
    _, wc_kernel = jpf_ops.probe_flash_attention(q, k, v, probe=jspec, q_block=48, interpret=True)
    _, wc_live = jattn.blocked_attention(q, k, v, q_block=48, probe=jspec)
    _, gc = pf_ops.probe_flash_attention(to_torch(q), to_torch(k), to_torch(v), probe=spec)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc_live), atol=TOL)
    assert np.abs(gc.numpy() - np.asarray(wc_kernel)).max() > 1e-3


def test_probe_flash_plain_version_matches_pallas_interpret(rng):
    q, k, v = _qkv(rng)
    jspec, spec = _spec(np.asarray(jsal.select_probes(48).positions))
    wo, wc = jpf_ops.probe_flash_attention(q, k, v, probe=jspec, q_block=16, interpret=True)
    go, gc = pf_ops.probe_flash_attention(to_torch(q), to_torch(k), to_torch(v), probe=spec)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=TOL)


def _caches(rng, dtype, b=2, hk=2, l=40, d=16, max_len=60, n_append=5, h=None):
    """The same cache built by both packages: prefill + a few appends; a
    query of h heads (2 * hk by default)."""
    jcfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    cfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(dtype)
    k, v = f(b, hk, l, d), f(b, hk, l, d)
    s = jnp.asarray(rng.uniform(size=(b, l)).astype(np.float32))
    jc = jkvc.compress_prefill(jcfg, k, v, s, max_len, dtype=dtype)
    tc = kvc.compress_prefill(cfg, to_torch(k), to_torch(v), to_torch(s), max_len,
                              dtype=to_torch(k).dtype)
    for _ in range(n_append):
        kt, vt = f(b, hk, d), f(b, hk, d)
        jc = jkvc.append_token(jc, kt, vt)
        tc = kvc.append_token(tc, to_torch(kt), to_torch(vt))
    return jc, tc, f(b, 2 * hk if h is None else h, d)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_attend_decode_matches_reference(dtype, rng):
    jc, tc, q = _caches(rng, dtype)
    want = jkvc.attend_decode(q, jc)
    got = kvc.attend_decode(to_torch(q), tc)
    tol = TOL if dtype == jnp.float32 else 2 ** -7   # bf16 output: one ulp
    np.testing.assert_allclose(to_np(got.out), to_np(want.out), atol=tol, rtol=tol)
    np.testing.assert_allclose(got.slot_weights.numpy(), np.asarray(want.slot_weights), atol=TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_qattn_plain_version_matches_reference(dtype, rng):
    """Segments + merge against the exact `attend_decode` (which rounds the
    dequantized K/V to the store dtype, as the port's kernel does) and
    against the Pallas `decode_attend_mixed` in interpret mode (which does
    not round: exact at f32, within the bf16 store rounding at bf16)."""
    _hold_decode_layer(rng, dtype, hk=2, h=4)


def _hold_decode_layer(rng, dtype, hk, h):
    jc, tc, q = _caches(rng, dtype, hk=hk, h=h)
    launches = dq_kernel.KERNEL.launches
    got = to_np(dq_ops.decode_attend_mixed(to_torch(q), tc))
    assert dq_kernel.KERNEL.launches == launches and got.shape == (2, h, 16)
    exact = to_np(jkvc.attend_decode(q, jc).out)
    pallas = to_np(jdq_ops.decode_attend_mixed(q, jc, block_s=16, interpret=True))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, exact, atol=TOL)
        np.testing.assert_allclose(got, pallas, atol=TOL)
    else:
        np.testing.assert_allclose(got, exact, atol=2 ** -7, rtol=2 ** -7)
        np.testing.assert_allclose(got, pallas, atol=5e-2)


# the walk's G = 7 (qwen2-7b, yi-34b) and G = 3 (smollm-360m) group sizes
NEW_GROUPS = [(7, 1), (14, 2), (3, 1), (15, 5)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("heads", NEW_GROUPS, ids=[f"h{h}-hk{hk}" for h, hk in NEW_GROUPS])
def test_decode_qattn_plain_version_at_new_group_sizes(heads, dtype, rng):
    """The layer's plain version at g = 7 and g = 3 against the exact
    `attend_decode` and the Pallas `decode_attend_mixed` (interpret mode),
    at the tolerances of the g = 2 case above."""
    h, hk = heads
    _hold_decode_layer(rng, dtype, hk=hk, h=h)
