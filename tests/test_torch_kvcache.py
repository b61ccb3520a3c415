"""Port parity: the mixed cache through prefill compression, appends, a
probe step and a recompression, against the JAX package on the same inputs.
Integer artifacts (positions, codes, salient/regular indices) are exact;
floats are exact too, the step-by-step arithmetic being the same."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkvc
from repro.core.policy import CompressionConfig as JCompression
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import steps
from repro_torch.models import registry
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _cfgs():
    return (dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8),
            dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8))


def _assert_cache_equal(got: kvc.MixedKVCache, want: jkvc.MixedKVCache):
    for name in ("hi", "lo"):
        g, w = getattr(got, name), getattr(want, name)
        for f in ("pos", "acc", "nnz"):
            np.testing.assert_array_equal(to_np(getattr(g, f)), to_np(getattr(w, f)),
                                          err_msg=f"{name}.{f}")
        for q in ("k", "v"):
            gq, wq = getattr(g, q), getattr(w, q)
            assert gq.bits == wq.bits and gq.shape == tuple(wq.shape)
            for f in ("codes", "scale", "zero", "channel_scale"):
                a, b = getattr(gq, f), getattr(wq, f)
                assert (a is None) == (b is None), f"{name}.{q}.{f}"
                if a is not None:
                    np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=f"{name}.{q}.{f}")
    for f in ("k_win", "v_win", "win_pos", "win_acc", "win_nnz", "length", "win_fill"):
        np.testing.assert_array_equal(to_np(getattr(got, f)), to_np(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cache_lifecycle_matches_reference(dtype, rng):
    """compress_prefill -> append x8 (two probe steps) -> recompress."""
    jcfg, cfg = _cfgs()
    b, hk, l, d, max_len = 2, 2, 40, 16, 60
    k = jnp.asarray(rng.normal(size=(b, hk, l, d)).astype(np.float32)).astype(dtype)
    v = jnp.asarray(rng.normal(size=(b, hk, l, d)).astype(np.float32)).astype(dtype)
    sal = rng.uniform(size=(b, l)).astype(np.float32)
    sal[:, -6:] = 0.0                                   # ties, as unprobed tokens give
    nnz = rng.integers(1, 5, size=(b, l)).astype(np.float32)
    want = jkvc.compress_prefill(jcfg, k, v, jnp.asarray(sal), max_len,
                                 probe_nnz=jnp.asarray(nnz), dtype=dtype)
    got = kvc.compress_prefill(cfg, to_torch(k), to_torch(v), torch.from_numpy(sal), max_len,
                               probe_nnz=torch.from_numpy(nnz), dtype=to_torch(k).dtype)
    _assert_cache_equal(got, want)

    for step in range(8):
        kt = jnp.asarray(rng.normal(size=(b, hk, d)).astype(np.float32)).astype(dtype)
        vt = jnp.asarray(rng.normal(size=(b, hk, d)).astype(np.float32)).astype(dtype)
        want = jkvc.append_token(want, kt, vt)
        got = kvc.append_token(got, to_torch(kt), to_torch(vt))
        if step in (3, 7):                              # probe steps
            w = rng.uniform(size=(b, want.capacity)).astype(np.float32)
            want = jkvc.update_probe_state(want, jnp.asarray(w), jnp.asarray(True))
            got = kvc.update_probe_state(got, torch.from_numpy(w), True)
        _assert_cache_equal(got, want)
    want = jkvc.recompress(jcfg, want)
    got = kvc.recompress(cfg, got)
    _assert_cache_equal(got, want)


def test_append_to_full_window_drops_the_write(rng):
    jcfg, cfg = _cfgs()
    k = rng.normal(size=(1, 1, 8, 8)).astype(np.float32)
    sal = rng.uniform(size=(1, 8)).astype(np.float32)
    want = jkvc.compress_prefill(jcfg, jnp.asarray(k), jnp.asarray(k), jnp.asarray(sal), 20,
                                 dtype=jnp.float32)
    got = kvc.compress_prefill(cfg, torch.from_numpy(k), torch.from_numpy(k),
                               torch.from_numpy(sal), 20, dtype=torch.float32)
    for _ in range(want.window + 2):
        kt = rng.normal(size=(1, 1, 8)).astype(np.float32)
        want = jkvc.append_token(want, jnp.asarray(kt), jnp.asarray(kt))
        got = kvc.append_token(got, torch.from_numpy(kt), torch.from_numpy(kt))
    _assert_cache_equal(got, want)


def test_valid_first_fold_order(rng):
    idx = np.stack([rng.permutation(12)[:7] for _ in range(3)]).astype(np.int32)
    valid = rng.uniform(size=(3, 12)) < 0.5
    want = jkvc._valid_first(jnp.asarray(idx), jnp.asarray(valid))
    got = kvc._valid_first(torch.from_numpy(idx), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_capacities_match_reference():
    jcfg, cfg = _cfgs()
    for max_len in (16, 60, 1152, 2048, 4224):
        for ratio in (0.1, 0.4, 0.9):
            a = dataclasses.replace(jcfg, saliency_ratio=ratio)
            bcfg = dataclasses.replace(cfg, saliency_ratio=ratio)
            assert kvc.capacities(bcfg, max_len) == jkvc.capacities(a, max_len)


def test_init_caches_match_reference():
    """`registry.init_caches`: one empty mixed cache per layer, equal to the
    reference's `init_cache` at the serving context's cache length."""
    jcfg, cfg = _cfgs()
    arch = configs.get_arch("yi-6b", smoke=True)
    ctx = steps.serve_ctx(arch, ShapeConfig("serve", 40, 2, "prefill"), cfg, decode_budget=20,
                          device="cpu")
    caches = registry.init_caches(arch, ctx, 2, device="cpu")
    want = jkvc.init_cache(jcfg, 2, arch.n_kv_heads, arch.hd, 60)
    assert len(caches["groups"]) == arch.n_layers
    for group in caches["groups"]:
        _assert_cache_equal(group["sub0"], want)
