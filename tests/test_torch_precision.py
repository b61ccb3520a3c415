"""Port parity for precision maps and the downshift rung algebra
(`repro_torch.core.precision`) and their path through the quantizers, the
`cst_quant` store's plain version, the caches and the engines, against the
JAX package on the same inputs (numpy-seeded).  Every comparison is exact:

  * the grammar cases of tests/test_precision.py (resolve, override order,
    open ranges, malformed specs, head pooling, `layer_eff`, `rung_eff`,
    `effective_bits`) give the reference's tables and values;
  * `quant.quantize_*` with per-head (h, 1, 1) and per-slot (b, h, 1, 1)
    eff give the JAX quantizers' codes, scale and zero bit for bit, in f32
    and bf16, and at the container width are bitwise `eff=None`;
  * `cst_quant`'s `quantize_store_ref` with an eff table is bitwise JAX
    `quantize_channelwise` + `quantize_cst` on the gathered block;
  * `compress_prefill`, `recompress` and the paged `recompress_slot` with
    a map and a rung are bitwise the JAX ones, on the kernel route's plain
    version and on the plain route;
  * the continuous engine under the conformance precision map
    (tests/test_backend_conformance.py's pmap-* rows) gives the JAX
    engine's tokens, bitwise equal across the port's layouts.

The JAX engine runs op by op (`jax.disable_jit()`), as in
tests/test_torch_continuous.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import kvcache as jkvc
from repro.core import paged as jpaged
from repro.core import precision as jprecision
from repro.core import quant as jquant
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core import kvcache as kvc
from repro_torch.core import packing, paged, precision, quant
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.cst_quant import kernel as cst_kernel
from repro_torch.kernels.cst_quant import ops as cst_ops
from repro_torch.kernels.cst_quant import ref as cst_ref
from repro_torch.serving import ContinuousEngine, Request, ServeConfig
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

# tests/test_backend_conformance.py's precision-map axis
PRECISION_MAP = "default=k8v8;layer:1-=k3v3"
HETERO = "default=k8v8;layer:0:head:0=k3v2"   # head 0 narrowed, head 1 free


# ---------------------------------------------------------------------------
# grammar, resolution, pooling, the ceiling and rung algebra
# ---------------------------------------------------------------------------

SPECS = [
    ("default=k8v8;layer:0-1=k4v4;layer:2-:head:0-1=k2v2;layer:3=k6v5", 4, 4),
    ('{"default": {"nbits_key": 8, "nbits_value": 8}, "1": {"nbits_key": 4, "nbits_value": 3},'
     ' "2": {"0": {"nbits_key": 2, "nbits_value": 2}}}', 3, 2),
    ("default=k8v8;layer:1=k4v3;layer:2:head:0=k2v2", 3, 2),
    ("layer:0=k2v2", 2, 2),
    ("layer:1-:head:3-=k2v2", 3, 8),
    (PRECISION_MAP, 4, 4),
    (HETERO, 2, 2),
]


@pytest.mark.parametrize("spec,n_layers,n_heads", SPECS)
def test_resolve_matches_reference(spec, n_layers, n_heads):
    got = precision.parse_precision_map(spec).resolve(n_layers, n_heads)
    want = jprecision.parse_precision_map(spec).resolve(n_layers, n_heads)
    assert got.dtype == np.int32 and got.shape == (n_layers, n_heads, 2)
    np.testing.assert_array_equal(got, want)


def test_compact_and_json_grammars_agree():
    pj = precision.parse_precision_map(SPECS[1][0])
    pc = precision.parse_precision_map(SPECS[2][0])
    np.testing.assert_array_equal(pj.resolve(3, 2), pc.resolve(3, 2))
    assert (precision.parse_precision_map("layer:0=k2v2").resolve(2, 2)[1]
            == precision.RAW_BITS).all()


@pytest.mark.parametrize("spec", [None, "", "   "])
def test_empty_spec_disables(spec):
    assert precision.parse_precision_map(spec) is None
    assert jprecision.parse_precision_map(spec) is None


@pytest.mark.parametrize("bad", [
    "layer:0", "layer:0=4v2", "layer:0=k4", "layer:a-2=k4v2", "head:0=k4v2",
    "layer:0:head=k4v2", "layer:0=k0v2", "layer:0=k4v99",
    '{"x": {"nbits_key": 4, "nbits_value": 2}}', '{"0": {"nbits_key": 4}}',
    '{"0": [4, 2]}', '{bad json',
])
def test_malformed_specs_raise_value_error(bad):
    for parse in (precision.parse_precision_map, jprecision.parse_precision_map):
        with pytest.raises(ValueError):
            parse(bad)


@pytest.mark.parametrize("n_heads", [1, 2, 3, 4])
def test_pooled_table_matches_reference(n_heads):
    t = np.array([[[8, 8], [2, 4], [6, 6], [3, 7]], [[1, 5], [4, 4], [16, 2], [5, 5]]], np.int32)
    np.testing.assert_array_equal(precision.pooled_table(t, n_heads),
                                  jprecision.pooled_table(t, n_heads))


@pytest.mark.parametrize("bits", [(4, 2), (8, 4), (2, 1)])
def test_layer_eff_matches_reference(bits):
    t = np.array([[[8, 8], [3, 1], [16, 16]], [[2, 2], [1, 6], [4, 3]]], np.int32)
    for layer in (0, 1):
        got = precision.layer_eff(t, layer, *bits)
        want = jprecision.layer_eff(t, layer, *bits)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == (3, 1, 1)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rung", [0, 1, 5, [0, 1, 3]], ids=["r0", "r1", "r5", "batched"])
@pytest.mark.parametrize("mapped", [False, True])
def test_rung_eff_matches_reference(rung, mapped):
    """Only the lo stores downshift, floored at 1 bit; a (b,) rung takes the
    (b, 1, 1, 1) shape of the rows fold; eff None starts at the containers."""
    t = np.array([[[8, 8], [3, 2]]], np.int32)
    base_t = precision.layer_eff(t, 0, 4, 2) if mapped else None
    base_j = jprecision.layer_eff(t, 0, 4, 2) if mapped else None
    got = precision.rung_eff(base_t, torch.tensor(rung, dtype=torch.int32), 4, 2)
    want = jprecision.rung_eff(base_j, jnp.asarray(rung, jnp.int32), 4, 2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_effective_bits_matches_reference():
    for t in (None, np.array([[[8, 8], [1, 1]]], np.int32),
              precision.parse_precision_map(PRECISION_MAP).resolve(4, 4)):
        assert precision.effective_bits(t, 4, 2) == jprecision.effective_bits(t, 4, 2)


# ---------------------------------------------------------------------------
# the quantizers with eff
# ---------------------------------------------------------------------------

def _x(rng, shape, dtype, scale=2.0):
    return jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale).astype(dtype)


def _eff(rng, shape, bits):
    """Integer effective bits in [1, bits], as f32, on both sides."""
    e = rng.integers(1, bits + 1, size=shape).astype(np.float32)
    return jnp.asarray(e), torch.from_numpy(e)


@pytest.mark.parametrize("scheme", ["channelwise", "tokenwise", "cst", "groupwise"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("eff_shape", [(3, 1, 1), (2, 3, 1, 1)], ids=["per-head", "per-slot"])
def test_quantizers_with_eff_match_reference(scheme, bits, dtype, eff_shape, rng):
    x = _x(rng, (2, 3, 40, 64), dtype)
    je, te = _eff(rng, eff_shape, bits)
    kw = {"group_size": 32} if scheme == "groupwise" else {}
    want = jquant.quantize(x, bits, scheme, eff=je, **kw)
    got = quant.quantize(to_torch(x), bits, scheme, eff=te, **kw)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    for a, b in ((got.scale, want.scale), (got.zero, want.zero),
                 (got.channel_scale, want.channel_scale)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == to_torch(b).dtype
            np.testing.assert_array_equal(to_np(a), to_np(b))
    # the narrowed range really bites: no code past the slice's qmax
    if scheme != "groupwise":
        codes = to_np(packing.unpack(got.codes, bits))
        assert (codes <= np.broadcast_to(2 ** te.numpy() - 1, codes.shape)).all()


@pytest.mark.parametrize("scheme", ["channelwise", "tokenwise", "cst", "groupwise"])
@pytest.mark.parametrize("bits", [2, 4])
def test_container_width_eff_is_bitwise_default(scheme, bits, rng):
    x = to_torch(_x(rng, (2, 3, 40, 64), jnp.bfloat16))
    kw = {"group_size": 32} if scheme == "groupwise" else {}
    base = quant.quantize(x, bits, scheme, **kw)
    mapped = quant.quantize(x, bits, scheme, eff=torch.full((2, 3, 1, 1), float(bits)), **kw)
    for f in ("codes", "scale", "zero", "channel_scale"):
        a, b = getattr(base, f), getattr(mapped, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_store_ref_with_eff_matches_reference(bits, dtype, rng):
    """The kernel's plain version with a mixed (b, hk, 2) table, some
    entries at the container width, against JAX quantize_channelwise (K)
    and quantize_cst (V) with (b, hk, 1, 1) effs on the gathered block."""
    b, hk, l, d, s = 2, 3, 40, 32, 36
    k, v = _x(rng, (b, hk, l, d), dtype), _x(rng, (b, hk, l, d), dtype, 1.0)
    idx = np.full((b, s), -1, np.int32)
    idx[0] = rng.permutation(l)[:s]
    idx[1, :30] = rng.permutation(l)[:30]
    je, te = _eff(rng, (b, hk, 2), bits)
    gather = jnp.take_along_axis
    safe = jnp.asarray(np.maximum(idx, 0))[:, None, :, None]
    live = jnp.asarray(idx >= 0)[:, None, :, None]
    kg = jnp.where(live, gather(k, safe, axis=2), 0).astype(dtype)
    vg = jnp.where(live, gather(v, safe, axis=2), 0).astype(dtype)
    wk = jquant.quantize_channelwise(kg, bits, eff=je[..., 0, None, None])
    wv = jquant.quantize_cst(vg, bits, eff=je[..., 1, None, None])
    launches = cst_kernel.KERNEL.launches
    got = cst_kernel.quantize_store(to_torch(k), to_torch(v), torch.from_numpy(idx), bits,
                                    eff=te)
    assert cst_kernel.KERNEL.launches == launches   # CPU tensors never launch
    want = (wk.codes, wk.scale, wk.zero, wv.codes, wv.scale, wv.zero, wv.channel_scale)
    for a, w in zip(got, want):
        assert a.dtype == to_torch(w).dtype
        np.testing.assert_array_equal(to_np(a), to_np(w))
    # container-width entries are the static path's slices, bit for bit
    full = torch.full((b, hk, 2), float(bits))
    for a, w in zip(cst_ref.quantize_store_ref(to_torch(k), to_torch(v), torch.from_numpy(idx),
                                               bits, full),
                    cst_ref.quantize_store_ref(to_torch(k), to_torch(v), torch.from_numpy(idx),
                                               bits)):
        assert torch.equal(a, w)


def test_eff_table_broadcasts_every_eff_shape():
    """The store's table from each eff shape a map or a rung gives: () for a
    bare width, (h, 1, 1), (b, 1, 1, 1) and (b, h, 1, 1)."""
    b, hk = 2, 3
    v = torch.arange(b * hk, dtype=torch.float32).reshape(b, hk, 1, 1)
    for e in (torch.tensor(3.0), torch.full((hk, 1, 1), 2.0), torch.full((b, 1, 1, 1), 1.0),
              torch.full((b, hk, 1, 1), 4.0)):
        t = cst_ops.eff_table(e, v, b, hk)
        assert t.shape == (b, hk, 2) and t.is_contiguous()
        assert torch.equal(t[..., 0], torch.broadcast_to(e, (b, hk, 1, 1))[..., 0, 0])
        assert torch.equal(t[..., 1], v[..., 0, 0])


# ---------------------------------------------------------------------------
# the caches with a map and a rung
# ---------------------------------------------------------------------------

def _cfgs():
    return (dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8),
            dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8))


def _assert_mixed_equal(got, want):
    def leaves_t(c):
        return [to_np(x) for x in kvc.tree_leaves(c)]

    gl, wl = leaves_t(got), [to_np(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(a, b)


def _leff(spec, layer, hk):
    jt = jprecision.parse_precision_map(spec).resolve(2, hk)
    tt = precision.parse_precision_map(spec).resolve(2, hk)
    return (jprecision.layer_eff(jprecision.pooled_table(jt, hk), layer, 4, 2),
            precision.layer_eff(precision.pooled_table(tt, hk), layer, 4, 2))


def _prefill(rng, dtype, spec, use_kernel, b=2, hk=2, l=40, d=16, max_len=60):
    jcfg, cfg = _cfgs()
    k, v = _x(rng, (b, hk, l, d), dtype, 1.0), _x(rng, (b, hk, l, d), dtype, 1.0)
    sal = rng.uniform(size=(b, l)).astype(np.float32)
    nnz = rng.integers(1, 5, size=(b, l)).astype(np.float32)
    je, te = _leff(spec, 1, hk) if spec else (None, None)
    want = jkvc.compress_prefill(jcfg, k, v, jnp.asarray(sal), max_len,
                                 probe_nnz=jnp.asarray(nnz), dtype=dtype, eff=je)
    got = kvc.compress_prefill(cfg, to_torch(k), to_torch(v), torch.from_numpy(sal), max_len,
                               probe_nnz=torch.from_numpy(nnz), dtype=to_torch(k).dtype,
                               use_kernel=use_kernel, eff=te)
    return jcfg, cfg, want, got


def _append(rng, want, got, dtype, n=5):
    b, hk, _, d = got.k_win.shape
    for _ in range(n):
        kt = _x(rng, (b, hk, d), dtype, 1.0)
        want = jkvc.append_token(want, kt, kt * 0.5)
        got = kvc.append_token(got, to_torch(kt), to_torch(kt * 0.5))
    return want, got


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("spec", [PRECISION_MAP, HETERO, "default=k16v16"])
def test_compress_prefill_with_map_matches_reference(spec, dtype, use_kernel, rng):
    _, _, want, got = _prefill(rng, dtype, spec, use_kernel)
    _assert_mixed_equal(got, want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("rung", [None, 1, [0, 1]], ids=["map", "map+rung", "map+rows-rung"])
def test_recompress_with_map_and_rung_matches_reference(rung, use_kernel, rng):
    """recompress with a per-head map and a rung folded in (scalar, or the
    (b,) rung of the rows fold), rows masked as the continuous engine folds."""
    dtype = jnp.bfloat16
    jcfg, cfg, want, got = _prefill(rng, dtype, HETERO, use_kernel)
    want, got = _append(rng, want, got, dtype)
    je, te = _leff(HETERO, 0, 2)
    if rung is not None:
        je = jprecision.rung_eff(je, jnp.asarray(rung, jnp.int32), 4, 2)
        te = precision.rung_eff(te, torch.tensor(rung, dtype=torch.int32), 4, 2)
    rows = np.array([True, False]) if isinstance(rung, list) else None
    want = jkvc.recompress(jcfg, want, rows=None if rows is None else jnp.asarray(rows), eff=je)
    got = kvc.recompress(cfg, got, rows=None if rows is None else torch.from_numpy(rows),
                         use_kernel=use_kernel, eff=te)
    _assert_mixed_equal(got, want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("mapped", [False, True], ids=["rung", "map+rung"])
def test_paged_recompress_slot_at_a_rung_matches_reference(mapped, use_kernel, rng):
    """The paged layout's per-slot fold with a scalar rung (the ladder's slot
    fold), against JAX's `paged.recompress_slot` on the same cache."""
    dtype = jnp.bfloat16
    jcfg, cfg, want, got = _prefill(rng, dtype, PRECISION_MAP if mapped else "", use_kernel)
    want, got = _append(rng, want, got, dtype)
    je, te = _leff(PRECISION_MAP, 1, 2) if mapped else (None, None)
    je = jprecision.rung_eff(je, jnp.asarray(1, jnp.int32), 4, 2)
    te = precision.rung_eff(te, torch.tensor(1, dtype=torch.int32), 4, 2)
    jp = jpaged.recompress_slot(jcfg, jpaged.from_mixed(want, page_size=8), jnp.asarray(1),
                                eff=je)
    tp = paged.recompress_slot(cfg, paged.from_mixed(got, page_size=8), 1,
                               use_kernel=use_kernel, eff=te)
    _assert_mixed_equal(tp.dense_view(), jp.dense_view())
    # the lo store of slot 1 really narrowed to 1 bit; slot 0 kept its codes
    lo = packing.unpack(tp.dense_view().lo.k.codes, 2)
    assert int(lo[1].max()) <= 1 and int(lo[0].max()) > 1


# ---------------------------------------------------------------------------
# the continuous engine under the conformance precision map
# ---------------------------------------------------------------------------

PMAP_VARIANTS = {
    "pmap-mixed": dict(backend="mixed"),
    "pmap-paged": dict(backend="paged"),
    "pmap-paged-kernel": dict(backend="paged", paged_kernel=True),
    "pmap-freelist": dict(backend="paged", page_allocator="freelist", pool_fraction=1.0),
}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(48,)).astype(np.int32) for _ in range(3)]


def _scenario(eng, request, prompts):
    """tests/test_backend_conformance.py's: two slots, a short request
    retiring after 6 tokens, a third admitted mid-run into its slot."""
    r0 = eng.submit(request(tokens=prompts[0]))
    r1 = eng.submit(request(tokens=prompts[1], max_new_tokens=6))
    for _ in range(4):
        eng.step()
    r2 = eng.submit(request(tokens=prompts[2]))
    res = eng.run()
    return [(res[r].tokens.tolist(), res[r].finish_reason) for r in (r0, r1, r2)]


@pytest.fixture(scope="module")
def pmap_runs():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg, ccfg = _cfgs()
    jparams = jregistry.materialize_params(jcfg, seed=0)
    prompts = _prompts(jcfg.vocab)
    with jax.disable_jit():
        scfg = JServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                            backend="mixed", precision_map=PRECISION_MAP)
        reference = _scenario(JContinuousEngine(jcfg, jccfg, scfg, jparams), JRequest, prompts)
    cfg = configs.get_arch("yi-6b", smoke=True)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")
    runs = {}
    for name, kw in {**PMAP_VARIANTS, "unmapped": dict(backend="mixed")}.items():
        pm = "" if name == "unmapped" else PRECISION_MAP
        scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                           precision_map=pm, **kw)
        eng = ContinuousEngine(cfg, ccfg, scfg, params, device="cpu")
        runs[name] = _scenario(eng, Request, prompts)
    return reference, runs


@pytest.mark.parametrize("variant", list(PMAP_VARIANTS))
def test_mapped_engine_tokens_match_reference(pmap_runs, variant):
    reference, runs = pmap_runs
    assert runs[variant] == reference
    assert runs[variant] == runs["pmap-mixed"]


def test_map_bites(pmap_runs):
    """The 3-bit ceiling changes tokens: the axis tests something."""
    _, runs = pmap_runs
    assert runs["pmap-mixed"] != runs["unmapped"]


def test_mapped_lockstep_equals_mapped_continuous():
    """The lockstep engine takes the map too (prefill and its folds): two
    full-length prompts give the mapped continuous engine's tokens."""
    from repro_torch.serving import ServingEngine, pack_requests

    cfg = configs.get_arch("yi-6b", smoke=True)
    _, ccfg = _cfgs()
    params = convert.from_jax_params(
        jax.device_get(jregistry.materialize_params(jconfigs.get_arch("yi-6b", smoke=True),
                                                    seed=0)), cfg, device="cpu")
    prompts = _prompts(cfg.vocab)[:2]
    scfg = ServeConfig(batch_size=2, prompt_len=48, max_new_tokens=12,
                       precision_map=PRECISION_MAP)
    want = ServingEngine(cfg, ccfg, scfg, params, device="cpu").generate(
        {"tokens": pack_requests(prompts, 2, 48)})["tokens"]
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device="cpu")
    rids = [eng.submit(Request(tokens=p)) for p in prompts]
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].tokens for r in rids]), want)
    unmapped = ServingEngine(cfg, ccfg, dataclasses.replace(scfg, precision_map=""), params,
                             device="cpu").generate({"tokens": pack_requests(prompts, 2, 48)})
    assert not np.array_equal(unmapped["tokens"], want)
