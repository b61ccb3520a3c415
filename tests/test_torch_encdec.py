"""The encoder-decoder (seamless-m4t-medium smoke: 2 encoder and 2 decoder
layers, d 64, 4 / 4 heads) against the JAX package, function by function,
and the frontend archs' schema.

  * `registry.schema` of seamless and of llava-next-34b (the vision
    frontend's `vision_proj`) equal the reference's leaf for leaf, in shape
    and dtype; the full-size seamless schema holds 978,909,184 parameters;
  * `gqa_forward` in its three uses: causal self-attention with a probe,
    the encoder's non-causal self-attention (rotated) and cross-attention
    over a separate K/V source (not rotated), with probes on both
    non-causal uses (nnz the probe count, repeats included);
  * `encode` on f32 and on bf16 frame embeddings: the output in the
    embeddings' dtype, as the reference's;
  * the lockstep engine's prefill on the serve CLI's f32 frames, on the
    kernel route (the kernels' plain versions on the CPU) and the plain
    route: each store's parameter dtype the reference's (the cross stores
    f32 beside a bf16 window, the self stores bf16); and on the same frames
    in bf16, where every artifact but the f32 probe sums is bitwise;
  * three decode steps (probe, plain, probe), a fold and a probe step
    after it: the fold leaves every cross cache as it was, and the cross
    caches' probe state moves as the reference's;
  * the engine's greedy tokens and `cache_bytes` equal the reference's;
  * the captured (static-buffer) lockstep step bitwise equal to
    `capture=False` on the encoder-decoder tree, self and cross caches at
    one address for the whole run; the lockstep engine builds no
    continuous program;
  * the continuous engine refuses seamless and llava with the reference's
    error, and a precision map on seamless is refused with a ValueError
    that names the cause.

The reference runs op by op in a child process (`tests/encdec_reference.py`,
part "functions"), which is most of this file's time.  Tolerances: the
bf16 outputs within one bf16 ulp of their largest magnitude (2**-7 of it);
the reference's QUANT_TOL (tests/test_backend_conformance.py: 0.35,
relative to the largest magnitude here) where an f32 difference has gone
through a bf16 rounding and on into a layer downstream; 1e-4 relative to
the largest magnitude where f32 sums alone differ in order.  Why more than
one decoder layer cannot be held bitwise on f32 frames: the encoder's f32
products sum in another order on torch's CPU BLAS than in XLA's (4e-5 at
the encoder output), the cross-attention's bf16 output then rounds the
other way in a few elements, and the second layer's salient split and
codes move with them; fed the reference's own input, that layer is
bitwise the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.models import attention, common, encdec, registry
from repro_torch.serving import ContinuousEngine, ServeConfig, ServingEngine
from tests import encdec_reference as er
from tests.torch_parity import to_np, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
QUANT_TOL = 0.35            # tests/test_backend_conformance.py
ROUTES = {"kernel-route": True, "plain": False}
POSITIONS = ("hi.pos", "lo.pos", "win_pos", "length", "win_fill")
INTEGERS = POSITIONS + ("hi.k.codes", "hi.v.codes", "lo.k.codes", "lo.v.codes")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return er.run(tmp_path_factory.mktemp("encdec"), "functions")[er.SEAMLESS]


def _ccfg():
    return dataclasses.replace(CompressionConfig.zipcache(), **er.ccfg_kwargs())


def _port(refs):
    cfg = configs.get_arch(er.SEAMLESS, smoke=True)
    return cfg, convert.from_jax_params(refs["params"], cfg, device="cpu")


def _engine(cfg, params, use_kernels=True, capture=True, prompt_len=er.PREFILL_LEN):
    return ServingEngine(cfg, _ccfg(), ServeConfig(er.BATCH, prompt_len, er.MAX_NEW), params,
                         device="cpu", use_kernels=use_kernels, capture=capture)


def _within(got, want, tol, what):
    """max |got - want| <= tol x the largest |want| (>= 1)."""
    g, w = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert g.shape == w.shape, what
    err, top = np.abs(g - w).max(), max(np.abs(w).max(), 1.0)
    assert err <= tol * top, f"{what}: {err:.3g} > {tol:.3g} x {top:.3g}"


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


# ---- schema --------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


@pytest.mark.parametrize("arch", [er.SEAMLESS, er.LLAVA])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_schema_matches_reference(arch, smoke):
    got = dict(_leaves(registry.schema(configs.get_arch(arch, smoke=smoke))))
    want = dict(_leaves(jregistry.schema(jconfigs.get_arch(arch, smoke=smoke))))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == tuple(w.shape) and _dtype(g) == np.dtype(w.dtype).name, path
    proj = "audio_proj" if arch == er.SEAMLESS else "vision_proj"
    assert proj in got
    cfg = configs.get_arch(arch, smoke=smoke)
    assert cfg.param_count() == jconfigs.get_arch(arch, smoke=smoke).param_count()
    if arch == er.SEAMLESS and not smoke:
        assert sum(int(np.prod(d.shape)) for d in got.values()) == 978_909_184


# ---- attention ------------------------------------------------------------------

@pytest.mark.parametrize("use", ["causal", "encoder", "cross"])
def test_gqa_forward_matches_reference(refs, use):
    cfg, params = _port(refs)
    a = er.attention_inputs()
    x, mem = torch.from_numpy(a["x"]).to(torch.bfloat16), torch.from_numpy(a["mem"])
    dec, enc = (common.layer_slice(params[k], 0) for k in ("dec_layers", "enc_layers"))
    p, inp, kw, n_rows = {
        "causal": (dec["self_attn"], x, dict(causal=True), er.ATTN_Q),
        "encoder": (enc["attn"], mem, dict(causal=False), er.ATTN_KV),
        "cross": (dec["cross_attn"], x, dict(causal=False, kv_x=mem), er.ATTN_Q)}[use]
    probe = sal.select_probes(n_rows)
    y, aux = attention.gqa_forward(p, inp, cfg, probe=probe, q_block=er.ATTN_Q_BLOCK, **kw)
    want = refs["attn"][use]
    assert y.dtype == inp.dtype and aux.k.dtype == (mem if use != "causal" else x).dtype
    # out: bf16 within one bf16 ulp of its largest value; f32 (the encoder's)
    # within 1e-4 of it (f32 sums in another order)
    _within(y, want["y"], 2 ** -7 if y.dtype == torch.bfloat16 else 1e-4, "out")
    for name, got in (("k", aux.k), ("v", aux.v), ("saliency", aux.saliency)):
        _within(got, want[name], 1e-4, name)
    np.testing.assert_array_equal(to_np(aux.probe_nnz), to_np(want["nnz"]))
    if use != "causal":   # non-causal: every probe row sees every column
        assert bool((aux.probe_nnz == probe.positions.shape[0]).all())
    # rotary on self-attention only: the cross keys are the plain projection
    plain_k = common.einsum("ble,ehd->bhld", kw.get("kv_x", inp), p["wk"])
    assert torch.equal(aux.k, plain_k) == (use == "cross")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_encode_matches_reference(refs, dtype):
    cfg, params = _port(refs)
    got = encdec.encode(params, torch.from_numpy(er.attention_inputs()["src"]).to(dtype), cfg)
    want = refs["encode"][_dtype(torch.empty((), dtype=dtype))]
    assert got.dtype == dtype and _dtype(got) == want.dtype.name
    _within(got, want, 1e-4 if dtype == torch.float32 else 2 ** -7, "encoder output")


# ---- prefill, decode, fold ---------------------------------------------------------

def _prefill(cfg, params, ctx, inputs, frames=torch.float32):
    batch = {k: torch.as_tensor(v) for k, v in inputs.items()}
    batch["frontend_embeds"] = batch["frontend_embeds"].to(frames)
    with torch.inference_mode():
        return registry.prefill(params, batch, cfg, ctx)


def _flat(caches):
    return [{kind: er.flat(gc[kind]) for kind in ("self", "cross")} for gc in caches["groups"]]


def _param_dtypes(flat_el):
    return {k: _dtype(v) if isinstance(v, torch.Tensor) else v.dtype.name
            for k, v in flat_el.items()}


@pytest.mark.parametrize("route", list(ROUTES))
def test_prefill_on_f32_frames_matches_reference(refs, route):
    """The serve CLI's f32 frames: the encoder, the cross K/V and the cross
    stores' parameters run in f32.  Held: logits within one bf16 ulp;
    every cache's dtypes the reference's, its positions and probe counts
    exactly; the codes of every cross cache and of the first layer's self
    cache (whose input is bitwise the reference's) exactly, and of the
    second layer's self cache but for at most 1% (codes on a rounding
    boundary, see the module docstring); every float within QUANT_TOL."""
    cfg, params = _port(refs)
    eng = _engine(cfg, params, use_kernels=ROUTES[route])
    logits, caches = _prefill(cfg, params, eng.ctx, refs["prefill"]["inputs"])
    _within(logits, refs["prefill"]["logits"], 2 ** -7, "prefill logits")
    for i, (layer, want_layer) in enumerate(zip(_flat(caches), refs["prefill"]["caches"])):
        for kind in ("self", "cross"):
            got, want = layer[kind], want_layer[kind]
            assert set(got) == set(want)
            assert _param_dtypes(got) == _param_dtypes(want), (i, kind)
            store = "float32" if kind == "cross" else "bfloat16"
            assert {_dtype(got[f"{s}.{q}.{p}"]) for s in ("hi", "lo") for q in ("k", "v")
                    for p in ("scale", "zero")} == {store}
            assert _dtype(got["k_win"]) == "bfloat16"
            for name in POSITIONS + ("hi.nnz", "lo.nnz"):
                np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]),
                                              err_msg=f"layer {i} {kind} {name}")
            for name in ("hi.k.codes", "hi.v.codes", "lo.k.codes", "lo.v.codes"):
                g, w = to_np(got[name]), to_np(want[name])
                if kind == "cross" or i == 0:
                    np.testing.assert_array_equal(g, w, err_msg=f"layer {i} {kind} {name}")
                else:
                    assert (g != w).mean() <= 0.01, f"layer {i} {kind} {name}"
            for name in set(want) - set(INTEGERS):
                _within(got[name], want[name], QUANT_TOL, f"layer {i} {kind} {name}")


@pytest.mark.parametrize("route", list(ROUTES))
def test_prefill_on_bf16_frames_is_bitwise(refs, route):
    """The same frames in bf16: the encoder runs in bf16, every store holds
    bf16 parameters, and logits, codes, positions and parameters equal the
    reference's bit for bit; the f32 probe sums (acc) within 1e-4 of their
    largest value (sums in another order)."""
    cfg, params = _port(refs)
    eng = _engine(cfg, params, use_kernels=ROUTES[route])
    logits, caches = _prefill(cfg, params, eng.ctx, refs["prefill"]["inputs"], torch.bfloat16)
    np.testing.assert_array_equal(to_np(logits), to_np(refs["prefill_bf16"]["logits"]))
    for i, (layer, want_layer) in enumerate(zip(_flat(caches), refs["prefill_bf16"]["caches"])):
        for kind in ("self", "cross"):
            got, want = layer[kind], want_layer[kind]
            assert _param_dtypes(got) == _param_dtypes(want) and _dtype(got["hi.k.scale"]) \
                == "bfloat16", (i, kind)
            for name in want:
                if name.endswith("acc"):
                    _within(got[name], want[name], 1e-4, f"layer {i} {kind} {name}")
                else:
                    np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]),
                                                  err_msg=f"layer {i} {kind} {name}")


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_and_fold_match_reference(refs, route):
    """Three decode steps (probe, plain, probe), a fold, a probe step.  Held:
    each step's logits within QUANT_TOL of the reference's; after the steps,
    every cache's positions exactly and the first layer's self cache (codes,
    window) exactly; the cross caches' probe state (acc within QUANT_TOL,
    nnz exactly) as the reference's; the fold leaves every cross cache bit
    for bit as it was, here and in the reference, and folds the first
    layer's self cache as the reference does."""
    cfg, params = _port(refs)
    eng = _engine(cfg, params, use_kernels=ROUTES[route])
    ctx, dec = eng.ctx, refs["decode"]
    logits, caches = _prefill(cfg, params, ctx, refs["prefill"]["inputs"])
    cross0 = _flat(caches)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    with torch.inference_mode():
        for i, probe in enumerate(er.DECODE_PROBES):
            logits, caches = registry.decode_step(params, tok, caches, cfg, ctx, probe)
            _within(logits, dec["logits"][i], QUANT_TOL, f"decode step {i} logits")
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        folded = registry.recompress(caches, cfg, ctx)
        logits, _ = registry.decode_step(params, tok, folded, cfg, ctx, True)
    _within(logits, dec["after_fold"], QUANT_TOL, "logits after the fold")
    got, got_f = _flat(caches), _flat(folded)
    for i in range(cfg.n_layers):
        for kind in ("self", "cross"):
            g, w = got[i][kind], dec["caches"][i][kind]
            for name in POSITIONS:
                np.testing.assert_array_equal(to_np(g[name]), to_np(w[name]),
                                              err_msg=f"layer {i} {kind} {name}")
        cross, cross_f, want_c = got[i]["cross"], got_f[i]["cross"], dec["caches"][i]["cross"]
        for name in cross:
            assert torch.equal(cross[name], cross_f[name]), f"layer {i}: the fold moved {name}"
            np.testing.assert_array_equal(to_np(dec["folded"][i]["cross"][name]),
                                          to_np(want_c[name]))
        for name in ("hi.nnz", "lo.nnz"):
            np.testing.assert_array_equal(to_np(cross[name]), to_np(want_c[name]))
        for name in ("hi.acc", "lo.acc"):
            _within(cross[name], want_c[name], QUANT_TOL, f"layer {i} cross {name}")
            # probe steps moved it: it is no longer the prefill's
            assert not torch.equal(cross[name], cross0[i]["cross"][name])
    for tree, want in ((got, dec["caches"]), (got_f, dec["folded"])):
        for name in INTEGERS + ("k_win", "v_win"):
            np.testing.assert_array_equal(to_np(tree[0]["self"][name]),
                                          to_np(want[0]["self"][name]), err_msg=name)


# ---- the engine ------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_engine_tokens_match_reference(refs, route):
    cfg, params = _port(refs)
    eng = _engine(cfg, params, use_kernels=ROUTES[route])
    out = eng.generate(er.engine_inputs(cfg, er.PREFILL_LEN, er.PREFILL_LEN))
    np.testing.assert_array_equal(out["tokens"], refs["engine"]["tokens"])
    assert eng.cache_bytes(eng.last_caches) == refs["engine"]["bytes"]


class _Recorder:
    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, *args):
        logits, caches = self.step(*args)
        self.logits.append(logits.clone())
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


def _addresses(caches):
    from repro_torch.core import kvcache as kvc
    return [t.data_ptr() for el in registry.cache_elements(caches) for t in kvc.tree_leaves(el)]


def test_captured_step_is_bitwise_eager(refs):
    """The static-buffer lockstep step (the CPU's route of a captured step)
    against capture=False: every step's logits bitwise, tokens equal; the
    static tree holds a self and a cross cache per decoder layer, each leaf
    at one address through a second batch."""
    cfg, params = _port(refs)
    inputs = er.engine_inputs(cfg, er.PREFILL_LEN, er.PREFILL_LEN)
    runs = []
    for capture in (True, False):
        eng = _engine(cfg, params, capture=capture)
        eng._decode = _Recorder(eng._decode)
        runs.append((eng, eng.generate(inputs)["tokens"]))
    (eng, tokens), (eager, want) = runs
    np.testing.assert_array_equal(tokens, want)
    assert len(eng._decode.logits) == er.MAX_NEW
    for a, w in zip(eng._decode.logits, eager._decode.logits):
        assert torch.equal(a, w)
    step = eng._decode.step
    assert step.captures == 1 and 0 < step.replays < er.MAX_NEW
    assert not hasattr(eng, "_decode_masked")   # no continuous program on the lockstep engine
    assert [set(gc) for gc in step.caches["groups"]] == [{"self", "cross"}] * cfg.n_layers
    before = _addresses(step.caches)
    eng.generate(er.engine_inputs(cfg, er.PREFILL_LEN, er.PREFILL_LEN))
    assert _addresses(step.caches) == before and step.captures == 1


# ---- refusals --------------------------------------------------------------------

@pytest.mark.parametrize("arch", [er.SEAMLESS, er.LLAVA])
def test_continuous_engine_refuses_encdec_and_frontends(arch):
    scfg = dict(batch_size=2, prompt_len=32, max_new_tokens=4)
    with pytest.raises(NotImplementedError) as want:
        JContinuousEngine(jconfigs.get_arch(arch, smoke=True), JCompression.zipcache(),
                          JServeConfig(**scfg), None)
    cfg = configs.get_arch(arch, smoke=True)
    with pytest.raises(NotImplementedError) as got:
        ContinuousEngine(cfg, CompressionConfig.zipcache(), ServeConfig(**scfg), None,
                         device="cpu")
    assert str(got.value) == str(want.value)


def test_precision_map_refused_on_encdec():
    cfg = configs.get_arch(er.SEAMLESS, smoke=True)
    scfg = ServeConfig(2, 32, 4, precision_map="default=k8v8;layer:1-=k3v3")
    with pytest.raises(ValueError, match="precision map has no effect on an encoder-decoder"):
        ServingEngine(cfg, CompressionConfig.zipcache(), scfg, None, device="cpu")


def test_encdec_recompress_refuses_slot_and_rung(refs):
    cfg, params = _port(refs)
    eng = _engine(cfg, params)
    _, caches = _prefill(cfg, params, eng.ctx, refs["prefill"]["inputs"])
    with pytest.raises(ValueError, match="per-slot"):
        registry.recompress(caches, cfg, eng.ctx, slot=0)
    with pytest.raises(ValueError, match="ladder"):
        registry.recompress(caches, cfg, eng.ctx, rung=torch.zeros(2, dtype=torch.int32))
