"""The lockstep engine on the encoder-decoder past 128 source frames, the
serve CLI's encoder-decoder inputs, and the vision frontend (llava-next-34b
smoke: 16 patch embeddings before the text), against the JAX package.

  * seamless-m4t-medium at 256 source frames and a 128-token decoder
    prompt: the greedy tokens equal the JAX engine's, on the kernel route
    and the plain route (fp_window 8, recompress interval 8: probe steps
    and a fold within 12 tokens), and `cache_bytes` its integers.  The
    JAX engine refuses a 256-token decoder prompt (its self cache is sized
    for min(128, prompt_len) tokens); the port's serve CLI packs the
    decoder prompt to 128 tokens beside 256 f32 frames, and refuses
    `--continuous` for the encoder-decoder.  The frames are bf16 here: on
    f32 frames the encoder's f32 sums, in another order on torch's CPU
    BLAS than in XLA's, move a bf16 rounding in the cross-attention output
    and, through the smoke model's random weights, a token near a tie
    after the fold (`tests/test_torch_encdec.py` holds the f32 path
    function by function);
  * llava: `lm.embed_inputs` (the embeddings cast to bf16, projected by
    `vision_proj`, put before the text) bitwise; the prefill with
    `frontend_embeds` (probes over all 64 query positions): logits bitwise,
    every cache artifact but the f32 probe sums bitwise; the lockstep
    engine's greedy tokens equal the JAX engine's, both routes.

The references run op by op in two child processes at once
(`tests/encdec_reference.py`, parts "seamless-long" and "llava").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import serve
from repro_torch.models import lm, registry
from repro_torch.serving import ServeConfig, ServingEngine
from tests import encdec_reference as er
from tests.torch_parity import to_np, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ROUTES = {"kernel-route": True, "plain": False}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return er.run(tmp_path_factory.mktemp("encdec_engine"), "seamless-long", "llava")


def _ccfg():
    return dataclasses.replace(CompressionConfig.zipcache(), **er.ccfg_kwargs())


def _port(refs, arch):
    cfg = configs.get_arch(arch, smoke=True)
    return cfg, convert.from_jax_params(refs[arch]["params"], cfg, device="cpu")


# ---- seamless past 128 frames ----------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_long_source_tokens_match_reference(refs, route):
    cfg, params = _port(refs, er.SEAMLESS)
    inputs = er.long_inputs(cfg)
    eng = ServingEngine(cfg, _ccfg(), ServeConfig(er.BATCH, er.LONG_PROMPT, er.MAX_NEW), params,
                        device="cpu", use_kernels=ROUTES[route])
    assert eng.ctx.max_cache_len == 128 + er.MAX_NEW
    assert eng.ctx.probe.positions.max() < 128
    out = eng.generate({"tokens": inputs["tokens"],
                        "frontend_embeds": to_torch(inputs["frontend_embeds"])})
    np.testing.assert_array_equal(out["tokens"], refs[er.SEAMLESS]["tokens"])
    assert eng.cache_bytes(eng.last_caches) == refs[er.SEAMLESS]["bytes"]
    self0, cross0 = (eng.last_caches["groups"][0][k] for k in ("self", "cross"))
    assert cross0.hi.capacity + cross0.lo.capacity == er.LONG_PROMPT
    assert self0.hi.capacity + self0.lo.capacity == 128 + er.MAX_NEW


def test_decoder_prompt_is_packed_to_128(refs, monkeypatch):
    """The JAX engine refuses a 256-token decoder prompt (tracing its
    prefill raises); the port's CLI packs the decoder prompt to 128 tokens
    beside 256 f32 frames and refuses --continuous for the arch."""
    jcfg = jconfigs.get_arch(er.SEAMLESS, smoke=True)
    jeng = JServingEngine(jcfg, dataclasses.replace(JCompression.zipcache(), **er.ccfg_kwargs()),
                          JServeConfig(er.BATCH, er.LONG_PROMPT, er.MAX_NEW),
                          jax.tree_util.tree_map(jnp.asarray, refs[er.SEAMLESS]["params"]))
    with pytest.raises(ValueError, match="exceed store capacity"):
        jeng.generate(er.engine_inputs(jcfg, er.LONG_PROMPT, er.LONG_PROMPT))
    seen = []
    generate = ServingEngine.generate

    def spy(self, batch, *a, **kw):
        seen.append({k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in batch.items()})
        return generate(self, batch, *a, **kw)

    monkeypatch.setattr(ServingEngine, "generate", spy)
    argv = ["--arch", er.SEAMLESS, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", str(er.LONG_PROMPT), "--max-new", "3"]
    out = serve.main(argv)
    assert out["tokens"].shape == (2, 3)
    assert seen == [{"tokens": ((2, 128), np.dtype(np.int32)),
                     "frontend_embeds": ((2, er.LONG_PROMPT, 64), np.dtype(np.float32))}]
    with pytest.raises(SystemExit):
        serve.main(argv + ["--continuous"])


# ---- llava's vision frontend ------------------------------------------------------

def test_embed_inputs_match_reference(refs):
    cfg, params = _port(refs, er.LLAVA)
    ref = refs[er.LLAVA]
    inputs = {k: torch.as_tensor(v) for k, v in ref["inputs"].items()}
    got = lm.embed_inputs(params, cfg, inputs["tokens"], inputs["frontend_embeds"])
    assert got.dtype == torch.bfloat16
    assert got.shape == (er.BATCH, er.PREFILL_LEN, cfg.d_model)
    np.testing.assert_array_equal(to_np(got), to_np(ref["embed"]))
    text = lm.embed_inputs(params, cfg, inputs["tokens"])
    assert torch.equal(got[:, cfg.n_frontend_tokens:], text)


@pytest.mark.parametrize("route", list(ROUTES))
def test_frontend_prefill_matches_reference(refs, route):
    cfg, params = _port(refs, er.LLAVA)
    ref = refs[er.LLAVA]
    eng = ServingEngine(cfg, _ccfg(), ServeConfig(er.BATCH, er.PREFILL_LEN, er.MAX_NEW), params,
                        device="cpu", use_kernels=ROUTES[route])
    assert eng.ctx.probe.positions.max() >= cfg.n_frontend_tokens   # probes span the query
    with torch.inference_mode():
        logits, caches = registry.prefill(
            params, {k: torch.as_tensor(v) for k, v in ref["inputs"].items()}, cfg, eng.ctx)
    np.testing.assert_array_equal(to_np(logits), to_np(ref["logits"]))
    for g, want in enumerate(ref["caches"]):
        got = er.flat(caches["groups"][g]["sub0"])
        assert set(got) == set(want)
        for name, w in want.items():
            a = to_np(got[name])
            if name.endswith("acc"):   # f32 probe sums in another order
                assert np.abs(a - to_np(w)).max() <= 1e-4 * max(np.abs(to_np(w)).max(), 1.0)
            else:
                np.testing.assert_array_equal(a, to_np(w), err_msg=f"group {g} {name}")


@pytest.mark.parametrize("route", list(ROUTES))
def test_frontend_tokens_match_reference(refs, route):
    cfg, params = _port(refs, er.LLAVA)
    ref = refs[er.LLAVA]
    eng = ServingEngine(cfg, _ccfg(), ServeConfig(er.BATCH, er.PREFILL_LEN, er.MAX_NEW), params,
                        device="cpu", use_kernels=ROUTES[route])
    np.testing.assert_array_equal(eng.generate(ref["inputs"])["tokens"], ref["tokens"])


def test_serve_cli_runs_llava_smoke(capsys):
    out = serve.main(["--arch", er.LLAVA, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "32", "--max-new", "3"])
    assert out["tokens"].shape == (2, 3)
    assert "llava-next-34b" in capsys.readouterr().out
