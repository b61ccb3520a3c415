"""Port parity for the whole slice: the lockstep `ServingEngine.generate` on
yi-6b smoke (zipcache, fp_window 8, recompress interval 8: probe steps and a
fold inside 12 tokens) against the JAX package's, with the JAX parameters
carried over by `convert.from_jax_params`.

The JAX engine runs op by op (`jax.disable_jit()`): under jit the CPU
compiler contracts a*b+c into fused multiply-adds (the rotary embedding's
x1*cos - x2*sin, measured), so the jitted program differs from its own
op-by-op run in the last bit, and a bf16 rounding there can flip a 2-bit
zero point at a recompression or an argmax near-tie.  Op by op, the port
reproduces the reference bit for bit on these shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.serving import ServeConfig, ServingEngine, pack_requests
from tests.torch_parity import to_np, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
BATCH, PROMPT, MAX_NEW = 2, 48, 12


def _batch(seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, vocab, size=(PROMPT,)).astype(np.int32) for _ in range(BATCH)]
    return {"tokens": pack_requests(prompts, BATCH, PROMPT)}


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's tokens and prefill logits on two prompt batches."""
    cfg = jconfigs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    params = jregistry.materialize_params(cfg, seed=0)
    out = {"params": jax.device_get(params)}
    with jax.disable_jit():
        eng = JServingEngine(cfg, ccfg, JServeConfig(BATCH, PROMPT, MAX_NEW), params)
        for seed in (0, 1):
            batch = _batch(seed, cfg.vocab)
            logits, _ = jregistry.prefill(params, {"tokens": jnp.asarray(batch["tokens"])},
                                          cfg, eng.ctx)
            out[seed] = (batch, eng.generate(batch)["tokens"], to_np(logits))
    return out


def _engine(reference, use_kernels):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")
    return ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW), params, device="cpu",
                         use_kernels=use_kernels)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-route", "plain"])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_tokens_match_reference(reference, seed, use_kernels):
    batch, want, _ = reference[seed]
    got = _engine(reference, use_kernels).generate(batch)["tokens"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_logits_match_reference(reference, seed):
    """bf16 logits within one bf16 ulp of the largest (observed: identical)."""
    batch, _, want = reference[seed]
    eng = _engine(reference, use_kernels=True)
    logits, _ = registry.prefill(eng.params, {"tokens": torch.as_tensor(batch["tokens"])},
                                 eng.cfg, eng.ctx)
    got = to_np(logits)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()


def test_from_jax_params_checks_the_layout(reference):
    cfg = configs.get_arch("yi-6b", smoke=True)
    bad = dict(reference["params"], final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        convert.from_jax_params(bad, cfg, device="cpu")


@pytest.mark.parametrize("extra", [[], ["--profile"]], ids=["plain", "profile"])
def test_serve_cli_runs_on_cpu(capsys, extra):
    out = serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--max-new", "4", *extra])
    assert out["tokens"].shape == (2, 4)
    printed = capsys.readouterr().out
    assert "kernel launches" in printed
    assert ("busy share" in printed) == bool(extra)
