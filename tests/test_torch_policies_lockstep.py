"""Port parity for the baseline policies on the lockstep engine: greedy
tokens of `ServingEngine.generate` on yi-6b smoke (fp_window 8, recompress
interval 8: probe steps and a fold inside 10 tokens) equal to the JAX
package's engine, for mikv, h2o, fp16, gear and kivi, with the JAX
parameters carried over by `convert.from_jax_params`; the port's engine
with its static-buffer step (whose tree a baseline's first fold promotes
to f32, so it is built again, as the reference's jitted step retraces) and
with `capture=False`.

The JAX engine runs op by op (`jax.disable_jit()`), as in
tests/test_torch_slice.py, which says why.
"""

import dataclasses

import jax
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
from repro_torch.serving import ServeConfig, ServingEngine, pack_requests
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
POLICIES = ["mikv", "h2o", "fp16", "gear", "kivi"]
BATCH, PROMPT, MAX_NEW = 2, 24, 10


def _batch(vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(PROMPT,)).astype(np.int32) for _ in range(BATCH)]
    return {"tokens": pack_requests(prompts, BATCH, PROMPT)}


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's greedy tokens under each policy."""
    cfg = jconfigs.get_arch("yi-6b", smoke=True)
    params = jregistry.materialize_params(cfg, seed=0)
    out = {"params": jax.device_get(params)}
    with jax.disable_jit():
        for policy in POLICIES:
            ccfg = dataclasses.replace(JCompression.preset(policy), fp_window=8,
                                       recompress_interval=8)
            eng = JServingEngine(cfg, ccfg, JServeConfig(BATCH, PROMPT, MAX_NEW), params)
            out[policy] = eng.generate(_batch(cfg.vocab))["tokens"]
    return out


@pytest.mark.parametrize("capture", [True, False], ids=["static-buffers", "eager"])
@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_tokens_match_reference(reference, policy, capture):
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.preset(policy), fp_window=8,
                               recompress_interval=8)
    params = convert.from_jax_params(reference["params"], cfg, device="cpu")
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW), params, device="cpu",
                        capture=capture)
    np.testing.assert_array_equal(eng.generate(_batch(cfg.vocab))["tokens"], reference[policy])
    if capture:   # mikv's stores keep their dtype; the others' fold promotes them
        assert eng._decode.captures == (1 if policy == "mikv" else 2)


@pytest.mark.parametrize("continuous", [False, True], ids=["lockstep", "continuous"])
@pytest.mark.parametrize("policy", ["zipcache", "mikv", "kivi", "gear", "h2o", "fp16"])
def test_serve_cli_runs_every_policy(policy, continuous, capsys):
    """`python -m repro_torch.launch.serve --policy p` for every preset:
    --smoke folds every 16 tokens, so 18 new tokens cross a fold; the
    continuous run on the paged free list with the page walk."""
    from repro_torch.launch import serve

    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--policy", policy,
            "--batch", "2", "--prompt-len", "16", "--max-new", "18"]
    if continuous:
        argv += ["--continuous", "--requests", "3", "--backend", "paged", "--page-size", "8",
                 "--page-allocator", "freelist", "--pool-fraction", "0.75",
                 "--paged-kernel", "on"]
    out = serve.main(argv)
    if continuous:
        assert [len(r.tokens) for r in out.values()] == [18] * 3
        assert "admissions deferred" in capsys.readouterr().out
    else:
        assert out["tokens"].shape == (2, 18)
        assert f"policy={policy}" in capsys.readouterr().out


def test_example_runs_on_cpu(capsys):
    """`python -m repro_torch.examples.serve_zipcache --device cpu` at smoke
    size: every request served, the streamed tokens equal to the result's,
    then the lockstep comparison in which fp16 holds the most bytes and
    zipcache the fewest, as their Appendix-A ratios order them."""
    from repro_torch.examples import serve_zipcache

    out = serve_zipcache.main(["--device", "cpu", "--slots", "2", "--requests", "4",
                               "--prompt-len", "32", "--max-new", "20", "--backend", "paged",
                               "--page-size", "8", "--page-allocator", "freelist",
                               "--pool-fraction", "0.75", "--paged-kernel", "on"])
    printed = capsys.readouterr().out
    assert "(== result: True)" in printed and "Appendix-A compression ratio" in printed
    assert len(out["continuous"]) == 4
    assert all(len(r.tokens) >= 1 for r in out["continuous"].values())
    lock = out["lockstep"]
    assert [lock[p]["tokens"].shape for p in serve_zipcache.POLICIES] == [(2, 20)] * 3
    assert lock["fp16"]["ratio"] == 1.0 < lock["gear"]["ratio"] < lock["zipcache"]["ratio"]
    assert lock["fp16"]["packed_bytes"] > lock["gear"]["packed_bytes"] \
        > lock["zipcache"]["packed_bytes"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_example_refuses_a_missing_card():
    """No quiet fall-back to the CPU: without a card the default device fails."""
    from repro_torch.examples import serve_zipcache

    with pytest.raises((RuntimeError, AssertionError)):
        serve_zipcache.main(["--slots", "1", "--requests", "1"])
