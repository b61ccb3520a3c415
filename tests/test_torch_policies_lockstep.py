"""Port parity for the baseline policies on the lockstep engine: greedy
tokens of `ServingEngine.generate` on yi-6b smoke (fp_window 8, recompress
interval 8: probe steps and a fold inside 10 tokens) equal to the JAX
package's engine, for mikv, h2o, fp16, gear and kivi, with the JAX
parameters carried over by `convert.from_jax_params`; the port's engine
with its static-buffer step (whose tree a baseline's first fold promotes
to f32, so it is built again, as the reference's jitted step retraces) and
with `capture=False`.

The JAX engine runs jitted in a child process (`tests/serving_reference.py`:
excess precision and the algebraic simplifier off, so it takes the op-by-op
run's tokens).  The ported examples print the JAX examples' lines.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ServeConfig, ServingEngine, pack_requests
from tests import serving_reference as sr
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
POLICIES = list(sr.LOCKSTEP_POLICIES)
BATCH, PROMPT, MAX_NEW = sr.LOCK_BATCH, sr.LOCK_PROMPT, sr.LOCK_NEW


def _batch(vocab):
    return sr.lockstep_batch(vocab, pack_requests)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX engine's greedy tokens under each policy."""
    return sr.run(tmp_path_factory.mktemp("lockstep_policies") / "ref.pkl", "lockstep_policies")


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


def _jax_example_output(script: str, call: str, capsys) -> str:
    """What the JAX package's example prints (`examples/<script>`, its
    module body run, then `call`, op by op)."""
    import runpy
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / script
    capsys.readouterr()
    ns = runpy.run_path(str(path), run_name="example")
    if call:
        eval(call, ns)
    return capsys.readouterr().out


def test_quickstart_example_prints_the_reference_figures(capsys):
    """`python -m repro_torch.examples.quickstart --device cpu`: every line
    the JAX example prints (CSTQuant bytes and MSE, the top probe token,
    the packed bytes of the 4/2 cache, the fold's step and live tokens, the
    output shape), character for character."""
    from repro_torch.examples import quickstart
    want = _jax_example_output("quickstart.py", "", capsys)
    out = quickstart.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert out["folds"] == [(15, 272)]


def test_longcontext_example_prints_the_reference_figures(capsys):
    """`python -m repro_torch.examples.longcontext_retrieval --device cpu` at
    a 256-token cache and 2 trials: the JAX example's recall, value error
    and compression per policy, line for line."""
    from repro_torch.examples import longcontext_retrieval
    want = _jax_example_output("longcontext_retrieval.py", "main(l=256, trials=2)", capsys)
    figures = longcontext_retrieval.main(["--device", "cpu", "--length", "256", "--trials", "2"])
    assert capsys.readouterr().out == want
    assert figures["zipcache(4/2)"][2] > figures["h2o(evict 60%)"][2] >= 1.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_example_refuses_a_missing_card():
    """No quiet fall-back to the CPU: without a card the default device fails."""
    from repro_torch.examples import serve_zipcache

    with pytest.raises((RuntimeError, AssertionError)):
        serve_zipcache.main(["--slots", "1", "--requests", "1"])
