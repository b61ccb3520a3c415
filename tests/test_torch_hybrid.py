"""The SSM and hybrid models on the port's engines: mamba2-2.7b (every layer
a Mamba2 SSD mixer, no KV cache) and jamba-v0.1-52b (one 8-layer group:
layer 4 GQA under ZipCache, the rest SSD; odd layers MoE), smoke size.

  * `convert.from_jax_params` carries both JAX parameter trees over leaf for
    leaf (the `ssm.*` weights, Jamba's 8-layer stacked group);
  * lockstep greedy tokens equal the JAX `ServingEngine`'s, on the port's
    mixed and paged layouts (the JAX engine runs on the mixed one: its
    paged tokens are its mixed ones, tests/test_backend_conformance.py);
  * continuous tokens equal the JAX `ContinuousEngine`'s: mamba2 on the
    mixed and the paged static layout, at prompt buckets the reference
    accepts (multiples of its 32-token chunk, or below it); Jamba on every
    layout (mixed, paged static, the free list, the free list with
    shared-prefix dedup) against the JAX engine on the free list, built with
    its MoE refusal hidden.  Two slots: at the smoke config's decode
    capacity (2 per expert) no decode pair is dropped, so the port's masked
    dispatch and the reference's agree;
  * `cache_bytes` equal to the reference's integers, SSM states counted as
    overhead;
  * a swap round trip bitwise on Jamba, SSM rows included, and a swap
    pressure run whose tokens equal the uncontended and the recompute runs';
  * mamba2 on the free list (and the levers that need it) refused with a
    `ValueError` that names the cause (the reference: an `IndexError`);
  * left padding runs through the SSM and changes its state, in the port as
    in the reference;
  * a ragged admission bucket (48 tokens at chunk 32, which the reference
    refuses) gives the tokens of the lockstep engine at that prompt length;
  * the static-buffer decode steps (the CPU's route of a captured step)
    bitwise equal to `capture=False`, and the serve CLI on both archs.

The JAX engines run once, in a child process (`tests/hybrid_reference.py`),
jitted with XLA's excess precision off: each bf16 operation then rounds as
op by op and as the port's do.  Most of this file's time is that child.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core import alloc as alloc_lib
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import paged
from repro_torch.core import swap as swap_lib
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models.ssm import SSMState
from repro_torch.serving import ContinuousEngine, Request, ServeConfig, ServingEngine
from repro_torch.serving import pack_requests
from tests import hybrid_reference as hr
from tests.hybrid_reference import BATCH, FREELIST, JAMBA, LAYOUTS, MAMBA, MAX_NEW, PAGE, PROMPT
from tests.hybrid_reference import SHORT, STATE_FIELDS
from tests.torch_parity import to_np, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _ccfg():
    return dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return hr.run(tmp_path_factory.mktemp("hybrid") / "refs.pkl")


def _port(refs, arch):
    cfg = configs.get_arch(arch, smoke=True)
    return cfg, _ccfg(), convert.from_jax_params(refs[arch]["params"], cfg, device="cpu")


# ---- parameters --------------------------------------------------------------

@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_from_jax_params_converts_ssm_trees(refs, arch):
    ref = refs[arch]["params"]
    cfg, _, got = _port(refs, arch)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == len(jax.tree_util.tree_leaves(got))
    for path, want in flat_ref:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_array_equal(to_np(leaf), to_np(want))
    kinds = cfg.layer_kinds()
    assert len(got["groups"]) == cfg.scan_group == len(kinds)
    for j, (mixer, ffn) in enumerate(kinds):
        sub = got["groups"][f"sub{j}"]
        assert ("ssm" in sub) == (mixer == "ssm") and ("attn" in sub) == (mixer == "attn")
        assert ("moe" in sub) == (ffn == "moe")
    if arch == JAMBA:
        assert kinds == tuple(("attn" if j == 4 else "ssm", "moe" if j % 2 else "dense")
                              for j in range(8))
        assert got["groups"]["sub0"]["ssm"]["A_log"].shape == (cfg.n_scan_groups, 8)
    else:
        assert kinds == (("ssm", "none"),) and not cfg.first_dense_layers
    bad = {**ref, "groups": {**ref["groups"], "sub0": {**ref["groups"]["sub0"], "ssm": {}}}}
    with pytest.raises(ValueError, match="ssm"):
        convert.from_jax_params(bad, cfg, device="cpu")


# ---- the lockstep engine ------------------------------------------------------

@pytest.mark.parametrize("layout", ["mixed", "paged-static"])
@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_lockstep_tokens_match_reference(refs, arch, layout):
    cfg, ccfg, params = _port(refs, arch)
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW, **LAYOUTS[layout]),
                        params, device="cpu")
    np.testing.assert_array_equal(eng.generate(refs[arch]["batch"])["tokens"],
                                  refs[arch]["lockstep"])
    if layout == "mixed":
        assert eng.cache_bytes(eng.last_caches) == refs[arch]["lockstep_bytes"]


def test_left_padding_runs_through_the_ssm(refs):
    """Row 1's 4 tokens sit behind 60 pad tokens, and the SSD does not mask
    them: layer 0's state after the padded row differs from its state after
    the 4 tokens alone, in the reference as in the port, and each state is
    the reference's (within 1e-5 of its largest magnitude).  Layer 0's conv
    tails hold real tokens only, so they agree."""
    cfg, ccfg, params = _port(refs, MAMBA)
    eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW), params, device="cpu")
    toks = torch.from_numpy(refs[MAMBA]["batch"]["tokens"])
    with torch.inference_mode():
        got = [registry.prefill(params, {"tokens": t}, cfg, eng.ctx)[1]["groups"][0]["sub0"]
               for t in (toks, toks[1:, PROMPT - SHORT:])]
    want = refs[MAMBA]["states"]   # the reference's group 0 (its groups are stacked)
    for g, w in zip(got, want):
        for name in STATE_FIELDS:
            a, b = to_np(getattr(g, name)), to_np(w[name])
            assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0), name
    (padded, alone), (r_padded, r_alone) = got, want
    gap = (padded.ssm[1] - alone.ssm[0]).abs().max().item()
    r_gap = np.abs(to_np(r_padded["ssm"][1]) - to_np(r_alone["ssm"][0])).max()
    assert gap > 1e-2 and r_gap > 1e-2
    assert torch.equal(padded.conv_x[1], alone.conv_x[0])   # the tails hold real tokens only


# ---- the continuous engine ----------------------------------------------------

CONTINUOUS = [(MAMBA, "mixed"), (MAMBA, "paged-static"), (JAMBA, "mixed"),
              (JAMBA, "paged-static"), (JAMBA, "freelist"), (JAMBA, "prefix")]


@pytest.mark.parametrize("arch,layout", CONTINUOUS, ids=[f"{a}-{l}" for a, l in CONTINUOUS])
def test_continuous_tokens_match_reference(refs, arch, layout):
    cfg, ccfg, params = _port(refs, arch)
    eng = ContinuousEngine(cfg, ccfg, ServeConfig(batch_size=BATCH, prompt_len=PROMPT,
                                                  max_new_tokens=10, **LAYOUTS[layout]),
                           params, device="cpu")
    got = hr.scenario(eng, Request, hr.prompts(cfg.vocab))
    assert got == refs[arch]["continuous"]
    assert [len(t) for t, _ in got] == [10, 3, 10] and eng._n_folds >= 1
    if layout == hr.REFERENCE_LAYOUT[arch]:
        assert eng.cache_bytes(eng.caches) == refs[arch]["continuous_bytes"]
    if layout == "prefix":   # the repeat aliased the first's pages and its SSM snapshot
        assert eng.pool_stats()["prefix"]["hits"] == 1
    if layout == "freelist":
        stats, want = eng.pool_stats(), refs[arch]["stats"]
        assert stats["deferrals"] == want["deferrals"]
        for seg in ("hi", "lo", "win"):
            assert stats[seg] == want[seg] and stats[seg]["used"] == 0


def test_mamba2_cache_bytes_are_all_state(refs):
    """No KV element: nothing packed, every byte the states' overhead."""
    cfg, ccfg, params = _port(refs, MAMBA)
    eng = ContinuousEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, 10), params, device="cpu")
    got = eng.cache_bytes(eng.caches)
    states = registry.cache_elements(eng.caches)
    assert all(isinstance(el, SSMState) for el in states) and len(states) == cfg.n_layers
    assert got["packed_bytes"] == 0
    assert got["overhead_bytes"] == got["total_bytes"] == sum(kvc._nbytes(el) for el in states)


@pytest.mark.parametrize("lever", ["freelist", "swap", "downshift", "prefix"])
def test_mamba2_free_list_is_refused(refs, lever):
    cfg, ccfg, params = _port(refs, MAMBA)
    extra = {"swap": dict(preemption="swap"), "downshift": dict(preemption="downshift"),
             "prefix": dict(prefix_cache=True)}.get(lever, {})
    with pytest.raises(ValueError, match="no attention layer"):
        ContinuousEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, 10, **FREELIST, **extra), params,
                         device="cpu")


def test_ragged_bucket_equals_lockstep_at_its_length(refs):
    """A 40-token prompt at page 16 takes a 48-token bucket, which the
    reference's chunk assert refuses (48 % 32): the port runs a ragged last
    chunk, and its tokens are the lockstep engine's at prompt length 48."""
    cfg, ccfg, params = _port(refs, MAMBA)
    prompt = hr.prompts(cfg.vocab, (40,))[0]
    eng = ContinuousEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, 10, **LAYOUTS["paged-static"]),
                           params, device="cpu")
    assert eng._bucket_len(40) == 48
    rid = eng.submit(Request(tokens=prompt))
    got = eng.run()[rid].tokens
    lock = ServingEngine(cfg, ccfg, ServeConfig(BATCH, 48, 10), params, device="cpu")
    want = lock.generate({"tokens": pack_requests([prompt], BATCH, 48)})["tokens"][0]
    np.testing.assert_array_equal(got, want)


# ---- the swap tier on Jamba ---------------------------------------------------

def test_swap_round_trip_is_bitwise_with_ssm_rows(refs):
    """A Jamba tree's slot out to a host entry and back: the payload holds
    every SSM layer's rows; after the slot is freed and its state rows are
    overwritten, the restore gives back every leaf's row bit for bit."""
    cfg, ccfg, params = _port(refs, JAMBA)
    eng = ContinuousEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, 10, **FREELIST), params,
                           device="cpu")
    rid = eng.submit(Request(tokens=hr.prompts(cfg.vocab)[0]))
    for _ in range(3):
        eng.step()
    with torch.inference_mode():
        _swap_round_trip(eng.caches)
    assert eng.result(rid) is None


def _swap_round_trip(tree):
    payload = registry.extract_caches(tree, 0)
    els = registry.cache_elements(tree)
    n_state = sum(isinstance(el, SSMState) for el in els)
    assert n_state == 7 and len(payload) == 4 * n_state + len(
        paged.extract_slot(tree["groups"][0]["sub4"], 0))
    pool = swap_lib.HostSwapPool(payload, fallback_entries=1)
    handle = pool.reserve()
    pool.store(handle, payload)
    want = [[t[0].clone() for t in kvc.tree_leaves(el)] for el in els]
    scrambled = registry.map_caches(
        lambda el: kvc.tree_map(lambda t: t.clone().fill_(7), el) if isinstance(el, SSMState)
        else el, registry.free_caches(tree, 0))
    back = registry.restore_caches(scrambled, pool.load(handle, torch.device("cpu")), 0)
    pool.release(handle)
    for el, w in zip(registry.cache_elements(back), want):
        for t, wt in zip(kvc.tree_leaves(el), w):
            assert torch.equal(t[0], wt)


def _swap_run(make, prompts, preemption, contended=True):
    """Two longs, then (contended) an urgent short that forces a victim."""
    eng = make(dict(batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8,
                    backend="paged", page_allocator="freelist", scheduler="priority",
                    preemption=preemption))
    rids = [eng.submit(Request(tokens=prompts[0])), eng.submit(Request(tokens=prompts[1]))]
    for _ in range(4):
        eng.step()
    if contended:
        rids.append(eng.submit(Request(tokens=prompts[2], max_new_tokens=3, priority=2)))
    while eng.pending:
        eng.step()
        eng._alloc.check_invariants()
    return [eng.result(r).tokens.tolist() for r in rids], eng.pool_stats()


def test_swap_pressure_keeps_tokens(refs):
    """Jamba under swap pressure: a swap-out and a swap-in fire, and the
    tokens equal the recompute run's and, for the longs, the uncontended
    run's: the restored SSM rows and KV pages decode on as if never moved."""
    cfg, ccfg, params = _port(refs, JAMBA)

    def make(kw):
        return ContinuousEngine(cfg, ccfg, ServeConfig(**kw), params, device="cpu")

    prompts = hr.prompts(cfg.vocab, (48, 48, 40))
    alone, _ = _swap_run(make, prompts, "recompute", contended=False)
    rc, _ = _swap_run(make, prompts, "recompute")
    sw, stats = _swap_run(make, prompts, "swap")
    assert stats["swap"]["swaps_out"] >= 1 and stats["swap"]["swaps_in"] == stats["swap"][
        "swaps_out"]
    assert sw == rc and sw[:2] == alone


# ---- the static-buffer steps and the CLI ---------------------------------------

@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_static_route_is_bitwise_eager(refs, arch):
    """Both engines' static-buffer decode steps (the CPU's plain version of a
    replay) against `capture=False`: tokens equal, every step's logits
    bitwise, the step built once and replayed."""
    cfg, ccfg, params = _port(refs, arch)
    layout = FREELIST if arch == JAMBA else LAYOUTS["paged-static"]
    for continuous in (False, True):
        runs = []
        for capture in (True, False):
            if continuous:
                eng = ContinuousEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, 10, **layout), params,
                                       device="cpu", capture=capture)
                toks = hr.scenario(eng, Request, hr.prompts(cfg.vocab))
                step = eng._decode_masked
            else:
                eng = ServingEngine(cfg, ccfg, ServeConfig(BATCH, PROMPT, MAX_NEW), params,
                                    device="cpu", capture=capture)
                toks = eng.generate(refs[arch]["batch"])["tokens"].tolist()
                step = eng._decode
            runs.append((toks, step))
        (toks, step), (want, eager) = runs
        assert toks == want
        assert step.captures == 1 and step.replays > 0 and eager.captures == 0


@pytest.mark.parametrize("arch,extra", [
    (MAMBA, []), (MAMBA, ["--continuous", "--requests", "3", "--backend", "paged"]),
    (JAMBA, ["--continuous", "--requests", "3", "--backend", "paged", "--page-allocator",
             "freelist", "--page-size", "8", "--paged-kernel", "on"]),
    (JAMBA, ["--continuous", "--requests", "3", "--backend", "paged", "--page-allocator",
             "freelist", "--page-size", "8", "--pool-fraction", "0.75", "--scheduler",
             "priority", "--preemption", "swap", "--swap-pool-mb", "4", "--ladder-watermark",
             "0.05", "--precision-map", "default=k8v8;layer:1-=k3v3"])],
    ids=["mamba2", "mamba2-continuous", "jamba-freelist", "jamba-levers"])
def test_serve_cli_runs_hybrid_archs_on_cpu(capsys, arch, extra):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--max-new", "4", *extra])
    printed = capsys.readouterr().out
    assert "kernel launches" in printed
    if extra:
        assert all(f"req-{i}: 4 tok" in printed for i in range(3))
    else:
        assert f"{arch} policy=zipcache" in printed and out["tokens"].shape == (2, 4)


def test_alloc_refuses_a_tree_without_kv():
    cfg = configs.get_arch(MAMBA, smoke=True)
    ctx = ServingEngine(cfg, _ccfg(), ServeConfig(BATCH, PROMPT, 10, backend="paged"),
                        registry.materialize_params(cfg, device="cpu"), device="cpu").ctx
    tree = registry.init_caches(cfg, ctx, 2, device="cpu")
    assert backend_lib.kv_elements(tree) == []
    with pytest.raises(ValueError, match="no attention layer"):
        alloc_lib.FreeListAllocator.from_caches(tree, PAGE)
    with pytest.raises(ValueError, match="no attention layer"):
        alloc_lib.slice_occupancy(tree)
