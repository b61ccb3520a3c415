"""The cache tree with a prefix layer: DeepSeek-V2-Lite's first dense layer
is unrolled before the stacked groups, so its cache element sits in
`caches["prefix"]`, and every walk over the tree must take it.

  * `convert.from_jax_params` carries the JAX package's DeepSeek smoke tree
    (a prefix layer, stacked MoE experts, an f32 router) over leaf for leaf;
  * every walk — `registry.insert_caches`, `free_caches`, `extract_caches` /
    `restore_caches`, `copy_caches`, `backend.cache_bytes`, the captured
    steps' `_fits` / `_copy_into` (`adopt`) — treats the prefix element as
    it treats a group's: each case marks the prefix element only, and
    fails if the walk leaves it behind;
  * the engines' static-buffer decode steps on the DeepSeek smoke model
    (the CPU's route of a captured step) bitwise equal to `capture=False`,
    lockstep and continuous, with the static tree's every leaf, the prefix
    layer's included, at one address for the whole run;
  * the serve CLI with `--arch deepseek-v2-lite-16b --smoke`, both engines;
  * SSM states (Jamba's smoke group: seven `SSMState` elements beside one
    KV cache): insertion writes their rows, retirement leaves them as they
    are, the swap payload carries their rows and restores them, and
    copy-on-write passes them by;
  * the encoder-decoder's tree (seamless smoke: a self and a cross cache
    per decoder layer, the cross stores' parameters f32): `cache_elements`
    and `map_caches` take both elements of every layer, `cache_bytes`
    counts both, and `adopt` copies the cross caches in and refits when a
    cross element alone changes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import configs, convert
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import paged
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import serve, steps
from repro_torch.models import registry
from repro_torch.models.ssm import SSMState
from repro_torch.serving import ContinuousEngine, Request, ServeConfig, ServingEngine
from repro_torch.serving import pack_requests
from tests.torch_parity import to_np, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
ARCH = "deepseek-v2-lite-16b"


def test_from_jax_params_round_trips_the_deepseek_tree():
    jcfg = jconfigs.get_arch(ARCH, smoke=True)
    cfg = configs.get_arch(ARCH, smoke=True)
    with jax.threefry_partitionable(True):
        ref = jax.device_get(jregistry.materialize_params(jcfg, seed=0))
    got = convert.from_jax_params(ref, cfg, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == len(jax.tree_util.tree_leaves(got))
    for path, want in flat_ref:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        assert tuple(leaf.shape) == want.shape, path
        np.testing.assert_array_equal(to_np(leaf), to_np(want))
    assert set(got["prefix"]) == {"layer0"} and "mlp" in got["prefix"]["layer0"]
    moe = got["groups"]["sub0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].shape == (cfg.n_scan_groups, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    bad = dict(ref, prefix={"layer0": ref["groups"]})
    with pytest.raises(ValueError, match="prefix"):
        convert.from_jax_params(bad, cfg, device="cpu")


def _ctx(arch=ARCH, **shape):
    cfg = configs.get_arch(arch, smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    shp = configs.ShapeConfig("t", 24, 2, "decode", **shape)
    return cfg, steps.serve_ctx(cfg, shp, ccfg, decode_budget=8, q_block=24, device="cpu")


def _tree(ctx_pair, b=2):
    cfg, ctx = ctx_pair
    return registry.init_caches(cfg, ctx, b, device="cpu")


def _prefill_slice(ctx_pair, seed=0):
    cfg, ctx = ctx_pair
    params = registry.materialize_params(cfg, seed=seed, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(2, cfg.vocab, (1, 24)))
    return registry.prefill(params, {"tokens": toks}, cfg, ctx)[1]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(kvc.tree_leaves(a), kvc.tree_leaves(b)))


PAGED = dict(cache_backend="paged", page_size=8, page_allocator="freelist", pool_fraction=1.0)


@pytest.mark.parametrize("layout", ["mixed", "paged"])
def test_insert_and_free_take_the_prefix(layout):
    pair = _ctx(**(PAGED if layout == "paged" else {}))
    dst, src = _tree(pair), _prefill_slice(pair)
    assert len(dst["prefix"]) == 1 and len(src["prefix"]) == 1
    out = registry.insert_caches(dst, src, 1)
    for el, sl in zip(registry.cache_elements(out), registry.cache_elements(src)):
        assert int(el.length[1]) == int(sl.length[0]) == 24 and int(el.length[0]) == 0
    want = (paged.insert_slot if layout == "paged" else kvc.insert_slot)(
        dst["prefix"][0], src["prefix"][0], 1)
    assert _equal(out["prefix"][0], want)
    freed = registry.free_caches(out, 1)
    assert all(int(el.length[1]) == 0 and not bool((el.hi.pos[1] >= 0).any())
               for el in registry.cache_elements(freed))


def test_swap_payload_covers_the_prefix():
    """`extract_caches` takes one list per layer, the prefix layer's first;
    `restore_caches` writes each back, the prefix layer's included."""
    pair = _ctx(**PAGED)
    tree = registry.insert_caches(_tree(pair), _prefill_slice(pair), 0)
    payload = registry.extract_caches(tree, 0)
    per = len(paged.extract_slot(tree["prefix"][0], 0))
    assert len(payload) == per * len(registry.cache_elements(tree))
    for want, got in zip(paged.extract_slot(tree["prefix"][0], 0), payload[:per]):
        assert torch.equal(want, got)
    empty = registry.free_caches(tree, 0)
    back = registry.restore_caches(empty, [t.clone() for t in payload], 0)
    for el, ref in zip(registry.cache_elements(back), registry.cache_elements(tree)):
        for want, got in zip(paged.extract_slot(ref, 0), paged.extract_slot(el, 0)):
            assert torch.equal(want, got)


def test_copy_pages_reaches_the_prefix():
    pair = _ctx(**PAGED)
    tree = registry.insert_caches(_tree(pair), _prefill_slice(pair), 0)
    src_page = int(tree["prefix"][0].hi.table[0, 0])
    dst_page = (src_page + 1) % int(tree["prefix"][0].hi.k_pages.shape[0])
    none = (torch.zeros(0, dtype=torch.int64),) * 2
    moves = {"hi": (torch.tensor([src_page]), torch.tensor([dst_page])), "lo": none,
             "win": none}
    assert not torch.equal(tree["prefix"][0].hi.k_pages[dst_page],
                           tree["prefix"][0].hi.k_pages[src_page])
    out = registry.copy_caches(tree, moves)
    for el in registry.cache_elements(out):
        assert torch.equal(el.hi.k_pages[dst_page], el.hi.k_pages[src_page])
        assert torch.equal(el.hi.v_pages[dst_page], el.hi.v_pages[src_page])


def test_cache_bytes_count_the_prefix():
    pair = _ctx()
    tree = _tree(pair)
    got = backend_lib.cache_bytes(tree)
    per = [el.nbytes_total() for el in registry.cache_elements(tree)]
    assert len(per) == pair[0].n_layers and got["total_bytes"] == sum(per)


def test_adopt_copies_into_the_prefix_and_refits_on_it():
    """The captured step's `adopt`: a tree that fits is copied in, the prefix
    element included; a tree whose prefix element alone has another shape
    does not fit."""
    pair = _ctx()
    static, new = _tree(pair), registry.insert_caches(_tree(pair), _prefill_slice(pair), 0)
    assert steps._fits(static, new)
    before = [t.data_ptr() for t in kvc.tree_leaves(static["prefix"][0])]
    steps._copy_into(static, new)
    assert _equal(static["prefix"][0], new["prefix"][0])
    assert [t.data_ptr() for t in kvc.tree_leaves(static["prefix"][0])] == before
    odd = dict(new, prefix=[kvc.tree_map(lambda t: t[:1], new["prefix"][0])])
    assert not steps._fits(static, odd)
    with pytest.raises(ValueError):
        steps._copy_into(static, odd)
    assert not steps._fits(static, dict(new, prefix=[]))


# ---- the static-buffer steps on the DeepSeek smoke model ---------------------

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
    return [t.data_ptr() for el in registry.cache_elements(caches) for t in kvc.tree_leaves(el)]


def _smoke():
    cfg = configs.get_arch(ARCH, smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    return cfg, ccfg, registry.materialize_params(cfg, seed=0, device="cpu")


def test_lockstep_static_route_is_bitwise_eager():
    cfg, ccfg, params = _smoke()
    rng = np.random.default_rng(0)
    batch = {"tokens": pack_requests([rng.integers(2, cfg.vocab, 48) for _ in range(2)], 2, 48)}
    runs = []
    for capture in (True, False):
        eng = ServingEngine(cfg, ccfg, ServeConfig(2, 48, 12), params, device="cpu",
                            capture=capture)
        eng._decode = _Recorder(eng._decode)
        runs.append((eng, eng.generate(batch)["tokens"]))
    (eng, tokens), (eager, want) = runs
    np.testing.assert_array_equal(tokens, want)
    assert len(eng._decode.logits) == 12
    for a, w in zip(eng._decode.logits, eager._decode.logits):
        assert torch.equal(a, w)
    step = eng._decode.step
    assert step.captures == 1 and 0 < step.replays < 12
    assert len(step.caches["prefix"]) == 1
    before = _addresses(step.caches)
    eng.generate(batch)   # a second batch: copied into the static tree, nothing rebuilt
    assert _addresses(step.caches) == before and step.captures == 1


def test_continuous_static_route_is_bitwise_eager():
    cfg, ccfg, params = _smoke()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=(n,)).astype(np.int32) for n in (24, 16, 20)]
    scfg = ServeConfig(batch_size=2, prompt_len=24, max_new_tokens=10, backend="paged",
                       page_size=8, page_allocator="freelist", pool_fraction=0.75)
    runs = []
    for capture in (True, False):
        eng = ContinuousEngine(cfg, ccfg, scfg, params, device="cpu", capture=capture)
        eng._decode_masked = _Recorder(eng._decode_masked)
        before = _addresses(eng.caches)
        rids = [eng.submit(Request(tokens=p, max_new_tokens=m))
                for p, m in zip(prompts, (10, 3, 10))]
        res = eng.run()
        runs.append((eng, [res[r].tokens.tolist() for r in rids], before))
    (eng, outs, before), (eager, want, _) = runs
    assert outs == want and [len(t) for t in outs] == [10, 3, 10]
    for a, w in zip(eng._decode_masked.logits, eager._decode_masked.logits):
        assert torch.equal(a, w)
    step = eng._decode_masked.step
    assert step.captures == 1 and 0 < step.replays < len(eng._decode_masked.logits)
    assert eng._n_folds >= 1
    assert eng.caches is step.caches and _addresses(eng.caches) == before


@pytest.mark.parametrize("extra", [[], ["--continuous", "--requests", "3", "--backend", "paged",
                                        "--page-allocator", "freelist", "--page-size", "8"]],
                         ids=["lockstep", "continuous"])
def test_serve_cli_runs_deepseek_on_cpu(capsys, extra):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--max-new", "4", *extra])
    printed = capsys.readouterr().out
    assert "kernel launches" in printed
    if extra:
        assert all(f"req-{i}: 4 tok" in printed for i in range(3))
    else:
        assert f"{ARCH} policy=zipcache" in printed and out["tokens"].shape == (2, 4)


# ---- SSM states in the tree (Jamba's hybrid group) ----------------------------

JAMBA = "jamba-v0.1-52b"


def _states(tree):
    return [el for el in registry.cache_elements(tree) if isinstance(el, SSMState)]


@pytest.mark.parametrize("layout", ["mixed", "paged"])
def test_insert_and_free_take_ssm_states(layout):
    """Insertion writes the slice's state rows into slot 1 and leaves slot
    0's; retirement leaves the state rows as they are (stale until the next
    insertion, masked while the slot is inactive)."""
    pair = _ctx(JAMBA, **(PAGED if layout == "paged" else {}))
    dst, src = _tree(pair), _prefill_slice(pair)
    assert len(_states(dst)) == 7 and len(registry.cache_elements(dst)) == 8
    out = registry.insert_caches(dst, src, 1)
    for el, sl, old in zip(_states(out), _states(src), _states(dst)):
        for t, ts, to in zip(kvc.tree_leaves(el), kvc.tree_leaves(sl), kvc.tree_leaves(old)):
            assert torch.equal(t[1], ts[0]) and torch.equal(t[0], to[0])
        assert bool(el.ssm[1].any())
    freed = registry.free_caches(out, 1)
    for a, b in zip(_states(freed), _states(out)):
        assert _equal(a, b)
    kv = [el for el in registry.cache_elements(freed) if not isinstance(el, SSMState)]
    assert len(kv) == 1 and int(kv[0].length[1]) == 0


def test_swap_payload_covers_ssm_states():
    """Each SSM layer adds its four state rows to the payload, in layer
    order; a restore onto overwritten rows gives them back."""
    pair = _ctx(JAMBA, **PAGED)
    tree = registry.insert_caches(_tree(pair), _prefill_slice(pair), 0)
    payload = registry.extract_caches(tree, 0)
    n_kv = len(paged.extract_slot(tree["groups"][0]["sub4"], 0))
    assert len(payload) == 7 * 4 + n_kv
    for want, got in zip(kvc.tree_leaves(tree["groups"][0]["sub0"]), payload[:4]):
        assert torch.equal(want[0:1], got)
    wiped = registry.map_caches(
        lambda el: kvc.tree_map(torch.zeros_like, el) if isinstance(el, SSMState) else el,
        registry.free_caches(tree, 0))
    back = registry.restore_caches(wiped, [t.clone() for t in payload], 0)
    for a, b in zip(_states(back), _states(tree)):
        assert _equal(a, b)
    with pytest.raises(ValueError):
        registry.restore_caches(wiped, payload + payload[:1], 0)


def test_copy_pages_skips_ssm_states():
    pair = _ctx(JAMBA, **PAGED)
    tree = registry.insert_caches(_tree(pair), _prefill_slice(pair), 0)
    kv = tree["groups"][0]["sub4"]
    src_page = int(kv.hi.table[0, 0])
    dst_page = (src_page + 1) % int(kv.hi.k_pages.shape[0])
    none = (torch.zeros(0, dtype=torch.int64),) * 2
    before = [[t.clone() for t in kvc.tree_leaves(el)] for el in _states(tree)]
    out = registry.copy_caches(tree, {"hi": (torch.tensor([src_page]), torch.tensor([dst_page])),
                                      "lo": none, "win": none})
    assert torch.equal(kv.hi.k_pages[dst_page], kv.hi.k_pages[src_page])
    for el, want in zip(_states(out), before):
        assert all(torch.equal(t, w) for t, w in zip(kvc.tree_leaves(el), want))


# ---- the encoder-decoder: a self and a cross cache per decoder layer ----------

def _encdec_tree(seed=0):
    cfg = configs.get_arch("seamless-m4t-medium", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    ctx = steps.serve_ctx(cfg, configs.ShapeConfig("t", 24, 2, "decode"), ccfg, decode_budget=8,
                          q_block=24, device="cpu")
    params = registry.materialize_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab, (2, 24))),
             "frontend_embeds": torch.from_numpy(
                 rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32))}
    with torch.inference_mode():
        return cfg, ctx, registry.prefill(params, batch, cfg, ctx)[1]


def test_encdec_tree_walks_take_self_and_cross():
    cfg, ctx, tree = _encdec_tree()
    assert tree["prefix"] == [] and len(tree["groups"]) == cfg.n_layers
    els = registry.cache_elements(tree)
    want = [gc[k] for gc in tree["groups"] for k in ("self", "cross")]
    assert len(els) == 2 * cfg.n_layers and all(a is b for a, b in zip(els, want))
    lengths = registry.map_caches(lambda el: int(el.length[0]), tree)
    assert lengths == {"prefix": [], "groups": [{"self": 24, "cross": 40}] * cfg.n_layers}
    for gc in tree["groups"]:
        assert gc["cross"].hi.k.scale.dtype == torch.float32
        assert gc["self"].hi.k.scale.dtype == torch.bfloat16
    empty = registry.init_caches(cfg, ctx, 2, l_src=40, device="cpu")
    assert [[el.hi.capacity + el.lo.capacity for el in (gc["self"], gc["cross"])]
            for gc in empty["groups"]] == [[24 + 8, 40]] * cfg.n_layers


def test_cache_bytes_count_self_and_cross():
    _, _, tree = _encdec_tree()
    got = backend_lib.cache_bytes(tree)
    parts = [backend_lib.cache_bytes([gc[k] for gc in tree["groups"]]) for k in ("self", "cross")]
    assert got["total_bytes"] == sum(el.nbytes_total() for el in registry.cache_elements(tree))
    for key in ("packed_bytes", "overhead_bytes", "total_bytes"):
        assert got[key] == parts[0][key] + parts[1][key] and parts[1][key] > 0


def test_adopt_copies_the_cross_caches_and_refits_on_them():
    _, _, static = _encdec_tree(0)
    _, _, new = _encdec_tree(1)
    assert steps._fits(static, new)
    before = _addresses(static)
    with torch.inference_mode():   # the engines' mode, in which the trees were made
        steps._copy_into(static, new)
    assert _addresses(static) == before
    assert all(_equal(a, b) for a, b in zip(registry.cache_elements(static),
                                             registry.cache_elements(new)))
    groups = [dict(gc) for gc in new["groups"]]
    groups[-1]["cross"] = kvc.tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point()
                                       else t, groups[-1]["cross"])
    assert not steps._fits(static, dict(new, groups=groups))
