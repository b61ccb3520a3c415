"""Serving on a mesh, the pure-Python half: the port's cache specs and
serving placement against the JAX package's on fake meshes (an object
with `axis_names` and a `shape` dict, as `tests/test_torch_mesh_specs.py`;
no devices, no process group), and the refusals.

  * `full_cache_pspecs` equals the reference's leaf for leaf (a
    `PartitionSpec` read as its tuple of parts) for every arch of the
    registry at full width, on the meshes 16 x 16, 2 x 16 x 16, 4 x 2,
    2 x 2, 1 x 4 and 1 x 8, at a mixed-layout cache below and above
    `max_len = 2048` (where the capacities align to 128 slots and the
    window reaches the slot split).  Both trees are built abstractly (the
    reference's `jax.eval_shape`, the port's on the `meta` device) with
    one scan group (the prefix layers and every element kind stay): the
    rule reads each element alone.  The reference's groups are stacked,
    so its group specs carry a leading replicated dim the port's lack;
  * `param_pspecs(..., SERVE_OVERRIDES)` on the same meshes, and the
    serving plans: only the routed experts compute split;
  * `serve_ctx` refuses a mesh with the paged backend (the reference's
    cause) and with the int8 decode algebra; `mesh_of_flag` refuses a mesh
    whose size is not WORLD_SIZE, naming both.
"""

import dataclasses
import math

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.policy import CompressionConfig as JCompressionConfig
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro_torch import configs, tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import registry
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model"))}
SEQS = (1024, 4096)        # max_len 1536 and 4608: below and above 2048
BATCH = 32
ARCHS = sorted(jconfigs.all_archs())


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _norm(spec, n):
    """A spec as a tuple of n parts, each one-axis tuple read as that axis."""
    parts = tuple(spec) + (None,) * (n - len(tuple(spec)))
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)


def _one_group(cfg):
    """The arch with its prefix layers and one scan group (encoder-decoder:
    one decoder layer): every element kind, a fraction of the tree."""
    if cfg.encdec:
        return dataclasses.replace(cfg, n_layers=1, n_enc_layers=1)
    return dataclasses.replace(cfg, n_layers=cfg.first_dense_layers + cfg.scan_group)


@pytest.fixture(scope="module")
def trees():
    """{(arch, seq): (reference cache tree (abstract), port cache tree (meta))}."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _one_group(jconfigs.get_arch(arch)), _one_group(configs.get_arch(arch))
        for seq in SEQS:
            l_src = seq if cfg.encdec else 0
            jctx = jsteps.serve_ctx(jcfg, JShapeConfig("s", seq, BATCH, "prefill"), None,
                                    JCompressionConfig.zipcache())
            ref = jax.eval_shape(lambda: jregistry.init_caches(jcfg, jctx, BATCH, l_src=l_src))
            ctx = steps.serve_ctx(cfg, ShapeConfig("s", seq, BATCH, "prefill"),
                                  CompressionConfig.zipcache(), device="meta", use_kernels=False)
            out[arch, seq] = (ref, registry.init_caches(cfg, ctx, BATCH, l_src=l_src,
                                                          device="meta"))
    return out


def _ref_elements(ref_tree, ref_specs):
    """[(leaf shapes, specs)] per element of the reference's tree, in the
    port's element order, the stacked dim dropped from group leaves."""
    def pairs(el, specs, stacked):
        shapes = [tuple(s.shape[stacked:]) for s in jax.tree_util.tree_leaves(el)]
        parts = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
        return [(sh, _norm(tuple(p)[stacked:], len(sh))) for sh, p in zip(shapes, parts)]

    if not isinstance(ref_tree, dict):      # the encoder-decoder: every leaf stacked
        return [pairs(getattr(ref_tree, f), getattr(ref_specs, f), 1) for f in ref_tree._fields]
    out = [pairs(el, sp, 0) for el, sp in zip(ref_tree["prefix"], ref_specs["prefix"])]
    for key in sorted(ref_tree["groups"]):
        out.append(pairs(ref_tree["groups"][key], ref_specs["groups"][key], 1))
    return out


def _port_elements(port_tree, specs):
    return [[(tuple(t.shape), _norm(s, t.dim())) for t, s in shd.cache_leaf_specs(el, sp)]
            for el, sp in zip(registry.cache_elements(port_tree),
                              registry.cache_elements(specs))]


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(trees, arch, seq):
    ref_tree, port_tree = trees[arch, seq]
    jcfg, cfg = jconfigs.get_arch(arch), configs.get_arch(arch)
    for name, layout in MESHES.items():
        mesh = FakeMesh(*layout)
        want = _ref_elements(ref_tree, jshd.full_cache_pspecs(ref_tree, jcfg, mesh, BATCH))
        got = _port_elements(port_tree, shd.full_cache_pspecs(port_tree, cfg, mesh, BATCH))
        assert got == want, (arch, seq, name)


def test_cache_specs_take_each_split():
    """The three outcomes on yi-6b: kv heads over `model` where its 4 kv
    heads divide; the slot split at 4608 slots on 8 ranks; rows only where
    the batch does not divide the data axes (the model split waits for
    it, as the reference's rule does)."""
    cfg = configs.get_arch("yi-6b")
    ctx = steps.serve_ctx(cfg, ShapeConfig("s", 4096, 8, "prefill"),
                          CompressionConfig.zipcache(), device="meta", use_kernels=False)
    el = registry.cache_elements(registry.init_caches(cfg, ctx, 8, device="meta"))[0]
    heads = shd.cache_pspecs(el, cfg, FakeMesh((2, 2), ("data", "model")), 8)
    assert heads.hi.k.codes == (("data",), "model", None, None)
    assert heads.hi.pos == (("data",), "model")          # (b, S), S >= 128
    slots = shd.cache_pspecs(el, cfg, FakeMesh((1, 8), ("data", "model")), 8)
    assert slots.hi.k.codes == (("data",), None, "model", None)
    assert slots.hi.k.scale == (("data",), None, None, None)   # channelwise: every slot's
    assert slots.k_win == (("data",), None, "model", None)     # the 128-slot window
    rows = shd.cache_pspecs(el, cfg, FakeMesh((3, 2), ("data", "model")), 8)
    assert all(s == (None,) * len(s) for _, s in shd.cache_leaf_specs(el, rows))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_serve_param_specs_match_reference(mesh_name):
    mesh = FakeMesh(*MESHES[mesh_name])
    for arch in ARCHS:
        jcfg, cfg = jconfigs.get_arch(arch), configs.get_arch(arch)
        shapes = [d.shape for d in tree.leaves(registry.schema(cfg))]
        want = jax.tree_util.tree_leaves(jshd.param_pspecs(jcfg, mesh, jshd.SERVE_OVERRIDES),
                                         is_leaf=lambda x: isinstance(x, P))
        want = [_norm(tuple(w), len(s)) for w, s in zip(want, shapes)]
        plans = shd.serve_plans(cfg, mesh)
        assert [_norm(p.pspec, len(s)) for p, s in zip(plans, shapes)] == want, arch
        names = [n for n, _ in tree.named_leaves(registry.schema(cfg))]
        kept = {n for n, p in zip(names, plans) if p.keep_model}
        assert all("/moe/w_" in n and "shared" not in n for n in kept), (arch, kept)
        # the decode step's blocks: heads, MLP width, vocabulary, the
        # attention heads only where the cache splits by them too
        heads_ok = (cfg.n_heads if cfg.mla else cfg.n_kv_heads) % mesh.shape["model"] == 0
        for d, p in zip(tree.leaves(registry.schema(cfg)), plans):
            axis = d.axes[p.pspec.index("model")] if "model" in p.pspec else None
            assert p.keep_decode == (d.split and axis in shd.DECODE_SPLIT_AXES and (
                heads_ok or axis not in ("heads", "kv_heads"))), (arch, d.axes, p)


def decode_gathered_bytes(cfg, mesh) -> tuple:
    """(bytes, bytes) of the weights a decode step gathers over `model` on
    each rank, every layer: the `serve_plans` placement, and the same
    placement with every leaf gathered on use (the decode computing whole)."""
    now = whole = 0
    for d, p in zip(tree.leaves(registry.schema(cfg)), shd.serve_plans(cfg, mesh)):
        if "model" not in p.pspec:
            continue
        n = math.prod(d.shape) * 2          # bf16
        whole += n
        now += 0 if (p.keep_model or p.keep_decode) else n
    return now, whole


def test_decode_gathers_only_what_does_not_divide():
    """At yi-6b's full width on a 4 x 2 mesh the decode step gathers no
    weight (every `model` block is heads, MLP width, vocabulary); whole,
    it would gather the model's 12.1 GB every token.  smollm-360m's 15
    heads and 5 kv heads do not divide 2: its attention is gathered."""
    yi = configs.get_arch("yi-6b")
    now, whole = decode_gathered_bytes(yi, FakeMesh((4, 2), ("data", "model")))
    assert now == 0 and whole == 12_121_538_560
    sm = configs.get_arch("smollm-360m")
    now, whole = decode_gathered_bytes(sm, FakeMesh((1, 2), ("data", "model")))
    attn = sum(math.prod(d.shape) * 2 for n, d in tree.named_leaves(registry.schema(sm))
               if "/attn/" in n and d.split)
    assert now == attn and 0 < now < whole


class RankMesh(FakeMesh):
    """A fake mesh seen from one rank: its coordinate on each axis."""

    def __init__(self, shape, axes, coords):
        super().__init__(shape, axes)
        self.coords = dict(zip(axes, coords))

    def coord(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("layout,coords", [((1, 2), (0, 1)), ((2, 1), (1, 0)),
                                           ((1, 4), (0, 2))], ids=("heads", "rows", "slots"))
def test_cache_shardings_cut_blocks_that_dequantize(layout, coords):
    """`cache_shardings` as a rank sees it: each leaf of yi-6b smoke's cache
    (a 2052-token cache, 4 rows) cut to the rank's block of its spec, the
    stores' logical shapes following their codes, so a block dequantizes to
    the block of the whole store's values (heads over 2, rows over 2, slots
    over 4: the 2 kv heads do not divide 4)."""
    import torch
    cfg = configs.get_arch("yi-6b", smoke=True)
    mesh = RankMesh(layout, ("data", "model"), coords)
    ctx = steps.serve_ctx(cfg, ShapeConfig("s", 2040, 4, "prefill"), CompressionConfig.zipcache(),
                          device="cpu", use_kernels=False, decode_budget=12)
    gen = torch.Generator().manual_seed(0)
    k, v = (torch.randn((4, 2, 2040, cfg.hd), generator=gen).to(torch.bfloat16) for _ in "kv")
    el = ctx.backend.compress_prefill(k, v, torch.rand((4, 2040), generator=gen), 2052)
    tree_ = {"prefix": [], "groups": [{"sub0": el}]}
    block = registry.cache_elements(shd.cache_shardings(tree_, cfg, mesh, 4))[0]
    specs = shd.cache_pspecs(el, cfg, mesh, 4)
    for (t, s), b in zip(shd.cache_leaf_specs(el, specs), kvc.tree_leaves(block)):
        assert torch.equal(b, shd.shard_of(t, s, mesh))
    assert any(b.shape != t.shape for t, b in zip(kvc.tree_leaves(el), kvc.tree_leaves(block)))
    whole_k, block_k = el.hi.k.dequantize(), block.hi.k.dequantize()
    assert torch.equal(block_k, shd.shard_of(whole_k, specs.hi.k.codes, mesh))


def _shape(**kw):
    return ShapeConfig("serve", 24, 4, "prefill", **kw)


@pytest.mark.parametrize("what", ("paged", "int8"))
def test_serve_ctx_refuses_on_a_mesh(what):
    mesh = FakeMesh((1, 2), ("data", "model"))
    cfg = configs.get_arch("yi-6b", smoke=True)
    shape = _shape(cache_backend="paged") if what == "paged" else _shape()
    with pytest.raises(NotImplementedError) as err:
        steps.serve_ctx(cfg, shape, CompressionConfig.zipcache(), device="cpu",
                        decode_impl="int8_algebra" if what == "int8" else "ref", mesh=mesh)
    if what == "paged":     # the reference's cause
        jcfg = jconfigs.get_arch("yi-6b", smoke=True)
        with pytest.raises(NotImplementedError) as jerr:
            jsteps.serve_ctx(jcfg, JShapeConfig("serve", 24, 4, "prefill", cache_backend="paged"),
                             mesh, JCompressionConfig.zipcache())
        assert str(err.value) == str(jerr.value).replace(" (ROADMAP §Serving)", "")


def test_mesh_flag_needs_its_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="needs 2 processes, but WORLD_SIZE is 1"):
        mesh_lib.mesh_of_flag("1x2", "cpu")
    assert mesh_lib.mesh_of_flag("1x1", "cpu") is None


def test_meta_cache_tree_leaves_are_the_elements():
    """`cache_leaf_specs` pairs every tensor leaf with its spec, in field
    order (a QuantizedTensor's None parameters hold none)."""
    cfg = configs.get_arch("yi-6b", smoke=True)
    ctx = steps.serve_ctx(cfg, _shape(), CompressionConfig.zipcache(), device="meta",
                          use_kernels=False)
    el = registry.cache_elements(registry.init_caches(cfg, ctx, 4, device="meta"))[0]
    specs = shd.cache_pspecs(el, cfg, FakeMesh((2, 1), ("data", "model")), 4)
    pairs = shd.cache_leaf_specs(el, specs)
    assert [t for t, _ in pairs] == list(kvc.tree_leaves(el))
    assert all(s[0] == ("data",) for _, s in pairs)
