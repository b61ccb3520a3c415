"""The port's logical axes and sharding rules against the JAX package's,
in pure Python (fake meshes: an object with `axis_names` and a `shape`
dict, as `tests/test_sharding.py`'s `FakeMesh`; no devices, no process
group), and the int8 gradient compression on the same floats.

  * every arch of the registry, full and smoke: each parameter leaf's
    (name, shape, logical axes) equals `registry.schema(cfg)`'s;
  * `param_pspecs` and `zero1_pspecs` equal the reference's leaf for leaf
    (a `PartitionSpec` read as its tuple of parts) on the meshes 16 x 16,
    2 x 16 x 16 (pod), 4 x 2, 2 x 2 and 1 x 8; `batch_pspec` and
    `batch_shardings` too;
  * `pick_grad_accum` equals the reference's on those meshes over
    `tests/test_torch_train_step.py`'s batch sizes;
  * `quantize_int8`, `dequantize_int8` and `ef_compress_step(axis=None)`
    bitwise the reference's (`tests/test_substrates.py`'s use).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models.common import is_def
from repro_torch import configs, tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import registry
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model"))}
BATCHES = (1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 256)
ARCHS = sorted(jconfigs.all_archs())


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _norm(spec):
    """A spec with each one-axis tuple read as that axis (newer JAX's
    PartitionSpec stores P(("data",)) as P("data"))."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def _ref_leaves(schema):
    out = []
    for path, d in jax.tree_util.tree_leaves_with_path(schema, is_leaf=is_def):
        out.append(("/".join(str(k.key) for k in path), d))
    return out


def _ref_specs(specs, shapes):
    leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return [tuple(s) + (None,) * (len(shape) - len(tuple(s))) for s, shape in zip(leaves, shapes)]


@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_schema_axes_match_reference(arch, smoke):
    jcfg, cfg = jconfigs.get_arch(arch, smoke=smoke), configs.get_arch(arch, smoke=smoke)
    ref = _ref_leaves(jregistry.schema(jcfg))
    got = tree.named_leaves(registry.schema(cfg))
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, d), (_, r) in zip(got, ref):
        assert (tuple(d.shape), tuple(d.axes)) == (tuple(r.shape), tuple(r.axes)), name
        assert len(d.axes) == len(d.shape)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_reference(arch, smoke, mesh_name):
    mesh = FakeMesh(*MESHES[mesh_name])
    jcfg, cfg = jconfigs.get_arch(arch, smoke=smoke), configs.get_arch(arch, smoke=smoke)
    shapes = [d.shape for _, d in _ref_leaves(jregistry.schema(jcfg))]
    for mine, ref in ((shd.param_pspecs, jshd.param_pspecs), (shd.zero1_pspecs, jshd.zero1_pspecs)):
        got = shd.spec_leaves(mine(cfg, mesh))
        want = _ref_specs(ref(jcfg, mesh), shapes)
        assert got == want, (mine.__name__, arch, smoke, mesh_name)
    # the plans' split flags follow the specs: every `model` block of a kept
    # leaf is a dim the model computes split
    for plan in steps.leaf_plans(cfg, mesh):
        assert len(plan.pspec) == len(plan.zspec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_match_reference(mesh_name):
    mesh = FakeMesh(*MESHES[mesh_name])
    assert _norm(shd.batch_pspec(mesh)) == _norm(tuple(jshd.batch_pspec(mesh)))
    for arch in ("yi-6b", "seamless-m4t-medium", "llava-next-34b"):
        cfg = configs.get_arch(arch, smoke=True)
        for b in (1, 8, 32, 512):
            spec = registry.train_batch_spec(cfg, ShapeConfig("t", 64, b, "train"))
            abstract = {k: jax.ShapeDtypeStruct(s, np.float32) for k, (s, _) in spec.items()}
            want = {k: _norm(tuple(v.spec) + (None,) * (len(abstract[k].shape)
                                                         - len(tuple(v.spec))))
                    for k, v in jshd.batch_shardings(abstract, _JaxMesh(mesh)).items()}
            got = {k: _norm(v) for k, v in shd.batch_shardings(spec, mesh).items()}
            assert got == want, (arch, b, mesh_name)


class _JaxMesh:
    """A FakeMesh that `NamedSharding` accepts in the reference's
    batch_shardings: only `.spec` is read back here."""

    def __init__(self, fake):
        self.axis_names, self.shape = fake.axis_names, fake.shape


@pytest.fixture(autouse=True)
def _named_sharding_of_fake_meshes(monkeypatch):
    class Named:
        def __init__(self, mesh, spec):
            self.spec = spec
    monkeypatch.setattr(jshd, "NamedSharding", Named)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pick_grad_accum_matches_reference_on_meshes(arch, mesh_name):
    mesh = FakeMesh(*MESHES[mesh_name])
    for smoke in (False, True):
        jcfg, cfg = jconfigs.get_arch(arch, smoke=smoke), configs.get_arch(arch, smoke=smoke)
        for batch in BATCHES:
            try:
                want = jsteps.pick_grad_accum(jcfg, JShapeConfig("t", 128, batch, "train"), mesh)
            except ZeroDivisionError:       # a batch below the data axes: both refuse
                with pytest.raises(ZeroDivisionError):
                    steps.pick_grad_accum(cfg, ShapeConfig("t", 128, batch, "train"), mesh)
                continue
            got = steps.pick_grad_accum(cfg, ShapeConfig("t", 128, batch, "train"), mesh)
            assert got == want, (arch, smoke, batch, mesh_name)


class Coords(FakeMesh):
    """A fake 2 x 2 x 2 ("pod", "data", "model") mesh at one coordinate."""

    def __init__(self, coords):
        super().__init__((2, 2, 2), ("pod", "data", "model"))
        self.coords = coords

    def coord(self, axis):
        return self.coords[axis]


def test_shard_of_and_local_shapes():
    """`shard_of` cuts the block of a spec at a mesh coordinate (a tuple of
    axes counts the first as the slowest); `local_shape` is its shape."""

    full = torch.arange(8 * 6).reshape(8, 6)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                mesh = Coords({"pod": pod, "data": data, "model": model})
                blk = shd.shard_of(full, (("pod", "data"), "model"), mesh)
                rows, cols = pod * 2 + data, model
                assert torch.equal(blk, full[rows * 2:rows * 2 + 2, cols * 3:cols * 3 + 3])
                assert shd.local_shape((8, 6), (("pod", "data"), "model"), mesh) == (2, 3)
                assert shd.shard_of(full, (None, None), mesh) is full


def test_int8_compression_matches_reference():
    import jax.numpy as jnp
    from repro.optim import grad_compress as jgc
    from repro_torch.optim import grad_compress as gc

    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 40.0):
        x = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
        jq, js = jgc.quantize_int8(jnp.asarray(x))
        q, s = gc.quantize_int8(torch.from_numpy(x))
        assert np.array_equal(np.asarray(jq), q.numpy()) and float(js) == float(s)
        assert np.array_equal(np.asarray(jgc.dequantize_int8(jq, js)),
                              gc.dequantize_int8(q, s).numpy())
    # error feedback over a sequence, no axis (tests/test_substrates.py's use)
    g_seq = [(rng.standard_normal((64,)) * 0.01).astype(np.float32) for _ in range(6)]
    jres, res = jnp.zeros((64,), jnp.float32), gc.init_residual([torch.zeros(64)])[0]
    for g in g_seq:
        (jsg,), (jres,) = (lambda t: ((t[0][0],), (t[1][0],)))(
            jgc.ef_compress_step([jnp.asarray(g)], [jres], axis=None))
        (sg,), (res,) = gc.ef_compress_step([torch.from_numpy(g)], [res], axis=None)
        assert np.array_equal(np.asarray(jsg), sg.numpy())
        assert np.array_equal(np.asarray(jres), res.numpy())


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-lite-16b", "seamless-m4t-medium"])
def test_train_placements_match_shard_train_state(arch):
    """`train_placements`' shapes are the blocks `shard_train_state` cuts;
    its batch specs split the batch over (pod, data)."""
    cfg = configs.get_arch(arch, smoke=True)
    mesh = Coords({"pod": 1, "data": 0, "model": 1})
    placed = steps.train_placements(cfg, ShapeConfig("t", 32, 8, "train"), mesh)
    params, opt = steps.shard_train_state(registry.materialize_params(cfg, 0, device="cpu"),
                                          cfg, mesh)
    assert [tuple(t.shape) for t in tree.leaves(params)] == placed["param_shapes"]
    assert [tuple(t.shape) for t in tree.leaves(opt.master)] == placed["opt_shapes"]
    assert all(s[0] == ("pod", "data") for s in placed["batch"].values())


def _computes_split(name: str) -> bool:
    """The leaves whose `model` blocks the port's layers compute on their
    own: attention heads (GQA, MLA, the encoder-decoder's self-attentions),
    the dense MLP's width (shared experts included), the vocabulary, the
    routed experts.  Not the SSD mixer, the cross-attention, the router or
    the frontend projection (ROADMAP.md §3)."""
    parts = name.split("/")
    if len(parts) == 1:
        return parts[0] in ("embed", "lm_head")
    if any(p in ("attn", "self_attn", "mlp", "shared") for p in parts[:-1]):
        return True
    return parts[-2] == "moe" and parts[-1] in ("w_gate", "w_up", "w_down")


@pytest.mark.parametrize("arch", ARCHS)
def test_split_leaves_are_the_layers_that_compute_split(arch):
    """`ParamDef.split`, which `steps.leaf_plans` reads into each leaf's
    plan, marks exactly the leaves whose layers compute split."""
    cfg = configs.get_arch(arch, smoke=True)
    named = tree.named_leaves(registry.schema(cfg))
    assert [d.split for _, d in named] == [_computes_split(n) for n, _ in named]
    plans = steps.leaf_plans(cfg, FakeMesh((2, 2), ("data", "model")))
    assert [p.keep_model for p in plans] == [d.split for _, d in named]


def test_a_mesh_is_on_the_card_unless_the_cpu_is_asked(monkeypatch, tmp_path):
    """Without a card, a mesh that does not ask for the CPU raises before
    any process group starts: `make_mesh`, `make_production_mesh` and
    `remesh_restore` default to the card (NCCL), never to gloo."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.elastic import remesh_restore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_arch("yi-6b", smoke=True)
    calls = (lambda: mesh_lib.make_mesh((1, 1), ("data", "model")),
             lambda: mesh_lib.make_production_mesh(),
             lambda: mesh_lib.init_distributed(),
             lambda: remesh_restore(Checkpointer(tmp_path), cfg, {}, (1, 1), ("data", "model")))
    for call in calls:
        with pytest.raises(RuntimeError, match="needs CUDA"):
            call()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        mesh_lib.make_mesh((1, 1), ("data", "model"), device_type="tpu")
    assert not dist.is_initialized()
