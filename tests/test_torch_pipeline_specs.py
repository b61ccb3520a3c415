"""The pipeline's scope and placements against the JAX package's
(`repro.launch.pipeline`), in pure Python: fake meshes (an object with
`axis_names` and a `shape` dict, as `tests/test_torch_mesh_specs.py`'s),
no devices, no process group.

  * `supports_pp` equals the reference's on every arch of the registry,
    full and smoke;
  * `pp_param_pspecs`, and `zero1_pspecs` with the pipeline's {"layers":
    "stage"}, equal the reference's `pp_param_shardings` and
    `zero1_pspecs(cfg, mesh, overrides=...)` leaf for leaf on the meshes
    ("stage",) 2 and 4, ("stage", "data", "model") 2 x 2 x 2 and 4 x 8 x 8;
  * `pp_placements` gives the specs of the reference's `pp_lowering_inputs`
    (parameters, ZeRO-1 state, batch) and this rank's local shapes of them;
  * `make_pp_mesh` builds the reference's axes: ("stage",) when data =
    model = 1, else ("stage", "data", "model"), on the card by default.
"""

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import pipeline as jpp
from repro.launch import sharding as jshd
from repro.models.common import is_def
from repro.models import registry as jregistry
from repro_torch import configs, tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import pipeline as pp
from repro_torch.launch import sharding as shd
from repro_torch.models import registry
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

MESHES = {"2": ((2,), ("stage",)), "4": ((4,), ("stage",)),
          "2x2x2": ((2, 2, 2), ("stage", "data", "model")),
          "4x8x8": ((4, 8, 8), ("stage", "data", "model"))}
ARCHS = sorted(jconfigs.all_archs())
PP_ARCHS = ("yi-6b", "yi-34b", "qwen2-7b", "smollm-360m", "llava-next-34b")


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


@pytest.fixture(autouse=True)
def _named_sharding_of_fake_meshes(monkeypatch):
    """The reference's NamedSharding over a fake mesh: only `.spec` is read
    back here."""
    class Named:
        def __init__(self, mesh, spec):
            self.spec = spec
    monkeypatch.setattr(jshd, "NamedSharding", Named)


def _shapes(jcfg):
    return [d.shape for d in jax.tree_util.tree_leaves(jregistry.schema(jcfg), is_leaf=is_def)]


def _ref_specs(specs, shapes):
    leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P)
                                       or hasattr(x, "spec"))
    parts = [getattr(s, "spec", s) for s in leaves]
    return [tuple(s) + (None,) * (len(shape) - len(tuple(s))) for s, shape in zip(parts, shapes)]


def _norm(spec):
    """A spec with each one-axis tuple read as that axis (newer JAX's
    PartitionSpec stores P(("data",)) as P("data"))."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_supports_pp_matches_reference(arch, smoke):
    want = jpp.supports_pp(jconfigs.get_arch(arch, smoke=smoke))
    assert pp.supports_pp(configs.get_arch(arch, smoke=smoke)) == want
    assert want == (arch in PP_ARCHS)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_stage_specs_match_reference(arch, smoke, mesh_name):
    mesh = FakeMesh(*MESHES[mesh_name])
    jcfg, cfg = jconfigs.get_arch(arch, smoke=smoke), configs.get_arch(arch, smoke=smoke)
    shapes = _shapes(jcfg)
    got = shd.spec_leaves(pp.pp_param_pspecs(cfg, mesh))
    assert got == _ref_specs(jpp.pp_param_shardings(jcfg, mesh), shapes)
    got = shd.spec_leaves(shd.zero1_pspecs(cfg, mesh, pp.PP_OVERRIDES))
    assert got == _ref_specs(jshd.zero1_pspecs(jcfg, mesh, overrides={"layers": "stage"}),
                             shapes)
    if arch in PP_ARCHS:            # the layer stack is each stage's own groups
        named = dict(zip([n for n, _ in tree.named_leaves(registry.schema(cfg))],
                         got))
        split = cfg.n_scan_groups % mesh.shape["stage"] == 0
        assert (named["groups/sub0/ln1"][0] == "stage") == split
        assert "stage" not in named["embed"] + named["final_norm"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ("yi-6b", "smollm-360m", "llava-next-34b"))
def test_placements_match_reference(arch, mesh_name):
    """`pp_placements` against `pp_lowering_inputs`' shardings, and the
    local shapes each rank holds."""
    mesh = FakeMesh(*MESHES[mesh_name])
    jcfg, cfg = jconfigs.get_arch(arch, smoke=True), configs.get_arch(arch, smoke=True)
    shapes = _shapes(jcfg)
    for b in (8, 64):
        (_, _, abatch), (p_sh, o_sh, b_sh), _ = jpp.pp_lowering_inputs(
            jcfg, JShapeConfig("t", 64, b, "train"), mesh)
        got = pp.pp_placements(cfg, ShapeConfig("t", 64, b, "train"), mesh)
        assert shd.spec_leaves(got["params"]) == _ref_specs(p_sh, shapes)
        for part in ("master", "m", "v"):
            assert (shd.spec_leaves(getattr(got["opt_state"], part))
                    == _ref_specs(getattr(o_sh, part), shapes))
        want_b = {k: _norm(tuple(v.spec) + (None,) * (len(abatch[k].shape) - len(tuple(v.spec))))
                  for k, v in b_sh.items()}
        assert {k: _norm(v) for k, v in got["batch"].items()} == want_b, (b, mesh_name)
        for shape, spec, local in zip(shapes, shd.spec_leaves(got["params"]),
                                      got["param_shapes"]):
            assert local == tuple(d // shd.axis_size(mesh, p) for d, p in zip(shape, spec))


def test_make_pp_mesh_axes(monkeypatch):
    made = []
    monkeypatch.setattr(mesh_lib, "make_mesh", lambda *a, **k: made.append((a, k)))
    pp.make_pp_mesh(2, 1, 1)
    pp.make_pp_mesh(4, 2, 1, device_type="cpu")
    pp.make_pp_mesh()
    assert made == [(((2,), ("stage",), "cuda"), {}),
                    (((4, 2, 1), ("stage", "data", "model"), "cpu"), {}),
                    (((4, 8, 8), ("stage", "data", "model"), "cuda"), {})]
    assert pp.make_pp_mesh is mesh_lib.make_pp_mesh
    assert mesh_lib.data_axes_of(FakeMesh(*MESHES["2x2x2"])) == ("data",)
    assert mesh_lib.data_axes_of(FakeMesh(*MESHES["2"])) == ()


def test_pp_mesh_is_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    """Without a card the pipeline's mesh raises before any process group
    starts, unless it asks for the CPU."""
    import torch
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        pp.make_pp_mesh(1, 1, 1)
    assert not dist.is_initialized()


def test_batch_pspec_ignores_stage():
    for name, (shape, axes) in MESHES.items():
        mesh = FakeMesh(shape, axes)
        assert _norm(shd.batch_pspec(mesh)) == _norm(tuple(jshd.batch_pspec(mesh))), name
