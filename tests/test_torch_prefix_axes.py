"""Port parity for the miss side of shared-prefix dedup: the `prefix-cache`
and `pmap-prefix` axes of tests/test_backend_conformance.py's engine
fixture.

The fixture's scenario (two slots, three distinct 48-token prompts, a short
request retiring after 6 tokens, a third admitted mid-run, windows folding
on each slot's own cadence, drained through `stream()`) runs on the port
with dedup on, over pools of 1.5 x the worst case, unmapped and under the
conformance precision map.  Every admission is a miss: what the axes
exercise is registration (the donor's ownership rescinded) and the
copy-on-write of a donor's pages at its first fold, which must not change a
token.  Each row's tokens, finish reasons, streams and the windows' fill
cursors after nine steps equal the port's rows without dedup (mixed and
paged free list; mapped: the mapped free list) and the JAX engine's row of
the same axis (op by op, `jax.disable_jit()`), and the prefix block of
`pool_stats()` equals the JAX engine's.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import backend as jbackend
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ContinuousEngine, Request, ServeConfig
from tests.torch_parity import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
PRECISION_MAP = "default=k8v8;layer:1-=k3v3"    # tests/test_backend_conformance.py's
FREELIST = dict(backend="paged", page_allocator="freelist", pool_fraction=1.0)
PREFIX = dict(backend="paged", page_allocator="freelist", pool_fraction=1.5, prefix_cache=True)
ROWS = {
    "mixed": dict(backend="mixed"),
    "paged-freelist": FREELIST,
    "prefix-cache": PREFIX,
    "pmap-freelist": dict(FREELIST, precision_map=PRECISION_MAP),
    "pmap-prefix": dict(PREFIX, precision_map=PRECISION_MAP),
}
# each dedup row, and the rows without dedup it must equal
AXES = {"prefix-cache": ("mixed", "paged-freelist"), "pmap-prefix": ("pmap-freelist",)}


def _first_el(caches):
    groups = caches["groups"]
    return groups[0]["sub0"] if isinstance(groups, list) else groups["sub0"]


def _scenario(eng, request, prompts, fills_of):
    r0 = eng.submit(request(tokens=prompts[0]))
    r1 = eng.submit(request(tokens=prompts[1], max_new_tokens=6))
    for _ in range(4):
        eng.step()
    r2 = eng.submit(request(tokens=prompts[2]))   # mid-run admission
    for _ in range(5):   # r1 retires at 6, r2 backfills; slot 0 folds
        eng.step()
    fills = fills_of(eng)
    streams = [list(eng.stream(r)) for r in (r0, r1, r2)]
    res = eng.run()
    if eng._alloc is not None:
        eng._alloc.check_invariants()
    outs = [(res[r].tokens.tolist(), res[r].finish_reason) for r in (r0, r1, r2)]
    return {"outs": outs, "fills": fills, "streams": streams, "stats": eng.pool_stats()}


@pytest.fixture(scope="module")
def rows():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    jparams = jregistry.materialize_params(jcfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, size=(48,)).astype(np.int32) for _ in range(3)]
    reference = {}
    with jax.disable_jit():
        for name in AXES:
            eng = JContinuousEngine(jcfg, jccfg, JServeConfig(
                batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8, **ROWS[name]),
                jparams)
            reference[name] = _scenario(
                eng, JRequest, prompts,
                lambda e: np.asarray(jax.tree_util.tree_leaves(
                    e.caches["groups"], is_leaf=jbackend.is_kv_cache)[0].win_fill
                ).reshape(-1, 2)[0])
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")
    port = {}
    for name, kw in ROWS.items():
        eng = ContinuousEngine(cfg, ccfg, ServeConfig(
            batch_size=2, prompt_len=48, max_new_tokens=12, page_size=8, **kw), params,
            device="cpu")
        port[name] = _scenario(eng, Request, prompts,
                               lambda e: _first_el(e.caches).win_fill.numpy().copy())
    return reference, port


@pytest.mark.parametrize("axis", list(AXES))
def test_prefix_axis_equals_rows_without_dedup(rows, axis):
    _, port = rows
    got = port[axis]
    for other in AXES[axis]:
        assert got["outs"] == port[other]["outs"], other
        assert got["streams"] == port[other]["streams"], other
        np.testing.assert_array_equal(got["fills"], port[other]["fills"], err_msg=other)


@pytest.mark.parametrize("axis", list(AXES))
def test_prefix_axis_matches_reference(rows, axis):
    reference, port = rows
    got, want = port[axis], reference[axis]
    assert got["outs"] == want["outs"]
    assert got["streams"] == want["streams"]
    np.testing.assert_array_equal(got["fills"], want["fills"])
    assert got["stats"]["prefix"] == want["stats"]["prefix"]
    for seg in ("hi", "lo", "win"):
        assert got["stats"][seg] == want["stats"][seg], seg


@pytest.mark.parametrize("axis", list(AXES))
def test_prefix_axis_is_all_misses_with_cow(rows, axis):
    """Distinct prompts: every admission misses, registrations hold pages,
    and a donor's fold copies its pages (the CoW the axis exists for)."""
    _, port = rows
    pf = port[axis]["stats"]["prefix"]
    assert pf["hits"] == 0 and pf["misses"] == 3, pf
    assert pf["entries"] >= 1 and pf["cow_copies"] >= 1, pf
    assert pf["prefill_tokens_skipped"] == 0


def test_map_bites_on_the_prefix_axis(rows):
    _, port = rows
    assert port["pmap-prefix"]["outs"] != port["prefix-cache"]["outs"]
