"""Nothing host-side inside the port's captured decode steps.

A CUDA graph records device work only: a host sync (`.item()`, `.cpu()`,
`.tolist()`) inside the capture fails it, and a host-to-device upload
(`torch.as_tensor`, `torch.from_numpy`) would be baked into the graph with
the value of the capture.  The captured bodies are `ServeStep._run` and
`ContinuousDecodeStep._run` (`repro_torch.launch.steps`), and the sampled
variant's graph: `core.prng.sample_tokens` over the step's staged
rows (`steps.sampling_rows`); their uploads go into the static buffers
before the replay.

The call graph is `tools/analyze/hostsync.py`'s, pointed at
`src/repro_torch`: it follows calls through module imports and `self`, and
stops at attribute chains.  So the backends' decode methods (reached as
`ctx.backend.append(...)`) and the caches' dequantization and dense views
are rooted here as well, and so is the plain decode attention a
gather-route policy's captured step replays (kivi, gear, mikv: the
groupwise and tokenwise dequantization, `kvcache.attend_decode`) with the
int8-algebra route beside it (`decode_impl="int8_algebra"`).  MLA's decode
reads the cache through the backends' `dense` views (rooted here too) with
both its algebras, and the MoE dispatch (`models.mlp`) runs in the MoE
layers' step bodies.  The SSM layers' decode step (`models.ssm.ssm_decode`:
the conv tails, the recurrence, the gated norm) and the row select that
keeps an inactive slot's state are rooted too, and so is the
encoder-decoder's decode step (`models.encdec.decode_step`: the self
cache's append and both caches' attention and probe updates).  Beside the syncs by name, the ops whose output size
depends on the data (`torch.bincount`, `torch.nonzero`, `torch.unique`,
`.nonzero()`) read a count back to the host, so they are flagged too.
"""

import ast
from pathlib import Path

import pytest

from tools.analyze import common, hostsync

ROOT = Path(__file__).resolve().parents[1]
SUB = "src/repro_torch"
ROOTS = (
    ("repro_torch.launch.steps", "ServeStep._run"),
    ("repro_torch.launch.steps", "ContinuousDecodeStep._run"),
    ("repro_torch.launch.steps", "sampling_rows"),
    ("repro_torch.core.prng", "sample_tokens"),
    *(("repro_torch.core.backend", f"MixedKVBackend.{m}") for m in ("append", "attend",
                                                                     "update_probe")),
    *(("repro_torch.core.paged", f"PagedKVBackend.{m}") for m in ("append", "attend",
                                                                   "update_probe")),
    ("repro_torch.core.paged", "PagedKVCache.dense_view"),
    ("repro_torch.core.backend", "MixedKVBackend.dense"),
    ("repro_torch.core.paged", "PagedKVBackend.dense"),
    ("repro_torch.core.paged", "PagedStore.dense"),
    ("repro_torch.core.quant", "QuantizedTensor.dequantize"),
    ("repro_torch.core.kvcache", "attend_decode"),
    ("repro_torch.core.kvcache", "attend_decode_int8"),
    ("repro_torch.core.kvcache", "attend_decode_mla_int8"),
    ("repro_torch.models.ssm", "ssm_decode"),
    ("repro_torch.core.kvcache", "tree_select_rows"),
    ("repro_torch.models.encdec", "decode_step"),
)
HOST_METHODS = {"item", "cpu", "tolist", "nonzero"}
HOST_CALLS = {"torch.as_tensor", "torch.from_numpy", "torch.bincount", "torch.nonzero",
              "torch.unique"}


def host_calls(fn: ast.AST):
    """(line, pattern) of every host sync or upload in a function's body."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and node.func.attr in HOST_METHODS:
            yield node.lineno, f".{node.func.attr}()"
        elif common.dotted_name(node.func) in HOST_CALLS:
            yield node.lineno, common.dotted_name(node.func)


@pytest.fixture(scope="module")
def graph():
    return hostsync._Graph(ROOT, SUB)


def test_roots_exist(graph):
    for mod, qual in ROOTS:
        assert qual in graph.modules[mod].functions, f"{mod}.{qual} is gone: update ROOTS"


def test_captured_steps_reach_no_host_calls(graph):
    reached = graph.reachable(ROOTS)
    assert ("repro_torch.models.lm", "decode_step") in reached
    assert ("repro_torch.models.encdec", "decode_step") in reached
    assert ("repro_torch.kernels.qattn_walk", "launch") in reached
    assert ("repro_torch.core.prng", "threefry2x32") in reached
    for fn in ("cache_keys_values", "_store_logits_int8", "_store_values_int8", "_int8_store"):
        assert ("repro_torch.core.kvcache", fn) in reached
    assert ("repro_torch.core.quant", "scheme_of") in reached
    for mod, fn in (("repro_torch.models.mlp", "_dispatch_compute"),
                    ("repro_torch.models.attention", "mla_decode"),
                    ("repro_torch.models.attention", "mla_kv_t"),
                    ("repro_torch.core.kvcache", "_store_logits_vstream_int8"),
                    ("repro_torch.models.ssm", "_conv_step"),
                    ("repro_torch.models.ssm", "_softplus")):
        assert (mod, fn) in reached, (mod, fn)
    bad = [f"{graph.modules[mod].src.rel}:{line} {qual}: {pattern}"
           for mod, qual in reached
           for line, pattern in host_calls(graph.modules[mod].functions[qual])]
    assert not bad, "host calls inside a captured decode step:\n" + "\n".join(bad)


@pytest.mark.parametrize("expr", ["x.item()", "x.cpu()", "x.tolist()", "torch.as_tensor(x)",
                                  "torch.from_numpy(x)", "torch.bincount(x)", "x.nonzero()",
                                  "torch.nonzero(x)", "torch.unique(x)"])
def test_scan_flags_each_pattern(expr):
    fn = ast.parse(f"def f(x):\n    return {expr}\n").body[0]
    assert [line for line, _ in host_calls(fn)] == [2]
