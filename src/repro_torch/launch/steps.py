"""Serving context and the engines' step factories, and the train step on
one card or on a mesh (port of `repro.launch.steps`; the train half at its
end).

Each serving factory returns `(fn, ctx)` as the reference's does.  With
`mesh=` (or a ctx made with one) it serves this rank's block: its rows of
the batch over the data axes, its `model` block of every cache element
(`core.sharded.ShardedBackend`), the parameters as their serving blocks
gathered on use (`sharding.shard_serve_params`).  The prefill takes its
rows of a batch (a batch-1 admission runs whole on every rank), the
continuous step its columns of the staged rows, insert and the row folds
their slots; the host loop around them is the same on every rank.
The JAX package jits every engine program.  Here prefill, recompression,
the folds and slot insertion run eagerly, and the two decode programs (the
lockstep step and the continuous masked step) are step objects over static
buffers:

  * the step owns its inputs (the lockstep token; the continuous step's
    staged (6, b) rows of tokens, probe flags, active flags, temperatures,
    seeds and token counters) and the cache tree it reads, and writes every
    cache leaf it changes back into that tree;
  * on the card, a step on which no row probes is captured once as a CUDA
    graph and replayed.  The first such step runs eagerly on the capture
    stream (the warm-up: kernel builds, `cudaFuncSetAttribute`, cuBLAS's
    workspace for that stream); the second is captured, then replayed.  A
    capture that fails raises `CaptureError`: there is no quiet return to
    the eager path;
  * a probe step runs eagerly against the same buffers: its route (exact
    slot weights for the saliency state) is chosen on the host;
  * the continuous step's tokens: greedy rows take the engine's `argmax` of
    the logits, as before sampling existed.  A step on which some row
    samples (temperature > 0) draws its tokens with `core.prng.sample_tokens`
    (`ContinuousDecodeStep.sample`): after a replay, through a second,
    small graph captured once over the decode graph's static logits and
    the staged TEMP, SEED and CTR rows; after an eager step, eagerly with
    the same function.  A step builds at most two graphs, and one on which
    no row samples runs exactly the graph it ran before;
  * on the CPU every step runs eagerly against the same buffers, the plain
    version of a replay;
  * `capture=False` runs the plain functions on fresh caches every step:
    the eager path that the captured one is held against.

A graph bakes in every address it reads: the parameters, the static inputs
and every cache leaf.  So whatever replaces cache leaves outside the step
(prefill, a fold, insertion, a slot's retirement) goes through `adopt`,
which copies the new leaves into the static tree.  A tree whose leaves
differ from the static tree's in shape or dtype becomes the static tree
itself, and the step is built again (a warm-up, then a capture), as the
reference's jitted step retraces: the baselines' first fold promotes their
mixed stores to f32 through the zero-capacity store's f32 parameters, in
the port as in the reference (ROADMAP.md §3).

A kernel wrapper counts its launches on the host, which a replay never
runs: the capture's counts are taken back and added again at every replay
(`kernels.build.COUNTERS`).  Each build (a capture on the card, the static
buffers on the CPU) is reported to `runtime.compile_guard`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core import precision as precision_lib
from repro_torch.core import prng
from repro_torch.core.quant import correctly_rounded_sqrt, true_div
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import blocks, parallel, registry
from repro_torch.optim import adamw
from repro_torch.runtime import compile_guard

# rows of the continuous step's staged (6, b) int32 inputs; ROW_TEMP holds
# the f32 temperatures' bits, read back on the device with `.view`
ROW_TOK, ROW_PROBE, ROW_ACT, ROW_TEMP, ROW_SEED, ROW_CTR = range(6)


# the reference's cause (`repro.launch.steps.serve_ctx`), its roadmap pointer left out
PAGED_ON_A_MESH = ("the paged cache backend is single-host today: its pools index physical "
                   "pages, which need a page-axis partitioning story before they can shard "
                   "over a mesh \u2014 use cache_backend='mixed' with a mesh")


def serve_ctx(cfg: ArchConfig, shape: ShapeConfig, ccfg: Optional[CompressionConfig] = None,
              decode_budget: int = 512, q_block: int = 512, device="cuda",
              use_kernels: bool = True, decode_impl: str = "ref",
              compact_softmax: bool = False, mesh=None) -> blocks.RunCtx:
    """RunCtx + probes for a serving shape; max cache = the query length
    (`registry.prefill_lengths`: seq_len, or the encoder-decoder's decoder
    prompt) + decode budget.

    The shape carries the cache layout (`cache_backend`, `page_size`,
    `paged_kernel`, `page_allocator`, `pool_fraction`) and the precision
    map, resolved here into the context's ceiling table ("" = maps off).
    The reference's encoder-decoder path never reads that table, so a map
    on an encoder-decoder arch is refused rather than ignored.
    use_kernels: the port's CUDA kernels on the path (the default), or their
    plain PyTorch versions throughout.  decode_impl / compact_softmax: the
    reference's levers on the plain routes (`blocks.RunCtx`).

    mesh: a serving mesh (`launch.mesh`): the backend becomes a
    `core.sharded.ShardedBackend` over `shape.global_batch` rows.  As the
    reference's, it refuses the paged backend (and so the swap tier, prefix
    dedup and `paged_qattn`); the port also refuses the int8 decode algebra
    on a mesh.
    """
    ccfg = ccfg or CompressionConfig.zipcache()
    if mesh is not None:
        if shape.cache_backend == "paged":
            raise NotImplementedError(PAGED_ON_A_MESH)
        if decode_impl != "ref":
            raise NotImplementedError(f"decode_impl={decode_impl!r} is not served on a mesh")
    if cfg.encdec and shape.precision_map:
        raise ValueError(f"{cfg.name}: a precision map has no effect on an encoder-decoder "
                         "arch (its prefill, decode and folds never read the table), so it "
                         "is refused")
    qlen, _ = registry.prefill_lengths(cfg, shape)
    probe = None
    if ccfg.uses_saliency and ccfg.probe_strategy not in ("none", "exact"):
        probe = sal.select_probes(qlen, ccfg.probe_strategy, ccfg.probe_ratio, ccfg.seed,
                                  device=device)
    if ccfg.needs_full_attention:
        probe = sal.select_probes(qlen, "all", 1.0, device=device)
    backend = backend_lib.of(ccfg, kind=shape.cache_backend, use_kernels=use_kernels,
                             page_size=shape.page_size, paged_kernel=shape.paged_kernel,
                             page_allocator=shape.page_allocator,
                             pool_fraction=shape.pool_fraction)
    pmap = precision_lib.parse_precision_map(shape.precision_map)
    table = pmap.resolve(cfg.n_layers, cfg.n_kv_heads) if pmap else None
    max_cache_len = (qlen if cfg.encdec else shape.seq_len) + decode_budget
    data_axes = ("data",)
    if mesh is not None:
        from repro_torch.core import sharded
        backend = sharded.ShardedBackend(backend, cfg, mesh, shape.global_batch)
        data_axes = mesh_lib.data_axes_of(mesh)
    return blocks.RunCtx(mesh=mesh, data_axes=data_axes, ccfg=ccfg, probe=probe,
                         max_cache_len=max_cache_len, q_block=q_block, use_kernels=use_kernels,
                         decode_impl=decode_impl, compact_softmax=compact_softmax,
                         backend=backend, precision=table)


def local_rows(ctx: blocks.RunCtx):
    """[start, stop) of this rank's rows of the serving batch (None off a
    mesh)."""
    return None if ctx.mesh is None else ctx.backend.rows()


def local_slot(ctx: blocks.RunCtx, slot: int) -> Optional[int]:
    """The row of global slot `slot` in this rank's block, None where
    another data rank holds it (the slot itself off a mesh)."""
    rows = local_rows(ctx)
    if rows is None:
        return slot
    return slot - rows[0] if rows[0] <= slot < rows[1] else None


def gather_rows(x: torch.Tensor, ctx: blocks.RunCtx) -> torch.Tensor:
    """The whole batch's rows of x (this rank's rows on dim 0), gathered over
    the data axes; x itself off a mesh."""
    if ctx.mesh is None:
        return x
    return shd.assemble(x, (ctx.data_axes,), ctx.mesh)


def stage_rows(rows: Dict[int, Tuple], b: int) -> np.ndarray:
    """A continuous step's inputs {slot: (token, probe[, temperature, seed,
    counter])} as a fresh host (6, b) int32 matrix; slots not in `rows` are
    inactive, and a row without sampling fields is greedy."""
    stage = np.zeros((6, b), np.int32)
    temps = stage[ROW_TEMP].view(np.float32)
    for i, (tok, probe, *sampling) in rows.items():
        stage[ROW_TOK, i], stage[ROW_PROBE, i], stage[ROW_ACT, i] = tok, probe, 1
        if sampling:
            temps[i], stage[ROW_SEED, i], stage[ROW_CTR, i] = sampling
    return stage


def sampling_rows(staged: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(temperatures f32, seeds, counters) of a device (6, b) matrix."""
    return staged[ROW_TEMP].view(torch.float32), staged[ROW_SEED], staged[ROW_CTR]


class CaptureError(RuntimeError):
    """A decode step could not be captured as a CUDA graph."""


def _fits(dst: Any, src: Any) -> bool:
    """Whether cache tree `src` has dst's layers and leaf shapes and dtypes,
    prefix layers and groups alike."""
    els_d, els_s = registry.cache_elements(dst), registry.cache_elements(src)
    if len(els_d) != len(els_s) or len(dst["prefix"]) != len(src["prefix"]):
        return False
    pairs = [(d, t) for ed, es in zip(els_d, els_s)
             for d, t in zip(kvc.tree_leaves(ed), kvc.tree_leaves(es))]
    return all(d.shape == t.shape and d.dtype == t.dtype for d, t in pairs)


def _copy_into(dst: Any, src: Any) -> None:
    """Copy every leaf of cache tree `src` that is not dst's own leaf into
    dst's, in place, prefix layers and groups alike.  Shapes and dtypes
    must match."""
    def put(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        if s is d:
            return d
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"cache leaf {tuple(s.shape)} {s.dtype} does not fit the static "
                             f"leaf {tuple(d.shape)} {d.dtype}")
        return d.copy_(s)

    els_d, els_s = registry.cache_elements(dst), registry.cache_elements(src)
    if len(els_d) != len(els_s) or len(dst["prefix"]) != len(src["prefix"]):
        raise ValueError("the cache trees have different layer counts")
    for ed, es in zip(els_d, els_s):
        kvc.tree_map(put, ed, es)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


class _DecodeStep:
    """A decode program over static buffers (see the module docstring).

    `captures` counts builds (captures on the card, the static buffers on
    the CPU); `replays` counts the steps on which no row probes served by
    the built program (graph replays on the card, its plain version on the
    CPU).  The logits a step returns on the card alias the graph's output:
    the next step overwrites them.
    """

    def __init__(self, name: str, cfg: ArchConfig, ctx: blocks.RunCtx, device, capture: bool):
        self.name = name
        self.cfg = cfg
        self.ctx = ctx
        self.device = torch.device(device)
        self.capture = capture
        self.caches = None
        self.captures = 0
        self.replays = 0
        self._params = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._deltas: Tuple = ()

    def adopt(self, caches: Any) -> Any:
        """Make `caches` the step's cache tree and return that tree: the first
        tree becomes the static one, a later one is copied into it, and one
        that does not fit it (other leaf dtypes or shapes) becomes the
        static tree and drops what was built over the old one.  With
        capture=False, `caches` itself."""
        if not self.capture:
            return caches
        if self.caches is None:
            self.caches = caches
        elif caches is not self.caches:
            if _fits(self.caches, caches):
                _copy_into(self.caches, caches)
            else:
                self._rebuild(caches)
        return self.caches

    def _rebuild(self, caches: Any) -> None:
        """A new static tree: the graphs over the old one go, and the next
        non-probe step warms up and captures again (on the CPU, the rebuilt
        static buffers count as a build)."""
        self.caches = caches
        self._stream = self._graph = self._out = None
        self._deltas = ()
        self._drop_graphs()
        if self._params is not None and self.device.type != "cuda":
            self._built()

    def _drop_graphs(self) -> None:
        """Forget the graphs captured beside the decode step's."""

    def _make_inputs(self, like) -> None:
        raise NotImplementedError

    def _run(self, probes) -> torch.Tensor:
        """The step against the static buffers, eagerly: returns the logits."""
        raise NotImplementedError

    def _prepare(self, params, caches: Any, like) -> None:
        """Adopt `caches`; at the first call make the static inputs shaped
        like `like` (a build on the CPU) and keep the parameters, whose
        addresses a graph bakes in."""
        self.adopt(caches)
        if self._params is None:
            self._make_inputs(like)
            self._params = params
            if self.device.type != "cuda":
                self._built()
        elif params is not self._params:
            raise ValueError(f"{self.name}: called with other parameters than it was built "
                             "with")

    def _built(self, suffix: str = "") -> None:
        self.captures += 1
        compile_guard.record(self.name + suffix)

    def _step(self, probes) -> torch.Tensor:
        """One step against the static buffers: a probe step eagerly, a
        non-probe step through the built program."""
        if probes is not False:
            return self._run(probes)
        if self.device.type == "cuda" and self._graph is None:
            if self._stream is None:
                return self._warm_up()
            self._capture()
        self.replays += 1
        if self._graph is None:   # the CPU: the plain version of a replay
            return self._run(False)
        return self._replay(self._graph, self._deltas, self._out)

    @staticmethod
    def _replay(graph, deltas, out):
        graph.replay()
        for counter, n in deltas:
            counter.launches += n
        return out

    def _warm_up(self) -> torch.Tensor:
        """The first non-probe step, eagerly, on the stream that will capture
        it."""
        self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self._run(False)
        main.wait_stream(self._stream)
        out.record_stream(main)
        return out

    def _record(self, fn, what: str):
        """Capture `fn()` on the step's stream: (graph, its output, the launch
        counts the capture took back, which each replay adds again)."""
        before = [(c, c.launches) for c in build.COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                out = fn()
        except Exception as e:  # noqa: BLE001 — any op that cannot be captured
            raise CaptureError(f"{self.name}: capturing {what} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            deltas = tuple((c, c.launches - n) for c, n in before if c.launches != n)
            for c, n in before:
                c.launches = n
        return graph, out, deltas

    def _capture(self) -> None:
        self._graph, self._out, self._deltas = self._record(lambda: self._run(False),
                                                            "the decode step")
        self._built()


class ServeStep(_DecodeStep):
    """serve_step(params, caches, token, is_probe) -> (logits, caches).

    is_probe: the step's host bool.  After a call, `token` holds the greedy
    next token ((b,) int32); with capture, that is the static input itself,
    written inside the graph, so passing it back feeds the next step with no
    copy.
    """

    def __init__(self, cfg: ArchConfig, ctx: blocks.RunCtx, device, capture: bool):
        super().__init__("serve_step", cfg, ctx, device, capture)
        self.token: Optional[torch.Tensor] = None

    def __call__(self, params, caches: Any, token: torch.Tensor, is_probe: bool):
        if not self.capture:
            logits, caches = registry.decode_step(params, token, caches, self.cfg, self.ctx,
                                                  bool(is_probe))
            self.token = _greedy(logits)
            return logits, caches
        self._prepare(params, caches, token)
        if token is not self.token:
            self.token.copy_(token)
        return self._step(bool(is_probe)), self.caches

    def _make_inputs(self, like: torch.Tensor) -> None:
        self.token = torch.zeros(like.shape, dtype=torch.int32, device=self.device)

    def _run(self, probes) -> torch.Tensor:
        logits, new = registry.decode_step(self._params, self.token, self.caches, self.cfg,
                                           self.ctx, probes)
        _copy_into(self.caches, new)
        self.token.copy_(_greedy(logits))
        return logits


class ContinuousDecodeStep(_DecodeStep):
    """decode(params, caches, staged) -> (logits, caches).

    staged: the step's host (6, b) int32 matrix (`stage_rows`: tokens,
    probe flags, active flags, temperatures, seeds, counters), uploaded
    once.  Inactive slots are masked (no append, invalid positions), never
    sliced away.  A step on which no row probes is the captured program.

    `sample(logits)` draws the step's tokens with `prng.sample_tokens`;
    `sample_replays` counts the sampler graph's replays.
    """

    def __init__(self, cfg: ArchConfig, ctx: blocks.RunCtx, device, capture: bool):
        super().__init__("continuous_decode", cfg, ctx, device, capture)
        self.staged: Optional[torch.Tensor] = None
        self.sample_replays = 0
        self._sample_graph: Optional[torch.cuda.CUDAGraph] = None
        self._tokens: Optional[torch.Tensor] = None
        self._sample_deltas: Tuple = ()

    def __call__(self, params, caches: Any, staged: np.ndarray):
        rows = local_rows(self.ctx)
        if rows is not None:
            staged = np.ascontiguousarray(staged[:, rows[0]:rows[1]])
        probe = bool(staged[ROW_PROBE].any())
        if not self.capture:
            self.staged = dev = torch.from_numpy(staged).to(self.device)
            return registry.decode_step(params, dev[ROW_TOK], caches, self.cfg, self.ctx,
                                        dev[ROW_PROBE] if probe else False,
                                        active=dev[ROW_ACT].bool())
        self._prepare(params, caches, staged)
        self.staged.copy_(torch.from_numpy(staged))
        return self._step(self.staged[ROW_PROBE] if probe else False), self.caches

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """The last step's tokens drawn from its `logits` at its staged TEMP,
        SEED and CTR rows: (b,) int32 on the device.  The logits of a replay
        go through the sampler's graph (captured at the first such call; on
        the card only); any other logits (capture=False, the CPU, a probe
        step, the warm-up) through the sampler eagerly."""
        if self._graph is None or logits is not self._out:
            return prng.sample_tokens(logits, *sampling_rows(self.staged))
        if self._sample_graph is None:
            self._sample_graph, self._tokens, self._sample_deltas = self._record(
                lambda: prng.sample_tokens(self._out, *sampling_rows(self.staged)), "the sampler")
            self._built("_sample")
        self.sample_replays += 1
        return self._replay(self._sample_graph, self._sample_deltas, self._tokens)

    def _drop_graphs(self) -> None:
        self._sample_graph = self._tokens = None
        self._sample_deltas = ()

    def _make_inputs(self, like: np.ndarray) -> None:
        self.staged = torch.zeros(like.shape, dtype=torch.int32, device=self.device)

    def _run(self, probes) -> torch.Tensor:
        s = self.staged
        logits, new = registry.decode_step(self._params, s[ROW_TOK], self.caches, self.cfg,
                                           self.ctx, probes, active=s[ROW_ACT].bool())
        _copy_into(self.caches, new)
        return logits


def _ctx(cfg, shape, ccfg, ctx, q_block, device, decode_impl: str = "ref",
         compact_softmax: bool = False, mesh=None) -> blocks.RunCtx:
    """`ctx`, else the serving context of `shape` (on `mesh`) with the port's
    kernels on the path and the given levers.  A caller that wants the
    plain versions passes `serve_ctx(..., use_kernels=False)` as `ctx`, as
    the engines do."""
    return ctx or serve_ctx(cfg, shape, ccfg, q_block=q_block, device=device,
                            decode_impl=decode_impl, compact_softmax=compact_softmax, mesh=mesh)


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, ccfg: Optional[CompressionConfig] = None,
                      q_block: int = 512, *, ctx=None, device="cuda",
                      compact_softmax: bool = False, mesh=None):
    """prefill(params, batch) -> (logits at the last position, caches).
    compact_softmax: bf16 logits and probabilities on the plain route.  On
    a mesh a batch of the serving batch's rows is cut to this rank's; any
    other (an admission's one row) runs whole on every rank."""
    ctx = _ctx(cfg, shape, ccfg, ctx, q_block, device, compact_softmax=compact_softmax,
               mesh=mesh)

    def prefill_step(params, batch):
        rows = local_rows(ctx)
        if rows is not None and batch["tokens"].shape[0] == ctx.backend.global_batch:
            batch = {k: v[rows[0]:rows[1]] for k, v in batch.items()}
        return registry.prefill(params, batch, cfg, ctx)

    return prefill_step, ctx


def make_serve_step(cfg: ArchConfig, shape: ShapeConfig, ccfg: Optional[CompressionConfig] = None,
                    q_block: int = 512, *, ctx=None, device="cuda", capture: bool = True,
                    decode_impl: str = "ref", mesh=None):
    """The lockstep decode step, a `ServeStep`: serve_step(params, caches,
    token, is_probe) -> (logits, caches).  decode_impl: the algebra of the
    plain decode attention ("ref" or "int8_algebra").  On a mesh: this
    rank's rows (tokens, caches, logits)."""
    ctx = _ctx(cfg, shape, ccfg, ctx, q_block, device, decode_impl=decode_impl, mesh=mesh)
    return ServeStep(cfg, ctx, device, capture), ctx


def make_recompress_step(cfg: ArchConfig, shape: ShapeConfig,
                         ccfg: Optional[CompressionConfig] = None, *, ctx=None, device="cuda",
                         mesh=None):
    """recompress_step(caches) -> caches: every slot's window folded."""
    ctx = _ctx(cfg, shape, ccfg, ctx, 512, device, mesh=mesh)

    def recompress_step(caches):
        return registry.recompress(caches, cfg, ctx)

    return recompress_step, ctx


def make_continuous_decode_step(cfg: ArchConfig, shape: ShapeConfig,
                                ccfg: Optional[CompressionConfig] = None, q_block: int = 512,
                                ctx=None, *, device="cuda", capture: bool = True, mesh=None):
    """The continuous masked decode step, a `ContinuousDecodeStep`:
    decode(params, caches, staged (6, b) host int32) -> (logits, caches),
    and `sample(logits)` for the steps on which a row samples.  Pass `ctx` to share one serving context across the program
    family (the engines do).  On a mesh the step takes this rank's columns
    of the staged rows: logits and tokens of its rows."""
    ctx = _ctx(cfg, shape, ccfg, ctx, q_block, device, mesh=mesh)
    return ContinuousDecodeStep(cfg, ctx, device, capture), ctx


def make_insert_step(cfg: ArchConfig, shape: ShapeConfig, ccfg: Optional[CompressionConfig] = None,
                     ctx=None, *, device="cuda", mesh=None):
    """insert(caches, slice_caches, slot): write a batch-1 prefill cache slice
    into decode-batch row `slot` (on a mesh: only on the data rank that
    holds the slot; every other rank's caches come back as they were)."""
    ctx = _ctx(cfg, shape, ccfg, ctx, 512, device, mesh=mesh)

    def insert(caches, slice_caches, slot: int):
        row = local_slot(ctx, slot)
        return caches if row is None else registry.insert_caches(caches, slice_caches, row)

    return insert, ctx


def make_recompress_rows_step(cfg: ArchConfig, shape: ShapeConfig,
                              ccfg: Optional[CompressionConfig] = None, ctx=None, *,
                              device="cuda", ladder: bool = False, mesh=None):
    """recompress_rows(caches, rows (b,) bool): fold the staging windows of
    the masked slots only (per-request cadence, paper Alg. 3).  Recompresses
    the whole batch and selects rows (on a mesh: this rank's rows of the
    mask).

    ladder=True arms the downshift ladder: the step takes a third operand,
    the (b,) int32 rungs, lowering each folded slot's lo-store effective
    bits (one routine serves every rung)."""
    ctx = _ctx(cfg, shape, ccfg, ctx, 512, device, mesh=mesh)

    def mine(t: torch.Tensor) -> torch.Tensor:
        rows = local_rows(ctx)
        return t if rows is None else t[rows[0]:rows[1]]

    if ladder:
        def recompress_rows_rung(caches, rows: torch.Tensor, rung: torch.Tensor):
            return registry.recompress(caches, cfg, ctx, rows=mine(rows), rung=mine(rung))
        return recompress_rows_rung, ctx

    def recompress_rows(caches, rows: torch.Tensor):
        return registry.recompress(caches, cfg, ctx, rows=mine(rows))

    return recompress_rows, ctx


def make_recompress_slot_step(cfg: ArchConfig, shape: ShapeConfig,
                              ccfg: Optional[CompressionConfig] = None, ctx=None, *,
                              device="cuda", ladder: bool = False):
    """recompress_slot(caches, slot): fold exactly ONE slot's staging window
    through the backend's per-slot recompression (the paged layout): a
    batch-1 view, ~1/slots the work.  ladder=True adds a scalar int32 rung
    operand (the view is batch 1)."""
    ctx = _ctx(cfg, shape, ccfg, ctx, 512, device)

    if ladder:
        def recompress_slot_rung(caches, slot: int, rung: torch.Tensor):
            return registry.recompress(caches, cfg, ctx, slot=slot, rung=rung)
        return recompress_slot_rung, ctx

    def recompress_slot(caches, slot: int):
        return registry.recompress(caches, cfg, ctx, slot=slot)

    return recompress_slot, ctx


def make_copy_pages_step(cfg: ArchConfig, shape: ShapeConfig,
                         ccfg: Optional[CompressionConfig] = None, ctx=None, *,
                         device="cuda"):
    """copy(caches, moves) -> caches: duplicate physical pages inside every
    pool per the allocator's copy-on-write plan ({segment: (src, dst)}
    int64 id vectors, sink-padded to each segment's page count), in place."""
    ctx = _ctx(cfg, shape, ccfg, ctx, 512, device)

    def copy(caches, moves):
        return registry.copy_caches(caches, moves)

    return copy, ctx


def make_swap_extract_step(cfg: ArchConfig, shape: ShapeConfig,
                           ccfg: Optional[CompressionConfig] = None, ctx=None, *,
                           device="cuda"):
    """extract(caches, slot) -> list of tensors: one slot's complete state
    (logical pages at their full extent and metadata rows), the device half
    of a swap-out.  Every shape is fixed, so one host entry fits every slot
    and occupancy."""
    ctx = _ctx(cfg, shape, ccfg, ctx, 512, device)

    def extract(caches, slot: int):
        return registry.extract_caches(caches, slot)

    return extract, ctx


def make_swap_restore_step(cfg: ArchConfig, shape: ShapeConfig,
                           ccfg: Optional[CompressionConfig] = None, ctx=None, *,
                           device="cuda"):
    """restore(caches, payload, slot) -> caches: a swapped-out slot's payload
    back through its re-granted page tables and its metadata rows.  No
    prefill, no recompute: the slot gets back the bytes the extract took."""
    ctx = _ctx(cfg, shape, ccfg, ctx, 512, device)

    def restore(caches, payload: list, slot: int):
        return registry.restore_caches(caches, payload, slot)

    return restore, ctx


# ---------------------------------------------------------------------------
# Train: one card (the reference's mesh=None) or a mesh
# ---------------------------------------------------------------------------

def _run_ctx(cfg: ArchConfig, mesh, q_block: int = 512, compact_softmax: bool = False
             ) -> blocks.RunCtx:
    data_axes = mesh_lib.data_axes_of(mesh) if mesh is not None else ("data",)
    return blocks.RunCtx(mesh=mesh, data_axes=data_axes, q_block=q_block,
                         compact_softmax=compact_softmax)


def _data_parallel(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh_lib.data_axes_of(mesh)) if mesh else 1


def pick_grad_accum(cfg: ArchConfig, shape: ShapeConfig, mesh=None) -> int:
    """Microbatch count: ~1 sequence per data-parallel rank per microbatch
    for wide models (d_model >= 2048), ~2 for small ones, each microbatch
    dividing the data axes (the reference's rule; mesh None is one rank)."""
    dp = _data_parallel(mesh)
    per_dev = max(shape.global_batch // max(dp, 1), 1)
    target = 1 if cfg.d_model >= 2048 else 2
    accum = max(per_dev // target, 1)
    while shape.global_batch % accum or (shape.global_batch // accum) % max(dp, 1):
        accum -= 1
    return max(accum, 1)


def loss_and_grads(params, batch, cfg: ArchConfig, ctx: blocks.RunCtx):
    """(loss, metrics, gradients in flatten order) of one batch, every
    tensor detached; the gradients in the parameters' dtypes."""
    leaves = [t.detach().requires_grad_(True) for t in tree_lib.leaves(params)]
    with torch.enable_grad():
        loss, met = registry.loss_fn(tree_lib.unflatten(params, leaves), batch, cfg, ctx)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in met.items()}, list(grads)


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[adamw.AdamWConfig] = None,
                    grad_accum: int = 1, q_block: int = 512, compact_softmax: bool = False,
                    *, mesh=None, param_dtype=torch.bfloat16):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    the batch a dict of device tensors.

    The step gives up its params and opt_state and returns them updated in
    place (`adamw.adamw_update`), as the reference's CLI jits its step with
    donated buffers: a step holds one training state, not two.  A caller
    that needs the state it passed in clones it first.

    grad_accum == 1 keeps the bf16 gradients.  Above it the batch splits into
    `grad_accum` microbatches along its first axis; each microbatch's
    gradients add into f32 accumulators in order, and the sums, the loss and
    the metrics are divided by `grad_accum`.  The metrics stay on the
    device: {"loss", "ce", "aux", "grad_norm", "lr"}.

    mesh: a `launch.mesh.Mesh` trains on it (`_mesh_train_step`): the
    params and opt_state are this rank's blocks (`shard_train_state`) and
    the batch its rows (`local_batch`).  On a 1 x 1 mesh every collective
    is the identity and the step computes the plain step's bits.

    param_dtype: the dtype AdamW hands the parameters back in (bf16, as the
    reference's; float32 trains in f32 throughout, given f32 parameters)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = _run_ctx(cfg, mesh, q_block=q_block, compact_softmax=compact_softmax)
    if mesh is not None:
        return _mesh_train_step(cfg, mesh, opt_cfg, grad_accum, ctx, param_dtype)

    def train_step(params, opt_state, batch):
        loss, met, grads = _accumulate(batch, grad_accum,
                                       lambda mb: loss_and_grads(params, mb, cfg, ctx),
                                       tree_lib.leaves(params))
        params, opt_state, opt_met = adamw.adamw_update(
            opt_cfg, tree_lib.unflatten(params, grads), opt_state, params, param_dtype)
        return params, opt_state, {"loss": loss, **met, **opt_met}

    return train_step


def _accumulate(batch, grad_accum: int, run, like: list):
    """(loss, metrics, gradients) over `grad_accum` microbatches of batch:
    run(microbatch) -> (loss, metrics, gradients); above one microbatch the
    gradients add in order into f32 accumulators shaped as the tensors of
    `like`, and the sums, the loss and the metrics are divided by
    `grad_accum`."""
    if grad_accum == 1:
        return run(batch)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in like]
    loss, mets = 0.0, []
    for i in range(grad_accum):
        mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        mb_loss, mb_met, g = run(mb)
        for a, gi in zip(acc, g):
            a.add_(gi)
        loss = loss + mb_loss
        mets.append(mb_met)
        del g
    grads = [a.copy_(true_div(a, grad_accum)) for a in acc]   # one leaf's temporary
    loss = true_div(loss, grad_accum)
    met = {k: true_div(torch.stack([m[k] for m in mets]).sum(0), grad_accum) for k in mets[0]}
    return loss, met, grads


# ---------------------------------------------------------------------------
# Train on a mesh
# ---------------------------------------------------------------------------

def leaf_plans(cfg: ArchConfig, mesh, overrides: Optional[dict] = None) -> list:
    """The `parallel.LeafPlan` of every parameter leaf, in flatten order:
    its specs, and whether its layer computes it split over `model` (the
    schema's `ParamDef.split`: the attention heads, the dense MLP's width,
    the vocabulary, the routed experts; the SSD mixer, the cross-attention,
    the router and the frontend projection are gathered whole).
    overrides: rules over `sharding.DEFAULT_RULES` (the pipeline's
    {"layers": "stage"}), for both specs."""
    defs = tree_lib.leaves(registry.schema(cfg))
    pspecs = shd.spec_leaves(shd.param_pspecs(cfg, mesh, overrides))
    zspecs = shd.spec_leaves(shd.zero1_pspecs(cfg, mesh, overrides))
    return [parallel.LeafPlan(p, z, d.split) for d, p, z in zip(defs, pspecs, zspecs)]


def state_specs(cfg: ArchConfig, mesh, overrides: Optional[dict] = None):
    """The specs of a training state (params, AdamWState): the parameters'
    `param_pspecs`, the master, m and v `zero1_pspecs`, the count ()."""
    z = shd.zero1_pspecs(cfg, mesh, overrides)
    return (shd.param_pspecs(cfg, mesh, overrides), adamw.AdamWState(z, z, z, ()))


def train_placements(cfg: ArchConfig, shape: ShapeConfig, mesh,
                     overrides: Optional[dict] = None) -> dict:
    """What each rank holds of a training step's inputs (the port's form of
    the reference's `train_lowering_inputs`): the specs of the parameters,
    of the optimizer state and of the batch's leaves, and the local shapes
    of the first two."""
    params, opt = state_specs(cfg, mesh, overrides)
    schema = registry.schema(cfg)
    full = [d.shape for d in tree_lib.leaves(schema)]
    return {"params": params, "opt_state": opt,
            "batch": shd.batch_shardings(registry.train_batch_spec(cfg, shape), mesh),
            "param_shapes": [shd.local_shape(s, p, mesh)
                             for s, p in zip(full, shd.spec_leaves(params))],
            "opt_shapes": [shd.local_shape(s, z, mesh)
                           for s, z in zip(full, shd.spec_leaves(opt.master))]}


def shard_train_state(params, cfg: ArchConfig, mesh, overrides: Optional[dict] = None):
    """(this rank's parameter blocks, its optimizer state) from full
    parameters: each leaf cut to its `param_pspecs` block (a copy where it
    splits, the leaf itself where it does not), the f32 master its
    `zero1_pspecs` block, m and v zeros of that shape."""
    plans = leaf_plans(cfg, mesh, overrides)
    leaves = tree_lib.leaves(params)

    def block(t, spec):
        b = shd.shard_of(t, spec, mesh)
        return b if b.shape == t.shape else b.contiguous().clone()

    p_blocks = [block(t, pl.pspec) for t, pl in zip(leaves, plans)]
    master = [shd.shard_of(t, pl.zspec, mesh).to(torch.float32, copy=True).contiguous()
              for t, pl in zip(leaves, plans)]
    zeros = lambda: [torch.zeros(m.shape, dtype=torch.float32, device=m.device) for m in master]
    count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    un = lambda xs: tree_lib.unflatten(params, xs)
    return un(p_blocks), adamw.AdamWState(un(master), un(zeros()), un(zeros()), count)


def local_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows of a global batch, as the reference's step shards
    it: the batch splits into `grad_accum` microbatches first, and each
    microbatch's rows split over the data axes; the rank's rows of each
    microbatch, in order (numpy arrays or tensors)."""
    daxes = mesh_lib.data_axes_of(mesh)
    idx, dp = shd.block_index(daxes, mesh)
    if dp == 1:
        return batch
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % grad_accum or (b // grad_accum) % dp:
            raise ValueError(f"batch {b} in {grad_accum} microbatches does not divide the "
                             f"{dp} data-parallel ranks")
        mb, rows = b // grad_accum, b // grad_accum // dp
        parts = [v[i * mb + idx * rows:i * mb + (idx + 1) * rows] for i in range(grad_accum)]
        out[k] = (np.concatenate(parts) if isinstance(v, np.ndarray) else torch.cat(parts))
    return out


def _mesh_train_step(cfg: ArchConfig, mesh, opt_cfg: adamw.AdamWConfig, grad_accum: int,
                     ctx: blocks.RunCtx, param_dtype=torch.bfloat16):
    """The train step on a mesh.  Each rank holds its blocks of the
    parameters (`param_pspecs`) and of the f32 master, m and v
    (`zero1_pspecs`), and runs its rows of each microbatch:

      * the model gathers each parameter on use (`models.parallel`): over
        `data` (FSDP), its gradient reduce-scattered back, summed in f32;
        over `model` where the leaf computes whole.  The heads, MLP width,
        vocabulary and experts compute split over `model`;
      * each microbatch's gradients are reduced onto the ZeRO-1 blocks
        (`mesh_update`'s `to_zero1`); above one microbatch they add into
        f32 accumulators of the ZeRO-1 blocks' shapes;
      * the loss, its metrics and the MoE aux statistics are global (their
        parts summed over the data axes);
      * AdamW updates the blocks in place (`mesh_update`)."""
    plans = leaf_plans(cfg, mesh)
    to_zero1, update = mesh_update(mesh, opt_cfg, plans, param_dtype)
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)

    def run(params, mb):
        leaves = []
        for t, plan in zip(tree_lib.leaves(params), plans):
            leaf = t.detach().requires_grad_(True)
            leaf._plan = plan
            leaves.append(leaf)
        with torch.enable_grad():
            loss, met = registry.loss_fn(tree_lib.unflatten(params, leaves), mb, cfg, ctx)
            grads = torch.autograd.grad(loss, leaves)
        grads = [to_zero1(g, plan) for g, plan in zip(grads, plans)]
        met = {k: v.detach() for k, v in met.items()}
        loss = loss.detach()
        if dp > 1:       # the loss and ce are global; aux is already
            for axis in reversed(ctx.data_axes):
                met["ce"] = parallel.all_reduce(met["ce"], mesh, axis)
            loss = met["ce"] + met["aux"]
        return loss, met, grads

    def train_step(params, opt_state, batch):
        loss, met, grads = _accumulate(batch, grad_accum, lambda mb: run(params, mb),
                                       tree_lib.leaves(opt_state.master))
        params, opt_state, opt_met = update(params, opt_state, grads)
        return params, opt_state, {"loss": loss, **met, **opt_met}

    return train_step


def mesh_update(mesh, opt_cfg: adamw.AdamWConfig, plans: list, param_dtype=torch.bfloat16):
    """The ZeRO-1 half of a step on a mesh, for the leaves' `plans`:
    (to_zero1(gradient, plan), update(params, opt_state, grads in flatten
    order) -> (params, opt_state, {"grad_norm", "lr"})).

      * `to_zero1` reduces a rank's gradient of a parameter block onto its
        ZeRO-1 block: where the plans split the layer stack over `stage`
        (the pipeline, whose stages compute disjoint parts of the model), a
        leaf not split over it (the embedding, the final norm, the
        unembedding) sums its stages' parts over `stage` in f32 first
        (without such a split every stage computes the same gradient); a
        leaf not split over `data` sums
        over it (reduce-scattered where its ZeRO-1 block splits `data`),
        every leaf sums over `pod`, and a block the ZeRO-1 spec splits over
        `model` is cut out (every model rank computed the same gradient);
      * `update` is AdamW on the blocks in place: the clip's global norm
        sums each leaf's squares over its block once (the rank at
        coordinate 0 of every axis the block is replicated over) in one
        all-reduce, and each new parameter is gathered from the ZeRO-1
        blocks back into its parameter block."""
    dsize, psize = mesh.shape.get("data", 1), mesh.shape.get("pod", 1)
    staged = any("stage" in plan.pspec for plan in plans)
    ssize = mesh.shape.get("stage", 1) if staged else 1

    def f32_sum(g, axis):
        return parallel.all_reduce(g.float(), mesh, axis).to(g.dtype)

    def to_zero1(g, plan):
        if ssize > 1 and "stage" not in plan.pspec:
            g = f32_sum(g, "stage")
        for j, (pp, zp) in enumerate(zip(plan.pspec, plan.zspec)):
            if zp == "model" and pp is None:
                g = parallel.block(g, j, mesh, "model")
        if "data" not in plan.pspec and dsize > 1:
            zd = plan.dim_of(plan.zspec, "data")
            g = (parallel.reduce_scatter_dim(g, zd, mesh, "data") if zd is not None
                 else f32_sum(g, "data"))
        if psize > 1:
            g = f32_sum(g, "pod")
        return g

    owned = [all(mesh.coord(a) == 0 for a in mesh.axis_names if a not in plan.zspec)
             for plan in plans]

    def global_norm(grads):
        total = sum(torch.sum(torch.square(g.float()))
                    for g, own in zip(tree_lib.leaves(grads), owned) if own)
        if not torch.is_tensor(total):
            total = torch.zeros((), dtype=torch.float32, device=tree_lib.leaves(grads)[0].device)
        if mesh.size > 1:
            total = total.contiguous()
            torch.distributed.all_reduce(total)
        return correctly_rounded_sqrt(total)

    def put(i, p, p32, param_dtype):
        plan = plans[i]
        added = [(j, zp) for j, (pp, zp) in enumerate(zip(plan.pspec, plan.zspec))
                 if pp is None and zp is not None]
        if not added:
            return p.copy_(p32) if p.dtype == param_dtype else p32.to(param_dtype)
        new = p32.to(param_dtype)
        for j, axis in added:
            new = parallel.all_gather_dim(new, j, mesh, axis)
        return p.copy_(new) if p.dtype == param_dtype else new

    def update(params, opt_state, grads):
        return adamw.adamw_update(opt_cfg, tree_lib.unflatten(params, grads), opt_state,
                                  params, param_dtype, norm_fn=global_norm, put=put)

    return to_zero1, update
