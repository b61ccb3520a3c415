"""Serving engines with ZipCache streaming compression (port of
`repro.serving.engine`, paper Alg. 2/3).

  * ``ServingEngine`` — the lockstep path: one packed batch prefills
    together, then decodes a fixed number of greedy steps.
  * ``EngineCore`` — continuous batching: a request lifecycle (``submit ->
    step/run -> result``, ``stream``, ``cancel``) over a fixed number of
    decode slots, with the scheduling policy injected
    (`serving.scheduler`).  A new request prefills on its own (batch 1, at a
    page-aligned ragged bucket of its prompt) and its compressed cache slice
    is inserted into a free slot of the running batch; a finished request
    frees its slot.  Inactive slots are masked, never sliced away.  Under
    the free-list page allocator (`core.alloc`), pages are granted and
    returned host-side between steps and admission defers when the pools
    cannot cover a request's worst case.
  * ``ContinuousEngine`` — `EngineCore` with the scheduler named by
    `ServeConfig.scheduler`.

Per-request cadence (paper Alg. 3 under continuous batching): each slot
carries its own token counter; probe rows and window folds fire on it, so a
request admitted mid-run sees the schedule of a fresh lockstep run.
Preemption by recompute re-prefills a victim and replays its retained
tokens through the same decode and fold steps, so its tokens are unchanged.
Under the free-list allocator two more levers relieve pressure: the host
swap tier (`preemption="swap"`, `core.swap`) moves a victim's exact cache
to host memory and back, tokens unchanged; the downshift ladder
(`preemption="downshift"`, `ladder_watermark`) early-folds a slot's window
one effective bit lower on its lo store and returns the window's pages.
Both engines take a precision map (`ServeConfig.precision_map`,
`core.precision`): effective-bit ceilings per layer and head inside the
same containers.  Over the free list, shared-prefix dedup
(`ServeConfig.prefix_cache`) admits a request whose page-aligned prompt
bucket was prefilled before by pointing its hi/lo page-table rows at the
donor's pages (no prefill), and copies those pages (copy-on-write) before
its first fold.

The probe flags of a step are host values: they pick the decode path
(exact slot weights on probe steps) with no device sync.

Sampling (the continuous engine; the lockstep engine is greedy): a request
with `SamplingParams(temperature > 0, seed)` draws each token with
`sample_tokens`, keyed on (seed, the request's token counter), so its
tokens depend on neither its slot nor its admission step, eager or
captured.  The draws are the reference's threefry bits (`core.prng`, the
`jax_threefry_partitionable=True` mode).  The first token is drawn at
admission (counter 0, from the prefill's or a prefix hit's snapshot
logits); a recompute replay or a swap-in never draws again.

Every engine program comes from the step factories of `launch.steps`, as
the reference's jitted ones do.  With `capture` (the default) both decode
steps are step objects over static buffers: on the card a step on which no
row probes replays a captured CUDA graph, and the engine writes whatever
an eager operation produces (prefill, a probe step, a fold, insertion, a
retirement) into the step's static cache tree (`adopt`).  `capture=False`
builds the eager path that the captured one is held against.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Callable, Deque, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import alloc as alloc_lib
from repro_torch.core import backend as backend_lib
from repro_torch.core import paged as paged_lib
from repro_torch.core import swap as swap_lib
from repro_torch.core.policy import CompressionConfig
from repro_torch.core.prng import sample_tokens
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry
from repro_torch.serving import events as events_lib
from repro_torch.serving import scheduler as scheduler_lib


def probe_flag(counter: int, interval: int, seed: int = 0) -> bool:
    """Probe schedule: the most recent ~5% of each recompress interval plus
    a hashed pseudo-random ~5% of steps, on the request's token counter."""
    n_recent = max(interval // 20, 1)
    recent = (counter % interval) >= interval - n_recent
    h = (counter * 2654435761 + seed * 40503 + 12345) & 0xFFFFFFFF
    rand = ((h >> 8) % 100) < 5
    return bool(recent or rand)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int                  # rows of the packed batch / decode slots
    prompt_len: int                  # static prompt capacity (left-padded)
    max_new_tokens: int = 128        # decode budget (the cache is sized for it)
    seed: int = 0
    # KV cache layout: "mixed" (dense per-slot arrays) or "paged" (page
    # pools behind per-slot page tables); greedy output is token-identical
    backend: str = "mixed"
    page_size: int = 64              # tokens per page; also the admission bucket
    # "paged" only: decode attention walks the pages (kernels/paged_qattn)
    paged_kernel: bool = False
    # "paged" only: "static" (every slot owns its worst case) or "freelist"
    # (shared pools of pool_fraction x that, granted on demand, admission
    # deferred when the pools cannot cover a request's worst case)
    page_allocator: str = "static"
    pool_fraction: float = 1.0
    # "freelist" only: fraction of each pool held back as admission headroom
    admit_watermark: float = 0.0
    # "freelist" only: a head-of-queue request that does not fit is left
    # queued ("defer", counted in pool_stats) or raises PagePoolExhausted
    # from step() ("error")
    backpressure: str = "defer"
    scheduler: str = "fifo"          # "fifo" | "priority"
    # "off" never evicts; "recompute" lets the scheduler evict a running
    # slot and re-admit it later by re-prefill + replay (tokens unchanged);
    # "swap" ("freelist" only) moves the victim's exact cache to host memory
    # and back (tokens unchanged; a refused swap falls back to recompute);
    # "downshift" ("freelist" only) keeps the victim decoding and early-folds
    # its window one lo-store bit lower, returning the window's pages
    preemption: str = "off"
    # per-layer/head effective-bit ceilings (core/precision.py); "" = off
    precision_map: str = ""
    # "freelist" only: downshift the oldest slot while the smallest free
    # fraction of the pools is at or below this (0 = the trigger is off)
    ladder_watermark: float = 0.0
    # preemption="swap" only: the host tier's budget in MiB (0 = one entry
    # per batch slot)
    swap_pool_mb: int = 0
    # "freelist" only: content-hash shared-prefix page dedup with
    # copy-on-write tables.  A hit aliases the hi/lo pages of an earlier
    # prefill of the same page-aligned prompt bucket and skips its prefill;
    # the slot's first fold privatizes the shared pages.  Greedy output is
    # bitwise that of prefix_cache=False
    prefix_cache: bool = False


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: temperature 0 = greedy; the seed (an int32)
    makes a sampled request reproducible whatever its slot and admission
    step."""
    temperature: float = 0.0
    seed: int = 0


@dataclasses.dataclass(eq=False)   # identity semantics: queue membership and
class Request:                     # removal must not compare token arrays
    """One generation request.

    tokens: (<= prompt_len,) prompt ids; `submit()` copies them.
    max_new_tokens: per-request budget, capped by ServeConfig.max_new_tokens.
    stop_tokens: generation stops when one of these is produced.
    priority: scheduling urgency (higher = sooner; the priority scheduler).
    deadline_s: wall-clock budget from submit; an expired request is
        cancelled at the next step boundary (reason "deadline").
    on_token: optional callback with each fresh `TokenEvent`; a raising
        callback is detached and surfaced as a `CallbackErrorEvent`.
    """
    tokens: np.ndarray
    id: Optional[str] = None
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    max_new_tokens: Optional[int] = None
    stop_tokens: Tuple[int, ...] = ()
    priority: int = 0
    deadline_s: Optional[float] = None
    on_token: Optional[Callable[[events_lib.TokenEvent], None]] = None


@dataclasses.dataclass
class RequestOutput:
    """Final output of one request.  timings: queued_s, prefill_s (incl.
    recompute replays), decode_s, tok_per_s (decode-phase tokens only),
    first_token_s, preempted_s, n_preemptions, n_deferrals."""
    id: str
    tokens: np.ndarray               # (n_generated,) int32, stop token included
    finish_reason: str               # "stop" | "length" | "cancelled"
    timings: Dict[str, float]


@dataclasses.dataclass(frozen=True)
class _SwapState:
    """Host record of one swapped-out request, carried on the Request until
    re-admission: the swap pool's handle and every per-slot counter the
    restore reinstates (allocator occupancy, probe and fold counters, the
    ladder rung)."""
    handle: int
    occ: alloc_lib.Occupancy
    steps: int
    since_rc: int
    rung: int


@dataclasses.dataclass
class _Slot:
    """Engine-internal per-slot decode state."""
    request: Request
    generated: List[int]
    steps: int = 0                   # decode steps done (probe counter)
    since_rc: int = 0                # tokens since the last fold
    t_submit: float = 0.0
    t_admit: float = 0.0
    prefill_s: float = 0.0


def pack_requests(requests: Sequence[np.ndarray], batch_size: int,
                  prompt_len: int, pad_id: int = 0) -> np.ndarray:
    """Left-pad + stack request prompts into a fixed-shape batch; raises on
    overflow instead of truncating."""
    if len(requests) > batch_size:
        raise ValueError(f"{len(requests)} requests exceed batch_size {batch_size}")
    out = np.full((batch_size, prompt_len), pad_id, np.int32)
    for i, r in enumerate(requests):
        r = np.asarray(r)
        if r.shape[-1] > prompt_len:
            raise ValueError(f"prompt of {r.shape[-1]} tokens exceeds prompt_len {prompt_len}")
        out[i, prompt_len - len(r):] = r
    return out


class _EngineBase:
    def __init__(self, cfg: ArchConfig, ccfg: CompressionConfig, scfg: ServeConfig, params,
                 device="cuda", use_kernels: bool = True, capture: bool = True):
        self.cfg = cfg
        self.ccfg = ccfg
        self.scfg = scfg
        self.params = params
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        shape = ShapeConfig("serve", scfg.prompt_len, scfg.batch_size, "prefill",
                            cache_backend=scfg.backend, page_size=scfg.page_size,
                            paged_kernel=scfg.paged_kernel, page_allocator=scfg.page_allocator,
                            pool_fraction=scfg.pool_fraction, precision_map=scfg.precision_map)
        self._shape = shape
        self.ctx = steps_lib.serve_ctx(cfg, shape, ccfg,
                                       decode_budget=scfg.max_new_tokens,
                                       q_block=min(512, scfg.prompt_len), device=self.device,
                                       use_kernels=use_kernels)
        # the lockstep program family, built from the shared step factories
        # over one serving ctx (ragged admission buckets get their prefill
        # lazily); `EngineCore` adds the continuous one
        mk = dict(ctx=self.ctx, device=self.device)
        self._prefill = steps_lib.make_prefill_step(cfg, shape, ccfg, **mk)[0]
        self._prefill_buckets: Dict[int, Callable] = {}
        self._decode = steps_lib.make_serve_step(cfg, shape, ccfg, capture=capture, **mk)[0]
        self._recompress = steps_lib.make_recompress_step(cfg, shape, ccfg, **mk)[0]

    def _bucket_len(self, n_tokens: int) -> int:
        """Ragged admission bucket: the smallest whole-page length that holds
        the prompt, capped at the prompt window (ServeConfig.page_size for
        every backend, so all layouts prefill alike)."""
        ps = self.scfg.page_size
        return min(alloc_lib.pages_for(max(n_tokens, 1), ps) * ps, self.scfg.prompt_len)

    def _prefill_for(self, bucket_len: int) -> Callable:
        """The prefill program of one admission bucket.  A shorter bucket has
        its own serving context: its own probes for `seq_len = bucket_len`,
        and the decode budget extended by the saved prompt tokens, so every
        cache shape matches the decode batch's."""
        if bucket_len == self.scfg.prompt_len:
            return self._prefill
        fn = self._prefill_buckets.get(bucket_len)
        if fn is None:
            bshape = dataclasses.replace(self._shape, seq_len=bucket_len)
            ctx = steps_lib.serve_ctx(
                self.cfg, bshape, self.ccfg,
                decode_budget=self.scfg.max_new_tokens + self.scfg.prompt_len - bucket_len,
                q_block=min(512, bucket_len), device=self.device, use_kernels=self.use_kernels)
            fn = steps_lib.make_prefill_step(self.cfg, bshape, self.ccfg, ctx=ctx)[0]
            self._prefill_buckets[bucket_len] = fn
        return fn

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def cache_bytes(self, caches) -> Dict[str, int]:
        """Packed KV payload against bookkeeping overhead (and, for the free
        list, the unallocated pool pages within it) over a cache tree, as
        `core.backend.cache_bytes` counts them."""
        return backend_lib.cache_bytes(caches)


class ServingEngine(_EngineBase):
    """Lockstep batch generation: all requests prefill together and decode
    the same number of greedy steps.  Each step's greedy token feeds the
    next through the decode step's static input: the loop never waits for
    the device."""

    def __init__(self, cfg: ArchConfig, ccfg: CompressionConfig, scfg: ServeConfig, params,
                 device="cuda", use_kernels: bool = True, capture: bool = True):
        super().__init__(cfg, ccfg, scfg, params, device=device, use_kernels=use_kernels,
                         capture=capture)
        self.last_caches = None

    def _is_probe(self, i: int) -> bool:
        return probe_flag(i, self.ccfg.recompress_interval, self.scfg.seed)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, np.ndarray],
                 max_new_tokens: Optional[int] = None) -> Dict[str, object]:
        """Prefill + streaming decode for one packed batch.

        batch: {"tokens": (b, l) int32[, "frontend_embeds": (b, n, e)]}: the
        encoder-decoder's source frames (tokens: its decoder prompt) or a
        frontend arch's embeddings, on the engine's device in their own dtype.
        Returns {"tokens": (b, n_new) int32 numpy, "timings": {...}}.
        """
        n_new = max_new_tokens if max_new_tokens is not None else self.scfg.max_new_tokens
        t0 = time.perf_counter()
        inputs = {k: torch.as_tensor(batch[k], device=self.device)
                  for k in ("tokens", "frontend_embeds") if k in batch}
        tokens = inputs["tokens"]
        logits, caches = self._prefill(self.params, inputs)
        caches = self._decode.adopt(caches)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        t_prefill = time.perf_counter() - t0

        outs = torch.empty((tokens.shape[0], n_new), dtype=torch.int32, device=self.device)
        t1 = time.perf_counter()
        since_recompress = 0
        for i in range(n_new):
            outs[:, i] = tok
            _, caches = self._decode(self.params, caches, tok, self._is_probe(i))
            tok = self._decode.token
            since_recompress += 1
            if since_recompress >= self.ccfg.recompress_interval:
                caches = self._decode.adopt(self._recompress(caches))
                since_recompress = 0
        self._sync()
        t_decode = time.perf_counter() - t1
        self.last_caches = caches
        return {
            "tokens": outs.cpu().numpy(),
            "timings": {"prefill_s": t_prefill, "decode_s": t_decode,
                        "tok_per_s": n_new * self.scfg.batch_size / max(t_decode, 1e-9)},
        }


class EngineCore(_EngineBase):
    """Continuous batching over a fixed slot count, scheduling policy injected.

        eng = ContinuousEngine(cfg, ccfg, scfg, params)
        rid = eng.submit(Request(tokens=prompt, stop_tokens=(eos,)))
        for tok in eng.stream(rid):     # drives step() while tokens are pending
            ...
        out = eng.result(rid)           # RequestOutput

    Each ``step()`` runs the ladder's pressure trigger, the scheduler's
    admission plan (and, with preemption armed, evictions: recompute, swap
    or downshift), decodes one token for every active slot, retires
    finished requests, folds staging windows on each slot's own cadence,
    and returns the typed events it produced.
    """

    def __init__(self, cfg: ArchConfig, ccfg: CompressionConfig, scfg: ServeConfig, params,
                 scheduler: scheduler_lib.Scheduler, device="cuda", use_kernels: bool = True,
                 capture: bool = True):
        if scfg.backpressure not in ("defer", "error"):
            raise ValueError(f"ServeConfig.backpressure must be 'defer' or 'error', got "
                             f"{scfg.backpressure!r}")
        if scfg.preemption not in ("off", "recompute", "downshift", "swap"):
            raise ValueError(f"ServeConfig.preemption must be 'off', 'recompute', 'downshift' "
                             f"or 'swap', got {scfg.preemption!r}")
        if cfg.encdec or cfg.frontend != "none":
            raise NotImplementedError(
                "ContinuousEngine currently serves decoder-only text models; "
                "use the lockstep ServingEngine for encdec/frontend archs")
        super().__init__(cfg, ccfg, scfg, params, device=device, use_kernels=use_kernels,
                         capture=capture)
        shape, mk = self._shape, dict(ctx=self.ctx, device=self.device)
        self._decode_masked = steps_lib.make_continuous_decode_step(
            cfg, shape, ccfg, capture=capture, **mk)[0]
        self._insert = steps_lib.make_insert_step(cfg, shape, ccfg, **mk)[0]
        self._recompress_rows = steps_lib.make_recompress_rows_step(cfg, shape, ccfg, **mk)[0]
        # per-slot folds where the backend offers them (paged): a batch-1 view
        self._recompress_slot = None
        if hasattr(self.ctx.backend, "recompress_slot"):
            self._recompress_slot = steps_lib.make_recompress_slot_step(cfg, shape, ccfg,
                                                                        **mk)[0]
        # every op on the caches runs in inference mode (`step`, `cancel`), so
        # they are made in it too: an inference tensor takes no in-place
        # write outside the mode
        with torch.inference_mode():
            caches = registry.init_caches(cfg, self.ctx, scfg.batch_size, device=self.device)
        self.scheduler = scheduler
        self.slots: List[Optional[_Slot]] = [None] * scfg.batch_size
        self.queue: Deque[Request] = collections.deque()
        self.results: Dict[str, RequestOutput] = {}
        self._ids = itertools.count()
        self._seq = itertools.count()      # arrival stamps (scheduler order)
        self._step_no = 0
        self._known: Set[str] = set()
        self._closed = False
        self._token_log: Dict[str, List[int]] = {}   # feeds stream()
        self._events: List[events_lib.Event] = []    # the current step's events
        self._n_admissions = 0                       # prefills, re-admissions included
        self._n_folds = 0                            # slot windows folded
        self._alloc: Optional[alloc_lib.FreeListAllocator] = None
        self._tables: Dict[str, torch.Tensor] = {}
        self._last_deferred: Optional[str] = None
        if getattr(self.ctx.backend, "allocator", "static") == "freelist":
            self._alloc = alloc_lib.FreeListAllocator.from_caches(
                caches, page_size=self.ctx.backend.page_size, watermark=scfg.admit_watermark)
            # one device table per segment, shared by every layer and written
            # in place from then on: the captured step reads it by address
            with torch.inference_mode():
                self._tables = {k: torch.from_numpy(v).to(self.device)
                                for k, v in self._alloc.tables().items()}
            self._alloc.dirty = False
            # onto the paged elements: an SSM state holds no pages
            caches = registry.map_caches(
                lambda el: paged_lib.with_tables(el, self._tables["hi"], self._tables["lo"],
                                                 self._tables["win"])
                if isinstance(el, paged_lib.PagedKVCache) else el, caches)
        self.caches = self._decode_masked.adopt(caches)
        # the downshift ladder: pressure is page-pool pressure, and what a
        # downshift frees is the window pages its fold returns, which only the
        # free list has.  A slot's rung: effective bits below the base map of
        # its lo store at its next folds; it dies with the slot, and the
        # deepest rung floors the lo store at 1 bit.  Armed, every fold takes
        # the slots' rungs as an operand (the ladder's fold steps).
        self._ladder = scfg.ladder_watermark > 0 or scfg.preemption == "downshift"
        if self._ladder and self._alloc is None:
            raise ValueError("the downshift ladder (ladder_watermark > 0 or "
                             "preemption='downshift') requires backend='paged' with "
                             "page_allocator='freelist'")
        self._rungs = np.zeros(scfg.batch_size, np.int32)
        self._max_rung = max(ccfg.low_bits - 1, 0)
        mk = dict(ctx=self.ctx, device=self.device)
        # shared-prefix dedup: the allocator keeps the page index, the engine
        # the device snapshot of each indexed prefill ({key: (slice_caches,
        # logits)}) that a hit re-inserts instead of prefilling, and the
        # page copies of copy-on-write
        if scfg.prefix_cache and self._alloc is None:
            raise ValueError("ServeConfig.prefix_cache requires backend='paged' with "
                             "page_allocator='freelist' (dedup aliases free-list pages)")
        self._prefix_on = scfg.prefix_cache
        self._prefix_snap: Dict[str, Tuple] = {}
        self._prefix_tokens_skipped = 0
        self._pending_reg: List[Tuple] = []
        if self._prefix_on:
            self._copy_pages = steps_lib.make_copy_pages_step(cfg, self._shape, ccfg, **mk)[0]
        if self._ladder:
            self._recompress_rows_rung = steps_lib.make_recompress_rows_step(
                cfg, self._shape, ccfg, ladder=True, **mk)[0]
            self._recompress_slot_rung = steps_lib.make_recompress_slot_step(
                cfg, self._shape, ccfg, ladder=True, **mk)[0]
        # the host swap tier: the extract / restore pair and a pool of host
        # entries shaped like one extract, made once
        self._swap: Optional[swap_lib.HostSwapPool] = None
        if scfg.preemption == "swap":
            if self._alloc is None:
                raise ValueError("preemption='swap' requires backend='paged' with "
                                 "page_allocator='freelist' (a swap-out returns the victim's "
                                 "pages to the free pools)")
            self._swap_extract = steps_lib.make_swap_extract_step(cfg, self._shape, ccfg, **mk)[0]
            self._swap_restore = steps_lib.make_swap_restore_step(cfg, self._shape, ccfg, **mk)[0]
            with torch.inference_mode():
                template = self._swap_extract(self.caches, 0)
            self._swap = swap_lib.HostSwapPool(template, swap_pool_mb=scfg.swap_pool_mb,
                                               fallback_entries=scfg.batch_size)
            del template

    # ------------------------------------------------------------------
    # lifecycle API
    # ------------------------------------------------------------------

    @property
    def pending(self) -> bool:
        """True while a request is queued or decoding, or events are buffered
        (a between-steps `cancel()` is delivered by the next step)."""
        return bool(self.queue) or any(s is not None for s in self.slots) or bool(self._events)

    def _request_budget(self, request: Request) -> int:
        return (request.max_new_tokens if request.max_new_tokens is not None
                else self.scfg.max_new_tokens)

    def _request_total_tokens(self, request: Request) -> int:
        """Worst-case cached tokens: the ragged bucket plus the decode budget."""
        return self._bucket_len(int(request.tokens.shape[-1])) + self._request_budget(request)

    def submit(self, request: Request) -> str:
        """Validate + enqueue a request; returns its id.

        Raises ValueError on prompts or budgets the engine can never hold,
        `events.EngineClosedError` after `shutdown()`,
        `alloc.PoolCapacityError` when the free-list pools can never hold the
        request's worst case."""
        if self._closed:
            raise events_lib.EngineClosedError(
                "engine is shut down: it drains what it has but accepts no new requests")
        if not -2**31 <= request.sampling.seed < 2**31:
            raise ValueError(f"sampling seed {request.sampling.seed} is not an int32")
        request.tokens = np.array(request.tokens, dtype=np.int32)
        n = int(request.tokens.shape[-1])
        if n > self.scfg.prompt_len:
            raise ValueError(f"prompt of {n} tokens exceeds engine prompt_len "
                             f"{self.scfg.prompt_len}")
        if request.max_new_tokens is not None and not (
                1 <= request.max_new_tokens <= self.scfg.max_new_tokens):
            raise ValueError(f"max_new_tokens {request.max_new_tokens} outside the engine's "
                             f"[1, {self.scfg.max_new_tokens}] decode budget")
        bucket = self._bucket_len(n)
        if self._alloc is not None and not self._alloc.fits_ever(
                self._request_total_tokens(request), bucket):
            raise alloc_lib.PoolCapacityError(
                f"request needs "
                f"{self._alloc.worst_pages(self._request_total_tokens(request), bucket)} pages "
                f"worst-case, beyond the pool ({self._alloc.stats()}); raise pool_fraction or "
                "lower the request budget")
        # the prefix key, stamped once: planning probes it many times a step
        request._prefix_key = (alloc_lib.prefix_key(request.tokens, self.scfg.page_size, bucket)
                               if self._prefix_on else None)
        if request.id is None:
            rid = f"req-{next(self._ids)}"
            while rid in self._known:  # user ids may shadow auto ids
                rid = f"req-{next(self._ids)}"
            request.id = rid
        elif request.id in self._known:
            raise ValueError(f"request id {request.id!r} already submitted; ids must be unique")
        if request.deadline_s is not None and request.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {request.deadline_s}")
        request._t_submit = time.perf_counter()
        request._deadline = (None if request.deadline_s is None
                             else request._t_submit + request.deadline_s)
        request._seq = next(self._seq)
        request._t_first_admit = None    # first admission (queued_s)
        request._t_first = None          # first token (first_token_s)
        request._prefill_s_acc = 0.0     # carried across preemptions
        request._decode_s_acc = 0.0
        request._preempt_s = 0.0
        request._n_preempts = 0
        request._n_deferrals = 0
        self._known.add(request.id)
        self._token_log[request.id] = []
        self.queue.append(request)
        return request.id

    def poll(self, request_id: str) -> str:
        """'queued' (waiting for a slot or pages, or preempted), 'running' or
        'done'.  Raises `events.UnknownRequestError` for an unknown id."""
        if request_id not in self._known:
            raise events_lib.UnknownRequestError(request_id)
        if request_id in self.results:
            return "done"
        if any(s is not None and s.request.id == request_id for s in self.slots):
            return "running"
        return "queued"

    def result(self, request_id: str) -> Optional[RequestOutput]:
        """The finished request's RequestOutput, or None while it is queued or
        running."""
        if request_id not in self._known:
            raise events_lib.UnknownRequestError(request_id)
        return self.results.get(request_id)

    def stream(self, request_id: str) -> Iterator[int]:
        """Yield the request's tokens as they decode (first token included),
        calling `step()` whenever it has yielded everything decoded so far.
        The concatenation is `result(request_id).tokens`."""
        if request_id not in self._known:
            raise events_lib.UnknownRequestError(request_id)
        sent = 0
        while True:
            out = self.results.get(request_id)
            log = out.tokens if out is not None else self._token_log.get(request_id, ())
            while sent < len(log):
                yield int(log[sent])
                sent += 1
            if out is not None:
                return
            self.step()

    @torch.inference_mode()
    def cancel(self, request_id: str, reason: str = "client") -> bool:
        """Retire a queued or running request early: its slot and pages are
        returned at once, its result carries the tokens decoded so far with
        finish_reason "cancelled", and a `CancelledEvent` is delivered by the
        current or next step.  False if it had already finished."""
        if request_id not in self._known:
            raise events_lib.UnknownRequestError(request_id)
        if request_id in self.results:
            return False
        for slot_id, s in enumerate(self.slots):
            if s is not None and s.request.id == request_id:
                self._retire(slot_id, "cancelled", cancel_reason=reason)
                return True
        req = next(r for r in self.queue if r.id == request_id)
        self.queue.remove(req)
        # a swapped-out request dies with its host entry
        st = getattr(req, "_swap_state", None)
        if st is not None:
            self._swap.release(st.handle)
            del req._swap_state
        now = time.perf_counter()
        resume = getattr(req, "_resume_tokens", None)
        tokens = list(resume) if resume is not None else []
        preempt_s = req._preempt_s + (now - req._t_preempt if resume is not None else 0.0)
        dec_tok = max(len(tokens) - 1, 0)
        self.results[req.id] = RequestOutput(
            id=req.id, tokens=np.asarray(tokens, np.int32), finish_reason="cancelled",
            timings={
                "queued_s": (req._t_first_admit if req._t_first_admit is not None
                             else now) - req._t_submit,
                "prefill_s": req._prefill_s_acc,
                "decode_s": req._decode_s_acc,
                "tok_per_s": (dec_tok / req._decode_s_acc
                              if dec_tok and req._decode_s_acc > 0 else 0.0),
                "first_token_s": (req._t_first if req._t_first is not None
                                  else now) - req._t_submit,
                "preempted_s": preempt_s,
                "n_preemptions": req._n_preempts,
                "n_deferrals": req._n_deferrals,
            })
        self._token_log.pop(req.id, None)
        if self._last_deferred == req.id:
            self._last_deferred = None
        self._events.append(events_lib.CancelledEvent(req.id, self._step_no,
                                                      n_tokens=len(tokens), reason=reason))
        return True

    def _sweep_deadlines(self) -> None:
        """Cancel every queued or running request past its deadline."""
        now = time.perf_counter()
        expired = [r.id for r in self.queue
                   if getattr(r, "_deadline", None) is not None and now > r._deadline]
        expired += [s.request.id for s in self.slots
                    if s is not None and getattr(s.request, "_deadline", None) is not None
                    and now > s.request._deadline]
        for rid in expired:
            self.cancel(rid, reason="deadline")

    def shutdown(self) -> None:
        """Stop accepting new work; queued and running requests drain."""
        self._closed = True

    def run(self, max_steps: Optional[int] = None) -> Dict[str, RequestOutput]:
        """Drive the scheduler until every submitted request finished."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.results

    # ------------------------------------------------------------------
    # scheduler internals
    # ------------------------------------------------------------------

    def _sync_tables(self) -> None:
        """Write the allocator's page tables into the device tables every
        layer's cache shares, in place; only when the allocator changed.  A
        blocking copy: the host tables are free again when it returns."""
        if self._alloc is None or not self._alloc.dirty:
            return
        for name, table in self._alloc.tables().items():
            self._tables[name].copy_(torch.from_numpy(table))
        self._alloc.dirty = False

    def _set_caches(self, caches) -> None:
        """Take the result of an eager operation on the caches: copied into
        the decode step's static tree (with capture)."""
        self.caches = self._decode_masked.adopt(caches)

    def pool_stats(self) -> Optional[Dict]:
        """Free-list pool telemetry (None for static and mixed layouts):
        per segment {pool_pages, used, free, peak_used, outstanding}, the
        cumulative deferral and preemption counts, the downshift ladder's
        block (downshifts, the window pages they freed, refusals), the
        shared-prefix block (index entries, hits, misses, evictions, CoW
        copies, shared and saved pages, the prefill tokens hits skipped),
        the host swap tier's block where preemption="swap" (swaps out / in,
        resident host bytes, refusals), and the engine's admissions that
        ran a prefill (a prefix hit runs none) and slot folds."""
        if self._alloc is None:
            return None
        stats = self._alloc.stats()
        stats["prefix"]["prefill_tokens_skipped"] = self._prefix_tokens_skipped
        if self._swap is not None:
            stats["swap"] = self._swap.stats()
        return {**stats, "admissions": self._n_admissions, "folds": self._n_folds}

    def free(self, slot_id: int) -> None:
        """Retire a slot: invalidate its batch row and, under the free list,
        return every page it held."""
        if self._alloc is not None:
            self._alloc.free(slot_id)
            self._sync_tables()
        self._set_caches(registry.free_caches(self.caches, slot_id))
        self.slots[slot_id] = None
        self._rungs[slot_id] = 0   # the ladder rung dies with the slot

    def _retire(self, slot_id: int, reason: str, cancel_reason: Optional[str] = None) -> None:
        s = self.slots[slot_id]
        req = s.request
        now = time.perf_counter()
        decode_s = max(now - s.t_admit - s.prefill_s, 0.0) + req._decode_s_acc
        dec_tok = max(len(s.generated) - 1, 0)   # the first token came from the prefill
        first_admit = req._t_first_admit if req._t_first_admit is not None else s.t_admit
        self.results[req.id] = RequestOutput(
            id=req.id, tokens=np.asarray(s.generated, np.int32), finish_reason=reason,
            timings={
                "queued_s": first_admit - s.t_submit,
                "prefill_s": s.prefill_s + req._prefill_s_acc,
                "decode_s": decode_s,
                "tok_per_s": dec_tok / decode_s if dec_tok and decode_s > 0 else 0.0,
                "first_token_s": (req._t_first if req._t_first is not None
                                  else now) - s.t_submit,
                "preempted_s": req._preempt_s,
                "n_preemptions": req._n_preempts,
                "n_deferrals": req._n_deferrals,
            })
        if reason == "cancelled":
            self._events.append(events_lib.CancelledEvent(
                req.id, self._step_no, n_tokens=len(s.generated),
                reason=cancel_reason if cancel_reason is not None else "client"))
        else:
            self._events.append(events_lib.FinishedEvent(
                req.id, self._step_no, finish_reason=reason, n_tokens=len(s.generated)))
        self._token_log.pop(req.id, None)
        self.scheduler.on_retire(slot_id, req)
        self.free(slot_id)

    def _maybe_finish(self, slot_id: int) -> bool:
        s = self.slots[slot_id]
        if s.generated and s.generated[-1] in s.request.stop_tokens:
            self._retire(slot_id, "stop")
            return True
        if len(s.generated) >= self._request_budget(s.request):
            self._retire(slot_id, "length")
            return True
        return False

    def _emit_token(self, request: Request, token: int, index: int) -> None:
        """One fresh token: event, stream log, optional push callback (a
        raising callback is detached and reported, never unwinds the step)."""
        ev = events_lib.TokenEvent(request.id, self._step_no, token=int(token), index=index)
        self._events.append(ev)
        self._token_log[request.id].append(int(token))
        if request.on_token is not None:
            try:
                request.on_token(ev)
            except Exception as e:  # noqa: BLE001 — any sink failure is contained
                request.on_token = None
                self._events.append(events_lib.CallbackErrorEvent(
                    request.id, self._step_no, error=f"{type(e).__name__}: {e}"))

    def _alias_can_fold(self, req: Request) -> bool:
        """Whether the request can reach a fold: it decodes budget - 1 steps
        (the first token comes from the prefill logits)."""
        return self._request_budget(req) - 1 >= self.ccfg.recompress_interval

    def _prefix_hit(self, req: Request) -> bool:
        """A usable hit needs both the allocator's index entry and the
        engine's snapshot; planning and admission take the same predicate."""
        key = getattr(req, "_prefix_key", None)
        return (key is not None and self._alloc.prefix_peek(key) is not None
                and key in self._prefix_snap)

    def _demand_pages(self, req: Request) -> Dict[str, int]:
        """Worst-case per-segment page demand of one queued request; a prefix
        hit that never folds shares its hi/lo pages for life and demands
        only its window."""
        worst = self._alloc.worst_pages(self._request_total_tokens(req),
                                        self._bucket_len(int(req.tokens.shape[-1])))
        if self._prefix_hit(req) and not self._alias_can_fold(req):
            worst = {**worst, "hi": 0, "lo": 0}
        return worst

    def _pool_view(self) -> scheduler_lib.PoolView:
        return scheduler_lib.PoolView(self._alloc,
                                      self._demand_pages if self._alloc is not None else None)

    def _running_views(self) -> List[scheduler_lib.SlotView]:
        return [scheduler_lib.SlotView(i, s.request, len(s.generated),
                                       self._request_budget(s.request))
                for i, s in enumerate(self.slots) if s is not None]

    def _admit(self) -> None:
        """Execute the scheduler's admission plan and preemptions.  A request
        is admitted only when every pool can reserve its worst case on top of
        the running slots' reservations and the watermark; a blocked plan
        defers (counted once per request per blocked span) or raises
        `PagePoolExhausted` under backpressure="error"."""
        n_evicted = 0
        while True:
            free_slots = [i for i in range(self.scfg.batch_size) if self.slots[i] is None]
            plan = self.scheduler.admit(list(self.queue), free_slots, self._pool_view())
            for slot_id, req in plan.admissions:
                self.queue.remove(req)
                self._admit_one(slot_id, req)
            if (self.scfg.preemption != "off" and self.queue
                    and n_evicted < self.scfg.batch_size):
                victim = self.scheduler.select_victim(list(self.queue), self._running_views(),
                                                      self._pool_view())
                # an ineligible downshift victim falls through to defer / error
                if victim is not None and self._relieve(victim):
                    n_evicted += 1
                    continue   # re-plan with the freed slot or pages
            if plan.blocked is not None and self._prefix_on and self._alloc.prefix:
                # out of pages with prefixes indexed: evict LRU entries and
                # re-plan before counting a deferral (the index shrinks on
                # every pass, so this ends)
                for key in self._alloc.prefix_reclaim():
                    self._prefix_snap.pop(key, None)
                continue
            if plan.blocked is not None:
                if self.scfg.backpressure == "error":
                    raise alloc_lib.PagePoolExhausted(
                        f"request {plan.blocked.id!r} needs {self._demand_pages(plan.blocked)} "
                        f"pages worst-case; pools: {self._alloc.stats()}")
                if plan.blocked.id != self._last_deferred:
                    self._alloc.deferrals += 1
                    plan.blocked._n_deferrals += 1
                    self._last_deferred = plan.blocked.id
            else:
                self._last_deferred = None
            break
        # the registrations of this pass's prefills, deferred to its end: one
        # rescinds the donor's ownership and raises its outstanding
        # reservation, which must not change the headroom a planned
        # admission of the same pass was checked against
        for key, slot_id, req, slice_caches, logits in self._pending_reg:
            s = self.slots[slot_id]
            if s is None or s.request is not req:
                continue   # retired or preempted before its registration
            if self._alloc.prefix_register(key, slot_id):
                self._prefix_snap[key] = (slice_caches, logits)
        self._pending_reg = []

    def _admit_one(self, slot_id: int, req: Request) -> None:
        """Prefill (batch 1, at the request's bucket) or, on a prefix hit,
        alias the indexed pages and take the prefill's snapshot; insert the
        compressed slice into the slot, then take the first token (a fresh
        request) or replay the retained tokens (recompute re-admission).

        A hit re-inserts the snapshot: the metadata rows and the fresh window
        pages take the donor's bytes, and the scatter onto the aliased hi/lo
        pages writes the bytes they already hold."""
        t0 = time.perf_counter()
        if getattr(req, "_swap_state", None) is not None:
            # the host holds its exact cache: upload it instead of a prefill
            self._swap_in(slot_id, req, t0)
            return
        bucket = self._bucket_len(int(req.tokens.shape[-1]))
        resume = getattr(req, "_resume_tokens", None)
        if self._prefix_on and self._prefix_hit(req):
            slice_caches, logits = self._prefix_snap[req._prefix_key]
            self._alloc.admit_alias(slot_id, req._prefix_key, self._request_total_tokens(req),
                                    bucket, can_fold=self._alias_can_fold(req))
            self._prefix_tokens_skipped += bucket
            self._sync_tables()
        else:
            self._n_admissions += 1
            prompt = torch.from_numpy(pack_requests([req.tokens], 1, bucket)).to(self.device)
            logits, slice_caches = self._prefill_for(bucket)(self.params, {"tokens": prompt})
            if self._alloc is not None:
                self._alloc.admit(slot_id, alloc_lib.slice_occupancy(slice_caches),
                                  self._request_total_tokens(req), bucket)
                self._sync_tables()
                if self._prefix_on:
                    self._alloc.prefix_note_miss()
                    # a recompute re-admission is never a donor: its replay
                    # may fold the slot before the registration
                    if resume is None:
                        self._pending_reg.append((req._prefix_key, slot_id, req, slice_caches,
                                                  logits))
        self._set_caches(self._insert(self.caches, slice_caches, slot_id))
        if resume is None:
            generated = [self._first_token(req, logits)]
        else:   # the prefill rebuilt exactly the cache the first token came from
            req._preempt_s += t0 - req._t_preempt
            generated = [int(resume[0])]
        t1 = time.perf_counter()
        self.slots[slot_id] = _Slot(request=req, generated=generated,
                                    t_submit=getattr(req, "_t_submit", t0), t_admit=t0,
                                    prefill_s=t1 - t0)
        if req._t_first_admit is None:
            req._t_first_admit = t0
        if resume is None:
            req._t_first = t1
            self._emit_token(req, generated[0], 0)
        else:
            del req._resume_tokens
            self._replay(slot_id, resume)
            self.slots[slot_id].prefill_s = time.perf_counter() - t0
        self._maybe_finish(slot_id)

    def _first_token(self, req: Request, logits: torch.Tensor) -> int:
        """A fresh request's first token from its prefill (or snapshot)
        logits: greedy, or drawn at counter 0."""
        sp = req.sampling
        if not sp.temperature > 0:
            return int(torch.argmax(logits[0]))
        temp = torch.tensor([sp.temperature], dtype=torch.float32, device=self.device)
        seed, ctr = torch.tensor([[sp.seed], [0]], dtype=torch.int32, device=self.device)
        return int(sample_tokens(logits, temp, seed, ctr)[0])

    def _decode_rows(self, rows: Dict[int, Tuple]) -> torch.Tensor:
        """One masked decode step of the slots {slot: (token, probe[,
        temperature, seed, counter])}, staged as one (6, b) host matrix ->
        logits (b, vocab)."""
        logits, self.caches = self._decode_masked(
            self.params, self.caches, steps_lib.stage_rows(rows, self.scfg.batch_size))
        return logits

    def _replay(self, slot_id: int, tokens: Sequence[int]) -> None:
        """Recompute a preempted slot's cache: feed its retained tokens back
        through the same masked decode and fold steps on the slot's own
        counters.  No TokenEvents fire; the last token is fed by the next
        regular step."""
        s = self.slots[slot_id]
        interval = self.ccfg.recompress_interval
        for i in range(len(tokens) - 1):
            if self._alloc is not None:
                self._alloc.note_append(slot_id)
                self._sync_tables()
            self._decode_rows(
                {slot_id: (int(tokens[i]), probe_flag(s.steps, interval, self.scfg.seed))})
            s.steps += 1
            s.since_rc += 1
            s.generated.append(int(tokens[i + 1]))
            if s.since_rc >= interval:
                self._fold([slot_id])
                s.since_rc = 0

    def _relieve(self, victim: int) -> bool:
        """Apply the preemption lever to the scheduler's victim; False when a
        downshift cannot make progress this step.  A refused swap falls back
        to recompute, so an eviction frees the slot either way."""
        if self.scfg.preemption == "downshift":
            return self._downshift(victim)
        if not (self.scfg.preemption == "swap" and self._swap_out(victim)):
            self._preempt(victim)
        return True

    def _evict(self, slot_id: int) -> Request:
        """Evict a running slot: keep its tokens host-side (`_resume_tokens`),
        return its pages, requeue it at its arrival position."""
        s = self.slots[slot_id]
        req = s.request
        now = time.perf_counter()
        req._resume_tokens = list(s.generated)
        req._t_preempt = now
        req._n_preempts += 1
        req._prefill_s_acc += s.prefill_s
        req._decode_s_acc += max(now - s.t_admit - s.prefill_s, 0.0)
        if self._alloc is not None:
            self._alloc.preemptions += 1
        self.free(slot_id)
        pos = next((j for j, r in enumerate(self.queue)
                    if getattr(r, "_seq", 0) > req._seq), len(self.queue))
        self.queue.insert(pos, req)
        return req

    def _preempt(self, slot_id: int) -> None:
        """Evict a running slot for recompute: re-admission re-prefills it
        and replays its tokens."""
        req = self._evict(slot_id)
        self._events.append(events_lib.PreemptedEvent(
            req.id, self._step_no, n_generated=len(req._resume_tokens)))

    def _swap_out(self, slot_id: int) -> bool:
        """Evict a running slot to the host swap tier: mirror its exact device
        state into a host entry, return its pages, requeue it at its arrival
        position.  Re-admission takes `_swap_in`: an upload and a page
        re-grant, no prefill, no recompute.  False, after a counted refusal,
        when the slot shares prefix pages or the host pool is full: the
        caller then preempts by recompute."""
        s = self.slots[slot_id]
        if s is None:
            return False
        if self._alloc.needs_privatize(slot_id):
            self._swap.note_refusal("aliased")
            return False
        handle = self._swap.reserve()    # a full pool counts its own refusal
        if handle is None:
            return False
        # taken before the eviction: the allocator clears the occupancy and
        # the rung dies with the slot
        s.request._swap_state = _SwapState(handle=handle, occ=self._alloc.occ[slot_id],
                                           steps=s.steps, since_rc=s.since_rc,
                                           rung=int(self._rungs[slot_id]))
        self._swap.store(handle, self._swap_extract(self.caches, slot_id))
        req = self._evict(slot_id)
        self._events.append(events_lib.SwappedEvent(
            req.id, self._step_no, direction="out", n_generated=len(req._resume_tokens),
            host_bytes=self._swap.stats()["host_bytes"]))
        return True

    def _swap_in(self, slot_id: int, req: Request, t0: float) -> None:
        """Re-admit a swapped-out request without recompute: re-grant its
        pages from the occupancy it left with (its worst-case reservation
        covered it while it ran), upload its host entry, scatter it through
        the new tables (into the decode step's static tree) and reinstate
        every per-slot counter.  Its next decode step reads exactly the bytes
        and counters it would have had without the eviction."""
        st: _SwapState = req._swap_state
        resume = req._resume_tokens
        bucket = self._bucket_len(int(req.tokens.shape[-1]))
        self._alloc.admit(slot_id, st.occ, self._request_total_tokens(req), bucket)
        self._sync_tables()
        payload = self._swap.load(st.handle, self.device)
        self._set_caches(self._swap_restore(self.caches, payload, slot_id))
        self._swap.release(st.handle)
        req._preempt_s += t0 - req._t_preempt
        t1 = time.perf_counter()
        self.slots[slot_id] = _Slot(request=req, generated=list(resume), steps=st.steps,
                                    since_rc=st.since_rc,
                                    t_submit=getattr(req, "_t_submit", t0), t_admit=t0,
                                    prefill_s=t1 - t0)   # two transfers, no prefill
        self._rungs[slot_id] = st.rung   # later folds stay at the ladder rung
        del req._swap_state
        del req._resume_tokens
        self._events.append(events_lib.SwappedEvent(
            req.id, self._step_no, direction="in", n_generated=len(resume),
            host_bytes=self._swap.stats()["host_bytes"]))
        self._maybe_finish(slot_id)

    def _downshift(self, slot_id: int) -> bool:
        """One ladder downshift of a running slot: raise its rung and fold its
        window early at the lowered lo-store width, returning the window's
        pages.  The slot keeps decoding.  False when it is ineligible (empty,
        at the deepest rung, or an empty window: no pages to free), and after
        a counted refusal when it shares prefix pages."""
        s = self.slots[slot_id]
        if s is None or int(self._rungs[slot_id]) >= self._max_rung or s.since_rc == 0:
            return False
        if self._alloc.needs_privatize(slot_id):
            self._alloc.note_downshift_refusal()
            return False
        self._rungs[slot_id] += 1
        freed = self._fold([slot_id])
        s.since_rc = 0
        self._alloc.note_downshift(slot_id, freed)
        self._events.append(events_lib.DownshiftEvent(
            s.request.id, self._step_no, rung=int(self._rungs[slot_id]), pages_freed=freed))
        return True

    def _ladder_step(self) -> None:
        """The pressure trigger (`ladder_watermark`): while the smallest free
        fraction of the pools is at or below the watermark, downshift the
        oldest eligible slot (by arrival), at most one per step."""
        if not self._ladder or self.scfg.ladder_watermark <= 0 or self._alloc is None:
            return
        if self._alloc.pool_pressure() > self.scfg.ladder_watermark:
            return
        order = sorted((i for i in range(self.scfg.batch_size) if self.slots[i] is not None),
                       key=lambda i: self.slots[i].request._seq)
        for i in order:
            if self._downshift(i):
                return

    def _pack_moves(self, moves: Dict[str, Tuple[List[int], List[int]]]
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """The copy step's operands: per segment, (src, dst) id vectors padded
        with the segment's sink id (sink -> sink copies), all in one upload
        of a fresh host array."""
        segs = alloc_lib.FreeListAllocator.SEGMENTS
        width = max(max(self._alloc.segs[n].npp for n in segs), 1)
        ids = np.empty((2 * len(segs), width), np.int64)
        for k, name in enumerate(segs):
            src, dst = moves.get(name, ((), ()))
            ids[2 * k:2 * k + 2] = self._alloc.segs[name].null
            ids[2 * k, :len(src)] = src
            ids[2 * k + 1, :len(dst)] = dst
        dev = torch.from_numpy(ids).to(self.device)
        return {name: (dev[2 * k], dev[2 * k + 1]) for k, name in enumerate(segs)}

    def _fold(self, due_ids: Sequence[int]) -> int:
        """Fold the due slots' staging windows, with the allocator's grant
        before and shrink after.  Returns how many window pages came back
        (what a downshift frees).  With the ladder armed every fold takes
        the slots' rungs (rung 0 is the base map's bits)."""
        b = self.scfg.batch_size
        self._n_folds += len(due_ids)
        if self._alloc is not None:
            # copy-on-write before the fold: a fold re-splits hi/lo per slot,
            # so a slot that still aliases shared pages gets its own first.
            # The copies are queued before the table write and the fold on
            # the same stream, so the fold reads the filled pages.
            for i in due_ids:
                if self._alloc.needs_privatize(int(i)):
                    moves = self._alloc.privatize(int(i))
                    if moves:
                        self._set_caches(self._copy_pages(self.caches, self._pack_moves(moves)))
            for i in due_ids:
                self._alloc.fold_grant(int(i))
            self._sync_tables()
        # per-slot folds while they save work over one full-batch fold
        if self._recompress_slot is not None and len(due_ids) * 2 <= b:
            for i in due_ids:
                if self._ladder:
                    rung = torch.tensor(int(self._rungs[i]), dtype=torch.int32,
                                        device=self.device)
                    new = self._recompress_slot_rung(self.caches, int(i), rung)
                else:
                    new = self._recompress_slot(self.caches, int(i))
                self._set_caches(new)
        else:
            due = np.zeros(b, bool)
            due[np.asarray(due_ids, int)] = True
            rows = torch.from_numpy(due).to(self.device)
            if self._ladder:
                # a copy: the host array changes between steps
                rungs = torch.from_numpy(self._rungs.copy()).to(self.device)
                new = self._recompress_rows_rung(self.caches, rows, rungs)
            else:
                new = self._recompress_rows(self.caches, rows)
            self._set_caches(new)
        freed = 0
        if self._alloc is not None:
            for i in due_ids:
                freed += self._alloc.fold_shrink(int(i))
            self._sync_tables()
        return freed

    @torch.inference_mode()
    def step(self) -> List[events_lib.Event]:
        """One scheduler iteration: admission (and preemptions), one token for
        every active slot, retirements, and the folds due on each slot's own
        cadence.  Returns the events of this iteration (and any buffered
        between steps), in order."""
        self._sweep_deadlines()
        self._ladder_step()   # relieve pool pressure before planning admissions
        self._admit()
        b = self.scfg.batch_size
        active_ids = [i for i in range(b) if self.slots[i] is not None]
        if not active_ids:
            events, self._events = self._events, []
            return events
        interval = self.ccfg.recompress_interval
        if self._alloc is not None:
            for i in active_ids:
                self._alloc.note_append(i)
            self._sync_tables()
        rows = {}
        for i in active_ids:
            s = self.slots[i]
            rows[i] = (s.generated[-1], probe_flag(s.steps, interval, self.scfg.seed),
                       s.request.sampling.temperature, s.request.sampling.seed,
                       len(s.generated))
        logits = self._decode_rows(rows)
        # one copy to the host; an all-greedy step launches no sampler op
        sampled = any(r[2] > 0 for r in rows.values())
        nxt = (self._decode_masked.sample(logits) if sampled
               else torch.argmax(logits, dim=-1)).cpu().numpy()

        due = []
        for i in active_ids:
            s = self.slots[i]
            s.steps += 1
            s.since_rc += 1
            s.generated.append(int(nxt[i]))
            self._emit_token(s.request, int(nxt[i]), len(s.generated) - 1)
            if self._maybe_finish(i):
                continue
            if s.since_rc >= interval:
                due.append(i)
        if due:
            self._fold(due)
            for i in due:
                self.slots[i].since_rc = 0
        self._step_no += 1
        events, self._events = self._events, []
        return events


class ContinuousEngine(EngineCore):
    """`EngineCore` with the scheduler built from `ServeConfig.scheduler`
    ("fifo" or "priority"); pass `scheduler=` to inject one directly."""

    def __init__(self, cfg: ArchConfig, ccfg: CompressionConfig, scfg: ServeConfig, params,
                 device="cuda", use_kernels: bool = True,
                 scheduler: Optional[scheduler_lib.Scheduler] = None, capture: bool = True):
        super().__init__(cfg, ccfg, scfg, params,
                         scheduler or scheduler_lib.make_scheduler(scfg.scheduler),
                         device=device, use_kernels=use_kernels, capture=capture)
