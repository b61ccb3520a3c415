#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ZipCache on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught and
continued:
  1. the device: nvidia-smi's name and power limit, torch's device name;
  2. the build: every CUDA source of the port, one nvcc each, in parallel,
     with nvcc's -Xptxas -v register / shared-memory / spill report;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (yi-6b, batch 4, 1024-token prompts):
     max error against a stated tolerance, time from CUDA events, the least
     time the card could take (bound), the plain version's time, and, where
     one PyTorch call computes the same function, that call's time;
     cst_quant takes the hi and lo stores of the lockstep prefill (K and V
     in one launch, bitwise against the plain version) and the lo store at
     batch 1, each also through its effective-bit (`eff`) instantiation with
     a mixed table of per-slice effective bits, bitwise against the plain
     version and timed beside the static launch; flash_fwd and probe_colsum are timed at batch 1 too (the continuous
     admission shape), flash_fwd with SDPA beside it; probe_colsum is held
     bitwise equal across two calls, and the salient set that
     `saliency.salient_split` draws from its normalized sums against the
     plain version's; decode_qattn takes each packed store alone
     (`qattn_segment`) and one decode layer's three segments (4-bit hi,
     2-bit lo, raw bf16 window) in one launch (`qattn_mixed_layer`), the
     timed call; paged_qattn takes one decode layer's three
     segments (4-bit hi, 2-bit lo, raw bf16 window) in one launch over a
     free-list paged cache at the continuous path's shapes (shuffled
     physical page ids, NULL entries, an empty slot), with and without the
     slot-weight outputs, and each segment alone through the same kernel;
     then the rows at DeepSeek-V2-Lite's MLA shapes (`<kernel>@mla`):
     flash_fwd at q/k head dim 192 and v 128, 16 heads, batch 4 and 1, with
     SDPA beside it (its backend logged); probe_colsum at d 192, two calls
     bitwise and the salient set the plain version's; cst_quant's hi and lo
     stores of one MLA layer's lockstep prefill (one kv head: the 64-wide
     rope key, the 512-wide latent), static and eff, bitwise; then the rows
     at jamba-v0.1-52b's attention layer (`<kernel>@jamba`: 32 query heads
     over 8 kv heads, g = 4, d 128, batch 4, prompt 1024): cst_quant's hi
     and lo stores bitwise; flash_fwd (out within 2**-7 of its largest
     value, LSE within 1e-5) with SDPA beside it; probe_colsum, two calls
     bitwise and the salient set the plain version's; decode_qattn's layer
     (the walk's G = 4 instantiation) and paged_qattn's layer over a
     free-list cache, within one bf16 ulp; then the rows at
     seamless-m4t-medium's decoder layer (`<kernel>@seamless`: 16 query
     heads over 16 kv heads, g = 1, d 64, batch 4, a 128-token decoder
     prompt over 1024 source frames): cst_quant's self stores (bf16) and
     cross stores (f32 K / V over 1024 tokens, f32 parameters) bitwise;
     flash_fwd (2**-7, LSE 1e-5) with SDPA beside it; probe_colsum (1e-4,
     two calls bitwise, the salient set); decode_qattn's layer (the walk's
     G = 1, D = 64 instantiation) over the cross cache and over a self
     cache, within one bf16 ulp; then the five kernels at qwen2-7b's
     attention layer (`<kernel>@qwen2`: 28 query heads over 4 kv heads, g =
     7, d 128), smollm-360m's (`<kernel>@smollm`: 15 over 5, g = 3, d 64),
     yi-34b's (`<kernel>@yi34b`: 56 over 8, probe_colsum at 7 heads per
     CTA, as llava-next-34b's prefill in phase 4m) and deepseek-moe-16b's
     (`<kernel>@dsmoe`: 16 over 16, g = 1, d 128), batch 4, prompt 1024,
     at the Jamba rows' tolerances (the walk's G = 7, G = 3 and G = 1 at
     D = 128 instantiations); each with its launch sizing.  For phase 4p,
     each of those rows' cst_quant stores again through the eff
     instantiation under a downshift rung (bitwise), Jamba's (zipcache-
     paper-8b's attention shape), qwen2's and smollm's paged_qattn layer
     over fp16's raw pages (one bf16 ulp), and phase 4i's kernels at the
     baselines' shapes at qwen2's and zipcache-paper-8b's attention layer
     (probe_colsum with every row a probe, decode_qattn over fp16's raw
     store before and after a fold);
  4. slice 1's main path: `ServingEngine.generate` on yi-6b at full width
     (32 layers, random bf16 weights from a seeded generator), zipcache
     defaults, batch 4, prompt 1024, 128 new tokens: prefill, probe steps,
     decode and one recompression.  Every kernel of the path must launch;
     the decode steps without a probe replay a captured CUDA graph, whose
     launches count as the capture's times the replays.  The prefill
     logits and the first decode step's logits are held against the same
     model run through the plain versions;
  4b. slice 2's main path: `ContinuousEngine` over the paged layout with the
     free-list allocator (4 slots, page 64, pool_fraction 0.75, the page
     walk on), same model, 8 greedy requests with ragged prompts (200-1024
     tokens) and budgets (48-128), so slots retire, re-admit and fold on
     their own cadence.  Every request must end with its budget, the
     allocator's invariants must hold and every page come back, every
     kernel of the path must launch and no decode may take the gather path.
     One admitted slot's first decode-step logits are held against the same
     engine built with the plain versions;
  4c / 4d. the captured decode steps (both engines replay a CUDA graph of
     their non-probe step in phases 4 and 4b): phase 4's and phase 4b's
     traffic through a fresh eager engine (capture=False) and a fresh
     captured one, in turn.  For each: decode wall time, the median wall
     time of a non-probe and of a probe step (lockstep: the step alone to a
     synchronize; continuous: an engine step that admits, folds and retires
     nothing), busy share and device operations per step in a profiled
     window of 16 steps, peak device memory, the launch counts (captured:
     the capture's times the replays) against the path's expected counts.
     The captured step must be built once and replayed.  Every decode step
     of the timed run (lockstep: 128; continuous: the first pass, through
     its admissions, deferrals, folds and retirements) is held against the
     eager engine's step of the same index: the active rows' logits within
     one bf16 ulp of their largest value (the count of bitwise-equal steps
     is logged), and every greedy token equal;
  4e. slice 7's levers: the continuous engine under the conformance
     precision map ("default=k8v8;layer:1-=k3v3", every store through
     cst_quant's eff instantiation), paged free-list, the page walk, the
     priority scheduler, 2 slots and prompts of 1024: a swap-pressure run
     (two long requests, then an urgent short one that forces a victim; at
     least one swap-out and swap-in, tokens equal to the same traffic under
     preemption by recompute, host bytes back to 0) and a ladder-pressure
     run (an exactly sized pool under a watermark of 0.6; at least one
     downshift that frees pages).  Each run's launches are counted from 0
     and held against its path; entry bytes and the swap-out / swap-in and
     downshift (fold at a rung) times are logged;
  4f. slice 8's shared-prefix dedup: the continuous engine (4 slots, prompt
     window 1024, budget 128, paged free list at 1.5 x the worst case, page
     64, the page walk, FIFO, captured) serves eight greedy requests on four
     prompts, four of them repeats, once with `prefix_cache` off and once
     with it on, then on again eagerly.  Tokens and finish reasons equal
     between off and on; at least one hit and one copy-on-write copy; the
     prefill tokens skipped equal the hits' buckets; the allocator's
     invariants after every step; every page back after the index is
     reclaimed; flash_fwd and probe_colsum launched 32 x hits fewer times;
     the captured step built once, and its first replays after an alias
     admission and after a CoW copy bitwise the eager step's.  Hit and miss
     admission times, CoW copy times, peak pages and snapshot bytes are
     logged;
  4g. slice 9's seeded sampling: phase 4d's configuration and traffic with
     the 2nd, 4th, 6th and 8th requests sampled (T 0.7, 1.0, 0.7, 1.0; seeds
     11-14), captured (run 1), eager (run 2) and captured in reverse
     submission order (run 3).  Every request's tokens equal between runs 1
     and 2; greedy requests equal phase 4d's captured run; sampled requests
     equal between runs 1 and 3 and differ from their greedy tokens; run 1
     builds at most two graphs (the decode step and its sampler).  Phase
     4d's all-greedy traffic must have run no sampler.  The device threefry
     bits equal the numpy ones for 16 (seed, counter) pairs, and
     `sample_tokens` on 16 logit rows on the card equals the host's (a
     difference only at a top-two margin within 1e-5).  Logged: step walls
     with and without sampled rows, the sampler's device ms, each run's
     decode wall, `cache_bytes` of phase 4's lockstep cache and of the
     engines;
  4h. slice 10's serving edge: `python -m repro_torch.launch.serve_http`
     as a child process at full width, driven over loopback sockets.  Run
     (i): two replicas on phase 4b's paged configuration take phase 4g's
     eight requests concurrently (the sampled ones with their temperature
     and seed in the body); every stream's tokens equal its done event's
     and phase 4g's run 1; both replicas take requests; a stream that hangs
     up after 8 events has its replica's free pages back at the first
     `/v1/stats` answer (a witness stream on the other replica counts the
     router steps meanwhile).  Run (ii): one replica on the CLI's default
     mixed layout, two 16-token requests one after the other, equal to an
     in-process engine built from the same flags on this script's
     parameters.  Each server exits 0 on SIGINT and prints its launches:
     every kernel of its layout, at the counts its admissions and folds
     imply; neither builds a kernel library.  Logged: each request's client
     time to its first SSE event and to its done event, run (i)'s wall
     against phase 4g's run 1;
  4i. slice 11's baseline policies and levers.  The kernels at the
     baselines' shapes: probe_colsum with every row a probe (h2o, mikv: np
     1024) at batch 4 and 1 against its plain version, two calls bitwise,
     the salient sets of the normalized (prefill) and accumulated (fold)
     scores as the plain version's; decode_qattn over fp16's raw 1152-slot
     store and window, bf16 and, after a fold, f32 (the fold promotes it),
     within one bf16 ulp, with the walk's split count.  The levers on one
     full-width layer, each timed beside its counterpart:
     `attend_decode(impl="int8_algebra")` against the exact route (out atol
     2e-2 rtol 1e-2, slot weights 1e-3), `blocked_attention(compact=True)`
     against f32 at batch 1 (out 2e-2).  Lockstep: `ServingEngine.generate`
     under fp16, h2o, mikv, gear and kivi at their preset defaults (phase
     4's batch, prompt and 128 new tokens: 16 probe steps, one fold) over
     the first 4 of yi-6b's 32 layers at full width (cut from 32, as the
     continuous runs below, to 8 and then to 4, to make room for phases 4l
     and 4o within the time limit),
     captured and eager: every step's logits within one bf16 ulp of the
     eager step's, tokens equal; the prefill and first decode step's logits
     against the plain versions' within phase 4's bound; launches held to
     each route (decode_qattn on fp16's and h2o's non-probe steps, the plain
     route on every step of mikv, gear and kivi, counted in
     `backend.PLAIN_DECODES`; probe_colsum 32 for h2o and mikv; no
     cst_quant); the step built again after the fold where it promotes the
     stores.  Logged: walls, step times, cache_bytes against the
     Appendix-A ratio, the cosine of the first and the last decode step's
     logits to fp16's.
     Continuous: phase 4b's configuration and traffic under fp16 (raw pages
     through paged_qattn, no gather) and kivi (every decode layer on the
     gather path, counted): every request ends with its budget, the
     allocator's invariants after every step, every page back;
  4j. slice 12: DeepSeek-V2-Lite at full width over 5 of its 27 layers
     (9 before phase 4o; the MLA prefix layer with a dense FFN, then 4 layers of MLA and 64
     routed + 2 shared experts, top 6; latent 512, q/k head dim 192, v 128;
     cut from 27 to keep the run within its time limit), random bf16
     weights from a seeded generator, after phase 4i's yi-6b model is freed.
     Lockstep: phase 4's batch and prompts, 128 new tokens, zipcache
     defaults (probe steps, one fold), captured and eager: every step's
     logits within one bf16 ulp of the eager step's, tokens equal; the
     prefill and first decode step's logits against the plain versions'
     within phase 4's bound.  Continuous: phase 4b's configuration and
     traffic, captured and eager: every request ends with its budget, the
     allocator's invariants hold and every page comes back, the first pass's
     steps held as the lockstep's.  Launches held to the path: flash_fwd and
     probe_colsum once per layer per prefill or admission, cst_quant twice
     per layer per prefill, admission and fold, no decode_qattn or
     paged_qattn (MLA decodes through the plain route over the cache's dense
     view).  Logged: parameter bytes and peak memory, prefill and decode
     walls, median non-probe and probe step times, packed cache bytes
     against the bf16 latent and rope-key streams, the expert-weight bytes
     a decode step reads;
  4k. slice 13: the SSM models, after phase 4j's model is freed.
     mamba2-2.7b at full width over 8 of its 64 Mamba2 SSD layers (16 before phase 4o; cut
     from 64 to keep the run within its time limit; no attention layer,
     so no kernel and no KV cache): lockstep on phase 4's batch and 128 new
     tokens, captured against eager bit for bit; phase 4b's traffic on the
     continuous engine over the mixed and the paged static layout (its
     page-aligned buckets give ragged last chunks), tokens equal across
     the two, the paged run captured against eager bit for bit; the free
     list refused with the ValueError that names the cause.
     jamba-v0.1-52b at full width over one 8-layer group (n_layers 32 -> 8:
     the full depth's 102.9 GB of bf16 weights do not fit one card; layer
     4 GQA, the rest SSD, odd layers MoE): lockstep as mamba2's, layer 4's
     attention output on the kernel route within 2**-7 of its largest value
     of the plain route's (layers 0-3 run no kernel); phase 4b's
     configuration and traffic, captured against eager bit for bit, every
     page back.  Launches held to each path (Jamba: one attention layer's
     flash_fwd, probe_colsum and cst_quant per prefill or admission and
     fold, decode_qattn or paged_qattn per step; mamba2: none).  Logged:
     parameter bytes, peak memory, `cache_bytes` split into packed KV and
     SSM-state overhead, non-probe and probe step walls, the phase's
     seconds;
  4l. slice 14: seamless-m4t-medium at full size (12 encoder and 12
     decoder layers, d_model 1024, 16 / 16 heads, vocab 256206; 978,909,184
     parameters, 1.96 GB), random bf16 weights from a seeded generator,
     after phase 4k's models are freed, on the lockstep engine (the
     continuous engine refuses the encoder-decoder): batch 4, 1024 source
     frames of f32 embeddings, a 128-token decoder prompt, 128 new tokens
     at zipcache defaults (16 probe steps, one fold at step 100), captured
     against eager bit for bit.  Launches held to the path: flash_fwd and
     probe_colsum 12 per prefill, cst_quant 48 per prefill (every self and
     cross store) and 24 per fold (the self stores), decode_qattn 24 per
     non-probe step (both caches of every layer), the plain route on probe
     steps only.  The encoder memory bitwise between the kernel and the
     plain route; every cross cache of the kernel route's prefill bitwise
     the plain route's store of the same K / V and saliency; the prefill
     and first decode step's logits against the plain route's within
     phase 4's bound.  Logged: parameter bytes, peak memory, the encoder's
     and the decoder's prefill walls, non-probe and probe step walls,
     `cache_bytes` split into self and cross, the phase's seconds;
  4m. slice 15: the remaining configs at full width over their first 8
     layers (cut from full depth to make room for phase 4o), after
     every earlier phase's weights and graph pools are released: qwen2-7b
     (g = 7, QKV biases drawn at random), smollm-360m (g = 3, d 64, tied
     embeddings) and deepseek-moe-16b (g = 1, a dense prefix layer, 64
     routed + 2 shared experts) on both engines, zipcache-paper-8b
     (LLaMA3-8B's shape) on the lockstep engine, llava-next-34b (576 patch
     embeddings before 448 text tokens) on the lockstep engine and yi-34b
     on the continuous one over the same tensors, the pair at full width
     over 10 of its 60 layers (cut from 60 to 20, then 10, to make room for
     phases 4n and 4o);
     zipcache with the window and the fold cadence at 16 over 32 new
     tokens (phase 4's
     batch; five requests for four slots).  Each engine captured against
     eager bit for bit; launches held to the path, the plain route on
     lockstep probe steps only, no gather-path decode, probe_colsum at the
     heads per CTA of the model's phase-3 row; the kernel route's prefill
     and first step against the plain route's within phase 4's bound of
     0.2 (deepseek-moe: layer 0's attention output and the prefix layer's
     output, before any router, within 2**-7 of their largest value).
     Logged: parameters, peak memory, step walls, each model's seconds;
  4n. slice 16: single-card training of the dense decoder, after every
     earlier phase's weights are released.  (i) `launch.train.main` (the
     CLI's entry point) on smollm-360m at full size: random bf16 weights
     from a seed, AdamW at its defaults under a cosine schedule (warmup 2,
     4 steps; 8 before phase 4o), the synthetic pipeline at 8 x 2048 tokens,
     grad_accum 4 (`pick_grad_accum`), q_block 512, through
     `FaultTolerantLoop` with a checkpoint at step 4: every loss finite,
     step 4's below step 1's, the checkpoint restored into a fresh device
     tree bitwise.  (ii) At full
     width over the first 4 layers: 8 steps with checkpoints every 4, a
     failure injected at step 6, a restart from step 4: every parameter
     and optimizer leaf at step 8 bitwise the uninterrupted run's.  (iii)
     At full width over the first 2 layers, one 2048-token microbatch: the
     card's loss against the port's CPU run (1e-3) at the reference's init;
     at a fan-in init of the same draws, also the gradient norm (1e-2) and
     each gradient leaf (2e-2 relative L2): the reference's init (a stacked
     weight at std 1 / sqrt(layer count)) leaves bf16 gradients that are
     rounding noise, over 30% from a float64 run of the same weights.  The training path runs no
     kernel (nor does the reference's): every count stays 0.  Logged: step
     walls, tokens/s, model FLOP/s against the bf16 dense peak, peak memory,
     checkpoint bytes, write and restore seconds, (iii)'s readings;
  4o. slice 17: training of every other family on one card, after every
     earlier phase's weights are released.  (i) `launch.train.main` on
     DeepSeek-V2-Lite (MLA + MoE + the aux loss; its dense layer and 3 MoE
     layers at full width), mamba2-2.7b (64 SSD layers), seamless-m4t-medium
     (12 + 12 layers, f32 source frames) and llava-next-34b (2 of 60 layers
     at full width, 576 patch embeddings before 448 text tokens): 4 steps
     of 4 x 1024 positions, warmup 1, `pick_grad_accum`, q_block 512, the
     step donating its state, one checkpoint at step 4 restored into a
     fresh host tree: losses finite and falling, DeepSeek's aux finite and
     positive, every restored leaf bitwise.  (ii) DeepSeek-V2-Lite over its
     dense layer and one MoE layer: a failure at step 3, checkpoints every
     2, resumed at 2 by a second `train.main`: every leaf at step 4 and the
     resumed metrics bitwise the uninterrupted run's.  (iii) One 512-token
     microbatch over one layer of each kind (DeepSeek's dense and one MoE
     layer, mamba2's 2, seamless 1 + 1) at a fan-in init: the card's loss,
     gradient norm and every leaf against the CPU's at (4n)'s tolerances,
     the CPU routed to the card's experts, the share routed alike logged.
     No kernel runs: every count stays 0.  Logged: step walls, tokens/s,
     model FLOP/s, peak memory, checkpoint bytes, write and restore seconds.
     Since phase 4p, (i)'s checkpoint round trip is seamless-m4t-medium's
     alone (the checkpointer does not depend on the tree; the other three
     families' writes and restores took ~80 s of a fast host's run);
  4p. slice 18: the serving levers and the baselines on every tree beyond
     yi-6b, each run while its model is resident in an earlier phase
     (`tree_levers`, through phases 4e-4i's helpers with the model and the
     traffic as parameters; window and folds at 16 as phase 4m's): after
     4j's runs, DeepSeek-V2-Lite (5 layers) under the precision map on the
     lockstep engine, the swap-pressure and ladder-pressure runs under the
     map, shared-prefix dedup and seeded sampling on the continuous one;
     after 4k's, mamba2 (8 layers) under the map on the lockstep engine and
     the mixed and paged static continuous layouts (tokens, cache_bytes
     and every step's logits equal the runs without the map: it has no KV
     element) and Jamba's group under swap, the ladder and the map, and
     prefix dedup; after 4m's (8 layers each), qwen2-7b (G = 7) and
     smollm-360m (G = 3) under swap, the ladder, prefix dedup, sampling and
     the continuous baselines (fp16 through raw pages, kivi on the gather
     path), qwen2-7b and zipcache-paper-8b under the lockstep baselines
     (fp16, h2o, mikv, gear, kivi; the kernels at their shapes are phase
     3's rows), zipcache-paper-8b under the
     continuous baselines and swap and the ladder, deepseek-moe-16b under
     swap and the ladder.  The swap and ladder runs and the lockstep map
     run go captured and eager, dedup off eagerly and on captured, and
     every captured step is bitwise the eager step of the same index, the
     first replays after each swap-in, downshift fold, alias admission and
     copy-on-write copy among them; sampled requests equal between captured
     runs in forward and reverse submission order (on DeepSeek, whose
     routed experts' capacity drops other rows' pairs when the requests
     change rows, captured against eager in one order); launches held to
     each path from 0, every cst_quant launch of a mapped or downshifted
     run with the eff table; the allocator's invariants after every step,
     every page and the host pool's bytes back.  Each model's part logs its
     seconds as `phase 4p/<model>`, their sum at the end;
  4q. slice 19: training on a 1 x 1 mesh over NCCL, bitwise the plain step
     (`mesh_training`);
  4r. slice 20: serving on a 1 x 1 ("data", "model") mesh over NCCL
     (`serving_mesh`): yi-6b over phase 4i's 4 layers at full width on
     both engines (mixed layout), tokens, cache leaves and every step's
     logits bitwise the no-mesh runs' and the mesh's eager runs'; then each
     kernel's share of a split on the one card: decode_qattn on each half
     of the kv heads bitwise the whole launch, on each half of the slots
     with its (acc, m, l) output merged in rank order within phase 3's
     bound (the output's row `decode_qattn.stats`), flash_fwd and
     probe_colsum on each half of the heads;
  4s. slice 21: pipeline parallelism on one-stage meshes over NCCL
     (`pipeline_training`): smollm-360m at full size on ("stage",),
     `pp_forward` against `lm.forward` and 2 pipelined steps against 2
     plain steps; yi-6b over 4i's 4 layers on a 1 x 1 x 1 ("stage",
     "data", "model") mesh, one step each; step seconds and peak memory
     logged.  No kernel launches;
  5. a `kernels` JSON line, then the last line:
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

It needs the repository's `src/repro_torch` beside it and one CUDA card.
"""

from __future__ import annotations

import argparse
import ast
import asyncio
import contextlib
import gc
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it) from operations and bytes moved."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean time of `fn` on the card from CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_MS_READINGS = []   # every device_ms reading: (label, attempts, events, launches, ms, event ms)


def _launches() -> int:
    """The kernel wrappers' launches so far (`kernels.build.COUNTERS`' kernels)."""
    from repro_torch.kernels import build
    return sum(c.launches for c in build.COUNTERS if isinstance(c, build.CudaKernel))


def device_ms(torch, fn, iters: int = 20, label: str = "") -> float:
    """Device time of the kernels `fn` launches, per call, from torch.profiler.
    CUDA events around back-to-back calls also count the gaps in which the
    card waits for the host to enqueue the next call; this does not.

    The profiler takes a warm-up window of `iters` calls before the
    recorded one (`torch.profiler.schedule`).  A reading must pass two
    checks, or it is taken again, up to 3 times, each after a longer pause
    (the profiler loses kernels in bursts of consecutive sessions, PERF.md
    §7), then the phase fails: the profiler recorded at least as many
    device kernels as the calls launched (the wrappers' counts over the
    same calls, or one a call for an op that counts none), and the device
    time is no more than the CUDA-event time of the same calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    label = label or f"at chip_smoke.py:{sys._getframe(1).f_lineno}"
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    why = ""
    for attempt in range(4):
        if attempt:
            time.sleep(0.5 * attempt)   # out of the burst that lost the last reading
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traces.append(p.events())) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
            before = _launches()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            launched = _launches() - before
            prof.step()
        # the device ops of the recorded window (not its ProfilerStep range)
        ops = [e for e in (traces[-1] if traces else []) if e.device_type.name == "CUDA"
               and not e.name.startswith("ProfilerStep")]
        kernels = [e for e in ops
                   if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
        ms = sum(e.device_time for e in ops) / 1e3 / iters
        event_ms = start.elapsed_time(end) / iters
        need = launched if launched else iters
        if len(kernels) >= need and ms <= event_ms:
            DEVICE_MS_READINGS.append((label, attempt + 1, len(kernels), launched, ms, event_ms))
            return ms
        names = {}
        for e in kernels:
            names[e.name[:40]] = names.get(e.name[:40], 0) + 1
        why = (f"{len(kernels)} device kernels for {need} launches, {ms:.5f} device ms against "
               f"{event_ms:.5f} event ms; recorded {names}")
        log(f"device_ms {label}: attempt {attempt + 1} of 4 rejected ({why})")
    fail(f"device_ms {label}: no reading passed its checks in 4 attempts ({why})")


def main() -> None:
    laps = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Log the seconds since the last lap (the run's phase budget)."""
        laps.append(time.perf_counter())
        log(f"phase {phase}: {laps[-1] - laps[-2]:.1f} s (run so far {laps[-1] - laps[0]:.1f} s)")

    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "build.py").is_file():
        fail(f"the port's sources (src/repro_torch) are not beside {Path(__file__).name}")
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")

    # ---- 1. the device ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import configs
    from repro_torch.core import alloc as alloc_lib
    from repro_torch.core import backend as backend_lib
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import paged
    from repro_torch.core import prng
    from repro_torch.core import saliency as sal
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.cst_quant import kernel as cst_kernel
    from repro_torch.kernels.cst_quant import ref as cst_ref
    from repro_torch.kernels.decode_qattn import kernel as dq_kernel
    from repro_torch.kernels.decode_qattn import ops as dq_ops
    from repro_torch.kernels.decode_qattn import ref as dq_ref
    from repro_torch.kernels.paged_qattn import kernel as pq_kernel
    from repro_torch.kernels.paged_qattn import ops as pq_ops
    from repro_torch.kernels.paged_qattn import ref as pq_ref
    from repro_torch.kernels.probe_flash import kernel as pf_kernel
    from repro_torch.kernels.probe_flash import ops as pf_ops
    from repro_torch.kernels.probe_flash import ref as pf_ref
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import attention, registry
    from repro_torch.serving import (ContinuousEngine, Request, ServeConfig, ServingEngine,
                                     pack_requests, probe_flag)

    # ---- 2. the build ----------------------------------------------------
    t0 = time.perf_counter()
    times = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{n} {t:.1f} s' for n, t in times.items()) or 'cached'})")
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    lap("1-2 (device, build)")
    # ---- 3. each kernel against its plain version --------------------------
    cfg = configs.get_arch("yi-6b")
    ccfg = CompressionConfig.zipcache()
    b, prompt, max_new = 4, 1024, 128
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    max_len = prompt + max_new
    s_hi, s_lo, _ = kvc.capacities(ccfg, max_len)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = {}

    def record(name, source, replaces, err, tol, fn, ms, plain, bnd, library=None):
        """`ms` from CUDA events per call; `device_ms` the kernels' own time."""
        check(err <= tol, f"{name}: max abs error {err:.3g} exceeds {tol:.3g}")
        dev_ms = device_ms(torch, fn)
        rows[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                      "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library}
        lib = f", library {library:.4f} ms" if library is not None else ""
        log(f"{name}: max abs err {err:.3g} (tol {tol:.3g}); kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms), plain {plain:.4f} ms{lib}, bound {bnd[0]:.4f} ms ({bnd[1]})")

    # cst_quant: one launch per store, K channelwise and V CST with the gather
    # fused, at the lockstep prefill's hi (4-bit) and lo (2-bit) stores: slot
    # indices from salient_split, -1 padding to capacity.  Codes and the
    # store-dtype parameters equal the plain version's bit for bit.
    kv_k, kv_v = randn(b, hk, prompt, d), randn(b, hk, prompt, d)
    sal_idx, reg_idx = sal.salient_split(torch.rand((b, prompt), generator=gen, device=dev),
                                         ccfg.n_salient(prompt))
    stores = {}
    for name, bits, cap, sidx in (("hi", ccfg.high_bits, s_hi, sal_idx),
                                  ("lo", ccfg.low_bits, s_lo, reg_idx)):
        sidx = torch.nn.functional.pad(sidx, (0, cap - sidx.shape[1]), value=-1)
        before = cst_kernel.KERNEL.launches
        got = cst_kernel.quantize_store(kv_k, kv_v, sidx, bits)
        want = cst_ref.quantize_store_ref(kv_k, kv_v, sidx, bits)
        torch.cuda.synchronize()
        check(cst_kernel.KERNEL.launches == before + 1, "cst_quant: one launch per store")
        for part, a, w in zip(("K codes", "K scale", "K zero", "V codes", "V scale", "V zero",
                               "V channel scale"), got, want):
            check(a.dtype == w.dtype and torch.equal(a, w),
                  f"cst_quant {name} store: {part} differ from the plain version")
        stores[name] = (bits, sidx, got)

    def store_bound(k_, v_, sidx, got, *inputs):
        """Bytes: each live slot's K and V rows read once, the slot indices
        (and any other input, an eff table) read, the codes and parameters
        written once."""
        n_live = int((sidx >= 0).sum())
        row = k_.shape[1] * (k_.shape[-1] + v_.shape[-1]) * k_.element_size()
        return bound_ms(0.0, n_live * row + nbytes(sidx, *got, *inputs))

    bits, sidx, got = stores["lo"]
    fn = lambda: cst_kernel.quantize_store(kv_k, kv_v, sidx, bits)  # noqa: E731
    ms = time_ms(torch, fn, iters=50)
    plain = time_ms(torch, lambda: cst_ref.quantize_store_ref(kv_k, kv_v, sidx, bits))
    record("cst_quant", "src/repro_torch/kernels/cst_quant/csrc/cst_quant.cu",
           "src/repro/kernels/cst_quant/kernel.py:66", 0.0, 0.0, fn, ms, plain,
           store_bound(kv_k, kv_v, sidx, got))
    hbits, hidx, hgot = stores["hi"]
    hfn = lambda: cst_kernel.quantize_store(kv_k, kv_v, hidx, hbits)  # noqa: E731
    extra = {"hi": {"ms": time_ms(torch, hfn, iters=50), "device_ms": device_ms(torch, hfn),
                    "bound_ms": store_bound(kv_k, kv_v, hidx, hgot)[0]}}
    # batch 1: one admission or slot fold of the continuous path
    k1, v1, idx1 = kv_k[:1].contiguous(), kv_v[:1].contiguous(), sidx[:1].contiguous()
    got1 = cst_kernel.quantize_store(k1, v1, idx1, bits)
    want1 = cst_ref.quantize_store_ref(k1, v1, idx1, bits)
    torch.cuda.synchronize()
    check(all(torch.equal(a, w) for a, w in zip(got1, want1)),
          "cst_quant batch 1: the lo store differs from the plain version")
    fn1 = lambda: cst_kernel.quantize_store(k1, v1, idx1, bits)  # noqa: E731
    extra["batch1"] = {"ms": time_ms(torch, fn1, iters=50), "device_ms": device_ms(torch, fn1),
                       "plain_ms": time_ms(torch, lambda: cst_ref.quantize_store_ref(
                           k1, v1, idx1, bits)),
                       "bound_ms": store_bound(k1, v1, idx1, got1)[0]}
    # the eff instantiation (precision maps, downshift rungs): a (b, hk, 2)
    # table of effective bits per slice and tensor, a third of it at the
    # container width; bitwise the plain version at the hi, lo and batch-1
    # lo stores, one launch each, and timed beside the static launch
    def eff_for(bits_, b_):
        e = torch.randint(1, bits_ + 1, (b_, hk, 2), generator=gen, device=dev).float()
        e.view(-1)[::3] = float(bits_)
        return e

    eff_cases = {name: (kv_k, kv_v, sidx_, bits_, eff_for(bits_, b))
                 for name, (bits_, sidx_, _) in stores.items()}
    eff_cases["batch1"] = (k1, v1, idx1, bits, eff_for(bits, 1))
    for name, (k_, v_, sidx_, bits_, e) in eff_cases.items():
        before = cst_kernel.KERNEL.launches
        got_e = cst_kernel.quantize_store(k_, v_, sidx_, bits_, eff=e)
        want_e = cst_ref.quantize_store_ref(k_, v_, sidx_, bits_, e)
        torch.cuda.synchronize()
        check(cst_kernel.KERNEL.launches == before + 1, "cst_quant eff: one launch per store")
        for part, a, w in zip(("K codes", "K scale", "K zero", "V codes", "V scale", "V zero",
                               "V channel scale"), got_e, want_e):
            check(a.dtype == w.dtype and torch.equal(a, w),
                  f"cst_quant eff {name} store: {part} differ from the plain version")
    k_, v_, sidx_, bits_, e = eff_cases["lo"]
    fn_s = lambda: cst_kernel.quantize_store(k_, v_, sidx_, bits_)  # noqa: E731
    fn_e = lambda: cst_kernel.quantize_store(k_, v_, sidx_, bits_, eff=e)  # noqa: E731
    got_e = fn_e()
    eb = store_bound(k_, v_, sidx_, got_e, e)
    extra["eff"] = {"max_abs_err": 0.0, "static_ms": time_ms(torch, fn_s, iters=50),
                    "ms": time_ms(torch, fn_e, iters=50),
                    "static_device_ms": device_ms(torch, fn_s), "device_ms": device_ms(torch, fn_e),
                    "plain_ms": time_ms(torch, lambda: cst_ref.quantize_store_ref(
                        k_, v_, sidx_, bits_, e)), "bound_ms": eb[0], "bound_by": eb[1]}
    k_, v_, sidx_, bits_, e = eff_cases["batch1"]
    fn_s1 = lambda: cst_kernel.quantize_store(k_, v_, sidx_, bits_)  # noqa: E731
    fn_e1 = lambda: cst_kernel.quantize_store(k_, v_, sidx_, bits_, eff=e)  # noqa: E731
    extra["eff"]["batch1"] = {"static_device_ms": device_ms(torch, fn_s1),
                              "device_ms": device_ms(torch, fn_e1)}
    fx = extra["eff"]
    log(f"cst_quant eff: bitwise at the hi, lo and batch-1 stores; lo store with eff "
        f"{fx['ms']:.4f} ms (device {fx['device_ms']:.4f} ms) against static "
        f"{fx['static_ms']:.4f} ms (device {fx['static_device_ms']:.4f} ms), plain "
        f"{fx['plain_ms']:.4f} ms, bound {fx['bound_ms']:.5f} ms; batch-1 lo device "
        f"{fx['batch1']['device_ms']:.4f} ms against static "
        f"{fx['batch1']['static_device_ms']:.4f} ms")
    del eff_cases, got_e, e, k_, v_, sidx_
    rows["cst_quant"].update(extra)
    log(f"cst_quant: timed at the lo store ({bits}-bit, {sidx.shape[1]} slots); hi store "
        f"({hbits}-bit, {hidx.shape[1]} slots) {extra['hi']['ms']:.4f} ms (device "
        f"{extra['hi']['device_ms']:.4f} ms, bound {extra['hi']['bound_ms']:.5f} ms); batch 1 "
        f"lo store {extra['batch1']['ms']:.4f} ms (device {extra['batch1']['device_ms']:.4f} "
        f"ms, plain {extra['batch1']['plain_ms']:.4f} ms, bound "
        f"{extra['batch1']['bound_ms']:.5f} ms)")
    del stores, got, hgot, k1, v1, idx1, got1, want1

    # flash_fwd: causal prefill attention, GQA 32/4, bf16
    q, k, v = randn(b, h, prompt, d), randn(b, hk, prompt, d), randn(b, hk, prompt, d)
    out, lse = pf_kernel.flash_fwd(q, k, v)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    err_out = (out.float() - ref_out.float()).abs().max().item()
    tol_out = 2 ** -7 * ref_out.float().abs().max().item()  # one bf16 ulp at the top
    err_lse = (lse - ref_lse).abs().max().item()
    check(err_lse <= 1e-4, f"flash_fwd: lse error {err_lse:.3g} exceeds 1e-4")
    fn = lambda: pf_kernel.flash_fwd(q, k, v)  # noqa: E731
    ms = time_ms(torch, fn)
    plain = time_ms(torch, lambda: pf_ref.flash_fwd_ref(q, k, v), iters=5)
    library = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = prompt * (prompt + 1) // 2
    record("flash_fwd", "src/repro_torch/kernels/probe_flash/csrc/probe_flash.cu",
           "src/repro/kernels/probe_flash/kernel.py:100", err_out, tol_out, fn, ms, plain,
           bound_ms(4.0 * b * h * pairs * d, nbytes(q, k, v, out, lse)), library)
    # batch 1: one admission of the continuous path
    q1, k1, v1 = q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous()
    out1, lse1 = pf_kernel.flash_fwd(q1, k1, v1)
    torch.cuda.synchronize()
    check(torch.equal(out1, out[:1]) and torch.equal(lse1, lse[:1]),
          "flash_fwd: batch 1 differs from the batch-4 call's first row")
    fn1 = lambda: pf_kernel.flash_fwd(q1, k1, v1)  # noqa: E731
    b1 = {"ms": time_ms(torch, fn1), "device_ms": device_ms(torch, fn1),
          "library_ms": time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
              q1, k1, v1, is_causal=True, enable_gqa=True)),
          "bound_ms": bound_ms(4.0 * h * pairs * d, nbytes(q1, k1, v1, out1, lse1))[0]}
    rows["flash_fwd"]["batch1"] = b1
    log(f"flash_fwd at batch 1: kernel {b1['ms']:.4f} ms (device {b1['device_ms']:.4f} ms), "
        f"library {b1['library_ms']:.4f} ms, bound {b1['bound_ms']:.4f} ms")
    del q1, k1, v1, out1, lse1

    # probe_colsum: the probe rows of select_probes(1024), which repeat (102, 99 unique)
    probe = sal.select_probes(prompt)
    pos = pf_ops.unique_probe_rows(probe.positions.to(dev))
    check(int((pos < 0).sum()) == 3, "select_probes(1024) should repeat 3 positions")
    safe = pos.clamp(0, prompt - 1).long()
    qp, lse_p = q[:, :, safe].contiguous(), lse[:, :, safe].contiguous()
    pos_b = pos[None].expand(b, -1).contiguous()
    col = pf_kernel.probe_colsum(qp, lse_p, pos_b, k, lq=prompt)
    col_ref = pf_ref.probe_colsum_ref(qp, lse_p, pos_b, k, lq=prompt)
    col_again = pf_kernel.probe_colsum(qp, lse_p, pos_b, k, lq=prompt)
    torch.cuda.synchronize()
    check(torch.equal(col, col_again), "probe_colsum: two calls on the same inputs differ")
    # f32 sums in another order: within 1e-4 absolute (checked by `record`)
    err = (col - col_ref).abs().max().item()
    _salient_sets_agree(torch, sal, attention, ccfg, probe, col, col_ref, prompt)
    fn = lambda: pf_kernel.probe_colsum(qp, lse_p, pos_b, k, lq=prompt)  # noqa: E731
    ms = time_ms(torch, fn)
    plain = time_ms(torch, lambda: pf_ref.probe_colsum_ref(qp, lse_p, pos_b, k, lq=prompt))
    valid_pairs = int((pos[pos >= 0] + 1).sum())
    record("probe_colsum", "src/repro_torch/kernels/probe_flash/csrc/probe_flash.cu",
           "src/repro/kernels/probe_flash/kernel.py:177", err, 1e-4, fn, ms, plain,
           bound_ms(2.0 * b * h * valid_pairs * d, nbytes(qp, lse_p, pos_b, k, col)))
    # batch 1: one admission of the continuous path, lkv 1024
    p1 = [t[:1].contiguous() for t in (qp, lse_p, pos_b, k)]
    col1 = pf_kernel.probe_colsum(*p1, lq=prompt)
    col1_ref = pf_ref.probe_colsum_ref(*p1, lq=prompt)
    torch.cuda.synchronize()
    check(torch.equal(col1, pf_kernel.probe_colsum(*p1, lq=prompt)),
          "probe_colsum: two batch-1 calls on the same inputs differ")
    err1 = (col1 - col1_ref).abs().max().item()
    check(err1 <= 1e-4, f"probe_colsum batch 1: max abs error {err1:.3g} exceeds 1e-4")
    fn1 = lambda: pf_kernel.probe_colsum(*p1, lq=prompt)  # noqa: E731
    b1 = {"ms": time_ms(torch, fn1), "device_ms": device_ms(torch, fn1), "max_abs_err": err1,
          "plain_ms": time_ms(torch, lambda: pf_ref.probe_colsum_ref(*p1, lq=prompt)),
          "bound_ms": bound_ms(2.0 * h * valid_pairs * d, nbytes(*p1, col1))[0]}
    rows["probe_colsum"]["batch1"] = b1
    log(f"probe_colsum at batch 1: kernel {b1['ms']:.4f} ms (device {b1['device_ms']:.4f} ms), "
        f"plain {b1['plain_ms']:.4f} ms, bound {b1['bound_ms']:.4f} ms")
    del p1, col1, col1_ref

    # decode_qattn: one decode step over a prefill cache after 40 appends
    # (the window partly filled): each packed store alone, then the layer
    kv_k, kv_v = randn(b, hk, prompt, d), randn(b, hk, prompt, d)
    cache = kvc.compress_prefill(ccfg, kv_k, kv_v, torch.rand((b, prompt), generator=gen,
                                                              device=dev), max_len)
    for _ in range(40):
        cache = kvc.append_token(cache, randn(b, hk, d), randn(b, hk, d))
    qd = randn(b, h, d)
    # f32 scores and sums in another order: each of acc, m and l within
    # 1e-4 of the plain version, relative to its largest magnitude (>= 1)
    seg_err = 0.0
    for store in (cache.hi, cache.lo):
        args = (qd, store.k.codes, store.k.scale, store.k.zero, store.v.codes,
                store.v.channel_scale, store.v.scale, store.v.zero, store.pos,
                store.k.bits, store.v.bits)
        got = dq_kernel.qattn_segment(*args)
        want = dq_ref.qattn_segment_ref(*args)
        torch.cuda.synchronize()
        for part, a, w in zip(("acc", "m", "l"), got, want):
            e, t = (a - w).abs().max().item(), 1e-4 * max(w.abs().max().item(), 1.0)
            check(e <= t, f"decode_qattn {part}: max abs error {e:.3g} exceeds {t:.3g}")
            seg_err = max(seg_err, e / t)
    # the layer: the bf16 output within one bf16 ulp of its largest magnitude
    dsegs = dq_ops.mixed_segments(cache)
    check([(o["k_bits"], o["v_bits"]) for o in dsegs] == [(4, 4), (2, 2), (16, 16)],
          "decode_qattn: segments are not 4-bit hi, 2-bit lo, raw window")
    before = dq_kernel.KERNEL.launches
    out_d = dq_kernel.qattn_mixed_layer(qd, dsegs)
    want_d = dq_ref.mixed_layer_ref(qd, dsegs)
    torch.cuda.synchronize()
    check(dq_kernel.KERNEL.launches == before + 1, "decode_qattn: one launch per layer")
    err = (out_d.float() - want_d.float()).abs().max().item()
    tol = 2 ** -7 * max(want_d.float().abs().max().item(), 1.0)
    fn = lambda: dq_kernel.qattn_mixed_layer(qd, dsegs)  # noqa: E731
    ms = time_ms(torch, fn, iters=50)
    plain = time_ms(torch, lambda: dq_ref.mixed_layer_ref(qd, dsegs))
    # the work this cache needs: every slot's pos and the channel parameters;
    # codes (or raw values) and V token parameters of the live slots only
    record("decode_qattn", "src/repro_torch/kernels/decode_qattn/csrc/decode_qattn.cu",
           "src/repro/kernels/decode_qattn/kernel.py:109", err, tol, fn, ms, plain,
           mixed_layer_bound(dsegs, qd, out_d, hk))
    rows["decode_qattn"]["segment_err_over_tol"] = seg_err
    log(f"decode_qattn: timed per decode layer (one launch: hi {cache.hi.capacity}, lo "
        f"{cache.lo.capacity}, window {cache.window} slots, {int(cache.win_fill.max())} "
        f"filled); each store alone within {seg_err:.3g} of its tolerance")
    del q, k, v, out, lse, ref_out, ref_lse, qp, lse_p, cache, kv_k, kv_v, dsegs

    # paged_qattn: one decode layer (three segments, one launch) over a
    # free-list cache at the continuous path's shapes (4 slots, page 64,
    # pool_fraction 0.75)
    pcache = _freelist_cache(torch, np, backend_lib, alloc_lib, paged, ccfg, dev, gen,
                             hk, d, max_len, lengths=(1024, 700, 0, 333), n_append=40)
    segs = pq_ops.layer_segments(pcache)
    check([(o["k_bits"], o["v_bits"]) for o in segs] == [(4, 4), (2, 2), (16, 16)],
          "paged_qattn: segments are not 4-bit hi, 2-bit lo, raw window")
    check(all(bool((o["table"] == o["k_pages"].shape[0] - 1).any()) for o in segs),
          "paged_qattn: every segment's table should hold NULL entries")
    scale = 1.0 / d ** 0.5
    # f32 scores and sums in another order: acc (or the output), m and l of
    # the live slots within 1e-4 of the plain version relative to their
    # largest magnitude (>= 1), the bf16 output within one bf16 ulp of its
    # largest magnitude; the rescaled slot probabilities p * exp(m_run - m)
    # (<= 1) within 1e-5; the empty slot (2) gives l = 0, acc = 0 and m = -1e30
    err = tol = 0.0
    live = torch.tensor([True, True, False, True], device=dev)

    def held(name, got, want, out_tol=None):
        nonlocal err, tol
        for part, a, w in zip(("acc", "m", "l", "p"), got, want):
            a, w = a[live].float(), w[live].float()
            e = (a - w).abs().max().item()
            top = max(w.abs().max().item(), 1.0)
            t = 1e-5 if part == "p" else (out_tol or 1e-4) * top if part == "acc" else 1e-4 * top
            check(e <= t, f"paged_qattn {name} {part}: max abs error {e:.3g} exceeds {t:.3g}")
            err, tol = max(err, e), max(tol, t)

    for weights in (True, False):
        want = pq_ref.paged_layer_ref(qd, segs, scale=scale)
        before = pq_kernel.KERNEL.launches
        out_, m_, l_, p_, mrun_ = pq_kernel.qattn_paged_layer(qd, segs, scale=scale,
                                                              want_weights=weights)
        torch.cuda.synchronize()
        check(pq_kernel.KERNEL.launches == before + 1, "paged_qattn: one launch per layer")
        check(bool((l_[2] == 0).all()) and not bool(out_[2].float().any())
              and torch.equal(m_[2], want[1][2]), "paged_qattn layer: the empty slot must give "
                                                  "zeros")
        got = [out_, m_, l_] + ([p_ * torch.exp(mrun_ - m_[..., None])] if weights else [])
        held(f"layer (weights {weights})", got, want, out_tol=2 ** -7)
    # each segment alone (padded operands, unnormalized acc) through the same kernel
    for o, name in zip(pq_ops.layer_segments(pcache, pad=True), ("hi", "lo", "window")):
        args = (qd, o["k_pages"], o["k_scale"], o["k_zero"], o["v_pages"], o["v_cscale"],
                o["v_tscale"], o["v_tzero"], o["pos"], o["table"])
        kw = dict(k_bits=o["k_bits"], v_bits=o["v_bits"], scale=scale, k_dtype=o["k_dtype"],
                  v_dtype=o["v_dtype"])
        want = pq_ref.paged_segment_ref(*args, **kw)
        acc_, m_, l_, p_, mrun_ = pq_kernel.qattn_paged_segment(*args, **kw)
        torch.cuda.synchronize()
        check(bool((l_[2] == 0).all()) and not bool(acc_[2].any())
              and torch.equal(m_[2], want[1][2]), f"paged_qattn {name}: the empty slot must give "
                                                  "zeros")
        held(name, [acc_, m_, l_, p_ * torch.exp(mrun_ - m_[..., None])], want)

    def paged_layer(weights=False):
        pq_kernel.qattn_paged_layer(qd, segs, scale=scale, want_weights=weights)

    ms = time_ms(torch, paged_layer, iters=50)
    ms_w = time_ms(torch, lambda: paged_layer(True), iters=50)
    dev_w = device_ms(torch, lambda: paged_layer(True))
    plain = time_ms(torch, lambda: pq_ref.paged_layer_ref(qd, segs, scale=scale))
    record("paged_qattn", "src/repro_torch/kernels/paged_qattn/csrc/paged_qattn.cu",
           "src/repro/kernels/paged_qattn/kernel.py:181", err, tol, paged_layer, ms, plain,
           paged_layer_bound(torch, segs, qd))
    rows["paged_qattn"].update(ms_weights=ms_w, device_ms_weights=dev_w)
    log(f"paged_qattn: timed per decode layer (one launch: hi {segs[0]['table'].shape[1]}, "
        f"lo {segs[1]['table'].shape[1]}, window {segs[2]['table'].shape[1]} pages of 64), "
        f"without slot weights; with them {ms_w:.4f} ms (device {dev_w:.4f} ms)")
    del pcache, segs

    # flash_fwd, probe_colsum and cst_quant at DeepSeek-V2-Lite's MLA shapes
    mla_kernels(torch, np, dev, rows, record, ccfg, prompt, max_new)
    # the five kernels at Jamba's (g = 4, 8 kv heads), qwen2-7b's (g = 7, 4 kv
    # heads), smollm-360m's (g = 3, 5 kv heads, d 64), yi-34b's (g = 7, 8 kv
    # heads) and deepseek-moe-16b's (g = 1, 16 kv heads) attention layers
    for tag, arch, g, d, seed, which, hpc in GQA_ROWS:
        gqa_kernels(torch, np, dev, rows, record, ccfg, prompt, max_new, tag, arch, g, d, seed,
                    which, hpc, fp16_pages=tag in FP16_PAGE_ROWS)
    # phase 4p's lockstep baselines at qwen2-7b's attention layer (G = 7) and at
    # zipcache-paper-8b's (Jamba's attention shape): probe_colsum with every
    # row a probe, decode_qattn over fp16's raw store before and after a fold
    for tag, arch in (("qwen2", "qwen2-7b"), ("jamba", "zipcache-paper-8b")):
        _baseline_kernels(torch, np, configs.get_arch(arch), dev, rows, b, prompt, max_new,
                          torch.Generator(device=dev).manual_seed(31), f"@{tag}", arch)
    # the four on seamless's path at its decoder layer (g = 1, 16 kv heads, d 64)
    seamless_kernels(torch, np, dev, rows, record, ccfg, max_new)

    lap("3")
    # ---- 4. the main path -------------------------------------------------
    t0 = time.perf_counter()
    params = registry.materialize_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"yi-6b params: {n_params / 1e9:.2f} B ({nbytes(*_leaves(params)) / 1e9:.1f} GB bf16) "
        f"in {time.perf_counter() - t0:.1f} s")
    scfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0)
    batch, requests, budgets = traffic(np, cfg.vocab, b, prompt, max_new)
    lengths = np.array([len(r) for r in requests])
    n_req = len(requests)
    engine = ServingEngine(cfg, ccfg, scfg, params, device=dev)
    engine.generate(batch, max_new_tokens=2)  # warm-up: cuBLAS and allocator
    kernels = serve.KERNELS
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    out = engine.generate(batch)
    launches = {n: kern.launches for n, kern in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    lock_bytes = engine.cache_bytes(engine.last_caches)
    log(f"main path: cache_bytes of the lockstep cache after the run {lock_bytes}")
    tm = out["timings"]
    n_probe = sum(probe_flag(i, ccfg.recompress_interval, scfg.seed) for i in range(max_new))
    log(f"main path: prefill {tm['prefill_s']:.3f} s, decode {tm['decode_s']:.3f} s, "
        f"{tm['tok_per_s']:.1f} tok/s ({b} x {max_new} tokens; {n_probe} probe steps, "
        f"{max_new // ccfg.recompress_interval} recompression)")
    log(f"first tokens: {out['tokens'][0][:16].tolist()}")
    log(f"kernel launches: {launches}")
    log(f"max memory allocated: {peak / 2**30:.2f} GiB")
    tokens = out["tokens"]
    check(tokens.shape == (b, max_new), f"tokens shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()), "token ids out of range")
    check(max_new >= ccfg.recompress_interval and n_probe > 0, "no fold or no probe step")
    # per layer: one flash_fwd and one probe_colsum per prefill, one
    # cst_quant per store (hi, lo) per compression, one decode_qattn (hi,
    # lo and window in one launch) per non-probe step (probe steps take the
    # exact plain path)
    n_layers, n_fold = cfg.n_layers, max_new // ccfg.recompress_interval
    expected = {"cst_quant": 2 * n_layers * (1 + n_fold), "flash_fwd": n_layers,
                "probe_colsum": n_layers, "decode_qattn": n_layers * (max_new - n_probe)}
    log(f"launches per prefill: flash_fwd {n_layers}, probe_colsum {n_layers}, cst_quant "
        f"{2 * n_layers}; per non-probe decode step: decode_qattn {n_layers} (one per layer); "
        f"per recompression: cst_quant {2 * n_layers}")
    for name, n in launches.items():
        if name not in expected:
            check(n == 0, f"{name} is not on the lockstep path but launched {n} times")
            continue
        check(n > 0, f"{name} was never launched on the main path")
        check(n == expected[name], f"{name}: {n} launches, the path implies {expected[name]}")
    by_path = {"lockstep": launches}

    # the same model through the plain versions: logits, then tokens.  The
    # decode step starts from the plain path's cache in both runs, so it
    # holds decode_qattn alone (step 0 is not a probe step).  Random weights
    # leave attention near one-hot, so one-ulp bf16 differences in a layer's
    # attention output grow over 32 layers: the test is the relative L2
    # error of the logits, within 0.2 (a wiring fault gives about 1).  As a
    # yardstick of that noise, the plain prefill is run once more with its
    # attention output taken from scaled_dot_product_attention (an
    # independent exact-softmax kernel, never called by the port); it read
    # about 0.11 on an H100.
    plain_engine = ServingEngine(cfg, ccfg, scfg, params, device=dev, use_kernels=False)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    first_probe = probe_flag(0, ccfg.recompress_interval, scfg.seed)
    check(not first_probe, "decode step 0 should take the decode kernel")
    plain_blocked = attention.blocked_attention

    def sdpa_blocked(q, k, v, **kw):
        _, colsum = plain_blocked(q, k, v, **kw)
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                               enable_gqa=True)
        return out, colsum

    with torch.inference_mode():
        lk, _ = registry.prefill(params, {"tokens": toks}, cfg, engine.ctx)
        lp, cp = registry.prefill(params, {"tokens": toks}, cfg, plain_engine.ctx)
        attention.blocked_attention = sdpa_blocked
        try:
            lf, _ = registry.prefill(params, {"tokens": toks}, cfg, plain_engine.ctx)
        finally:
            attention.blocked_attention = plain_blocked
        tok0 = torch.argmax(lp, dim=-1).to(torch.int32)
        dk, _ = registry.decode_step(params, tok0, cp, cfg, engine.ctx, first_probe)
        dp, _ = registry.decode_step(params, tok0, cp, cfg, plain_engine.ctx, first_probe)

    def rel_l2(a, w):
        return ((a.float() - w.float()).norm() / w.float().norm()).item()

    log(f"yardstick: plain prefill logits with SDPA's attention output vs plain: relative "
        f"L2 {rel_l2(lf, lp):.4g}")
    for what, a, w in (("prefill", lk, lp), ("first decode step", dk, dp)):
        check(bool(torch.isfinite(a).all()), f"{what} logits not finite")
        e, top = (a.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        r = rel_l2(a, w)
        log(f"{what} logits vs plain: relative L2 {r:.4g} (tolerance 0.2), max abs diff "
            f"{e:.4g} (max |logit| {top:.4g}), argmax equal {bool((a.argmax(-1) == w.argmax(-1)).all())}")
        check(r <= 0.2, f"{what} logits differ from the plain path beyond tolerance")
    plain_out = plain_engine.generate(batch)
    agree = float((plain_out["tokens"] == tokens).mean())
    log(f"generated tokens equal to the plain path's: {agree:.3f} (not asserted: random "
        f"weights leave near-ties)")
    yardstick = rel_l2(lf, lp)
    del engine, plain_engine, plain_out, cp, lk, lp, lf, dk, dp

    lap("4")
    # ---- 4b. slice 2's main path: the continuous engine ---------------------
    cscfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0,
                        backend="paged", page_size=64, page_allocator="freelist",
                        pool_fraction=0.75, paged_kernel=True, scheduler="fifo")
    log(f"continuous: {n_req} requests, prompt lengths {lengths.tolist()}, budgets "
        f"{budgets.tolist()}")
    ceng = ContinuousEngine(cfg, ccfg, cscfg, params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    paged.GATHER_DECODES.launches = 0
    t0 = time.perf_counter()
    rids = [ceng.submit(Request(tokens=r, max_new_tokens=int(m)))
            for r, m in zip(requests, budgets)]
    res = ceng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    claunches = {n: kern.launches for n, kern in kernels.items()}
    gathers = paged.GATHER_DECODES.launches
    cpeak = torch.cuda.max_memory_allocated()
    stats = ceng.pool_stats()
    n_tok = sum(len(res[r].tokens) for r in rids)
    log(f"continuous: {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s over the run), "
        f"{ceng._step_no} steps, {stats['admissions']} admissions, {stats['deferrals']} "
        f"deferrals, {stats['folds']} slot folds")
    for i, r in enumerate(rids):
        t = res[r].timings
        log(f"  {r}: prompt {lengths[i]}, {len(res[r].tokens)} tokens, queued "
            f"{t['queued_s']:.3f} s, first token {t['first_token_s']:.3f} s, prefill "
            f"{t['prefill_s']:.3f} s, decode {t['tok_per_s']:.1f} tok/s")
    peaks = {k: f"{stats[k]['peak_used']}/{stats[k]['pool_pages']}" for k in ("hi", "lo", "win")}
    log(f"continuous: pages peak used / pool {peaks}")
    log(f"continuous: kernel launches {claunches}, gather-path decodes {gathers}")
    log(f"continuous: max memory allocated {cpeak / 2**30:.2f} GiB")
    for i, r in enumerate(rids):
        check(res[r].finish_reason == "length" and len(res[r].tokens) == budgets[i],
              f"{r} ended {res[r].finish_reason} with {len(res[r].tokens)} of {budgets[i]} tokens")
        check(bool(((res[r].tokens >= 0) & (res[r].tokens < cfg.vocab)).all()),
              f"{r}: token ids out of range")
    ceng._alloc.check_invariants()
    for seg in ("hi", "lo", "win"):
        check(stats[seg]["used"] == 0 and stats[seg]["free"] == stats[seg]["pool_pages"],
              f"continuous: {seg} pages not all returned: {stats[seg]}")
    check(stats["admissions"] == n_req and stats["deferrals"] >= 1 and stats["folds"] >= 1,
          f"continuous: expected {n_req} admissions, a deferral and a fold: {stats}")
    check(gathers == 0, f"continuous: {gathers} decodes took the gather path")
    # per layer: one flash_fwd and one probe_colsum per admission, one
    # cst_quant per store (hi, lo) per admission and per slot fold, one
    # paged_qattn (all three segments) per decode step; the mixed layout's
    # decode_qattn is not on this path
    cexpected = {"cst_quant": 2 * n_layers * (stats["admissions"] + stats["folds"]),
                 "flash_fwd": n_layers * stats["admissions"],
                 "probe_colsum": n_layers * stats["admissions"],
                 "decode_qattn": 0, "paged_qattn": n_layers * ceng._step_no}
    log(f"launches per admission: flash_fwd {n_layers}, probe_colsum {n_layers}, cst_quant "
        f"{2 * n_layers}; per decode step: paged_qattn {n_layers}; per slot fold: "
        f"cst_quant {2 * n_layers}")
    for name, n in claunches.items():
        check(n == cexpected[name], f"{name}: {n} launches on the continuous path, the path "
                                    f"implies {cexpected[name]}")
        check(n > 0 or name == "decode_qattn", f"{name} was never launched on the continuous path")
    by_path["continuous"] = claunches
    del ceng, res

    # the first decode step of one admitted slot, from the plain engine's
    # cache: through the page walk's kernel and through its plain version
    peng = ContinuousEngine(cfg, ccfg, cscfg, params, device=dev, use_kernels=False)
    keng = ContinuousEngine(cfg, ccfg, cscfg, params, device=dev)
    peng.submit(Request(tokens=requests[0], max_new_tokens=int(budgets[0])))
    check(not probe_flag(0, ccfg.recompress_interval, 0), "decode step 0 should not probe")
    with torch.inference_mode():
        peng._admit()   # prefill + insert, without the step's decode
        peng._alloc.note_append(0)   # the window page the decode writes
        peng._sync_tables()
        stage = steps_lib.stage_rows({0: (peng.slots[0].generated[-1], False)}, b)
        kstep, pstep = (steps_lib.make_continuous_decode_step(cfg, e._shape, ccfg, ctx=e.ctx,
                                                              device=dev, capture=False)[0]
                        for e in (keng, peng))
        before = pq_kernel.KERNEL.launches
        lpk, _ = kstep(params, peng.caches, stage)
        check(pq_kernel.KERNEL.launches - before == n_layers,
              "the kernel engine's decode step did not go through paged_qattn once per layer")
        lpp, _ = pstep(params, peng.caches, stage)
        check(pq_kernel.KERNEL.launches - before == n_layers,
              "the plain engine's decode step launched paged_qattn")
    check(bool(torch.isfinite(lpk[0]).all()), "continuous first decode logits not finite")
    r = rel_l2(lpk[0], lpp[0])
    # paged_qattn and its plain version run the same page walk and merge, so
    # their f32 outputs differ by summation order only, below one bf16 ulp of
    # the attention output: the logits agree to that
    log(f"continuous first decode step logits (slot 0) vs plain: relative L2 {r:.4g} "
        f"(tolerance 0.2; yardstick of bf16 noise from phase 4: {yardstick:.4g}), argmax equal "
        f"{bool(lpk[0].argmax() == lpp[0].argmax())}")
    check(r <= 0.2, "continuous first decode logits differ from the plain path beyond tolerance")
    del peng, keng

    lap("4b")
    # ---- 4c / 4d. eager against captured decode steps -----------------------
    # the same traffic on the same model through a fresh engine of each kind
    # (capture=False: the plain functions; capture=True: the decode step
    # replays a CUDA graph), in one call
    toks = torch.as_tensor(batch["tokens"], device=dev)
    interval = ccfg.recompress_interval
    n_win = 16   # steps in each profiled window
    lock = {}
    for capture in (False, True):
        eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        eng.generate(batch, max_new_tokens=2)   # warm-up (with capture: warm-up step, capture)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        rec = eng._decode = StepLogits(eng._decode)   # every step's logits
        out = eng.generate(batch)
        eng._decode = rec.step
        got = {n: kern.launches for n, kern in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        for name, n in expected.items():
            check(got[name] == n, f"lockstep (capture {capture}): {name} {got[name]} launches, "
                                  f"the path implies {n}")
        step_ms, probe_ms = [], []
        with torch.inference_mode():
            lg, caches = eng._prefill(params, {"tokens": toks})
            caches = eng._decode.adopt(caches)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            for i in range(n_win):
                probe = probe_flag(i, interval, scfg.seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches = eng._decode(params, caches, tok, probe)
                torch.cuda.synchronize()
                (probe_ms if probe else step_ms).append((time.perf_counter() - t0) * 1e3)
                tok = eng._decode.token

            def window():
                c = caches
                for _ in range(n_win):
                    _, c = eng._decode(params, c, eng._decode.token, False)

            busy, ops = profile_window(torch, window, n_win)
        lock[capture] = dict(tokens=out["tokens"], decode_s=out["timings"]["decode_s"],
                             tok_s=out["timings"]["tok_per_s"], step_ms=np.median(step_ms),
                             probe_ms=np.median(probe_ms),
                             busy=busy, ops=ops, peak=peak, rec=rec, step=eng._decode)
        del eng, caches, lg
    summarize("lockstep", lock, torch, rel_l2, yardstick)

    cont = {}
    prng.SAMPLES.launches = 0
    for capture in (False, True):
        eng = ContinuousEngine(cfg, ccfg, cscfg, params, device=dev, capture=capture)
        rec = eng._decode_masked = StepLogits(eng._decode_masked)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        plain_ms, probe_ms = [], []
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=r, max_new_tokens=int(m)))
                for r, m in zip(requests, budgets)]
        while eng.pending:
            # a plain or a probe step: nothing is admitted, folded or retired
            live = [sl for sl in eng.slots if sl is not None]
            probe = any(probe_flag(sl.steps, interval, 0) for sl in live)
            n_events = (eng._n_admissions, eng._n_folds, len(live))
            ts = time.perf_counter()
            eng.step()   # ends in the tokens' copy to the host
            if live and n_events == (eng._n_admissions, eng._n_folds,
                                     sum(sl is not None for sl in eng.slots)):
                (probe_ms if probe else plain_ms).append((time.perf_counter() - ts) * 1e3)
        wall = time.perf_counter() - t0
        got = {n: kern.launches for n, kern in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        st = eng.pool_stats()
        want = {"cst_quant": 2 * n_layers * (st["admissions"] + st["folds"]),
                "flash_fwd": n_layers * st["admissions"],
                "probe_colsum": n_layers * st["admissions"],
                "decode_qattn": 0, "paged_qattn": n_layers * eng._step_no}
        for name, n in want.items():
            check(got[name] == n, f"continuous (capture {capture}): {name} {got[name]} "
                                  f"launches, the path implies {n}")
        rec.on = False   # the first pass's steps are the ones compared
        res = {r: eng.result(r).tokens for r in rids}
        check(all(len(res[r]) == budgets[i] for i, r in enumerate(rids)),
              f"continuous (capture {capture}): a request ended short of its budget")
        # a profiled window of engine steps in the middle of a second pass
        rids2 = [eng.submit(Request(tokens=r, max_new_tokens=int(m)))
                 for r, m in zip(requests, budgets)]
        for _ in range(40):
            eng.step()
        busy, ops = profile_window(torch, lambda: [eng.step() for _ in range(n_win)], n_win)
        eng.run()
        same = np.mean([eng.result(r).tokens.tolist() == res[q].tolist()
                        for r, q in zip(rids2, rids)])
        log(f"continuous (capture {capture}): {same:.3f} of the requests' tokens repeat on a "
            f"second pass of the same traffic on the same engine")
        cont[capture] = dict(tokens=np.concatenate([res[r] for r in rids]), decode_s=wall,
                             tok_s=sum(len(t) for t in res.values()) / wall,
                             step_ms=np.median(plain_ms), probe_ms=np.median(probe_ms), busy=busy,
                             ops=ops, peak=peak, rec=rec, step=rec.step,
                             per_request=[res[r].tolist() for r in rids])
        del eng
    summarize("continuous", cont, torch, rel_l2, yardstick)
    # all-greedy traffic runs no sampler: no draw, no sampler graph
    check(prng.SAMPLES.launches == 0 and cont[True]["step"].sample_replays == 0,
          f"continuous: all-greedy traffic ran the sampler {prng.SAMPLES.launches} times")
    ops = cont[True]["ops"]
    log(f"continuous captured: device ops per step {'not measured' if ops is None else f'{ops:.1f}'} "
        f"(3,109.2 before sampling existed, H100 80GB HBM3 at 700 W); sampler runs 0, "
        "sampler graph replays 0")
    greedy_4d = cont[True]["per_request"]
    del cont

    lap("4c / 4d")
    # ---- 4e. slice 7's levers: precision map, swap tier, downshift ladder ---
    by_path.update(levers(torch, np, cfg, ccfg, params, dev, kernels, n_layers, prompt))

    lap("4e")
    # ---- 4f. slice 8: shared-prefix dedup with copy-on-write ---------------
    by_path.update(prefix_dedup(torch, np, cfg, ccfg, params, dev, kernels, n_layers, prompt,
                                card, rel_l2))

    lap("4f")
    # ---- 4g. slice 9: seeded temperature sampling --------------------------
    run_4g = sampling(torch, np, cfg, ccfg, params, dev, kernels, n_layers, cscfg, requests,
                      budgets, greedy_4d, lock_bytes, card)
    by_path.update(run_4g["launches"])

    lap("4g")
    # ---- 4h. slice 10: the serving edge, serve_http over HTTP/SSE ------------
    torch.cuda.empty_cache()   # the server processes take their own share of the card
    by_path["http"] = serving_edge(torch, np, cfg, params, dev, n_layers, requests, budgets,
                                   run_4g, card)
    lap("4h")
    # ---- 4i. slice 11: the baseline policies and the two levers -------------
    by_path.update(baselines(torch, np, cfg, params, dev, kernels, rows, batch, scfg,
                             cscfg, requests, budgets, rel_l2, yardstick, card))
    lap("4i")
    # ---- 4j. slice 12: DeepSeek-V2-Lite (MLA + fine-grained MoE) ------------
    del params, lock, rec, kstep, pstep   # the last holders of yi-6b's tree
    gc.collect()
    torch.cuda.empty_cache()
    log(f"yi-6b freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    by_path.update(deepseek(torch, np, dev, kernels, batch, cscfg, requests, budgets, rel_l2,
                            yardstick, card, rows))
    lap("4j")
    # ---- 4k. slice 13: mamba2 and Jamba's hybrid group (SSM + attention) ----
    by_path.update(hybrid(torch, np, dev, kernels, b, prompt, cscfg, rel_l2, yardstick, card,
                          rows))
    lap("4k")
    # ---- 4l. slice 14: seamless-m4t-medium (encoder-decoder) -----------------
    by_path.update(seamless(torch, np, dev, kernels, rel_l2, yardstick, card))
    lap("4l")
    # ---- 4m. slice 15: the remaining configs at full size -------------------
    by_path.update(remaining(torch, np, dev, kernels, rel_l2, yardstick, card, rows))
    lap("4m")
    # ---- 4n. slice 16: single-card training of the dense decoder -----------
    by_path["train"] = training(torch, np, dev, kernels, card)
    lap("4n")
    # ---- 4o. slice 17: training of every other family ----------------------
    by_path["train_families"] = families(torch, np, dev, kernels, card)
    lap("4o")
    # ---- 4q. slice 19: training on a mesh at world size 1 -------------------
    by_path["train_mesh"] = mesh_training(torch, np, dev, kernels, card)
    lap("4q")
    # ---- 4r. slice 20: serving on a mesh at world size 1 --------------------
    by_path["serve_mesh"] = serving_mesh(torch, np, dev, kernels, card, rows)
    lap("4r")
    # ---- 4s. slice 21: pipeline parallelism at world size 1 -----------------
    by_path["train_pp"] = pipeline_training(torch, np, dev, kernels, card)
    lap("4s")
    rows["cst_quant"]["eff"]["launches"] = sum(
        p["cst_quant"] for name, p in by_path.items() if name.startswith("levers"))
    # phase 4p's launches at the new shapes: cst_quant's eff instantiation
    # (every store of the levers' runs under the map, the ladder's rungs
    # too), fp16's raw pages, probe_colsum with every row a probe
    for row, model in (("cst_quant@mla", MLA_ARCH), ("cst_quant@jamba", JAMBA_ARCH),
                       ("cst_quant@qwen2", "qwen2-7b"), ("cst_quant@smollm", "smollm-360m"),
                       ("cst_quant@dsmoe", "deepseek-moe-16b")):
        rows[row]["eff"]["launches"] = sum(
            p["cst_quant"] for name, p in by_path.items()
            if name.startswith(f"4p/{model} levers") or name == f"4p/{model} map")
    for row, model in (("paged_qattn@jamba", "zipcache-paper-8b"),
                       ("paged_qattn@qwen2", "qwen2-7b"), ("paged_qattn@smollm", "smollm-360m")):
        rows[row]["fp16_raw"]["launches"] = by_path[f"4p/{model}-continuous-fp16"]["paged_qattn"]
    for tag, model in (("qwen2", "qwen2-7b"), ("jamba", "zipcache-paper-8b")):
        rows[f"probe_colsum@{tag}"]["np1024"]["launches"] = sum(
            by_path[f"4p/{model}-lockstep-{p}"]["probe_colsum"] for p in ("h2o", "mikv"))
        rows[f"decode_qattn@{tag}"]["fp16_raw"]["launches"] = by_path[
            f"4p/{model}-lockstep-fp16"]["decode_qattn"]
    log(f"phase 4p: {sum(P_SECONDS.values()):.1f} s in all, within phases 4j, 4k and 4m ("
        + ", ".join(f"{m} {t:.1f} s" for m, t in P_SECONDS.items()) + f"; {card})")
    for name, row in rows.items():
        row["launches"] = sum(p.get(name, 0) for p in by_path.values())
        row["launches_by_path"] = {k: p.get(name, 0) for k, p in by_path.items()}
    retried = [r for r in DEVICE_MS_READINGS if r[1] > 1]
    log(f"device_ms: {len(DEVICE_MS_READINGS)} readings, each with at least as many device "
        f"kernels as launches and its device ms within its event ms; {len(retried)} taken "
        "again: " + ("; ".join(f"{r[0]} ({r[1]} attempts)" for r in retried) or "none"))

    # ---- 5. the kernels and the contract line ------------------------------
    log("kernels: " + ", ".join(f"{n} ok ({r['launches']} launches)" for n, r in rows.items()))
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


PRECISION_MAP = "default=k8v8;layer:1-=k3v3"   # tests/test_backend_conformance.py's


def levers(torch, np, cfg, ccfg, params, dev, kernels, n_layers, prompt, tag="levers",
           eager=False, recompute=True):
    """Phase 4e (and each tree of phase 4p): the swap-pressure and
    ladder-pressure runs of tests/test_backend_conformance.py at full width
    (prompts of `prompt`, page 64), under the conformance precision map,
    captured.  `n_layers`: the layers with a KV element (every store of an
    admission and a fold through cst_quant's eff instantiation; a decode
    step takes the page walk there, but on MLA, which decodes through the
    plain route over the cache's dense view); `eager`: each run again
    with `capture=False`, every step's logits bitwise, the first replays
    after a swap-in and after a downshift fold among them; `recompute`:
    the swap scenario under preemption by recompute too, tokens equal.
    Returns each captured run's launch counts, read from 0."""
    from repro_torch.kernels.cst_quant import kernel as cst_kernel
    from repro_torch.serving import (ContinuousEngine, DownshiftEvent, PreemptedEvent,
                                     Request, ServeConfig, SwappedEvent)

    walk = not cfg.mla
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, cfg.vocab, size=(prompt,)).astype(np.int32) for _ in range(3)]
    timed = {"_swap_out": [], "_swap_in": [], "_downshift": []}
    marked = {"_swap_in": "swap-in", "_downshift": "downshift"}

    def engine(capture=True, **kw):
        scfg = ServeConfig(batch_size=2, prompt_len=prompt, max_new_tokens=12, seed=0,
                           backend="paged", page_size=64, page_allocator="freelist",
                           paged_kernel=True, scheduler="priority",
                           precision_map=PRECISION_MAP, **kw)
        eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        pending, marks, folds = set(), {}, []
        eng._decode_masked = MarkedLogits(eng._decode_masked, pending, marks)
        for name, ms in timed.items():   # wall time of each lever event, to a synchronize
            def wrapped(*a, _fn=getattr(eng, name), _ms=ms, _name=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a)
                torch.cuda.synchronize()
                if out is not False:   # not a refused or ineligible victim
                    _ms.append(round((time.perf_counter() - t0) * 1e3, 3))
                    if _name in marked:
                        pending.add(marked[_name])
                return out
            setattr(eng, name, wrapped)
        fold = eng._fold

        def counted_fold(due):
            folds.append(len(due))
            return fold(due)

        eng._fold = counted_fold
        return eng, marks, folds, capture

    def drive(made, scenario, label):
        """Returns (tokens per request, events, pool stats, launches, the
        step's logits, the marks)."""
        eng, marks, folds, capture = made
        torch.cuda.synchronize()
        for kern in kernels.values():
            kern.launches = 0
        cst_kernel.EFF.launches = 0
        if scenario == "swap":
            rids = [eng.submit(Request(tokens=prompts[0])), eng.submit(Request(tokens=prompts[1]))]
        else:
            rids = [eng.submit(Request(tokens=prompts[0])),
                    eng.submit(Request(tokens=prompts[1], max_new_tokens=6))]
        events = []
        for _ in range(4):
            events += eng.step()
            eng._alloc.check_invariants()
        if scenario == "swap":
            rids.append(eng.submit(Request(tokens=prompts[2], max_new_tokens=3, priority=2)))
        else:
            rids.append(eng.submit(Request(tokens=prompts[2])))
        while eng.pending:
            events += eng.step()
            eng._alloc.check_invariants()
        torch.cuda.synchronize()
        launches = {n: kern.launches for n, kern in kernels.items()}
        st = eng.pool_stats()
        for seg in ("hi", "lo", "win"):
            check(st[seg]["used"] == 0, f"{tag} ({label}): {seg} pages not all returned")
        # every store of every admission and fold through cst_quant's eff
        # instantiation (the map covers every layer; a fold call of more than
        # half the batch is one full-batch store), every decode step through
        # the page walk where the tree takes it, a recompute re-admission's
        # replayed steps too
        b = eng.scfg.batch_size
        stores = sum(k if 2 * k <= b else 1 for k in folds) + st["folds"] - sum(folds)
        replayed = sum(e.n_generated - 1 for e in events if isinstance(e, PreemptedEvent))
        want = {"cst_quant": 2 * n_layers * (st["admissions"] + stores),
                "flash_fwd": n_layers * st["admissions"],
                "probe_colsum": n_layers * st["admissions"],
                "decode_qattn": 0,
                "paged_qattn": n_layers * (eng._step_no + replayed) if walk else 0}
        for name, n in want.items():
            check(launches[name] == n, f"{tag} ({label}): {name} {launches[name]} "
                                       f"launches, the path implies {n}")
            check(n > 0 or name == "decode_qattn" or not walk,
                  f"{tag} ({label}): {name} never launched")
        check(cst_kernel.EFF.launches == launches["cst_quant"],
              f"{tag} ({label}): {cst_kernel.EFF.launches} of {launches['cst_quant']} cst_quant "
              "launches took the map's eff table")
        step = eng._decode_masked
        if capture:
            check(step.step.captures == 1 and step.step.replays > 0,
                  f"{tag} ({label}): the decode step was built {step.step.captures} times")
        return ([eng.result(r).tokens.tolist() for r in rids], events, st, launches,
                step.logits, marks)

    def bitwise(label, captured, eager_run):
        """Every captured step's logits bitwise the eager step's of the same
        index; the first replays after the marked events among them."""
        got, want, marks = captured[4], eager_run[4], captured[5]
        check(captured[0] == eager_run[0], f"{tag} ({label}): captured tokens differ from eager")
        check(len(got) == len(want) > 0, f"{tag} ({label}): {len(got)} captured steps against "
                                         f"{len(want)} eager")
        for i, (a, w) in enumerate(zip(got, want)):
            check(torch.equal(a, w), f"{tag} ({label}): step {i}'s logits are not bitwise the "
                                     "eager step's")
        log(f"{tag} ({label}): {len(got)} captured steps bitwise the eager steps, the first "
            f"replays after {', '.join(f'{k} (step {v})' for k, v in sorted(marks.items()))}")
        return marks

    out_rc = None
    if recompute:
        out_rc, ev_rc, _, _, _, _ = drive(engine(pool_fraction=1.0, preemption="recompute"),
                                          "swap", "recompute")
        check(any(isinstance(e, PreemptedEvent) for e in ev_rc),
              f"{tag}: the swap scenario forced no victim under recompute")
    for ms in timed.values():
        ms.clear()
    sw_run = drive(engine(pool_fraction=1.0, preemption="swap"), "swap", "swap")
    out_sw, ev_sw, st_sw, l_sw = sw_run[:4]
    dirs = [e.direction for e in ev_sw if isinstance(e, SwappedEvent)]
    sw = st_sw["swap"]
    log(f"{tag} (swap): {dirs.count('out')} swap-outs, {dirs.count('in')} swap-ins; entry "
        f"{sw['entry_bytes']} bytes ({sw['entry_bytes'] / 2**20:.2f} MiB, {sw['capacity']} "
        f"pinned entries); swap-out {timed['_swap_out']} ms, swap-in {timed['_swap_in']} ms "
        f"(wall to a synchronize); host bytes after the run {sw['host_bytes']}")
    check("out" in dirs and "in" in dirs, f"{tag}: no swap-out and swap-in: {dirs}")
    check(not any(isinstance(e, PreemptedEvent) for e in ev_sw),
          f"{tag}: a swap fell back to recompute")
    check(sw["host_bytes"] == 0 and sw["resident"] == 0, f"{tag}: host bytes left: {sw}")
    if recompute:
        check(out_sw == out_rc, f"{tag}: the swap run's tokens differ from the recompute run's")
    log(f"{tag} (swap): launches {l_sw}" + ("; tokens equal to the recompute run's"
                                            if recompute else ""))
    if eager:
        check("swap-in" in bitwise("swap", sw_run, drive(engine(
            capture=False, pool_fraction=1.0, preemption="swap"), "swap", "swap eager")),
              f"{tag} (swap): no replay after the swap-in")

    ds_run = drive(engine(pool_fraction=1.0, ladder_watermark=0.6), "ladder", "ladder")
    out_ds, ev_ds, st_ds, l_ds = ds_run[:4]
    ds = st_ds["downshift"]
    rungs = [e.rung for e in ev_ds if isinstance(e, DownshiftEvent)]
    log(f"{tag} (ladder): {ds['downshifts']} downshifts (rungs {rungs}) freed "
        f"{ds['pages_freed']} window pages; downshift (fold at the rung, all layers) "
        f"{timed['_downshift']} ms; {st_ds['folds']} folds, {st_ds['deferrals']} deferrals; "
        f"launches {l_ds}")
    check(ds["downshifts"] >= 1 and ds["pages_freed"] >= 1, f"{tag}: no downshift: {ds}")
    check(all(len(t) == m for t, m in zip(out_ds, (12, 6, 12))),
          f"{tag} (ladder): a request ended short of its budget")
    check(all(0 <= tok < cfg.vocab for t in out_ds + out_sw for tok in t),
          f"{tag}: token ids out of range")
    if eager:
        check("downshift" in bitwise("ladder", ds_run, drive(engine(
            capture=False, pool_fraction=1.0, ladder_watermark=0.6), "ladder", "ladder eager")),
              f"{tag} (ladder): no replay after a downshift")
    return {f"{tag} (swap)": l_sw, f"{tag} (ladder)": l_ds}


# phase 4f's traffic: (prompt, budget) in submission order.  The first four
# miss and register; 5-8 come in as slots retire and can hit; budgets past
# recompress_interval (100) fold, so donors and aliases copy on write; #7
# never folds (it reserves no hi/lo pages)
PREFIX_TRAFFIC = (("A", 128), ("C", 64), ("B", 48), ("D", 96),
                  ("A", 128), ("B", 112), ("A", 48), ("A", 120))
PREFIX_LENGTHS = {"A": 1024, "B": 640, "C": 300, "D": 900}


def prefix_dedup(torch, np, cfg, ccfg, params, dev, kernels, n_layers, prompt, card, rel_l2,
                 traffic=PREFIX_TRAFFIC, max_new=128, tag="prefix", off_eager=False):
    """Phase 4f (and each tree of phase 4p): the same traffic through a
    fresh captured engine with `prefix_cache` off, then on, then an eager
    engine with it on; with `off_eager` (phase 4p), the run with dedup off
    is the eager one and there is no third run: the captured run with dedup
    on is held step by step to it.  `n_layers`: the layers with a KV
    element (a decode step walks their pages but on MLA).  Returns the
    runs' launch counts, each read from 0."""
    from repro_torch.core import backend as backend_lib
    from repro_torch.serving import ContinuousEngine, Request, ServeConfig

    walk = not cfg.mla
    rng = np.random.default_rng(3)
    texts = {k: rng.integers(2, cfg.vocab, size=(n,)).astype(np.int32)
             for k, n in PREFIX_LENGTHS.items()}

    def run(prefix_cache, capture):
        scfg = ServeConfig(batch_size=4, prompt_len=prompt, max_new_tokens=max_new, seed=0,
                           backend="paged", page_size=64, page_allocator="freelist",
                           pool_fraction=1.5, paged_kernel=True, scheduler="fifo",
                           prefix_cache=prefix_cache)
        eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        log_ = {"hit_ms": [], "miss_ms": [], "cow_ms": [], "hit_buckets": 0, "shared_peak": 0,
                "marks": {}, "pending": set()}
        rec = eng._decode_masked = MarkedLogits(eng._decode_masked, log_["pending"],
                                                log_["marks"])
        admit_one, copy_pages = eng._admit_one, getattr(eng, "_copy_pages", None)
        fold, log_["folds"] = eng._fold, []

        def counted_fold(due):
            log_["folds"].append(len(due))
            return fold(due)

        eng._fold = counted_fold

        def timed_admit(slot_id, req):
            hits = eng._alloc.prefix_hits
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            admit_one(slot_id, req)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if eng._alloc.prefix_hits > hits:
                log_["hit_ms"].append(ms)
                log_["hit_buckets"] += eng._bucket_len(int(req.tokens.shape[-1]))
                log_["pending"].add("alias")
            else:
                log_["miss_ms"].append(ms)

        def timed_copy(caches, moves):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = copy_pages(caches, moves)
            torch.cuda.synchronize()
            log_["cow_ms"].append(round((time.perf_counter() - t0) * 1e3, 3))
            log_["pending"].add("cow")
            return out

        eng._admit_one = timed_admit
        eng._copy_pages = timed_copy
        torch.cuda.synchronize()
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=texts[k], max_new_tokens=m)) for k, m in traffic]
        while eng.pending:
            eng.step()
            eng._alloc.check_invariants()
            log_["shared_peak"] = max(log_["shared_peak"],
                                      eng._alloc.stats()["prefix"]["shared_pages"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: kern.launches for n, kern in kernels.items()}
        st = eng.pool_stats()
        outs = [(eng.result(r).tokens.tolist(), eng.result(r).finish_reason) for r in rids]
        snap_bytes = [backend_lib.cache_bytes(snap)["total_bytes"] + nbytes(lg)
                      for snap, lg in eng._prefix_snap.values()]
        for key in eng._alloc.prefix_reclaim(min_pages=10**9):
            eng._prefix_snap.pop(key)
        eng._alloc.check_invariants()
        for name, seg in eng._alloc.segs.items():
            check(len(seg.free) == seg.pool_pages and not seg.refcount.any(),
                  f"{tag} (on={prefix_cache}): {name} pages not all back after the reclaim")
        return dict(eng=eng, rec=rec, wall=wall, launches=launches, stats=st, outs=outs,
                    snap_bytes=snap_bytes, **log_)

    off = run(False, not off_eager)
    on = run(True, True)
    eager = off if off_eager else run(True, False)
    for i, ((a, ra), (w, rw)) in enumerate(zip(on["outs"], off["outs"])):
        if (a, ra) != (w, rw):
            step = next((j for j, (x, y) in enumerate(zip(a, w)) if x != y), min(len(a), len(w)))
            fail(f"{tag}: request {i} ({traffic[i][0]}, budget {traffic[i][1]}) "
                 f"diverges at token {step}: on {a[step:step + 4]} ({ra}), off "
                 f"{w[step:step + 4]} ({rw})")
    check(eager["outs"] == on["outs"], f"{tag}: the eager engine's tokens differ from the "
                                       "captured engine's")
    check(all(len(t) == m and r == "length" for (t, r), (_, m) in zip(on["outs"], traffic)),
          f"{tag}: a request ended short of its budget")
    pf = on["stats"]["prefix"]
    log(f"{tag}: {card}; {pf['hits']} hits, {pf['misses']} misses, {pf['cow_copies']} CoW "
        f"page copies ({len(on['cow_ms'])} copy steps), {pf['evictions']} evictions, "
        f"{on['shared_peak']} shared pages at peak, {pf['prefill_tokens_skipped']} prefill "
        f"tokens skipped")
    check(pf["hits"] >= 1 and pf["cow_copies"] >= 1, f"{tag}: no hit or no CoW copy: {pf}")
    check(pf["prefill_tokens_skipped"] == on["hit_buckets"],
          f"{tag}: {pf['prefill_tokens_skipped']} tokens skipped, the hits' buckets hold "
          f"{on['hit_buckets']}")
    check(off["stats"]["prefix"]["hits"] == 0, f"{tag}: the run with dedup off hit")
    log(f"{tag}: admission wall to a synchronize: hit median {np.median(on['hit_ms']):.3f} ms "
        f"({len(on['hit_ms'])}: {[round(x, 3) for x in on['hit_ms']]}), miss median "
        f"{np.median(on['miss_ms']):.3f} ms ({len(on['miss_ms'])}); with dedup off, miss median "
        f"{np.median(off['miss_ms']):.3f} ms ({len(off['miss_ms'])})")
    log(f"{tag}: CoW copy (all layers' pools, one step) wall {on['cow_ms']} ms")
    peaks = {k: (on["stats"][k]["peak_used"], off["stats"][k]["peak_used"],
                 on["stats"][k]["pool_pages"]) for k in ("hi", "lo", "win")}
    log(f"{tag}: peak pages used on / off / pool per segment {peaks}")
    log(f"{tag}: snapshot bytes per entry {on['snap_bytes']} "
        f"({[round(b / 2**20, 2) for b in on['snap_bytes']]} MiB)")
    log(f"{tag}: decode wall (submit to drained) off {off['wall']:.3f} s"
        f"{' (eager)' if off_eager else ''}, on {on['wall']:.3f} s"
        + ("" if off_eager else f", on eager {eager['wall']:.3f} s"))
    log(f"{tag}: launches off {off['launches']}, on {on['launches']}")
    for run_, label in ((off, "off"), (on, "on")):
        st, got = run_["stats"], run_["launches"]
        b = run_["eng"].scfg.batch_size
        stores = sum(k if 2 * k <= b else 1 for k in run_["folds"]) + st["folds"] - sum(
            run_["folds"])
        want = {"cst_quant": 2 * n_layers * (st["admissions"] + stores),
                "flash_fwd": n_layers * st["admissions"],
                "probe_colsum": n_layers * st["admissions"],
                "decode_qattn": 0,
                "paged_qattn": n_layers * run_["eng"]._step_no if walk else 0}
        for name, n in want.items():
            check(got[name] == n, f"{tag} ({label}): {name} {got[name]} launches, the path "
                                  f"implies {n}")
            check(n > 0 or name == "decode_qattn" or not walk,
                  f"{tag} ({label}): {name} never launched")
    for name in ("flash_fwd", "probe_colsum"):
        saved = off["launches"][name] - on["launches"][name]
        check(saved == n_layers * pf["hits"], f"{tag}: {name} launched {saved} times fewer "
                                              f"with dedup, layers x hits is "
                                              f"{n_layers * pf['hits']}")
    step = on["rec"].step
    check(step.captures == 1 and step.replays > 0,
          f"{tag}: the captured step was built {step.captures} times")
    got, want = on["rec"].logits, eager["rec"].logits
    check(len(got) == len(want) > 0, f"{tag}: {len(got)} captured steps against {len(want)}")
    n_equal, worst = 0, 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        n_equal += bool(torch.equal(a, w))
        ulp = 2 ** -7 * max(w.float().abs().max().item(), 1.0)
        worst = max(worst, (a.float() - w.float()).abs().max().item() / ulp)
    check(worst <= 1.0, f"{tag}: a captured step's logits differ from the eager step's by "
                        f"{worst:.3g} bf16 ulps (tolerance 1)")
    check(not off_eager or n_equal == len(got),
          f"{tag}: {len(got) - n_equal} captured steps with dedup on are not bitwise the eager "
          "steps with it off")
    marks = on["marks"]
    check(set(marks) == {"alias", "cow"}, f"{tag}: no replay after an alias admission and "
                                           f"after a CoW copy: {marks}")
    for what, i in sorted(marks.items()):
        check(torch.equal(got[i], want[i]),
              f"{tag}: the first replay after {what} (step {i}) is not bitwise the eager "
              f"step's: relative L2 {rel_l2(got[i], want[i]):.4g}")
    log(f"{tag}: captured step {step.captures} capture(s), {step.replays} replays; {len(got)} "
        f"steps vs eager: {n_equal} bitwise equal, largest difference {worst:.4g} bf16 ulps; "
        f"first replays after an alias admission (step {marks['alias']}) and after a CoW copy "
        f"(step {marks['cow']}) bitwise equal")
    return {f"{tag} (off)": off["launches"], f"{tag} (on)": on["launches"]}


# phase 4g: the requests of phase 4b's traffic that sample, by submission
# index: (temperature, seed); the others stay greedy
SAMPLED = {1: (0.7, 11), 3: (1.0, 12), 5: (0.7, 13), 7: (1.0, 14)}


def sampling(torch, np, cfg, ccfg, params, dev, kernels, n_layers, scfg, requests, budgets,
             greedy_4d, lock_bytes, card, sampled=SAMPLED, runs=(1, 2, 3), draws=True,
             tag="sampling"):
    """Phase 4g (and trees of phase 4p): phase 4d's traffic (or `requests`)
    with the requests of `sampled` sampled, through a captured engine (run
    1), an eager one (run 2) and a captured one with the requests submitted
    in reverse order (run 3), those of `runs`; with `draws`, then the draw
    itself on the card against the host.  `greedy_4d`: the greedy tokens of
    the same traffic, or None (the greedy requests are then held across
    the runs alone).  `n_layers`: the layers with a KV element (a decode
    step walks their pages but on MLA).  Returns run 1's
    launch counts, read from 0, its tokens by submission index, decode wall
    and the requests' first-token times."""
    from repro_torch.core import prng
    from repro_torch.core import saliency as sal
    from repro_torch.launch import steps as steps_lib
    from repro_torch.runtime import compile_guard
    from repro_torch.serving import ContinuousEngine, Request, SamplingParams, probe_flag

    interval, n, walk = ccfg.recompress_interval, len(requests), not cfg.mla

    def run(capture, order, account=False):
        eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        folds, fold = [], eng._fold

        def counted_fold(due):
            folds.append(len(due))
            return fold(due)

        eng._fold = counted_fold
        torch.cuda.synchronize()
        for kern in kernels.values():
            kern.launches = 0
        prng.SAMPLES.launches = 0
        ms = {True: [], False: []}   # non-probe steps that admit, fold, retire nothing
        peak_bytes = {}
        with compile_guard.count_captures() as builds:
            t0 = time.perf_counter()
            rids = {i: eng.submit(Request(
                tokens=requests[i], max_new_tokens=int(budgets[i]),
                sampling=SamplingParams(*sampled.get(i, (0.0, 0))))) for i in order}
            while eng.pending:
                live = [sl for sl in eng.slots if sl is not None]
                probe = any(probe_flag(sl.steps, interval, 0) for sl in live)
                with_sampled = any(sl.request.sampling.temperature > 0 for sl in live)
                n_events = (eng._n_admissions, eng._n_folds, len(live))
                ts = time.perf_counter()
                eng.step()   # ends in the tokens' copy to the host
                if live and not probe and n_events == (eng._n_admissions, eng._n_folds,
                                                       sum(sl is not None for sl in eng.slots)):
                    ms[with_sampled].append((time.perf_counter() - ts) * 1e3)
                if account:
                    cb = eng.cache_bytes(eng.caches)
                    if cb["packed_bytes"] > peak_bytes.get("packed_bytes", -1):
                        peak_bytes = cb
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = eng.pool_stats()
        got = {name: kern.launches for name, kern in kernels.items()}
        b = scfg.batch_size
        stores = sum(k if 2 * k <= b else 1 for k in folds) + st["folds"] - sum(folds)
        want = {"cst_quant": 2 * n_layers * (st["admissions"] + stores),
                "flash_fwd": n_layers * st["admissions"],
                "probe_colsum": n_layers * st["admissions"],
                "decode_qattn": 0, "paged_qattn": n_layers * eng._step_no if walk else 0}
        for name, k in want.items():
            check(got[name] == k, f"{tag} (capture {capture}): {name} {got[name]} launches, "
                                  f"the path implies {k}")
        eng._alloc.check_invariants()
        for seg in ("hi", "lo", "win"):
            check(st[seg]["used"] == 0, f"{tag} (capture {capture}): {seg} pages not all back")
        tokens = [eng.result(rids[i]).tokens.tolist() for i in range(n)]
        for i, t in enumerate(tokens):
            check(len(t) == budgets[i] and all(0 <= x < cfg.vocab for x in t),
                  f"{tag} (capture {capture}): request {i} ended with {len(t)} of "
                  f"{budgets[i]} tokens or out of range")
        return dict(eng=eng, rids=rids, tokens=tokens, wall=wall, ms=ms, builds=builds.count,
                    launches=got, draws=prng.SAMPLES.launches, peak_bytes=peak_bytes)

    r1 = run(True, range(n))
    r2 = run(False, range(n)) if 2 in runs else None
    r3 = run(True, range(n - 1, -1, -1), account=True) if 3 in runs else None

    def first_diff(a, w):
        return next((j for j, (x, y) in enumerate(zip(a, w)) if x != y), min(len(a), len(w)))

    for i in range(n if r2 else 0):
        a, w = r1["tokens"][i], r2["tokens"][i]
        if a != w:
            j = first_diff(a, w)
            fail(f"{tag}: request {i} {sampled.get(i, 'greedy')} differs captured against "
                 f"eager at step {j}: {a[j:j + 4]} against {w[j:j + 4]}")
    for i in range(n):
        a = r1["tokens"][i]
        if r3 and (i in sampled or greedy_4d is None) and a != r3["tokens"][i]:
            j = first_diff(a, r3["tokens"][i])
            fail(f"{tag}: request {i} {sampled.get(i, 'greedy')} differs in reverse submission "
                 f"order at step {j}: {a[j:j + 4]} against {r3['tokens'][i][j:j + 4]}")
        if greedy_4d is None:
            continue
        if i in sampled:
            check(a != greedy_4d[i], f"{tag}: sampled request {i} {sampled[i]} equals its "
                                     "greedy tokens of phase 4d")
        elif a != greedy_4d[i]:
            j = first_diff(a, greedy_4d[i])
            fail(f"{tag}: greedy request {i} differs from phase 4d at step {j}: "
                 f"{a[j:j + 4]} against {greedy_4d[i][j:j + 4]}")
    step = r1["eng"]._decode_masked
    check(r1["builds"] <= 2 and step.captures <= 2 and step.sample_replays > 0,
          f"{tag}: run 1 built {r1['builds']} graphs ({step.captures} captures, "
          f"{step.sample_replays} sampler replays)")
    check(r2 is None or r2["builds"] == 0, f"{tag}: the eager run built {r2 and r2['builds']} "
                                           "graphs")
    n_sampled_tok = sum(len(r1["tokens"][i]) for i in sampled)
    held = (["captured and eager equal"] if r2 else []) + (
        ["greedy requests equal phase 4d"] if greedy_4d is not None else []) + (
        [f"{'sampled' if greedy_4d is not None else 'all'} requests equal in reverse "
         "submission order"] if r3 else []) + (
        ["sampled requests differ from their greedy tokens"] if greedy_4d is not None else [])
    log(f"{tag}: {card}; requests {sorted(sampled)} sampled at {list(sampled.values())} "
        f"((temperature, seed)); {n_sampled_tok} sampled tokens; " + ", ".join(held))
    log(f"{tag}: run 1 built {r1['builds']} graphs (decode step and sampler), "
        f"{step.replays} decode replays, {step.sample_replays} sampler replays, "
        f"{r1['draws']} sampler runs")
    def median(xs):
        return f"{np.median(xs):.3f} ms ({len(xs)} steps)" if xs else "none (0 steps)"

    for label, r in (("run 1 captured", r1), ("run 2 eager", r2), ("run 3 captured, reversed", r3)):
        if r is not None:
            log(f"{tag}: {label}: decode wall {r['wall']:.3f} s; median non-probe step with "
                f"sampled rows {median(r['ms'][True])}, without {median(r['ms'][False])}")
    if r3:
        log(f"{tag}: run 3's wall includes a cache_bytes read after every step")
    if not draws:
        return {"launches": {tag: r1["launches"]}, "tokens": r1["tokens"], "wall": r1["wall"]}

    # the draw itself: 16 (seed, counter) pairs over the vocabulary
    seeds = [-5, 0, 7, 2**31 - 1, 11, 12, 13, 14, -2**31, 1, 2, 3, 99, 12345, -77, 5]
    ctrs = [0, 1, 3, 1024, 0, 5, 127, 128, 7, 0, 1, 2, 511, 40, 9, 100]
    keys = prng.fold_in(prng.key(torch.tensor(seeds, dtype=torch.int32, device=dev)),
                        torch.tensor(ctrs, dtype=torch.int32, device=dev))
    bits = prng.random_bits32(keys, cfg.vocab).cpu().numpy()
    for row, sd, c in zip(bits, seeds, ctrs):
        want = sal._random_bits32(sal._fold_in(sal._key(sd), c), cfg.vocab).astype(np.int64)
        check(bool((row == want).all()), f"sampling: device bits differ from numpy's at seed "
                                         f"{sd}, counter {c}")
    gen = torch.Generator(device=dev).manual_seed(9)
    logits = (torch.randn((16, cfg.vocab), generator=gen, device=dev) * 4).to(torch.bfloat16)
    temps = torch.tensor([0.0, 0.7, 1.0, 2.0] * 4, device=dev)
    sd_t = torch.tensor(seeds, dtype=torch.int32, device=dev)
    ct_t = torch.tensor(ctrs, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        got = prng.sample_tokens(logits, temps, sd_t, ct_t).cpu()
        host = [t.cpu() for t in (logits, temps, sd_t, ct_t)]
        want = prng.sample_tokens(*host)
        scores = (prng.gumbel(prng.fold_in(prng.key(host[2]), host[3]), cfg.vocab)
                  + host[0].float() / torch.maximum(host[1], torch.full_like(host[1], 1e-3))[:, None])
    top2 = scores.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    for i in range(16):
        check(int(got[i]) == int(want[i]) or (host[1][i] > 0 and margins[i] <= 1e-5),
              f"sampling: row {i} draws {int(got[i])} on the card, {int(want[i])} on the host "
              f"(top-two margin {margins[i]:.3g})")
    log(f"sampling: device random_bits32 over {cfg.vocab} columns equals numpy's for 16 (seed, "
        f"counter) pairs; sample_tokens on 16 bf16 logit rows equal on the card and the host "
        f"({int((got == want).sum())} of 16; smallest top-two margin of a sampled row "
        f"{min(m for m, t in zip(margins, host[1]) if t > 0):.4g})")

    # the sampler's device time per step: its graph over the step's static
    # logits, and the same function eagerly
    with torch.inference_mode():
        graph_ms = device_ms(torch, lambda: step.sample(step._out))
        eager_ms = device_ms(torch, lambda: prng.sample_tokens(
            step._out, *steps_lib.sampling_rows(step.staged)))
    log(f"sampling: sampler device ms per step ({scfg.batch_size} x {cfg.vocab}): graph "
        f"{graph_ms:.4f}, eager {eager_ms:.4f} ({card})")
    packed = r1["eng"].cache_bytes(r1["eng"].caches)
    log(f"sampling: cache_bytes at full width ({card}): phase 4 lockstep cache after its run "
        f"{lock_bytes}; run 1's engine after its run {packed}; run 3's step of most packed "
        f"bytes {r3['peak_bytes']}")
    return {"launches": {"sampling": r1["launches"]}, "tokens": r1["tokens"], "wall": r1["wall"],
            "first_token_s": [r1["eng"].result(r1["rids"][i]).timings["first_token_s"]
                              for i in range(n)]}


# phase 4h: serve_http's command line at phase 4b's configuration; run (i)
# adds the paged layout's flags and two replicas, run (ii) keeps the CLI's
# default mixed layout on one replica
HTTP_ARGV = ["--arch", "yi-6b", "--seed", "0", "--batch", "4", "--prompt-len", "1024",
             "--max-new", "128"]
HTTP_PAGED = ["--backend", "paged", "--page-size", "64", "--page-allocator", "freelist",
              "--pool-fraction", "0.75", "--paged-kernel", "on"]


class HttpServer:
    """`python -m repro_torch.launch.serve_http` on 127.0.0.1 as a child
    process, its port read from the line it prints; its stderr goes to this
    script's.  `stop()` sends SIGINT and returns the kernel launches the
    server printed on its way out; leaving the `with` block kills a server
    that is still alive."""

    def __init__(self, argv, start_timeout: float = 600.0):
        self.argv, self.start_timeout = argv, start_timeout

    def __enter__(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve_http", *self.argv, "--port", "0"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
        try:
            self.lines = queue.Queue()
            threading.Thread(target=self._pump, daemon=True).start()
            t0, self.port = time.perf_counter(), None
            while self.port is None:
                wait = self.start_timeout - (time.perf_counter() - t0)
                try:
                    line = self.lines.get(timeout=max(wait, 0.01))
                except queue.Empty:
                    fail(f"serve_http printed no port within {self.start_timeout:.0f} s")
                if line is None:
                    fail(f"serve_http exited with status {self.proc.wait()} before listening")
                log(f"server: {line.rstrip()}")
                m = re.search(r"listening on http://127\.0\.0\.1:(\d+) ", line)
                self.port = int(m.group(1)) if m else None
            self.start_s = time.perf_counter() - t0
        except BaseException:
            self.__exit__()
            raise
        return self

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def stop(self, timeout: float = 60.0):
        """SIGINT -> (kernel launches, seconds to exit); fails unless the
        server drains, prints its launches and exits 0 within `timeout`."""
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            fail(f"serve_http still running {timeout:.0f} s after SIGINT")
        exit_s = time.perf_counter() - t0
        out = []
        while (line := self.lines.get(timeout=timeout)) is not None:
            out.append(line)
            log(f"server: {line.rstrip()}")
        check(rc == 0, f"serve_http exited with status {rc} after SIGINT")
        m = re.search(r"\[serve_http\] kernel launches: (\{.*\})", "".join(out))
        check(m is not None, "serve_http printed no kernel launches on shutdown")
        return ast.literal_eval(m.group(1)), exit_s

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


async def _http(port: int, method: str, path: str, payload=None):
    """One request on a fresh loopback connection -> (status line, reader,
    writer), the headers consumed."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b"" if payload is None else json.dumps(payload).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Length: "
                 f"{len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    status = (await reader.readline()).decode().strip()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    return status, reader, writer


async def _get_json(port: int, path: str):
    status, reader, writer = await _http(port, "GET", path)
    body = json.loads(await reader.read())
    writer.close()
    check(status.endswith("200 OK"), f"GET {path}: {status} {body}")
    return body


async def _next_event(reader):
    """The data of the next SSE event, or None at the end of the stream."""
    while line := await reader.readline():
        if line.startswith(b"data: "):
            return json.loads(line[6:])
    return None


async def _generate(port: int, spec):
    """One streamed request: its token events, its done event, and the
    client's seconds from sending to the first event and to the done event."""
    t0 = time.perf_counter()
    status, reader, writer = await _http(port, "POST", "/v1/generate", spec)
    check(status.endswith("200 OK"), f"POST /v1/generate: {status}")
    tokens, t_first = [], None
    while True:
        ev = await _next_event(reader)
        check(ev is not None, "an SSE stream ended without its done event")
        if t_first is None:
            t_first = time.perf_counter() - t0
        if "token" not in ev:
            break
        check(ev["index"] == len(tokens), f"SSE token event {ev} out of order")
        tokens.append(ev["token"])
    writer.close()
    return dict(tokens=tokens, done=ev, t_first=t_first, t_done=time.perf_counter() - t0)


async def _hang_up(port: int, witness_spec, spec):
    """Phase 4h's disconnect: a witness stream on replica-0 (both replicas
    idle: the router's tie goes to the lower index), then `spec` on
    replica-1 (the less loaded), which hangs up after 8 events.  Polls
    /v1/stats until replica-1's free pages are back to their value before;
    the witness's events in between count the router steps.  Then the
    witness hangs up too, and replica-0's pages must come back."""
    def free(st, name):
        return st["replicas"][name]["free_pool_pages"]

    before = await _get_json(port, "/v1/stats")
    status, wr, ww = await _http(port, "POST", "/v1/generate", witness_spec)
    check(status.endswith("200 OK"), f"witness: {status}")
    arrivals = []

    async def witness():
        while (ev := await _next_event(wr)) is not None and "token" in ev:
            arrivals.append(time.perf_counter())

    wtask = asyncio.create_task(witness())
    while not arrivals:
        await asyncio.sleep(0.001)
    status, r, w = await _http(port, "POST", "/v1/generate", spec)
    check(status.endswith("200 OK"), f"hang-up request: {status}")
    times = []
    for _ in range(8):
        ev = await _next_event(r)
        check(ev is not None and "token" in ev, "the hang-up request ended early")
        times.append(time.perf_counter())
    mid = await _get_json(port, "/v1/stats")
    check(mid["replicas"]["replica-1"]["busy_slots"] == 1
          and free(mid, "replica-1") < free(before, "replica-1"),
          f"the hang-up request is not running on replica-1: {mid['replicas']}")
    gaps = sorted(b - a for a, b in zip(times, times[1:]))
    out = {"gap_ms": gaps[len(gaps) // 2] * 1e3}
    for name, writer, task in (("replica-1", w, None), ("replica-0", ww, wtask)):
        writer.close()
        t_hang, polls = time.perf_counter(), 0
        while True:
            st = await _get_json(port, "/v1/stats")
            polls += 1
            if free(st, name) == free(before, name):
                break
            check(time.perf_counter() - t_hang < 30, f"{name}: pages not back 30 s after the "
                                                     f"hang-up: {st['replicas'][name]}")
        t_back = time.perf_counter()
        out[name] = dict(polls=polls, ms=(t_back - t_hang) * 1e3,
                         steps=sum(t_hang < a <= t_back for a in arrivals),
                         busy=st["replicas"][name]["busy_slots"])
        if task is not None:
            await asyncio.wait_for(task, timeout=30)
    return out


def serving_edge(torch, np, cfg, params, dev, n_layers, requests, budgets, run_4g, card):
    """Phase 4h: `python -m repro_torch.launch.serve_http` as a child
    process on the card at full width, driven over loopback sockets.  Run
    (i): two replicas on the paged layout take phase 4g's eight requests
    concurrently (its sampled ones at their temperature and seed); each
    stream's tokens equal its done event's and phase 4g's run 1; both
    replicas take requests; a hung-up stream's pages come back.  Run (ii):
    one replica on the CLI's default mixed layout, two requests of 16 tokens
    one after the other, equal to an in-process engine on `params`.  Each
    server exits 0 on SIGINT with its layout's kernels launched.  Returns
    the two runs' launches, summed."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousEngine, Request, SamplingParams

    built = sorted(build.BUILD_DIR.glob("*.so"))   # phase 2's libraries, loaded by the servers
    n = len(requests)
    specs = [{"tokens": requests[i].tolist(), "max_new_tokens": int(budgets[i]),
              "temperature": SAMPLED.get(i, (0.0, 0))[0], "seed": SAMPLED.get(i, (0.0, 0))[1]}
             for i in range(n)]

    # run (i): two replicas, paged
    async def run_i(port):
        t0 = time.perf_counter()
        res = await asyncio.wait_for(asyncio.gather(*[_generate(port, sp) for sp in specs]),
                                     timeout=600)
        wall = time.perf_counter() - t0
        stats = await _get_json(port, "/v1/stats")
        full = [{k: v for k, v in specs[i].items() if k != "max_new_tokens"} for i in (0, 2)]
        hang = await asyncio.wait_for(_hang_up(port, *full), timeout=300)
        return res, wall, stats, hang, await _get_json(port, "/v1/stats")

    with HttpServer(HTTP_ARGV + HTTP_PAGED + ["--replicas", "2"]) as srv:
        res, wall, stats, hang, final = asyncio.run(run_i(srv.port))
        launches_i, exit_i = srv.stop()
    for i, r in enumerate(res):
        check(r["tokens"] == r["done"]["tokens"], f"http: request {i}'s SSE tokens differ from "
                                                  f"its done event's")
        check(r["done"]["finish_reason"] == "length" and len(r["tokens"]) == budgets[i],
              f"http: request {i} ended {r['done']['finish_reason']} with {len(r['tokens'])} "
              f"of {budgets[i]} tokens")
        if r["tokens"] != run_4g["tokens"][i]:
            want = run_4g["tokens"][i]
            j = next(j for j, (a, b) in enumerate(zip(r["tokens"], want)) if a != b)
            fail(f"http: request {i} {SAMPLED.get(i, 'greedy')} on {r['done']['id']} differs "
                 f"from phase 4g's run 1 at step {j}: {r['tokens'][j:j + 4]} against "
                 f"{want[j:j + 4]}")
    names = {"replica-0", "replica-1"}
    placed = [r["done"]["id"].split("/")[0] for r in res]
    check(set(stats["replicas"]) == names and set(placed) == names
          and all(stats["pool_stats"][k]["admissions"] > 0 for k in names),
          f"http: the requests did not spread over both replicas: {placed}, {stats['replicas']}")
    for name in ("replica-1", "replica-0"):
        h = hang[name]
        check(h["polls"] == 1 and h["busy"] == 0,
              f"http: {name}'s pages came back at /v1/stats poll {h['polls']} after the hang-up "
              f"(busy slots {h['busy']}), not at the first")
    adm = sum(final["pool_stats"][k]["admissions"] for k in names)
    folds = sum(final["pool_stats"][k]["folds"] for k in names)
    want_i = {"cst_quant": 2 * n_layers * (adm + folds), "flash_fwd": n_layers * adm,
              "probe_colsum": n_layers * adm, "decode_qattn": 0}
    for name, k in want_i.items():
        check(launches_i[name] == k, f"http run (i): {name} {launches_i[name]} launches, the "
                                     f"path implies {k}")
    check(launches_i["paged_qattn"] > 0 and launches_i["paged_qattn"] % n_layers == 0,
          f"http run (i): paged_qattn {launches_i['paged_qattn']} launches")

    log(f"http: {card}; run (i) serve_http --replicas 2 (paged free list 0.75, page walk), "
        f"listening {srv.start_s:.1f} s after start; 8 requests posted concurrently, placed "
        f"{placed}; tokens equal phase 4g's run 1 and each done event's")
    lags = []
    for i, r in enumerate(res):
        t = r["done"]["timings"]
        finish = t["queued_s"] + t["prefill_s"] + t["decode_s"]   # submit to retirement
        lags.append(r["t_done"] - finish)
        log(f"  request {i} ({len(specs[i]['tokens'])} prompt tokens, {budgets[i]} new, "
            f"{SAMPLED.get(i, 'greedy')}) on {r['done']['id']}: client first event "
            f"{r['t_first']:.3f} s, done {r['t_done']:.3f} s; server first token "
            f"{t['first_token_s']:.3f} s, retired {finish:.3f} s, queued {t['queued_s']:.3f} "
            f"s; phase 4g run 1 first token {run_4g['first_token_s'][i]:.3f} s")
    log(f"http: done event after the server's retirement by {min(lags):.3f}-{max(lags):.3f} s "
        f"(client clock from sending, server clock from submit)")
    last = range(n - 4, n)
    log(f"http: run (i) wall {wall:.3f} s against phase 4g run 1's decode wall "
        f"{run_4g['wall']:.3f} s (ratio {wall / run_4g['wall']:.3f}); mean first event of "
        f"requests 4-7 {np.mean([res[i]['t_first'] for i in last]):.3f} s on two replicas, "
        f"phase 4g run 1 first token {np.mean([run_4g['first_token_s'][i] for i in last]):.3f} "
        f"s on one engine")
    log(f"http: hang-up after 8 events (median gap {hang['gap_ms']:.2f} ms): replica-1's pages "
        f"back at the first /v1/stats answer, {hang['replica-1']['ms']:.1f} ms and "
        f"{hang['replica-1']['steps']} router steps (witness events) after the hang-up; the "
        f"witness's own hang-up: replica-0's back in {hang['replica-0']['ms']:.1f} ms")
    log(f"http: run (i) SIGINT -> exit 0 in {exit_i:.2f} s; launches {launches_i} "
        f"({adm} admissions, {folds} slot folds)")

    # run (ii): one replica, the CLI's default (mixed) layout, against an
    # in-process engine built from the same flags; one request at a time,
    # so both see the same slots and steps
    specs2 = [dict(specs[i], max_new_tokens=16) for i in (0, 1)]

    async def run_ii(port):
        return [await asyncio.wait_for(_generate(port, sp), timeout=300) for sp in specs2]

    with HttpServer(HTTP_ARGV + ["--replicas", "1"]) as srv:
        res2 = asyncio.run(run_ii(srv.port))
        launches_ii, exit_ii = srv.stop()
    ap = argparse.ArgumentParser()
    serve.add_engine_args(ap)
    args = ap.parse_args(HTTP_ARGV)
    eng = ContinuousEngine(cfg, serve.build_compression_config(args),
                           serve.build_serve_config(args), params, device=dev)
    for i, (sp, r) in enumerate(zip(specs2, res2)):
        rid = eng.submit(Request(tokens=np.asarray(sp["tokens"], np.int32), max_new_tokens=16,
                                 sampling=SamplingParams(sp["temperature"], sp["seed"])))
        want = eng.run()[rid].tokens.tolist()
        check(r["tokens"] == r["done"]["tokens"] == want and len(want) == 16,
              f"http run (ii): request {i} {r['tokens']} differs from the in-process engine's "
              f"{want}")
    del eng
    want_ii = {"cst_quant": 2 * n_layers * 2, "flash_fwd": 2 * n_layers,
               "probe_colsum": 2 * n_layers, "paged_qattn": 0}
    for name, k in want_ii.items():
        check(launches_ii[name] == k, f"http run (ii): {name} {launches_ii[name]} launches, "
                                      f"the path implies {k}")
    check(launches_ii["decode_qattn"] > 0, "http run (ii): decode_qattn never launched")
    check(sorted(build.BUILD_DIR.glob("*.so")) == built,
          "http: a serve_http process built kernel libraries of its own")
    firsts = ", ".join(f"{r['t_first']:.3f}" for r in res2)
    dones = ", ".join(f"{r['t_done']:.3f}" for r in res2)
    log(f"http: run (ii) serve_http --replicas 1 (mixed layout): 2 requests of 16 tokens equal "
        f"the in-process engine's; client first event {firsts} s, done {dones} s; SIGINT -> "
        f"exit 0 in {exit_ii:.2f} s; launches {launches_ii}")
    return {k: launches_i[k] + launches_ii[k] for k in launches_i}


# phase 4i: the lockstep policies (fp16 first: the others' logits are held
# to its) and the continuous ones
LOCKSTEP_POLICIES = ("fp16", "h2o", "mikv", "gear", "kivi")
CONTINUOUS_POLICIES = ("fp16", "kivi")
# the policies whose mixed stores a fold promotes to f32 (a zero-capacity
# store's f32 parameters, as in the reference): their lockstep step is
# built again after the first fold
PROMOTING = ("fp16", "h2o", "gear", "kivi")
BASELINE_LAYERS = 4   # phase 4i's runs: the first 4 of yi-6b's 32 layers (8 before phase 4o)


def baselines(torch, np, cfg, params, dev, kernels, rows, batch, scfg, cscfg,
              requests, budgets, rel_l2, yardstick, card, layers=BASELINE_LAYERS,
              policies=LOCKSTEP_POLICIES, cpolicies=CONTINUOUS_POLICIES, ccfg_of=None,
              tag="4i", full=True):
    """Phase 4i (and trees of phase 4p): the baseline policies on both
    engines at full width over the first `layers` of the model's layers
    (phase 4i: BASELINE_LAYERS of yi-6b's 32, cut from 32 to make room for
    phase 4l in the time limit), the kernels at their shapes, and the
    int8-algebra / compact-softmax levers.  `policies` / `cpolicies`: the
    lockstep and continuous runs; `ccfg_of`: each policy's configuration
    (its preset by default); `full` (phase 4i): also the kernels at the
    baselines' shapes, the int8-algebra / compact-softmax levers and the
    lockstep steps timed alone.  Returns the launch counts of each run
    ({path: {kernel: n}})."""
    import dataclasses

    from repro_torch.core import backend as backend_lib
    from repro_torch.core import paged
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.models import registry
    from repro_torch.serving import ContinuousEngine, Request, ServingEngine, probe_flag

    t_phase = time.perf_counter()
    ccfg_of = ccfg_of or CompressionConfig.preset
    b, prompt = batch["tokens"].shape
    max_new = scfg.max_new_tokens
    hk, d = cfg.n_kv_heads, cfg.hd
    max_len = prompt + max_new
    gen = torch.Generator(device=dev).manual_seed(4)
    if full:   # the kernels at the baselines' shapes; the int8-algebra and compact levers
        _baseline_kernels(torch, np, cfg, dev, rows, b, prompt, max_new, gen, "", tag)
        _baseline_levers(torch, cfg, dev, b, prompt, max_len, gen, card)

    # -- (i) lockstep runs, at the first `layers` of the model's (full width:
    # the groups' leading axis cut to views of phase 4's first layers) ------------
    out_paths = {}
    lcfg = dataclasses.replace(cfg, n_layers=layers)
    lparams = _first_layers(params, lcfg.n_scan_groups)
    n_lock = lcfg.n_layers
    toks = torch.as_tensor(batch["tokens"], device=dev)
    first, last = {}, {}
    counters = dict(kernels, plain_decodes=backend_lib.PLAIN_DECODES)
    for policy in policies:
        ccfg = ccfg_of(policy)
        interval = ccfg.recompress_interval
        n_probe = sum(probe_flag(i, interval, scfg.seed) for i in range(max_new))
        n_fold = max_new // interval
        runs = {}
        for capture in (True, False):
            eng = ServingEngine(lcfg, ccfg, scfg, lparams, device=dev, capture=capture)
            eng.generate(batch, max_new_tokens=2)   # warm-up
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            rec = eng._decode = StepLogits(eng._decode)
            out = eng.generate(batch)
            eng._decode = rec.step
            got = {n: c.launches for n, c in counters.items()}
            runs[capture] = dict(out=out, rec=rec, launches=got, step=rec.step,
                                 captures=rec.step.captures,
                                 bytes=eng.cache_bytes(eng.last_caches))
            if capture:
                plain_eng = ServingEngine(lcfg, ccfg, scfg, lparams, device=dev,
                                          use_kernels=False)
                with torch.inference_mode():
                    lk, _ = registry.prefill(lparams, {"tokens": toks}, lcfg, eng.ctx)
                    lp, cp = registry.prefill(lparams, {"tokens": toks}, lcfg, plain_eng.ctx)
                    tok0 = torch.argmax(lp, dim=-1).to(torch.int32)
                    dk, _ = registry.decode_step(lparams, tok0, cp, lcfg, eng.ctx, False)
                    dp, _ = registry.decode_step(lparams, tok0, cp, lcfg, plain_eng.ctx, False)
                for what, a, w in (("prefill", lk, lp), ("first decode step", dk, dp)):
                    r = rel_l2(a, w)
                    check(bool(torch.isfinite(a).all()) and r <= 0.2,
                          f"{tag} {policy}: {what} logits vs plain: relative L2 {r:.4g} (tolerance "
                          "0.2) or not finite")
                    runs[capture][what] = r
                del plain_eng, lk, lp, cp, dk, dp
                if full:   # the step alone to a synchronize: median non-probe, probe step
                    step_ms, probe_ms = [], []
                    with torch.inference_mode():
                        lg, caches = eng._prefill(lparams, {"tokens": toks})
                        caches = eng._decode.adopt(caches)
                        tok = torch.argmax(lg, dim=-1).to(torch.int32)
                        for i in range(16):
                            p = probe_flag(i, interval, scfg.seed)
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            lg, caches = eng._decode(lparams, caches, tok, p)
                            torch.cuda.synchronize()
                            (probe_ms if p else step_ms).append((time.perf_counter() - t0) * 1e3)
                            tok = eng._decode.token
                    runs[capture].update(
                        step_ms=float(np.median(step_ms)),
                        probe_ms=float(np.median(probe_ms)) if probe_ms else None)
                    del lg, caches
            del eng
        cap, eager = runs[True], runs[False]
        uses_walk = policy in ("fp16", "h2o")
        want = {"flash_fwd": n_lock, "cst_quant": 0, "paged_qattn": 0,
                "probe_colsum": n_lock if ccfg.uses_saliency else 0,
                "decode_qattn": n_lock * (max_new - n_probe) if uses_walk else 0,
                "plain_decodes": n_lock * (n_probe if uses_walk else max_new)}
        for name, n in want.items():
            check(cap["launches"][name] == n, f"{tag} lockstep {policy}: {name} "
                                              f"{cap['launches'][name]} launches, the route "
                                              f"implies {n}")
        # the warm-up run's capture, then one after the first fold where it promotes
        builds = 1 + (policy in PROMOTING and n_fold > 0)
        check(cap["captures"] == builds and eager["captures"] == 0,
              f"{tag} lockstep {policy}: the captured step was built {cap['captures']} times, the "
              f"route implies {builds}")
        n_equal, worst = 0, 0.0
        for i, (a, w) in enumerate(zip(cap["rec"].logits, eager["rec"].logits)):
            check(bool(torch.isfinite(a).all()), f"{tag} lockstep {policy}: step {i} not finite")
            n_equal += bool(torch.equal(a, w))
            dev_ = (a.float() - w.float()).abs().max().item() / (
                2 ** -7 * max(w.float().abs().max().item(), 1.0))
            worst = max(worst, dev_)
            check(dev_ <= 1.0, f"{tag} lockstep {policy}: step {i}'s logits differ from the eager "
                               f"step's by {dev_:.3g} bf16 ulps of their largest value")
        check(len(cap["rec"].logits) == len(eager["rec"].logits) == max_new,
              f"{tag} lockstep {policy}: {len(cap['rec'].logits)} captured steps")
        check(bool((cap["out"]["tokens"] == eager["out"]["tokens"]).all()),
              f"{tag} lockstep {policy}: captured tokens differ from the eager engine's")
        first[policy], last[policy] = (cap["rec"].logits[i].float() for i in (0, -1))
        tm = cap["out"]["timings"]
        packed = cap["bytes"]["packed_bytes"]
        fp16_bytes = 2 * b * hk * max_len * d * 2 * n_lock
        ratio = ccfg.compression_ratio(b, hk, max_len, d)
        # the first decode step's logits (one prefill, the caches apart) as
        # tests/test_serving.py compares policies; the last step's follow
        # each policy's own greedy tokens
        cos = [torch.nn.functional.cosine_similarity(x[policy].flatten(), x["fp16"].flatten(),
                                                     dim=0).item() for x in (first, last)]
        timed = (f"median non-probe step {cap['step_ms']:.3f} ms, probe step "
                 f"{cap['probe_ms'] or 0:.3f} ms" if full else "steps not timed alone")
        log(f"{tag} lockstep {policy} ({n_lock} layers, {card}): prefill {tm['prefill_s']:.3f} s, "
            f"decode {tm['decode_s']:.3f} s (eager {eager['out']['timings']['decode_s']:.3f} s), "
            f"{timed}; "
            f"{n_probe} probe steps, {n_fold} fold; launches {cap['launches']}; captures "
            f"{cap['captures']}; {n_equal} of {max_new} steps bitwise the eager step's, largest "
            f"difference {worst:.3g} bf16 ulps; logits vs plain: prefill rel L2 "
            f"{cap['prefill']:.4g}, first decode {cap['first decode step']:.4g} (yardstick "
            f"{yardstick:.4g}); cache_bytes packed {packed} ({fp16_bytes / packed:.4f}x the "
            f"bf16 bytes of {max_len} tokens; Appendix-A ratio {ratio:.4f}), total "
            f"{cap['bytes']['total_bytes']}; logits cosine to fp16's: first decode step "
            f"{cos[0]:.4f}, last step {cos[1]:.4f}")
        out_paths[f"{tag}-lockstep-{policy}"] = {n: c for n, c in cap["launches"].items()
                                              if n in kernels}
        del runs, cap, eager

    # -- (ii) continuous runs: phase 4b's configuration and traffic, at the
    # lockstep runs' layers --------------------------------------------------------
    for policy in cpolicies:
        ccfg = ccfg_of(policy)
        eng = ContinuousEngine(lcfg, ccfg, cscfg, lparams, device=dev)
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        paged.GATHER_DECODES.launches = 0
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=r, max_new_tokens=int(m)))
                for r, m in zip(requests, budgets)]
        while eng.pending:
            eng.step()
            eng._alloc.check_invariants()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: c.launches for n, c in kernels.items()}
        gathers = paged.GATHER_DECODES.launches
        st = eng.pool_stats()
        res = {r: eng.result(r) for r in rids}
        for i, r in enumerate(rids):
            check(res[r].finish_reason == "length" and len(res[r].tokens) == budgets[i],
                  f"{tag} continuous {policy}: {r} ended {res[r].finish_reason} with "
                  f"{len(res[r].tokens)} of {budgets[i]} tokens")
        for seg in ("hi", "lo", "win"):
            check(st[seg]["used"] == 0 and st[seg]["free"] == st[seg]["pool_pages"],
                  f"{tag} continuous {policy}: {seg} pages not all returned: {st[seg]}")
        walk_ = policy == "fp16"
        want = {"cst_quant": 0, "flash_fwd": n_lock * st["admissions"], "probe_colsum": 0,
                "decode_qattn": 0, "paged_qattn": n_lock * eng._step_no if walk_ else 0}
        for name, n in want.items():
            check(got[name] == n, f"{tag} continuous {policy}: {name} {got[name]} launches, "
                                  f"the route implies {n}")
        n_gather = 0 if walk_ else n_lock * eng._step_no
        check(gathers == n_gather, f"{tag} continuous {policy}: {gathers} gather-path decodes, the "
                                   f"route implies {n_gather}")
        n_tok = sum(len(x.tokens) for x in res.values())
        peaks = {k: f"{st[k]['peak_used']}/{st[k]['pool_pages']}" for k in ("hi", "lo", "win")}
        log(f"{tag} continuous {policy} ({n_lock} layers, {card}): {n_tok} tokens in "
            f"{wall:.3f} s, {eng._step_no} steps, {st['admissions']} admissions, "
            f"{st['deferrals']} deferrals, {st['folds']} folds; pages peak used / pool {peaks}; launches {got}, gather-path decodes "
            f"{gathers}; allocator invariants held after every step, every page back")
        out_paths[f"{tag}-continuous-{policy}"] = got
        del eng, res
    log(f"baselines: {tag} took {time.perf_counter() - t_phase:.1f} s")
    return out_paths


def _baseline_kernels(torch, np, cfg, dev, rows, b, prompt, max_new, gen, suffix, tag):
    """Phase 4i's kernels at the baselines' shapes, at `cfg`'s attention
    layer: probe_colsum with every row a probe, decode_qattn over fp16's raw
    store before and after a fold.  Kept under `rows["probe_colsum" +
    suffix]["np1024"]` and `rows["decode_qattn" + suffix]["fp16_raw"]`."""
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import saliency as sal
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.kernels.decode_qattn import kernel as dq_kernel
    from repro_torch.kernels.decode_qattn import ops as dq_ops
    from repro_torch.kernels.decode_qattn import ref as dq_ref
    from repro_torch.kernels.probe_flash import kernel as pf_kernel
    from repro_torch.kernels.probe_flash import ref as pf_ref
    from repro_torch.models import attention

    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    max_len = prompt + max_new

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # probe_colsum with every row a probe (h2o, mikv: np = lq = 1024), batch 4
    # (lockstep) and 1 (an admission); sums in another order within 1e-4 of
    # the largest column sum (>= 1), two calls bitwise; the salient sets the
    # prefill (Eq. 8, normalized) and a fold (Eq. 7, accumulated) would draw
    # agree with the plain version's up to ties at the boundary
    q, k, v = randn(b, h, prompt, d), randn(b, hk, prompt, d), randn(b, hk, prompt, d)
    _, lse = pf_kernel.flash_fwd(q, k, v)
    pos = torch.arange(prompt, dtype=torch.int32, device=dev)
    every = sal.ProbeSpec(pos, 0, 0)
    hcfg = CompressionConfig.h2o()
    np1024 = {}
    for nb in (b, 1):
        args = (q[:nb].contiguous(), lse[:nb].contiguous(), pos[None].expand(nb, -1).contiguous(),
                k[:nb].contiguous())
        pf_kernel.COLSUM.heads_per_cta = None
        col = pf_kernel.probe_colsum(*args, lq=prompt)
        hpc = pf_kernel.COLSUM.heads_per_cta
        col_ref = pf_ref.probe_colsum_ref(*args, lq=prompt)
        again = pf_kernel.probe_colsum(*args, lq=prompt)
        torch.cuda.synchronize()
        check(torch.equal(col, again), f"probe_colsum np {prompt} batch {nb}: two calls differ")
        err = (col - col_ref).abs().max().item()
        tol = 1e-4 * max(col_ref.abs().max().item(), 1.0)
        check(err <= tol, f"probe_colsum np {prompt} batch {nb}: max abs error {err:.3g} "
                          f"exceeds {tol:.3g}")
        _salient_sets_agree(torch, sal, attention, hcfg, every, col, col_ref, prompt)
        _salient_sets_agree(torch, sal, attention, hcfg, every, col, col_ref, prompt,
                            normalized=False)
        fn = lambda: pf_kernel.probe_colsum(*args, lq=prompt)  # noqa: E731
        pairs = prompt * (prompt + 1) // 2
        np1024[nb] = {"max_abs_err": err, "ms": time_ms(torch, fn),
                      "device_ms": device_ms(torch, fn),
                      "plain_ms": time_ms(torch, lambda: pf_ref.probe_colsum_ref(
                          *args, lq=prompt), iters=5),
                      "bound_ms": bound_ms(2.0 * nb * h * pairs * d, nbytes(*args, col))[0],
                      "heads_per_cta": hpc}
        log(f"probe_colsum np {prompt} batch {nb} ({h} / {hk} heads, {hpc} a CTA): max abs err "
            f"{err:.3g} (tol {tol:.3g}); "
            f"kernel {np1024[nb]['ms']:.4f} ms (device {np1024[nb]['device_ms']:.4f} ms), "
            f"plain {np1024[nb]['plain_ms']:.4f} ms, bound {np1024[nb]['bound_ms']:.5f} ms")
    np1024[b]["batch1"] = np1024[1]
    rows["probe_colsum" + suffix]["np1024"] = np1024[b]
    del q, k, v, lse, args, col, col_ref, again

    # decode_qattn over fp16's raw store (1152 slots, 1024 filled) and a 100-slot
    # window with 40 appends, in bf16; then the same after a fold (the hi store's
    # values f32, as the fold promotes them): each within one bf16 ulp of the
    # largest output of the plain version
    fcfg = CompressionConfig.fp16()
    cache = kvc.compress_prefill(fcfg, randn(b, hk, prompt, d), randn(b, hk, prompt, d), None,
                                 max_len)
    for _ in range(40):
        cache = kvc.append_token(cache, randn(b, hk, d), randn(b, hk, d))
    qd = randn(b, h, d)
    raw = {}
    for when in ("prefill", "fold"):
        if when == "fold":
            cache = kvc.recompress(fcfg, cache)
            for _ in range(40):
                cache = kvc.append_token(cache, randn(b, hk, d), randn(b, hk, d))
        check(dq_ops.kernel_supported(cache), "decode_qattn: fp16's raw stores must qualify")
        dsegs = dq_ops.mixed_segments(cache)
        check([(o["k_bits"], o["k_codes"].shape[2]) for o in dsegs] == [(16, max_len),
                                                                          (16, cache.window)],
              f"decode_qattn fp16: segments {[(o['k_bits'], o['k_codes'].shape) for o in dsegs]}")
        before = dq_kernel.KERNEL.launches
        dq_kernel.KERNEL.splits = None
        got = dq_kernel.qattn_mixed_layer(qd, dsegs)
        splits = dq_kernel.KERNEL.splits
        want = dq_ref.mixed_layer_ref(qd, dsegs)
        torch.cuda.synchronize()
        check(dq_kernel.KERNEL.launches == before + 1, "decode_qattn fp16: one launch per layer")
        check(isinstance(splits, int) and splits >= 1,
              f"decode_qattn fp16: the launch recorded no split count ({splits!r})")
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -7 * max(want.float().abs().max().item(), 1.0)
        check(err <= tol, f"decode_qattn fp16 raw ({when}): max abs error {err:.3g} exceeds "
                          f"{tol:.3g}")
        fn = lambda: dq_kernel.qattn_mixed_layer(qd, dsegs)  # noqa: E731
        moved, flops = nbytes(qd, got), 0.0
        for o in dsegs:
            n_live = int((o["pos"] >= 0).sum())
            moved += hk * n_live * nbytes(o["k_codes"][0, 0, 0], o["v_codes"][0, 0, 0])
            moved += nbytes(o["pos"])
            flops += 4.0 * h * n_live * d
        raw[when] = {"max_abs_err": err, "ms": time_ms(torch, fn, iters=50),
                     "device_ms": device_ms(torch, fn),
                     "plain_ms": time_ms(torch, lambda: dq_ref.mixed_layer_ref(qd, dsegs)),
                     "bound_ms": bound_ms(flops, moved)[0], "splits": splits,
                     "hi_dtype": str(dsegs[0]["k_codes"].dtype)}
        log(f"decode_qattn fp16 raw layer ({when}: hi {raw[when]['hi_dtype']}, {max_len} slots, "
            f"window {cache.window}): max abs err {err:.3g} (tol {tol:.3g}); "
            f"{raw[when]['splits']} splits per (row, kv head); kernel {raw[when]['ms']:.4f} ms "
            f"(device {raw[when]['device_ms']:.4f} ms), plain {raw[when]['plain_ms']:.4f} ms, "
            f"bound {raw[when]['bound_ms']:.5f} ms")
    rows["decode_qattn" + suffix]["fp16_raw"] = raw
    log(f"{tag}: the kernels at the baselines' shapes ({h} / {hk} heads, d {d}) held")


def _baseline_levers(torch, cfg, dev, b, prompt, max_len, gen, card):
    """Phase 4i's levers on one full-width layer of `cfg`, each timed beside
    its counterpart: the int8-algebra decode and the compact softmax."""
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import saliency as sal
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.models import attention

    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    qd = randn(b, h, d)
    zcfg = CompressionConfig.zipcache()
    cache = kvc.compress_prefill(zcfg, randn(b, hk, prompt, d), randn(b, hk, prompt, d),
                                 torch.rand((b, prompt), generator=gen, device=dev), max_len)
    for _ in range(40):
        cache = kvc.append_token(cache, randn(b, hk, d), randn(b, hk, d))
    ref = kvc.attend_decode(qd, cache)
    alg = kvc.attend_decode(qd, cache, impl="int8_algebra")
    err = (alg.out.float() - ref.out.float()).abs()
    check(bool((err <= 2e-2 + 1e-2 * ref.out.float().abs()).all()),
          f"int8 algebra: output off by {err.max().item():.3g} (atol 2e-2, rtol 1e-2)")
    werr = (alg.slot_weights - ref.slot_weights).abs().max().item()
    check(werr <= 1e-3, f"int8 algebra: slot weights off by {werr:.3g} (atol 1e-3)")
    levers = {"int8_ms": time_ms(torch, lambda: kvc.attend_decode(qd, cache, impl="int8_algebra")),
              "ref_ms": time_ms(torch, lambda: kvc.attend_decode(qd, cache)),
              "int8_out_err": err.max().item(), "int8_weight_err": werr}
    q1, k1, v1 = randn(1, h, prompt, d), randn(1, hk, prompt, d), randn(1, hk, prompt, d)
    probe = sal.select_probes(prompt, device=dev)
    oc, cc = attention.blocked_attention(q1, k1, v1, probe=probe, compact=True)
    of, cf = attention.blocked_attention(q1, k1, v1, probe=probe)
    cerr = (oc.float() - of.float()).abs().max().item()
    check(cerr <= 2e-2, f"compact softmax: output off by {cerr:.3g} (atol 2e-2)")
    levers.update(compact_ms=time_ms(torch, lambda: attention.blocked_attention(
        q1, k1, v1, probe=probe, compact=True), iters=5), f32_ms=time_ms(
        torch, lambda: attention.blocked_attention(q1, k1, v1, probe=probe), iters=5),
        compact_out_err=cerr, compact_colsum_err=(cc - cf).abs().max().item())
    log(f"levers ({card}): int8-algebra decode layer {levers['int8_ms']:.4f} ms against the "
        f"exact route's {levers['ref_ms']:.4f} ms (output off by {levers['int8_out_err']:.3g}, "
        f"slot weights by {werr:.3g}); compact prefill attention, batch 1, "
        f"{levers['compact_ms']:.4f} ms against f32's {levers['f32_ms']:.4f} ms (output off by "
        f"{cerr:.3g}, probe column sums by {levers['compact_colsum_err']:.3g}); plain routes")
    del cache, ref, alg, q1, k1, v1, oc, of, cc, cf


def _first_layers(params, n: int):
    """A parameter tree's first `n` stacked groups, as views (the prefix
    layers and the unstacked leaves as they are)."""
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[:n]
    return dict(params, groups=cut(params["groups"]))


def traffic(np, vocab, b, prompt, max_new):
    """Phase 4's packed batch (seed 0: b prompts of `prompt` tokens) and
    phase 4b's eight requests (seed 1: prompts of 200 to `prompt` tokens,
    budgets of 48 to `max_new`), token ids drawn in [2, vocab)."""
    from repro_torch.serving import pack_requests

    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(prompt,)).astype(np.int32) for _ in range(b)]
    rng = np.random.default_rng(1)
    lengths = rng.integers(200, prompt + 1, size=8)
    budgets = rng.integers(48, max_new + 1, size=8)
    requests = [rng.integers(2, vocab, size=(int(n),)).astype(np.int32) for n in lengths]
    return {"tokens": pack_requests(prompts, b, prompt)}, requests, budgets


def profile_window(torch, run, n_steps):
    """(busy share, device operations per step) of `run()`, which runs
    `n_steps` steps, under torch.profiler: the device's summed kernel, copy
    and fill time over the wall time to a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not ops:
        log("torch.profiler recorded no device operations: busy share not measured")
        return None, None
    return sum(e.device_time for e in ops) / 1e6 / wall, len(ops) / n_steps


class StepLogits:
    """A decode step that keeps every call's logits while `on`: all rows of
    a lockstep step; the active rows of a continuous step (staged (3, b)
    host rows), the only ones the engine reads.  Also the step's replay
    count after each call."""

    def __init__(self, step):
        self.step, self.on, self.logits, self.replays = step, True, [], []

    def __call__(self, *args):
        logits, caches = self.step(*args)
        if self.on:
            kept = logits
            if len(args) == 3:   # continuous: (params, caches, staged); row 2 active
                kept = logits[[i for i, a in enumerate(args[2][2]) if a]]
            self.logits.append(kept.clone())
            self.replays.append(self.step.replays)
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.step, name)


class MarkedLogits(StepLogits):
    """`StepLogits` that also notes, for each event named in `pending` (an
    alias admission, a CoW copy) before a call, the index of the first
    later call that was a replay, in `marks`."""

    def __init__(self, step, pending, marks):
        super().__init__(step)
        self.pending, self.marks = pending, marks

    def __call__(self, *args):
        before, replays = set(self.pending), self.step.replays
        out = super().__call__(*args)
        if self.step.replays > replays:
            for what in before:
                self.marks.setdefault(what, len(self.logits) - 1)
            self.pending.difference_update(before)
        return out


def summarize(path, runs, torch, rel_l2, yardstick, bitwise=False):
    """Log the eager and captured runs of one engine side by side; check the
    captured step was built once and replayed, that every step's logits
    agree with the eager step's of the same index within one bf16 ulp of
    their largest value (with `bitwise`, bit for bit), and that every greedy
    token is equal."""
    eager, cap = runs[False], runs[True]
    step = cap["step"]
    check(step.captures == 1 and step.replays > 0,
          f"{path}: the captured step was built {step.captures} times and replayed "
          f"{step.replays} times")
    check(eager["step"].captures == 0 and eager["step"].replays == 0,
          f"{path}: the eager engine built a step")
    got, want = cap["rec"].logits, eager["rec"].logits
    check(len(got) == len(want) > 0,
          f"{path}: {len(got)} captured steps against {len(want)} eager steps")
    n_equal, worst = 0, 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        check(a.shape == w.shape and bool(torch.isfinite(a).all()),
              f"{path}: step {i}'s logits not finite or of another shape")
        n_equal += bool(torch.equal(a, w))
        ulp = 2 ** -7 * max(w.float().abs().max().item(), 1.0)
        dev_ = (a.float() - w.float()).abs().max().item() / ulp
        worst = max(worst, dev_)
        check(dev_ <= 1.0, f"{path}: step {i}'s logits differ from the eager step's by "
                           f"{dev_:.3g} bf16 ulps of their largest value (tolerance 1)")
    k = next(i for i, r in enumerate(cap["rec"].replays) if r > 0)
    r = rel_l2(got[k], want[k])
    agree = float((cap["tokens"] == eager["tokens"]).mean())
    for name, x in (("eager", eager), ("captured", cap)):
        busy = "not measured" if x["busy"] is None else f"{x['busy']:.4f}"
        ops = "not measured" if x["ops"] is None else f"{x['ops']:.1f}"
        log(f"{path} {name}: decode wall {x['decode_s']:.3f} s ({x['tok_s']:.1f} tok/s), "
            f"median non-probe step {x['step_ms']:.3f} ms, probe step {x['probe_ms']:.3f} ms, "
            f"busy share {busy}, device ops "
            f"per step {ops}, max memory allocated {x['peak'] / 2**30:.3f} GiB")
    log(f"{path}: captured step {step.captures} capture(s), {step.replays} replays; "
        f"{len(got)} steps' logits vs eager: {n_equal} bitwise equal, largest difference "
        f"{worst:.4g} bf16 ulps of the largest value (tolerance 1); replayed first non-probe "
        f"step (step {k}): bitwise equal {bool(torch.equal(got[k], want[k]))}, relative L2 "
        f"{r:.4g} (yardstick of bf16 noise {yardstick:.4g}); greedy tokens equal {agree:.4f}")
    check(agree == 1.0, f"{path}: the captured engine's greedy tokens differ from the eager "
                        "engine's")
    check(not bitwise or n_equal == len(got),
          f"{path}: {len(got) - n_equal} of {len(got)} captured steps' logits differ from the "
          "eager steps' bit for bit")


def mixed_layer_bound(dsegs, qd, out, hk):
    """decode_qattn's bound over one layer's mixed segments: every slot's pos
    and the channel parameters; the codes (or raw values) and V token
    parameters of the live slots only; q read and the output written once."""
    b, h, d = qd.shape
    moved, flops = nbytes(qd, out), 0.0
    for o in dsegs:
        n_live = int((o["pos"] >= 0).sum())          # live (batch row, slot) pairs
        per_slot = nbytes(*[o[k][0, 0, 0] for k in ("k_codes", "v_codes", "v_tscale", "v_tzero")
                            if o.get(k) is not None])
        moved += hk * n_live * per_slot + nbytes(o["pos"])
        moved += nbytes(*[o[k] for k in ("k_scale", "k_zero", "v_cscale") if o.get(k) is not None])
        flops += 4.0 * h * n_live * d
    return bound_ms(flops, moved)


def paged_layer_bound(torch, segs, qd):
    """paged_qattn's bound over one layer's paged segments: each page the
    tables reach read once, with the parameters, positions and tables; q
    read, out (q's dtype), m and l written."""
    b, h, d = qd.shape
    moved = flops = 0
    for o in segs:
        n_read = int(torch.unique(o["table"]).numel())
        moved += n_read * sum(nbytes(t) // t.shape[0] for t in (o["k_pages"], o["v_pages"]))
        moved += nbytes(*[o[k] for k in ("k_scale", "k_zero", "v_cscale", "v_tscale", "v_tzero",
                                         "pos", "table") if o[k] is not None])
        flops += 4.0 * b * h * o["s_seg"] * d
    moved += 2 * nbytes(qd) + 4 * b * h * 2
    return bound_ms(flops, moved)


def _freelist_cache(torch, np, backend_lib, alloc_lib, paged, ccfg, dev, gen, hk, d, max_len,
                    lengths, n_append):
    """A free-list paged cache as the continuous engine builds it: shuffled
    free lists, one batch-1 prefill per slot at its length (0 leaves the
    slot empty: an all-invalid row), ungranted pages NULL, then appends."""
    be = backend_lib.of(ccfg, kind="paged", page_size=64, paged_kernel=True,
                        page_allocator="freelist", pool_fraction=0.75)
    b = len(lengths)
    cache = be.init_cache(b, hk, d, max_len, torch.bfloat16, device=dev)
    alloc = alloc_lib.FreeListAllocator.from_caches(cache, 64)
    rng = np.random.default_rng(0)
    for seg in alloc.segs.values():
        rng.shuffle(seg.free)

    def sync(c):
        t = {k: torch.from_numpy(v).to(dev) for k, v in alloc.tables().items()}
        return paged.with_tables(c, t["hi"], t["lo"], t["win"])

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for slot, n in enumerate(lengths):
        if n:
            sl = be.compress_prefill(randn(1, hk, n, d), randn(1, hk, n, d),
                                     torch.rand((1, n), generator=gen, device=dev), max_len)
            alloc.admit(slot, alloc_lib.slice_occupancy(sl), n + max_len - max(lengths), n)
            cache = be.insert(sync(cache), sl, slot)
    active = torch.tensor([n > 0 for n in lengths], device=dev)
    for _ in range(n_append):
        for slot, n in enumerate(lengths):
            if n:
                alloc.note_append(slot)
        kt = randn(b, hk, d)
        cache = be.append(sync(cache), kt, kt, active=active)
    alloc.check_invariants()
    return cache


def _salient_sets_agree(torch, sal, attention, ccfg, probe, col, col_ref, prompt,
                        normalized=True):
    """`saliency.salient_split` of the kernel's normalized saliency (or,
    without `normalized`, of its accumulated column sums, Eq. 7) picks the
    plain version's salient set, up to tokens within the tolerance of the
    split boundary: a column sum may move by 1e-4 + 1e-4 |sum| (the
    kernel's tolerance), so a token whose saliency and the boundary's lie
    within their two tolerances of each other may swap sides."""
    n_hi = ccfg.n_salient(prompt)
    s_k, nnz = attention.probe_saliency_from_colsum(col, probe, prompt)
    s_r, _ = attention.probe_saliency_from_colsum(col_ref, probe, prompt)
    if not normalized:
        s_k, s_r, nnz = col, col_ref, torch.ones_like(nnz)
    tol = (1e-4 + 1e-4 * col_ref.abs()) / nnz.clamp_min(1.0)
    idx_k, _ = sal.salient_split(s_k, n_hi)
    idx_r, _ = sal.salient_split(s_r, n_hi)
    n_diff = 0
    for row in range(col.shape[0]):
        ks, rs = set(idx_k[row].tolist()), set(idx_r[row].tolist())
        order = torch.argsort(s_r[row], descending=True, stable=True)
        edge = int(order[n_hi - 1])  # the plain version's last salient token
        for t in ks ^ rs:
            gap = abs(s_r[row, t].item() - s_r[row, edge].item())
            check(gap <= tol[row, t].item() + tol[row, edge].item(),
                  f"probe_colsum: token {t} of row {row} changes saliency side {gap:.3g} away "
                  "from the split boundary")
        n_diff += len(ks ^ rs) // 2
    log(f"probe_colsum: salient sets ({n_hi} of {prompt} tokens per row, "
        f"{'normalized' if normalized else 'accumulated'}) agree with the plain version's up "
        f"to {n_diff} swapped pairs, all within tolerance of the boundary")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# phase 3's MLA rows and phase 4j: DeepSeek-V2-Lite (MLA + fine-grained MoE)
MLA_ARCH = "deepseek-v2-lite-16b"
DEEPSEEK_LAYERS = 5    # phase 4j: the MLA prefix layer and the first 4 MoE layers of 27 (9 before phase 4o)


def _sdpa_timed(torch, q, k, v):
    """(ms, backend name) of the first SDPA backend that takes q/k/v: flash,
    memory-efficient, cuDNN, then the math fallback."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fn(backend=backend):
            with sdpa_kernel(backend):
                return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return time_ms(torch, fn), backend.name
    fail("no SDPA backend takes the MLA shapes")


def mla_kernels(torch, np, dev, rows, record, ccfg, prompt, max_new):
    """Phase 3's rows at DeepSeek-V2-Lite's shapes: flash_fwd at (q/k 192, v
    128), 16 heads of one kv head each (MLA's materialized rope-key
    broadcast), batch 4 and 1; probe_colsum at d 192 over the probe rows of
    select_probes(prompt); cst_quant's hi and lo stores of one MLA layer's
    lockstep prefill (one kv head: K the 64-wide rope key, V the 512-wide
    latent), static and through an eff table."""
    from repro_torch import configs
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import saliency as sal
    from repro_torch.kernels.cst_quant import kernel as cst_kernel
    from repro_torch.kernels.cst_quant import ref as cst_ref
    from repro_torch.kernels.probe_flash import kernel as pf_kernel
    from repro_torch.kernels.probe_flash import ops as pf_ops
    from repro_torch.kernels.probe_flash import ref as pf_ref
    from repro_torch.models import attention

    cfg = configs.get_arch(MLA_ARCH)
    h, p, r = cfg.n_heads, cfg.rope_head_dim, cfg.kv_lora_rank
    dqk, dv = cfg.nope_head_dim + p, cfg.v_head_dim
    gen = torch.Generator(device=dev).manual_seed(24)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    pairs = prompt * (prompt + 1) // 2
    q, k, v = randn(4, h, prompt, dqk), randn(4, h, prompt, dqk), randn(4, h, prompt, dv)
    extra = {}
    for b in (4, 1):
        qb, kb, vb = q[:b].contiguous(), k[:b].contiguous(), v[:b].contiguous()
        out, lse = pf_kernel.flash_fwd(qb, kb, vb)
        ref_out, ref_lse = pf_ref.flash_fwd_ref(qb, kb, vb)
        torch.cuda.synchronize()
        check(out.shape == (b, h, prompt, dv), f"flash_fwd mla: output shape {tuple(out.shape)}")
        err = (out.float() - ref_out.float()).abs().max().item()
        tol = 2 ** -7 * ref_out.float().abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        check(err_lse <= 1e-4, f"flash_fwd mla batch {b}: lse error {err_lse:.3g} exceeds 1e-4")
        fn = lambda qb=qb, kb=kb, vb=vb: pf_kernel.flash_fwd(qb, kb, vb)  # noqa: E731
        lib, backend = _sdpa_timed(torch, qb, kb, vb)
        bnd = bound_ms(2.0 * b * h * pairs * (dqk + dv), nbytes(qb, kb, vb, out, lse))
        if b == 4:
            record("flash_fwd@mla", "src/repro_torch/kernels/probe_flash/csrc/probe_flash.cu",
                   "src/repro/kernels/probe_flash/kernel.py:100", err, tol, fn,
                   time_ms(torch, fn), time_ms(torch, lambda: pf_ref.flash_fwd_ref(qb, kb, vb),
                                               iters=5), bnd, lib)
            rows["flash_fwd@mla"].update(sdpa_backend=backend, shape=[b, h, prompt, dqk, dv])
            q4, lse4 = qb, lse
        else:
            check(err <= tol, f"flash_fwd mla batch 1: max abs error {err:.3g} exceeds {tol:.3g}")
            extra = {"ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn),
                     "library_ms": lib, "sdpa_backend": backend, "max_abs_err": err,
                     "bound_ms": bnd[0]}
            rows["flash_fwd@mla"]["batch1"] = extra
            log(f"flash_fwd@mla batch 1: kernel {extra['ms']:.4f} ms (device "
                f"{extra['device_ms']:.4f} ms), SDPA ({backend}) {lib:.4f} ms, bound "
                f"{bnd[0]:.4f} ms")
    log(f"flash_fwd@mla: SDPA backend at batch 4: {rows['flash_fwd@mla']['sdpa_backend']}")

    # probe_colsum at d 192: the probe rows of select_probes(prompt) (repeats -> -1)
    probe = sal.select_probes(prompt)
    pos = pf_ops.unique_probe_rows(probe.positions.to(dev))
    safe = pos.clamp(0, prompt - 1).long()
    args = (q4[:, :, safe].contiguous(), lse4[:, :, safe].contiguous(),
            pos[None].expand(4, -1).contiguous(), k)
    col = pf_kernel.probe_colsum(*args, lq=prompt)
    col_ref = pf_ref.probe_colsum_ref(*args, lq=prompt)
    again = pf_kernel.probe_colsum(*args, lq=prompt)
    torch.cuda.synchronize()
    check(torch.equal(col, again), "probe_colsum@mla: two calls on the same inputs differ")
    _salient_sets_agree(torch, sal, attention, ccfg, probe, col, col_ref, prompt)
    fn = lambda: pf_kernel.probe_colsum(*args, lq=prompt)  # noqa: E731
    valid_pairs = int((pos[pos >= 0] + 1).sum())
    pf_kernel.COLSUM.heads_per_cta = None
    record("probe_colsum@mla", "src/repro_torch/kernels/probe_flash/csrc/probe_flash.cu",
           "src/repro/kernels/probe_flash/kernel.py:177", (col - col_ref).abs().max().item(),
           1e-4, fn, time_ms(torch, fn),
           time_ms(torch, lambda: pf_ref.probe_colsum_ref(*args, lq=prompt), iters=5),
           bound_ms(2.0 * 4 * h * valid_pairs * dqk, nbytes(*args, col)))
    hpc = pf_kernel.COLSUM.heads_per_cta
    check(isinstance(hpc, int) and hpc >= 1,
          f"probe_colsum@mla: the launch recorded no heads per CTA ({hpc!r})")
    rows["probe_colsum@mla"]["heads_per_cta"] = hpc
    del q, k, v, out, lse, ref_out, ref_lse, args, col, col_ref, again, q4, lse4

    # cst_quant: one MLA layer's lockstep prefill stores, K the rope key, V the latent
    s_hi, s_lo, _ = kvc.capacities(ccfg, prompt + max_new)
    kpe, lat = randn(4, 1, prompt, p), randn(4, 1, prompt, r)
    sal_idx, reg_idx = sal.salient_split(torch.rand((4, prompt), generator=gen, device=dev),
                                         ccfg.n_salient(prompt))
    timed = {}
    for name, bits, cap, sidx in (("hi", ccfg.high_bits, s_hi, sal_idx),
                                  ("lo", ccfg.low_bits, s_lo, reg_idx)):
        sidx = torch.nn.functional.pad(sidx, (0, cap - sidx.shape[1]), value=-1)
        eff = torch.randint(1, bits + 1, (4, 1, 2), generator=gen, device=dev).float()
        eff.view(-1)[::3] = float(bits)
        for e in (None, eff):
            got = cst_kernel.quantize_store(kpe, lat, sidx, bits, eff=e)
            want = cst_ref.quantize_store_ref(kpe, lat, sidx, bits, e)
            torch.cuda.synchronize()
            for part, a, w in zip(("K codes", "K scale", "K zero", "V codes", "V scale",
                                   "V zero", "V channel scale"), got, want):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"cst_quant@mla {name} store (eff {e is not None}): {part} differ from "
                      "the plain version")
        n_live = int((sidx >= 0).sum())
        # the eff store's bound: the same bytes and its eff table, read once
        timed[name] = (bits, sidx, eff, bound_ms(0.0, n_live * (p + r) * 2 + nbytes(sidx, *got)),
                       bound_ms(0.0, n_live * (p + r) * 2 + nbytes(sidx, *got, eff)))
    bits, sidx, eff, bnd, ebnd = timed["lo"]
    fn = lambda: cst_kernel.quantize_store(kpe, lat, sidx, bits)  # noqa: E731
    cst_kernel.KERNEL.split = None
    record("cst_quant@mla", "src/repro_torch/kernels/cst_quant/csrc/cst_quant.cu",
           "src/repro/kernels/cst_quant/kernel.py:66", 0.0, 0.0, fn, time_ms(torch, fn, iters=50),
           time_ms(torch, lambda: cst_ref.quantize_store_ref(kpe, lat, sidx, bits)), bnd)
    split = cst_kernel.KERNEL.split
    check(isinstance(split, int) and split >= 1,
          f"cst_quant@mla: the launch recorded no split ({split!r})")
    fe = lambda: cst_kernel.quantize_store(kpe, lat, sidx, bits, eff=eff)  # noqa: E731
    hbits, hidx, _, hbnd, _ = timed["hi"]
    fh = lambda: cst_kernel.quantize_store(kpe, lat, hidx, hbits)  # noqa: E731
    rows["cst_quant@mla"].update(
        eff={"ms": time_ms(torch, fe, iters=50), "device_ms": device_ms(torch, fe),
             "bound_ms": ebnd[0], "plain_ms": time_ms(
                 torch, lambda: cst_ref.quantize_store_ref(kpe, lat, sidx, bits, eff))},
        hi={"ms": time_ms(torch, fh, iters=50), "device_ms": device_ms(torch, fh),
            "bound_ms": hbnd[0]}, split=split)
    log(f"cst_quant@mla: bitwise at the hi and lo stores, static and eff; lo store "
        f"({bits}-bit, {sidx.shape[1]} slots) with eff {rows['cst_quant@mla']['eff']['ms']:.4f} "
        f"ms (plain {rows['cst_quant@mla']['eff']['plain_ms']:.4f} ms, bound {ebnd[0]:.5f} ms); "
        f"hi store ({hbits}-bit, {hidx.shape[1]} slots) "
        f"{rows['cst_quant@mla']['hi']['ms']:.4f} ms (device "
        f"{rows['cst_quant@mla']['hi']['device_ms']:.4f} ms, bound {hbnd[0]:.5f} ms); "
        f"{rows['cst_quant@mla']['split']} CTAs per slice")
    del kpe, lat


# phase 3's Jamba rows and phase 4k: Mamba2 and Jamba's hybrid group
MAMBA_ARCH, JAMBA_ARCH = "mamba2-2.7b", "jamba-v0.1-52b"
MAMBA_LAYERS = 8       # phase 4k: the first 8 of mamba2's 64 SSD layers (16 before phase 4o)


# phase 3's GQA rows, one model's attention layer each: (row tag, arch, g, d,
# seed, the kernels held there, probe_colsum's query heads per CTA at batch
# 4 over 1024 keys): g = 7 and g = 3 are the walk's G = 7 and G = 3
# instantiations, g = 1 at d 128 its G = 1 at D = 128
FIVE = ("cst_quant", "flash_fwd", "probe_colsum", "decode_qattn", "paged_qattn")
GQA_ROWS = (("jamba", JAMBA_ARCH, 4, 128, 25, FIVE, 4),
            ("qwen2", "qwen2-7b", 7, 128, 27, FIVE, 1),
            ("smollm", "smollm-360m", 3, 64, 28, FIVE, 1),
            ("yi34b", "yi-34b", 7, 128, 29, FIVE, 7),
            ("dsmoe", "deepseek-moe-16b", 1, 128, 30, FIVE, 1))


# the rows whose paged_qattn also walks fp16's raw pages (phase 4p's continuous
# fp16 runs: zipcache-paper-8b at Jamba's attention shape, qwen2-7b, smollm-360m)
FP16_PAGE_ROWS = ("jamba", "qwen2", "smollm")


def gqa_kernels(torch, np, dev, rows, record, ccfg, prompt, max_new, tag, arch, g, d, seed,
                which, want_hpc, fp16_pages=False):
    """Phase 3's rows `<kernel>@<tag>` at one model's attention layer (its
    query and kv heads: g query heads a kv head, head dim d), batch 4, prompt
    `prompt`, for the kernels in `which`: cst_quant's hi and lo stores of the
    lockstep prefill, bitwise; flash_fwd (out within 2**-7 of its largest
    value, LSE within 1e-5) with SDPA beside it; probe_colsum over the
    probe rows of select_probes(prompt), 1e-4, two calls bitwise, the
    salient set the plain version's, at `want_hpc` query heads per CTA;
    decode_qattn's layer after 40 appends
    (the walk's G = g, D = d instantiation) and paged_qattn's layer over a
    free-list cache, within one bf16 ulp of their largest value.  For phase
    4p, cst_quant's stores again through its eff instantiation under a
    downshift rung (bitwise, the lo store timed: the row's `eff`) and, with
    `fp16_pages`, paged_qattn's layer over fp16's raw pages (its `fp16_raw`).
    Each row records its launch sizing."""
    from repro_torch import configs
    from repro_torch.core import alloc as alloc_lib
    from repro_torch.core import backend as backend_lib
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import paged
    from repro_torch.core import saliency as sal
    from repro_torch.kernels.cst_quant import kernel as cst_kernel
    from repro_torch.kernels.cst_quant import ref as cst_ref
    from repro_torch.kernels.decode_qattn import kernel as dq_kernel
    from repro_torch.kernels.decode_qattn import ops as dq_ops
    from repro_torch.kernels.decode_qattn import ref as dq_ref
    from repro_torch.kernels.paged_qattn import kernel as pq_kernel
    from repro_torch.kernels.paged_qattn import ops as pq_ops
    from repro_torch.kernels.paged_qattn import ref as pq_ref
    from repro_torch.kernels.probe_flash import kernel as pf_kernel
    from repro_torch.kernels.probe_flash import ops as pf_ops
    from repro_torch.kernels.probe_flash import ref as pf_ref
    from repro_torch.models import attention

    cfg = configs.get_arch(arch)
    b, h, hk = 4, cfg.n_heads, cfg.n_kv_heads
    check(h // hk == g and cfg.hd == d, f"{arch}'s attention layer: g {h // hk}, d {cfg.hd}")
    max_len = prompt + max_new
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizing = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    src_pf = "src/repro_torch/kernels/probe_flash/csrc/probe_flash.cu"
    if "cst_quant" in which:
        # the lockstep prefill's hi and lo stores over hk kv heads
        s_hi, s_lo, _ = kvc.capacities(ccfg, max_len)
        kv_k, kv_v = randn(b, hk, prompt, d), randn(b, hk, prompt, d)
        sal_idx, reg_idx = sal.salient_split(torch.rand((b, prompt), generator=gen, device=dev),
                                             ccfg.n_salient(prompt))
        timed = {}
        for name, bits, cap, sidx in (("hi", ccfg.high_bits, s_hi, sal_idx),
                                      ("lo", ccfg.low_bits, s_lo, reg_idx)):
            sidx = torch.nn.functional.pad(sidx, (0, cap - sidx.shape[1]), value=-1)
            got = cst_kernel.quantize_store(kv_k, kv_v, sidx, bits)
            want = cst_ref.quantize_store_ref(kv_k, kv_v, sidx, bits)
            torch.cuda.synchronize()
            for part, a, w in zip(("K codes", "K scale", "K zero", "V codes", "V scale",
                                   "V zero", "V channel scale"), got, want):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"cst_quant@{tag} {name} store: {part} differ from the plain version")
            n_live = int((sidx >= 0).sum())
            timed[name] = (bits, sidx, bound_ms(0.0, n_live * hk * 2 * d * 2 + nbytes(sidx, *got)))
        bits, sidx, bnd = timed["lo"]
        fn = lambda: cst_kernel.quantize_store(kv_k, kv_v, sidx, bits)  # noqa: E731
        cst_kernel.KERNEL.split = None
        record(f"cst_quant@{tag}", "src/repro_torch/kernels/cst_quant/csrc/cst_quant.cu",
               "src/repro/kernels/cst_quant/kernel.py:66", 0.0, 0.0, fn,
               time_ms(torch, fn, iters=50),
               time_ms(torch, lambda: cst_ref.quantize_store_ref(kv_k, kv_v, sidx, bits)), bnd)
        split = cst_kernel.KERNEL.split
        check(isinstance(split, int) and split >= 1,
              f"cst_quant@{tag}: the launch recorded no split ({split!r})")
        hbits, hidx, hbnd = timed["hi"]
        fh = lambda: cst_kernel.quantize_store(kv_k, kv_v, hidx, hbits)  # noqa: E731
        row = rows[f"cst_quant@{tag}"]
        row.update(split=split, hi={"ms": time_ms(torch, fh, iters=50),
                                    "device_ms": device_ms(torch, fh), "bound_ms": hbnd[0]})
        # the eff instantiation under a downshift rung (phase 4p's ladder
        # folds): the lo store of slot i at max(1, bits - i), the hi store
        # at its container width, the map's K ceiling at 3 on the last kv
        # head; bitwise, one launch each
        for name, (bits_, sidx_, _) in timed.items():
            e = torch.full((b, hk, 2), float(bits_), device=dev)
            if name == "lo":
                e -= torch.arange(b, device=dev, dtype=torch.float32)[:, None, None]
            e[:, -1, 0] = torch.clamp(e[:, -1, 0], max=3.0)
            e.clamp_(min=1.0)
            before = cst_kernel.KERNEL.launches
            got = cst_kernel.quantize_store(kv_k, kv_v, sidx_, bits_, eff=e)
            want = cst_ref.quantize_store_ref(kv_k, kv_v, sidx_, bits_, e)
            torch.cuda.synchronize()
            check(cst_kernel.KERNEL.launches == before + 1,
                  f"cst_quant@{tag} eff: one launch per store")
            for part, a, w in zip(("K codes", "K scale", "K zero", "V codes", "V scale",
                                   "V zero", "V channel scale"), got, want):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"cst_quant@{tag} {name} store (eff, a rung): {part} differ from the plain "
                      "version")
            if name == "lo":
                fe = lambda: cst_kernel.quantize_store(  # noqa: E731
                    kv_k, kv_v, sidx_, bits_, eff=e)
                row["eff"] = {"max_abs_err": 0.0, "ms": time_ms(torch, fe, iters=50),
                              "device_ms": device_ms(torch, fe),
                              "plain_ms": time_ms(torch, lambda: cst_ref.quantize_store_ref(
                                  kv_k, kv_v, sidx_, bits_, e)),
                              "bound_ms": timed["lo"][2][0], "launches": 0}
        log(f"cst_quant@{tag}: bitwise at the hi and lo stores ({hk} kv heads), static and with "
            f"a rung's eff table; {split} CTAs per slice; hi store {row['hi']['ms']:.4f} ms "
            f"(device {row['hi']['device_ms']:.4f} ms, bound {hbnd[0]:.5f} ms); lo store with "
            f"eff {row['eff']['ms']:.4f} ms (device {row['eff']['device_ms']:.4f} ms)")
        sizing.append(f"cst_quant {split} CTAs per slice")
        del kv_k, kv_v

    if "flash_fwd" in which:
        # flash_fwd at g, with SDPA (GQA) beside it
        q, k, v = randn(b, h, prompt, d), randn(b, hk, prompt, d), randn(b, hk, prompt, d)
        out, lse = pf_kernel.flash_fwd(q, k, v)
        ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref_out.float()).abs().max().item()
        tol = 2 ** -7 * ref_out.float().abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        check(err_lse <= 1e-5, f"flash_fwd@{tag}: lse error {err_lse:.3g} exceeds 1e-5")
        fn = lambda: pf_kernel.flash_fwd(q, k, v)  # noqa: E731
        pairs = prompt * (prompt + 1) // 2
        record(f"flash_fwd@{tag}", src_pf, "src/repro/kernels/probe_flash/kernel.py:100", err,
               tol, fn, time_ms(torch, fn),
               time_ms(torch, lambda: pf_ref.flash_fwd_ref(q, k, v), iters=5),
               bound_ms(4.0 * b * h * pairs * d, nbytes(q, k, v, out, lse)),
               time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True)))
        rows[f"flash_fwd@{tag}"].update(lse_err=err_lse, shape=[b, h, hk, prompt, d])

        if "probe_colsum" in which:
            # the probe rows of select_probes(prompt) (repeats -> -1)
            probe = sal.select_probes(prompt)
            pos = pf_ops.unique_probe_rows(probe.positions.to(dev))
            safe = pos.clamp(0, prompt - 1).long()
            args = (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
                    pos[None].expand(b, -1).contiguous(), k)
            col = pf_kernel.probe_colsum(*args, lq=prompt)
            col_ref = pf_ref.probe_colsum_ref(*args, lq=prompt)
            again = pf_kernel.probe_colsum(*args, lq=prompt)
            torch.cuda.synchronize()
            check(torch.equal(col, again),
                  f"probe_colsum@{tag}: two calls on the same inputs differ")
            _salient_sets_agree(torch, sal, attention, ccfg, probe, col, col_ref, prompt)
            fn = lambda: pf_kernel.probe_colsum(*args, lq=prompt)  # noqa: E731
            valid_pairs = int((pos[pos >= 0] + 1).sum())
            pf_kernel.COLSUM.heads_per_cta = None
            record(f"probe_colsum@{tag}", src_pf, "src/repro/kernels/probe_flash/kernel.py:177",
                   (col - col_ref).abs().max().item(), 1e-4, fn, time_ms(torch, fn),
                   time_ms(torch, lambda: pf_ref.probe_colsum_ref(*args, lq=prompt)),
                   bound_ms(2.0 * b * h * valid_pairs * d, nbytes(*args, col)))
            hpc = pf_kernel.COLSUM.heads_per_cta
            check(hpc == want_hpc, f"probe_colsum@{tag}: the launch ran {hpc!r} heads per CTA, "
                                   f"not {want_hpc}")
            rows[f"probe_colsum@{tag}"]["heads_per_cta"] = hpc
            sizing.append(f"probe_colsum {hpc} heads per CTA")
            del args, col, col_ref, again
        del q, k, v, out, lse, ref_out, ref_lse

    qd = randn(b, h, d)
    if "decode_qattn" in which:
        # one decode layer over a prefill cache after 40 appends
        cache = kvc.compress_prefill(ccfg, randn(b, hk, prompt, d), randn(b, hk, prompt, d),
                                     torch.rand((b, prompt), generator=gen, device=dev), max_len)
        for _ in range(40):
            cache = kvc.append_token(cache, randn(b, hk, d), randn(b, hk, d))
        dsegs = dq_ops.mixed_segments(cache)
        out_d = dq_kernel.qattn_mixed_layer(qd, dsegs)
        want_d = dq_ref.mixed_layer_ref(qd, dsegs)
        torch.cuda.synchronize()
        err = (out_d.float() - want_d.float()).abs().max().item()
        tol = 2 ** -7 * max(want_d.float().abs().max().item(), 1.0)
        fn = lambda: dq_kernel.qattn_mixed_layer(qd, dsegs)  # noqa: E731
        dq_kernel.KERNEL.splits = None
        record(f"decode_qattn@{tag}", "src/repro_torch/kernels/decode_qattn/csrc/decode_qattn.cu",
               "src/repro/kernels/decode_qattn/kernel.py:109", err, tol, fn,
               time_ms(torch, fn, iters=50),
               time_ms(torch, lambda: dq_ref.mixed_layer_ref(qd, dsegs)),
               mixed_layer_bound(dsegs, qd, out_d, hk))
        rows[f"decode_qattn@{tag}"]["splits"] = dq_kernel.KERNEL.splits
        sizing.append(f"decode_qattn {dq_kernel.KERNEL.splits} CTAs per (slot, kv head)")
        del cache, dsegs

    if "paged_qattn" in which:
        # one decode layer over a free-list cache (4 slots, page 64)
        pcache = _freelist_cache(torch, np, backend_lib, alloc_lib, paged, ccfg, dev, gen, hk, d,
                                 max_len, lengths=(1024, 700, 0, 333), n_append=40)
        segs = pq_ops.layer_segments(pcache)
        scale = 1.0 / d ** 0.5
        live = torch.tensor([True, True, False, True], device=dev)
        out_p, m_p, l_p, _, _ = pq_kernel.qattn_paged_layer(qd, segs, scale=scale)
        rout, rm, rl, _ = pq_ref.paged_layer_ref(qd, segs, scale=scale)
        torch.cuda.synchronize()
        err = (out_p[live].float() - rout[live].float()).abs().max().item()
        tol = 2 ** -7 * max(rout[live].float().abs().max().item(), 1.0)
        for part, a, w in (("m", m_p, rm), ("l", l_p, rl)):
            e = (a[live] - w[live]).abs().max().item()
            t = 1e-4 * max(w[live].abs().max().item(), 1.0)
            check(e <= t, f"paged_qattn@{tag} {part}: max abs error {e:.3g} exceeds {t:.3g}")
        check(bool((l_p[2] == 0).all()) and not bool(out_p[2].float().any()),
              f"paged_qattn@{tag}: the empty slot must give zeros")
        fn = lambda: pq_kernel.qattn_paged_layer(qd, segs, scale=scale)  # noqa: E731
        pq_kernel.KERNEL.splits = None
        record(f"paged_qattn@{tag}", "src/repro_torch/kernels/paged_qattn/csrc/paged_qattn.cu",
               "src/repro/kernels/paged_qattn/kernel.py:181", err, tol, fn,
               time_ms(torch, fn, iters=50),
               time_ms(torch, lambda: pq_ref.paged_layer_ref(qd, segs, scale=scale)),
               paged_layer_bound(torch, segs, qd))
        rows[f"paged_qattn@{tag}"]["splits"] = pq_kernel.KERNEL.splits
        sizing.append(f"paged_qattn {pq_kernel.KERNEL.splits} CTAs per (slot, kv head)")
        del pcache, segs
        if fp16_pages:
            # fp16's raw pages (phase 4p's continuous fp16 runs): the same
            # layer over a free-list cache with no quantized store
            from repro_torch.core.policy import CompressionConfig
            pcache = _freelist_cache(torch, np, backend_lib, alloc_lib, paged,
                                     CompressionConfig.fp16(), dev, gen, hk, d, max_len,
                                     lengths=(1024, 700, 0, 333), n_append=40)
            segs = pq_ops.layer_segments(pcache)
            out_p, _, _, _, _ = pq_kernel.qattn_paged_layer(qd, segs, scale=scale)
            rout, _, _, _ = pq_ref.paged_layer_ref(qd, segs, scale=scale)
            torch.cuda.synchronize()
            err = (out_p[live].float() - rout[live].float()).abs().max().item()
            tol = 2 ** -7 * max(rout[live].float().abs().max().item(), 1.0)
            check(err <= tol, f"paged_qattn@{tag} fp16 raw pages: max abs error {err:.3g} "
                              f"exceeds {tol:.3g}")
            fn = lambda: pq_kernel.qattn_paged_layer(qd, segs, scale=scale)  # noqa: E731
            pq_kernel.KERNEL.splits = None
            rows[f"paged_qattn@{tag}"]["fp16_raw"] = {
                "max_abs_err": err, "ms": time_ms(torch, fn, iters=50),
                "device_ms": device_ms(torch, fn),
                "plain_ms": time_ms(torch, lambda: pq_ref.paged_layer_ref(qd, segs, scale=scale)),
                "bound_ms": paged_layer_bound(torch, segs, qd)[0], "launches": 0,
                "splits": pq_kernel.KERNEL.splits}
            log(f"paged_qattn@{tag} over fp16's raw pages: max abs err {err:.3g} (tol {tol:.3g}); "
                f"{rows[f'paged_qattn@{tag}']['fp16_raw']['ms']:.4f} ms (device "
                f"{rows[f'paged_qattn@{tag}']['fp16_raw']['device_ms']:.4f} ms)")
            del pcache, segs
    log(f"{arch}'s attention shapes ({h} / {hk} heads, g {g}, d {d}): {'; '.join(sizing)}")
    del qd


# phase 3's seamless rows and phase 4l: seamless-m4t-medium (encoder-decoder)
SEAMLESS_ARCH = "seamless-m4t-medium"
SEAMLESS_SRC, SEAMLESS_DEC = 1024, 128     # source frames; the decoder prompt


def seamless_kernels(torch, np, dev, rows, record, ccfg, max_new):
    """Phase 3's rows at seamless-m4t-medium's decoder layer (16 query heads
    over 16 kv heads: g = 1, d 64), batch 4, a 128-token decoder prompt
    over 1024 source frames: cst_quant's self-cache stores (bf16 K / V) and
    cross-cache stores (the encoder memory's f32 K / V over 1024 tokens, f32
    parameters), bitwise; flash_fwd over the causal self-attention prefill
    (out within 2**-7 of its largest value, LSE within 1e-5) with SDPA
    beside it; probe_colsum over the probe rows of select_probes(128), 1e-4,
    two calls bitwise, the salient set the plain version's; decode_qattn's
    layer (the walk's G = 1, D = 64 instantiation) over the cross cache (f32
    store parameters beside the empty bf16 window) and over a self cache
    after 40 appends, each within one bf16 ulp of its largest value.  Each
    row records its launch sizing."""
    from repro_torch import configs
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import saliency as sal
    from repro_torch.kernels.cst_quant import kernel as cst_kernel
    from repro_torch.kernels.cst_quant import ref as cst_ref
    from repro_torch.kernels.decode_qattn import kernel as dq_kernel
    from repro_torch.kernels.decode_qattn import ops as dq_ops
    from repro_torch.kernels.decode_qattn import ref as dq_ref
    from repro_torch.kernels.probe_flash import kernel as pf_kernel
    from repro_torch.kernels.probe_flash import ops as pf_ops
    from repro_torch.kernels.probe_flash import ref as pf_ref
    from repro_torch.models import attention

    cfg = configs.get_arch(SEAMLESS_ARCH)
    b, h, hk, d = 4, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    check(h == hk == 16 and d == 64, f"seamless's attention: {h} / {hk} heads, d {d}")
    lq, src, self_len = SEAMLESS_DEC, SEAMLESS_SRC, SEAMLESS_DEC + max_new
    gen = torch.Generator(device=dev).manual_seed(26)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    src_pf = "src/repro_torch/kernels/probe_flash/csrc/probe_flash.cu"
    src_cst = "src/repro_torch/kernels/cst_quant/csrc/cst_quant.cu"
    # cst_quant: a self cache's stores (bf16, 128 tokens, capacity 256) and a
    # cross cache's (f32, 1024 tokens, capacity 1024)
    stores = {}
    for cache, dtype, l, max_len in (("self", torch.bfloat16, lq, self_len),
                                     ("cross", torch.float32, src, src)):
        s_hi, s_lo, _ = kvc.capacities(ccfg, max_len)
        kv_k, kv_v = randn(b, hk, l, d, dtype=dtype), randn(b, hk, l, d, dtype=dtype)
        sal_idx, reg_idx = sal.salient_split(torch.rand((b, l), generator=gen, device=dev),
                                             ccfg.n_salient(l))
        for name, bits, cap, sidx in (("hi", ccfg.high_bits, s_hi, sal_idx),
                                      ("lo", ccfg.low_bits, s_lo, reg_idx)):
            sidx = torch.nn.functional.pad(sidx, (0, cap - sidx.shape[1]), value=-1)
            got = cst_kernel.quantize_store(kv_k, kv_v, sidx, bits)
            want = cst_ref.quantize_store_ref(kv_k, kv_v, sidx, bits)
            torch.cuda.synchronize()
            for part, a, w in zip(("K codes", "K scale", "K zero", "V codes", "V scale",
                                   "V zero", "V channel scale"), got, want):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"cst_quant@seamless {cache} {name} store: {part} differ from the plain "
                      "version")
            check(got[1].dtype == dtype, f"cst_quant@seamless {cache}: parameters {got[1].dtype}")
            n_live = int((sidx >= 0).sum())
            stores[(cache, name)] = (kv_k, kv_v, bits, sidx, bound_ms(
                0.0, n_live * hk * 2 * d * kv_k.element_size() + nbytes(sidx, *got)))
    kv_k, kv_v, bits, sidx, bnd = stores[("cross", "lo")]
    fn = lambda: cst_kernel.quantize_store(kv_k, kv_v, sidx, bits)  # noqa: E731
    cst_kernel.KERNEL.split = None
    record("cst_quant@seamless", src_cst, "src/repro/kernels/cst_quant/kernel.py:66", 0.0, 0.0,
           fn, time_ms(torch, fn, iters=50),
           time_ms(torch, lambda: cst_ref.quantize_store_ref(kv_k, kv_v, sidx, bits)), bnd)
    row = rows["cst_quant@seamless"]
    row.update(timed="cross lo store (f32, 1024 tokens)", split=cst_kernel.KERNEL.split)
    check(isinstance(row["split"], int) and row["split"] >= 1,
          f"cst_quant@seamless: the launch recorded no split ({row['split']!r})")
    for key in (("cross", "hi"), ("self", "hi"), ("self", "lo")):
        k_, v_, bits_, sidx_, bnd_ = stores[key]
        f = lambda: cst_kernel.quantize_store(k_, v_, sidx_, bits_)  # noqa: E731
        row["_".join(key)] = {"ms": time_ms(torch, f, iters=50), "device_ms": device_ms(torch, f),
                              "bound_ms": bnd_[0]}
    log(f"cst_quant@seamless: bitwise at the self (bf16) and cross (f32) hi and lo stores; "
        f"{row['split']} CTAs per slice; " + ", ".join(
            f"{k} {row[k]['ms']:.4f} ms (device {row[k]['device_ms']:.4f} ms, bound "
            f"{row[k]['bound_ms']:.5f} ms)" for k in ("cross_hi", "self_hi", "self_lo")))
    del stores

    # flash_fwd over the decoder's causal self-attention prefill, SDPA beside it
    q, k, v = randn(b, h, lq, d), randn(b, hk, lq, d), randn(b, hk, lq, d)
    out, lse = pf_kernel.flash_fwd(q, k, v)
    ref_out, ref_lse = pf_ref.flash_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref_out.float()).abs().max().item()
    tol = 2 ** -7 * ref_out.float().abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    check(err_lse <= 1e-5, f"flash_fwd@seamless: lse error {err_lse:.3g} exceeds 1e-5")
    fn = lambda: pf_kernel.flash_fwd(q, k, v)  # noqa: E731
    pairs = lq * (lq + 1) // 2
    record("flash_fwd@seamless", src_pf, "src/repro/kernels/probe_flash/kernel.py:100", err, tol,
           fn, time_ms(torch, fn), time_ms(torch, lambda: pf_ref.flash_fwd_ref(q, k, v), iters=5),
           bound_ms(4.0 * b * h * pairs * d, nbytes(q, k, v, out, lse)),
           time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, is_causal=True)))
    rows["flash_fwd@seamless"].update(lse_err=err_lse, shape=[b, h, hk, lq, d])

    # probe_colsum: the probe rows of select_probes(128) (repeats -> -1)
    probe = sal.select_probes(lq)
    pos = pf_ops.unique_probe_rows(probe.positions.to(dev))
    safe = pos.clamp(0, lq - 1).long()
    args = (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
            pos[None].expand(b, -1).contiguous(), k)
    col = pf_kernel.probe_colsum(*args, lq=lq)
    col_ref = pf_ref.probe_colsum_ref(*args, lq=lq)
    again = pf_kernel.probe_colsum(*args, lq=lq)
    torch.cuda.synchronize()
    check(torch.equal(col, again), "probe_colsum@seamless: two calls on the same inputs differ")
    _salient_sets_agree(torch, sal, attention, ccfg, probe, col, col_ref, lq)
    fn = lambda: pf_kernel.probe_colsum(*args, lq=lq)  # noqa: E731
    valid_pairs = int((pos[pos >= 0] + 1).sum())
    pf_kernel.COLSUM.heads_per_cta = None
    record("probe_colsum@seamless", src_pf, "src/repro/kernels/probe_flash/kernel.py:177",
           (col - col_ref).abs().max().item(), 1e-4, fn, time_ms(torch, fn),
           time_ms(torch, lambda: pf_ref.probe_colsum_ref(*args, lq=lq)),
           bound_ms(2.0 * b * h * valid_pairs * d, nbytes(*args, col)))
    hpc = pf_kernel.COLSUM.heads_per_cta
    check(isinstance(hpc, int) and hpc >= 1,
          f"probe_colsum@seamless: the launch recorded no heads per CTA ({hpc!r})")
    rows["probe_colsum@seamless"]["heads_per_cta"] = hpc
    del q, k, v, out, lse, ref_out, ref_lse, args, col, col_ref, again

    # decode_qattn: the cross cache (f32 parameters, empty bf16 window), the
    # timed call, and a self cache after 40 appends
    caches = {
        "cross": kvc.compress_prefill(ccfg, randn(b, hk, src, d, dtype=torch.float32),
                                      randn(b, hk, src, d, dtype=torch.float32),
                                      torch.rand((b, src), generator=gen, device=dev), src,
                                      use_kernel=True),
        "self": kvc.compress_prefill(ccfg, randn(b, hk, lq, d), randn(b, hk, lq, d),
                                     torch.rand((b, lq), generator=gen, device=dev), self_len,
                                     use_kernel=True)}
    for _ in range(40):
        caches["self"] = kvc.append_token(caches["self"], randn(b, hk, d), randn(b, hk, d))
    qd = randn(b, h, d)
    timed = {}
    for name, cache in caches.items():
        check(dq_ops.kernel_supported(cache), f"decode_qattn@seamless: the {name} cache")
        dsegs = dq_ops.mixed_segments(cache)
        check([o["k_codes"].dtype for o in dsegs] == [torch.int8, torch.int8, torch.bfloat16]
              and cache.hi.k.scale.dtype == (torch.float32 if name == "cross" else torch.bfloat16),
              f"decode_qattn@seamless {name}: segments "
              f"{[(o['k_bits'], o['k_codes'].dtype) for o in dsegs]}, parameters "
              f"{cache.hi.k.scale.dtype}")
        before = dq_kernel.KERNEL.launches
        dq_kernel.KERNEL.splits = None
        out_d = dq_kernel.qattn_mixed_layer(qd, dsegs)
        splits = dq_kernel.KERNEL.splits
        want_d = dq_ref.mixed_layer_ref(qd, dsegs)
        torch.cuda.synchronize()
        check(dq_kernel.KERNEL.launches == before + 1, "decode_qattn@seamless: one launch per "
                                                       "layer")
        err = (out_d.float() - want_d.float()).abs().max().item()
        tol = 2 ** -7 * max(want_d.float().abs().max().item(), 1.0)
        check(err <= tol, f"decode_qattn@seamless {name}: max abs error {err:.3g} exceeds "
                          f"{tol:.3g}")
        fn = lambda dsegs=dsegs: dq_kernel.qattn_mixed_layer(qd, dsegs)  # noqa: E731
        timed[name] = (err, tol, fn, dsegs, mixed_layer_bound(dsegs, qd, out_d, hk), splits)
    err, tol, fn, dsegs, bnd, splits = timed["cross"]
    record("decode_qattn@seamless", "src/repro_torch/kernels/decode_qattn/csrc/decode_qattn.cu",
           "src/repro/kernels/decode_qattn/kernel.py:109", err, tol, fn,
           time_ms(torch, fn, iters=50), time_ms(torch, lambda: dq_ref.mixed_layer_ref(qd, dsegs)),
           bnd)
    err, tol, fn, dsegs, bnd, self_splits = timed["self"]
    rows["decode_qattn@seamless"].update(
        timed=f"cross cache ({src} source slots, f32 parameters)", splits=splits,
        self={"max_abs_err": err, "ms": time_ms(torch, fn, iters=50),
              "device_ms": device_ms(torch, fn), "bound_ms": bnd[0], "splits": self_splits,
              "slots": int(sum(o["pos"].shape[-1] for o in dsegs))})
    sr = rows["decode_qattn@seamless"]["self"]
    log(f"decode_qattn@seamless: cross cache {splits} splits per (row, kv head); self cache "
        f"({sr['slots']} slots, 40 appended) {sr['ms']:.4f} ms (device {sr['device_ms']:.4f} "
        f"ms, bound {sr['bound_ms']:.5f} ms, {self_splits} splits), max abs err "
        f"{sr['max_abs_err']:.3g}; probe_colsum {hpc} heads per CTA")
    del caches, timed, qd


class TimedLogits(StepLogits):
    """`StepLogits` that also times each call to a synchronize, by kind:
    a probe step (lockstep: its host flag; continuous: a staged probe row)
    or not."""

    def __init__(self, step, torch):
        super().__init__(step)
        self.torch, self.ms = torch, {True: [], False: []}

    def __call__(self, *args):
        probe = bool(args[3]) if len(args) == 4 else bool(args[2][1].any())
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().__call__(*args)
        self.torch.cuda.synchronize()
        self.ms[probe].append((time.perf_counter() - t0) * 1e3)
        return out


def deepseek(torch, np, dev, kernels, batch, cscfg, requests, budgets, rel_l2, yardstick, card,
             rows):
    """Phase 4j: DeepSeek-V2-Lite at full width over DEEPSEEK_LAYERS of its
    27 layers (the MLA prefix layer with a dense FFN, then MLA + MoE layers
    of 64 routed and 2 shared experts, top 6; cut from 27 to keep the script
    within its time limit) from a seeded generator, on both engines,
    captured and eager.  Returns the launch counts of each run."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import paged
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.models import attention, common, registry
    from repro_torch.serving import ContinuousEngine, Request, ServeConfig, ServingEngine
    from repro_torch.serving import probe_flag

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get_arch(MLA_ARCH), n_layers=DEEPSEEK_LAYERS)
    ccfg = CompressionConfig.zipcache()
    b, prompt = batch["tokens"].shape
    max_new = 128
    n_layers = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.materialize_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    log(f"deepseek: {MLA_ARCH} params {sum(t.numel() for t in leaves) / 1e9:.3f} B "
        f"({nbytes(*leaves) / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_probe = sum(probe_flag(i, ccfg.recompress_interval, 0) for i in range(max_new))
    n_fold = max_new // ccfg.recompress_interval
    scfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0)
    out_paths = {}

    def counts(path, want):
        got = {n: kern.launches for n, kern in kernels.items()}
        for name, n in want.items():
            check(got[name] == n, f"deepseek {path}: {name} {got[name]} launches, the path "
                                  f"implies {n}")
        got.update({f"{n}@mla": got[n] for n in ("flash_fwd", "probe_colsum", "cst_quant")})
        return got

    # -- lockstep: captured and eager, step by step ---------------------------
    lock = {}
    for capture in (True, False):
        eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        eng.generate(batch, max_new_tokens=2)   # warm-up (with capture: warm-up step, capture)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        rec = eng._decode = TimedLogits(eng._decode, torch)
        out = eng.generate(batch)
        eng._decode = rec.step
        want = {"flash_fwd": n_layers, "probe_colsum": n_layers,
                "cst_quant": 2 * n_layers * (1 + n_fold), "decode_qattn": 0, "paged_qattn": 0}
        out_paths[f"deepseek-lockstep-{'captured' if capture else 'eager'}"] = counts(
            f"lockstep (capture {capture})", want)
        tm = out["timings"]
        lock[capture] = dict(tokens=out["tokens"], decode_s=tm["decode_s"],
                             tok_s=tm["tok_per_s"], step_ms=np.median(rec.ms[False]),
                             probe_ms=np.median(rec.ms[True]), busy=None, ops=None,
                             peak=torch.cuda.max_memory_allocated(), rec=rec, step=rec.step)
        log(f"deepseek lockstep (capture {capture}): prefill {tm['prefill_s']:.3f} s, decode "
            f"{tm['decode_s']:.3f} s ({b} x {max_new} tokens, {n_probe} probe steps, {n_fold} "
            f"fold), median non-probe step {lock[capture]['step_ms']:.3f} ms, probe step "
            f"{lock[capture]['probe_ms']:.3f} ms (each to a synchronize)")
        if capture:
            tokens = out["tokens"]
            check(tokens.shape == (b, max_new) and bool(((tokens >= 0)
                                                         & (tokens < cfg.vocab)).all()),
                  f"deepseek lockstep: tokens {tokens.shape} out of shape or range")
            cb = eng.cache_bytes(eng.last_caches)
            raw = 2 * b * (prompt + max_new) * (cfg.rope_head_dim + cfg.kv_lora_rank) * n_layers
            log(f"deepseek lockstep: cache_bytes {cb}; packed {cb['packed_bytes']} B against "
                f"{raw} B of bf16 latent + rope-key streams at {prompt + max_new} tokens "
                f"({cb['packed_bytes'] / raw:.4f})")
            ctx = eng.ctx
        del eng
    summarize("deepseek lockstep", lock, torch, rel_l2, yardstick)
    del lock

    # the kernel route against the plain one where no router runs before it:
    # the attention output of layer 0 (the MLA prefix layer, dense FFN), to a
    # bf16 limit (2**-7 of its largest value, phase 3's flash_fwd limit)
    plain = ServingEngine(cfg, ccfg, scfg, params, device=dev, use_kernels=False)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    p0 = params["prefix"]["layer0"]
    with torch.inference_mode():
        h0 = common.rms_norm(common.embed_lookup(params["embed"], toks), p0["ln1"],
                             cfg.norm_eps)
        y0 = {run.use_kernels: attention.mla_forward(p0["attn"], h0, cfg, probe=run.probe,
                                                     q_block=run.q_block,
                                                     use_kernel=run.use_kernels)
              for run in (ctx, plain.ctx)}
    (yk, ak), (yp, ap) = y0[True], y0[False]
    err = (yk.float() - yp.float()).abs().max().item()
    tol = 2 ** -7 * yp.float().abs().max().item()
    err_s = (ak.saliency - ap.saliency).abs().max().item()
    log(f"deepseek layer 0 (before any router): attention output, kernel route vs plain: "
        f"max abs err {err:.4g} (tol {tol:.4g}), relative L2 {rel_l2(yk, yp):.4g}; "
        f"saliency max abs err {err_s:.4g}")
    check(bool(torch.isfinite(yk).all()), "deepseek layer 0: attention output not finite")
    check(err <= tol, f"deepseek layer 0: the kernel route's attention output is {err:.4g} "
                      f"from the plain route's, beyond {tol:.4g}")
    del y0, yk, yp, ak, ap, h0

    # the whole prefill's logits, logged beside phase 4's yardstick: past
    # layer 0 the router turns bf16 noise into other experts, so a bound here
    # would see only gross faults
    plain_blocked = attention.blocked_attention

    def sdpa_blocked(q, k, v, **kw):
        _, colsum = plain_blocked(q, k, v, **kw)
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True), colsum

    with torch.inference_mode():
        lk, _ = registry.prefill(params, {"tokens": toks}, cfg, ctx)
        lp, _ = registry.prefill(params, {"tokens": toks}, cfg, plain.ctx)
        attention.blocked_attention = sdpa_blocked
        try:
            lf, _ = registry.prefill(params, {"tokens": toks}, cfg, plain.ctx)
        finally:
            attention.blocked_attention = plain_blocked
    check(bool(torch.isfinite(lk).all()), "deepseek prefill logits not finite")
    log(f"deepseek prefill logits vs plain: relative L2 {rel_l2(lk, lp):.4g}, argmax equal "
        f"{float((lk.argmax(-1) == lp.argmax(-1)).float().mean()):.2f}; SDPA's attention "
        f"output in the plain route vs plain: {rel_l2(lf, lp):.4g} (phase 4's yardstick, "
        f"yi-6b: {yardstick:.4g})")
    del plain, lk, lp, lf

    # -- continuous: phase 4b's configuration and traffic ---------------------
    cont = {}
    for capture in (True, False):
        eng = ContinuousEngine(cfg, ccfg, cscfg, params, device=dev, capture=capture)
        rec = eng._decode_masked = TimedLogits(eng._decode_masked, torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        paged.GATHER_DECODES.launches = 0
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=r, max_new_tokens=int(m)))
                for r, m in zip(requests, budgets)]
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.pool_stats()
        want = {"flash_fwd": n_layers * st["admissions"],
                "probe_colsum": n_layers * st["admissions"],
                "cst_quant": 2 * n_layers * (st["admissions"] + st["folds"]),
                "decode_qattn": 0, "paged_qattn": 0}
        out_paths[f"deepseek-continuous-{'captured' if capture else 'eager'}"] = counts(
            f"continuous (capture {capture})", want)
        check(paged.GATHER_DECODES.launches == 0,
              "deepseek continuous: a decode took the GQA gather path")
        for i, r in enumerate(rids):
            check(res[r].finish_reason == "length" and len(res[r].tokens) == budgets[i],
                  f"deepseek continuous: {r} ended {res[r].finish_reason} with "
                  f"{len(res[r].tokens)} of {budgets[i]} tokens")
        eng._alloc.check_invariants()
        for seg in ("hi", "lo", "win"):
            check(st[seg]["used"] == 0 and st[seg]["free"] == st[seg]["pool_pages"],
                  f"deepseek continuous: {seg} pages not all returned: {st[seg]}")
        n_tok = sum(len(res[r].tokens) for r in rids)
        cont[capture] = dict(tokens=np.concatenate([res[r].tokens for r in rids]),
                             decode_s=wall, tok_s=n_tok / wall,
                             step_ms=np.median(rec.ms[False]), probe_ms=np.median(rec.ms[True]),
                             busy=None, ops=None, peak=torch.cuda.max_memory_allocated(),
                             rec=rec, step=rec.step)
        peaks = {k: f"{st[k]['peak_used']}/{st[k]['pool_pages']}" for k in ("hi", "lo", "win")}
        log(f"deepseek continuous (capture {capture}): {n_tok} tokens in {wall:.3f} s, "
            f"{eng._step_no} steps, {st['admissions']} admissions, {st['deferrals']} deferrals, "
            f"{st['folds']} slot folds; pages peak used / pool {peaks}")
        del eng, res
    summarize("deepseek continuous", cont, torch, rel_l2, yardstick)
    del cont

    # the expert weights one decode step reads: every expert runs its capacity slot(s)
    e_bytes = (cfg.n_layers - cfg.first_dense_layers) * cfg.n_experts * 3 * cfg.d_model \
        * cfg.moe_d_ff * 2
    log(f"deepseek: expert weights read per decode step {e_bytes / 1e9:.2f} GB, a bound of "
        f">= {e_bytes / PEAK_BYTES * 1e3:.2f} ms at {PEAK_BYTES / 1e12:.2f} TB/s ({card})")
    # -- phase 4p on this tree: the map, swap, the ladder, prefix dedup, sampling
    out_paths.update(tree_levers(torch, np, dev, kernels, rows, cfg, params,
                                 ("map", "levers", "prefix", "sampling"), card, rel_l2,
                                 yardstick))
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    log(f"deepseek: phase 4j took {time.perf_counter() - t_phase:.1f} s")
    return out_paths


class PathRuns:
    """What phases 4k and 4m share to drive one model on the engines under
    `ccfg` and the lockstep `scfg`: the launch counts held to each path and
    kept on `out_paths` (under the model's tag, and under each phase-3 row
    tag that `row_tags` gives it), a seeded materialization, the lockstep
    engine captured and eager, and one continuous run."""

    def __init__(self, torch, np, dev, kernels, ccfg, scfg, rel_l2, yardstick, card,
                 row_tags):
        from repro_torch.serving import probe_flag

        self.torch, self.np, self.dev, self.kernels = torch, np, dev, kernels
        self.ccfg, self.scfg, self.rel_l2, self.yardstick = ccfg, scfg, rel_l2, yardstick
        self.card, self.row_tags, self.out_paths = card, row_tags, {}
        self.n_probe = sum(probe_flag(i, ccfg.recompress_interval, 0)
                           for i in range(scfg.max_new_tokens))
        self.n_fold = scfg.max_new_tokens // ccfg.recompress_interval

    def zero_counts(self):
        from repro_torch.core import backend as backend_lib
        from repro_torch.core import paged

        for kern in self.kernels.values():
            kern.launches = 0
        backend_lib.PLAIN_DECODES.launches = paged.GATHER_DECODES.launches = 0

    def counts(self, tag, path, want, plain_decodes=None):
        """Hold the launches since `zero_counts` to `want`, the plain-route
        decodes to `plain_decodes` where it is given, and no decode to the
        gather path."""
        from repro_torch.core import backend as backend_lib
        from repro_torch.core import paged

        got = {n: kern.launches for n, kern in self.kernels.items()}
        for name, n in want.items():
            check(got[name] == n, f"{tag} {path}: {name} {got[name]} launches, the path "
                                  f"implies {n}")
        check(plain_decodes is None or backend_lib.PLAIN_DECODES.launches == plain_decodes,
              f"{tag} {path}: {backend_lib.PLAIN_DECODES.launches} decodes on the plain route, "
              f"the probe steps imply {plain_decodes}")
        check(paged.GATHER_DECODES.launches == 0, f"{tag} {path}: a decode took the gather path")
        for t in self.row_tags.get(tag, ()):
            got.update({f"{n}@{t}": got[n] for n in self.kernels})
        self.out_paths[f"{tag}-{path.replace(' ', '-')}"] = got

    def materialize(self, cfg):
        from repro_torch.models import registry

        torch = self.torch
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = registry.materialize_params(cfg, seed=0, device=self.dev)
        torch.cuda.synchronize()
        leaves = list(_leaves(params))
        n = sum(t.numel() for t in leaves)
        heads = f", {cfg.n_heads} / {cfg.n_kv_heads} heads, d {cfg.hd}" if cfg.n_heads else ""
        log(f"{cfg.name} ({cfg.n_layers} layers{heads}): params {n:,} ({nbytes(*leaves) / 1e9:.2f} "
            f"GB bf16) in {time.perf_counter() - t0:.1f} s; the config counts "
            f"{cfg.param_count():,}")
        return params

    def lockstep(self, tag, cfg, params, batch, want, plain_decodes=None, on_engine=None):
        """The lockstep engine captured and eager over `batch`, launches held
        to `want`, every step's logits bitwise across the two; `on_engine`
        takes the captured engine after its run (by default, its cache_bytes
        are logged).  Returns the captured engine's serving context."""
        from repro_torch.serving import ServingEngine

        torch, np = self.torch, self.np
        b, max_new = self.scfg.batch_size, self.scfg.max_new_tokens
        lock = {}
        for capture in (True, False):
            eng = ServingEngine(cfg, self.ccfg, self.scfg, params, device=self.dev,
                                capture=capture)
            eng.generate(batch, max_new_tokens=2)   # warm-up (with capture: warm-up step, capture)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.zero_counts()
            rec = eng._decode = TimedLogits(eng._decode, torch)
            out = eng.generate(batch)
            eng._decode = rec.step
            self.counts(tag, f"lockstep {'captured' if capture else 'eager'}", want,
                        plain_decodes)
            tm = out["timings"]
            lock[capture] = dict(tokens=out["tokens"], decode_s=tm["decode_s"],
                                 tok_s=tm["tok_per_s"], step_ms=np.median(rec.ms[False]),
                                 probe_ms=np.median(rec.ms[True]), busy=None, ops=None,
                                 peak=torch.cuda.max_memory_allocated(), rec=rec, step=rec.step)
            log(f"{tag} lockstep (capture {capture}): prefill {tm['prefill_s']:.3f} s, decode "
                f"{tm['decode_s']:.3f} s ({b} x {max_new} tokens, {self.n_probe} probe steps, "
                f"{self.n_fold} folds), median non-probe step {lock[capture]['step_ms']:.3f} ms, "
                f"probe step {lock[capture]['probe_ms']:.3f} ms (each to a synchronize), max "
                f"memory allocated {lock[capture]['peak'] / 2**30:.2f} GiB ({self.card})")
            if capture:
                tokens = out["tokens"]
                check(tokens.shape == (b, max_new) and bool(((tokens >= 0)
                                                             & (tokens < cfg.vocab)).all()),
                      f"{tag} lockstep: tokens {tokens.shape} out of shape or range")
                if on_engine is None:
                    log(f"{tag} lockstep: cache_bytes {eng.cache_bytes(eng.last_caches)}")
                else:
                    on_engine(eng)
                ctx = eng.ctx
            del eng
        summarize(f"{tag} lockstep", lock, self.torch, self.rel_l2, self.yardstick, bitwise=True)
        self.tokens = lock[True]["tokens"]
        return ctx

    def continuous(self, tag, cfg, params, requests, budgets, layout, capture):
        """One continuous run of `requests` under `layout`, each to its
        budget.  Returns the engine, the run, and the slots that each fold
        call took."""
        from repro_torch.serving import ContinuousEngine, Request

        torch = self.torch
        eng = ContinuousEngine(cfg, self.ccfg, layout, params, device=self.dev, capture=capture)
        rec = eng._decode_masked = TimedLogits(eng._decode_masked, torch)
        fold_calls, fold = [], eng._fold

        def counted_fold(due):
            fold_calls.append(len(due))
            return fold(due)

        eng._fold = counted_fold
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=r, max_new_tokens=int(m)))
                for r, m in zip(requests, budgets)]
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for i, r in enumerate(rids):
            check(res[r].finish_reason == "length" and len(res[r].tokens) == budgets[i],
                  f"{tag} continuous: {r} ended {res[r].finish_reason} with "
                  f"{len(res[r].tokens)} of {budgets[i]} tokens")
        n_tok = sum(len(res[r].tokens) for r in rids)
        run = dict(tokens=self.np.concatenate([res[r].tokens for r in rids]), decode_s=wall,
                   tok_s=n_tok / wall, step_ms=self.np.median(rec.ms[False]),
                   probe_ms=self.np.median(rec.ms[True]), busy=None, ops=None,
                   peak=torch.cuda.max_memory_allocated(), rec=rec, step=rec.step)
        log(f"{tag} continuous {layout.backend}/{layout.page_allocator} (capture {capture}): "
            f"{n_tok} tokens in {wall:.3f} s, {eng._step_no} steps, {eng._n_admissions} "
            f"admissions, {eng._n_folds} slot folds in {len(fold_calls)} fold calls "
            f"{fold_calls}, median non-probe step {run['step_ms']:.3f} ms, probe step "
            f"{run['probe_ms']:.3f} ms, max memory allocated {run['peak'] / 2**30:.2f} GiB "
            f"({self.card})")
        return eng, run, fold_calls


def hybrid(torch, np, dev, kernels, b, prompt, cscfg, rel_l2, yardstick, card, rows):
    """Phase 4k: mamba2-2.7b at full width over MAMBA_LAYERS of its 64 SSD
    layers (no attention layer; cut from 64 to keep the script within its
    time limit), then jamba-v0.1-52b at full width over one 8-layer group (layer
    4 GQA under ZipCache, the rest SSD, odd layers MoE; n_layers 32 -> 8:
    the 32 layers' 102.9 GB of bf16 weights do not fit one card), random
    bf16 weights from a seeded generator, after phase 4j's model is freed.
    Lockstep: phase 4's batch and prompts, 128 new tokens, captured against
    eager bit for bit.  mamba2 continuous: phase 4b's traffic on the mixed
    and the paged static layout (captured; the paged one eager too), tokens
    equal across the two, its free list refused.  Jamba continuous: phase
    4b's configuration and traffic, captured against eager bit for bit.
    Returns the launch counts of each run."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import backend as backend_lib
    from repro_torch.core import kvcache as kvc
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.models import attention, blocks, common, lm, registry
    from repro_torch.models.ssm import SSMState
    from repro_torch.serving import ContinuousEngine, ServeConfig, ServingEngine

    t_phase = time.perf_counter()
    ccfg = CompressionConfig.zipcache()
    max_new = 128
    scfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0)
    runs = PathRuns(torch, np, dev, kernels, ccfg, scfg, rel_l2, yardstick, card,
                    {"jamba": ("jamba",)})
    n_probe, n_fold, out_paths = runs.n_probe, runs.n_fold, runs.out_paths

    def split_bytes(tag, what, caches):
        cb = backend_lib.cache_bytes(caches)
        states = sum(kvc._nbytes(el) for el in registry.cache_elements(caches)
                     if isinstance(el, SSMState))
        log(f"{tag} {what}: cache_bytes {cb}: packed KV {cb['packed_bytes']} B, overhead "
            f"{cb['overhead_bytes']} B, of it SSM states {states} B")
        check(cb["overhead_bytes"] >= states > 0, f"{tag}: SSM states not counted as overhead")
        return cb

    def lockstep(tag, cfg, params, batch, want):
        return runs.lockstep(tag, cfg, params, batch, want, on_engine=lambda eng: split_bytes(
            tag, "lockstep", eng.last_caches))

    # -- mamba2-2.7b: no attention layer, so no kernel and no KV cache ----------
    cfg = dataclasses.replace(configs.get_arch(MAMBA_ARCH), n_layers=MAMBA_LAYERS)
    check(cfg.layer_kinds() == (("ssm", "none"),), "mamba2 should have SSD layers only")
    params = runs.materialize(cfg)
    batch_m, requests_m, budgets = traffic(np, cfg.vocab, b, prompt, max_new)
    none = {name: 0 for name in kernels}
    lock_bytes = {}
    runs.lockstep("mamba2", cfg, params, batch_m, none, on_engine=lambda eng: lock_bytes.update(
        plain=split_bytes("mamba2", "lockstep", eng.last_caches)))
    lock_tokens = runs.tokens
    chunk = cfg.ssm_chunk
    buckets = [min(-(-len(r) // cscfg.page_size) * cscfg.page_size, prompt) for r in requests_m]
    ragged = [n for n in buckets if n % chunk]
    log(f"mamba2 continuous: admission buckets {buckets}, {len(ragged)} of them not a multiple "
        f"of the {chunk}-token chunk (a ragged last chunk, which the reference's assert "
        "refuses)")
    check(bool(ragged), "phase 4b's traffic should give a ragged bucket")
    layouts = {"mixed": dataclasses.replace(cscfg, backend="mixed", paged_kernel=False,
                                            page_allocator="static", pool_fraction=1.0),
               "paged": dataclasses.replace(cscfg, page_allocator="static", pool_fraction=1.0)}
    cont, cont_bytes = {}, {}
    for name, capture in (("mixed", True), ("paged", True), ("paged", False)):
        eng, run, _ = runs.continuous("mamba2", cfg, params, requests_m, budgets, layouts[name],
                                      capture)
        runs.counts("mamba2", f"continuous {name} {'captured' if capture else 'eager'}", none)
        if name == "paged" and capture:
            split_bytes("mamba2", "continuous", eng.caches)
        cont[(name, capture)], cont_bytes[name] = run, backend_lib.cache_bytes(eng.caches)
        del eng
    check(np.array_equal(cont[("mixed", True)]["tokens"], cont[("paged", True)]["tokens"]),
          "mamba2 continuous: the mixed layout's tokens differ from the paged layout's")
    summarize("mamba2 continuous (paged static)", {True: cont[("paged", True)],
                                                   False: cont[("paged", False)]},
              torch, rel_l2, yardstick, bitwise=True)
    try:
        ContinuousEngine(cfg, ccfg, cscfg, params, device=dev)
        fail("mamba2 on the free list should be refused")
    except ValueError as e:
        check("no attention layer" in str(e), f"mamba2 free list: {e}")
        log(f"mamba2 on the free list refused: {e}")

    # -- phase 4p on this tree: the precision map, which has no KV element to
    # act on: the lockstep run (captured and eager) and the continuous runs
    # on both layouts (captured) take the runs' tokens and cache bytes
    # without the map, and every step's logits bitwise
    t_p = time.perf_counter()
    mruns = PathRuns(torch, np, dev, kernels, ccfg, dataclasses.replace(
        scfg, precision_map=PRECISION_MAP), rel_l2, yardstick, card, {})
    mruns.lockstep("4p/mamba2 map", cfg, params, batch_m, none, on_engine=lambda eng: lock_bytes
                   .update(mapped=backend_lib.cache_bytes(eng.last_caches)))
    check(np.array_equal(mruns.tokens, lock_tokens) and lock_bytes["mapped"] == lock_bytes["plain"],
          "4p/mamba2 map: the lockstep tokens or cache_bytes under the map differ from the run "
          "without it")
    for name in ("mixed", "paged"):
        eng, run, _ = mruns.continuous("4p/mamba2 map", cfg, params, requests_m, budgets,
                                       dataclasses.replace(layouts[name],
                                                           precision_map=PRECISION_MAP), True)
        mruns.counts("4p/mamba2", f"map continuous {name}", none)
        want = cont[(name, name == "mixed")]
        check(np.array_equal(run["tokens"], want["tokens"])
              and backend_lib.cache_bytes(eng.caches) == cont_bytes[name],
              f"4p/mamba2 map: the continuous {name} tokens or cache_bytes under the map differ "
              "from the run without it")
        got, ref = run["rec"].logits, want["rec"].logits
        check(len(got) == len(ref) > 0 and all(torch.equal(a, w) for a, w in zip(got, ref)),
              f"4p/mamba2 map: the continuous {name} steps under the map are not bitwise the "
              f"{'captured' if name == 'mixed' else 'eager'} steps without it")
        del eng
    out_paths.update(mruns.out_paths)
    P_SECONDS[MAMBA_ARCH] = time.perf_counter() - t_p
    log(f"phase 4p/{MAMBA_ARCH}: {P_SECONDS[MAMBA_ARCH]:.1f} s (map: lockstep captured and "
        f"eager, continuous mixed and paged static; tokens, cache_bytes and every step's "
        f"logits equal the runs without the map; {card})")
    del params, cont
    gc.collect()
    torch.cuda.empty_cache()

    # -- jamba-v0.1-52b, one 8-layer group: layer 4 runs the five kernels --------
    cfg = dataclasses.replace(configs.get_arch(JAMBA_ARCH), n_layers=8)
    kinds = cfg.layer_kinds()
    attn_at = [j for j, (m, _) in enumerate(kinds) if m == "attn"]
    check(attn_at == [cfg.attn_layer_offset] == [4], f"jamba's group kinds {kinds}")
    params = runs.materialize(cfg)
    n_attn = len(attn_at)
    batch, requests, budgets = traffic(np, cfg.vocab, b, prompt, max_new)
    ctx = lockstep("jamba", cfg, params, batch, {
        "flash_fwd": n_attn, "probe_colsum": n_attn, "cst_quant": 2 * n_attn * (1 + n_fold),
        "decode_qattn": n_attn * (max_new - n_probe), "paged_qattn": 0})

    # layer 4's attention output, kernel route against plain: layers 0-3
    # run no kernel, so layer 4 takes the same input on both routes
    plain = ServingEngine(cfg, ccfg, scfg, params, device=dev, use_kernels=False)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    with torch.inference_mode():
        x = common.embed_lookup(params["embed"], toks)
        for layer, mixer, ffn, where in lm.layers(cfg)[:4]:
            x, _, _ = blocks.apply_layer_full(lm.layer_params(params, where), x, cfg, mixer,
                                              ffn, plain.ctx, build_cache=False, layer=layer)
        p4 = lm.layer_params(params, lm.layers(cfg)[4][3])
        h4 = common.rms_norm(x, p4["ln1"], cfg.norm_eps)
        y4 = {run.use_kernels: attention.gqa_forward(p4["attn"], h4, cfg, probe=run.probe,
                                                     q_block=run.q_block,
                                                     use_kernel=run.use_kernels)
              for run in (ctx, plain.ctx)}
    (yk, ak), (yp, ap) = y4[True], y4[False]
    err = (yk.float() - yp.float()).abs().max().item()
    tol = 2 ** -7 * yp.float().abs().max().item()
    log(f"jamba layer 4 (after four SSM layers, no kernel before it): attention output, kernel "
        f"route vs plain: max abs err {err:.4g} (tol {tol:.4g}, largest "
        f"{yp.float().abs().max().item():.4g}), relative L2 {rel_l2(yk, yp):.4g}; saliency max "
        f"abs err {(ak.saliency - ap.saliency).abs().max().item():.4g}")
    check(bool(torch.isfinite(yk).all()), "jamba layer 4: attention output not finite")
    check(err <= tol, f"jamba layer 4: the kernel route's attention output is {err:.4g} from the "
                      f"plain route's, beyond {tol:.4g}")
    del plain, y4, yk, yp, ak, ap, h4, x

    cont = {}
    for capture in (True, False):
        eng, run, _ = runs.continuous("jamba", cfg, params, requests, budgets, cscfg, capture)
        st = eng.pool_stats()
        runs.counts("jamba", f"continuous {'captured' if capture else 'eager'}", {
            "flash_fwd": n_attn * st["admissions"], "probe_colsum": n_attn * st["admissions"],
            "cst_quant": 2 * n_attn * (st["admissions"] + st["folds"]), "decode_qattn": 0,
            "paged_qattn": n_attn * eng._step_no})
        eng._alloc.check_invariants()
        for seg in ("hi", "lo", "win"):
            check(st[seg]["used"] == 0 and st[seg]["free"] == st[seg]["pool_pages"],
                  f"jamba continuous: {seg} pages not all returned: {st[seg]}")
        peaks = {k: f"{st[k]['peak_used']}/{st[k]['pool_pages']}" for k in ("hi", "lo", "win")}
        got = out_paths[f"jamba-continuous-{'captured' if capture else 'eager'}"]
        log(f"jamba continuous (capture {capture}): launches "
            f"{ {n: got[n] for n in kernels} }; {st['admissions']} admissions, "
            f"{st['deferrals']} deferrals, {st['folds']} folds; pages peak used / pool {peaks}, "
            f"every page back ({ {k: st[k]['free'] for k in ('hi', 'lo', 'win')} } free)")
        if capture:
            split_bytes("jamba", "continuous", eng.caches)
        cont[capture] = run
        del eng
    summarize("jamba continuous", cont, torch, rel_l2, yardstick, bitwise=True)
    del cont, ctx
    # -- phase 4p on this tree: swap and the ladder under the map, prefix dedup
    out_paths.update(tree_levers(torch, np, dev, kernels, rows, cfg, params, ("levers", "prefix"),
                                 card, rel_l2, yardstick))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"hybrid: phase 4k took {time.perf_counter() - t_phase:.1f} s ({card})")
    return out_paths



class _CrossTap:
    """A cache backend that keeps the arguments and the result of every
    cross-cache compression (max_len = the source length) it passes on."""

    def __init__(self, be, src_len):
        self.be, self.src_len, self.cross = be, src_len, []

    def compress_prefill(self, k, v, saliency, max_len, **kw):
        el = self.be.compress_prefill(k, v, saliency, max_len, **kw)
        if max_len == self.src_len:
            self.cross.append((k, v, saliency, kw, el))
        return el

    def __getattr__(self, name):
        return getattr(self.be, name)


def seamless(torch, np, dev, kernels, rel_l2, yardstick, card):
    """Phase 4l: seamless-m4t-medium at full size (12 encoder and 12 decoder
    layers, d_model 1024, 16 / 16 heads, d 64, vocab 256206 padded to
    256256), random bf16 weights from a seeded generator, after phase 4k's
    models are freed; the lockstep engine only (the continuous engine
    refuses the encoder-decoder, as the reference's).  Batch 4, 1024 source
    frames of f32 embeddings, a 128-token decoder prompt, 128 new tokens at
    zipcache defaults (probe steps, one fold at step 100), captured against
    eager bit for bit.  Held: launches to the path; the prefill's and first
    decode step's logits on the kernel route against the plain route's;
    the encoder memory bitwise between the routes; every cross cache of the
    kernel route's prefill bitwise the plain route's store of the same
    K / V and saliency.  Returns the launch counts of each run."""
    from repro_torch import configs
    from repro_torch.core import backend as backend_lib
    from repro_torch.core import kvcache as kvc
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.models import encdec, registry
    from repro_torch.serving import ServeConfig, ServingEngine, probe_flag

    t_phase = time.perf_counter()
    cfg = configs.get_arch(SEAMLESS_ARCH)
    ccfg = CompressionConfig.zipcache()
    b, max_new, n_dec = 4, 128, cfg.n_layers
    n_probe = sum(probe_flag(i, ccfg.recompress_interval, 0) for i in range(max_new))
    n_fold = max_new // ccfg.recompress_interval
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.materialize_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params, p_bytes = sum(t.numel() for t in leaves), nbytes(*leaves)
    log(f"seamless: {cfg.n_enc_layers} encoder + {n_dec} decoder layers, params {n_params:,} "
        f"({p_bytes / 1e9:.3f} GB bf16) in {time.perf_counter() - t0:.1f} s")
    check(n_params == 978_909_184, f"seamless: {n_params} parameters, the schema has 978,909,184")
    rng = np.random.default_rng(26)
    batch = {"tokens": rng.integers(2, cfg.vocab, size=(b, SEAMLESS_DEC)).astype(np.int32),
             "frontend_embeds": rng.standard_normal(
                 (b, SEAMLESS_SRC, cfg.d_model)).astype(np.float32)}
    scfg = ServeConfig(batch_size=b, prompt_len=SEAMLESS_SRC, max_new_tokens=max_new, seed=0)
    counters = dict(kernels, plain_decodes=backend_lib.PLAIN_DECODES)
    # per prefill: flash_fwd and probe_colsum once per decoder layer, cst_quant
    # on the hi and lo stores of its self and cross caches; per fold cst_quant
    # on the self stores only; per non-probe step decode_qattn over both
    # caches of every layer; the plain route on probe steps only
    want = {"flash_fwd": n_dec, "probe_colsum": n_dec,
            "cst_quant": 4 * n_dec + 2 * n_dec * n_fold,
            "decode_qattn": 2 * n_dec * (max_new - n_probe), "paged_qattn": 0,
            "plain_decodes": 2 * n_dec * n_probe}
    log(f"seamless: launches the path implies {want} ({n_probe} probe steps, {n_fold} fold)")
    out_paths, lock = {}, {}
    for capture in (True, False):
        eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=capture)
        eng.generate(batch, max_new_tokens=2)   # warm-up (with capture: warm-up step, capture)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        rec = eng._decode = TimedLogits(eng._decode, torch)
        out = eng.generate(batch)
        eng._decode = rec.step
        rec.logits = [x[:, :cfg.vocab] for x in rec.logits]   # not the masked vocab padding
        got = {n: c.launches for n, c in counters.items()}
        path = f"seamless-lockstep-{'captured' if capture else 'eager'}"
        for name, n in want.items():
            check(got[name] == n, f"{path}: {name} {got[name]} launches, the path implies {n}")
        out_paths[path] = {**{n: got[n] for n in kernels},
                           **{f"{n}@seamless": got[n] for n in kernels}}
        tm = out["timings"]
        lock[capture] = dict(tokens=out["tokens"], decode_s=tm["decode_s"],
                             tok_s=tm["tok_per_s"], step_ms=np.median(rec.ms[False]),
                             probe_ms=np.median(rec.ms[True]), busy=None, ops=None,
                             peak=torch.cuda.max_memory_allocated(), rec=rec, step=rec.step)
        log(f"seamless lockstep (capture {capture}, {card}): prefill {tm['prefill_s']:.3f} s, "
            f"decode {tm['decode_s']:.3f} s ({b} x {max_new} tokens), median non-probe step "
            f"{lock[capture]['step_ms']:.3f} ms, probe step {lock[capture]['probe_ms']:.3f} ms "
            f"(each to a synchronize), max memory {lock[capture]['peak'] / 2**30:.3f} GiB; "
            f"launches {got}")
        if capture:
            tokens = out["tokens"]
            check(tokens.shape == (b, max_new) and bool(((tokens >= 0)
                                                         & (tokens < cfg.vocab)).all()),
                  f"seamless lockstep: tokens {tokens.shape} out of shape or range")
            groups = eng.last_caches["groups"]
            split = {k: backend_lib.cache_bytes([gc[k] for gc in groups]) for k in ("self", "cross")}
            total = backend_lib.cache_bytes(eng.last_caches)
            check(total["total_bytes"] == sum(x["total_bytes"] for x in split.values()),
                  "seamless: cache_bytes is not the self and the cross caches' sum")
            check(all(gc["cross"].hi.k.scale.dtype == torch.float32 for gc in groups),
                  "seamless: the cross stores' parameters are not f32")
            log(f"seamless cache_bytes after the run: {total}; self caches {split['self']}; "
                f"cross caches {split['cross']} (bf16 K / V of the source would take "
                f"{2 * b * cfg.n_kv_heads * SEAMLESS_SRC * cfg.hd * 2 * n_dec} B)")
            ctx = eng.ctx
        del eng
    summarize("seamless lockstep", lock, torch, rel_l2, yardstick, bitwise=True)

    # the kernel route against the plain route: encoder memory, prefill and
    # first decode step's logits, and the cross caches' stores
    plain = ServingEngine(cfg, ccfg, scfg, params, device=dev, use_kernels=False)
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    tap = _CrossTap(ctx.backend, SEAMLESS_SRC)
    with torch.inference_mode():
        walls = {}
        for what in ("encoder", "prefill"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "encoder":
                enc = encdec.encode(params, inputs["frontend_embeds"], cfg, ctx)
            else:
                ctx.backend = tap
                try:
                    lk, ck = registry.prefill(params, inputs, cfg, ctx)
                finally:
                    ctx.backend = tap.be
            torch.cuda.synchronize()
            walls[what] = time.perf_counter() - t0
        enc_p = encdec.encode(params, inputs["frontend_embeds"], cfg, plain.ctx)
        lp, cp = registry.prefill(params, inputs, cfg, plain.ctx)
        tok0 = torch.argmax(lp, dim=-1).to(torch.int32)
        check(not probe_flag(0, ccfg.recompress_interval, 0), "decode step 0 should not probe")
        dk, _ = registry.decode_step(params, tok0, cp, cfg, ctx, False)
        dp, _ = registry.decode_step(params, tok0, cp, cfg, plain.ctx, False)
        check(enc.dtype == torch.float32 and torch.equal(enc, enc_p),
              "seamless: the encoder memory differs between the routes")
        check(len(tap.cross) == n_dec, f"seamless: {len(tap.cross)} cross compressions")
        n_same = 0
        for i, ((k_, v_, s_, kw, el), gc_p) in enumerate(zip(tap.cross, cp["groups"])):
            check(k_.dtype == torch.float32, f"seamless layer {i}: cross K {k_.dtype}")
            want_el = kvc.compress_prefill(ccfg, k_, v_, s_, SEAMLESS_SRC, use_kernel=False, **kw)
            for a, w in zip(kvc.tree_leaves(el), kvc.tree_leaves(want_el)):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"seamless layer {i}: the kernel route's cross cache differs from the "
                      "plain route's store of the same K / V and saliency")
            check(all(torch.equal(a, w) for a, w in zip(kvc.tree_leaves(el),
                                                        kvc.tree_leaves(ck["groups"][i]["cross"]))),
                  f"seamless layer {i}: the tapped cross cache is not the prefill's")
            n_same += all(torch.equal(a, w) for a, w in zip(kvc.tree_leaves(el),
                                                            kvc.tree_leaves(gc_p["cross"])))
    log(f"seamless prefill walls ({card}): encoder {walls['encoder'] * 1e3:.1f} ms, decoder "
        f"{(walls['prefill'] - walls['encoder']) * 1e3:.1f} ms (whole prefill "
        f"{walls['prefill'] * 1e3:.1f} ms, {b} x {SEAMLESS_SRC} frames, {SEAMLESS_DEC}-token "
        f"decoder prompt)")
    log(f"seamless: the encoder memory bitwise between the routes; every layer's cross cache on "
        f"the kernel route bitwise the plain route's store of the same K / V and saliency; "
        f"{n_same} of {n_dec} layers' cross caches bitwise the plain route's prefill (the cross "
        "queries follow the decoder's self-attention, whose route moves bf16 roundings)")
    for what, a, w in (("prefill", lk, lp), ("first decode step", dk, dp)):
        # the real vocabulary: the padding columns hold -1e30 on both routes
        a, w = a[:, :cfg.vocab], w[:, :cfg.vocab]
        check(bool(torch.isfinite(a).all()), f"seamless {what} logits not finite")
        r = rel_l2(a, w)
        log(f"seamless {what} logits vs plain: relative L2 {r:.4g} (tolerance 0.2; yardstick "
            f"{yardstick:.4g}), argmax equal {bool((a.argmax(-1) == w.argmax(-1)).all())}")
        check(r <= 0.2, f"seamless {what} logits differ from the plain path beyond tolerance")
    del params, plain, lock, tap, enc, enc_p, ck, cp, lk, lp, dk, dp, ctx, inputs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"seamless: phase 4l took {time.perf_counter() - t_phase:.1f} s, max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    return out_paths


# phase 4m: the remaining configs at full size (each model's row tags in phase 3)
REMAINING_NEW, REMAINING_INTERVAL = 32, 16   # decode budget; fold cadence (and window)
LAYERS_34B = 10   # phase 4m's llava-next-34b / yi-34b: 10 of 60 layers (20 before phase 4o)
LAYERS_4M = 8     # phase 4m's other models: their first 8 layers (full depth before phase 4o)
ROW_TAGS = {"qwen2-7b": ("qwen2",), "smollm-360m": ("smollm",),
            "llava-next-34b": ("yi34b",), "yi-34b": ("yi34b",),
            "deepseek-moe-16b": ("dsmoe",)}


def remaining_traffic(np, vocab, b, prompt):
    """Phase 4m's traffic: phase 4's packed batch (seed 0) and five requests
    for four slots (seed 2: prompts of 200 to `prompt` tokens, budgets of 20
    to REMAINING_NEW, so each slot passes the probe step at its token 15 and
    the fold at 16, and the fifth request waits for a slot), token ids in
    [2, vocab)."""
    from repro_torch.serving import pack_requests

    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=(prompt,)).astype(np.int32) for _ in range(b)]
    rng = np.random.default_rng(2)
    lengths = rng.integers(200, prompt + 1, size=5)
    budgets = rng.integers(20, REMAINING_NEW + 1, size=5)
    requests = [rng.integers(2, vocab, size=(int(n),)).astype(np.int32) for n in lengths]
    return {"tokens": pack_requests(prompts, b, prompt)}, requests, budgets


def remaining(torch, np, dev, kernels, rel_l2, yardstick, card, rows):
    """Phase 4m: the remaining configs at full width over their first
    LAYERS_4M layers (full depth before phase 4o; the 34B pair over its first
    LAYERS_34B), random
    bf16 weights from a seeded generator, after every earlier phase's
    weights and graph pools are released: qwen2-7b (28 / 4 heads, g = 7,
    QKV biases drawn at random), smollm-360m (15 / 5, g = 3, d 64, tied
    embeddings) and deepseek-moe-16b (16 / 16, g = 1, a dense prefix layer,
    64 routed + 2 shared experts, top 6) on both engines; zipcache-paper-8b
    (LLaMA3-8B's shape) on the lockstep engine; llava-next-34b (576 patch
    embeddings before 448 text tokens) on the lockstep engine and yi-34b on
    the continuous one over the same tensors, one materialization (the
    continuous engine refuses frontend archs).  zipcache with the window
    and the fold cadence at 16 over 32 new tokens (probe steps at 15 and 31,
    folds at 16 and 32).  Each engine captured and eager: every step's
    logits bitwise, tokens equal; launches held to the path, the plain
    route on lockstep probe steps only, no gather-path decode.  The kernel
    route's prefill and first decode step against the plain route's by
    relative L2 within phase 4's 0.2 (deepseek-moe: layer 0's attention output and the prefix layer's
    output, before any router, within 2**-7 of their largest value).
    Returns the launch counts of each run."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.kernels.probe_flash import kernel as pf_kernel
    from repro_torch.models import attention, blocks, common, registry
    from repro_torch.serving import ContinuousEngine, ServeConfig, ServingEngine
    from repro_torch.serving import probe_flag

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"remaining: {held / 2**30:.2f} GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB reserved after the earlier phases' weights and graph pools are released")
    check(held < 2 * 2**30, f"remaining: {held / 2**30:.2f} GiB still held by earlier phases")
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=REMAINING_INTERVAL,
                               recompress_interval=REMAINING_INTERVAL)
    b, prompt, max_new = 4, 1024, REMAINING_NEW
    check(not probe_flag(0, REMAINING_INTERVAL, 0),
          "phase 4m's first decode step must not be a probe step")
    scfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0)
    cscfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0,
                        backend="paged", page_size=64, page_allocator="freelist",
                        pool_fraction=0.75, paged_kernel=True, scheduler="fifo")
    runs = PathRuns(torch, np, dev, kernels, ccfg, scfg, rel_l2, yardstick, card, ROW_TAGS)
    n_probe, n_fold, walls = runs.n_probe, runs.n_fold, {}
    check(n_probe > 0 and n_fold > 0, "phase 4m's lockstep run must span a probe step and a fold")
    hpc_of = {tag: hpc for tag, *_, hpc in GQA_ROWS}

    def lockstep(tag, cfg, params, batch):
        """Both engines' runs at every layer's five kernels, the plain route
        on the probe steps only; the prefill's probe_colsum at the heads per
        CTA of the model's phase-3 row."""
        n = cfg.n_layers
        ctx = runs.lockstep(tag, cfg, params, batch, {
            "flash_fwd": n, "probe_colsum": n, "cst_quant": 2 * n * (1 + n_fold),
            "decode_qattn": n * (max_new - n_probe), "paged_qattn": 0}, n * n_probe)
        for t in ROW_TAGS.get(tag, ()):
            hpc = pf_kernel.COLSUM.heads_per_cta
            check(hpc == hpc_of[t], f"{tag} lockstep: probe_colsum ran {hpc} heads per CTA, "
                                    f"its row probe_colsum@{t} {hpc_of[t]}")
        return ctx

    def continuous(tag, cfg, params, requests, budgets):
        n = cfg.n_layers
        cont = {}
        for capture in (True, False):
            eng, run, fold_calls = runs.continuous(tag, cfg, params, requests, budgets, cscfg,
                                                   capture)
            st = eng.pool_stats()
            # one per-slot fold each while the due slots are at most half
            # the batch, else one full-batch fold
            n_stores = sum(k if 2 * k <= b else 1 for k in fold_calls)
            check(sum(fold_calls) == st["folds"], f"{tag} continuous: fold calls {fold_calls} "
                                                  f"against {st['folds']} slot folds")
            runs.counts(tag, f"continuous {'captured' if capture else 'eager'}", {
                "flash_fwd": n * st["admissions"], "probe_colsum": n * st["admissions"],
                "cst_quant": 2 * n * (st["admissions"] + n_stores), "decode_qattn": 0,
                "paged_qattn": n * eng._step_no}, 0)
            eng._alloc.check_invariants()
            for seg in ("hi", "lo", "win"):
                check(st[seg]["used"] == 0 and st[seg]["free"] == st[seg]["pool_pages"],
                      f"{tag} continuous: {seg} pages not all returned: {st[seg]}")
            check(st["folds"] >= 1 and len(run["rec"].ms[True]) > 0
                  and st["admissions"] == len(requests),
                  f"{tag} continuous: expected {len(requests)} admissions, a fold and a probe "
                  f"step: {st}")
            peaks = {k: f"{st[k]['peak_used']}/{st[k]['pool_pages']}" for k in ("hi", "lo", "win")}
            log(f"{tag} continuous (capture {capture}): {st['deferrals']} deferrals; pages peak "
                f"used / pool {peaks}")
            cont[capture] = run
            del eng
        summarize(f"{tag} continuous", cont, torch, rel_l2, yardstick, bitwise=True)

    plain_blocked = attention.blocked_attention

    def sdpa_blocked(q, k, v, **kw):
        _, colsum = plain_blocked(q, k, v, **kw)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), colsum

    def against_plain(tag, cfg, params, batch, ctx):
        """The kernel route's prefill and first decode step (from the plain
        route's cache) against the plain route's, by relative L2 within
        phase 4's 0.2.  Logged beside it: the model's own yardstick, the
        plain prefill once more with its attention output from SDPA (an
        exact kernel the port never calls), the bf16 noise that this depth
        and width turn into logits, and yi-6b's."""
        plain = ServingEngine(cfg, ccfg, scfg, params, device=dev, use_kernels=False)
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.inference_mode():
            lk, _ = registry.prefill(params, inputs, cfg, ctx)
            lp, cp = registry.prefill(params, inputs, cfg, plain.ctx)
            attention.blocked_attention = sdpa_blocked
            try:
                lf, _ = registry.prefill(params, inputs, cfg, plain.ctx)
            finally:
                attention.blocked_attention = plain_blocked
            tok0 = torch.argmax(lp, dim=-1).to(torch.int32)
            dk, _ = registry.decode_step(params, tok0, cp, cfg, ctx, False)
            dp, _ = registry.decode_step(params, tok0, cp, cfg, plain.ctx, False)
        own = rel_l2(lf[:, :cfg.vocab], lp[:, :cfg.vocab])
        for what, a, w in (("prefill", lk, lp), ("first decode step", dk, dp)):
            a, w = a[:, :cfg.vocab], w[:, :cfg.vocab]
            check(bool(torch.isfinite(a).all()), f"{tag} {what} logits not finite")
            r = rel_l2(a, w)
            log(f"{tag} {what} logits vs plain: relative L2 {r:.4g} (tolerance 0.2; its own "
                f"yardstick {own:.4g}, yi-6b's {yardstick:.4g}), argmax equal "
                f"{float((a.argmax(-1) == w.argmax(-1)).float().mean()):.2f}")
            check(r <= 0.2, f"{tag} {what} logits differ from the plain path beyond tolerance")

    def lap(tag):
        gc.collect()
        torch.cuda.empty_cache()
        walls[tag] = time.perf_counter() - t_phase - sum(walls.values())
        log(f"remaining: {tag} took {walls[tag]:.1f} s")

    # -- smollm-360m: g = 3, d 64, tied embeddings --------------------------------
    cfg = dataclasses.replace(configs.get_arch("smollm-360m"), n_layers=LAYERS_4M)
    check(cfg.tie_embeddings and "lm_head" not in registry.schema(cfg)
          and (cfg.n_heads // cfg.n_kv_heads, cfg.hd) == (3, 64), f"{cfg.name}'s shape")
    params = runs.materialize(cfg)
    batch, requests, budgets = remaining_traffic(np, cfg.vocab, b, prompt)
    ctx = lockstep(cfg.name, cfg, params, batch)
    against_plain(cfg.name, cfg, params, batch, ctx)
    continuous(cfg.name, cfg, params, requests, budgets)
    runs.out_paths.update(tree_levers(
        torch, np, dev, kernels, rows, cfg, params,
        ("levers", "prefix", "sampling", "baselines-continuous"), card, rel_l2, yardstick))
    del params, ctx
    lap(cfg.name)

    # -- qwen2-7b: g = 7, QKV biases (zeros at initialization: drawn here) ------
    cfg = dataclasses.replace(configs.get_arch("qwen2-7b"), n_layers=LAYERS_4M)
    check(cfg.qkv_bias and (cfg.n_heads // cfg.n_kv_heads, cfg.hd) == (7, 128),
          f"{cfg.name}'s shape")
    params = runs.materialize(cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    attn_p = params["groups"]["sub0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn_p[name].copy_(torch.randn(attn_p[name].shape, generator=gen, device=dev) * 0.5)
    batch, requests, budgets = remaining_traffic(np, cfg.vocab, b, prompt)
    ctx = lockstep(cfg.name, cfg, params, batch)
    against_plain(cfg.name, cfg, params, batch, ctx)
    continuous(cfg.name, cfg, params, requests, budgets)
    runs.out_paths.update(tree_levers(
        torch, np, dev, kernels, rows, cfg, params,
        ("levers", "prefix", "sampling", "baselines-lockstep", "baselines-continuous"), card,
        rel_l2, yardstick))
    del params, ctx, attn_p
    lap(cfg.name)

    # -- zipcache-paper-8b: LLaMA3-8B's shape, g = 4, the lockstep engine --------
    cfg = dataclasses.replace(configs.get_arch("zipcache-paper-8b"), n_layers=LAYERS_4M)
    params = runs.materialize(cfg)
    batch, _, _ = remaining_traffic(np, cfg.vocab, b, prompt)
    ctx = lockstep(cfg.name, cfg, params, batch)
    against_plain(cfg.name, cfg, params, batch, ctx)
    runs.out_paths.update(tree_levers(
        torch, np, dev, kernels, rows, cfg, params,
        ("levers", "baselines-lockstep", "baselines-continuous"), card, rel_l2, yardstick))
    del params, ctx
    lap(cfg.name)

    # -- deepseek-moe-16b: g = 1 (the walk's G = 1 at D = 128), a dense prefix --
    cfg = dataclasses.replace(configs.get_arch("deepseek-moe-16b"), n_layers=LAYERS_4M)
    check(cfg.first_dense_layers == 1 and not cfg.mla and cfg.n_heads == cfg.n_kv_heads,
          f"{cfg.name}'s shape")
    params = runs.materialize(cfg)
    batch, requests, budgets = remaining_traffic(np, cfg.vocab, b, prompt)
    ctx = lockstep(cfg.name, cfg, params, batch)
    # before any router: layer 0's attention output and the prefix layer's
    # output, kernel route against plain, to 2**-7 of their largest value
    plain = ServingEngine(cfg, ccfg, scfg, params, device=dev, use_kernels=False)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    p0 = params["prefix"]["layer0"]
    with torch.inference_mode():
        x = common.embed_lookup(params["embed"], toks)
        h0 = common.rms_norm(x, p0["ln1"], cfg.norm_eps)
        outs = {}
        for run in (ctx, plain.ctx):
            y, _ = attention.gqa_forward(p0["attn"], h0, cfg, probe=run.probe, q_block=run.q_block,
                                         use_kernel=run.use_kernels)
            x1, _, _ = blocks.apply_layer_full(p0, x, cfg, "attn", "dense", run,
                                               build_cache=False)
            outs[run.use_kernels] = (y, x1)
        lk, ck = registry.prefill(params, {"tokens": toks}, cfg, ctx)
        lp, _ = registry.prefill(params, {"tokens": toks}, cfg, plain.ctx)
    check(len(ck["prefix"]) == 1 and len(registry.cache_elements(ck)) == cfg.n_layers,
          "deepseek-moe: the prefix layer's cache is not walked with the groups'")
    for i, what in enumerate(("layer 0's attention output", "the prefix layer's output")):
        a, w = outs[True][i].float(), outs[False][i].float()
        err, tol = (a - w).abs().max().item(), 2 ** -7 * w.abs().max().item()
        log(f"{cfg.name} {what} (before any router), kernel route vs plain: max abs err "
            f"{err:.4g} (tol {tol:.4g}), relative L2 {rel_l2(a, w):.4g}")
        check(bool(torch.isfinite(a).all()) and err <= tol,
              f"{cfg.name}: {what} on the kernel route is {err:.4g} from the plain route's")
    check(bool(torch.isfinite(lk).all()), f"{cfg.name} prefill logits not finite")
    log(f"{cfg.name} prefill logits vs plain: relative L2 {rel_l2(lk, lp):.4g} (not held: the "
        f"router turns bf16 noise into other experts; yardstick {yardstick:.4g})")
    del plain, outs, x, x1, h0, y, lk, lp, ck, p0
    continuous(cfg.name, cfg, params, requests, budgets)
    runs.out_paths.update(tree_levers(torch, np, dev, kernels, rows, cfg, params, ("levers",),
                                      card, rel_l2, yardstick))
    del params, ctx
    lap(cfg.name)

    # -- llava-next-34b (lockstep) and yi-34b (continuous): one materialization,
    # at full width over the first LAYERS_34B of their 60 layers --
    cfg = dataclasses.replace(configs.get_arch("llava-next-34b"), n_layers=LAYERS_34B)
    ycfg = dataclasses.replace(configs.get_arch("yi-34b"), n_layers=LAYERS_34B)
    check((cfg.n_heads // cfg.n_kv_heads, cfg.hd) == (7, 128) and cfg.n_frontend_tokens == 576,
          f"{cfg.name}'s shape")
    params = runs.materialize(cfg)
    free, total = torch.cuda.mem_get_info()
    log(f"{cfg.name}: {free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB with its weights "
        f"on the card")
    batch, requests, budgets = remaining_traffic(np, cfg.vocab, b, prompt)
    n_text = prompt - cfg.n_frontend_tokens
    rng = np.random.default_rng(4)
    batch = {"tokens": batch["tokens"][:, :n_text], "frontend_embeds": rng.standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    ctx = lockstep(cfg.name, cfg, params, batch)
    against_plain(cfg.name, cfg, params, batch, ctx)
    del ctx
    try:
        ContinuousEngine(cfg, ccfg, cscfg, params, device=dev)
        fail(f"{cfg.name} on the continuous engine should be refused")
    except NotImplementedError as e:
        log(f"{cfg.name} on the continuous engine refused: {e}")
    yparams = {k: v for k, v in params.items() if k != "vision_proj"}
    def same_shapes(tree, sch):
        if isinstance(sch, dict):
            return set(tree) == set(sch) and all(same_shapes(tree[k], sch[k]) for k in sch)
        return tuple(tree.shape) == tuple(sch.shape) and tree.dtype == sch.dtype

    check(same_shapes(yparams, registry.schema(ycfg)),
          f"{ycfg.name}: llava's tree without vision_proj is not yi-34b's")
    continuous(ycfg.name, ycfg, yparams, requests, budgets)
    del params, yparams
    lap("llava-next-34b / yi-34b")
    log(f"remaining: phase 4m took {time.perf_counter() - t_phase:.1f} s ({card}): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    return runs.out_paths


# ---- 4p. slice 18: the serving levers and baselines on every other tree ------
# phase 4f's prompts with budgets that fold at REMAINING_INTERVAL: the first
# four miss and register; 5-8 can hit as slots retire; #7 never folds
P_PREFIX_TRAFFIC = (("A", 32), ("C", 24), ("B", 20), ("D", 28),
                    ("A", 32), ("B", 30), ("A", 12), ("A", 30))
P_SAMPLED = {1: (0.7, 11), 3: (1.0, 12)}   # phase 4m's traffic: requests 1 and 3 sampled
P_SECONDS = {}   # each model's phase 4p seconds, logged in phases 4j, 4k and 4m


def tree_levers(torch, np, dev, kernels, rows, cfg, params, parts, card, rel_l2, yardstick):
    """Phase 4p on one model already resident at full width (its phase 4j,
    4k or 4m depth): the levers of `parts`, through phases 4e-4i's helpers
    with this model and phase 4m's fold cadence (window and fold every
    REMAINING_INTERVAL tokens):

      * "map": the lockstep engine under the conformance precision map on
        phase 4's batch, REMAINING_NEW tokens, captured and eager: every
        step bitwise, every store through cst_quant's eff instantiation;
      * "levers": phase 4e's swap-pressure and ladder-pressure runs under
        the map (2 slots, prompts of 1024, page 64), each captured and
        eager: every step bitwise, the first replays after a swap-in and
        after a downshift fold among them (no recompute run);
      * "prefix": phase 4f's prompts with budgets of 12-32
        (P_PREFIX_TRAFFIC), dedup off on an eager engine and on on a
        captured one (no third run): tokens equal, every step bitwise, the
        first replays after an alias admission and a CoW copy among them;
      * "sampling": phase 4m's five requests for four slots with requests
        1 and 3 sampled (P_SAMPLED), phase 4g's runs 1 (captured) and 3
        (captured, reverse submission order): every request's tokens equal;
        on a tree with routed experts runs 1 and 2 (eager) instead, since
        the reverse order puts requests in other rows and an expert's
        capacity then drops other rows' pairs;
      * "baselines-lockstep" / "baselines-continuous": phase 4i's policies
        (fp16, h2o, mikv, gear, kivi on the lockstep engine, captured and
        eager; fp16 and kivi on the continuous one) at the model's depth
        with the window and fold cadence at REMAINING_INTERVAL over
        REMAINING_NEW tokens (phase 4i's kernels at the baselines' shapes
        run at phase 3, at qwen2-7b's and zipcache-paper-8b's attention
        layer).

    Every run counts its launches from 0 and holds them to its path, the
    allocator's invariants after every step, every page and the host swap
    pool's bytes back.  Logs the seconds as `phase 4p/<model>`.  Returns the
    runs' launch counts."""
    import dataclasses

    from repro_torch.core.policy import CompressionConfig
    from repro_torch.kernels.cst_quant import kernel as cst_kernel
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServingEngine, probe_flag

    t0 = time.perf_counter()
    model = cfg.name
    tag = f"4p/{model}"
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=REMAINING_INTERVAL,
                               recompress_interval=REMAINING_INTERVAL)
    n_kv = sum(mixer != "ssm" for _, mixer, _, _ in lm.layers(cfg))
    walk = not cfg.mla
    b, prompt, max_new = 4, 1024, REMAINING_NEW
    batch, requests, budgets = remaining_traffic(np, cfg.vocab, b, prompt)
    cscfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0,
                        backend="paged", page_size=64, page_allocator="freelist",
                        pool_fraction=0.75, paged_kernel=True, scheduler="fifo")
    scfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new, seed=0)
    out = {}
    if "map" in parts:
        n_probe = sum(probe_flag(i, ccfg.recompress_interval, 0) for i in range(max_new))
        n_fold = max_new // ccfg.recompress_interval
        mscfg = dataclasses.replace(scfg, precision_map=PRECISION_MAP)
        runs = {}
        for capture in (True, False):
            eng = ServingEngine(cfg, ccfg, mscfg, params, device=dev, capture=capture)
            eng.generate(batch, max_new_tokens=2)   # warm-up (with capture: the capture)
            torch.cuda.synchronize()
            for kern in kernels.values():
                kern.launches = 0
            cst_kernel.EFF.launches = 0
            rec = eng._decode = StepLogits(eng._decode)
            res = eng.generate(batch)
            torch.cuda.synchronize()
            got = {n: kern.launches for n, kern in kernels.items()}
            want = {"flash_fwd": n_kv, "probe_colsum": n_kv,
                    "cst_quant": 2 * n_kv * (1 + n_fold),
                    "decode_qattn": n_kv * (max_new - n_probe) if walk else 0, "paged_qattn": 0}
            for name, n in want.items():
                check(got[name] == n, f"{tag} map (capture {capture}): {name} {got[name]} "
                                      f"launches, the path implies {n}")
            check(cst_kernel.EFF.launches == got["cst_quant"],
                  f"{tag} map: {cst_kernel.EFF.launches} of {got['cst_quant']} cst_quant "
                  "launches took the map's eff table")
            runs[capture] = dict(tokens=res["tokens"], rec=rec, launches=got,
                                 bytes=eng.cache_bytes(eng.last_caches))
            del eng
        cap, eager = runs[True], runs[False]
        check(cap["rec"].step.captures == 1 and cap["rec"].step.replays > 0,
              f"{tag} map: the captured step was built {cap['rec'].step.captures} times")
        check(bool((cap["tokens"] == eager["tokens"]).all()),
              f"{tag} map: captured tokens differ from eager")
        check(len(cap["rec"].logits) == len(eager["rec"].logits) == max_new,
              f"{tag} map: {len(cap['rec'].logits)} captured steps")
        for i, (a, w) in enumerate(zip(cap["rec"].logits, eager["rec"].logits)):
            check(torch.equal(a, w), f"{tag} map: step {i}'s logits are not bitwise the eager "
                                     "step's")
        log(f"{tag} map (lockstep, {PRECISION_MAP}): {max_new} captured steps bitwise the eager "
            f"steps, {n_probe} probe steps, {n_fold} folds; launches {cap['launches']}, every "
            f"cst_quant launch with the eff table; cache_bytes {cap['bytes']}")
        out[f"{tag} map"] = cap["launches"]
        del runs, cap, eager
    if "levers" in parts:
        out.update(levers(torch, np, cfg, ccfg, params, dev, kernels, n_kv, prompt,
                          tag=f"{tag} levers", eager=True, recompute=False))
    if "prefix" in parts:
        out.update(prefix_dedup(torch, np, cfg, ccfg, params, dev, kernels, n_kv, prompt, card,
                                rel_l2, traffic=P_PREFIX_TRAFFIC, max_new=max_new,
                                tag=f"{tag} prefix", off_eager=True))
    if "sampling" in parts:
        r = sampling(torch, np, cfg, ccfg, params, dev, kernels, n_kv, cscfg, requests, budgets,
                     None, None, card, sampled=P_SAMPLED,
                     runs=(1, 2) if cfg.n_experts else (1, 3), draws=False,
                     tag=f"{tag} sampling")
        out.update(r["launches"])
    lock_p = ("fp16", "h2o", "mikv", "gear", "kivi") if "baselines-lockstep" in parts else ()
    cont_p = ("fp16", "kivi") if "baselines-continuous" in parts else ()
    if lock_p or cont_p:   # the kernels at the baselines' shapes are phase 3's rows
        out.update(baselines(
            torch, np, cfg, params, dev, kernels, rows, batch, scfg, cscfg, requests, budgets,
            rel_l2, yardstick, card, layers=cfg.n_layers, policies=lock_p, cpolicies=cont_p,
            ccfg_of=lambda p: dataclasses.replace(
                CompressionConfig.preset(p), fp_window=REMAINING_INTERVAL,
                recompress_interval=REMAINING_INTERVAL),
            tag=tag, full=False))
    gc.collect()
    torch.cuda.empty_cache()
    P_SECONDS[model] = time.perf_counter() - t0
    log(f"phase {tag}: {P_SECONDS[model]:.1f} s ({', '.join(parts)}; {card})")
    return out


# ---- 4n. slice 16: single-card training of the dense decoder --------------
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_STEPS = 4       # (i): 8 before phase 4o, cut to make room for it


def train_argv():
    return ["--arch", TRAIN_ARCH, "--seed", "0", "--steps", str(TRAIN_STEPS), "--warmup", "2",
            "--batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
            "--checkpoint-every", str(TRAIN_STEPS)]


CRASH_LAYERS = 4      # (ii): full width over the first 4 of smollm's 32 layers
CARD_CPU_LAYERS = 2   # (iii): full width over the first 2
# (iii)'s tolerances, the card's first step against the CPU's
CPU_LOSS_REL, CPU_GNORM_REL, CPU_LEAF_REL_L2 = 1e-3, 1e-2, 2e-2


def training(torch, np, dev, kernels, card):
    """Phase 4n: `launch.train` on smollm-360m at full size, a crash and a
    restart bitwise, and the card's step against the CPU's.

    (i) `train.main` (the CLI's entry point) at full size: random bf16
    weights from `registry.materialize_params(cfg, 0)`, AdamW at its
    defaults under a cosine schedule (warmup 2, TRAIN_STEPS = 4 steps), the
    synthetic pipeline at 8 x 2048 tokens, `grad_accum` from
    `pick_grad_accum` (4: microbatches of 2), q_block 512, through
    `FaultTolerantLoop` with one checkpoint at the last step, restored into
    a fresh tree: every loss finite, the last step's below step 1's, every
    restored leaf bitwise the returned
    state's.  (ii) At full width over the first 4 layers, 8 steps with
    checkpoints every 4 and a failure injected at step 6, resumed from
    step 4: every parameter and optimizer leaf at step 8 bitwise the
    uninterrupted run's, and its losses too.  (iii) At full width over the
    first 2 layers, one 2048-token microbatch: the loss on the card against
    the port on the CPU, and at a fan-in init of the same draws also the
    gradient norm and every gradient leaf (the comment there has why).
    Every kernel's count stays 0: the training path runs none (neither
    does the reference's).  Returns the launch counts of (i)."""
    import dataclasses
    import tempfile

    from repro_torch import configs, tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import blocks, common, registry
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule, global_norm
    from repro_torch.runtime import FaultTolerantLoop

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2 * 2**30, f"training: {held / 2**30:.2f} GiB still held by earlier phases")
    cfg = configs.get_arch(TRAIN_ARCH)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    accum = steps_lib.pick_grad_accum(cfg, ShapeConfig("train", seq, batch, "train"))
    check(accum == 4, f"training: pick_grad_accum gave {accum} for smollm's 8 x 2048, not 4")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # ---- (i) full size through the CLI's entry point ----------------
        seen = []
        print_metrics = train._print_metrics

        def record(step, m):
            seen.append((time.perf_counter(), step, m))
            print_metrics(step, m)

        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        train._print_metrics = record
        try:
            t0 = time.perf_counter()
            state = train.main(train_argv() + ["--checkpoint-dir", f"{tmp}/full"])
            t_end = time.perf_counter()
        finally:
            train._print_metrics = print_metrics
        launches = {n: kern.launches for n, kern in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        check(all(v == 0 for v in launches.values()),
              f"training: the train path launched kernels {launches}; it runs none")
        losses = [m["loss"] for _, _, m in seen]
        check([s for _, s, _ in seen] == list(range(1, TRAIN_STEPS + 1)),
              f"training: {TRAIN_STEPS} steps were not run")
        check(all(np.isfinite(losses)), f"training: a loss is not finite: {losses}")
        check(losses[-1] < losses[0], f"training: step {TRAIN_STEPS}'s loss {losses[-1]:.4f} "
              f"is not below "
              f"step 1's {losses[0]:.4f}")
        stamps = [t0] + [t for t, _, _ in seen]
        step_s = np.diff(stamps)
        med = float(np.median(step_s[1:]))
        params, opt = state
        n_params = sum(t.numel() for t in tree.leaves(params))
        n_groups = sum(t.numel() for t in tree.leaves(params["groups"]))
        tokens = batch * seq
        flops = 6 * n_params * tokens + 2 * n_groups * tokens
        log(f"training (i): {TRAIN_ARCH} at full size, {n_params:,} parameters ({n_groups:,} in "
            f"the layers), batch {batch} x {seq}, grad_accum {accum}; losses "
            + ", ".join(f"{x:.4f}" for x in losses) + "; gradient norms "
            + ", ".join(f"{m['grad_norm']:.3f}" for _, _, m in seen))
        log("training (i): step walls " + ", ".join(f"{x * 1e3:.1f}" for x in step_s) + " ms (the "
            f"first with its warm-up); median of steps 2-{TRAIN_STEPS} {med * 1e3:.1f} "
            f"ms, {tokens / med:,.0f} tokens/s; model FLOPs (6 N tokens + 2 N_layers tokens of "
            f"the recompute forward, attention scores not counted) {flops / 1e12:.2f} TFLOP a "
            f"step, {flops / med / 1e12:.1f} TFLOP/s, {flops / med / PEAK_BF16_FLOPS:.1%} of the "
            f"bf16 dense peak ({card}); max memory allocated {peak / 2**30:.2f} GiB")
        ck = Checkpointer(f"{tmp}/full")
        check(ck.all_steps() == [TRAIN_STEPS],
              f"training: checkpoints {ck.all_steps()}, want [{TRAIN_STEPS}]")
        step_dir = Path(tmp) / "full" / f"step_{TRAIN_STEPS:010d}"
        ck_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
        fresh = tree.tree_map(torch.empty_like, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        restored, meta = ck.restore(TRAIN_STEPS, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(meta["step"] == TRAIN_STEPS
              and meta["data_state"] == {"step": TRAIN_STEPS, "seed": 0},
              f"training: checkpoint metadata {meta}")
        bad = [n for (n, a), b in zip(tree.named_leaves(state), tree.leaves(restored))
               if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b)]
        check(not bad, f"training: restored leaves differ from the saved: {bad[:4]}")
        log(f"training (i): checkpoint at step {TRAIN_STEPS} {ck_bytes / 1e9:.3f} GB in "
            f"{len(list(step_dir.iterdir())) - 1} leaves; write (blocking, from the card) "
            f"{t_end - seen[-1][0]:.2f} s (the last step's metrics to the CLI's return, the final wait "
            f"included); restore into a fresh device tree {restore_s:.2f} s; every leaf bitwise")
        del state, params, opt, fresh, restored
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (ii) crash and restart at full width over 4 layers ---------
        cfg4 = dataclasses.replace(cfg, n_layers=CRASH_LAYERS)
        opt_cfg = AdamWConfig(schedule=cosine_schedule(2, 8))
        step4 = steps_lib.make_train_step(cfg4, opt_cfg, grad_accum=accum, q_block=512)
        step_fn = train.make_step_fn(step4, dev)
        dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab, seed=1)
        params4 = registry.materialize_params(cfg4, seed=1, device=dev)
        state0 = (params4, adamw_init(params4))
        t2 = time.perf_counter()
        pipe = TokenPipeline(dcfg)
        ref_state, _, ref_hist = FaultTolerantLoop(
            step_fn, Checkpointer(f"{tmp}/ref"), checkpoint_every=4, max_steps=8).run(
                tree.tree_map(torch.clone, state0), pipe, 0)   # a step updates in place
        pipe.close()
        ck4 = Checkpointer(f"{tmp}/crash")
        pipe = TokenPipeline(dcfg)
        try:
            FaultTolerantLoop(step_fn, ck4, checkpoint_every=4, max_steps=8,
                              fail_at_step=6).run(state0, pipe, 0)
            fail("training (ii): the injected failure at step 6 did not raise")
        except RuntimeError as e:
            check("injected failure at step 6" in str(e), f"training (ii): {e}")
        pipe.close()
        ck4.wait()
        loop2 = FaultTolerantLoop(step_fn, ck4, checkpoint_every=4, max_steps=8)
        state, start, data_state = loop2.resume_or(tree.tree_map(torch.empty_like, state0))
        check(start == 4 and data_state == {"step": 4, "seed": 1},
              f"training (ii): resumed at {start} with data state {data_state}, want 4")
        pipe = TokenPipeline.restore(dcfg, data_state)
        state, last, hist = loop2.run(state, pipe, start)
        pipe.close()
        crash_s = time.perf_counter() - t2
        check(last == 8, f"training (ii): the resumed run ended at {last}")
        bad = [n for (n, a), b in zip(tree.named_leaves(ref_state), tree.leaves(state))
               if not torch.equal(a, b)]
        check(not bad, f"training (ii): leaves at step 8 differ from the uninterrupted run's: "
              f"{bad[:4]}")
        check([h["loss"] for h in hist] == [h["loss"] for h in ref_hist[4:]],
              "training (ii): the resumed losses differ from the uninterrupted run's")
        crash_dir = Path(tmp) / "crash" / f"step_{8:010d}"
        crash_bytes = sum(p.stat().st_size for p in crash_dir.iterdir())
        log(f"training (ii): {CRASH_LAYERS} layers at full width, failure at step 6, resumed "
            f"at 4: all {len(tree.leaves(state))} parameter and optimizer leaves at step 8 "
            "bitwise the uninterrupted run's, losses "
            + ", ".join(f"{h['loss']:.4f}" for h in ref_hist)
            + f"; checkpoint {crash_bytes / 1e9:.3f} GB; {crash_s:.1f} s for the three runs, "
            f"{time.perf_counter() - t2:.1f} s with the checks")
        del state0, ref_state, state, params4
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (iii) the card's first step against the CPU's ---------------
        # the reference's init draws each stacked layer weight at std 1 /
        # sqrt(its leading axis), the layer count: a 960-wide product then
        # gains ~20x, the softmaxes saturate, and the bf16 gradients are
        # rounding noise (over 30% relative L2 from a float64 run of the
        # same weights, tests/test_torch_train_loss.py), which the card and
        # the CPU round apart.  There only the loss is held; the gradients
        # are held at a fan-in init of the same draws
        cfg2 = dataclasses.replace(cfg, n_layers=CARD_CPU_LAYERS)
        params2 = registry.materialize_params(cfg2, seed=2, device=dev)
        pipe = TokenPipeline(DataConfig(seq_len=seq, global_batch=1, vocab=cfg.vocab, seed=2))
        host = next(pipe)
        pipe.close()
        ctx = blocks.RunCtx(q_block=512)
        on = {d: train.to_device(host, d) for d in (dev, "cpu")}
        with torch.no_grad():
            ref_loss = {d: registry.loss_fn(tree.tree_map(lambda t: t.to(d), params2), on[d],
                                            cfg2, ctx)[0].item() for d in (dev, "cpu")}
        loss_rel = abs(ref_loss[dev] - ref_loss["cpu"]) / abs(ref_loss["cpu"])
        log(f"training (iii), the reference's init: loss {ref_loss[dev]:.6f} on the card, "
            f"{ref_loss['cpu']:.6f} on the CPU ({loss_rel:.2e} relative, tolerance "
            f"{CPU_LOSS_REL:g})")
        check(loss_rel <= CPU_LOSS_REL, f"training (iii): loss {loss_rel:.2e} relative")
        p2 = common.fan_in_init(params2)
        t3 = time.perf_counter()
        loss_c, _, g_c = steps_lib.loss_and_grads(p2, on[dev], cfg2, ctx)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t3
        cpu_params = tree.tree_map(lambda t: t.cpu(), p2)
        t4 = time.perf_counter()
        loss_h, _, g_h = steps_lib.loss_and_grads(cpu_params, on["cpu"], cfg2, ctx)
        cpu_s = time.perf_counter() - t4
        loss_rel = abs(loss_c.item() - loss_h.item()) / abs(loss_h.item())
        gn_c, gn_h = global_norm(g_c).item(), global_norm(g_h).item()
        gn_rel = abs(gn_c - gn_h) / gn_h
        leaf_rel = {n: ((a.cpu().float() - b.float()).norm() / b.float().norm()).item()
                    for (n, _), a, b in zip(tree.named_leaves(p2), g_c, g_h)}
        worst = max(leaf_rel, key=leaf_rel.get)
        log(f"training (iii), a fan-in init: {CARD_CPU_LAYERS} layers at full width, one "
            f"{seq}-token microbatch: loss {loss_c.item():.6f} on the card, "
            f"{loss_h.item():.6f} on the CPU ({loss_rel:.2e} relative, tolerance "
            f"{CPU_LOSS_REL:g}); gradient norm {gn_c:.5f} / {gn_h:.5f} ({gn_rel:.2e}, "
            f"tolerance {CPU_GNORM_REL:g}); per-leaf relative L2 "
            + ", ".join(f"{n} {r:.2e}" for n, r in leaf_rel.items())
            + f" (tolerance {CPU_LEAF_REL_L2:g}); card {card_s:.2f} s, CPU {cpu_s:.1f} s")
        check(loss_rel <= CPU_LOSS_REL, f"training (iii): loss {loss_rel:.2e} relative")
        check(gn_rel <= CPU_GNORM_REL, f"training (iii): gradient norm {gn_rel:.2e} relative")
        check(leaf_rel[worst] <= CPU_LEAF_REL_L2,
              f"training (iii): gradient {worst} at {leaf_rel[worst]:.2e} relative L2")
        del params2, p2, cpu_params, g_c, g_h
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"training: the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- 4o. slice 17: training of every other family on one card ---------------
# (arch, layers at full width): DeepSeek-V2-Lite's dense layer and 3 MoE
# layers (MLA + MoE + the aux loss); mamba2, seamless at full depth; llava's
# first 2 of 60 layers (576 patch embeddings before 448 text tokens)
FAMILY_TRAIN = (("deepseek-v2-lite-16b", 4), ("mamba2-2.7b", 64),
                ("seamless-m4t-medium", 12), ("llava-next-34b", 2))
FAMILY_BATCH, FAMILY_SEQ, FAMILY_STEPS = 4, 1024, 4
# (i)'s checkpoint round trip: one dense family's (the checkpointer does not
# depend on the tree); every family's until phase 4p needed the room
FAMILY_ROUND_TRIP = "seamless-m4t-medium"
FAMILY_CRASH = ("deepseek-v2-lite-16b", 2)     # (ii): its dense layer and one MoE layer
# (iii): one microbatch of 512 tokens over one layer of each kind
FAMILY_CARD_CPU = (("deepseek-v2-lite-16b", 2), ("mamba2-2.7b", 2), ("seamless-m4t-medium", 1))
FAMILY_CARD_CPU_SEQ = 512


def cut_depth(cfg, layers: int):
    """`cfg` over its first `layers` layers at full width (the encoder-decoder:
    as many encoder as decoder layers)."""
    import dataclasses
    if cfg.encdec:
        return dataclasses.replace(cfg, n_layers=layers, n_enc_layers=layers)
    return dataclasses.replace(cfg, n_layers=layers)


def family_argv(arch, steps, every, ckpt_dir, fail_at=None):
    argv = ["--arch", arch, "--seed", "0", "--steps", str(steps), "--warmup", "1",
            "--batch", str(FAMILY_BATCH), "--seq-len", str(FAMILY_SEQ),
            "--checkpoint-every", str(every), "--checkpoint-dir", ckpt_dir]
    return argv + (["--fail-at", str(fail_at)] if fail_at is not None else [])


def run_train_cli(train, configs, argv, layers):
    """`train.main(argv)` with the arch cut to `layers` layers at full width:
    (the returned state, [(time, step, metrics)] of each step, start time)."""
    seen = []
    print_metrics, get_arch = train._print_metrics, configs.get_arch

    def record(step, m):
        seen.append((time.perf_counter(), step, m))
        print_metrics(step, m)

    train._print_metrics = record
    configs.get_arch = lambda name, smoke=False: cut_depth(get_arch(name, smoke=smoke), layers)
    try:
        t0 = time.perf_counter()
        state = train.main(argv)
    finally:
        train._print_metrics, configs.get_arch = print_metrics, get_arch
    return state, seen, t0


def model_flops(cfg, params, tokens: int, tree) -> float:
    """6 x active parameters x tokens, plus 2 x the recomputed layers'
    active parameters x tokens (the remat forward); an MoE expert weight
    counts top_k / n_experts of itself; attention scores not counted."""
    total = layers = 0
    for name, t in tree.named_leaves(params):
        n = t.numel()
        path = name.split("/")
        if path[-2:-1] == ["moe"]:
            n = n * cfg.top_k // cfg.n_experts
        total += n
        if path[0] in ("groups", "enc_layers", "dec_layers"):
            layers += n
    return 6 * total * tokens + 2 * layers * tokens


class PinnedRoutes:
    """Patches `mlp.route` for the card-against-CPU step: `record` keeps the
    expert ids of every call (the forward's and the recompute's), `replay`
    routes each call to the recorded ids instead of its own top k (the
    gates renormalized over the recorded experts' probabilities) and notes
    the share of tokens whose own top-k set is the recorded one."""

    def __init__(self, torch, mlp):
        self.torch, self.mlp, self.route = torch, mlp, mlp.route
        self.calls, self.same = [], []

    def record(self):
        def route(params, x, cfg):
            probs, gates, eidx = self.route(params, x, cfg)
            self.calls.append(eidx.cpu())
            return probs, gates, eidx
        self.mlp.route = route

    def replay(self):
        torch = self.torch
        pending = list(self.calls)

        def route(params, x, cfg):
            probs, _, own = self.route(params, x, cfg)
            eidx = pending.pop(0).to(own.device)
            self.same.append((torch.sort(own, -1).values == torch.sort(eidx, -1).values)
                             .all(-1).float().mean().item())
            g = torch.gather(probs, -1, eidx)
            return probs, g / g.sum(dim=-1, keepdim=True).clamp_min(1e-9), eidx
        self.mlp.route = route

    def restore(self):
        self.mlp.route = self.route


def families(torch, np, dev, kernels, card):
    """Phase 4o: `launch.train` trains each other family at full width, a
    crash and a restart bitwise on the MoE path, and the card's first step
    against the CPU's.

    (i) `train.main` (the CLI's entry point) on DeepSeek-V2-Lite (MLA + MoE
    + the aux loss) over its dense layer and 3 MoE layers, mamba2-2.7b
    (64 SSD layers), seamless-m4t-medium (12 + 12 layers, f32 source
    frames) and llava-next-34b over 2 of its 60 layers (576 patch
    embeddings before 448 text tokens): random bf16 weights from
    `registry.materialize_params(cfg, 0)`, AdamW at its defaults under a
    cosine schedule (warmup 1, 4 steps), the synthetic pipeline at 4 x
    1024 positions, `grad_accum` from `pick_grad_accum`, q_block 512, one
    checkpoint at step 4 restored into a fresh host tree (each leaf mapped
    from its file) and compared on the card: every loss
    finite, step 4's below step 1's, DeepSeek's aux finite and positive,
    every restored leaf bitwise.  (ii) DeepSeek-V2-Lite over its dense
    layer and one MoE layer through `train.main`: 4 steps, a failure
    injected at step 3 with checkpoints every 2, a second invocation
    resumed at 2: every parameter and optimizer leaf at step 4 and the
    resumed losses bitwise the uninterrupted run's (a dispatch backward
    with float atomics would show here).  (iii) One 512-token microbatch
    over one layer of each kind (DeepSeek's dense and one MoE layer,
    mamba2's 2 layers, seamless 1 + 1) at a fan-in init of the same draws:
    the loss (1e-3), the gradient norm (1e-2) and every gradient leaf (2e-2
    relative L2) on the card against the port on the CPU, the MoE layer's
    experts pinned to the card's choices on the CPU (`PinnedRoutes`; the
    share of tokens both devices route alike is logged).  Every kernel's
    count stays 0: no training path runs one.  Returns the launch counts
    of (i)."""
    import shutil
    import tempfile

    from repro_torch import configs, tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import blocks, common, mlp, registry
    from repro_torch.optim import global_norm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2 * 2**30, f"families: {held / 2**30:.2f} GiB still held by earlier phases")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_families_")
    launches = {n: 0 for n in kernels}
    try:
        # ---- (i) each family through the CLI's entry point ---------------
        for arch, layers in FAMILY_TRAIN:
            t_arch = time.perf_counter()
            cfg = cut_depth(configs.get_arch(arch), layers)
            accum = steps_lib.pick_grad_accum(
                cfg, ShapeConfig("train", FAMILY_SEQ, FAMILY_BATCH, "train"))
            for kern in kernels.values():
                kern.launches = 0
            torch.cuda.reset_peak_memory_stats()
            ck_dir = f"{tmp}/{arch}"
            every = FAMILY_STEPS if arch == FAMILY_ROUND_TRIP else 100   # 100: no checkpoint
            state, seen, t0 = run_train_cli(
                train, configs, family_argv(arch, FAMILY_STEPS, every, ck_dir), layers)
            t_end = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            for n, kern in kernels.items():
                launches[n] += kern.launches
            check(all(kern.launches == 0 for kern in kernels.values()),
                  f"families (i) {arch}: the train path launched kernels "
                  f"{ {n: k.launches for n, k in kernels.items()} }; it runs none")
            losses = [m["loss"] for _, _, m in seen]
            auxes = [m["aux"] for _, _, m in seen]
            check([s for _, s, _ in seen] == list(range(1, FAMILY_STEPS + 1)),
                  f"families (i) {arch}: {FAMILY_STEPS} steps were not run")
            check(all(np.isfinite(losses)), f"families (i) {arch}: a loss is not finite: {losses}")
            check(losses[-1] < losses[0], f"families (i) {arch}: step {FAMILY_STEPS}'s loss "
                  f"{losses[-1]:.4f} is not below step 1's {losses[0]:.4f}")
            if cfg.n_experts:
                check(all(np.isfinite(auxes)) and min(auxes) > 0,
                      f"families (i) {arch}: the aux loss is not finite and positive: {auxes}")
            step_s = np.diff([t0] + [t for t, _, _ in seen])
            med = float(np.median(step_s[1:]))
            params = state[0]
            n_params = sum(t.numel() for t in tree.leaves(params))
            tokens = FAMILY_BATCH * FAMILY_SEQ
            flops = model_flops(cfg, params, tokens, tree)
            log(f"families (i) {arch}: {layers} layers at full width, {n_params:,} parameters, "
                f"batch {FAMILY_BATCH} x {FAMILY_SEQ}, grad_accum {accum}; losses "
                + ", ".join(f"{x:.4f}" for x in losses) + "; aux "
                + ", ".join(f"{x:.6f}" for x in auxes) + "; gradient norms "
                + ", ".join(f"{m['grad_norm']:.3f}" for _, _, m in seen))
            log(f"families (i) {arch}: step walls " + ", ".join(f"{x * 1e3:.1f}" for x in step_s)
                + f" ms (the first with its warm-up); median of steps 2-{FAMILY_STEPS} "
                f"{med * 1e3:.1f} ms, {tokens / med:,.0f} tokens/s; model FLOPs (6 N_active "
                f"tokens + 2 N_layers tokens of the recompute) {flops / 1e12:.2f} TFLOP a step, "
                f"{flops / med / 1e12:.1f} TFLOP/s, {flops / med / PEAK_BF16_FLOPS:.1%} of the "
                f"bf16 dense peak ({card}); max memory allocated {peak / 2**30:.2f} GiB")
            if arch != FAMILY_ROUND_TRIP:
                check(not Path(ck_dir).exists() or not any(Path(ck_dir).iterdir()),
                      f"families (i) {arch}: a checkpoint was written")
                log(f"families (i) {arch}: no checkpoint (the round trip is "
                    f"{FAMILY_ROUND_TRIP}'s alone)")
            else:
                ck = Checkpointer(ck_dir)
                check(ck.all_steps() == [FAMILY_STEPS],
                      f"families (i) {arch}: checkpoints {ck.all_steps()}, want [{FAMILY_STEPS}]")
                step_dir = Path(ck_dir) / f"step_{FAMILY_STEPS:010d}"
                ck_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
                # a host tree (a second device copy of mamba2's state would not fit
                # beside it): each restored leaf maps its file, and reads it once,
                # straight to the card, when it is compared there
                fresh = tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), state)
                t1 = time.perf_counter()
                restored, meta = ck.restore(FAMILY_STEPS, fresh)
                check(meta["step"] == FAMILY_STEPS,
                      f"families (i) {arch}: checkpoint metadata {meta}")
                bad = [n for (n, a), b in zip(tree.named_leaves(state), tree.leaves(restored))
                       if a.dtype != b.dtype or not torch.equal(a, b.to(a.device))]
                restore_s = time.perf_counter() - t1
                check(not bad,
                      f"families (i) {arch}: restored leaves differ from the saved: {bad[:4]}")
                log(f"families (i) {arch}: checkpoint at step {FAMILY_STEPS} "
                    f"{ck_bytes / 1e9:.3f} GB in {len(list(step_dir.iterdir())) - 1} leaves; "
                    f"write (blocking, from the card) {t_end - seen[-1][0]:.2f} s (the last "
                    f"step's metrics to the CLI's return); restore into a fresh host tree and "
                    f"compare on the card {restore_s:.2f} s; every leaf bitwise")
            del state, params
            shutil.rmtree(ck_dir, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"families (i) {arch}: {time.perf_counter() - t_arch:.1f} s in all")

        # ---- (ii) crash and restart on the MoE path -----------------------
        t2 = time.perf_counter()
        arch, layers = FAMILY_CRASH
        ref_state, ref_seen, _ = run_train_cli(
            train, configs, family_argv(arch, 4, 100, f"{tmp}/ref"), layers)
        try:
            run_train_cli(train, configs, family_argv(arch, 4, 2, f"{tmp}/crash", fail_at=3),
                          layers)
            fail("families (ii): the injected failure at step 3 did not raise")
        except RuntimeError as e:
            check("injected failure at step 3" in str(e), f"families (ii): {e}")
        gc.collect()
        torch.cuda.empty_cache()
        state, seen, _ = run_train_cli(
            train, configs, family_argv(arch, 4, 2, f"{tmp}/crash"), layers)
        crash_s = time.perf_counter() - t2
        check([s for _, s, _ in seen] == [3, 4],
              f"families (ii): the resumed run took steps {[s for _, s, _ in seen]}, want 3, 4")
        check([m for _, _, m in seen] == [m for _, _, m in ref_seen[2:]],
              "families (ii): the resumed metrics differ from the uninterrupted run's")
        bad = [n for (n, a), b in zip(tree.named_leaves(ref_state), tree.leaves(state))
               if not torch.equal(a, b)]
        check(not bad, f"families (ii): leaves at step 4 differ from the uninterrupted run's: "
              f"{bad[:4]}")
        crash_dir = Path(tmp) / "crash" / f"step_{4:010d}"
        crash_bytes = sum(p.stat().st_size for p in crash_dir.iterdir())
        log(f"families (ii): {arch} over {layers} layers at full width, failure at step 3, "
            f"resumed at 2: all {len(tree.leaves(state))} parameter and optimizer leaves at "
            "step 4 and the resumed metrics bitwise the uninterrupted run's, losses "
            + ", ".join(f"{m['loss']:.4f}" for _, _, m in ref_seen)
            + f"; checkpoint {crash_bytes / 1e9:.3f} GB; {crash_s:.1f} s for the three runs, "
            f"{time.perf_counter() - t2:.1f} s with the checks")
        del ref_state, state
        shutil.rmtree(f"{tmp}/crash", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (iii) the card's first step against the CPU's ----------------
        # at a fan-in init of the reference's draws: at the reference's init
        # the bf16 gradients are rounding noise (phase 4n (iii))
        t5 = time.perf_counter()
        ctx = blocks.RunCtx(q_block=512)
        for arch, layers in FAMILY_CARD_CPU:
            cfg = cut_depth(configs.get_arch(arch), layers)
            params = common.fan_in_init(registry.materialize_params(cfg, seed=2, device=dev))
            pipe = TokenPipeline(train.data_config(cfg, FAMILY_CARD_CPU_SEQ, 1, seed=2))
            host = next(pipe)
            pipe.close()
            on = {d: train.to_device(host, d) for d in (dev, "cpu")}
            pins = PinnedRoutes(torch, mlp)
            pins.record()
            try:
                t3 = time.perf_counter()
                loss_c, met_c, g_c = steps_lib.loss_and_grads(params, on[dev], cfg, ctx)
                torch.cuda.synchronize()
                card_s = time.perf_counter() - t3
                cpu_params = tree.tree_map(lambda t: t.cpu(), params)
                pins.replay()
                t4 = time.perf_counter()
                loss_h, met_h, g_h = steps_lib.loss_and_grads(cpu_params, on["cpu"], cfg, ctx)
                cpu_s = time.perf_counter() - t4
            finally:
                pins.restore()
            loss_rel = abs(loss_c.item() - loss_h.item()) / abs(loss_h.item())
            gn_c, gn_h = global_norm(g_c).item(), global_norm(g_h).item()
            gn_rel = abs(gn_c - gn_h) / gn_h
            leaf_rel = {n: ((a.cpu().float() - b.float()).norm()
                            / b.float().norm().clamp_min(1e-30)).item()
                        for (n, _), a, b in zip(tree.named_leaves(params), g_c, g_h)}
            worst = max(leaf_rel, key=leaf_rel.get)
            routed = (f"; the CPU's own top {cfg.top_k} is the card's for "
                      + ", ".join(f"{x:.4f}" for x in pins.same[:len(pins.same) // 2])
                      + " of the tokens (each MoE layer's forward), the CPU pinned to the card's"
                      f" experts; aux {met_c['aux'].item():.6f} / {met_h['aux'].item():.6f}"
                      if pins.same else "")
            log(f"families (iii) {arch}: {layers} layer(s) at full width, a fan-in init, one "
                f"{FAMILY_CARD_CPU_SEQ}-token microbatch: loss {loss_c.item():.6f} on the card, "
                f"{loss_h.item():.6f} on the CPU ({loss_rel:.2e} relative, tolerance "
                f"{CPU_LOSS_REL:g}); gradient norm {gn_c:.5f} / {gn_h:.5f} ({gn_rel:.2e}, "
                f"tolerance {CPU_GNORM_REL:g}); worst leaf {worst} {leaf_rel[worst]:.2e} "
                f"(tolerance {CPU_LEAF_REL_L2:g}) of {len(leaf_rel)}{routed}; card "
                f"{card_s:.2f} s, CPU {cpu_s:.1f} s")
            check(loss_rel <= CPU_LOSS_REL, f"families (iii) {arch}: loss {loss_rel:.2e} relative")
            check(gn_rel <= CPU_GNORM_REL,
                  f"families (iii) {arch}: gradient norm {gn_rel:.2e} relative")
            check(leaf_rel[worst] <= CPU_LEAF_REL_L2,
                  f"families (iii) {arch}: gradient {worst} at {leaf_rel[worst]:.2e} relative L2")
            del params, cpu_params, g_c, g_h, on
            gc.collect()
            torch.cuda.empty_cache()
        log(f"families (iii): {time.perf_counter() - t5:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"families: the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- 4q. slice 19: training on a mesh at world size 1 ----------------------
MESH_TRAIN = (("deepseek-v2-lite-16b", 4, FAMILY_BATCH, FAMILY_SEQ),   # phase 4o's layers
              ("smollm-360m", None, 4, 2048))                            # full size
MESH_STEPS = 2


def mesh_training(torch, np, dev, kernels, card):
    """Phase 4q: `make_train_step(cfg, mesh=)` on a 1 x 1 ("data", "model")
    mesh over NCCL (a world of one process, its store in memory), bitwise
    the plain step.

    (i) DeepSeek-V2-Lite over phase 4o's layers (its dense layer and 3 MoE
    layers, full width) and smollm-360m at full size: from
    `registry.materialize_params(cfg, 0)` (made twice: the generator on
    the card gives the same bits), 2 steps of the synthetic pipeline's
    batches through the plain step, the state kept on the host, then the
    same through the mesh step (`shard_train_state`, `local_batch`): every
    step's metrics and every parameter and optimizer leaf bitwise.  (ii) A
    checkpoint of smollm's mesh state written by the mesh's checkpointer
    and restored through `runtime.elastic.remesh_restore` onto a 1 x 1
    mesh: every leaf bitwise.  (iii) `ef_compress_step` (axis None) and
    `quantize_int8` on the card: the same codes, scales and residuals as
    on the CPU for the same floats.  No kernel launches.  Logs the seconds
    and the peak memory of each run.  Returns the launch counts."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs, tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim import grad_compress as gcomp
    from repro_torch.runtime.elastic import remesh_restore

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "mesh_training: a process group is already up")
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device_type="cuda")
    check(dist.get_backend() == "nccl" and mesh.size == 1,
          f"mesh_training: backend {dist.get_backend()}, mesh {mesh.shape}")
    launches = {n: 0 for n in kernels}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        for arch, layers, batch, seq in MESH_TRAIN:
            t_arch = time.perf_counter()
            cfg = configs.get_arch(arch)
            if layers is not None:
                cfg = cut_depth(cfg, layers)
            accum = steps_lib.pick_grad_accum(cfg, ShapeConfig("train", seq, batch, "train"),
                                              mesh)
            check(accum == steps_lib.pick_grad_accum(
                cfg, ShapeConfig("train", seq, batch, "train")),
                f"mesh_training {arch}: the 1 x 1 mesh's grad_accum differs from the plain one")
            pipe = TokenPipeline(train.data_config(cfg, seq, batch, 0))
            host = [next(pipe) for _ in range(MESH_STEPS)]
            pipe.close()
            kw = dict(grad_accum=accum, q_block=512)
            runs = {}
            for route in ("plain", "mesh"):
                for kern in kernels.values():
                    kern.launches = 0
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                params = registry.materialize_params(cfg, 0, device=dev)
                if route == "plain":
                    opt = adamw_init(params)
                    step = steps_lib.make_train_step(cfg, AdamWConfig(), **kw)
                    batches = [train.to_device(b, dev) for b in host]
                else:
                    params, opt = steps_lib.shard_train_state(params, cfg, mesh)
                    step = steps_lib.make_train_step(cfg, AdamWConfig(), mesh=mesh, **kw)
                    batches = [train.to_device(steps_lib.local_batch(b, mesh, accum), dev)
                               for b in host]
                mets = []
                for bt in batches:
                    params, opt, met = step(params, opt, bt)
                    mets.append({k: v.item() for k, v in met.items()})
                torch.cuda.synchronize()
                secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
                for n, kern in kernels.items():
                    launches[n] += kern.launches
                check(all(k.launches == 0 for k in kernels.values()),
                      f"mesh_training {arch} {route}: the train path launched kernels")
                state = (params, opt)
                n_leaves = len(tree.leaves(state))
                if route == "plain":
                    # kept on the host: a second device state would not fit beside DeepSeek's
                    t1 = time.perf_counter()
                    runs[route] = (mets, [t.cpu() for t in tree.leaves(state)])
                    host_s = time.perf_counter() - t1
                    del state, params, opt, batches
                    gc.collect()
                    torch.cuda.empty_cache()
                else:
                    runs[route] = (mets, state)
                log(f"mesh_training {arch} {route}: {MESH_STEPS} steps of {batch} x {seq} "
                    f"(grad_accum {accum}) {secs:.1f} s with the init; peak memory "
                    f"{peak / 2**30:.2f} GiB; losses "
                    + ", ".join(f"{m['loss']:.6f}" for m in mets) + f" ({card})")
            (pm, plain_leaves), (mm, mesh_state) = runs["plain"], runs["mesh"]
            check(pm == mm, f"mesh_training {arch}: the mesh step's metrics differ from the "
                  f"plain step's: {mm} against {pm}")
            bad = [n for (n, a), b in zip(tree.named_leaves(mesh_state), plain_leaves)
                   if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b.to(dev))]
            check(not bad, f"mesh_training {arch}: leaves differ from the plain step's: {bad[:4]}")
            n_params = sum(t.numel() for t in tree.leaves(mesh_state[0]))
            log(f"mesh_training {arch}: {n_params:,} parameters; the 1 x 1 mesh step's metrics "
                f"and all {n_leaves} parameter and optimizer leaves bitwise the plain step's "
                f"(the plain state to the host {host_s:.1f} s)")
            if arch == "smollm-360m":
                # (ii) a checkpoint under the mesh, restored through remesh_restore
                specs = steps_lib.state_specs(cfg, mesh)
                t2 = time.perf_counter()
                Checkpointer(f"{tmp}/ck", mesh=mesh, specs=specs).save(
                    MESH_STEPS, mesh_state, {"step": MESH_STEPS}, blocking=True)
                fresh = tree.tree_map(torch.empty_like, mesh_state)
                restored, meta, _ = remesh_restore(Checkpointer(f"{tmp}/ck"), cfg, fresh, (1, 1),
                                                   ("data", "model"), device_type="cuda")
                bad = [n for (n, a), b in zip(tree.named_leaves(mesh_state), tree.leaves(restored))
                       if a.dtype != b.dtype or not torch.equal(a, b.to(a.device))]
                check(not bad and meta == {"step": MESH_STEPS},
                      f"mesh_training: the remesh_restore differs: {bad[:4]} {meta}")
                log(f"mesh_training {arch}: checkpoint under the 1 x 1 mesh and remesh_restore "
                    f"onto a 1 x 1 mesh: every leaf bitwise, {time.perf_counter() - t2:.1f} s")
                del restored, fresh
            del runs, mesh_state, plain_leaves, params, opt, state, batches
            gc.collect()
            torch.cuda.empty_cache()
            log(f"mesh_training {arch}: {time.perf_counter() - t_arch:.1f} s in all")

        # (iii) int8 compression with error feedback, card against CPU
        rng = np.random.default_rng(7)
        floats = [(rng.standard_normal((257, 129)) * s).astype(np.float32)
                  for s in (1e-3, 1.0, 30.0)]
        out = []
        for d in (dev, torch.device("cpu")):
            gs = [torch.from_numpy(f).to(d) for f in floats]
            res = gcomp.init_residual(gs)
            synced, res2 = gcomp.ef_compress_step(gs, res, None)
            synced2, res3 = gcomp.ef_compress_step(gs, res2, None)
            codes = [gcomp.quantize_int8(g) for g in gs]
            out.append([t.cpu() for t in (*synced, *res2, *synced2, *res3,
                                          *(c for q in codes for c in q))])
        check(all(torch.equal(a, b) for a, b in zip(*out)),
              "mesh_training: ef_compress_step / quantize_int8 differ between the card and the CPU")
        log("mesh_training: ef_compress_step (two steps, axis None) and quantize_int8 on the "
            "card bitwise the CPU's (codes, scales, residuals)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"mesh_training: the phase took {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


# ---- 4r. slice 20: serving on a mesh at world size 1 -----------------------
MESH_SERVE_LAYERS = BASELINE_LAYERS      # phase 4i's cut: 4 of yi-6b's 32 layers
MESH_SERVE = (4, 512, 24)                # batch, prompt, new tokens: probe steps, a fold at 16


def serving_mesh(torch, np, dev, kernels, card, rows):
    """Phase 4r: serving on a 1 x 1 ("data", "model") mesh over NCCL (a
    world of one process, its store in memory), and each kernel's share of
    a split on the one card.

    (i) yi-6b at full width over phase 4i's 4 layers, zipcache at fp_window
    = recompress_interval = 16: the lockstep engine (4 prompts of 512
    tokens, 24 new) and the continuous engine (the same 4 requests) on the
    mixed layout, each without a mesh (captured), on the mesh captured and
    on the mesh eagerly: the tokens, every cache leaf at the end and every
    step's logits of the mesh's captured run bitwise its eager run's and
    the no-mesh run's; the mesh runs' launches of cst_quant, flash_fwd,
    probe_colsum and decode_qattn (the main path's counts).  (ii) At phase
    3's yi-6b layer (batch 4, 1024 + 128 tokens, 32 / 4 heads, d 128):
    `decode_qattn` launched on each half of the kv heads with the whole
    layer's split plan, concatenated, bitwise the whole launch; launched on
    each half of the slots with the statistics output (acc, m, l), merged in
    rank order, within phase 3's bound of the whole launch, its (m, l)
    those of the plain version; `flash_fwd` on each half of the heads
    bitwise the whole launch, `probe_colsum`'s halves averaged within 1e-5
    of its largest column sum.  Logs the seconds; returns the launch
    counts of (i)'s mesh runs."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import kvcache as kvc
    from repro_torch.core import saliency as sal
    from repro_torch.core.policy import CompressionConfig
    from repro_torch.kernels.decode_qattn import kernel as dq_kernel
    from repro_torch.kernels.decode_qattn import ops as dq_ops
    from repro_torch.kernels.decode_qattn import ref as dq_ref
    from repro_torch.kernels.probe_flash import kernel as pf_kernel
    from repro_torch.kernels.probe_flash import ops as pf_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import registry
    from repro_torch.serving import (ContinuousEngine, Request, ServeConfig, ServingEngine,
                                     pack_requests)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "serving_mesh: a process group is already up")
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device_type="cuda")
    check(dist.get_backend() == "nccl" and mesh.size == 1,
          f"serving_mesh: backend {dist.get_backend()}, mesh {mesh.shape}")
    launches = {n: 0 for n in kernels}
    try:
        # ---- (i) both engines on the mesh against no mesh ------------------
        cfg = cut_depth(configs.get_arch("yi-6b"), MESH_SERVE_LAYERS)
        ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=16,
                                   recompress_interval=16)
        params = registry.materialize_params(cfg, 0, device=dev)
        b, prompt, max_new = MESH_SERVE
        scfg = ServeConfig(batch_size=b, prompt_len=prompt, max_new_tokens=max_new)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(2, cfg.vocab, (prompt,)).astype(np.int32) for _ in range(b)]
        batch = {"tokens": pack_requests(prompts, b, prompt)}
        for engine in ("lockstep", "continuous"):
            runs = {}
            for name, m, capture in (("no mesh", None, True), ("mesh", mesh, True),
                                     ("mesh eager", mesh, False)):
                t0 = time.perf_counter()
                if engine == "lockstep":
                    eng = ServingEngine(cfg, ccfg, scfg, params, device=dev, capture=capture,
                                        mesh=m)
                    rec = eng._decode = StepLogits(eng._decode)
                else:
                    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=dev,
                                           capture=capture, mesh=m)
                    rec = eng._decode_masked = StepLogits(eng._decode_masked)
                for kern in kernels.values():
                    kern.launches = 0
                dq_kernel.STATS.launches = 0
                if engine == "lockstep":
                    tokens = eng.generate(batch)["tokens"]
                    caches = eng.last_caches
                else:
                    rids = [eng.submit(Request(tokens=p)) for p in prompts]
                    eng.run()
                    tokens = np.stack([eng.result(r).tokens for r in rids])
                    caches = eng.caches
                torch.cuda.synchronize()
                got = {n: k.launches for n, k in kernels.items()}
                got["decode_qattn.stats"] = dq_kernel.STATS.launches
                if m is not None and capture:
                    for n, c in got.items():
                        launches[n] = launches.get(n, 0) + c
                leaves = [t.clone() for el in registry.cache_elements(caches)
                          for t in kvc.tree_leaves(el)]
                runs[name] = dict(tokens=tokens, logits=rec.logits, leaves=leaves,
                                  captures=rec.step.captures, replays=rec.step.replays,
                                  launches=got, bytes=eng.cache_bytes(caches),
                                  secs=time.perf_counter() - t0)
                del eng, rec, caches
            base, mine, eager = runs["no mesh"], runs["mesh"], runs["mesh eager"]
            for name, other in (("no mesh", base), ("mesh eager", eager)):
                check(np.array_equal(mine["tokens"], other["tokens"]),
                      f"serving_mesh {engine}: the mesh's tokens differ from the {name} run's")
                check(len(mine["leaves"]) == len(other["leaves"]) and all(
                    a.dtype == w.dtype and torch.equal(a, w)
                    for a, w in zip(mine["leaves"], other["leaves"])),
                      f"serving_mesh {engine}: a cache leaf differs from the {name} run's")
                check(len(mine["logits"]) == len(other["logits"]) and all(
                    torch.equal(a, w) for a, w in zip(mine["logits"], other["logits"])),
                      f"serving_mesh {engine}: a step's logits differ from the {name} run's")
            for name, r in (("mesh", mine), ("mesh eager", eager)):
                check(r["bytes"]["total_bytes"] == base["bytes"]["total_bytes"]
                      == r["bytes"]["mesh_total_bytes"],
                      f"serving_mesh {engine}: the {name} run's cache bytes {r['bytes']}, "
                      f"{base['bytes']['total_bytes']} without a mesh")
            check(mine["captures"] >= 1 and mine["replays"] > 0,
                  f"serving_mesh {engine}: the mesh's captured step was built "
                  f"{mine['captures']} times and replayed {mine['replays']} times")
            # a 1 x 1 mesh splits no slots: the statistics launch is not on it
            check(mine["launches"]["decode_qattn.stats"] == 0,
                  f"serving_mesh {engine}: {mine['launches']['decode_qattn.stats']} statistics "
                  "launches on a 1 x 1 mesh")
            path = {n: c for n, c in mine["launches"].items()
                    if n not in ("paged_qattn", "decode_qattn.stats")}
            check(all(c > 0 for c in path.values()),
                  f"serving_mesh {engine}: a kernel of the mixed path did not launch: {path}")
            check(mine["launches"] == base["launches"],
                  f"serving_mesh {engine}: launches {mine['launches']} on the mesh, "
                  f"{base['launches']} without")
            log(f"serving_mesh (i) {engine}: yi-6b over {MESH_SERVE_LAYERS} layers at full "
                f"width, {b} x {prompt} tokens, {max_new} new, on a 1 x 1 mesh over NCCL: "
                f"tokens, all {len(mine['leaves'])} cache leaves, the cache bytes "
                f"({mine['bytes']['total_bytes']}, mesh total "
                f"{mine['bytes']['mesh_total_bytes']}) and all "
                f"{len(mine['logits'])} steps' logits bitwise the no-mesh run's and the "
                f"mesh's eager run's; {mine['captures']} capture(s), {mine['replays']} "
                f"replays; launches {path}; "
                + ", ".join(f"{n} {r['secs']:.2f} s" for n, r in runs.items()) + f" ({card})")
            del runs, base, mine, eager
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (ii) each kernel's share of a split on one card ---------------
        t2 = time.perf_counter()
        ycfg = configs.get_arch("yi-6b")
        zc = CompressionConfig.zipcache()
        b, prompt, max_new = 4, 1024, 128
        h, hk, d = ycfg.n_heads, ycfg.n_kv_heads, ycfg.hd
        gen = torch.Generator(device=dev).manual_seed(20)
        randn = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        k, v = randn(b, hk, prompt, d), randn(b, hk, prompt, d)
        cache = kvc.compress_prefill(zc, k, v, torch.rand((b, prompt), generator=gen, device=dev),
                                     prompt + max_new, use_kernel=True)
        for _ in range(40):
            cache = kvc.append_token(cache, randn(b, hk, d), randn(b, hk, d))
        segs = dq_ops.mixed_segments(cache)
        q = randn(b, h, d)
        whole = dq_kernel.qattn_mixed_layer(q, segs)
        share = dq_ops.segment_share
        heads = torch.cat([dq_kernel.qattn_mixed_layer(
            q.chunk(2, 1)[i].contiguous(), [share(o, 1, i, 2) for o in segs], plan=b * hk)
            for i in range(2)], dim=1)
        check(torch.equal(heads, whole),
              "serving_mesh (ii): decode_qattn on each half of the kv heads differs from the "
              "whole launch")
        dq_kernel.STATS.launches = 0
        halves = [dq_kernel.qattn_mixed_layer(q, [share(o, 2, i, 2) for o in segs], stats=True)
                  for i in range(2)]
        check(dq_kernel.STATS.launches == 2,
              f"serving_mesh (ii): two statistics launches counted {dq_kernel.STATS.launches}")
        plain = [dq_ref.mixed_layer_ref(q, [share(o, 2, i, 2) for o in segs], stats=True)
                 for i in range(2)]
        merged = dq_ref.merge_segments_ref(halves).to(q.dtype)
        err = (merged.float() - whole.float()).abs().max().item()
        tol = 2 ** -7 * max(whole.float().abs().max().item(), 1.0)
        check(err <= tol, f"serving_mesh (ii): decode_qattn's slot halves merged differ from the "
                          f"whole launch by {err:.3g} (tolerance {tol:.3g})")
        ml_err = max(((a - w).abs() / w.abs().clamp_min(1.0)).max().item()
                     for got, want in zip(halves, plain) for a, w in zip(got[1:], want[1:]))
        check(ml_err <= 1e-5, f"serving_mesh (ii): decode_qattn's (m, l) differ from the plain "
                              f"version's by {ml_err:.3g} (tolerance 1e-5)")
        half = [share(o, 2, 0, 2) for o in segs]
        fn = lambda: dq_kernel.qattn_mixed_layer(q, half, stats=True)  # noqa: E731
        moved, flops = nbytes(q), 0.0
        for o in half:
            n_live = int((o["pos"] >= 0).sum())
            moved += hk * n_live * nbytes(o["k_codes"][0, 0, 0], o["v_codes"][0, 0, 0])
            moved += nbytes(o["pos"]) + 4 * b * h * (d + 2)
            flops += 4.0 * h * n_live * d
        # timed with CUDA events only: torch.profiler loses kernels in bursts
        # (PERF.md §7), so the row has no device reading.  launches: (i)'s
        # mesh runs' count (a 1 x 1 mesh splits no slots)
        rows["decode_qattn"]["stats"] = {
            "max_abs_err": ml_err, "merged_err": err, "ms": time_ms(torch, fn, iters=50),
            "plain_ms": time_ms(torch, lambda: dq_ref.mixed_layer_ref(q, half, stats=True)),
            "bound_ms": bound_ms(flops, moved)[0], "launches": launches["decode_qattn.stats"]}
        st = rows["decode_qattn"]["stats"]
        log(f"serving_mesh (ii) decode_qattn: each half of the {hk} kv heads (plan {b * hk} rows x "
            f"kv heads) bitwise the whole launch; each half of the slots with (acc, m, l), "
            f"merged in rank order: max abs err {err:.3g} (tol {tol:.3g}), (m, l) within "
            f"{ml_err:.3g} of the plain version's; one half's launch {st['ms']:.4f} ms, plain "
            f"{st['plain_ms']:.4f} ms, bound {st['bound_ms']:.5f} ms ({card})")
        qf, kf, vf = randn(b, h, prompt, d), randn(b, hk, prompt, d), randn(b, hk, prompt, d)
        out, lse = pf_kernel.flash_fwd(qf, kf, vf, causal=True)
        parts = [pf_kernel.flash_fwd(qf.chunk(2, 1)[i].contiguous(),
                                     kf.chunk(2, 1)[i].contiguous(),
                                     vf.chunk(2, 1)[i].contiguous(), causal=True)
                 for i in range(2)]
        check(torch.equal(torch.cat([p[0] for p in parts], 1), out)
              and torch.equal(torch.cat([p[1] for p in parts], 1), lse),
              "serving_mesh (ii): flash_fwd on each half of the heads differs from the whole "
              "launch")
        pos = pf_ops.unique_probe_rows(sal.select_probes(prompt, device=dev).positions)
        safe = pos.clamp(0, prompt - 1).long()
        pos_b = pos[None].expand(b, -1).contiguous()
        col = pf_kernel.probe_colsum(qf[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
                                     pos_b, kf, lq=prompt)
        cols = [pf_kernel.probe_colsum(qf.chunk(2, 1)[i][:, :, safe].contiguous(),
                                       parts[i][1][:, :, safe].contiguous(), pos_b,
                                       kf.chunk(2, 1)[i].contiguous(), lq=prompt)
                for i in range(2)]
        cerr = ((cols[0] + cols[1]) / 2 - col).abs().max().item() / col.abs().max().item()
        check(cerr <= 1e-5, f"serving_mesh (ii): probe_colsum's head halves averaged differ "
                            f"from the whole launch by {cerr:.3g} of its largest (tol 1e-5)")
        log(f"serving_mesh (ii) flash_fwd / probe_colsum: each half of the {h} heads bitwise the "
            f"whole flash_fwd launch (out and LSE); probe_colsum's halves averaged within "
            f"{cerr:.3g} of its largest column sum; (ii) {time.perf_counter() - t2:.1f} s")
        del cache, segs, k, v, qf, kf, vf
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    log(f"serving_mesh: the phase took {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches



# ---- 4s. slice 21: pipeline parallelism at world size 1 ---------------------
PP_MICRO = 4
PP_SMOLLM = (4, 2048)           # (i): smollm-360m at full size, batch x sequence
PP_YI = (4, 4, 1024)            # (ii): yi-6b's first 4 layers (4i's cut), batch x sequence
# the pipelined run against the plain one on the card: the mesh step's bf16
# bounds (tests/test_torch_mesh_step.py) for the steps (readings: metrics
# 1.72e-3, the worst leaf 5.07e-3 relative L2 on an H100 80GB HBM3 at 700 W); the
# logits were bitwise there, and cuBLAS may tile another M otherwise, so they are
# held to one bf16 ulp of the largest
PP_LOGITS_OF_MAX = 2 ** -8
PP_METRIC_REL, PP_LEAF_REL_L2 = 2e-3, 1.5e-2


def pipeline_training(torch, np, dev, kernels, card):
    """Phase 4s: the pipeline (`launch.pipeline`) on one-stage meshes over
    NCCL (a world of one process, its store in memory): the stage hop is the
    identity, and the one stage's work runs on the one card.

    (i) smollm-360m at full size (32 layers, d 960, vocab 49152, tied
    embeddings) on a ("stage",) mesh of 1, from `common.fan_in_init` of
    `materialize_params(cfg, 0)` (at the reference's init the bf16
    gradients are rounding noise, which two summation orders round apart:
    ROADMAP.md §3) and the synthetic pipeline's 4 x 2048 batches: `pp_forward` with 4
    microbatches against `lm.forward` (no remat), the logits within
    PP_LOGITS_OF_MAX of the largest (and how many are bitwise); then 2
    steps of `make_pp_train_step` against 2 steps of the plain
    `make_train_step` (no mesh), each from its own copy of the state: the
    loss, grad norm and lr within PP_METRIC_REL relative and every
    parameter, master, m and v leaf within PP_LEAF_REL_L2 relative L2.
    (ii) yi-6b at full width over its first 4 layers on a 1 x 1 x 1
    ("stage", "data", "model") mesh: one pipelined step against one plain
    step at 4 x 1024, the same bounds.  Logs each step's seconds, each
    run's peak memory above the state it starts from (GPipe keeps every
    microbatch's activations, no remat; the plain step recomputes each
    layer) and the phase's seconds.  No kernel launches; returns the launch
    counts."""
    import torch.distributed as dist

    from repro_torch import configs, tree
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import pipeline as pp
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import common, lm, registry
    from repro_torch.optim import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "pipeline_training: a process group is already up")
    launches = {n: 0 for n in kernels}

    def batches_of(cfg, b, seq, n):
        pipe = TokenPipeline(train.data_config(cfg, seq, b, 0))
        try:
            return [train.to_device(next(pipe), dev) for _ in range(n)]
        finally:
            pipe.close()

    def run(tag, step, state, batches):
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mets, secs = [], []
        for bt in batches:
            t0 = time.perf_counter()
            *state, met = step(*state, bt)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            mets.append({k: met[k].item() for k in ("loss", "grad_norm", "lr")})
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        for n, kern in kernels.items():
            launches[n] += kern.launches
        check(all(k.launches == 0 for k in kernels.values()),
              f"pipeline_training {tag}: the train path launched kernels")
        log(f"pipeline_training {tag}: step seconds " + ", ".join(f"{t:.3f}" for t in secs)
            + f"; peak memory {peak:.2f} GiB above the state; losses "
            + ", ".join(f"{m['loss']:.6f}" for m in mets) + f" ({card})")
        return tuple(state), mets

    def compare(tag, plain, piped):
        (p_state, p_mets), (q_state, q_mets) = plain, piped
        m_errs = {f"{k} of step {i + 1}": abs(q[k] - p[k]) / abs(p[k])
                  for i, (p, q) in enumerate(zip(p_mets, q_mets)) for k in p}
        worst_m = max(m_errs, key=m_errs.get)
        errs = {n: ((b.float() - a.float()).norm() / a.float().norm().clamp_min(1e-30)).item()
                for (n, a), b in zip(tree.named_leaves(p_state), tree.leaves(q_state))
                if a.is_floating_point()}
        same = sum(torch.equal(a, b) for a, b in zip(tree.leaves(p_state), tree.leaves(q_state)))
        worst = max(errs, key=errs.get)
        log(f"pipeline_training {tag}: metrics within {m_errs[worst_m]:.3g} relative of the "
            f"plain step's ({worst_m}); worst leaf {worst} {errs[worst]:.3g} relative L2; "
            f"{same} of {len(tree.leaves(p_state))} state leaves bitwise")
        check(m_errs[worst_m] <= PP_METRIC_REL and errs[worst] <= PP_LEAF_REL_L2,
              f"pipeline_training {tag}: the pipelined step differs from the plain step: "
              f"{worst_m} {m_errs[worst_m]:.3g} (tol {PP_METRIC_REL}), {worst} "
              f"{errs[worst]:.3g} (tol {PP_LEAF_REL_L2})")

    try:
        # ---- (i) smollm-360m at full size on ("stage",) ------------------------
        t_i = time.perf_counter()
        cfg = configs.get_arch("smollm-360m")
        check(pp.supports_pp(cfg) and cfg.tie_embeddings, "pipeline_training: smollm's config")
        mesh = pp.make_pp_mesh(1, 1, 1)
        check(dist.get_backend() == "nccl" and mesh.axis_names == ("stage",),
              f"pipeline_training: backend {dist.get_backend()}, mesh {mesh.shape}")
        batches = batches_of(cfg, *PP_SMOLLM, 2)
        params = common.fan_in_init(registry.materialize_params(cfg, 0, device=dev))
        with torch.no_grad():
            want = lm.forward(params, batches[0]["tokens"], cfg, steps_lib._run_ctx(cfg, None),
                              remat=False).logits
            got = pp.pp_forward(params, batches[0]["tokens"], cfg, mesh, PP_MICRO)
        err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        n_diff = int((got != want).sum())
        log(f"pipeline_training (i) pp_forward: {n_diff:,} of {want.numel():,} logits differ "
            f"from lm.forward's, the largest by {err:.3g} of the largest logit")
        check(err <= PP_LOGITS_OF_MAX, f"pipeline_training (i): pp_forward's logits differ "
              f"by {err:.3g} of the largest (tol {PP_LOGITS_OF_MAX})")
        del got, want
        plain = run("(i) plain", steps_lib.make_train_step(cfg, AdamWConfig()),
                    (tree.tree_map(torch.clone, params), adamw_init(params)), batches)
        piped = run("(i) pipelined", pp.make_pp_train_step(cfg, mesh, PP_MICRO),
                    steps_lib.shard_train_state(params, cfg, mesh, pp.PP_OVERRIDES), batches)
        compare("(i) smollm-360m", plain, piped)
        del plain, piped, params, batches
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"pipeline_training (i): {time.perf_counter() - t_i:.1f} s")

        # ---- (ii) yi-6b at full width over 4 layers on 1 x 1 x 1 -----------------
        t_ii = time.perf_counter()
        layers, b, seq = PP_YI
        cfg = cut_depth(configs.get_arch("yi-6b"), layers)
        mesh = mesh_lib.make_mesh((1, 1, 1), ("stage", "data", "model"))
        batches = batches_of(cfg, b, seq, 1)
        params = common.fan_in_init(registry.materialize_params(cfg, 0, device=dev))
        plain = run("(ii) plain", steps_lib.make_train_step(cfg, AdamWConfig()),
                    (tree.tree_map(torch.clone, params), adamw_init(params)), batches)
        piped = run("(ii) pipelined", pp.make_pp_train_step(cfg, mesh, PP_MICRO),
                    steps_lib.shard_train_state(params, cfg, mesh, pp.PP_OVERRIDES), batches)
        compare("(ii) yi-6b 4 layers", plain, piped)
        del plain, piped, params, batches
        log(f"pipeline_training (ii): {time.perf_counter() - t_ii:.1f} s")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    log(f"pipeline_training: the phase took {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches

if __name__ == "__main__":
    main()
