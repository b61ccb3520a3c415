"""Serving entry point of the port: lockstep or continuous generation with
ZipCache.

Examples (on a CUDA card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
      --policy zipcache --batch 4 --prompt-len 64 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
      --continuous --requests 8 --backend paged --page-allocator freelist \
      --pool-fraction 0.75 --paged-kernel on
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
      --continuous --backend paged --page-allocator freelist --pool-fraction 1.5 \
      --prefix-cache on

  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke \
      --continuous --backend paged --page-allocator freelist

  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \
      --batch 4 --prompt-len 1024 --max-new 128

--arch takes yi-6b, deepseek-v2-lite-16b, mamba2-2.7b, jamba-v0.1-52b,
seamless-m4t-medium and llava-next-34b (--smoke only: its full size needs
the decode walk at 7 query heads per kv head).
mamba2-2.7b has no attention layer, so no KV cache: it runs on the mixed
and the paged static layout; the free list (and what needs it: swap,
downshift, --prefix-cache) has no pages to give it and is refused.
seamless-m4t-medium (encoder-decoder) and llava-next-34b (vision frontend)
run on the lockstep engine only, with random f32 frontend embeddings from
the seeded generator, as `repro.launch.serve` makes them: seamless takes
--prompt-len source frames and, departing from the reference, a decoder
prompt of min(128, --prompt-len) tokens, the length its serving context
sizes the caches and probes for (the reference packs --prompt-len tokens
and fails past 128); llava takes n_frontend_tokens patch embeddings before
--prompt-len minus that many text tokens.

The flags are those of `repro.launch.serve` that the port runs, plus
--requests (how many requests the continuous engine serves) and --device
(default cuda; --device cpu runs the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import precision as precision_lib
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.cst_quant import kernel as cst_kernel
from repro_torch.kernels.decode_qattn import kernel as dq_kernel
from repro_torch.kernels.paged_qattn import kernel as pq_kernel
from repro_torch.kernels.probe_flash import kernel as pf_kernel
from repro_torch.models import registry
from repro_torch.serving import (ContinuousEngine, Request, ServeConfig, ServingEngine,
                                 pack_requests)

KERNELS = {"cst_quant": cst_kernel.KERNEL, "flash_fwd": pf_kernel.FLASH,
           "probe_colsum": pf_kernel.COLSUM, "decode_qattn": dq_kernel.KERNEL,
           "paged_qattn": pq_kernel.KERNEL}


def card_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu (kernels run their plain versions)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return f"{torch.cuda.get_device_name(device)} ({smi.stdout.strip() or 'nvidia-smi n/a'})"


def profiled(run, device: torch.device, label: str = "serve"):
    """`run()` (which returns its wall seconds) under torch.profiler: device
    time by kernel name, and the summed kernel time over the wall time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        out, wall = run()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time for e in kernels) / 1e6  # us -> s
    print(f"[{label}] profile: {len(kernels)} device kernels, {busy:.3f} s of device time "
          f"in {wall:.3f} s wall (busy share {busy / max(wall, 1e-9):.3f})")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    return out


def print_step(step) -> None:
    """The decode step's builds and replays: CUDA graph captures and replays
    on the card; on the CPU, static-buffer builds and their eager runs."""
    print(f"[serve] decode step {step.name}: {step.captures} captures, {step.replays} replays")


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The engine / `ServeConfig` flags, named as in `repro.launch.serve`."""
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="zipcache")
    ap.add_argument("--saliency-ratio", type=float, default=0.4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="mixed", choices=("mixed", "paged"),
                    help="KV cache layout: mixed = dense per-slot arrays; paged = page pools "
                         "behind per-slot page tables")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per page (also the continuous engine's admission bucket)")
    ap.add_argument("--paged-kernel", default="off", choices=("on", "off"),
                    help="--backend paged only: decode attention walks the pages "
                         "(kernels/paged_qattn); off = gather a dense view each step")
    ap.add_argument("--page-allocator", default="static", choices=("static", "freelist"),
                    help="--backend paged only: static = every slot owns its worst case; "
                         "freelist = pages granted on demand from shared pools, admission "
                         "deferred when they cannot cover a request's worst case")
    ap.add_argument("--pool-fraction", type=float, default=1.0,
                    help="--page-allocator freelist only: pool capacity as a fraction of the "
                         "static worst case; above 1.0 provisions the slack pages that "
                         "--prefix-cache registrations keep while every slot runs")
    ap.add_argument("--admit-watermark", type=float, default=0.0,
                    help="--page-allocator freelist only: fraction of each pool held back "
                         "as admission headroom")
    ap.add_argument("--prefix-cache", default="off", choices=("off", "on"),
                    help="--page-allocator freelist only: content-hash shared-prefix page "
                         "dedup with copy-on-write tables: identical page-aligned prompt "
                         "buckets alias one set of hi/lo pages and skip their prefill; a "
                         "shared slot gets its own pages before its first fold.  Greedy "
                         "output is that of off")
    ap.add_argument("--scheduler", default="fifo", choices=("fifo", "priority"),
                    help="--continuous only: admission policy")
    ap.add_argument("--preemption", default="off",
                    choices=("off", "recompute", "downshift", "swap"),
                    help="--scheduler priority only: recompute lets the scheduler evict a "
                         "running lower-priority slot and re-admit it by replaying its "
                         "tokens; downshift (freelist only) keeps the victim decoding and "
                         "early-folds its window one lo-store bit lower, returning the "
                         "window's pages; swap (freelist only) moves the victim's exact "
                         "cache to host memory and back (tokens unchanged; a full host pool "
                         "falls back to recompute)")
    ap.add_argument("--swap-pool-mb", type=int, default=0,
                    help="--preemption swap only: host budget (MiB) of the swap tier's "
                         "preallocated entries; 0 = one entry per batch slot")
    ap.add_argument("--precision-map", default="",
                    help="per-layer/head (key, value) effective-bit ceilings inside the "
                         "policy's containers: compact rules like "
                         "'default=k8v8;layer:2-:head:0-1=k2v2' or a KVTuner-shaped JSON "
                         "object; empty = off")
    ap.add_argument("--ladder-watermark", type=float, default=0.0,
                    help="--page-allocator freelist only: when the smallest free fraction of "
                         "the page pools is at or below this, the oldest slot's window is "
                         "early-folded one lo-store bit lower (floor 1 bit) and its pages "
                         "return; 0 = off")


def validate_engine_args(args, ap: argparse.ArgumentParser, continuous: bool) -> None:
    """Reject flag combinations that would be silently ignored.  `continuous`
    is the caller's engine mode (the HTTP front is always continuous)."""
    if args.paged_kernel == "on" and args.backend != "paged":
        ap.error("--paged-kernel on requires --backend paged")
    if args.scheduler != "fifo" and not continuous:
        ap.error("--scheduler requires --continuous")
    if args.preemption != "off" and args.scheduler != "priority":
        ap.error(f"--preemption {args.preemption} requires --scheduler priority")
    for lever in ("downshift", "swap"):
        if args.preemption == lever and args.page_allocator != "freelist":
            ap.error(f"--preemption {lever} requires --page-allocator freelist")
    if args.swap_pool_mb != 0 and args.preemption != "swap":
        ap.error("--swap-pool-mb requires --preemption swap")
    if args.ladder_watermark != 0.0 and args.page_allocator != "freelist":
        ap.error("--ladder-watermark requires --page-allocator freelist")
    try:
        precision_lib.parse_precision_map(args.precision_map)
    except ValueError as e:
        ap.error(f"--precision-map: {e}")
    if args.page_allocator == "freelist" and args.backend != "paged":
        ap.error("--page-allocator freelist requires --backend paged")
    if args.page_allocator == "freelist" and not continuous:
        ap.error("--page-allocator freelist requires --continuous")
    if args.pool_fraction != 1.0 and args.page_allocator != "freelist":
        ap.error("--pool-fraction requires --page-allocator freelist")
    if args.admit_watermark != 0.0 and args.page_allocator != "freelist":
        ap.error("--admit-watermark requires --page-allocator freelist")
    if args.prefix_cache == "on" and args.page_allocator != "freelist":
        ap.error("--prefix-cache on requires --page-allocator freelist")


def build_serve_config(args) -> ServeConfig:
    return ServeConfig(batch_size=args.batch, prompt_len=args.prompt_len,
                       max_new_tokens=args.max_new, seed=args.seed, backend=args.backend,
                       page_size=args.page_size, paged_kernel=args.paged_kernel == "on",
                       page_allocator=args.page_allocator, pool_fraction=args.pool_fraction,
                       admit_watermark=args.admit_watermark, scheduler=args.scheduler,
                       preemption=args.preemption, prefix_cache=args.prefix_cache == "on",
                       precision_map=args.precision_map,
                       ladder_watermark=args.ladder_watermark,
                       swap_pool_mb=args.swap_pool_mb)


def build_compression_config(args) -> CompressionConfig:
    """The policy's preset; --smoke shrinks the fold cadence (fp_window =
    recompress_interval = 16) so short runs still cross a recompression, as
    `repro.launch.serve` does."""
    kw = {"saliency_ratio": args.saliency_ratio} if args.policy in ("zipcache", "mikv") else {}
    ccfg = CompressionConfig.preset(args.policy, **kw)
    return dataclasses.replace(ccfg, fp_window=16, recompress_interval=16) if args.smoke else ccfg


def _serve_continuous(args, cfg, ccfg, scfg, params, device, prompts):
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=device)

    def serve_all():
        # under the priority scheduler, stagger priorities so the policy shows
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=p, priority=i % 2 if args.scheduler == "priority"
                                   else 0)) for i, p in enumerate(prompts)]
        eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return rids, time.perf_counter() - t0

    if args.profile:
        serve_all()   # warm-up: kernel builds, cuBLAS, allocator, every admission bucket
        for k in KERNELS.values():
            k.launches = 0
        rids = profiled(serve_all, device)
    else:
        rids, _ = serve_all()
    print(f"[serve] device: {card_name(device)}")
    for rid in rids:
        out = eng.result(rid)
        print(f"[serve] {rid}: {len(out.tokens)} tok ({out.timings['tok_per_s']:.1f} tok/s, "
              f"first tok {out.timings['first_token_s']:.2f}s, "
              f"{int(out.timings['n_preemptions'])} preemptions) first={out.tokens[:16].tolist()}")
    ps = eng.pool_stats()
    if ps is not None:
        used = {k: f"{ps[k]['peak_used']}/{ps[k]['pool_pages']}" for k in ("hi", "lo", "win")}
        print(f"[serve] page pools peak used {used}, {ps['deferrals']} admissions deferred, "
              f"{ps['preemptions']} slots preempted")
        ds, sw = ps["downshift"], ps.get("swap")
        if ds["downshifts"] or ds["refusals"]:
            print(f"[serve] downshift ladder: {ds['downshifts']} downshifts freed "
                  f"{ds['pages_freed']} window pages, {ds['refusals']} refusals")
        if sw is not None:
            print(f"[serve] swap tier: {sw['swaps_out']} out / {sw['swaps_in']} in, entry "
                  f"{sw['entry_bytes']} bytes, {sw['host_bytes']} host bytes resident, "
                  f"{sw['swap_refusals']} refusals")
        px = ps["prefix"]
        if px["hits"] or px["misses"]:
            print(f"[serve] prefix cache: {px['hits']} hits / {px['misses']} misses, "
                  f"{px['cow_copies']} CoW copies, {px['prefill_tokens_skipped']} prefill "
                  "tokens skipped")
    print("[serve] kernel launches:", {n: k.launches for n, k in KERNELS.items()})
    print_step(eng._decode_masked)
    return {rid: eng.result(rid) for rid in rids}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_engine_args(ap)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (submit/step/result)")
    ap.add_argument("--requests", type=int, default=None,
                    help="--continuous only: requests to serve (default: --batch)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="after a warm-up run, trace one run (a generate, or serving every "
                         "request) with torch.profiler and print device time by kernel and "
                         "the device's busy share")
    args = ap.parse_args(argv)
    validate_engine_args(args, ap, continuous=args.continuous)
    if args.requests is not None and not args.continuous:
        ap.error("--requests requires --continuous")

    device = torch.device(args.device)
    cfg = configs.get_arch(args.arch, smoke=args.smoke)
    if args.continuous and (cfg.encdec or cfg.frontend != "none"):
        ap.error(f"--continuous: {args.arch} runs on the lockstep engine only")
    ccfg = build_compression_config(args)
    scfg = build_serve_config(args)
    params = registry.materialize_params(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    n_req = args.requests if args.requests is not None else args.batch
    prompts = [rng.integers(2, cfg.vocab, size=(args.prompt_len,)).astype(np.int32)
               for _ in range(n_req if args.continuous else args.batch)]
    for k in KERNELS.values():
        k.launches = 0
    if args.continuous:
        return _serve_continuous(args, cfg, ccfg, scfg, params, device, prompts)

    engine = ServingEngine(cfg, ccfg, scfg, params, device=device)
    batch = {"tokens": pack_requests(prompts, args.batch, args.prompt_len)}
    if cfg.encdec or cfg.frontend != "none":
        n = args.prompt_len if cfg.encdec else cfg.n_frontend_tokens
        batch["frontend_embeds"] = rng.standard_normal(
            (args.batch, n, cfg.d_model)).astype(np.float32)
        text = (registry.prefill_lengths(cfg, engine._shape)[0] if cfg.encdec
                else args.prompt_len - n)
        batch["tokens"] = batch["tokens"][:, :text]
    if args.profile:
        engine.generate(batch, max_new_tokens=2)  # warm-up: kernel builds, cuBLAS, allocator
        for k in KERNELS.values():
            k.launches = 0
        def generate():
            out = engine.generate(batch)
            return out, out["timings"]["prefill_s"] + out["timings"]["decode_s"]

        out = profiled(generate, device)
    else:
        out = engine.generate(batch)
    print(f"[serve] device: {card_name(device)}")
    print(f"[serve] {args.arch} policy={args.policy} "
          f"prefill={out['timings']['prefill_s']:.3f}s "
          f"decode={out['timings']['decode_s']:.3f}s "
          f"({out['timings']['tok_per_s']:.1f} tok/s)")
    print("[serve] first request tokens:", out["tokens"][0][:16].tolist())
    print("[serve] kernel launches:", {n: k.launches for n, k in KERNELS.items()})
    print_step(engine._decode)
    return out


if __name__ == "__main__":
    main()
