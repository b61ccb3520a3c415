"""Continuous-batching serving demo of the port (counterpart of the JAX
package's `examples/serve_zipcache.py`).

Request-lifecycle API: build a `ContinuousEngine`, `submit` requests (each
with its own sampling params, stop tokens, token budget and priority), then
drive the scheduler with `step()` / `run()` and read `result` per request
id, or consume tokens as they decode:

    eng = ContinuousEngine(cfg, ccfg, scfg, params)
    rid = eng.submit(Request(tokens=prompt, stop_tokens=(eos,), max_new_tokens=32))
    for tok in eng.stream(rid):   # drives step() itself; other slots keep decoding
        print(tok)
    out = eng.result(rid)         # .tokens, .finish_reason, .timings

Each step admits queued requests into free decode slots (a batch-1 prefill
whose compressed cache slice is inserted into the running batch), decodes
one token for every active slot and folds each slot's staging window on its
own counter (paper Alg. 3 per request).  A lockstep `ServingEngine` pass
over ("fp16", "gear", "zipcache") follows, with each policy's packed cache
bytes and its Appendix-A compression ratio.

The cache layouts and the scheduler flags are the JAX example's (see its
docstring): --backend mixed | paged, --paged-kernel (the page walk),
--page-allocator freelist with --pool-fraction, --scheduler priority with
--preemption recompute.  The model is the architecture's reduced (smoke)
config with random weights, as in the JAX example.  It runs on the CUDA
card (the port's kernels) unless --device cpu is given, where every kernel
runs its plain PyTorch version; there is no fallback from one to the other.

    PYTHONPATH=src python -m repro_torch.examples.serve_zipcache [--device cpu]
        [--backend paged] [--paged-kernel on] [--page-allocator freelist]
        [--pool-fraction 0.75] [--scheduler priority] [--preemption recompute]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch.serve import card_name
from repro_torch.models import registry
from repro_torch.serving import (ContinuousEngine, Request, SamplingParams, ServeConfig,
                                 ServingEngine, pack_requests)

POLICIES = ("fp16", "gear", "zipcache")


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--backend", default="mixed", choices=("mixed", "paged"))
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--paged-kernel", default="off", choices=("on", "off"))
    ap.add_argument("--page-allocator", default="static", choices=("static", "freelist"))
    ap.add_argument("--pool-fraction", type=float, default=1.0)
    ap.add_argument("--admit-watermark", type=float, default=0.0)
    ap.add_argument("--scheduler", default="fifo", choices=("fifo", "priority"))
    ap.add_argument("--preemption", default="off", choices=("off", "recompute"))
    args = ap.parse_args(argv)
    if args.paged_kernel == "on" and args.backend != "paged":
        ap.error("--paged-kernel on requires --backend paged")
    if args.page_allocator == "freelist" and args.backend != "paged":
        ap.error("--page-allocator freelist requires --backend paged")
    if args.preemption == "recompute" and args.scheduler != "priority":
        ap.error("--preemption recompute requires --scheduler priority")
    return args


def main(argv=None) -> dict:
    """Run the demo; returns {"continuous": {rid: RequestOutput}, "lockstep":
    {policy: {"tokens", "packed_bytes", "ratio"}}}."""
    args = _args(argv)
    device = torch.device(args.device)
    cfg = configs.get_arch(args.arch, smoke=True)
    params = registry.materialize_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=16, recompress_interval=16)
    scfg = ServeConfig(batch_size=args.slots, prompt_len=args.prompt_len,
                       max_new_tokens=args.max_new, backend=args.backend,
                       page_size=args.page_size, paged_kernel=args.paged_kernel == "on",
                       page_allocator=args.page_allocator, pool_fraction=args.pool_fraction,
                       admit_watermark=args.admit_watermark, scheduler=args.scheduler,
                       preemption=args.preemption)

    # ---- continuous batching: more requests than slots, mixed budgets ----
    print(f"== continuous serving {cfg.name} on {card_name(device)}: {args.requests} requests "
          f"over {args.slots} slots, backend={args.backend}, scheduler={args.scheduler}"
          + (f" (+{args.preemption} preemption)" if args.preemption != "off" else ""))
    eng = ContinuousEngine(cfg, ccfg, scfg, params, device=device)
    rids = []
    for i in range(args.requests):
        n = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        prompt = rng.integers(2, cfg.vocab, size=(n,)).astype(np.int32)
        rids.append(eng.submit(Request(
            tokens=prompt, sampling=SamplingParams(temperature=0.0 if i % 2 == 0 else 0.8, seed=i),
            max_new_tokens=int(rng.integers(8, args.max_new + 1)),
            priority=i % 2 if args.scheduler == "priority" else 0, stop_tokens=(1,))))
    # stream the first request token by token; its generator drives step()
    # for the whole engine, so every other slot keeps decoding meanwhile
    streamed = list(eng.stream(rids[0]))
    eng.run()                     # drain whatever outlived the stream
    print(f"  streamed {rids[0]}: {len(streamed)} tok, first={streamed[:6]} (== result: "
          f"{streamed == eng.result(rids[0]).tokens.tolist()})")
    results = {}
    for rid in rids:
        out = results[rid] = eng.result(rid)
        t = out.timings
        print(f"  {rid:8s} {len(out.tokens):3d} tok ({out.finish_reason:6s}) "
              f"prefill={t['prefill_s']:.2f}s decode={t['decode_s']:.2f}s "
              f"({t['tok_per_s']:.1f} tok/s, first tok {t['first_token_s']:.2f}s, "
              f"{int(t['n_preemptions'])} preemptions)  first={out.tokens[:6].tolist()}")
    cb = eng.cache_bytes(eng.caches)
    print(f"  scheduler: {eng._step_no} steps; cache {cb['packed_bytes']} B packed + "
          f"{cb['overhead_bytes']} B overhead ({cb['free_pool_bytes']} B of that free pool "
          "pages)")
    ps = eng.pool_stats()
    if ps is not None:
        used = {k: f"{ps[k]['peak_used']}/{ps[k]['pool_pages']}" for k in ("hi", "lo", "win")}
        print(f"  page pools: peak used {used}; {ps['deferrals']} admissions deferred; "
              f"{ps['preemptions']} slots preempted")
    del eng

    # ---- lockstep per-policy comparison ----
    prompts = [rng.integers(2, cfg.vocab, size=(args.prompt_len,)).astype(np.int32)
               for _ in range(args.slots)]
    batch = {"tokens": pack_requests(prompts, args.slots, args.prompt_len)}
    length = args.prompt_len + args.max_new
    print(f"== lockstep policy comparison, batch={args.slots}, prompt={args.prompt_len}, "
          f"new={args.max_new}")
    lockstep = {}
    for policy in POLICIES:
        pcfg = dataclasses.replace(CompressionConfig.preset(policy), fp_window=16,
                                   recompress_interval=16)
        engine = ServingEngine(cfg, pcfg, scfg, params, device=device)
        out = engine.generate(batch)
        t = out["timings"]
        cb = engine.cache_bytes(engine.last_caches)
        ratio = pcfg.compression_ratio(args.slots, cfg.n_kv_heads, length, cfg.hd)
        lockstep[policy] = {"tokens": out["tokens"], "packed_bytes": cb["packed_bytes"],
                            "ratio": ratio}
        print(f"  {policy:10s} prefill={t['prefill_s']:.2f}s decode={t['decode_s']:.2f}s "
              f"({t['tok_per_s']:.1f} tok/s) kv={cb['packed_bytes']} B packed; Appendix-A "
              f"compression ratio {ratio:.2f}x at {length} tokens")
        del engine
    return {"continuous": results, "lockstep": lockstep}


if __name__ == "__main__":
    main()
