"""Serving entry point of the port: lockstep batched generation with ZipCache.

Example (on a CUDA card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
      --policy zipcache --batch 4 --prompt-len 64 --max-new 32

The flags are the lockstep subset of `repro.launch.serve`, plus --device
(default cuda; --device cpu runs the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.cst_quant import kernel as cst_kernel
from repro_torch.kernels.decode_qattn import kernel as dq_kernel
from repro_torch.kernels.probe_flash import kernel as pf_kernel
from repro_torch.models import registry
from repro_torch.serving import ServeConfig, ServingEngine, pack_requests

KERNELS = {"cst_quant": cst_kernel.KERNEL, "flash_fwd": pf_kernel.FLASH,
           "probe_colsum": pf_kernel.COLSUM, "decode_qattn": dq_kernel.KERNEL}


def card_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu (kernels run their plain versions)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return f"{torch.cuda.get_device_name(device)} ({smi.stdout.strip() or 'nvidia-smi n/a'})"


def _profiled(engine: ServingEngine, batch, device: torch.device):
    """One generate under torch.profiler: device time by kernel name, and
    the summed kernel time over the wall time of the run."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        out = engine.generate(batch)
    wall = out["timings"]["prefill_s"] + out["timings"]["decode_s"]
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time for e in kernels) / 1e6  # us -> s
    print(f"[serve] profile: {len(kernels)} device kernels, {busy:.3f} s of device time "
          f"in {wall:.3f} s wall (busy share {busy / max(wall, 1e-9):.3f})")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="zipcache")
    ap.add_argument("--saliency-ratio", type=float, default=0.4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="after a warm-up run, trace one generate with torch.profiler and "
                         "print device time by kernel and the device's busy share")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = configs.get_arch(args.arch, smoke=args.smoke)
    kw = {"saliency_ratio": args.saliency_ratio} if args.policy in ("zipcache", "mikv") else {}
    ccfg = CompressionConfig.preset(args.policy, **kw)
    scfg = ServeConfig(batch_size=args.batch, prompt_len=args.prompt_len,
                       max_new_tokens=args.max_new, seed=args.seed)
    params = registry.materialize_params(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(2, cfg.vocab, size=(args.prompt_len,)).astype(np.int32)
               for _ in range(args.batch)]

    engine = ServingEngine(cfg, ccfg, scfg, params, device=device)
    batch = {"tokens": pack_requests(prompts, args.batch, args.prompt_len)}
    if args.profile:
        engine.generate(batch, max_new_tokens=2)  # warm-up: kernel builds, cuBLAS, allocator
    for k in KERNELS.values():
        k.launches = 0
    if args.profile:
        out = _profiled(engine, batch, device)
    else:
        out = engine.generate(batch)
    print(f"[serve] device: {card_name(device)}")
    print(f"[serve] {args.arch} policy={args.policy} "
          f"prefill={out['timings']['prefill_s']:.3f}s "
          f"decode={out['timings']['decode_s']:.3f}s "
          f"({out['timings']['tok_per_s']:.1f} tok/s)")
    print("[serve] first request tokens:", out["tokens"][0][:16].tolist())
    print("[serve] kernel launches:", {n: k.launches for n, k in KERNELS.items()})
    return out


if __name__ == "__main__":
    main()
