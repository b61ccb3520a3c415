"""Time the bf16 probe_colsum kernel at several grid splits, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.colsum_splits

The probe column sums of one prefill layer at the main paths' shapes (yi-6b
widths: 32 query heads, 4 kv heads, d 128; prompt 1024 and the probe rows
of `select_probes(1024)`, repeats fed once), at batch 4 (the lockstep
prefill) and batch 1 (a continuous admission), through the port's wrapper
with its own choice of query heads per CTA, then 1, 2, 4 and 8 (reached by
setting `kernel.MIN_CTAS`, the smallest grid that choice keeps): device
time per call by kernel (colsum, merge) from torch.profiler, time from CUDA
events, the largest error against the plain version, and whether a second
call gives bitwise-equal sums.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from repro_torch.core import saliency as sal
from repro_torch.kernels.paged_splits import _device_ms, _events_ms
from repro_torch.kernels.probe_flash import kernel as pf_kernel
from repro_torch.kernels.probe_flash import ops as pf_ops
from repro_torch.kernels.probe_flash import ref as pf_ref


def _operands(dev, b, h=32, hk=4, l=1024, d=128):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, h, l, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, hk, l, d), generator=gen, device=dev).to(torch.bfloat16)
    _, lse = pf_kernel.flash_fwd(q, k, k)
    pos = pf_ops.unique_probe_rows(sal.select_probes(l).positions.to(dev))
    safe = pos.clamp(0, l - 1).long()
    return (q[:, :, safe].contiguous(), lse[:, :, safe].contiguous(),
            pos[None].expand(b, -1).contiguous(), k)


def sweep(iters: int = 50) -> dict:
    dev = torch.device("cuda")
    res = {}
    default = pf_kernel.MIN_CTAS
    col_blocks = -(-1024 // pf_kernel.COLSUM_COLS)
    try:
        for b in (4, 1):
            args = _operands(dev, b)
            want = pf_ref.probe_colsum_ref(*args, lq=1024)
            for hpc in (None, 1, 2, 4, 8):
                # the grid of hpc heads per CTA: the smallest that picks hpc
                pf_kernel.MIN_CTAS = default if hpc is None else col_blocks * (32 // hpc) * b
                fn = lambda: pf_kernel.probe_colsum(*args, lq=1024)  # noqa: E731
                got = fn()
                picked = pf_kernel._heads_per_cta(b, 32, 8, 1024)
                assert hpc in (None, picked)
                tag = f"hpc{hpc}" if hpc else f"auto (hpc{picked})"
                res[f"batch{b}-{tag}"] = {
                    "err": (got - want).abs().max().item(),
                    "deterministic": bool(torch.equal(got, fn())),
                    "device_ms": _device_ms(fn, iters), "events_ms": _events_ms(fn, iters)}
    finally:
        pf_kernel.MIN_CTAS = default
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("colsum_splits: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    res = sweep()
    for tag, r in res.items():
        parts = ", ".join(f"{k} {v:.4f}" for k, v in r["device_ms"].items() if k != "all")
        print(f"[colsum_splits] {tag}: device {r['device_ms']['all']:.4f} ms ({parts}), events "
              f"{r['events_ms']:.4f} ms, err {r['err']:.3g}, deterministic {r['deterministic']}")
    print(json.dumps({"card": smi, "seconds": time.perf_counter() - t0, "runs": res}))


if __name__ == "__main__":
    main()
