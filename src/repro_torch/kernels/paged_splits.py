"""Time the paged_qattn layer kernel at several split counts, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.paged_splits

One decode layer at the continuous path's shapes (yi-6b widths, 4 slots,
page 64: 4-bit hi, 2-bit lo and bf16 window segments over shuffled
free-list tables), through the port's wrapper, with the split count set by
`kernel.TARGET_CTAS`, with and without the slot weights, and each segment
alone: device time per call by kernel (split, merge) from torch.profiler,
time from CUDA events, and the largest error against the layer's plain
version (out in bf16 ulps of its magnitude, l relative).
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.paged_qattn import kernel as pq_kernel
from repro_torch.kernels.paged_qattn import ref as pq_ref


def _events_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, iters: int) -> dict:
    """Device time per call from torch.profiler, in all and by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = e.name.split("<")[0].split("::")[-1]
            by_name[key] = by_name.get(key, 0.0) + e.device_time / 1e3 / iters
    return {"all": sum(by_name.values()), **by_name}


def _paged_segments(dev, gen, b=4, hk=4, d=128, page=64, lengths=(1024, 700, 0, 333)):
    """One decode layer's segments as the continuous path's free-list cache
    holds them (yi-6b widths, zipcache at a 1152-token window): 4-bit hi,
    2-bit lo, bf16 window; shuffled page ids, NULL entries past each slot's
    pages, an empty slot.  Random codes and parameters from `gen`."""
    ccfg = CompressionConfig.zipcache()
    s_hi, s_lo, _ = kvc.capacities(ccfg, 1152)
    segs = []
    for cap, bits, n_valid in ((s_hi, 4, [int(n * ccfg.saliency_ratio) for n in lengths]),
                               (s_lo, 2, [n - int(n * ccfg.saliency_ratio) for n in lengths]),
                               (ccfg.fp_window, 16, [40 if n else 0 for n in lengths])):
        npp = -(-cap // page)
        n_pool = b * npp
        ids = torch.randperm(n_pool, generator=torch.Generator().manual_seed(cap)).view(b, npp)
        pos = torch.arange(cap, dtype=torch.int32).repeat(b, 1)
        for i, n in enumerate(n_valid):
            pos[i, n:] = -1
            ids[i, -(-n // page):] = n_pool          # NULL: the sink page
        c = d if bits >= 16 else d * bits // 8
        dt = torch.bfloat16 if bits >= 16 else torch.int8
        pools = [(torch.randn((n_pool + 1, hk, page, c), generator=gen, device=dev) * 40).to(dt)
                 for _ in range(2)]
        rnd = lambda *sh: torch.rand(sh, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        quant = bits < 16
        segs.append(dict(
            k_pages=pools[0], v_pages=pools[1], pos=pos.to(dev), table=ids.int().to(dev),
            k_bits=bits, v_bits=bits, k_dtype=torch.bfloat16, v_dtype=torch.bfloat16,
            k_scale=rnd(b, hk, 1, d) if quant else None, k_zero=rnd(b, hk, 1, d) if quant else None,
            v_cscale=rnd(b, hk, 1, d) if quant else None,
            v_tscale=rnd(b, hk, cap, 1) if quant else None,
            v_tzero=rnd(b, hk, cap, 1) if quant else None))
    return segs


def _err(got, want) -> float:
    out, _, l, _, _ = got
    return max((out.float() - want[0].float()).abs().max().item(),
               (l - want[2]).abs().max().item() / max(want[2].abs().max().item(), 1.0))


def sweep(iters: int = 50) -> dict:
    """One decode layer through `qattn_paged_layer` at several split counts,
    and each segment alone; device time by kernel."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    segs = _paged_segments(dev, gen)
    q = torch.randn((4, 32, 128), generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 / 128 ** 0.5
    want = pq_ref.paged_layer_ref(q, segs, scale=scale)
    res = {}
    default = pq_kernel.TARGET_CTAS
    try:
        for target in (264, 528, 1056):
            pq_kernel.TARGET_CTAS = target
            for weights in (False, True):
                fn = lambda: pq_kernel.qattn_paged_layer(q, segs, scale=scale,  # noqa: E731
                                                         want_weights=weights)
                err = _err(fn(), want)
                res[f"target{target}" + ("-weights" if weights else "")] = {
                    "device_ms": _device_ms(fn, iters), "events_ms": _events_ms(fn, iters),
                    "err": err}
    finally:
        pq_kernel.TARGET_CTAS = default
    for i, name in enumerate(("hi", "lo", "window")):  # each segment alone
        fn = lambda: pq_kernel.qattn_paged_layer(q, segs[i:i + 1], scale=scale,  # noqa: E731
                                                 want_weights=False)
        res[f"{name}-only"] = {
            "err": _err(fn(), pq_ref.paged_layer_ref(q, segs[i:i + 1], scale=scale)),
            "device_ms": _device_ms(fn, iters), "events_ms": _events_ms(fn, iters)}
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("paged_splits: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    res = sweep()
    for tag, r in res.items():
        parts = ", ".join(f"{k} {v:.4f}" for k, v in r["device_ms"].items() if k != "all")
        print(f"[paged_splits] {tag}: device {r['device_ms']['all']:.4f} ms ({parts}), events "
              f"{r['events_ms']:.4f} ms, err {r['err']:.3g}")
    print(json.dumps({"card": smi, "seconds": time.perf_counter() - t0, "runs": res}))


if __name__ == "__main__":
    main()
