"""How often torch.profiler loses device kernels, on the card.

    PYTHONPATH=src python -m tools.profiler_loss [OUT.json]   (from the repo root, on a card)

Forty sessions in a row of each shape below, each over back-to-back calls
of a fast kernel (cst_quant's 2-bit store at the MLA shape: batch 4, one kv
head, a 64-wide rope key and a 512-wide latent, 691 slots): the device
kernels each session recorded against the calls it made.  Shapes: a plain
session of 20 and of 100 calls; a session with a warm-up window of 20 calls
before 20 recorded ones (`torch.profiler.schedule`, as `chip_smoke.py`'s
`device_ms`), of 100, after a 50 ms pause, and with 20 calls after the
recorded window.  Prints each shape's shortfalls and writes every count
(and the card's name and power limit) to OUT.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch.core import saliency as sal
from repro_torch.kernels import build
from repro_torch.kernels.cst_quant import kernel as cst

SESSIONS = 40


def _kernels(events) -> int:
    return sum(1 for e in events if e.device_type.name == "CUDA"
               and not e.name.startswith("ProfilerStep")
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())


def _plain(fn, iters: int) -> int:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _kernels(prof.events())


def _scheduled(fn, iters: int, tail: int = 0, pause: float = 0.0) -> int:
    if pause:
        time.sleep(pause)
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.events())) as prof:
        for window in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        for _ in range(tail):
            fn()
        torch.cuda.synchronize()
    return _kernels(traces[-1]) if traces else 0


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    kpe = torch.randn(4, 1, 1024, 64, generator=gen, device=dev).bfloat16()
    lat = torch.randn(4, 1, 1024, 512, generator=gen, device=dev).bfloat16()
    _, reg = sal.salient_split(torch.rand((4, 1024), generator=gen, device=dev), 410)
    sidx = torch.nn.functional.pad(reg, (0, 691 - reg.shape[1]), value=-1)

    def fn():
        cst.quantize_store(kpe, lat, sidx, 2)

    fn()
    torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card}
    shapes = (("plain 20", 20, lambda: _plain(fn, 20)),
              ("warm-up + 20", 20, lambda: _scheduled(fn, 20)),
              ("warm-up + 20 after a 50 ms pause", 20, lambda: _scheduled(fn, 20, pause=0.05)),
              ("warm-up + 100", 100, lambda: _scheduled(fn, 100)),
              ("plain 100", 100, lambda: _plain(fn, 100)),
              ("warm-up + 20, 20 calls after", 20, lambda: _scheduled(fn, 20, tail=20)))
    for name, want, run in shapes:
        counts = [run() for _ in range(SESSIONS)]
        out[name] = {"calls": want, "kernels": counts}
        short = [i for i, c in enumerate(counts) if c < want]
        print(f"{name}: {len(short)} of {SESSIONS} sessions short (sessions {short}, "
              f"kernels {[counts[i] for i in short]}; {card})", flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
