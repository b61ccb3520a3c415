"""The cache-store kernel and the stores around it, measured on the card.

    PYTHONPATH=src python -m repro_torch.kernels.store_splits [--phases splits,stores,proj,model]

At the lockstep path's shapes (yi-6b widths: 4 kv heads, d 128; prompt 1024
into an 1152-token cache, zipcache defaults):
  splits  `cst_quant.quantize_store` at each grid design, batch 4 and 1,
          the hi (4-bit, 461 slots) and lo (2-bit, 691 slots) stores: the
          wrapper's own choice, then 1 CTA per (batch row, kv head, tensor)
          and clusters of 2, 4 and 8; device ms by kernel (torch.profiler),
          CUDA-event ms, and whether the outputs equal the plain version's;
  stores  one layer's `kvcache.compress_prefill` and `kvcache.recompress`
          (after 40 appends), `use_kernel` on and off: the device kernels,
          the host-issued aten ops, and the ops that touch the K / V payload
          (an input shaped (b, hk, *, d));
  proj    the attention-output projection at decode (batch 4) and prefill
          (batch 4 x 1024) through `common.out_proj` and through
          `torch.einsum`: copies and clones of wo, in any order of its
          axes (record_shapes), device kernels and device ms;
  model   yi-6b at full width (random weights, seed 0), batch 4: device
          kernels and device ms of one prefill, one non-probe decode step
          and one recompression, and the wall times of 5 prefills.
The stores and model phases use only what earlier trees of the port have,
so the same file measures a parent tree:
    PYTHONPATH=<parent>/src python src/repro_torch/kernels/store_splits.py --phases stores,model
Prints one line per measurement and a JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch import configs
from repro_torch.core import kvcache as kvc
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels.paged_splits import _device_ms, _events_ms

B, HK, L, D, MAX_LEN = 4, 4, 1024, 128, 1152


def _profile(fn, record_shapes=False):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def _summary(events) -> dict:
    """Device kernels (count, ms, by name) and the host-issued aten ops."""
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    top = [e for e in events if e.device_type.name == "CPU" and e.name.startswith("aten::")
           and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    by_name: dict = {}
    for e in kernels:
        key = e.name.split("(")[0][:60]
        by_name[key] = by_name.get(key, 0) + 1
    return {"device_kernels": len(kernels),
            "device_ms": sum(e.device_time for e in kernels) / 1e3,
            "aten_ops": len(top), "kernels_by_name": by_name}


def _store_operands(dev, b, gen):
    ccfg = CompressionConfig.zipcache()
    s_hi, s_lo, _ = kvc.capacities(ccfg, MAX_LEN)
    k = torch.randn((b, HK, L, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, HK, L, D), generator=gen, device=dev).to(torch.bfloat16)
    hi, lo = sal.salient_split(torch.rand((b, L), generator=gen, device=dev),
                               ccfg.n_salient(L))
    pad = torch.nn.functional.pad
    return k, v, {"hi": (ccfg.high_bits, pad(hi, (0, s_hi - hi.shape[1]), value=-1)),
                  "lo": (ccfg.low_bits, pad(lo, (0, s_lo - lo.shape[1]), value=-1))}


def splits(dev, iters: int = 50) -> dict:
    from repro_torch.kernels.cst_quant import kernel as K
    from repro_torch.kernels.cst_quant import ref

    res = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in (4, 1):
        k, v, stores = _store_operands(dev, b, gen)
        for name, (bits, idx) in stores.items():
            want = ref.quantize_store_ref(k, v, idx, bits)
            for split in (None, 1, 2, 4, 8):
                fn = lambda: K.quantize_store(k, v, idx, bits, split=split)  # noqa: E731
                exact = all(torch.equal(a, w) for a, w in zip(fn(), want))
                tag = f"split{split}" if split else f"auto (split{K._split(2 * b * HK)})"
                res[f"batch{b}-{name}-{tag}"] = {"exact": exact, "device_ms": _device_ms(fn, iters),
                                                 "events_ms": _events_ms(fn, iters)}
    return res


def _payload_ops(events, b):
    """aten ops with an input shaped (b, hk, *, d): the ones on the K / V payload."""
    ops: dict = {}
    for e in events:
        if e.device_type.name == "CPU" and e.name.startswith("aten::") and any(
                len(s) == 4 and s[0] == b and s[1] == HK and s[3] == D
                for s in (e.input_shapes or ())):
            ops[e.name] = ops.get(e.name, 0) + 1
    return ops


def stores(dev) -> dict:
    ccfg = CompressionConfig.zipcache()
    gen = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn((B, HK, L, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, HK, L, D), generator=gen, device=dev).to(torch.bfloat16)
    saliency = torch.rand((B, L), generator=gen, device=dev)
    cache = kvc.compress_prefill(ccfg, k, v, saliency, MAX_LEN)
    for _ in range(40):
        kt = torch.randn((B, HK, D), generator=gen, device=dev).to(torch.bfloat16)
        cache = kvc.append_token(cache, kt, kt)
    res = {}
    for use_kernel in (True, False):
        for what, fn in (("compress_prefill", lambda: kvc.compress_prefill(
                              ccfg, k, v, saliency, MAX_LEN, use_kernel=use_kernel)),
                         ("recompress", lambda: kvc.recompress(ccfg, cache,
                                                               use_kernel=use_kernel))):
            events = _profile(fn, record_shapes=True)
            res[f"{what}-{'kernel' if use_kernel else 'plain'}"] = dict(
                _summary(events), payload_ops=_payload_ops(events, B))
    return res


def proj(dev) -> dict:
    from repro_torch.models import common

    gen = torch.Generator(device=dev).manual_seed(2)
    h, e = 32, 4096
    wo = (torch.randn((h, D, e), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    dec = torch.randn((B, h, D), generator=gen, device=dev).to(torch.bfloat16)
    pre = torch.randn((B, h, L, D), generator=gen, device=dev).to(torch.bfloat16)
    forms = {"decode-out_proj": lambda: common.out_proj(dec, wo),
             "decode-einsum": lambda: torch.einsum("bhd,hde->be", dec, wo),
             "prefill-out_proj": lambda: common.out_proj(pre.transpose(1, 2), wo),
             "prefill-einsum": lambda: torch.einsum("bhld,hde->ble", pre, wo)}
    res = {}
    for name, fn in forms.items():
        events = _profile(fn, record_shapes=True)
        copies = [f"{ev.name} {ev.input_shapes[0]}" for ev in events
                  if ev.name in ("aten::copy_", "aten::clone") and ev.input_shapes
                  and sorted(n for n in ev.input_shapes[0] if n > 1) == sorted(wo.shape)]
        res[name] = dict(_summary(events), weight_copies=copies)
    return res


def model(dev, n_wall: int = 5) -> dict:
    from repro_torch.models import registry
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = configs.get_arch("yi-6b")
    ccfg = CompressionConfig.zipcache()
    params = registry.materialize_params(cfg, seed=0, device=dev)
    eng = ServingEngine(cfg, ccfg, ServeConfig(batch_size=B, prompt_len=L, max_new_tokens=128,
                                               seed=0), params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(2, cfg.vocab, (B, L), generator=gen, device=dev, dtype=torch.int32)
    res = {}
    with torch.inference_mode():
        prefill = lambda: registry.prefill(params, {"tokens": toks}, cfg, eng.ctx)  # noqa: E731
        res["prefill"] = _summary(_profile(prefill))
        walls = []
        for _ in range(n_wall):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res["prefill"].update(wall_s=walls, wall_median_s=statistics.median(walls))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        res["decode_step"] = _summary(_profile(
            lambda: registry.decode_step(params, tok, caches, cfg, eng.ctx, False)))
        res["recompress"] = _summary(_profile(lambda: registry.recompress(caches, cfg, eng.ctx)))
    return res


PHASES = {"splits": splits, "stores": stores, "proj": proj, "model": model}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="splits,stores,proj,model")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("store_splits: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out = {}
    for phase in args.phases.split(","):
        out[phase] = PHASES[phase](dev)
        for tag, r in out[phase].items():
            brief = {k: v for k, v in r.items() if k != "kernels_by_name"}
            print(f"[store_splits] {phase} {tag}: {json.dumps(brief)}", flush=True)
            if "kernels_by_name" in r and phase != "model":
                print(f"[store_splits]   kernels: {json.dumps(r['kernels_by_name'])}")
    print(json.dumps({"card": smi, "seconds": time.perf_counter() - t0, "runs": out}))


if __name__ == "__main__":
    main()
