"""Long-context retrieval under compression (port of
`examples/longcontext_retrieval.py`; paper Fig. 5 as a demo): plant a
needle in a long cache, compress under each policy, retrieve.

    PYTHONPATH=src python -m repro_torch.examples.longcontext_retrieval            # card
    PYTHONPATH=src python -m repro_torch.examples.longcontext_retrieval --device cpu

The draws are the JAX example's (numpy, seed 1), so on the CPU it prints
the JAX example's figures.  --length and --trials size a shorter run.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--length", type=int, default=1024)
    ap.add_argument("--trials", type=int, default=8)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    l, d, hkv, trials = args.length, 64, 4, args.trials
    rng = np.random.default_rng(1)
    policies = {
        "fp16": CompressionConfig.fp16(),
        "h2o(evict 60%)": CompressionConfig.h2o(keep_ratio=0.4),
        "zipcache(4/2)": CompressionConfig.zipcache(saliency_ratio=0.4),
    }
    print(f"== needle retrieval from an l={l} cache ==")
    figures = {}
    for name, pol in policies.items():
        hits, errs = 0, []
        for _ in range(trials):
            k = rng.normal(size=(1, hkv, l, d)).astype(np.float32)
            v = rng.normal(size=(1, hkv, l, d)).astype(np.float32)
            needle = int(rng.integers(l // 2, l - 64))
            q_dir = rng.normal(size=(d,)).astype(np.float32)
            q_dir /= np.linalg.norm(q_dir)
            k[0, :, needle] = q_dir * 64.0
            v_needle = v[0, 0, needle].copy()
            # accumulated-score bias buries late needles for H2O (Fig. 3)
            base = rng.uniform(0, 0.1, size=(1, l)).astype(np.float32)
            base[0, needle] += 0.3
            s = base + (np.linspace(1.2, 0, l)[None] if "h2o" in name else 0)
            ccfg = dataclasses.replace(pol, fp_window=16, recompress_interval=16)
            cache = kvc.compress_prefill(
                ccfg, torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev),
                torch.from_numpy(s.astype(np.float32)).to(dev), max_len=l + 16,
                dtype=torch.float32, use_kernel=True)
            q = torch.from_numpy(np.tile(q_dir, (1, 2 * hkv, 1)).astype(np.float32)).to(dev)
            out = kvc.attend_decode(q, cache)
            pos = torch.cat([cache.hi.pos, cache.lo.pos, cache.win_pos], 1)
            hits += int(int(pos[0, int(torch.argmax(out.slot_weights[0]))]) == needle)
            got = out.out[0, 0].cpu().numpy()
            errs.append(float(np.linalg.norm(got - v_needle) / np.linalg.norm(v_needle)))
        raw = 2 * hkv * l * d * 2
        ratio = raw / cache.nbytes_packed() * 1.0
        figures[name] = (hits, float(np.mean(errs)), ratio)
        print(f"  {name:16s} recall={hits}/{trials}  value_err={np.mean(errs):.3f}  "
              f"cache={ratio:.1f}x smaller" if name != "fp16" else
              f"  {name:16s} recall={hits}/{trials}  value_err={np.mean(errs):.3f}")
    return figures


if __name__ == "__main__":
    main()
