"""Quickstart (port of `examples/quickstart.py`): ZipCache on raw tensors --
compress a KV cache, decode against it, stream new tokens, recompress
(paper Alg. 1/2/3).

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The tensors are the JAX example's draws (numpy, seed 0), so on the CPU it
prints the JAX example's figures.  The stores go through `cst_quant`'s
wrapper (its kernel on the card, its plain version on the CPU).
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import kvcache as kvc
from repro_torch.core import quant
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    b, h_kv, h_q, l, d = 2, 4, 8, 256, 64

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    # 1. a KV cache worth of tensors (pretend they came out of attention)
    k, v = draw(b, h_kv, l, d), draw(b, h_kv, l, d)

    # 2. channel-separable tokenwise quantization (paper Alg. 1) on its own
    qt = quant.quantize(v[0, 0], 4, "cst")
    mse = float(torch.mean((qt.dequantize() - v[0, 0]) ** 2))
    print(f"CSTQuant 4-bit: {v[0, 0].numel() * 4} B -> {qt.nbytes_packed()} B, mse={mse:.5f}")

    # 3. saliency: normalized attention scores via 10% probe rows (Eq. 8/9)
    q_full = draw(b, h_q, l, d)
    probe = sal.select_probes(l, "random+recent", probe_ratio=0.10, seed=0, device=dev)
    saliency = sal.probe_scores_from_qk(q_full, k.repeat_interleave(h_q // h_kv, 1), probe)
    top = int(torch.argmax(saliency[0]))
    print(f"probe saliency: {tuple(saliency.shape)}, top token = {top}")

    # 4. mixed-precision compression: top-40% tokens 4-bit, rest 2-bit (Alg. 2)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(saliency_ratio=0.4),
                               fp_window=16, recompress_interval=16)
    cache = kvc.compress_prefill(ccfg, k, v, saliency, max_len=l + 64, dtype=torch.float32,
                                 use_kernel=True)
    raw = 2 * b * h_kv * l * d * 2  # bf16 equivalent
    print(f"mixed 4/2 cache: {raw} B bf16 -> {cache.nbytes_packed()} B packed "
          f"({raw / cache.nbytes_packed():.2f}x)")

    # 5. decode a few tokens against the compressed cache (Alg. 3)
    folds = []
    for step in range(20):
        q_t, k_t, v_t = draw(b, h_q, d), draw(b, h_kv, d), draw(b, h_kv, d)
        cache = kvc.append_token(cache, k_t, v_t)
        out = kvc.attend_decode(q_t, cache)
        cache = kvc.update_probe_state(cache, out.slot_weights, step % 4 == 0)
        if bool((cache.win_fill >= cache.window).all()):
            cache = kvc.recompress(ccfg, cache, use_kernel=True)  # streaming recompression
            folds.append((step, int(cache.length[0])))
            print(f"  step {step}: recompressed; live tokens = {folds[-1][1]}")
    print("attention out:", tuple(out.out.shape), "— done")
    return {"mse": mse, "top": top, "packed": cache.nbytes_packed(), "folds": folds,
            "out": out.out}


if __name__ == "__main__":
    main()
