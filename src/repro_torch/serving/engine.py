"""Lockstep serving engine (port of the lockstep half of
`repro.serving.engine`): one packed batch prefills together, then decodes
a fixed number of greedy steps with ZipCache streaming recompression
(paper Alg. 2/3).

The probe flag of each step is a host bool from `probe_flag`; it picks the
decode path (exact softmax on probe steps, the decode kernel otherwise)
with no device sync.  Tokens stay on the device until the loop ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.policy import CompressionConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry


def probe_flag(counter: int, interval: int, seed: int = 0) -> bool:
    """Probe schedule: the most recent ~5% of each recompress interval plus
    a hashed pseudo-random ~5% of steps, on the request's token counter."""
    n_recent = max(interval // 20, 1)
    recent = (counter % interval) >= interval - n_recent
    h = (counter * 2654435761 + seed * 40503 + 12345) & 0xFFFFFFFF
    rand = ((h >> 8) % 100) < 5
    return bool(recent or rand)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The fields the lockstep path reads."""
    batch_size: int                  # rows of the packed batch
    prompt_len: int                  # static prompt length (left-padded)
    max_new_tokens: int = 128        # decode budget (the cache is sized for it)
    seed: int = 0


def pack_requests(requests: Sequence[np.ndarray], batch_size: int,
                  prompt_len: int, pad_id: int = 0) -> np.ndarray:
    """Left-pad + stack request prompts into a fixed-shape batch; raises on
    overflow instead of truncating."""
    if len(requests) > batch_size:
        raise ValueError(f"{len(requests)} requests exceed batch_size {batch_size}")
    out = np.full((batch_size, prompt_len), pad_id, np.int32)
    for i, r in enumerate(requests):
        r = np.asarray(r)
        if r.shape[-1] > prompt_len:
            raise ValueError(f"prompt of {r.shape[-1]} tokens exceeds prompt_len {prompt_len}")
        out[i, prompt_len - len(r):] = r
    return out


class ServingEngine:
    """Lockstep batch generation: all requests prefill together and decode
    the same number of greedy steps."""

    def __init__(self, cfg: ArchConfig, ccfg: CompressionConfig, scfg: ServeConfig, params,
                 device="cuda", use_kernels: bool = True):
        self.cfg = cfg
        self.ccfg = ccfg
        self.scfg = scfg
        self.params = params
        self.device = torch.device(device)
        shape = ShapeConfig("serve", scfg.prompt_len, scfg.batch_size, "prefill")
        self.ctx = steps_lib.serve_ctx(cfg, shape, ccfg, decode_budget=scfg.max_new_tokens,
                                       q_block=min(512, scfg.prompt_len), device=self.device,
                                       use_kernels=use_kernels)
        self.last_caches = None

    def _is_probe(self, i: int) -> bool:
        return probe_flag(i, self.ccfg.recompress_interval, self.scfg.seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, np.ndarray],
                 max_new_tokens: Optional[int] = None) -> Dict[str, object]:
        """Prefill + streaming decode for one packed batch.

        batch: {"tokens": (b, prompt_len) int32}.
        Returns {"tokens": (b, n_new) int32 numpy, "timings": {...}}.
        """
        n_new = max_new_tokens if max_new_tokens is not None else self.scfg.max_new_tokens
        t0 = time.perf_counter()
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=self.device)
        logits, caches = registry.prefill(self.params, {"tokens": tokens}, self.cfg, self.ctx)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        t_prefill = time.perf_counter() - t0

        outs = []
        t1 = time.perf_counter()
        since_recompress = 0
        for i in range(n_new):
            outs.append(tok)
            logits, caches = registry.decode_step(self.params, tok, caches, self.cfg, self.ctx,
                                                  self._is_probe(i))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            since_recompress += 1
            if since_recompress >= self.ccfg.recompress_interval:
                caches = registry.recompress(caches, self.cfg, self.ctx)
                since_recompress = 0
        self._sync()
        t_decode = time.perf_counter() - t1
        self.last_caches = caches
        return {
            "tokens": torch.stack(outs, dim=1).cpu().numpy(),
            "timings": {"prefill_s": t_prefill, "decode_s": t_decode,
                        "tok_per_s": n_new * self.scfg.batch_size / max(t_decode, 1e-9)},
        }
