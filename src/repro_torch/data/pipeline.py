"""Deterministic, resumable, shard-aware token data pipeline (a copy of
`repro.data.pipeline`, numpy only: the batches are numpy arrays, which
the train loop moves to the device).

Sources:
  * synthetic  — counter-based hashed token streams with planted structure
                 (Zipf-ish marginals + copy/retrieval patterns) so tiny models
                 have something learnable; fully deterministic in (seed, step)
  * file       — memory-mapped uint16/uint32 token binaries, strided by host

Properties a 1000-node job needs:
  * O(1) resume: state == (seed, step); checkpoint stores just integers.
  * per-host sharding: each data-parallel host reads only its slice
    (host_id, num_hosts), no coordination.
  * background prefetch: a double-buffer thread keeps one batch ahead.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | file
    path: Optional[str] = None         # token binary for source="file"
    dtype: str = "uint16"
    host_id: int = 0
    num_hosts: int = 1
    frontend_tokens: int = 0           # vlm/audio stubs: embeds prepended
    d_model: int = 0                   # for frontend embed synthesis
    encdec: bool = False


class TokenPipeline:
    """Iterator of batches: {tokens, labels[, frontend_embeds]} np arrays."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global batch must divide across hosts")
        self.cfg = cfg
        self.step = start_step
        self._mm = None
        if cfg.source == "file":
            self._mm = np.memmap(cfg.path, dtype=cfg.dtype, mode="r")
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    @staticmethod
    def restore(cfg: DataConfig, state: Dict[str, int]) -> "TokenPipeline":
        return TokenPipeline(cfg, start_step=int(state["step"]))

    # ------------------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_id]))

    def _synthetic_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // cfg.num_hosts
        rng = self._rng(step)
        l = cfg.seq_len + 1
        # Zipf-ish marginal + planted copy structure: second half repeats a
        # shifted window of the first half -> a tiny model can learn copying,
        # giving benchmarks a non-flat quality signal.
        ranks = rng.zipf(1.3, size=(b, l)).astype(np.int64)
        toks = (ranks % (cfg.vocab - 2)) + 2
        half = l // 2
        src = toks[:, :half]
        toks[:, half:half + half // 2] = src[:, : half // 2]
        toks = toks.astype(np.int32)
        tokens, labels = toks[:, :-1], toks[:, 1:]
        if cfg.frontend_tokens:
            n_f = cfg.frontend_tokens
            tokens = tokens[:, : cfg.seq_len - n_f]
            labels = labels[:, : cfg.seq_len - n_f]
            fe = rng.standard_normal((b, n_f, cfg.d_model)).astype(np.float32)
            return {"tokens": tokens, "labels": labels, "frontend_embeds": fe}
        if cfg.encdec:
            fe = rng.standard_normal((b, cfg.seq_len, cfg.d_model)).astype(np.float32)
            return {"tokens": tokens, "labels": labels, "frontend_embeds": fe}
        return {"tokens": tokens, "labels": labels}

    def _file_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // cfg.num_hosts
        l = cfg.seq_len + 1
        n_tokens = self._mm.shape[0]
        n_windows = n_tokens // l
        rng = self._rng(step)
        idx = rng.integers(0, n_windows, size=(b,))
        rows = np.stack([self._mm[i * l:(i + 1) * l] for i in idx]).astype(np.int32)
        rows = np.clip(rows, 0, cfg.vocab - 1)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        if self.cfg.source == "synthetic":
            return self._synthetic_batch(step)
        return self._file_batch(step)

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
