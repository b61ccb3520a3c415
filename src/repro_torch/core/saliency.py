"""Probe selection and salient-token partition (port of `repro.core.saliency`).

`select_probes` reproduces the reference's probe positions exactly.  Its
random half comes from `jax.random.randint` on a threefry2x32 key; the
numpy threefry below follows `jax/_src/prng.py` and `jax/_src/random.py`
in the `jax_threefry_partitionable=True` mode (the default of current jax):
`PRNGKey(0)`, `fold_in(key, seed)`, `split(key)` and 32-bit `random_bits`
drawn from a 64-bit iota counter, then randint's two-draw modulus.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# threefry2x32 (numpy, uint32 arrays wrap on overflow)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _threefry2x32(k1: np.ndarray, k2: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """The 20-round threefry2x32 block (uint32 arrays of one shape)."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a non-negative 32-bit seed."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _fold_in(key: np.ndarray, data: int) -> np.ndarray:
    o1, o2 = _threefry2x32(key[:1], key[1:], np.zeros(1, np.uint32),
                           np.array([data & 0xFFFFFFFF], np.uint32))
    return np.concatenate([o1, o2])


def _split2(key: np.ndarray):
    b1, b2 = _threefry2x32(key[:1], key[1:], np.zeros(2, np.uint32),
                           np.arange(2, dtype=np.uint32))
    return np.array([b1[0], b2[0]], np.uint32), np.array([b1[1], b2[1]], np.uint32)


def _random_bits32(key: np.ndarray, n: int) -> np.ndarray:
    b1, b2 = _threefry2x32(key[:1], key[1:], np.zeros(n, np.uint32),
                           np.arange(n, dtype=np.uint32))
    return b1 ^ b2


def _randint(key: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, (n,), minval, maxval)` for int32 bounds."""
    k1, k2 = _split2(key)
    hi, lo = _random_bits32(k1, n), _random_bits32(k2, n)
    span = np.uint32(maxval - minval if maxval > minval else 1)
    mult = np.uint32((1 << 16) % int(span))
    mult = np.array([mult], np.uint32) * mult % span
    off = ((hi % span) * mult + lo % span) % span
    return (minval + off.astype(np.int64)).astype(np.int32)


def _hash_positions(n: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """n pseudo-random positions in [lo, hi), equal to the reference's."""
    key = _fold_in(_key(0), seed)
    return lo + _randint(key, n, 0, max(hi - lo, 1))


# ---------------------------------------------------------------------------
# Probe selection (paper §4.3, Table 2)
# ---------------------------------------------------------------------------

class ProbeSpec(NamedTuple):
    """Static probe layout: absolute query positions used as probes."""

    positions: torch.Tensor  # (n_probes,) int32, sorted (may repeat)
    n_recent: int
    n_random: int


def select_probes(
    seq_len: int,
    strategy: str = "random+recent",
    probe_ratio: float = 0.10,
    seed: int = 0,
    special_positions: Optional[torch.Tensor] = None,
    device=None,
) -> ProbeSpec:
    """Choose probe QUERY rows (static count = round(probe_ratio * seq_len)).

    Strategies: 'all' | 'random' | 'special' | 'recent' | 'random+recent'
    (half recent, half random).  The random half draws WITH replacement, so
    positions can repeat at long prompts, exactly as in the reference.
    """
    n = max(1, int(round(probe_ratio * seq_len)))
    n_recent = n_random = 0
    if strategy == "all":
        pos = np.arange(seq_len, dtype=np.int32)
    elif strategy == "recent":
        pos, n_recent = np.arange(seq_len - n, seq_len, dtype=np.int32), n
    elif strategy == "random":
        pos, n_random = np.sort(_hash_positions(n, 0, seq_len, seed)), n
    elif strategy == "special":
        if special_positions is None:
            raise ValueError("'special' strategy needs special_positions")
        return ProbeSpec(special_positions.to(torch.int32)[:n].to(device), 0, 0)
    elif strategy == "random+recent":
        n_recent = n // 2
        n_random = n - n_recent
        recent = np.arange(seq_len - n_recent, seq_len, dtype=np.int32)
        rand = _hash_positions(n_random, 0, max(seq_len - n_recent, 1), seed)
        pos = np.sort(np.concatenate([rand, recent]))
    else:
        raise ValueError(f"unknown probe strategy {strategy!r}")
    return ProbeSpec(torch.as_tensor(pos, dtype=torch.int32, device=device),
                     n_recent, n_random)


# ---------------------------------------------------------------------------
# Salient-token partition
# ---------------------------------------------------------------------------

def salient_split(saliency: torch.Tensor, n_salient: int):
    """Top-k split into (salient_idx, regular_idx), both sorted ascending.

    Ranks with a STABLE descending sort, so equal scores keep the lower index
    first, as `jax.lax.top_k` does (ties are common: window tokens that were
    never probed all score 0).  Returns int32 (..., n) and (..., l - n).
    """
    n_salient = int(n_salient)
    idx = torch.sort(saliency, dim=-1, descending=True, stable=True).indices
    salient = torch.sort(idx[..., :n_salient], dim=-1).values
    regular = torch.sort(idx[..., n_salient:], dim=-1).values
    return salient.to(torch.int32), regular.to(torch.int32)
