"""Token-saliency metrics, probe selection and the salient-token partition
(port of `repro.core.saliency`).

The exact metrics need the full attention matrix: the accumulated score of
Eq. 7 (H2O, MiKV) and the normalized score of Eq. 8 (ZipCache).  The probe
approximation of Eq. 9 substitutes a few probe rows into Eq. 8.

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

from repro_torch.models import common

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
# Exact metrics
# ---------------------------------------------------------------------------

def accumulated_scores(attn: torch.Tensor) -> torch.Tensor:
    """Eq. 7: column sums of the (causal) attention matrix.
    attn (..., q_len, kv_len) -> (..., kv_len)."""
    return attn.sum(dim=-2)


def causal_nnz(q_len: int, kv_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """nnz(A[:, i]) of a causal matrix whose queries are the LAST q_len
    positions of a kv_len-long sequence: min(q_len, kv_len - i)."""
    i = torch.arange(kv_len, device=device)
    return torch.clamp(kv_len - i, max=q_len).to(dtype)


def normalized_scores(attn: torch.Tensor, nnz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 8: accumulated scores over per-column non-zero counts; `nnz`
    defaults to the causal structure (queries are the last q_len rows)."""
    if nnz is None:
        nnz = causal_nnz(attn.shape[-2], attn.shape[-1], dtype=attn.dtype, device=attn.device)
    return accumulated_scores(attn) / nnz.clamp_min(1.0)


def head_mean(saliency: torch.Tensor, head_axis: int = -2) -> torch.Tensor:
    """Saliency averaged over heads: the cache quantizes whole tokens."""
    return saliency.mean(dim=head_axis)


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


def probe_normalized_scores(attn_probe: torch.Tensor, probe_positions: torch.Tensor,
                            kv_len: int) -> torch.Tensor:
    """Eq. 8 on probe rows only (the Eq. 9 substitution).  attn_probe
    (..., n_probes, kv_len): causal softmax rows of the probe queries at
    absolute positions `probe_positions`; a column's nnz is the number of
    probes at or after it."""
    pos = probe_positions.to(attn_probe.device)[:, None]
    col = torch.arange(kv_len, device=attn_probe.device)[None, :]
    nnz = (pos >= col).to(attn_probe.dtype).sum(dim=0)
    return attn_probe.sum(dim=-2) / nnz.clamp_min(1.0)


def probe_scores_from_qk(q: torch.Tensor, k: torch.Tensor, probe: ProbeSpec,
                         scale: Optional[float] = None, pool_heads: bool = True) -> torch.Tensor:
    """Probe-row attention (standard softmax) and its normalized saliency,
    from Q/K directly (Eq. 9 into Eq. 8): the plain path that the probe
    kernels' column sums replace.  q (..., h, q_len, d), k (..., h, kv_len,
    d) -> (..., kv_len), or (..., h, kv_len) without `pool_heads`."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d), device=q.device)).to(q.dtype)
    positions = probe.positions.to(q.device)
    qp = q.index_select(-2, positions.long())
    logits = common.einsum("...pd,...kd->...pk", qp * scale, k).float()
    kv_len = k.shape[-2]
    mask = positions[:, None] >= torch.arange(kv_len, device=q.device)[None, :]
    a = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    sal = probe_normalized_scores(a, positions, kv_len)
    if pool_heads and sal.dim() >= 2:
        sal = sal.mean(dim=-2)
    return sal


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
