"""threefry2x32 over device tensors, and the seeded sampler built on it.

The reference draws a sampled token from `jax.random` (`fold_in`,
`categorical`).  These functions compute the same bits as jax in the
`jax_threefry_partitionable=True` mode, row by row:

  * `key(seeds)`: `PRNGKey(seed)` per row, `[0, seed & 0xFFFFFFFF]`;
  * `fold_in(keys, data)`: `jax.random.fold_in` per row;
  * `random_bits32(keys, n)`: `jax.random.bits(key, (n,), uint32)` per row,
    drawn from a 64-bit iota counter (hi word 0, lo word the column);
  * `gumbel(keys, n)`: `jax.random.gumbel(key, (n,), float32)` ("low"
    mode), the uniform built from the bits as jax builds it;
  * `sample_tokens(logits, temps, seeds, counters)`: the reference engine's
    `_sample_tokens`, greedy or Gumbel-max per row, counted in `SAMPLES`.

Keys are (b, 2) tensors and draws (b, n).  The uint32 arithmetic runs in
int64 with `& 0xFFFFFFFF` after every add and shift: torch's int32 add
wraps only by accident, and its uint32 operations are incomplete on CUDA.
Every function is a pure function of its tensors, with no generator state
and no host value, so it runs inside a captured CUDA graph.  The numpy
threefry of `core.saliency` computes the same bits on the host.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The 20-round threefry2x32 block on int64 tensors holding uint32 values
    (broadcast together)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = a ^ _rotl(b, r)
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def key(seeds: torch.Tensor) -> torch.Tensor:
    """(b,) integer seeds -> (b, 2) int64 keys, `PRNGKey(seed)` per row."""
    lo = seeds.to(torch.int64) & _M32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(b, 2) keys and (b,) integers -> (b, 2) keys, `fold_in` per row."""
    d = data.to(torch.int64) & _M32
    a, b = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits32(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(b, 2) keys -> (b, n) int64 holding each row's 32-bit random bits."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return a ^ b


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(b, n) f32 uniforms in [tiny, 1) as `jax.random.uniform(key, (n,),
    minval=tiny, maxval=1)` makes them: 23 mantissa bits over 1.0, minus 1,
    scaled by 1 - tiny (1.0 in f32), plus tiny, floored at tiny."""
    bits = (random_bits32(keys, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(b, n) f32 standard Gumbel noise, `-log(-log(u))` of `uniform`."""
    return -torch.log(-torch.log(uniform(keys, n)))


# sampler runs: eager calls of `sample_tokens`, and its graph's replays
SAMPLES = build.Counter()


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, seeds: torch.Tensor,
                  counters: torch.Tensor) -> torch.Tensor:
    """Per-row greedy or temperature sampling, (b, vocab) -> (b,) int32.

    A row with temperature 0 takes the argmax of its logits in their own
    dtype; any other row the argmax of Gumbel noise keyed on
    `fold_in(PRNGKey(seed), counter)` plus its f32 logits divided by
    max(temperature, 1e-3) (`jax.random.categorical`).  Ties go to the
    lowest index.  The division is tensor by tensor: on CUDA, PyTorch
    divides by a Python number as a multiply by its reciprocal.  Reads
    `logits` and writes nothing."""
    SAMPLES.launches += 1
    keys = fold_in(key(seeds), counters)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / torch.maximum(temps, torch.full_like(temps, 1e-3))[:, None]
    sampled = torch.argmax(gumbel(keys, logits.shape[-1]) + scaled, dim=-1)
    return torch.where(temps > 0, sampled.to(torch.int32), greedy)
