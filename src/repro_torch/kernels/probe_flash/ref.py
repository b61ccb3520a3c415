"""Plain PyTorch versions of the probe-flash kernels.

Standard softmax attention with its LSE, and the probe column sum (Eq. 9
numerator) of given probe rows, both with materialized scores (the thing
the kernels never do).  Float32 throughout, like the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (b,h,lq,d), k/v (b,hk,lkv,d) -> (out (b,h,lq,dv) in q's dtype,
    lse (b,h,lq) f32).  Causal rows see columns <= row + lkv - lq."""
    b, h, lq, d = q.shape
    hk, lkv = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hk, g, lq, d).float() * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None] + (lkv - lq)
        s = s.masked_fill(rows < torch.arange(lkv, device=q.device)[None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0]
    return out.reshape(b, h, lq, -1).to(q.dtype), lse.reshape(b, h, lq)


def probe_colsum_ref(qp: torch.Tensor, lse_p: torch.Tensor, pos: torch.Tensor,
                     k: torch.Tensor, causal: bool = True, lq: int = None) -> torch.Tensor:
    """Column sums of softmax probabilities over probe rows, mean over heads.

    qp (b,h,np,d) probe queries, lse_p (b,h,np) their LSEs, pos (b,np)
    absolute probe rows (< 0 = padding), k (b,hk,lkv,d).  Returns (b,lkv) f32.
    """
    b, h, n_p, d = qp.shape
    hk, lkv = k.shape[1], k.shape[2]
    lq = lkv if lq is None else lq
    scale = 1.0 / (d ** 0.5)
    qg = qp.reshape(b, hk, h // hk, n_p, d).float() * scale
    s = torch.einsum("bhgpd,bhkd->bhgpk", qg, k.float()).reshape(b, h, n_p, lkv)
    p = torch.exp(s - lse_p[..., None])
    valid = (pos >= 0)[:, None, :, None]
    if causal:
        col = torch.arange(lkv, device=k.device)
        valid = valid & (pos[:, None, :, None] + (lkv - lq) >= col)
    p = torch.where(valid, p, torch.zeros((), device=p.device))
    return p.mean(dim=1).sum(dim=1)
