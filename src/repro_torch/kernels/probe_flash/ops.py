"""`probe_flash_attention`: the kernel-backed mirror of
`models.attention.blocked_attention` (prefill attention + probe colsum).

Probe rows go to the colsum kernel de-duplicated.  `select_probes` draws its
random half with replacement, so positions repeat at long prompts;
`blocked_attention` builds a row MASK, so a repeated row counts once, and
this wrapper follows it by marking every repeat as a padding row (pos -1).
The reference's Pallas wrapper gathers rows by position and would count a
repeat twice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import saliency as sal
from repro_torch.kernels.probe_flash import kernel as K


def unique_probe_rows(positions: torch.Tensor) -> torch.Tensor:
    """Sorted probe positions with every repeat replaced by -1 (no host sync)."""
    pos = torch.sort(positions.to(torch.int32)).values
    first = torch.ones_like(pos, dtype=torch.bool)
    first[1:] = pos[1:] != pos[:-1]
    return torch.where(first, pos, torch.full_like(pos, -1))


def probe_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    probe: Optional[sal.ProbeSpec] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q (b,h,lq,d), k (b,hk,lkv,d), v (b,hk,lkv,dv) -> (out (b,h,lq,dv),
    colsum (b,lkv) | None)."""
    out, lse = K.flash_fwd(q, k, v, causal=causal)
    if probe is None:
        return out, None
    b, _, lq, _ = q.shape
    pos = unique_probe_rows(probe.positions.to(q.device))
    safe = pos.clamp(0, lq - 1).long()
    qp = q[:, :, safe]
    lse_p = lse[:, :, safe]
    pos_b = pos[None].expand(b, pos.shape[0])
    return out, K.probe_colsum(qp, lse_p, pos_b, k, causal=causal, lq=lq)
