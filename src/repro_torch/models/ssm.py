"""Mamba2 SSD (state-space duality) mixer (port of `repro.models.ssm`,
arXiv:2405.21060).

Prefill runs the chunked SSD: within each chunk a quadratic,
attention-like term, across chunks the recurrent state, carried by a Python
loop over the chunks where the reference scans with `lax.scan`.  Decode runs
the one-token recurrence on the O(1) state: the (b, heads, head_dim,
d_state) f32 SSM state and one conv tail per stream (x, B, C).  The
projections are per stream (z, x, B, C, dt), as the reference declares them.

The numerics are the reference's: the clips to (-60, 0) before every
exponential, f32 accumulation of the scan and the recurrence, the casts
back to the activations' dtype, and the gated RMSNorm order norm(y *
silu(z)).  The f32 products assume TF32 is off
(`torch.backends.cuda.matmul.allow_tf32`, off by default).

One departure: `ssm_forward` takes a length that is not a multiple of the
chunk.  The reference asserts `l % min(chunk, l) == 0`; the continuous
engine's admission buckets are page-aligned, not chunk-aligned, so most of
them would fail there.  Here the last chunk is shorter.  That equals
padding it at the end with dt = 0, x = 0 rows: such a row leaves the state
and the earlier rows' outputs unchanged.  A length the reference accepts
keeps the reference's chunking.

ZipCache has nothing to compress here: a layer's cache element is its
`SSMState`, carried as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDef

CLIP = (-60.0, 0.0)   # every exponent of the scan and the recurrence


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def group_dim(cfg: ArchConfig) -> int:
    return cfg.ssm_n_groups * cfg.ssm_d_state


def ssm_schema(cfg: ArchConfig) -> dict:
    e, di, h, gd, dc = cfg.d_model, d_inner(cfg), n_ssm_heads(cfg), group_dim(cfg), cfg.ssm_d_conv
    return {
        "w_z": ParamDef((e, di), ("embed", "ssm_inner")),
        "w_x": ParamDef((e, di), ("embed", "ssm_inner")),
        "w_B": ParamDef((e, gd), ("embed", "ssm_state_in")),
        "w_C": ParamDef((e, gd), ("embed", "ssm_state_in")),
        "w_dt": ParamDef((e, h), ("embed", "ssm_heads")),
        "conv_x_w": ParamDef((dc, di), ("conv", "ssm_inner"), init="small"),
        "conv_x_b": ParamDef((di,), ("ssm_inner",), init="zeros"),
        "conv_B_w": ParamDef((dc, gd), ("conv", "ssm_state_in"), init="small"),
        "conv_B_b": ParamDef((gd,), ("ssm_state_in",), init="zeros"),
        "conv_C_w": ParamDef((dc, gd), ("conv", "ssm_state_in"), init="small"),
        "conv_C_b": ParamDef((gd,), ("ssm_state_in",), init="zeros"),
        "A_log": ParamDef((h,), ("ssm_heads",), init="zeros"),     # A = -exp(A_log) = -1
        "D": ParamDef((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "norm_w": ParamDef((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((di, e), ("ssm_inner", "embed")),
    }


@dataclasses.dataclass
class SSMState:
    """A layer's recurrent state, the SSM's cache element: a dataclass, so
    the cache-tree walks of `core.kvcache` (`tree_map`, `tree_leaves`,
    `tree_update_rows`, `tree_select_rows`) take it as they take a KV cache."""
    ssm: torch.Tensor       # (b, h, head_dim, d_state) f32
    conv_x: torch.Tensor    # (b, d_conv - 1, d_inner)
    conv_B: torch.Tensor    # (b, d_conv - 1, gd)
    conv_C: torch.Tensor    # (b, d_conv - 1, gd)


def init_state(cfg: ArchConfig, b: int, dtype=torch.float32, device=None) -> SSMState:
    dc = cfg.ssm_d_conv - 1
    return SSMState(
        ssm=torch.zeros((b, n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_d_state),
                        dtype=torch.float32, device=device),
        conv_x=torch.zeros((b, dc, d_inner(cfg)), dtype=dtype, device=device),
        conv_B=torch.zeros((b, dc, group_dim(cfg)), dtype=dtype, device=device),
        conv_C=torch.zeros((b, dc, group_dim(cfg)), dtype=dtype, device=device))


def _silu_to(x: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` (`logaddexp(x, 0)`) computes it.
    max(x, 0) is (x + |x|) / 2, the same value: its gradient at x = 0 is
    1/2, as JAX's, where `clamp_min`'s is 1."""
    return (x + x.abs()) * 0.5 + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b_: torch.Tensor, tail: torch.Tensor):
    """Depthwise causal conv1d + SiLU. x: (b, l, c); tail: (b, d_conv - 1, c).
    Returns (out, new tail), the tail in x's dtype."""
    dconv, l = w.shape[0], x.shape[1]
    xin = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xin[:, 0:l] * w[0]
    for i in range(1, dconv):
        out = out + xin[:, i:i + l] * w[i]
    out = out + b_
    new_tail = xin[:, xin.shape[1] - (dconv - 1):] if dconv > 1 else tail
    return _silu_to(out, x.dtype), new_tail


def _conv_step(x_t: torch.Tensor, w: torch.Tensor, b_: torch.Tensor, tail: torch.Tensor):
    """Single-token depthwise conv. x_t: (b, c); tail: (b, d_conv - 1, c)."""
    xin = torch.cat([tail, x_t[:, None, :].to(tail.dtype)], dim=1)
    out = xin[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        out = out + xin[:, i] * w[i]
    out = out + b_
    return _silu_to(out, x_t.dtype), xin[:, 1:]


def _exp_clip(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(t, *CLIP))


def _ssd_chunk_scan(xh, B, C, dA, dt, chunk: int, init_state: Optional[torch.Tensor] = None):
    """Chunked SSD, f32 throughout.

    xh: (b, l, h, p)   B, C: (b, l, g, n)   dA: (b, l, h) = dt*A   dt: (b, l, h).
    Returns (y (b, l, h, p), final state (b, h, p, n)).  Chunks of
    min(chunk, l) rows; the last one is shorter where l is not a multiple.
    Heads share their group's B and C (h // g heads a group): the products
    run on a (b, g, h // g, ...) view of the heads, B and C broadcast.
    """
    b, l, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    c = min(chunk, l)
    causal = torch.tril(torch.ones((c, c), dtype=torch.float32, device=xh.device))
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state)
    ys = []
    for start in range(0, l, c):
        stop = min(start + c, l)
        cl = stop - start
        xc = xh[:, start:stop].transpose(1, 2)            # (b, h, cl, p)
        Bc = B[:, start:stop].transpose(1, 2)[:, :, None]  # (b, g, 1, cl, n)
        Cc = C[:, start:stop].transpose(1, 2)[:, :, None]
        dtc = dt[:, start:stop].transpose(1, 2)           # (b, h, cl)
        cum = torch.cumsum(dA[:, start:stop].transpose(1, 2), dim=-1)   # (b, h, cl)
        total = cum[..., -1]                              # (b, h)
        # within the chunk: att[i, j] = (C_i . B_j) e^(cum_i - cum_j) dt_j, j <= i
        cb = torch.matmul(Cc, Bc.transpose(-1, -2))       # (b, g, 1, cl, cl)
        decay = _exp_clip(cum[..., :, None] - cum[..., None, :])
        att = (cb * decay.reshape(b, g, rep, cl, cl)).reshape(b, h, cl, cl)
        att = att * causal[:cl, :cl] * dtc[..., None, :]
        y_intra = torch.matmul(att, xc)                   # (b, h, cl, p)
        # across chunks: y_inter[i] = C_i . S_prev e^(cum_i)
        s_g = s.reshape(b, g, rep, p, n).transpose(-1, -2)
        y_inter = torch.matmul(Cc, s_g).reshape(b, h, cl, p) * _exp_clip(cum)[..., None]
        # S = S_prev e^(total) + sum_j e^(total - cum_j) dt_j x_j (x) B_j
        w_state = _exp_clip(total[..., None] - cum) * dtc   # (b, h, cl)
        xw = (xc * w_state[..., None]).transpose(-1, -2)     # (b, h, p, cl)
        upd = torch.matmul(xw.reshape(b, g, rep, p, cl), Bc).reshape(b, h, p, n)
        s = s * _exp_clip(total)[..., None, None] + upd
        ys.append((y_intra + y_inter).transpose(1, 2))      # (b, cl, h, p)
    return torch.cat(ys, dim=1), s


def ssm_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[SSMState] = None) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence SSD. x: (b, l, e) -> (y (b, l, e), the final decode
    state).  `state`: the state to continue from (zeros by default)."""
    b, l, _ = x.shape
    h, p, g, n = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_n_groups, cfg.ssm_d_state
    if state is None:
        state = init_state(cfg, b, x.dtype, device=x.device)
    z = common.matmul(x, params["w_z"])
    xi = common.matmul(x, params["w_x"])
    B = common.matmul(x, params["w_B"])
    C = common.matmul(x, params["w_C"])
    dt = common.matmul(x, params["w_dt"])

    xi, tail_x = _causal_conv(xi, params["conv_x_w"], params["conv_x_b"], state.conv_x)
    B, tail_B = _causal_conv(B, params["conv_B_w"], params["conv_B_b"], state.conv_B)
    C, tail_C = _causal_conv(C, params["conv_C_w"], params["conv_C_b"], state.conv_C)

    dt = _softplus(dt.float() + params["dt_bias"].float())
    dA = dt * -torch.exp(params["A_log"].float())          # (b, l, h)
    xh = xi.reshape(b, l, h, p)
    y, s_last = _ssd_chunk_scan(xh.float(), B.reshape(b, l, g, n).float(),
                                C.reshape(b, l, g, n).float(), dA, dt, cfg.ssm_chunk,
                                init_state=state.ssm)
    y = y + xh.float() * params["D"].float()[:, None]
    y = y.reshape(b, l, d_inner(cfg)).to(x.dtype)
    # the gated RMSNorm (mamba2): norm(y * silu(z))
    y = common.rms_norm(y * _silu_to(z, x.dtype), params["norm_w"], cfg.norm_eps)
    out = common.matmul(y, params["out_proj"])
    return out, SSMState(ssm=s_last, conv_x=tail_x, conv_B=tail_B, conv_C=tail_C)


def ssm_decode(params: dict, x_t: torch.Tensor, cfg: ArchConfig,
               state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """One-token SSD recurrence. x_t: (b, e) -> (y (b, e), the next state)."""
    b = x_t.shape[0]
    h, p, g, n = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_n_groups, cfg.ssm_d_state
    rep = h // g
    z = common.matmul(x_t, params["w_z"])
    xi = common.matmul(x_t, params["w_x"])
    B = common.matmul(x_t, params["w_B"])
    C = common.matmul(x_t, params["w_C"])
    dt = common.matmul(x_t, params["w_dt"])

    xi, tail_x = _conv_step(xi, params["conv_x_w"], params["conv_x_b"], state.conv_x)
    B, tail_B = _conv_step(B, params["conv_B_w"], params["conv_B_b"], state.conv_B)
    C, tail_C = _conv_step(C, params["conv_C_w"], params["conv_C_b"], state.conv_C)

    xi = xi.reshape(b, h, p)
    dt = _softplus(dt.float() + params["dt_bias"].float())   # (b, h)
    dA = _exp_clip(dt * -torch.exp(params["A_log"].float()))
    # heads in their groups: (b, g, rep, ...), B and C broadcast over rep
    Bg = B.reshape(b, g, 1, 1, n).float()
    Cg = C.reshape(b, g, 1, n, 1).float()
    dx = (dt[..., None] * xi.float()).reshape(b, g, rep, p, 1)
    s = state.ssm * dA[..., None, None] + (dx * Bg).reshape(b, h, p, n)
    y = torch.matmul(s.reshape(b, g, rep, p, n), Cg).reshape(b, h, p)
    y = y + xi.float() * params["D"].float()[:, None]
    y = y.reshape(b, d_inner(cfg)).to(x_t.dtype)
    y = common.rms_norm(y * _silu_to(z, x_t.dtype), params["norm_w"], cfg.norm_eps)
    out = common.matmul(y, params["out_proj"])
    return out, SSMState(ssm=s, conv_x=tail_x, conv_B=tail_B, conv_C=tail_C)
