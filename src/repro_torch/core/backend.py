"""Cache backends (port of `repro.core.backend`, mixed layout).

`MixedKVBackend` puts the ZipCache mixed cache behind the interface the
model layers call.  With `use_kernels` it routes the cache's hot steps
through the port's CUDA kernels: CST quantization of V through `cst_quant`,
and decode attention on non-probe steps through `decode_qattn`.  Probe steps
need exact head-pooled slot weights for the saliency state, so they take the
plain exact-softmax `attend_decode`, as the reference's paged kernel backend
does (`core/paged.py`).  `use_kernels=False` is the plain path throughout,
the JAX package's live path written in PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig


@dataclasses.dataclass(frozen=True)
class MixedKVBackend:
    """The ZipCache mixed-precision cache as a backend; stateless."""

    ccfg: CompressionConfig
    use_kernels: bool = True

    def init_cache(self, b, h_kv, d, max_len, dtype=torch.bfloat16, d_v=None, device=None):
        return kvc.init_cache(self.ccfg, b, h_kv, d, max_len, dtype, d_v=d_v, device=device)

    def compress_prefill(self, k, v, token_saliency, max_len, probe_nnz=None,
                         dtype=torch.bfloat16):
        return kvc.compress_prefill(self.ccfg, k, v, token_saliency, max_len,
                                    probe_nnz=probe_nnz, dtype=dtype,
                                    use_kernel=self.use_kernels)

    def append(self, cache, k_t, v_t):
        return kvc.append_token(cache, k_t, v_t)

    def attend(self, q, cache, is_probe: bool) -> kvc.DecodeAttnOut:
        """Decode attention; `is_probe` (a host bool) selects the exact path
        with slot weights.  Non-probe kernel steps return no slot weights."""
        if is_probe or not self.use_kernels:
            return kvc.attend_decode(q, cache)
        from repro_torch.kernels.decode_qattn import ops as dq_ops
        return kvc.DecodeAttnOut(dq_ops.decode_attend_mixed(q, cache), None)

    def update_probe(self, cache, slot_weights, is_probe: bool):
        return kvc.update_probe_state(cache, slot_weights, is_probe)

    def recompress(self, cache):
        return kvc.recompress(self.ccfg, cache, use_kernel=self.use_kernels)


BACKEND_KINDS = ("mixed",)


def of(ccfg: Optional[CompressionConfig], kind: str = "mixed", use_kernels: bool = True):
    """Backend for a policy config (None passes through)."""
    if ccfg is None:
        return None
    if kind == "mixed":
        return MixedKVBackend(ccfg, use_kernels=use_kernels)
    if kind == "paged":
        raise NotImplementedError("the paged cache layout is not ported yet")
    raise ValueError(f"unknown cache backend {kind!r}; one of {BACKEND_KINDS}")
