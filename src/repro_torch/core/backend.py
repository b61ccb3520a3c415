"""Cache backends (port of `repro.core.backend`): the mixed and paged layouts
behind one interface the model layers and the engines call.

`MixedKVBackend` puts the mixed cache of every policy behind that
interface.  With `use_kernels` it routes the cache's hot steps through the
port's CUDA kernels where the stores allow: each ZipCache store's gather
and quantization (K and V) through one `cst_quant` launch, and decode
attention on non-probe steps through `decode_qattn` wherever every
non-empty store is in the walk's schemes (channelwise K, CST V, or raw:
zipcache, fp16, h2o), checked per store as the paged layout's gate does.
Probe steps need exact head-pooled slot weights for the saliency state, so
they take the plain exact-softmax `attend_decode`, as do the stores the
walk does not read (kivi, gear, mikv: the gather route).  `impl` picks
that plain route's algebra ("ref" or "int8_algebra").  `use_kernels=False`
is the plain path throughout, the JAX package's live path written in
PyTorch.  The paged layout is `core.paged.PagedKVBackend`.

`is_probe`, wherever it appears, is a host bool for the whole batch or a
(b,) device tensor of per-row flags that the caller passes only when some
row probes; `active` is an optional (b,) bool device tensor of live slots;
`eff` is an optional `core.precision.LayerEff` (a layer's effective bits).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import kvcache as kvc
from repro_torch.core.policy import CompressionConfig
from repro_torch.kernels import build

# mixed-layout decode attentions computed by the plain exact route
# (`kvcache.attend_decode`) instead of `decode_qattn`: probe steps, the
# policies whose stores the walk does not read, and use_kernels=False
PLAIN_DECODES = build.Counter()


@dataclasses.dataclass(frozen=True)
class MixedKVBackend:
    """The ZipCache mixed-precision cache as a backend; stateless."""

    ccfg: CompressionConfig
    use_kernels: bool = True

    def init_cache(self, b, h_kv, d, max_len, dtype=torch.bfloat16, d_v=None, device=None):
        return kvc.init_cache(self.ccfg, b, h_kv, d, max_len, dtype, d_v=d_v, device=device)

    def compress_prefill(self, k, v, token_saliency, max_len, probe_nnz=None,
                         dtype=torch.bfloat16, eff=None):
        return kvc.compress_prefill(self.ccfg, k, v, token_saliency, max_len,
                                    probe_nnz=probe_nnz, dtype=dtype,
                                    use_kernel=self.use_kernels, eff=eff)

    def append(self, cache, k_t, v_t, active=None):
        return kvc.append_token(cache, k_t, v_t, active=active)

    def attend(self, q, cache, is_probe=False, impl: str = "ref") -> kvc.DecodeAttnOut:
        """Decode attention: the exact path (`impl`'s algebra) with slot
        weights when some row probes or a store is not the walk's;
        otherwise the kernel, which returns no slot weights."""
        from repro_torch.kernels.decode_qattn import ops as dq_ops
        if kvc.any_probe(is_probe) or not self.use_kernels or not dq_ops.kernel_supported(cache):
            PLAIN_DECODES.launches += 1
            return kvc.attend_decode(q, cache, impl=impl)
        return kvc.DecodeAttnOut(dq_ops.decode_attend_mixed(q, cache), None)

    def update_probe(self, cache, slot_weights, is_probe):
        return kvc.update_probe_state(cache, slot_weights, is_probe)

    def recompress(self, cache, rows=None, eff=None):
        return kvc.recompress(self.ccfg, cache, rows=rows, use_kernel=self.use_kernels, eff=eff)

    def insert(self, cache, slice_cache, slot: int):
        return kvc.insert_slot(cache, slice_cache, slot)

    def free(self, cache, slot: int):
        return kvc.free_slot(cache, slot)

    def dense(self, cache) -> kvc.MixedKVCache:
        """The cache as the mixed layout, for consumers that read its stores
        directly (MLA's absorbed decode): the identity here."""
        return cache

    def place(self, el):
        """The block of an element computed whole that this backend holds:
        the element itself off a mesh (`core.sharded.ShardedBackend` cuts
        a rank's block)."""
        return el

    def whole(self, el):
        """An element as computed whole (an SSM state's decode): the
        element itself off a mesh."""
        return el

    def nbytes(self, cache) -> Tuple[int, int]:
        packed = cache.nbytes_packed()
        return packed, cache.nbytes_total() - packed


BACKEND_KINDS = ("mixed", "paged")
PAGE_ALLOCATORS = ("static", "freelist")


def of(ccfg: Optional[CompressionConfig], kind: str = "mixed", use_kernels: bool = True,
       page_size: Optional[int] = None, paged_kernel: bool = False,
       page_allocator: str = "static", pool_fraction: float = 1.0):
    """Backend for a policy config (None passes through).

    kind: "mixed" (dense per-slot layout) or "paged" (page pools behind
    per-slot page tables).  paged_kernel: the paged layout's decode
    attention walks the pages (`kernels.paged_qattn`) instead of gathering
    a dense view each step.  page_allocator: "static" pre-assigns every
    slot its worst-case pages; "freelist" provisions shared pools of
    `pool_fraction` x that, granted and returned by the continuous
    engine's allocator.  use_kernels: the CUDA kernels, or their plain
    versions throughout.
    """
    if ccfg is None:
        return None
    if page_allocator not in PAGE_ALLOCATORS:
        raise ValueError(f"unknown page allocator {page_allocator!r}; one of {PAGE_ALLOCATORS}")
    if kind == "mixed":
        if paged_kernel:
            raise ValueError("paged_kernel=True requires the paged cache backend (kind='paged')")
        if page_allocator != "static":
            raise ValueError("page_allocator='freelist' requires the paged cache backend "
                             "(kind='paged')")
        return MixedKVBackend(ccfg, use_kernels=use_kernels)
    if kind == "paged":
        from repro_torch.core import paged
        if pool_fraction <= 0.0:
            raise ValueError(f"pool_fraction must be > 0, got {pool_fraction}")
        return paged.PagedKVBackend(ccfg, page_size=page_size or paged.DEFAULT_PAGE_SIZE,
                                    paged_kernel=paged_kernel, allocator=page_allocator,
                                    pool_fraction=pool_fraction, use_kernels=use_kernels)
    raise ValueError(f"unknown cache backend {kind!r}; one of {BACKEND_KINDS}")


def is_kv_cache(x) -> bool:
    from repro_torch.core import paged
    return isinstance(x, (kvc.MixedKVCache, paged.PagedKVCache))


def _elements(caches) -> list:
    """Every cache element of an engine's cache tree, in layer order: KV
    caches and the other per-layer elements (SSM states)."""
    if is_kv_cache(caches) or dataclasses.is_dataclass(caches):
        return [caches]
    if isinstance(caches, dict):
        return [el for v in caches.values() for el in _elements(v)]
    if isinstance(caches, (list, tuple)):
        return [el for v in caches for el in _elements(v)]
    return []


def kv_elements(caches) -> list:
    """Every KV cache element of an engine's cache tree, in layer order (SSM
    states are not)."""
    return [el for el in _elements(caches) if is_kv_cache(el)]


def cache_bytes(caches) -> dict:
    """Packed KV payload vs bookkeeping overhead over a cache tree.  packed =
    live payload (codes or pages + quantization params + staging window);
    overhead = positions, saliency state, counters, page tables, every SSM
    state (not compressed payload) and, for the free-list layout,
    unallocated pool pages (also broken out as `free_pool_bytes`).
    packed + overhead == total."""
    packed = overhead = free_pool = 0
    for el in _elements(caches):
        if not is_kv_cache(el):
            overhead += kvc._nbytes(el)
            continue
        p = el.nbytes_packed()
        packed += p
        overhead += el.nbytes_total() - p
        fp = getattr(el, "nbytes_free_pool", None)
        if fp is not None:
            free_pool += fp()
    return {"packed_bytes": packed, "overhead_bytes": overhead, "free_pool_bytes": free_pool,
            "total_bytes": packed + overhead}
