"""The mixed cache split over a serving mesh (port of what GSPMD does to the
reference's caches under `launch.sharding.cache_pspecs`).

`ShardedBackend` wraps a `MixedKVBackend`.  Every cache element it hands
out is this rank's block: its rows of the batch (the data axes) and its
`model` block of each leaf by the reference's size-matching rule, read
with the batch dim at the global batch (`launch.sharding.cache_pspecs`):

  * a **head split** where the element's kv heads divide `model`: each
    rank holds its kv heads' codes, scales and window; the (b, S) slot
    metadata (positions, probe mass) splits over slots where the rule says
    so (S of 128 or more);
  * a **slot split** where they do not: each store of 128 slots or more,
    and a window of 128 (caches of 2048 tokens or more), splits over
    slots; the channelwise K and CST channel scales stay whole;
  * otherwise the element is whole on every model rank.

What each operation does with a split:

  * compress and folds run on a work view with every slot-split leaf
    gathered over `model` (channelwise K and CST's normaliser are
    statistics over all of a store's slots), on the rank's heads (a fold
    under a precision map, whose table covers every kv head, on the whole
    element), and keep the rank's block: the codes and indices equal the
    one-process cache's by construction.  An append gathers only the
    window and counters, a probe update those and the stores' positions
    and probe mass;
  * decode attention under a head split runs on the rank's heads (the
    walk launched with the whole layer's split plan, so each head's
    output is the whole launch's); the decode step hands in this rank's
    heads of q, k and v (its projections split over `model`) and keeps
    the rank's outputs, a caller with every head (the encoder-decoder's
    cross-attention) has its q cut and the outputs gathered; on probe
    steps each head's exact slot weights are gathered and averaged in the
    one-process order;
  * decode attention under a slot split: each rank's partial softmax
    (acc, m, l) over its block, gathered and merged over `model` in rank
    order (a float sum in another order than the one process's); a probe
    step gathers the logits, so the slot weights are the one-process
    softmax's, and sums the ranks' weighted values;
  * MLA and SSM layers read their element whole (`whole`) and keep their
    block of what they write (`place`).

A segment (hi, lo, window) that stays whole under a slot split is counted
by `model` rank 0 alone.  Specs are pure functions of the element's whole
shapes; the backend recognises a block it placed by its leaf shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import kvcache as kvc
from repro_torch.launch import sharding as shd
from repro_torch.models import parallel

def _signature(el) -> tuple:
    return (type(el).__name__,) + tuple(tuple(t.shape) for t in kvc.tree_leaves(el))


# a MixedKVCache's window and counters: all an append reads or writes
WINDOW_FIELDS = ("k_win", "v_win", "win_pos", "win_acc", "win_nnz", "length", "win_fill")


def _model_dim(spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def _is_head(t: torch.Tensor, dim: Optional[int], el) -> bool:
    """Whether a leaf's `model` dim is its head dim: dim 1 of a KV payload
    (b, hk, S, c).  An SSM state's split (its heads or channels) is never
    a head block of this kind: the state is read whole."""
    return dim == 1 and t.dim() == 4 and isinstance(el, kvc.MixedKVCache)


class ShardedBackend:
    """A `MixedKVBackend` over this rank's block of every cache element (see
    the module docstring).  global_batch: the decode batch (the data axes
    split it); every element handed in or out holds this rank's rows."""

    def __init__(self, base, cfg, mesh, global_batch: int):
        from repro_torch.launch.mesh import data_axes_of
        self.base = base
        self.ccfg = base.ccfg
        self.use_kernels = base.use_kernels
        self.cfg = cfg
        self.mesh = mesh
        self.global_batch = global_batch
        self.data_axes = data_axes_of(mesh)
        self.dp = shd.axis_size(mesh, self.data_axes)
        self.mp = mesh.shape.get("model", 1)
        self.rank = parallel.coord("model", mesh)
        if global_batch % self.dp:
            raise ValueError(f"a serving batch of {global_batch} does not divide the "
                             f"{self.dp} data-parallel ranks of {mesh}")
        self._specs = {}    # (element kind, block leaf shapes) -> the spec tree it was cut by

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def rows(self) -> tuple:
        """[start, stop) of this rank's rows of the global batch."""
        idx, n = shd.block_index(self.data_axes, self.mesh)
        per = self.global_batch // n
        return idx * per, (idx + 1) * per

    def specs_of(self, el):
        """The spec tree this backend cut block `el` by."""
        return self._specs[_signature(el)]

    def place(self, el):
        """This rank's block of an element computed whole over `model` (and
        over the rows too where it holds the global batch)."""
        specs = shd.cache_pspecs(el, self.cfg, self.mesh, self.global_batch, local_rows=True)
        axes = None if _rows_of(el) == self.global_batch and self.dp > 1 else ("model",)
        out = shd.shard_cache_element(el, specs, self.mesh, axes=axes)
        known = self._specs.setdefault(_signature(out), specs)
        if ([s for _, s in shd.cache_leaf_specs(el, known)]
                != [s for _, s in shd.cache_leaf_specs(el, specs)]):
            raise ValueError(f"two placements share the block shapes {_signature(out)}")
        return out

    def whole(self, el, heads: bool = True):
        """The element with every `model`-split leaf gathered; heads=False
        keeps a KV payload's head block (the work view of a head split)."""
        specs = self.specs_of(el)

        def one(t, spec):
            dim = _model_dim(spec)
            if dim is None or (not heads and _is_head(t, dim, el)):
                return t
            return parallel.all_gather_dim(t, dim, self.mesh, "model")

        return shd.fix_logical_shapes(kvc.tree_map(one, el, specs))

    def _cut(self, new, like):
        """`new` (a work view of `like`'s block, or a whole element) cut back
        to `like`'s leaf shapes."""
        specs = self.specs_of(like)

        def one(t, ref, spec):
            if t.shape == ref.shape:
                return t
            dim = _model_dim(spec)
            return parallel.block(t, dim, self.mesh, "model").clone()

        return shd.fix_logical_shapes(kvc.tree_map(one, new, like, specs))

    def _work(self, cache, what: str = "all"):
        """The work view of a KV block: its slot-split leaves gathered over
        `model`, its head block kept.  what: "all"; "window" (the window
        and counters, what an append touches); "meta" (those and the
        stores' positions and probe mass, what a probe update touches)."""
        if what == "all":
            return self.whole(cache, heads=False)
        specs = self.specs_of(cache)

        def gathered(node, spec_node, fields):
            out = {}
            for f in fields:
                t, dim = getattr(node, f), _model_dim(getattr(spec_node, f))
                out[f] = (t if dim is None or _is_head(t, dim, cache)
                          else parallel.all_gather_dim(t, dim, self.mesh, "model"))
            return dataclasses.replace(node, **out)

        work = gathered(cache, specs, WINDOW_FIELDS)
        if what == "window":
            return work
        return dataclasses.replace(work, **{
            n: gathered(getattr(cache, n), getattr(specs, n), ("pos", "acc", "nnz"))
            for n in ("hi", "lo")})

    # ------------------------------------------------------------------
    # the backend interface
    # ------------------------------------------------------------------

    def init_cache(self, b, h_kv, d, max_len, dtype=torch.bfloat16, d_v=None, device=None):
        lo, hi = self.rows() if b == self.global_batch else (0, b)
        return self.place(self.base.init_cache(hi - lo, h_kv, d, max_len, dtype, d_v=d_v,
                                               device=device))

    def compress_prefill(self, k, v, token_saliency, max_len, probe_nnz=None,
                         dtype=torch.bfloat16, eff=None):
        return self.place(self.base.compress_prefill(k, v, token_saliency, max_len,
                                                     probe_nnz=probe_nnz, dtype=dtype, eff=eff))

    def _head_block(self, x: torch.Tensor, cache, n_whole: int) -> torch.Tensor:
        """x's heads (dim 1) of this rank's kv heads: x holds every head
        (n_whole of them) or, from a decode step whose projections split
        over `model`, this rank's heads already."""
        if self._head_split(cache) and x.shape[1] == n_whole:
            return parallel.block(x, 1, self.mesh, "model")
        return x

    def _head_split(self, cache) -> bool:
        return _model_dim(self.specs_of(cache).k_win) == 1

    def _whole_heads(self, cache) -> int:
        return cache.k_win.shape[1] * (self.mp if self._head_split(cache) else 1)

    def append(self, cache, k_t, v_t, active=None):
        work = self._work(cache, "window")
        n = self._whole_heads(cache)
        new = self.base.append(work, self._head_block(k_t, cache, n),
                               self._head_block(v_t, cache, n), active=active)
        return self._cut(new, cache)

    def update_probe(self, cache, slot_weights, is_probe):
        if slot_weights is None and not kvc.any_probe(is_probe):
            return cache
        return self._cut(self.base.update_probe(self._work(cache, "meta"), slot_weights, is_probe),
                         cache)

    def recompress(self, cache, rows=None, eff=None):
        """The fold on the work view; under a precision map (`eff`, a table
        over every kv head) on the whole element."""
        work = self._work(cache) if eff is None else self.whole(cache)
        return self._cut(self.base.recompress(work, rows=rows, eff=eff), cache)

    def insert(self, cache, slice_cache, slot: int):
        return self.base.insert(cache, slice_cache, slot)

    def free(self, cache, slot: int):
        return self.base.free(cache, slot)

    def dense(self, cache):
        """The element whole (MLA's absorbed decode reads every slot)."""
        return self.whole(cache)

    def nbytes(self, cache):
        return self.base.nbytes(cache)

    # ------------------------------------------------------------------
    # decode attention
    # ------------------------------------------------------------------

    def attend(self, q, cache, is_probe=False, impl: str = "ref") -> kvc.DecodeAttnOut:
        from repro_torch.core import backend as backend_lib
        from repro_torch.kernels.decode_qattn import ops as dq_ops
        if impl != "ref":
            raise ValueError("decode_impl='int8_algebra' is not served on a mesh")
        if self._head_split(cache):
            return self._attend_heads(q, cache, is_probe)
        if q.shape[1] != self.cfg.n_heads:
            raise ValueError(f"{q.shape[1]} of {self.cfg.n_heads} query heads over a cache "
                             "that does not split by heads")
        payload = self.specs_of(cache)
        split = [_model_dim(s.k.codes) == 2 for s in (payload.hi, payload.lo)] \
            + [_model_dim(payload.k_win) == 2]
        if self.mp == 1 or not any(split):
            return self.base.attend(q, self.whole(cache), is_probe, impl)
        probe = kvc.any_probe(is_probe)
        if probe or not self.use_kernels or not dq_ops.kernel_supported(cache):
            backend_lib.PLAIN_DECODES.launches += 1
        return self._attend_slots(q, cache, split, probe)

    def _attend_heads(self, q, cache, is_probe) -> kvc.DecodeAttnOut:
        """The rank's heads over its kv heads, on a probe step each head's
        exact slot weights gathered over `model`.  q holds every head (the
        outputs are gathered) or this rank's (a decode step whose
        projections split: the outputs stay the rank's)."""
        from repro_torch.core import backend as backend_lib
        from repro_torch.kernels.decode_qattn import ops as dq_ops
        work = self._work(cache)
        whole = q.shape[1] == self.cfg.n_heads
        q_loc = self._head_block(q, cache, self.cfg.n_heads)

        def heads(out):
            return parallel.all_gather_dim(out, 1, self.mesh, "model") if whole else out

        if kvc.any_probe(is_probe) or not self.use_kernels or not dq_ops.kernel_supported(work):
            backend_lib.PLAIN_DECODES.launches += 1
            out, w = kvc.attend_exact(q_loc, work)
            w = parallel.all_gather_dim(w, 1, self.mesh, "model")
            return kvc.DecodeAttnOut(heads(out), w.mean(dim=(1, 2)))
        plan = q.shape[0] * self._whole_heads(cache) * self.dp
        return kvc.DecodeAttnOut(heads(dq_ops.decode_attend_mixed(q_loc, work, plan=plan)), None)

    def _segments(self, cache, split):
        """[(k, v, valid, split)] of the block's non-empty hi, lo and window
        (dequantized as the stores do)."""
        segs = []
        for store, sp in zip((cache.hi, cache.lo), split):
            if store.capacity:
                segs.append((*store.dequantize(), store.valid, sp))
        if cache.window:
            segs.append((cache.k_win, cache.v_win, cache.win_pos >= 0, split[2]))
        return segs

    def _attend_slots(self, q, cache, split, probe: bool) -> kvc.DecodeAttnOut:
        """Split-KV: each rank's partial softmax over its slot block, merged
        over `model` in rank order; a probe step gathers the logits."""
        from repro_torch.kernels.decode_qattn import ops as dq_ops
        from repro_torch.kernels.decode_qattn import ref as dq_ref
        b, h, d = q.shape
        hk = cache.k_win.shape[1]
        scale = 1.0 / (d ** 0.5)
        qg = q.reshape(b, hk, h // hk, d).float() * scale
        taken = [sp or self.rank == 0 for sp in split]   # a whole segment: rank 0's
        if not probe:
            if self.use_kernels and dq_ops.kernel_supported(cache):
                stats = dq_ops.decode_attend_mixed(q, cache, stats=True, taken=taken)
            else:
                parts = [dq_ref.segment_attend_ref(q, k.float(), v.float(), valid, scale)
                         for k, v, valid, sp in self._segments(cache, split)
                         if sp or self.rank == 0]
                stats = (dq_ref.merged_stats_ref(parts) if parts
                         else dq_ref.empty_stats(q, cache.v_win.shape[-1]))
            ranks = [parallel.all_gather_dim(t[None], 0, self.mesh, "model") for t in stats]
            out = dq_ref.merge_segments_ref(list(zip(*ranks)))
            return kvc.DecodeAttnOut(out.to(q.dtype), None)
        logits, values, valids = [], [], []
        for k, v, valid, sp in self._segments(cache, split):
            s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
            if sp:
                s = parallel.all_gather_dim(s, 3, self.mesh, "model")
                valid = parallel.all_gather_dim(valid, 1, self.mesh, "model")
            logits.append(s)
            values.append((v, sp))
            valids.append(valid)
        valid = torch.cat(valids, dim=-1)
        w = torch.softmax(torch.cat(logits, dim=-1).masked_fill(~valid[:, None, None, :],
                                                                kvc.NEG_INF), dim=-1)
        out = torch.zeros((b, hk, h // hk, cache.v_win.shape[-1]), dtype=torch.float32,
                          device=q.device)
        off = 0
        for (v, sp), s in zip(values, logits):
            n = s.shape[-1]
            ws = w[..., off:off + n]
            if sp:
                ws = parallel.block(ws, 3, self.mesh, "model")
            if sp or self.rank == 0:
                out = out + torch.einsum("bhgs,bhsd->bhgd", ws, v.float())
            off += n
        out = parallel.all_reduce(out, self.mesh, "model")
        return kvc.DecodeAttnOut(out.reshape(b, h, -1).to(q.dtype), w.mean(dim=(1, 2)))


def _rows_of(el) -> int:
    return next(iter(kvc.tree_leaves(el))).shape[0]
