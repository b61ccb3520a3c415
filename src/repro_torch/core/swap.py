"""Host-memory KV swap tier (port of `repro.core.swap`): the fourth lever
under page-pool pressure, beside deferring admission, preempting by
recompute and downshifting precision (`core.precision`).

A victim's EXACT quantized cache goes to host memory and comes back later:
two PCIe transfers instead of a prefill and a replay.  ZipCache's packed
codes make the trade lopsided: a slot's pages are a few hundred KB per
layer at 4/2 bits.

`HostSwapPool` owns preallocated host entries that mirror the flat list of
tensors `registry.extract_caches` gives for one slot (the packed hi/lo
pages, the staging window, the metadata rows and, for a hybrid model, each
SSM layer's state rows): one byte buffer per entry,
pinned when the cache lives on a CUDA device, each tensor at a 16-byte
aligned offset.  The engine's swap-out gathers the slot into that list and
`store`s it into a reserved entry (the tensors packed on the device, then
ONE device-to-host copy), then returns the slot's pages to the free lists;
swap-in re-grants pages host-side, `load`s the entry back to the device
(ONE host-to-device copy, the tensors views of it) and scatters it through
the new tables: no prefill, no recompute, bitwise the bytes that left.
Handles are plain ints; entry layouts are fixed at construction, so
swapping never allocates host memory.

The two points where a transfer must be complete are explicit: `store`
waits for its device-to-host copies before it returns (the slot's pages are
freed and re-granted next), and `release` waits for the host-to-device
copies of the entry's last `load` (a later `store` may overwrite the
entry).  No decode step waits on either.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch


class HostSwapPool:
    """Fixed-capacity pool of host mirrors of one slot's cache state.

    template: tensors shaped and typed like one entry (the engine passes one
    extract of its caches; only shapes and dtypes are read).
    swap_pool_mb: the host budget; 0 means one entry per batch slot
    (`fallback_entries`), which can always hold every slot.  Entries are
    page-locked where the template lives on a CUDA device.
    """

    def __init__(self, template: Sequence[torch.Tensor], swap_pool_mb: int = 0,
                 fallback_entries: int = 1):
        self._specs = [(tuple(t.shape), t.dtype) for t in template]
        self._sizes = [t.numel() * t.element_size() for t in template]
        self.entry_bytes = sum(self._sizes)
        # each tensor at a 16-byte aligned offset, so that it views back
        self._pads = [-n % 16 for n in self._sizes]
        self._padding = torch.zeros(16, dtype=torch.uint8)
        if swap_pool_mb > 0:
            cap = (int(swap_pool_mb) << 20) // max(self.entry_bytes, 1)
        else:
            cap = int(fallback_entries)
        self.capacity = max(cap, 0)
        pin = bool(template) and template[0].is_cuda
        # made once: swapping at steady state never allocates host memory
        self._buffers: List[torch.Tensor] = [
            torch.zeros(self.entry_bytes + sum(self._pads), dtype=torch.uint8, pin_memory=pin)
            for _ in range(self.capacity)]
        self._free: List[int] = list(range(self.capacity))
        self._occupied: set = set()
        self._uploads: Dict[int, torch.cuda.Event] = {}
        self.swaps_out = 0
        self.swaps_in = 0
        self.refusals: Dict[str, int] = {"aliased": 0, "pool_full": 0}

    # -- handles ------------------------------------------------------------

    def reserve(self) -> Optional[int]:
        """Claim an entry for an imminent swap-out; None (and a counted
        pool_full refusal) when every entry is resident, so that the engine
        falls back to preempt + recompute."""
        if not self._free:
            self.refusals["pool_full"] += 1
            return None
        h = self._free.pop()
        self._occupied.add(h)
        return h

    def release(self, handle: int) -> None:
        """Return an entry to the free list (after swap-in, or when a swapped
        request is cancelled), once the uploads of its last `load` are done.
        The buffers stay allocated; only the handle recycles."""
        upload = self._uploads.pop(handle, None)
        if upload is not None:
            upload.synchronize()
        self._occupied.discard(handle)
        if handle not in self._free:
            self._free.append(handle)

    def note_refusal(self, reason: str) -> None:
        """Count a swap-out the engine refused before reserving (`aliased`: a
        slot whose tables share prefix pages swaps as a unit or not at all)."""
        self.refusals[reason] = self.refusals.get(reason, 0) + 1

    # -- the two transfers ----------------------------------------------------

    def store(self, handle: int, payload: Sequence[torch.Tensor]) -> None:
        """Mirror one slot's device payload into entry `handle` in one copy;
        returns once the copy is complete."""
        if len(payload) != len(self._specs):
            raise ValueError(f"swap payload has {len(payload)} tensors, pool entries hold "
                             f"{len(self._specs)}")
        parts = []
        dev = payload[0].device
        if self._padding.device != dev:
            self._padding = torch.zeros(16, dtype=torch.uint8, device=dev)
        padding = self._padding
        for t, (shape, dt), pad in zip(payload, self._specs, self._pads):
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"swap payload tensor {tuple(t.shape)} {t.dtype} does not "
                                 f"fit the entry's {shape} {dt}")
            parts += [t.contiguous().reshape(-1).view(torch.uint8), padding[:pad]]
        self._buffers[handle].copy_(torch.cat(parts), non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        self.swaps_out += 1

    def load(self, handle: int, device) -> List[torch.Tensor]:
        """Entry `handle` uploaded to `device` in one copy, as the list the
        restore takes (views of the upload): bitwise the bytes `store`
        captured.  The upload is stream-ordered before whatever reads it;
        `release` waits for it before the entry can be written again."""
        device = torch.device(device)
        up = self._buffers[handle].to(device, non_blocking=True, copy=True)
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            self._uploads[handle] = done
        self.swaps_in += 1
        out, off = [], 0
        for (shape, dt), n, pad in zip(self._specs, self._sizes, self._pads):
            out.append(up[off:off + n].view(dt).reshape(shape))
            off += n + pad
        return out

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Counters for `pool_stats()`.  `host_bytes` is RESIDENT bytes
        (occupied entries x entry size): it returns to zero once every
        swapped request was restored or cancelled."""
        return {
            "capacity": self.capacity,
            "resident": len(self._occupied),
            "entry_bytes": self.entry_bytes,
            "host_bytes": len(self._occupied) * self.entry_bytes,
            "swaps_out": self.swaps_out,
            "swaps_in": self.swaps_in,
            "swap_refusals": int(sum(self.refusals.values())),
            "refusals": dict(self.refusals),
        }
