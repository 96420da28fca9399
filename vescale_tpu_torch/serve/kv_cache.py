"""Paged KV cache — page pools on the card, deterministic host bookkeeping.

The port of ``vescale_tpu/serve/kv_cache.py``.  K and V are two torch
tensors of shape ``(layers, num_pages, page_size, kv_heads, head_dim)`` on
one device.  On a mesh (``mesh=``) the pool is placed as the JAX package
places it, ``plan_axes(mesh, tp=Shard(3))`` by default (kv heads over the
dim named "tp"), and each rank holds its piece: its own kv heads, every
page.  Page 0 is the reserved NULL page: unused table
entries point at it and everything read through it is masked by the
length vector, so its contents never reach a logit.  The engine writes the
pools in place.

The host side — page table, lengths, free lists, per-page refcounts and the
event-sourced crc digest behind :meth:`PagedKVCache.fingerprint` — is the
JAX package's code unchanged: the same sequence of calls gives the same
table and the same fingerprint in both packages.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .. import config as _config

__all__ = ["KVCacheConfig", "KVCacheOutOfPages", "PagedKVCache"]


class KVCacheOutOfPages(RuntimeError):
    """The page pool cannot cover the requested tokens — an admission-time
    capacity verdict (the scheduler sheds or waits), never a mid-decode
    crash: ``reserve`` is called before any cache byte moves."""


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static geometry of the paged cache.  ``max_seq_len`` (=
    ``page_size * pages_per_slot``) bounds prompt + generated tokens per
    request; ``num_pages`` defaults to one full allotment per slot plus the
    reserved null page (an intentionally tight pool — set it higher to
    overcommit slots against typical-shorter-than-max sequences)."""

    layers: int
    kv_heads: int
    head_dim: int
    num_slots: int = 8
    page_size: int = 16
    pages_per_slot: int = 4
    num_pages: Optional[int] = None
    dtype: Any = None  # default torch.float32

    def __post_init__(self):
        if min(self.layers, self.kv_heads, self.head_dim) <= 0:
            raise ValueError("layers/kv_heads/head_dim must be positive")
        if min(self.num_slots, self.page_size, self.pages_per_slot) <= 0:
            raise ValueError("num_slots/page_size/pages_per_slot must be positive")
        if self.num_pages is not None and self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the reserved null page)")

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.pages_per_slot

    @property
    def pool_pages(self) -> int:
        # +1: page 0 is reserved (never allocated, masked everywhere)
        return self.num_pages if self.num_pages is not None else self.num_slots * self.pages_per_slot + 1

    @classmethod
    def from_env(cls, layers: int, kv_heads: int, head_dim: int, dtype=None) -> "KVCacheConfig":
        return cls(
            layers=layers,
            kv_heads=kv_heads,
            head_dim=head_dim,
            num_slots=_config.get_int("VESCALE_SERVE_SLOTS"),
            page_size=_config.get_int("VESCALE_SERVE_PAGE_SIZE"),
            pages_per_slot=_config.get_int("VESCALE_SERVE_PAGES_PER_SLOT"),
            dtype=dtype,
        )


class PagedKVCache:
    """Slot-allocated paged K/V storage + deterministic host bookkeeping.

    Device side: ``k``/``v`` are tensors of shape
    ``(L, num_pages, page_size, KV, hd)`` on ``device`` (default: the
    card).  With ``mesh`` (a live ``DeviceMesh``) they live on the mesh's
    device and hold this rank's piece under ``placements`` (default
    ``plan_axes(mesh, tp=Shard(3))``: KV/tp heads a rank); ``spec`` is the
    pool's ``DArraySpec``.  Host side: ``page_table`` (num_slots,
    pages_per_slot) int32 and ``lengths`` (num_slots,) int32 are the only
    mutable state — both travel into the engine's steps as DATA, never as
    shapes.
    """

    def __init__(self, config: KVCacheConfig, device=None, *, mesh=None, placements=None):
        self.config = config
        self.mesh = mesh
        dtype = config.dtype if config.dtype is not None else torch.float32
        shape = (
            config.layers,
            self.num_pages,
            config.page_size,
            config.kv_heads,
            config.head_dim,
        )
        self.spec = None
        if mesh is not None:
            from ..placements import Shard, plan_axes
            from ..spec import DArraySpec, TensorMeta

            self.device = mesh.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"cache device {resolve_device(device)} is not the mesh's "
                                 f"device {self.device}")
            if placements is None:
                # kv-heads (axis 3) split over the mesh dim NAMED "tp" when it
                # exists; any other axis name stays replicated
                placements = plan_axes(mesh, tp=Shard(3))
            placements = tuple(placements)
            if any(not (p.is_replicate() or p.is_shard(3)) for p in placements):
                raise NotImplementedError(f"pool placements {placements}: only kv heads "
                                          "(Shard(3)) are sharded")
            tp = next((mesh.shape[i] for i, p in enumerate(placements) if p.is_shard(3)), 1)
            if config.kv_heads % max(tp, 1):
                raise ValueError(
                    f"kv_heads={config.kv_heads} not divisible by the head-sharded "
                    f"mesh extent {tp}"
                )
            self.spec = DArraySpec(mesh, placements, TensorMeta(shape, dtype))
            if mesh.size() > 1 and not mesh.is_live:
                raise ValueError("a pool over several ranks needs a live mesh (init_device_mesh)")
            coord = mesh.get_coordinate() if mesh.is_live else (0,) * mesh.ndim
            shape = self.spec.local_shape(coord)
        else:
            self.device = resolve_device(device)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        # ---------------------------------------------- host bookkeeping
        self.page_table = np.zeros((config.num_slots, config.pages_per_slot), np.int32)
        self.lengths = np.zeros((config.num_slots,), np.int32)
        self._pages_held = np.zeros((config.num_slots,), np.int32)
        # per-page reference counts: slots + the prefix tree; a page leaves
        # the free list at refs 0->1 and returns only at refs 1->0
        self._page_refs = np.zeros((self.num_pages,), np.int32)
        # pop() takes the HIGHEST page / lowest slot — deterministic across
        # ranks by construction (the agreement check hashes the result)
        self._free_pages: List[int] = list(range(1, self.num_pages))
        self._free_slots: List[int] = sorted(range(config.num_slots), reverse=True)
        # event-sourced digest: every mutation folds into a running crc, so
        # fingerprint() is O(1) per step
        self._digest = 0
        self._tokens_held = 0

    # ------------------------------------------------------------ geometry
    @property
    def dtype(self) -> torch.dtype:
        return self.k.dtype

    @property
    def num_pages(self) -> int:
        return self.config.pool_pages

    @property
    def num_slots(self) -> int:
        return self.config.num_slots

    @property
    def max_seq_len(self) -> int:
        return self.config.max_seq_len

    def pages_needed(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.config.page_size))

    def free_slot_count(self) -> int:
        return len(self._free_slots)

    def free_page_count(self) -> int:
        return len(self._free_pages)

    def active_slots(self) -> List[int]:
        return sorted(set(range(self.num_slots)) - set(self._free_slots))

    def can_admit(self, prompt_tokens: int, max_new_tokens: int) -> bool:
        """Admission-time capacity check against the WHOLE request (prompt +
        generation budget): admitting on prompt pages alone would turn pool
        exhaustion into a mid-decode fault for a request we promised to
        serve."""
        total = prompt_tokens + max_new_tokens
        if total > self.max_seq_len:
            return False
        return (
            len(self._free_slots) > 0
            and self.pages_needed(total) <= len(self._free_pages)
        )

    def _fold(self, *ints: int) -> None:
        b = b"".join((v & 0xFFFFFFFF).to_bytes(4, "little") for v in ints)
        self._digest = zlib.crc32(b, self._digest)

    # ---------------------------------------------------------- allocation
    def _take_slot(self, slot: Optional[int]) -> int:
        """Pop the deterministic next free slot, or claim an EXPLICIT one."""
        if slot is None:
            return self._free_slots.pop()
        self._free_slots.remove(slot)  # ValueError when not free — loud
        return slot

    def alloc(self, prompt_tokens: int, max_new_tokens: int = 0,
              slot: Optional[int] = None) -> int:
        """Reserve a slot + every page the request can ever touch; returns
        the slot id.  Raises :class:`KVCacheOutOfPages` when the pool
        cannot cover it (callers gate on :meth:`can_admit`)."""
        total = prompt_tokens + max_new_tokens
        if total > self.max_seq_len:
            raise KVCacheOutOfPages(
                f"request of {total} tokens exceeds max_seq_len={self.max_seq_len}"
            )
        need = self.pages_needed(total)
        if not self._free_slots or need > len(self._free_pages):
            raise KVCacheOutOfPages(
                f"need slot+{need} pages, have {len(self._free_slots)} slots / "
                f"{len(self._free_pages)} pages free"
            )
        slot = self._take_slot(slot)
        row = self.page_table[slot]
        row[:] = 0
        for i in range(need):
            row[i] = self._free_pages.pop()
            self._page_refs[row[i]] = 1
        self._pages_held[slot] = need
        self.lengths[slot] = 0
        self._fold(1, slot, need, int(row[0]))
        return slot

    def alloc_shared(self, shared_pages: Sequence[int], prompt_tokens: int,
                     max_new_tokens: int = 0, slot: Optional[int] = None) -> int:
        """Prefix-cache admission: map ``shared_pages`` (already written,
        already referenced) into the new slot's leading table entries and
        allocate FRESH pages only for the rest of the request.  The shared
        pages gain one reference each."""
        total = prompt_tokens + max_new_tokens
        if total > self.max_seq_len:
            raise KVCacheOutOfPages(
                f"request of {total} tokens exceeds max_seq_len={self.max_seq_len}"
            )
        shared = [int(p) for p in shared_pages]
        need = self.pages_needed(total)
        if len(shared) > need:
            raise ValueError(
                f"{len(shared)} shared pages exceed the {need} the request needs"
            )
        fresh = need - len(shared)
        if not self._free_slots or fresh > len(self._free_pages):
            raise KVCacheOutOfPages(
                f"need slot+{fresh} fresh pages, have {len(self._free_slots)} "
                f"slots / {len(self._free_pages)} pages free"
            )
        slot = self._take_slot(slot)
        row = self.page_table[slot]
        row[:] = 0
        for i, p in enumerate(shared):
            if self._page_refs[p] <= 0:
                raise ValueError(f"shared page {p} is unreferenced (freed?)")
            row[i] = p
            self._page_refs[p] += 1
            self._fold(4, slot, p, int(self._page_refs[p]))
        for i in range(len(shared), need):
            row[i] = self._free_pages.pop()
            self._page_refs[row[i]] = 1
        self._pages_held[slot] = need
        self.lengths[slot] = 0
        self._fold(1, slot, need, int(row[0]))
        return slot

    def commit_prefill(self, slot: int, prompt_tokens: int) -> None:
        """The prompt's K/V pages were written by the engine: the slot now
        holds ``prompt_tokens`` positions."""
        if prompt_tokens > int(self._pages_held[slot]) * self.config.page_size:
            raise ValueError(f"slot {slot}: prefill {prompt_tokens} exceeds reserved pages")
        self.lengths[slot] = prompt_tokens
        self._tokens_held += prompt_tokens
        self._fold(2, slot, prompt_tokens)

    def advance(self, slot: int) -> None:
        """One decoded token landed in the cache (position ``lengths``)."""
        if self.lengths[slot] >= int(self._pages_held[slot]) * self.config.page_size:
            raise KVCacheOutOfPages(f"slot {slot} is full ({int(self.lengths[slot])} tokens)")
        self.lengths[slot] += 1
        self._tokens_held += 1

    def can_advance(self, slot: int) -> bool:
        return self.lengths[slot] < int(self._pages_held[slot]) * self.config.page_size

    def rollback(self, slot: int, length: int) -> None:
        """Rewind the slot to ``length`` committed positions.  Pages stay
        reserved; only the length bookkeeping moves."""
        cur = int(self.lengths[slot])
        if not (0 <= length <= cur):
            raise ValueError(f"slot {slot}: rollback to {length} from {cur}")
        self._tokens_held -= cur - length
        self.lengths[slot] = length
        self._fold(7, slot, length)

    def free(self, slot: int) -> None:
        """Release the slot; each of its pages drops one reference and
        returns to the pool only when that was the LAST one."""
        if slot in self._free_slots:
            return
        held = int(self._pages_held[slot])
        # LIFO return keeps the free list a deterministic function of the
        # alloc/free history (not of dict/set iteration order)
        for i in range(held - 1, -1, -1):
            p = int(self.page_table[slot, i])
            self._page_refs[p] -= 1
            if self._page_refs[p] < 0:
                raise AssertionError(f"page {p} refcount went negative")
            if self._page_refs[p] == 0:
                self._free_pages.append(p)
        self._tokens_held -= int(self.lengths[slot])
        self._fold(3, slot, held, int(self.lengths[slot]))
        self.page_table[slot] = 0
        self.lengths[slot] = 0
        self._pages_held[slot] = 0
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)

    # ----------------------------------------------------- page references
    def retain_page(self, page: int) -> None:
        """One more holder for an ALREADY-REFERENCED page."""
        if not (0 < page < self.num_pages):
            raise ValueError(f"page {page} out of range (page 0 is reserved)")
        if self._page_refs[page] <= 0:
            raise ValueError(f"page {page} is unreferenced — nothing to retain")
        self._page_refs[page] += 1
        self._fold(5, page, int(self._page_refs[page]))

    def release_page(self, page: int) -> None:
        """Drop one reference; the page returns to the free pool only when
        this was the last holder."""
        if self._page_refs[page] <= 0:
            raise ValueError(f"page {page} is already unreferenced")
        self._page_refs[page] -= 1
        self._fold(6, page, int(self._page_refs[page]))
        if self._page_refs[page] == 0:
            self._free_pages.append(page)

    def page_ref(self, page: int) -> int:
        return int(self._page_refs[page])

    def reset(self) -> None:
        """Return every slot and page to the pool (device bytes stay —
        stale pages are legal: nothing reads past a slot's length)."""
        for slot in list(self.active_slots()):
            self.free(slot)
        self._page_refs[:] = 0
        self._free_pages = list(range(1, self.num_pages))

    # ------------------------------------------------------- device plumbing
    def update(self, k, v) -> None:
        """Replace the pools with tensors of the same shape, dtype and
        device (the engine writes in place and never needs this)."""
        for name, new, old in (("k", k, self.k), ("v", v, self.v)):
            if new.shape != old.shape or new.dtype != old.dtype or new.device != old.device:
                raise ValueError(
                    f"update: {name} {tuple(new.shape)}/{new.dtype}/{new.device} vs "
                    f"{tuple(old.shape)}/{old.dtype}/{old.device}"
                )
        self.k, self.v = k, v

    def table_array(self) -> np.ndarray:
        return np.ascontiguousarray(self.page_table)

    def lengths_array(self) -> np.ndarray:
        return np.ascontiguousarray(self.lengths)

    # ------------------------------------------------------------ agreement
    def fingerprint(self) -> Tuple[int, ...]:
        """Host-bookkeeping digest: every alloc/commit/free folds into a
        running crc, advances keep a token total, and the live page-reference
        total rides along.  Deliberately EXCLUDES device bytes (the null
        page legally holds scatter garbage)."""
        return (
            self._digest,
            len(self._free_slots),
            len(self._free_pages),
            self._tokens_held,
            int(self._page_refs.sum()),
        )

    def utilization(self) -> float:
        usable = self.num_pages - 1
        return 1.0 - (len(self._free_pages) / usable) if usable else 0.0
