"""Decode caches of the serving engine: dense, or a paged pool.

A dense decode cache allocates ``slots x max_len`` KV rows per attention
layer. The paged cache keeps every layer's KV rows in a fixed **page
pool** instead, and each serving slot owns the pages recorded in its row
of a host-side **page table**:

* ``pool``  -- per layer and k/v, ``(pages, page_size, kv, hd)``. One page
  id indexes the same row range in every layer's pool.
* ``table`` -- ``(slots, max_pages)`` int32 numpy array kept by the
  engine; entry ``j`` is the page backing cache positions
  ``[j*page_size, (j+1)*page_size)``, ``-1`` marks unallocated.

Each decode step, :meth:`PagedOps.gather` materialises the dense
per-slot view the decode math expects and :meth:`PagedOps.scatter`
writes the one new KV row per slot back into its page, so both modes
compute on identically valued dense views: paged serving is bitwise
equal to dense serving (test-enforced). Unallocated table entries read
page 0 and their writes are dropped -- by explicit masks, never by
out-of-range indices; those rows always get exactly zero attention
weight. Windowed layers keep their ring: a leaf of ring length
``L < max_len`` only touches positions ``pos % L``.

Recurrent-mixer state (mamba's ``conv``, ``h``, mLSTM's ``conv``, ``C``,
``n``, ``m`` and sLSTM's ``c``, ``n``, ``m``, ``h``) is O(1) per slot and
stays dense in both modes: admission copies a slot's rows, and each step
takes the decode's new state wholesale. A model without attention needs
no page; a hybrid one takes pages for its attention layers only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import blocks as B
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class _LeafInfo:
    layer: str      # "blk{l}"
    name: str       # "k" | "v" (attention), or a recurrent state's key
    attn: bool      # paged KV leaf vs dense recurrent-state leaf
    length: int     # ring / cache length L of a KV leaf (0 otherwise)
    shape: tuple    # dense shape, slot axis first
    dtype: torch.dtype


def _leaf_infos(cfg, slots: int, max_len: int, dtype):
    """One entry per leaf of the dense decode cache, from a template made
    on the meta device (no memory)."""
    T.check_supported(cfg)
    infos = []
    for l, spec in enumerate(cfg.block_specs):
        attn = spec.mixer == "attn"
        L = B.cache_length(spec, max_len) if attn else 0
        tpl = B.block_cache_init(spec, cfg, slots, max_len, dtype, "meta")
        for name, t in tpl.items():
            infos.append(_LeafInfo(f"blk{l}", name, attn, L, tuple(t.shape),
                                   t.dtype))
    return infos


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class DenseOps:
    """Ops for the dense cache: the cache *is* the dense view, and slot
    admission overwrites one slot."""

    paged = False

    def __init__(self, cfg, slots: int, max_len: int, dtype, device):
        self.cfg, self.slots, self.max_len = cfg, slots, max_len
        self.dtype, self.device = dtype, device
        self.infos = _leaf_infos(cfg, slots, max_len, dtype)
        self.max_pages = 1  # dummy table width

    def init(self):
        return T.init_decode_cache(self.cfg, self.slots, self.max_len,
                                   self.dtype, self.device)

    def gather(self, cache, table):
        return cache

    def scatter(self, cache, new_dense, table, idxs):
        return new_dense

    def admit(self, cache, req_cache, table_row, slot: int):
        """Overwrite one slot with a B=1 request cache, in place."""
        for i in self.infos:
            cache[i.layer][i.name][slot] = req_cache[i.layer][i.name][0]
        return cache

    def state_bytes(self) -> int:
        return sum(_nbytes(i.shape, i.dtype) for i in self.infos)


class PagedOps:
    """Gather / scatter between the page pool and the dense per-slot
    view. Tables and positions are host numpy arrays."""

    paged = True

    def __init__(self, cfg, slots: int, max_len: int, dtype, device, *,
                 pages: int, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.cfg, self.slots, self.max_len = cfg, slots, max_len
        self.dtype, self.device = dtype, device
        self.pages, self.page_size = pages, page_size
        self.max_pages = math.ceil(max_len / page_size)
        self.infos = _leaf_infos(cfg, slots, max_len, dtype)
        self.kv = [i for i in self.infos if i.attn]
        self.dense = [i for i in self.infos if not i.attn]

    def _npages(self, length: int) -> int:
        return math.ceil(length / self.page_size)

    def _idx(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long, device=self.device)

    def init(self):
        """A pool per KV leaf, the dense state per recurrent leaf."""
        pool = {}
        for i in self.infos:
            shape = ((self.pages, self.page_size) + i.shape[2:] if i.attn
                     else i.shape)
            pool.setdefault(i.layer, {})[i.name] = torch.zeros(
                shape, dtype=i.dtype, device=self.device)
        return pool

    def pages_needed(self, target_len: int) -> int:
        """Table columns a request reaching ``target_len`` total tokens
        touches (budgeted for the longest leaf; 0 without attention)."""
        longest = max((i.length for i in self.kv), default=0)
        return self._npages(min(target_len, longest))

    def gather(self, paged, table: np.ndarray):
        """Materialise the dense (slots, L, kv, hd) view decode expects;
        unallocated entries read page 0. Recurrent leaves pass as they
        are."""
        cols = {}
        dense = {}
        for i in self.dense:
            dense.setdefault(i.layer, {})[i.name] = paged[i.layer][i.name]
        for i in self.kv:
            L = i.length
            if L not in cols:
                cols[L] = self._idx(np.maximum(table[:, :self._npages(L)], 0))
            g = paged[i.layer][i.name][cols[L]]       # (S, npg, ps, kv, hd)
            dense.setdefault(i.layer, {})[i.name] = g.reshape(
                (g.shape[0], -1) + g.shape[3:])[:, :L]
        return dense

    def scatter(self, paged, new_dense, table: np.ndarray, idxs: np.ndarray):
        """Write the one KV row each slot produced this step back into its
        page; rows of slots without a page there are dropped. Recurrent
        leaves are taken wholesale."""
        for i in self.dense:
            paged[i.layer][i.name] = new_dense[i.layer][i.name]
        sel = {}
        for i in self.kv:
            L = i.length
            if L not in sel:
                widx = idxs % L
                pid = table[np.arange(self.slots), widx // self.page_size]
                keep = np.nonzero(pid >= 0)[0]
                sel[L] = (self._idx(keep), self._idx(pid[keep]),
                          self._idx(widx[keep] % self.page_size),
                          self._idx(widx[keep]))
            rows, pid, off, widx = sel[L]
            if rows.numel():
                paged[i.layer][i.name][pid, off] = \
                    new_dense[i.layer][i.name][rows, widx]
        return paged

    def admit(self, paged, req_cache, table_row: np.ndarray, slot: int):
        """Scatter a B=1 prefill cache into the slot's pages, and its
        recurrent state into the slot's rows; columns without a page are
        dropped."""
        for i in self.dense:
            paged[i.layer][i.name][slot] = req_cache[i.layer][i.name][0]
        for i in self.kv:
            L = i.length
            npg = self._npages(L)
            cols = table_row[:npg]
            keep = np.nonzero(cols >= 0)[0]
            r = req_cache[i.layer][i.name][0]                 # (L, kv, hd)
            r = torch.nn.functional.pad(
                r, (0, 0, 0, 0, 0, npg * self.page_size - L))
            r = r.reshape((npg, self.page_size) + tuple(r.shape[1:]))
            paged[i.layer][i.name][self._idx(cols[keep])] = r[self._idx(keep)]
        return paged

    def state_bytes(self) -> int:
        return (sum(_nbytes((self.pages, self.page_size) + i.shape[2:],
                            i.dtype) for i in self.kv)
                + sum(_nbytes(i.shape, i.dtype) for i in self.dense))


def make_ops(cfg, slots: int, max_len: int, dtype, device, *,
             pages: int = 0, page_size: int = 16):
    """pages == 0 selects the dense cache; pages > 0 the paged pool."""
    if pages > 0:
        return PagedOps(cfg, slots, max_len, dtype, device,
                        pages=pages, page_size=page_size)
    return DenseOps(cfg, slots, max_len, dtype, device)
