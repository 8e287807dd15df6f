"""Counting what a step does, op by op, without running it on a card.

:class:`StepCount` is a context under which a step runs on ``meta``
tensors (or on CPU tensors: the counts are the same). It counts

* FLOPs with :class:`torch.utils.flop_counter.FlopCounterMode` for every
  op but the kernels; a kernel call counts its :class:`~repro_torch.
  perf.roofline.Work` instead (:func:`kernel_site`), so the count is the
  same whichever implementation of the kernel runs;
* bytes: each op's tensor inputs read and its outputs written once (the
  counterpart of XLA's unfused "bytes accessed"); an op that only
  aliases its input (a view, a detach) and an ``empty`` move nothing;
* live storage bytes: every storage the step's ops make is live until
  its last tensor dies, so the largest sum over the step is its peak.
  The arguments (:meth:`StepCount.track`) are live from the start.

A kernel call site wraps its work in ``with kernel_site(name, work_fn)``:
without a :class:`StepCount` active that does nothing (``work_fn`` is
not called); under one, the ops inside are neither charged FLOPs nor
bytes (their storages still count as live), and ``work_fn()`` is
charged once. Nested sites charge the outermost only.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

#: ops whose outputs hold no written data
NO_DATA = {aten.empty.memory_format, aten.empty_strided.default,
           aten.empty_like.default, aten.new_empty.default,
           aten.new_empty_strided.default}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CountMode(TorchDispatchMode):
    """The bytes and live-storage half of :class:`StepCount`."""

    def __init__(self, owner: "StepCount"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        owner = self.owner
        outs = _tensors(out)
        for t in outs:
            owner._live_add(t)
        if owner._suspended or func in NO_DATA:
            return out
        ins = _tensors(args) + _tensors(kwargs)
        if not func._schema.is_mutable:
            stores = {id(t.untyped_storage()) for t in ins}
            if outs and all(id(t.untyped_storage()) in stores for t in outs):
                return out          # a view or alias: no data moves
        owner.bytes_read += sum(_nbytes(t) for t in ins)
        owner.bytes_written += sum(_nbytes(t) for t in outs)
        return out


class StepCount:
    """FLOPs, bytes and live memory of the ops run under it (module
    docstring). After the context: :attr:`flops` (FlopCounterMode's count
    less what ran inside kernel sites, plus the kernels' work),
    :attr:`bytes` (read + written), :attr:`peak_bytes`, :attr:`kernels`
    ({name: {calls, flops, bytes}})."""

    def __init__(self):
        self.bytes_read = 0
        self.bytes_written = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.kernels: Dict[str, dict] = {}
        self._live: Dict[int, int] = {}
        self._suspended = 0
        self._excluded_flops = 0
        self._kernel_flops = 0.0
        self._kernel_bytes = 0.0
        self._flop = FlopCounterMode(display=False)
        self._mode = _CountMode(self)

    # -- live storage -------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _live_add(self, t: torch.Tensor) -> int:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return 0
        n = s.nbytes()
        self._live[key] = n
        weakref.finalize(s, self._free, key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (the step's
        arguments); returns their bytes, each storage once."""
        return sum(self._live_add(t) for t in _tensors(tree))

    def new_bytes(self, tree, exclude) -> int:
        """The bytes of ``tree``'s storages that are not ``exclude``'s
        (a step's outputs beside its arguments)."""
        old = {id(t.untyped_storage()) for t in _tensors(exclude)}
        seen, n = set(), 0
        for t in _tensors(tree):
            s = t.untyped_storage()
            if id(s) not in old and id(s) not in seen:
                seen.add(id(s))
                n += s.nbytes()
        return n

    # -- counts -------------------------------------------------------------

    @property
    def flops(self) -> float:
        return (self._flop.get_total_flops() - self._excluded_flops
                + self._kernel_flops)

    @property
    def bytes(self) -> float:
        return self.bytes_read + self.bytes_written + self._kernel_bytes

    @contextlib.contextmanager
    def kernel(self, name: str, work_fn: Callable):
        if self._suspended:
            yield
            return
        f0 = self._flop.get_total_flops()
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1
            self._excluded_flops += self._flop.get_total_flops() - f0
        work = work_fn()
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work.total_flops
        k["bytes"] += work.bytes
        self._kernel_flops += work.total_flops
        self._kernel_bytes += work.bytes

    def __enter__(self):
        self._flop.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._flop.__exit__(*exc)
        return False


def active() -> "StepCount | None":
    """The innermost :class:`StepCount` whose mode is on the dispatch
    stack, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _CountMode):
            return mode.owner
    return None


@contextlib.contextmanager
def kernel_site(name: str, work_fn: Callable):
    """Charge a kernel call's ``work_fn()`` to the active
    :class:`StepCount` in place of the ops inside; nothing without one."""
    counter = active()
    if counter is None:
        yield
        return
    with counter.kernel(name, work_fn):
        yield
