"""Roofline terms of one step on one NVIDIA H100 (the reference's
``perf/roofline.py`` with the card's published peaks in place of a TPU
v5e's).

Constants: NVIDIA's data sheet for the H100 SXM part, dense rates
without sparsity, at the full 700 W power limit (a card set below it runs
slower under load, so a share against these peaks is stated beside the
card's power limit):

  =============  ===========  =====================================
  PEAK_FLOPS     989e12       bf16 / fp16 on the tensor cores (the
                              reference's one-peak convention)
  PEAK_BY_KIND   tf32 495e12  TF32 on the tensor cores
                 f32 67e12    float32 outside the tensor cores
  HBM_BW         3.35e12      bytes/s of HBM3
  HBM_BYTES      80e9         bytes of HBM
  LINK_BW        450e9        bytes/s one way over NVLink 4 (the
                              reference's ``ICI_BW``)
  =============  ===========  =====================================

A PyTorch program has no HLO, so the reference's three HLO-text parsers
have no counterpart: the collectives of a step are the call log of a
recording grid (:class:`repro_torch.sharding.grid.RecordingGrid`), which
:func:`collectives_from_calls` folds with the reference's accounting:

  all-reduce       2 x the tensor's size  (ring reduce-scatter + gather)
  all-gather       the result's size      (bytes landing per rank)
  reduce-scatter   the operand's size     (bytes leaving per rank)

Every call is recorded, loops included, so the result is loop-aware.

A kernel's work (:class:`Work`) is its operations by the rate class that
runs them and the bytes it must move (each input read once, each output
written once); :func:`work_bound` prices it at the peaks above.
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple

import torch

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_BY_KIND = {"bf16": PEAK_FLOPS, "tf32": 495e12, "f32": 67e12}
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9
LINK_BW = 450e9              # bytes/s, NVLink 4, one way
PEAKS_NAME = "NVIDIA H100 SXM 80GB (published peaks)"

COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")


class Work(NamedTuple):
    """A kernel call's operations by rate class (``"bf16"``, ``"tf32"``,
    ``"f32"``: keys of :data:`PEAK_BY_KIND`) and the bytes it must move."""

    flops: Dict[str, float]
    bytes: float

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def __add__(self, other):
        flops = dict(self.flops)
        for k, v in other.flops.items():
            flops[k] = flops.get(k, 0) + v
        return Work(flops, self.bytes + other.bytes)


def rate_kind(dtype: torch.dtype) -> str:
    """The rate class of a product whose operands are all ``dtype``: bf16
    and fp16 on the tensor cores' bf16 rate, anything else at float32's
    (outside the tensor cores)."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def work_bound(work: Work):
    """(seconds, 'operations' | 'bytes'): the least time the card could
    take for ``work``: its operations at their classes' peaks, or its
    bytes at HBM's rate, the larger."""
    t_ops = sum(n / PEAK_BY_KIND[k] for k, n in work.flops.items())
    t_bytes = work.bytes / HBM_BW
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _call_bytes(call) -> int:
    op, nbytes = call["op"], call["bytes"]
    return 2 * nbytes if op == "all-reduce" else nbytes


def collectives_from_calls(calls: Iterable[dict]) -> Dict[str, dict]:
    """Per-op ``{count, bytes}`` of a recording grid's call log (each call
    a dict with ``op`` and ``bytes``: the tensor's size, or for an
    all-gather the result's), with ``total_bytes`` and ``loop_aware``."""
    out = {k: {"count": 0, "bytes": 0} for k in COLL_OPS}
    for c in calls:
        out[c["op"]]["count"] += 1
        out[c["op"]]["bytes"] += _call_bytes(c)
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    out["loop_aware"] = True
    return out


def collective_breakdown(calls: Iterable[dict], top: int = 15):
    """The per-call ranking ``profile_collectives`` prints: ([(bytes, op,
    group, shape, dtype, site, count)], total bytes), one row per distinct
    (op, group, shape, dtype, site), sorted by its bytes over the step."""
    rows: Dict[tuple, list] = {}
    for c in calls:
        key = (c["op"], c["group"], tuple(c["shape"]), c["dtype"], c["site"])
        row = rows.setdefault(key, [0, 0])
        row[0] += _call_bytes(c)
        row[1] += 1
    items = sorted(((b, *k, n) for k, (b, n) in rows.items()),
                   key=lambda r: -r[0])
    return items[:top], sum(r[0] for r in items)


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   min_bytes: float = 0.0) -> dict:
    """Seconds per step on one card: ``t_compute_s`` (flops at
    :data:`PEAK_FLOPS`), ``t_memory_s`` (every op's bytes read and written,
    unfused), ``t_memory_min_s`` (``min_bytes``: the liveness lower bound,
    arguments + outputs + peak), ``t_collective_s`` (at :data:`LINK_BW`);
    ``bottleneck`` from the lower memory bound, ``bottleneck_hlo_bytes``
    from the unfused one (the reference's key names)."""
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = coll_bytes / LINK_BW
    terms = {"t_compute_s": t_compute, "t_memory_s": t_memory,
             "t_collective_s": t_coll,
             "t_memory_min_s": min_bytes / HBM_BW}
    cand = {"compute": t_compute, "memory": terms["t_memory_min_s"],
            "collective": t_coll}
    terms["bottleneck"] = max(cand, key=cand.get)
    cand_hlo = {"compute": t_compute, "memory": t_memory,
                "collective": t_coll}
    terms["bottleneck_hlo_bytes"] = max(cand_hlo, key=cand_hlo.get)
    return terms


def model_flops(param_count_active: float, tokens: float,
                mode: str) -> float:
    """6 N D for training, 2 N D for an inference forward."""
    mult = 6.0 if mode == "train" else 2.0
    return mult * param_count_active * tokens


def is_axes(a) -> bool:
    """A logical-axes leaf: a tuple of axis names."""
    return isinstance(a, tuple) and all(isinstance(x, str) for x in a)


def _axes_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _axes_leaves(v)]
    return [tree]


def count_params(shapes_tree, axes_tree, top_k: int = 0,
                 num_experts: int = 0) -> dict:
    """Total and active param counts of a shape tree (leaves with
    ``.shape``) against its logical-axes tree: a leaf stacked over
    ``client`` counts one client's copy, an ``experts`` leaf counts
    ``top_k / num_experts`` of itself among the active."""
    shapes = _axes_leaves(shapes_tree)
    axes = _axes_leaves(axes_tree)
    if len(shapes) != len(axes) or not all(map(is_axes, axes)):
        raise ValueError("the axes tree does not match the shape tree")
    total = 0
    active = 0.0
    for s, a in zip(shapes, axes):
        n = 1
        for d in s.shape:
            n *= int(d)
        if a and a[0] == "client":
            n //= int(s.shape[0])
        total += n
        if "experts" in a and num_experts:
            active += n * (top_k / num_experts)
        else:
            active += n
    return {"total": total, "active": active}
