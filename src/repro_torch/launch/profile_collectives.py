"""Trace one (arch, shape) on a recording grid and print its per-call
collective ranking (the reference's ``launch/profile_collectives.py``,
which reads the compiled HLO): bytes over the step, share, count, op,
group, shape, dtype and calling site, one row per distinct call.

    PYTHONPATH=src python -m repro_torch.launch.profile_collectives \\
        --arch qwen1.5-0.5b --shape train_4k [--multi-pod] [--top 15] \\
        [--save calls.json]
"""
from __future__ import annotations

import argparse
import json
import warnings

from repro_torch.configs import get_config, get_shape
from repro_torch.launch.dryrun import build_step, count_step, skip_reason
from repro_torch.launch.mesh import make_production_grid
from repro_torch.perf.roofline import LINK_BW, collective_breakdown


def profile(arch: str, shape: str = "train_4k", *, multi_pod: bool = False,
            top: int = 15):
    """(rows, total bytes, the grid's call log) of one step's collectives
    on the production grid (:func:`collective_breakdown`'s rows)."""
    grid = make_production_grid(multi_pod=multi_pod)
    reason = skip_reason(get_config(arch), get_shape(shape), grid)
    if reason:
        raise SystemExit(f"{arch} {shape}: {reason}")
    step, args, _, _ = build_step(arch, shape, grid)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        count_step(step, args)
    rows, total = collective_breakdown(grid.calls, top=top)
    return rows, total, grid.calls


def print_rows(arch: str, shape: str, rows, total) -> None:
    print(f"{arch} {shape} total={total:.3e} B/device "
          f"t_coll={total / LINK_BW:.4f}s (NVLink one way, "
          f"{LINK_BW / 1e9:.0f} GB/s)")
    for b, op, group, shp, dtype, site, n in rows:
        share = 100 * b / total if total else 0.0
        print(f"{b:10.3e} ({share:4.1f}%) x{n:<4} {op:11s} {group:6s} "
              f"{str(list(shp)):24s} {dtype:15s} {site}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--save", default="",
                    help="write the grid's whole call log as JSON")
    ap.add_argument("--no-constrain", action="store_true",
                    help="(the reference's; refused here)")
    args = ap.parse_args(argv)
    if args.no_constrain:
        raise SystemExit("--no-constrain has no counterpart in the port: "
                         "there is no ambient mesh")
    rows, total, calls = profile(args.arch, args.shape,
                                 multi_pod=args.multi_pod, top=args.top)
    if args.save:
        with open(args.save, "w") as f:
            json.dump(calls, f, indent=1)
    print_rows(args.arch, args.shape, rows, total)
    return rows, total


if __name__ == "__main__":
    main()
