"""Render the dry run's tables from its records (the reference's
``perf/report.py``, over the port's records and grid names).

  PYTHONPATH=src python -m repro_torch.perf.report \\
      [--dir results/dryrun_torch] [--grid 1] [--section all]

Every time in these tables is a bound at the published peaks of one
H100 (:mod:`repro_torch.perf.roofline`), from counts: none is measured.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import GRID_NAMES
from repro_torch.perf.roofline import PEAK_FLOPS

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dirname):
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt(x, digits=3):
    if x is None:
        return "-"
    return f"{x:.{digits}e}"


def _rows(recs, grid):
    rows = [r for r in recs if r["mesh"] == grid]
    order = {s: i for i, s in enumerate(SHAPE_ORDER)}
    rows.sort(key=lambda r: (r["arch"], order.get(r["shape"], 99)))
    return rows


def dryrun_table(recs, grid="1"):
    """Status, trace seconds, memory and FLOPs per device, collectives."""
    out = ["| arch | shape | status | trace s | peak GB/dev | args GB/dev "
           "| fits 80 GB | GFLOPs/dev | collectives |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in _rows(recs, grid):
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} |  "
                       f"|  |  |  |  | {reason} |")
            continue
        mem = r["memory"]
        cdesc = ", ".join(
            f"{k}:{int(v['count'])}" for k, v in r["collectives"].items()
            if isinstance(v, dict) and v.get("count"))
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['trace_s']} | "
            f"{mem['peak_bytes'] / 1e9:.2f} | "
            f"{mem['argument_bytes'] / 1e9:.2f} | "
            f"{'yes' if r['fits_hbm'] else 'no'} | "
            f"{r['flops_per_device'] / 1e9:.1f} | {cdesc or '-'} |")
    return "\n".join(out)


def roofline_table(recs, grid="1"):
    """The roofline terms per device (seconds per step at the published
    peaks), the bottleneck and the one-line fix."""
    out = ["| arch | shape | t_compute (counted) | t_compute (model) | "
           "t_mem (unfused) | t_mem (min) | t_coll | bottleneck | "
           "MODEL/counted flops | fits 80 GB | one-line fix |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in _rows(recs, grid):
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} "
                       f"| | | | | | | | {r.get('reason', '')[:50]} |")
            continue
        t = r["roofline"]
        tca = r["model_flops_per_device"] / PEAK_FLOPS
        cand = {"compute": max(t["t_compute_s"], tca),
                "memory": t["t_memory_min_s"],
                "collective": t["t_collective_s"]}
        bott = max(cand, key=cand.get)
        ufr = r.get("useful_flops_ratio")
        fix = {
            "collective": "shrink the dominant collective "
                          "(profile_collectives)",
            "memory": "fuse / reuse HBM traffic; bigger tiles",
            "compute": "at the bound: raise tensor-core use (fusion, "
                       "bf16 products)",
        }[bott]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt(t['t_compute_s'])} | "
            f"{fmt(tca)} | {fmt(t['t_memory_s'])} | "
            f"{fmt(t['t_memory_min_s'])} | {fmt(t['t_collective_s'])} | "
            f"{bott} | {'' if ufr is None else f'{ufr:.2f}'} | "
            f"{'yes' if r['fits_hbm'] else 'no'} | {fix} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--grid", default=None, choices=GRID_NAMES,
                    help="one grid (default: every grid with records)")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline"])
    args = ap.parse_args(argv)
    recs = load(args.dir)
    grids = [args.grid] if args.grid else [
        g for g in GRID_NAMES if any(r["mesh"] == g for r in recs)]
    for g in grids:
        if args.section in ("all", "dryrun"):
            print(f"### Dry run -- grid {g} (per device)\n")
            print(dryrun_table(recs, g))
            print()
        if args.section in ("all", "roofline"):
            print(f"### Roofline terms -- grid {g} (per device, seconds a "
                  f"step at one H100's published peaks; counts, no time "
                  f"measured)\n")
            print(roofline_table(recs, g))
            print()


if __name__ == "__main__":
    main()
