"""The paper's tables on the port: one function per table.

``benchmarks/run.py``'s six paper tables (T1, T2, T3, T5, T7, T8) with the
same methods, settings, rounds and CSV block ``table,setting,method,acc,
balanced_acc,seconds``. A table function takes ``run(method, **kw)``,
:func:`repro_torch.benchmarks.common.run_experiment` with the device and
width bound, and appends each row it prints to ``rows``; a row whose
final state holds an inf or a NaN is marked diverged on stderr (the CSV
block stays the reference's). The claim of a
table is the paper's ordering (SCALA above the baselines, the trends
over r, K, T and the split point), recorded here, not enforced.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --table t1 --quick
    PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu \
        --table t1 --quick [--width 0.125] [--out t1.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table \
        participation [--quick] [--out part.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table async \
        [--quick] [--out async.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table scale \
        [--quick] [--out scale.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table faults \
        [--quick] [--out faults.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table dispatch \
        [--quick] [--out dispatch.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table \
        round_loop [--quick] [--out round_loop.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table boundary \
        [--quick] [--out boundary.json]     # or --table serve
    PYTHONPATH=src python -m repro_torch.benchmarks.run --table roofline \
        [--dryrun-dir results/dryrun_torch]

``--smoke`` runs the reference's SMOKE rows of the synchronous modes:
SCALA through ``exec=subset``, ``masked`` and ``sparse``, FedAvgM
(fedavg with a momentum server optimizer at 0.9), K = 4, r = 0.5, 2
rounds, and ``fused+bf16`` (masked SCALA, 3 rounds at
``rounds_per_call=2`` in bf16), then the reference's ``boundary_guard``
and ``serve_guard`` rows (each asserts, with one re-measure) and the
roofline reprint; its dispatch, scale, arrival and faults guard rows are
not ported. ``--table participation`` is the participation leg
(:mod:`repro_torch.benchmarks.participation`: rounds/s masked, sparse
and re-stacked subset), ``--table async`` the async leg
(:mod:`repro_torch.benchmarks.async_rounds`: sparse against masked, and
events/s and staleness per delay distribution) and ``--table scale`` the
scale leg (:mod:`repro_torch.benchmarks.scale`: delta against dense
events/s and state bytes over K, the sort, topk and topk:sharded pops,
the last on a grid over the process group) and ``--table
faults`` the faults leg (:mod:`repro_torch.benchmarks.faults`: guarded
over unguarded seconds a round at zero faults, masked and async, and a
chaos run's rejections and final loss), ``--table dispatch`` the
dispatch leg (:mod:`repro_torch.benchmarks.dispatch`: rounds/s over
rounds per call x donation x precision per mode, and the baselines'
transpose once a chunk against once a round) and ``--table round_loop``
the round-loop leg (:mod:`repro_torch.benchmarks.round_loop`: T split
steps and a FedAvg from Python against one round runner call),
``--table boundary`` the boundary leg (:mod:`repro_torch.benchmarks.
boundary`: the fused loss stage against the dual one), ``--table serve``
the serving leg (:mod:`repro_torch.benchmarks.serve`: continuous against
static admission; MICRO with ``--quick``, full-width qwen1.5-0.5b
without) and ``--table roofline`` the dry run's roofline terms
reprinted from its records (``--dryrun-dir``; counts at the card's
published peaks, no time measured), each printing CSV rows as the
reference's runner does and its JSON stamped with the device.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from repro_torch.benchmarks.common import device_info, run_experiment

HEADER = "table,setting,method,acc,balanced_acc,seconds"
DRYRUN_DIR = "results/dryrun_torch"


def _emit(rows, table: str, setting: str, method: str, res: dict) -> None:
    rows.append(dict(table=table, setting=setting, method=method, **res))
    print(f"{table},{setting},{method},{res['acc']:.4f},"
          f"{res['balanced_acc']:.4f},{res['seconds']}", flush=True)
    if res["nonfinite_leaves"]:
        print(f"{table},{setting},{method}: diverged, "
              f"{res['nonfinite_leaves']} leaves hold inf or NaN",
              file=sys.stderr, flush=True)


def bench_table1(quick: bool, run, rows) -> None:
    """Table 1 / Figure 4: SCALA against the FL baselines under quantity
    (alpha) and Dirichlet (beta) label skew."""
    methods = ("scala", "fedavg", "fedprox", "fedlogit", "fedla") if quick \
        else ("scala", "scala_noadj", "fedavg", "fedprox", "feddyn",
              "feddecorr", "fedlogit", "fedla")
    rounds = 6 if quick else 10
    for setting, kw in (("alpha=2", dict(alpha=2)),
                        ("beta=0.05", dict(beta=0.05))):
        for m in methods:
            _emit(rows, "T1", setting, m,
                  run(m, rounds=rounds, **kw))


def bench_table2(quick: bool, run, rows) -> None:
    """Table 2: the participation ratio r (alpha=2)."""
    ratios = (0.1, 0.5) if quick else (0.1, 0.2, 0.5)
    methods = ("scala", "fedavg") if quick else ("scala", "fedavg", "fedla")
    rounds = 6 if quick else 10
    for r in ratios:
        for m in methods:
            _emit(rows, "T2", f"r={r}", m,
                  run(m, alpha=2, r=r, rounds=rounds))


def bench_table3(quick: bool, run, rows) -> None:
    """Table 3: the number of clients K (alpha=2; r=50% for small K, 10%
    for large K, as in the paper)."""
    grid = ((10, 0.5), (20, 0.5)) if quick else ((10, 0.5), (20, 0.5),
                                                 (50, 0.1))
    methods = ("scala", "fedavg") if quick else ("scala", "fedavg", "fedla")
    rounds = 6 if quick else 10
    for K, r in grid:
        for m in methods:
            _emit(rows, "T3", f"K={K},r={r}", m,
                  run(m, alpha=2, K=K, r=r, rounds=rounds))


def bench_table5(quick: bool, run, rows) -> None:
    """Tables 5-6: SCALA against the SFL family."""
    methods = ("scala", "splitfed_v1", "splitfed_v2") if quick else (
        "scala", "splitfed_v1", "splitfed_v2", "splitfed_v3",
        "sfl_localloss")
    rounds = 6 if quick else 10
    for setting, kw in (("alpha=2", dict(alpha=2)),
                        ("beta=0.1", dict(beta=0.1))):
        for m in methods:
            _emit(rows, "T5", setting, m,
                  run(m, rounds=rounds, **kw))


def bench_table7(quick: bool, run, rows) -> None:
    """Table 7: the local iterations T."""
    Ts = (1, 5) if quick else (1, 5, 10)
    methods = ("scala", "fedavg") if quick else ("scala", "fedavg", "fedla")
    rounds = 6 if quick else 10
    for T in Ts:
        for m in methods:
            _emit(rows, "T7", f"T={T}", m,
                  run(m, alpha=2, T=T, rounds=rounds))


def bench_table8(quick: bool, run, rows) -> None:
    """Table 8: the split point (the client/server boundary depth)."""
    splits = ("s1", "s2") if quick else ("s1", "s2", "s3", "s4")
    rounds = 6 if quick else 10
    for sp in splits:
        _emit(rows, "T8", f"split={sp}", "scala",
              run("scala", alpha=2, split=sp, rounds=rounds))


TABLES = {
    "t1": bench_table1,
    "t2": bench_table2,
    "t3": bench_table3,
    "t5": bench_table5,
    "t7": bench_table7,
    "t8": bench_table8,
}


def smoke(run, rows, device="cuda", dryrun_dir=DRYRUN_DIR) -> None:
    """The reference's SMOKE rows of the synchronous execution modes and
    FedAvgM, its boundary and serving guard rows, and the roofline
    reprint."""
    from repro_torch.benchmarks.boundary import \
        smoke_guard as boundary_smoke_guard
    from repro_torch.benchmarks.serve import smoke_guard as serve_smoke_guard

    kw = dict(alpha=2, K=4, r=0.5, T=2, rounds=2, n_train=300)
    for execution in ("subset", "masked", "sparse"):
        _emit(rows, "SMOKE", f"exec={execution}", "scala",
              run("scala", execution=execution, **kw))
    _emit(rows, "SMOKE", "fedavgm", "fedavg",
          run("fedavg", server_optimizer="momentum", server_lr=0.9, **kw))
    _emit(rows, "SMOKE", "fused+bf16", "scala",
          run("scala", execution="masked", rounds_per_call=2,
              precision="bf16", **dict(kw, rounds=3)))
    # the one-pass (fused) boundary loss stage must be at least as fast as
    # the two passes (shared with `boundary --smoke`)
    bguard = boundary_smoke_guard(device)
    print("SMOKE,boundary_guard,fused_speedup,"
          f"{bguard['backends']['lace']['max_speedup']},,", flush=True)
    # continuous batching must sustain at least the static token rate
    # (shared with `serve --smoke`)
    vguard = serve_smoke_guard(device)
    print("SMOKE,serve_guard,continuous_speedup,"
          f"{vguard['slots']['2']['batch']['continuous_speedup']},,",
          flush=True)
    leg_roofline(dryrun_dir)


def leg_async(quick: bool, device, width: float) -> dict:
    """The async leg, its CSV rows as ``benchmarks/run.py:bench_async``
    prints them."""
    from repro_torch.benchmarks.async_rounds import bench_async

    res = bench_async(rounds=3 if quick else 10, width=width, device=device)
    for frac, entry in res["sparse_vs_masked"].items():
        for variant in ("masked", "sparse"):
            print(f"async,{frac},{variant},"
                  f"{entry[variant]['rounds_per_sec']},,"
                  f"{entry[variant]['seconds']}", flush=True)
    for spec, entry in res["async_events"].items():
        print(f"async,delay={spec},events,{entry['events_per_sec']},"
              f"{entry['mean_cohort_staleness']},{entry['seconds']}",
              flush=True)
    return res


def leg_scale(quick: bool, device, width: float) -> dict:
    """The scale leg, its CSV rows as ``benchmarks/run.py:bench_scale``
    prints them (``width`` is the leg's own micro AlexNet's, unchanged)."""
    from repro_torch.benchmarks.scale import bench_arrival, bench_scale

    res = bench_scale(ks=(100, 10_000) if quick else (100, 10_000,
                                                      1_000_000),
                      events=8 if quick else 16, device=device)
    for K, entry in res["K"].items():
        for leg in ("dense", "delta"):
            row = entry.get(leg, {})
            if "rounds_per_sec" in row:
                print(f"scale,K={K},{leg},{row['rounds_per_sec']},"
                      f"{row['state_bytes']['snapshot_bytes']},"
                      f"{row['seconds']}", flush=True)
    for K, flat in res["delta_flatness"].items():
        print(f"scale,K={K},delta_flatness,{flat},,", flush=True)
    res["arrival"] = bench_arrival(
        ks=(10_000,) if quick else (10_000, 1_000_000),
        events=8 if quick else 16, device=device)
    for K, entry in res["arrival"]["K"].items():
        for leg in ("sort", "topk", "topk:sharded"):
            print(f"scale,K={K},arrival={leg},"
                  f"{entry[leg]['rounds_per_sec']},,"
                  f"{entry[leg]['seconds']}", flush=True)
        print(f"scale,K={K},topk_speedup_vs_sort,"
              f"{entry['topk_speedup_vs_sort']},,", flush=True)
    return res


def leg_faults(quick: bool, device, width: float) -> dict:
    """The faults leg, its CSV rows as ``benchmarks/run.py:bench_faults``
    prints them."""
    from repro_torch.benchmarks.faults import bench_faults, print_rows

    res = bench_faults(K=4 if quick else 8, rounds=2 if quick else 4,
                       reps=2 if quick else 3, device=device, width=width)
    print_rows(res)
    return res


def leg_dispatch(quick: bool, device, width: float) -> dict:
    """The dispatch leg, its CSV rows as ``benchmarks/run.py:
    bench_dispatch`` prints them, then the baselines' transpose rows
    (``width`` is the leg's own micro AlexNet's, unchanged)."""
    from repro_torch.benchmarks.dispatch import (bench_baseline_hoist,
                                                 bench_dispatch, print_rows)

    rounds = 48 if quick else 192
    res = bench_dispatch(rounds=rounds, device=device)
    res["baseline_transpose_hoist"] = bench_baseline_hoist(rounds=rounds,
                                                           device=device)
    print_rows(res)
    return res


def leg_round_loop(quick: bool, device, width: float) -> dict:
    """The round-loop leg, its CSV rows as ``benchmarks/run.py:
    bench_round_loop`` prints them (the leg's own AlexNet width)."""
    from repro_torch.benchmarks.round_loop import bench_round_loop, \
        print_rows

    res = bench_round_loop(rounds=5 if quick else 20, device=device)
    print_rows(res)
    return res


def leg_boundary(quick: bool, device, width: float) -> dict:
    """The boundary leg, its CSV rows as ``benchmarks/run.py:
    bench_boundary`` prints them."""
    from repro_torch.benchmarks.boundary import GRID, bench_boundary

    res = bench_boundary(grid=GRID[:2] if quick else GRID,
                         reps=3 if quick else 5, device=device)
    for backend, entry in res["backends"].items():
        for key, row in entry.items():
            cell = key.replace(",", ";")      # grid keys hold commas (CSV)
            if key in ("max_speedup", "min_speedup"):
                print(f"boundary,{backend},{cell},{row},,", flush=True)
            else:
                print(f"boundary,{backend},{cell},{row['fused_speedup']},,"
                      f"{row['fused_ms']}", flush=True)
    return res


def leg_serve(quick: bool, device, width: float) -> dict:
    """The serving leg, its CSV rows as ``benchmarks/run.py:bench_serve``
    prints them: MICRO with ``quick``, else full-width qwen1.5-0.5b."""
    from repro_torch.benchmarks.serve import bench_serve

    res = bench_serve(arch=None if quick else "qwen1.5-0.5b",
                      reduced=False, n_requests=8 if quick else 12,
                      slots_list=(2,) if quick else (2, 4), reps=2,
                      device=device)
    for slots, entry in res["slots"].items():
        for leg in ("batch", "open_loop"):
            for admission in ("static", "continuous"):
                row = entry[leg][admission]
                print(f"serve,slots={slots}:{leg},{admission},"
                      f"{row['tok_per_sec']},,{row['seconds']}", flush=True)
            print(f"serve,slots={slots}:{leg},continuous_speedup,"
                  f"{entry[leg]['continuous_speedup']},,", flush=True)
        row = entry["paged"]
        print(f"serve,slots={slots}:paged,continuous,"
              f"{row['tok_per_sec']},,{row['seconds']}", flush=True)
    return res


def leg_roofline(dirname: str = DRYRUN_DIR) -> dict:
    """The roofline reprint, its CSV rows as ``benchmarks/run.py:
    bench_roofline`` prints them, from the dry run's records in
    ``dirname`` (counts at one H100's published peaks; no time is
    measured)."""
    from repro_torch.perf.report import load

    recs = load(dirname) if os.path.isdir(dirname) else []
    if not recs:
        print("roofline,NO_DRYRUN_RESULTS,,,,", flush=True)
        return {"records": 0}
    print("roofline_table,arch,shape,mesh,status,bottleneck,"
          "t_compute_s,t_memory_s,t_collective_s,useful_flops_ratio",
          flush=True)
    for r in recs:
        if r.get("status") != "ok":
            print(f"roofline,{r['arch']},{r['shape']},{r['mesh']},"
                  f"{r.get('status')},,,,,", flush=True)
            continue
        t = r["roofline"]
        ufr = r.get("useful_flops_ratio")
        print(f"roofline,{r['arch']},{r['shape']},{r['mesh']},ok,"
              f"{t['bottleneck']},{t['t_compute_s']:.3e},"
              f"{t['t_memory_s']:.3e},{t['t_collective_s']:.3e},"
              f"{'' if ufr is None else f'{ufr:.3f}'}", flush=True)
    return {"records": len(recs), "dir": dirname}


LEGS = {"async": leg_async, "scale": leg_scale, "faults": leg_faults,
        "dispatch": leg_dispatch, "round_loop": leg_round_loop,
        "boundary": leg_boundary, "serve": leg_serve}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", default=None,
                    choices=sorted(TABLES) + ["participation", "roofline"]
                    + sorted(LEGS))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="paper-protocol settings (slow)")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE rows: each sync mode, FedAvgM")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless given)")
    ap.add_argument("--width", type=float, default=0.125,
                    help="AlexNet width (1.0: the paper's network)")
    ap.add_argument("--out", default="",
                    help="also write the rows and the device as JSON")
    ap.add_argument("--dryrun-dir", default=DRYRUN_DIR,
                    help="the dry run's records (the roofline leg)")
    args = ap.parse_args(argv)
    quick = args.quick and not args.full
    if args.table == "roofline":
        return leg_roofline(args.dryrun_dir)
    if args.table == "participation":
        from repro_torch.benchmarks.participation import bench_participation

        res = dict(bench_participation(rounds=3 if quick else 10,
                                       width=args.width, device=args.device),
                   device=device_info(args.device))
        print(json.dumps(res), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=2)
        return res
    if args.table in LEGS:
        res = dict(LEGS[args.table](quick, args.device, args.width),
                   device=device_info(args.device))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=2)
        return res
    names = [args.table] if args.table else list(TABLES)
    if not args.table and not args.smoke:
        print(f"skipped: participation, roofline, "
              f"{', '.join(sorted(LEGS))} (run each with --table NAME)",
              file=sys.stderr)
    print(HEADER, flush=True)
    rows = []
    run = functools.partial(run_experiment, device=args.device,
                            width=args.width)
    if args.smoke:
        smoke(run, rows, args.device, args.dryrun_dir)
    else:
        for name in names:
            TABLES[name](quick, run, rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device_info(args.device), "rows": rows}, f,
                      indent=2)
    return rows


if __name__ == "__main__":
    main()
