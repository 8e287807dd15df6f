"""Dry run: trace every (arch x input shape) on the ``meta`` device and
count what one step does on one card (the reference's
``launch/dryrun.py``, which lowers and compiles on a 512-device CPU mesh).

No step computes anything and no card is read: params, batch and caches
are ``meta`` tensors (:mod:`repro_torch.launch.input_specs`), the kernel
call sites run their shape functions and charge their work, and a
:class:`repro_torch.perf.count.StepCount` counts FLOPs, bytes and live
memory op by op. The record has the reference's keys (``lower_s`` and
``compile_s`` become ``trace_s``) and two more: ``layout`` and ``peaks``
(the card the roofline constants are for).

Grids (:mod:`repro_torch.launch.mesh`):

* ``"1"``: one H100 running the arch at the production client count (16)
  with the whole global batch, as one replica;
* ``"16x16"`` and ``"2x16x16"``: recording grids, one rank's share. Only
  the ``dp`` archs (qwen1.5-0.5b, xlstm-1.3b, whisper-tiny) have a layout
  in the port there: training is the ``lace_dp`` step over the grid
  (:func:`~repro_torch.core.scala.scala_local_step_fused_dp`), serving a
  replica on each rank over its rows of the batch. A ``tp`` / ``fsdp``
  arch on a grid records ``skip``.

The MoE FFN's slab reads its row count back to the host above
``STATIC_ROWS`` (``models/layers/moe.py``); on ``meta`` it takes the
static capacity bound, as the reference's compiled program does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--grid 16x16 | --multi-pod | --both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import warnings

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, ScalaConfig,
                                 get_config, get_shape)
from repro_torch.core.scala import (scala_local_step_fused,
                                    scala_local_step_fused_dp,
                                    transformer_split_model)
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import GRID_NAMES, grid_for, num_clients_for
from repro_torch.models import transformer as T
from repro_torch.perf import roofline
from repro_torch.perf.count import StepCount
from repro_torch.sharding.grid import spec_for, tree_specs
from repro_torch.tree import tree_map

NO_LAYOUT = ("no tp/fsdp layout in the port: on a grid of more than one "
             "rank only the dp archs run (ROADMAP queue 1)")


def skip_reason(cfg, shape, grid=None) -> str:
    """Why (arch, shape) does not run on ``grid``, or ''."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return ("SKIP(full-attn): pure full-attention stack; 512k decode "
                "requires sub-quadratic attention (see DESIGN.md §4)")
    if grid is not None and cfg.sharding_profile != "dp":
        return f"SKIP({cfg.sharding_profile}): {NO_LAYOUT}"
    return ""


def _rows(grid, tree, n):
    """Every leaf's rows (leading axis of ``n``) of this rank's share of
    a serving batch: over the grid's ``batch`` rule, or all of them (each
    share its own storage, as a rank holds it)."""
    if grid is None:
        return tree
    entry = (spec_for(("batch",), (n,), grid) or (None,))[0]
    return tree_map(lambda v: grid.shard(v, (entry,)).clone(), tree)


def build_step(arch: str, shape_name: str, grid=None, *, remat=None,
               scala_overrides=None, cfg=None, shape=None,
               num_clients=None):
    """(step, args, meta, cfg): the step, its ``meta``-tensor arguments
    (this rank's params and serving rows on a grid; a ``lace_dp`` step
    takes the global batch and cuts it itself) and the record's keys.

    train: the fused local step, ``scala_local_step_fused`` (a ``dp`` arch
    on a grid: ``scala_local_step_fused_dp`` with the batch specs);
    prefill: ``forward_prefill``; decode: ``decode_step`` at the cache's
    last position. ``cfg``, ``shape`` (an ``InputShape``) and
    ``num_clients`` override the arch's config, the named shape and the
    grid's client count (a test's small sizes)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    meta = {"arch": arch, "shape": shape.name, "mode": shape.mode,
            "sharding_profile": cfg.sharding_profile,
            "layout": "replica"}
    if shape.mode == "train":
        C = num_clients or num_clients_for(grid)
        b_shapes, b_axes = ispec.train_batch_specs(cfg, shape, C)
        batch = ispec.meta_tree(b_shapes)
        params = ispec.meta_params(cfg, num_clients=C)
        model = transformer_split_model(cfg, remat=remat)
        sc = ScalaConfig(**(scala_overrides or {}))
        if grid is None:
            def step(params, batch):
                return scala_local_step_fused(model, params, batch, sc)
        else:
            b_specs = tree_specs(b_axes, b_shapes, grid)
            params["client"] = tree_map(
                torch.clone, grid.local_clients(params["client"]))
            meta["layout"] = ("lace_dp " + "x".join(
                str(n) for n in grid.shape.values()))

            def step(params, batch):
                return scala_local_step_fused_dp(model, params, batch, sc,
                                                 grid, b_specs)
        meta["num_clients"] = C
        meta["tokens"] = shape.global_batch * shape.seq_len
        return step, (params, batch), meta, cfg

    params = ispec.meta_params(cfg)
    B = shape.global_batch
    if shape.mode == "prefill":
        b_shapes, _ = ispec.prefill_batch_specs(cfg, shape)
        batch = _rows(grid, ispec.meta_tree(b_shapes), B)

        def step(params, batch):
            return T.forward_prefill(params, batch, cfg)

        meta["tokens"] = B * shape.seq_len
        return step, (params, batch), meta, cfg

    b_shapes, _, c_shapes, _ = ispec.decode_batch_specs(cfg, shape)
    batch = _rows(grid, ispec.meta_tree(b_shapes), B)
    cache = _rows(grid, ispec.meta_tree(c_shapes), B)

    def step(params, batch, cache):
        return T.decode_step(params, batch, cache, shape.seq_len - 1, cfg)

    meta["tokens"] = B                       # one token per sequence
    return step, (params, batch, cache), meta, cfg


def realize(tree, vocab: int, device="cpu", seed: int = 0):
    """Tensors of the shapes and dtypes of ``tree``'s (``meta``) tensors
    on ``device``, drawn from ``seed``: integers uniform in [0, vocab),
    floats uniform in [0, 0.02). Values to run a traced step on (the
    counts do not depend on them), not a model's."""
    gen = torch.Generator(device).manual_seed(seed)

    def draw(t):
        if t.is_floating_point():
            return (torch.rand(t.shape, generator=gen, device=device)
                    * 0.02).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen,
                             device=device, dtype=t.dtype)

    return tree_map(draw, tree)


def count_step(step, args):
    """(outputs, counts) of ``step(*args)`` run under a
    :class:`StepCount`: ``flops``, ``bytes``, ``memory`` (argument,
    output, temp and peak bytes: the most bytes live at once, arguments
    included, temp = peak - arguments), ``kernels`` and ``trace_s``."""
    counter = StepCount()
    t0 = time.perf_counter()
    with counter, warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        arg_bytes = counter.track(args)
        out = step(*args)
    trace_s = time.perf_counter() - t0
    peak = counter.peak_bytes
    return out, {
        "flops": float(counter.flops), "bytes": float(counter.bytes),
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": counter.new_bytes(out, args),
                   "temp_bytes": peak - arg_bytes, "peak_bytes": peak},
        "kernels": counter.kernels, "trace_s": round(trace_s, 3)}


def dryrun_one(arch: str, shape_name: str, *, grid_name: str = "1",
               remat=None, scala_overrides=None, cfg=None, shape=None,
               num_clients=None) -> dict:
    """The record of one (arch, shape, grid): ``status`` ok, skip (with
    ``reason``) or error (with ``error`` and ``traceback``). ``cfg``,
    ``shape`` and ``num_clients`` as :func:`build_step` takes them."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    record = {"arch": arch, "shape": shape.name, "mesh": grid_name}
    grid = grid_for(grid_name)
    reason = skip_reason(cfg, shape, grid)
    if reason:
        record.update(status="skip", reason=reason)
        return record
    try:
        step, args, meta, cfg = build_step(
            arch, shape_name, grid, remat=remat,
            scala_overrides=scala_overrides, cfg=cfg, shape=shape,
            num_clients=num_clients)
        record.update(meta)
        chips = 1 if grid is None else grid.world
        _, c = count_step(step, args)
        mem = c["memory"]
        coll = roofline.collectives_from_calls(
            [] if grid is None else grid.calls)
        min_bytes = (mem["argument_bytes"] + mem["output_bytes"]
                     + mem["temp_bytes"])
        terms = roofline.roofline_terms(c["flops"], c["bytes"],
                                        coll["total_bytes"], min_bytes)
        counts = roofline.count_params(
            *ispec.param_specs(cfg, meta.get("num_clients", 0)),
            top_k=cfg.moe.top_k if cfg.moe else 0,
            num_experts=cfg.moe.num_experts if cfg.moe else 0)
        mf = roofline.model_flops(counts["active"], meta["tokens"],
                                  "train" if shape.mode == "train"
                                  else "serve")
        record.update({
            "status": "ok",
            "chips": chips,
            "trace_s": c["trace_s"],
            "flops_per_device": c["flops"],
            "bytes_per_device": c["bytes"],
            "collectives": coll,
            "memory": mem,
            "fits_hbm": bool(mem["peak_bytes"] <= roofline.HBM_BYTES),
            "roofline": terms,
            "kernels": c["kernels"],
            "params_total": counts["total"],
            "params_active": counts["active"],
            "model_flops_global": mf,
            "model_flops_per_device": mf / chips,
            "useful_flops_ratio": ((mf / chips) / c["flops"]
                                   if c["flops"] else None),
            "peaks": roofline.PEAKS_NAME,
        })
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    return record


def summary(rec: dict) -> str:
    """One line of a record, as the sweep prints it."""
    extra = ""
    if rec["status"] == "ok":
        r = rec["roofline"]
        extra = (f" trace={rec['trace_s']}s bottleneck={r['bottleneck']}"
                 f" tc={r['t_compute_s']:.3e} tm={r['t_memory_s']:.3e}"
                 f" tmin={r['t_memory_min_s']:.3e}"
                 f" tx={r['t_collective_s']:.3e}"
                 f" peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:200]
    return f"[{rec['status']}] {rec['arch']} {rec['shape']} {rec['mesh']}" \
        + extra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grid", action="append", choices=GRID_NAMES,
                    help="grid name (repeatable; default '1': one card)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 grid")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16x16 and 2x16x16 grids")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run even if a cached ok/skip record exists")
    ap.add_argument("--no-constrain", action="store_true",
                    help="(the reference's; refused here)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    if args.no_constrain:
        raise SystemExit("--no-constrain has no counterpart in the port: "
                         "there is no ambient mesh and no in-graph "
                         "sharding constraint to turn off")
    archs = ASSIGNED_ARCHS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    grids = (["16x16", "2x16x16"] if args.both_meshes
             else ["2x16x16"] if args.multi_pod else args.grid or ["1"])
    os.makedirs(args.out, exist_ok=True)
    records = []
    for arch in archs:
        for shape in shapes:
            for g in grids:
                path = os.path.join(args.out, f"{arch}__{shape}__{g}.json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[cached] {arch} {shape} {g}: "
                              f"{prev['status']}", flush=True)
                        records.append(prev)
                        continue
                rec = dryrun_one(arch, shape, grid_name=g,
                                 remat=False if args.no_remat else None)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                print(summary(rec), flush=True)
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
