"""Continuous against static admission on the serving engine (the
reference's ``benchmarks/serve.py``).

Same engine, cache and kernels on both sides; only the admission
schedule differs, so the token-rate ratio isolates the scheduling win.
Per slot count:

* ``batch``: every request present at t=0 (``wall_clock=False``); the
  median of ``reps`` runs. Static admission waits for the longest
  request of a wave while short ones hold dead slots; continuous
  admission refills a slot at once.
* ``open_loop``: requests arrive on the wall clock with gaps drawn from
  :func:`repro_torch.fed.delays.make_delays`, on the host with numpy
  (the reference draws them from ``jax.random``, so the gaps differ);
  per-request latency p50 / p99 beside tok/s.
* ``paged``: the continuous batch leg from the paged pool; its greedy
  tokens equal the dense leg's (the serving contract), and the entry
  gives the cache-bytes ratio.

Each leg also keeps every request's tokens (``tokens``: rid -> prompt +
generated), so a caller can hold the legs against each other. Times are
host-clock seconds around ``ServeEngine.serve`` (which waits for its
tokens on the host); the result is stamped with the device.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve \\
        [--arch qwen1.5-0.5b [--reduced]] [--device cpu]
    PYTHONPATH=src python -m repro_torch.benchmarks.serve --smoke
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import device_info
from repro_torch.configs.base import ModelConfig
from repro_torch.fed.delays import make_delays
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

# registry-free micro decoder for the smoke guard: the guard measures
# scheduling, not the model
MICRO = ModelConfig(
    name="micro-serve", family="dense", source="bench", num_layers=2,
    d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
    vocab_size=97, split_layer=1, dtype="float32", param_dtype="float32")

PROMPT_LENS = (8, 16)
GENS = (4, 16)                     # mixed budgets: the continuous win


def config(arch=None, reduced=True) -> ModelConfig:
    """``MICRO`` for ``arch=None``, else the arch, reduced or at full
    width."""
    if arch is None:
        return MICRO
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.reduced() if reduced else cfg


def setup(arch=None, reduced=True, device="cuda", seed=0):
    """(cfg, params): :func:`config`'s, params drawn from ``seed`` on
    ``device``."""
    cfg = config(arch, reduced)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, T.init_params(gen, cfg)


def requests(cfg, n, prompt_lens, gens, gap_spec, gap_scale, seed=0):
    """``n`` mixed-length requests; open-loop arrivals are the cumulative
    gaps drawn from the delay model (``gap_scale`` seconds a unit), the
    prompts from ``default_rng([seed, 2 + i])``."""
    gaps = make_delays(gap_spec).draw(seed, 1, (n,)) * gap_scale
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    reqs = []
    for i in range(n):
        P = prompt_lens[i % len(prompt_lens)]
        toks = np.random.default_rng([seed, 2 + i]).integers(
            0, cfg.vocab_size, P).astype(np.int32)
        reqs.append(Request(i, toks, gens[i % len(gens)],
                            arrival=float(arrivals[i])))
    return reqs


def _percentile(xs, q):
    return round(float(np.percentile(np.asarray(xs), q)), 4)


def run_leg(params, cfg, reqs, *, slots, max_len, admission, pages=0,
            page_size=16, open_loop=False, reps=1, device="cuda"):
    """One leg: seconds (median over ``reps``), tok/s, cache MB, every
    request's tokens, and on the open loop the latency p50 / p99."""
    eng = ServeEngine(params, cfg, slots=slots, max_len=max_len,
                      pages=pages, page_size=page_size, admission=admission,
                      device=device)
    eng.warmup(sorted({len(r.tokens) for r in reqs}))
    total = sum(r.max_new for r in reqs)
    times, res = [], {}
    for _ in range(reps):
        t0 = time.perf_counter()
        res = eng.serve(list(reqs), wall_clock=open_loop)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    out = {"seconds": round(dt, 4),
           "tok_per_sec": round(total / dt, 2),
           "cache_mb": round(eng.state_bytes() / 1e6, 3),
           "tokens": {r.rid: res[r.rid].tokens.tolist() for r in reqs}}
    if open_loop:
        lats = [res[r.rid].latency for r in reqs]
        out["latency_p50_s"] = _percentile(lats, 50)
        out["latency_p99_s"] = _percentile(lats, 99)
    return out


def bench_serve(arch=None, reduced=True, n_requests=12, slots_list=(2, 4),
                prompt_lens=PROMPT_LENS, gens=GENS,
                gap_spec="lognormal:1:1", gap_scale=0.02, reps=3,
                page_size=8, device="cuda", params=None):
    """The reference's ``bench_serve`` result on ``device``; ``params``
    (with ``arch=None``: MICRO's) replaces the seeded ones."""
    if params is None:
        cfg, params = setup(arch, reduced, device)
    else:
        cfg = config(arch, reduced)
    max_len = max(prompt_lens) + max(gens)
    res = {
        "config": {"arch": cfg.name, "n_requests": n_requests,
                   "prompt_lens": list(prompt_lens), "gens": list(gens),
                   "max_len": max_len, "gap_delays": gap_spec,
                   "gap_scale_s": gap_scale, "page_size": page_size,
                   "reps": reps},
        "slots": {},
    }
    reqs = requests(cfg, n_requests, prompt_lens, gens, gap_spec,
                    gap_scale)
    leg = dict(max_len=max_len, device=device)
    for slots in slots_list:
        entry = {}
        for name, open_loop in (("batch", False), ("open_loop", True)):
            sub = {}
            for admission in ("static", "continuous"):
                sub[admission] = run_leg(params, cfg, reqs, slots=slots,
                                         admission=admission,
                                         open_loop=open_loop,
                                         reps=1 if open_loop else reps,
                                         **leg)
            sub["continuous_speedup"] = round(
                sub["continuous"]["tok_per_sec"]
                / sub["static"]["tok_per_sec"], 3)
            entry[name] = sub
        # the paged pool sized to the live worst case
        pages = slots * -(-max_len // page_size)
        paged = run_leg(params, cfg, reqs, slots=slots,
                        admission="continuous", pages=pages,
                        page_size=page_size, reps=reps, **leg)
        paged["pages"] = pages
        paged["cache_ratio_vs_dense"] = round(
            paged["cache_mb"] / entry["batch"]["continuous"]["cache_mb"], 3)
        entry["paged"] = paged
        res["slots"][str(slots)] = entry
    return res


def smoke_guard(device="cuda"):
    """The continuous-against-static guard of ``--smoke`` and ``run.py
    --smoke``: on MICRO with mixed budgets, continuous admission must
    sustain at least the static token rate. A sub-1.0 first ratio gets
    one re-measure before failing. Returns the last result."""
    ratio, res = None, None
    for attempt in (0, 1):
        res = bench_serve(arch=None, n_requests=8, slots_list=(2,),
                          prompt_lens=(6, 6), gens=(2, 10), gap_scale=0.0,
                          reps=3, device=device)
        ratio = res["slots"]["2"]["batch"]["continuous_speedup"]
        print(f"continuous-vs-static tok/s ratio (2 slots): {ratio}"
              + (" (retry)" if attempt else ""), flush=True)
        if ratio >= 1.0:
            break
    if ratio < 1.0:
        raise AssertionError(
            f"continuous batching regressed: {ratio}x the static token "
            "rate (expected >= 1; reproduced twice)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="'micro' = the registry-free smoke decoder")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--slots", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--gap-scale", type=float, default=0.02)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="MICRO; asserts continuous tok/s >= static")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.smoke:
        res = smoke_guard(args.device)
    else:
        res = bench_serve(arch=None if args.arch == "micro" else args.arch,
                          reduced=args.reduced, n_requests=args.n,
                          slots_list=tuple(args.slots),
                          gap_scale=args.gap_scale, reps=args.reps,
                          device=args.device)
    res["device"] = device_info(args.device)
    print(json.dumps({k: v for k, v in res.items() if k != "slots"}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
