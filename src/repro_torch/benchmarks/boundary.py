"""The split boundary's loss stage alone: fused (one pass) against dual
(the reference's ``benchmarks/boundary.py``).

The SCALA step evaluates the adjusted cross-entropy twice: eq. 14 with
the concatenated prior P_s for the server update, eq. 15 with the
per-client priors P_k for the client gradients. ``boundary="fused"``
gives both values and both cotangents from one pass over a shared
``feats @ w_head`` product, ``"dual"`` takes two. This leg times the loss
stage alone over the reference's grid of (head width d, tokens per group,
chunk) cells on both backends:

* ``lace``: fused is :func:`~repro_torch.kernels.lace.ops.lace2_grads`
  (K1 + K2 on a card), dual two
  :func:`~repro_torch.kernels.lace.ops.lace_loss` passes under autograd,
  the server side with the head's gradient (K4 + K5 twice), as the
  engine's ``lace`` backend runs them;
* ``logits``: :func:`~repro_torch.core.losses.dual_adjusted_xent` against
  two :func:`~repro_torch.core.losses.softmax_xent` gradients over
  materialized (tokens, V) logits (``d`` only scales the token count and
  the chunk is unused, as in the reference).

``fused_speedup`` = dual time / fused time. On a card each time is the
median of ``reps`` CUDA-event timings after a warm-up call (which builds
the kernels); on the CPU a host clock's (numbers of the CPU's own kernels,
not of a card). The bf16 leg (feats and head in bf16) runs on a card
only. Inputs come from numpy's seeded generator, so the CPU tests feed
the same ones to the reference.

    PYTHONPATH=src python -m repro_torch.benchmarks.boundary [--reps 5]
    PYTHONPATH=src python -m repro_torch.benchmarks.boundary --smoke
    PYTHONPATH=src python -m repro_torch.benchmarks.boundary --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import device_info
from repro_torch.core import losses
from repro_torch.kernels.lace.ops import lace2_grads, lace_loss

# (head width d, token count per group, ce chunk); the last cell chunks
# at the full token count -- the memory-bound one-chunk reference
GRID = ((128, 2048, 512), (256, 4096, 1024), (512, 2048, 512),
        (256, 4096, 4096))
BACKENDS = ("lace", "logits")
G = 4                # client groups (lace backend)
V = 8192             # classes / vocab
TAU = 1.3
EPS = 1e-8
#: qwen1.5-0.5b's head: d 1024, V 151936, G x 2048 tokens
QWEN_CELL = ((1024, 2048, 2048),)
QWEN_CLASSES = 151936


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def lace_case(d: int, n: int, classes: int = V, seed: int = 0):
    """numpy (feats (G, n, d), w (d, V), labels (G, n), p_s (1, V), p_k
    (G, V)) in float32 / int32, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((G, n, d), dtype=np.float32)
    w = (rng.standard_normal((d, classes), dtype=np.float32) * 0.02)
    labels = rng.integers(0, classes, (G, n)).astype(np.int32)
    p_s = _softmax(rng.standard_normal(classes))[None].astype(np.float32)
    p_k = _softmax(rng.standard_normal((G, classes))).astype(np.float32)
    return feats, w.astype(np.float32), labels, p_s, p_k


def logits_case(d: int, n: int, classes: int = V, seed: int = 1):
    """numpy (logits (B, V), labels (B,), p_s (V,), p_k (B, V)), B =
    n G / 2."""
    rng = np.random.default_rng(seed)
    B = n * G // 2
    logits = rng.standard_normal((B, classes), dtype=np.float32)
    labels = rng.integers(0, classes, (B,)).astype(np.int32)
    p_s = _softmax(rng.standard_normal(classes)).astype(np.float32)
    p_k = _softmax(rng.standard_normal((B, classes))).astype(np.float32)
    return logits, labels, p_s, p_k


def lace_pair(d: int, n: int, ck: int, *, classes: int = V, device="cuda",
              dtype=torch.float32, seed: int = 0):
    """(dual, fused): two no-argument callables returning (loss_s, loss_k,
    df_s, df_k, dw_s) of the ``lace`` backend's loss stage."""
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    feats, w, labels, p_s, p_k = lace_case(d, n, classes, seed)
    feats, w = t(feats).to(dtype), t(w).to(dtype)
    labels, p_s, p_k = t(labels), t(p_s), t(p_k)
    ids = torch.arange(G, device=feats.device)

    def dual():
        f = feats.detach().requires_grad_()
        wh = w.detach().requires_grad_()
        ls = lace_loss(f, wh, labels, p_s, None, None, TAU, EPS, ck)
        gf_s, gw_s = torch.autograd.grad(ls, (f, wh))
        f = feats.detach().requires_grad_()
        lk = lace_loss(f, w, labels, p_k, ids, None, TAU, EPS, ck)
        (gf_k,) = torch.autograd.grad(lk, f)
        return ls.detach(), lk.detach(), gf_s, gf_k, gw_s

    def fused():
        return lace2_grads(feats, w, labels, p_s, None, p_k, ids, None,
                           TAU, EPS, ck)[:5]

    return dual, fused


def logits_pair(d: int, n: int, ck: int, *, classes: int = V,
                device="cuda", seed: int = 1):
    """(dual, fused) of the ``logits`` backend's loss stage, each
    returning (loss_s, loss_k, g_s, g_k)."""
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    logits, labels, p_s, p_k = (t(a) for a in logits_case(d, n, classes,
                                                           seed))

    def dual():
        z = logits.detach().requires_grad_()
        ls = losses.softmax_xent(z, labels, prior=p_s, tau=TAU)
        (g_s,) = torch.autograd.grad(ls, z)
        z = logits.detach().requires_grad_()
        lk = losses.softmax_xent(z, labels, prior=p_k, tau=TAU)
        (g_k,) = torch.autograd.grad(lk, z)
        return ls.detach(), lk.detach(), g_s, g_k

    def fused():
        return losses.dual_adjusted_xent(logits, labels, prior_s=p_s,
                                         prior_k=p_k, tau=TAU)

    return dual, fused


def median_ms(fn, reps: int, device) -> float:
    """The median of ``reps`` timings of ``fn()`` after one warm-up call:
    CUDA events on a card, the host clock on the CPU."""
    fn()
    cuda = torch.device(device).type == "cuda"
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(sorted(ts)[len(ts) // 2])


def _cells(grid, pair, reps, device, **kw):
    entry = {}
    for d, n, ck in grid:
        dual, fused = pair(d, n, ck, device=device, **kw)
        td = median_ms(dual, reps, device)
        tf = median_ms(fused, reps, device)
        entry[f"d={d},tokens={n},chunk={ck}"] = {
            "dual_ms": round(td, 4), "fused_ms": round(tf, 4),
            "fused_speedup": round(td / tf, 3)}
    return entry


def bench_boundary(grid=GRID, backends=BACKENDS, reps: int = 3, *,
                   classes: int = V, device="cuda"):
    """The reference's ``bench_boundary`` result: per backend and cell
    ``dual_ms``, ``fused_ms``, ``fused_speedup``, and the grid's
    ``max_speedup`` / ``min_speedup``."""
    res = {
        "bench": "boundary",
        "config": {"groups": G, "classes": classes, "tau": TAU,
                   "grid": [list(c) for c in grid], "reps": reps},
        "backend": device_info(device)["platform"],
        "backends": {},
    }
    for backend in backends:
        pair = lace_pair if backend == "lace" else logits_pair
        entry = _cells(grid, pair, reps, device, classes=classes)
        ratios = [v["fused_speedup"] for v in entry.values()]
        entry["max_speedup"] = max(ratios)
        entry["min_speedup"] = min(ratios)
        res["backends"][backend] = entry
    return res


def bench_boundary_bf16(grid=GRID, reps: int = 3, *, classes: int = V,
                        device="cuda"):
    """The card-only leg: bf16 feats and head through the ``lace`` pair
    (K1 / K2 and K4 / K5 take a bf16 operand as one TF32 term)."""
    if torch.device(device).type != "cuda":
        raise ValueError("the bf16 leg runs on a card only")
    return _cells(grid, lace_pair, reps, device, classes=classes,
                  dtype=torch.bfloat16)


def smoke_guard(device="cuda"):
    """The fused-against-dual guard of ``--smoke`` and ``run.py --smoke``:
    one small ``lace`` cell; fused must take no longer than dual. A
    sub-1.0 first ratio gets one re-measure before failing. Returns the
    last result."""
    ratio, res = 0.0, None
    for attempt in (0, 1):
        res = bench_boundary(grid=((128, 1024, 256),), backends=("lace",),
                             reps=3, device=device)
        ratio = res["backends"]["lace"]["max_speedup"]
        print(f"fused-vs-dual loss-stage ratio: {ratio}"
              + (" (retry)" if attempt else ""), flush=True)
        if ratio >= 1.0:
            break
    if ratio < 1.0:
        raise AssertionError(
            f"boundary fusion regressed: the one-pass loss stage runs at "
            f"{ratio}x the two-pass rate (expected >= 1; reproduced twice)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="one-cell guard: fused no slower than dual")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.smoke:
        res = smoke_guard(args.device)
    else:
        res = bench_boundary(reps=args.reps, device=args.device)
        res["bf16"] = (bench_boundary_bf16(reps=args.reps,
                                           device=args.device)
                       if torch.device(args.device).type == "cuda" else
                       "gated: card-only leg (device=cpu)")
    res["device"] = device_info(args.device)
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
