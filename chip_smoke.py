#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build: every kernel of the serving path, from ``src/repro_torch/
   kernels/csrc`` with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the serving path gives it, with the stated tolerance; then its time
   (CUDA events), the plain version's, PyTorch's own call's
   (``library_ms``, a yardstick only) and the card's bound for the work;
4. serve: full-width qwen1.5-0.5b in bf16 through ServeSpec ->
   build_serve -> ServeEngine.serve, dense and paged cache; paged tokens
   must equal dense tokens, and every admitted request must have
   launched the attention kernel once per layer;
5. check: full width in float32, TF32 off -- the fused prefill's logits
   (through the kernel) against the token-by-token decode loop's (no
   kernel), and the engine's greedy tokens against the loop's.

Then one JSON line of kernel numbers, the ``nvidia-smi`` line again, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
exits nonzero; without a GPU it exits nonzero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "qwen1.5-0.5b"
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # float32 outside the tensor cores
PEAK_BYTES = 3.35e12                    # HBM3, H100 SXM
TOL = {torch.bfloat16: 3e-2,  # output rounded to bf16 (2^-8 relative)
       torch.float32: 1e-4}   # float32 sums over <= 2048 keys in another order
LOGIT_ATOL = 1e-3   # f32 logits of O(1) after 24 layers, sums in another order
# (P, H, KV, window, dtype): the prefill shapes of the served model
KERNEL_CASES = [(P, 16, 16, None, dt) for dt in (torch.bfloat16, torch.float32)
                for P in (128, 777, 2048)]
KERNEL_CASES += [(777, 16, 2, None, torch.bfloat16),      # GQA
                 (1024, 16, 16, 256, torch.bfloat16)]     # sliding window
REPORT_CASE = (777, 16, 16, None, torch.bfloat16)         # the JSON line's


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(P, H, KV, hd, window, dtype):
    """(ms, 'operations' | 'bytes'): the least time for causal attention
    over one prompt of P tokens, from the (q, k) pairs it must score."""
    span = np.arange(P) + 1
    pairs = int(np.minimum(span, window).sum() if window else span.sum())
    flops = 4 * hd * pairs * H            # QK^T and PV, 2 flops per MAC
    nbytes = (2 * P * H * hd + 2 * P * KV * hd) * torch.empty(
        (), dtype=dtype).element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    say("device", f"{name}; {count} device(s); nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(["flash_attn"])
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "built in" in line:
                say("build", f"{name}: {line.strip()}")
    say("build", f"all kernels ready in {time.perf_counter() - t0:.1f} s")


def phase_kernels():
    from repro_torch.kernels.flash_attn import kernel, ref
    import torch.nn.functional as F

    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    rows, max_err = {}, 0.0
    for case in KERNEL_CASES:
        P, H, KV, window, dtype = case
        hd = 64
        q = torch.randn((1, P, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, P, KV, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((1, P, KV, hd), generator=gen, device="cuda").to(dtype)

        def run_kernel():
            return kernel.flash_attention_cuda(q, k, v, causal=True,
                                               window=window)

        def run_plain():
            return ref.mha_ref(q, k, v, causal=True, window=window)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(P, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

        def run_library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                **({"enable_gqa": True} if KV != H else {}))

        out = run_kernel()
        torch.cuda.synchronize()
        err = (out.float() - run_plain().float()).abs().max().item()
        lib_err = (run_library().transpose(1, 2).float()
                   - run_plain().float()).abs().max().item()
        max_err = max(max_err, err)
        check(err <= TOL[dtype], f"kernel vs plain {case}: {err} > {TOL[dtype]}")
        ms, plain_ms, lib_ms = (time_ms(f) for f in
                                (run_kernel, run_plain, run_library))
        bound_ms, bound_by = attention_bound(P, H, KV, hd, window, dtype)
        rows[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        say("kernels", f"flash_attn_fwd P={P} H={H} KV={KV} hd={hd} "
            f"window={window} {str(dtype)[6:]}: max_abs_err={err:.3g} "
            f"(tol {TOL[dtype]}; sdpa vs plain {lib_err:.3g}) "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"sdpa={lib_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by})")
    return rows, max_err


def serve_run(spec, reqs, warm_len: int):
    """Build ``spec``, warm up, serve ``reqs`` with the launch count reset
    just before. Returns (engine, results, seconds, launches, peak bytes,
    cache bytes)."""
    from repro_torch.api import build_serve
    from repro_torch.kernels.flash_attn import ops

    program = build_serve(spec)
    engine = program.engine
    engine.warmup([warm_len])
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    results = engine.serve(list(reqs))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return engine, results, dt, launches, peak, engine.state_bytes()


def profile_serve(engine, reqs):
    """Serve ``reqs`` again under torch.profiler: the wall time, the
    device's busy time (sum of kernel times) and the kernels that take
    the most of it. Profiling slows the host, so only the device numbers
    are read from this run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(list(reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy == 0:
        say("profile", "device time not measured (the profiler saw no "
            "kernels)")
        return
    say("profile", f"profiled dense run: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), {len(kernels)} kernel "
        "names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        t = e.self_device_time_total / 1e6
        say("profile", f"  {t:.4f} s ({100 * t / busy:.1f}% of busy) "
            f"x{e.count}: {e.key[:90]}")


def phase_serve(device="cuda", reduced=False, n_req=16, lens=(128, 333, 512, 777),
                gen=32, slots=8, max_len=1024, page_size=16):
    from repro_torch.api import ServeSpec
    from repro_torch.serve import Request

    spec = ServeSpec(arch=ARCH, reduced=reduced, slots=slots, max_len=max_len,
                     seed=0, device=device)
    cfg = spec.model_config()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(P)), gen)
            for i, P in enumerate(rng.choice(lens, n_req))]
    n_attn = sum(s.mixer == "attn" for s in cfg.block_specs)
    pages = slots * -(-max_len // page_size)
    launches, tokens = 0, None
    for paged in (False, True):
        s = dataclasses.replace(spec, pages=pages if paged else 0,
                                page_size=page_size)
        engine, results, dt, n, peak, cache = serve_run(s, reqs, min(lens))
        check(set(results) == {r.rid for r in reqs}, "every request served")
        for r in reqs:
            res = results[r.rid]
            check(res.evicted is None and
                  len(res.tokens) == len(r.tokens) + gen,
                  f"request {r.rid} ran to its max_new")
        check(n == len(reqs) * n_attn,
              f"kernel launches {n} != {len(reqs)} admits x {n_attn} layers")
        launches += n
        got = {r.rid: results[r.rid].tokens for r in reqs}
        if tokens is None:
            tokens = got
        else:
            check(all(np.array_equal(tokens[i], got[i]) for i in tokens),
                  "paged tokens == dense tokens")
        lats = [results[r.rid].latency for r in reqs]
        say("serve", f"{cfg.name} {cfg.dtype} {'paged' if paged else 'dense'} "
            f"cache: {len(reqs)} reqs (prompts {sorted(set(len(r.tokens) for r in reqs))}) "
            f"x {gen} tok on {slots} slots in {dt:.3f} s: "
            f"{len(reqs) * gen / dt:.1f} tok/s, latency p50={np.percentile(lats, 50):.3f} s "
            f"p99={np.percentile(lats, 99):.3f} s, peak {peak / 2**20:.0f} MiB "
            f"allocated, cache {cache / 1e6:.1f} MB, {n} kernel launches")
        if not paged and engine.device.type == "cuda":
            profile_serve(engine, reqs)
        del engine
    say("serve", "paged tokens == dense tokens; launches == admits x "
        f"{n_attn} attention layers")
    return launches


def phase_check(device="cuda", reduced=False, prompt_len=64, max_len=128):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator(device)
    gen.manual_seed(1)
    params = T.init_params(gen, cfg)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)),
                             device=device)
    with torch.no_grad():
        logits, _ = T.forward_prefill_cached(params, {"tokens": prompt}, cfg,
                                             max_len)
    _, logs = generate(params, cfg, prompt, max_len, 1, return_logits=True)
    err = (logits[0, 0] - logs[0][0]).abs().max().item()
    scale = logs[0].abs().max().item()
    check(err <= LOGIT_ATOL, f"prefill vs loop logits {err} > {LOGIT_ATOL}")
    say("check", f"{cfg.name} float32: prefill logits (kernel) vs "
        f"token-by-token loop: max_abs_err={err:.3g} (atol {LOGIT_ATOL}, "
        f"max |logit| {scale:.3g})")

    engine = ServeEngine(params, cfg, slots=2, max_len=max_len, device=device)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, P), 8)
            for i, P in enumerate((16, 24))]
    res = engine.serve(reqs, wall_clock=False)
    for r in reqs:
        ref = generate(params, cfg, torch.as_tensor(r.tokens[None],
                                                    device=device),
                       max_len, r.max_new).cpu().numpy()[0]
        check(np.array_equal(res[r.rid].tokens, ref),
              f"engine tokens == loop tokens for request {r.rid}")
    say("check", f"engine greedy tokens == loop tokens for {len(reqs)} requests")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi = phase_device()
    phase_build()
    rows, max_err = phase_kernels()
    launches = phase_serve()
    phase_check()
    r = rows[REPORT_CASE]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:23",
        "launches": launches, "max_abs_err": max_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
