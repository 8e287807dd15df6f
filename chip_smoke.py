#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build: every kernel source in ``src/repro_torch/kernels/csrc``
   (flash_attn, flash_attn_bwd, lace), one nvcc each, all at once, for
   sm_90a;
3. kernels: each kernel against its plain PyTorch version at the shapes
   its path gives it, with the stated tolerance; then its time (CUDA
   events), the plain version's, PyTorch's own call's (``library_ms``, a
   yardstick only) and the card's bound for the work -- the attention
   forward (K3) at the serving shapes, then the attention backward and
   the fused LACE boundary (K1, K2) at the training shapes;
4. serve: full-width qwen1.5-0.5b in bf16 through ServeSpec ->
   build_serve -> ServeEngine.serve, dense and paged cache; paged tokens
   must equal dense tokens, and every admitted request must have
   launched the attention kernel once per layer;
5. check: full width in float32, TF32 off -- the fused prefill's logits
   (through the kernel) against the token-by-token decode loop's (no
   kernel), and the engine's greedy tokens against the loop's;
6. train: full-width qwen1.5-0.5b through the training CLI's spec and
   Trainer on the card -- 16 clients, 4 sampled per round, 2 local steps
   of 16 x 512 tokens, 3 rounds; finite losses, the kernels' launch
   counts per round against the layout's formula, round seconds, tokens/s,
   peak memory and a profiled round's device-busy share;
7. train-check: full width in float32, TF32 off -- one split step and
   one round on the card (K1, K2, K3 forward and backward) against the
   same on the CPU (the plain versions).

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
# (B, P, H, KV, window, dtype): the prefill shapes of the served model,
# then the training trunk's (16 sequences of 512 tokens)
KERNEL_CASES = [(1, P, 16, 16, None, dt)
                for dt in (torch.bfloat16, torch.float32)
                for P in (128, 777, 2048)]
KERNEL_CASES += [(1, 777, 16, 2, None, torch.bfloat16),      # GQA
                 (1, 1024, 16, 16, 256, torch.bfloat16),     # sliding window
                 (16, 512, 16, 16, None, torch.bfloat16)]    # training
REPORT_CASE = (1, 777, 16, 16, None, torch.bfloat16)         # the JSON line's
# attention backward, (B, P, H, KV, window, dtype): the training trunk's
# shape (16 sequences of 512 tokens) first, then other lengths, GQA and a
# window. Tolerance against autograd of the plain version, relative to
# the largest entry: bf16 3e-2 (inputs, output and grads rounded to
# bf16), f32 1e-4 (sums in another order).
FLASH_BWD_CASES = [(16, 512, 16, 16, None, torch.bfloat16),
                   (16, 512, 16, 16, None, torch.float32),
                   (1, 777, 16, 16, None, torch.bfloat16),
                   (1, 777, 16, 16, None, torch.float32),
                   (4, 512, 16, 2, None, torch.bfloat16),          # GQA
                   (2, 1024, 16, 16, 256, torch.bfloat16)]         # window
FLASH_BWD_REPORT = FLASH_BWD_CASES[0]
# the fused LACE boundary (K1, K2), (N tokens, feats dtype, tau) at the
# training width (d 1024, V 151936, 4 per-client prior rows, one
# concatenated row, the last eighth of each client's tokens weight 0):
# the main path's 8192 tokens first, then 2048, a ragged N and tau = 0.
# Tolerance against the plain version, f32 on the CUDA cores with TF32
# off: nll and lse within 1e-4 of their largest entry, df and dW within
# 1e-5 of theirs; df of the first 256 tokens also within 1e-5 of the
# float64 value.
LACE_CASES = [(8192, torch.bfloat16, 1.0), (8192, torch.float32, 1.0),
              (2048, torch.bfloat16, 1.0), (2048, torch.float32, 0.0),
              (2047, torch.bfloat16, 1.0)]
LACE_REPORT = LACE_CASES[0]
LACE_CLIENTS = 4
# the training phase: the reference LM training CLI's defaults (SCALA, subset
# sampling, fused LACE boundary, weighted FedAvg, SGD) at full width
TRAIN_FLAGS = ["--arch", ARCH, "--clients", "16", "--participation", "0.25",
               "--local-iters", "2", "--seq", "512", "--server-batch", "16",
               "--docs-per-client", "8", "--rounds", "3", "--seed", "0"]
# f32 full-width step and round, card against CPU: losses within 1e-4
# relative, every grad leaf within 1e-3 of its largest entry, every
# aggregated client param within 3 ulps plus 1e-3 of its leaf's largest
# update (float32 sums in other orders through 24 layers)
LOSS_RTOL, LEAF_RTOL = 1e-4, 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after ``warmup``."""
    for _ in range(warmup):
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


def causal_pairs(P, window):
    """The (query, key) pairs causal attention over P tokens scores."""
    span = np.arange(P) + 1
    return int(np.minimum(span, window).sum() if window else span.sum())


def attention_bound(B, P, H, KV, hd, window, dtype):
    """(ms, 'operations' | 'bytes'): the least time for causal attention
    over B prompts of P tokens, from the (q, k) pairs it must score."""
    flops = 4 * hd * causal_pairs(P, window) * H * B   # QK^T and PV
    nbytes = B * (2 * P * H * hd + 2 * P * KV * hd) * torch.empty(
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
    logs = build.build(["flash_attn", "flash_attn_bwd", "lace"])
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
        B, P, H, KV, window, dtype = case
        hd = 64
        q = torch.randn((B, P, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, P, KV, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, P, KV, hd), generator=gen, device="cuda").to(dtype)

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
        bound_ms, bound_by = attention_bound(B, P, H, KV, hd, window, dtype)
        rows[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        say("kernels", f"flash_attn_fwd B={B} P={P} H={H} KV={KV} hd={hd} "
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


def profile(what: str, fn, top: int) -> None:
    """Run ``fn`` once more under torch.profiler: the wall time, the
    device's busy time (the sum of kernel times) and the ``top`` kernels
    that take the most of it. Profiling slows the host, so only the
    device numbers are read from this run."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy == 0:
        say("profile", "device time not measured (the profiler saw no "
            "kernels)")
        return
    say("profile", f"profiled {what}: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), {len(kernels)} kernel "
        "names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
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
            profile("dense run", lambda: engine.serve(list(reqs)), 6)
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


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (at least 1e-30)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def phase_flash_bwd():
    """The attention backward kernel against autograd of the plain
    version; ``library_ms`` is SDPA's backward alone, timed through
    autograd with the graph kept (the forward outside the timed
    region)."""
    from repro_torch.kernels.flash_attn import kernel, ref
    import torch.nn.functional as F

    gen = torch.Generator("cuda")
    gen.manual_seed(1)
    rows, max_err = {}, 0.0
    for case in FLASH_BWD_CASES:
        B, P, H, KV, window, dtype = case
        hd = 64
        q, k, v = (torch.randn((B, P, n, hd), generator=gen, device="cuda")
                   .to(dtype).requires_grad_() for n in (H, KV, KV))
        gout = torch.randn((B, P, H, hd), generator=gen,
                           device="cuda").to(dtype)
        with torch.no_grad():
            out, lse = kernel.flash_attention_cuda(q, k, v, causal=True,
                                                   window=window,
                                                   return_lse=True)
        want = ref.mha_ref(q, k, v, causal=True, window=window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(P, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                 < window)
        lib = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            **({"enable_gqa": True} if KV != H else {}))
        gout_t = gout.transpose(1, 2)

        def run_kernel():
            return kernel.flash_attention_bwd_cuda(q, k, v, out, lse, gout,
                                                   causal=True, window=window)

        def run_plain():
            return torch.autograd.grad(want, (q, k, v), gout,
                                       retain_graph=True)

        def run_library():
            return torch.autograd.grad(lib, (q, k, v), gout_t,
                                       retain_graph=True)

        got = run_kernel()
        sync("cuda")
        exp = run_plain()
        tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
        errs = [rel_err(a, b) for a, b in zip(got, exp)]
        max_err = max(max_err, max((a.float() - b.float()).abs().max().item()
                                   for a, b in zip(got, exp)))
        check(max(errs) <= tol,
              f"flash bwd vs autograd of plain {case}: {errs} > {tol}")
        ms, plain_ms, lib_ms = (time_ms(f, iters=5, warmup=1) for f in
                                (run_kernel, run_plain, run_library))
        pairs = causal_pairs(P, window) * B * H
        flops = 10 * hd * pairs        # S, dP, dV, dK, dQ: 5 products
        el = torch.empty((), dtype=dtype).element_size()
        # read q, o, dO, k, v and lse; write dq, dk, dv
        nbytes = (el * (4 * B * P * H * hd + 4 * B * P * KV * hd)
                  + 4 * B * H * P)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
        rows[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=max(t_ops, t_bytes) * 1e3,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes")
        say("kernels", f"flash_attn_bwd B={B} P={P} H={H} KV={KV} hd={hd} "
            f"window={window} {str(dtype)[6:]}: rel err dq/dk/dv "
            f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (tol {tol}) "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"sdpa_bwd={lib_ms:.4f} ms bound={rows[case]['bound_ms']:.4f} "
            f"ms ({rows[case]['bound_by']})")
    return rows, max_err


def lace_inputs(N, dtype, tau, d=1024, V=151936, G=LACE_CLIENTS):
    """Boundary inputs at the training width, from a seeded generator:
    feats (N, d), w_head (d, V) f32, labels, the two sides' prior tables
    and per-token client ids, and the per-token scale weight / sum."""
    from repro_torch.kernels.lace import ops

    gen = torch.Generator("cuda")
    gen.manual_seed(N)
    feats = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    w = torch.randn((d, V), generator=gen, device="cuda") * d ** -0.5
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    cid = (torch.arange(N, device="cuda") * G // N)
    weights = torch.ones(N, device="cuda")
    for c in range(G):            # the last eighth of each client: weight 0
        rows = (cid == c).nonzero()[:, 0]
        weights[rows[-(len(rows) // 8):]] = 0.0
    p = torch.rand((1 + G, V), generator=gen, device="cuda") ** 4
    p[1:, : V // 10] = 0.0        # classes a client never saw
    p = p / p.sum(-1, keepdim=True)
    adj_s, _ = ops._side_table(p[:1], None, tau, 1e-8, 1, N)
    adj_k = (tau * torch.log(p[1:] + 1e-8)).contiguous()
    ts = (weights / weights.sum()).contiguous()
    return (feats, w, labels, adj_s, None, adj_k,
            cid.to(torch.int32).contiguous()), weights, ts


def lace_df_f64(args, ts, n=256):
    """df_s, df_k of the first ``n`` tokens computed in float64 from the
    same inputs (own log-sum-exp): the exact value both f32 versions
    round."""
    feats, w, labels, adj_s, ids_s, adj_k, ids_k = args
    w64 = w.double()
    z = feats[:n].double() @ w64
    lab = labels[:n].long()[:, None]
    out = []
    for adj, ids in ((adj_s, ids_s), (adj_k, ids_k)):
        g = torch.softmax(z + (adj[0] if ids is None
                               else adj[ids[:n].long()]).double(), -1)
        g.scatter_add_(-1, lab, torch.full_like(lab, -1, dtype=g.dtype))
        out.append((g * ts[:n, None].double()) @ w64.T)
    return out


def phase_lace():
    """K1 and K2 against their plain versions (same arguments, chunked
    logits); ``library_ms`` is the one cuBLAS product feats @ W, a
    yardstick only (no PyTorch call computes the fused boundary)."""
    from repro_torch.kernels.lace import kernel, ref

    rows, errs = {}, {"fwd": 0.0, "bwd": 0.0}
    for case in LACE_CASES:
        N, dtype, tau = case
        args, weights, ts = lace_inputs(N, dtype, tau)
        feats, w = args[0], args[1]
        d, V = w.shape
        got = kernel.lace2_fwd_cuda(*args)
        sync("cuda")
        exp = ref.lace2_fwd_plain(*args)
        e_fwds = [rel_err(a, b) for a, b in zip(got, exp)]
        e_fwd = max(e_fwds)
        check(e_fwd <= 1e-4, f"lace2_fwd vs plain {case}: nll_s, nll_k, "
              f"lse_s, lse_k {e_fwds}")
        lse = got[2:]
        bargs = args + lse + (ts, ts)
        gb = kernel.lace2_bwd_cuda(*bargs)
        sync("cuda")
        eb = ref.lace2_bwd_plain(*bargs)
        e_bwds = [rel_err(a, b) for a, b in zip(gb, eb)]
        e_bwd = max(e_bwds)
        check(e_bwd <= 1e-5, f"lace2_bwd vs plain {case}: df_s, df_k, dW_s "
              f"{e_bwds}")
        exact = lace_df_f64(args, ts)
        e_exact = [rel_err(x[:256].double(), e) for x, e in zip(gb, exact)]
        e_exact_plain = [rel_err(x[:256].double(), e)
                         for x, e in zip(eb, exact)]
        check(max(e_exact) <= 1e-5, f"lace2_bwd vs float64 {case}: df_s, "
              f"df_k {e_exact}")
        zero = weights == 0
        check(bool((gb[0][zero] == 0).all() and (gb[1][zero] == 0).all()),
              f"weight-0 rows get exactly zero df {case}")
        errs["fwd"] = max(errs["fwd"], max(
            (a - b).abs().max().item() for a, b in zip(got, exp)))
        errs["bwd"] = max(errs["bwd"], max(
            (a - b).abs().max().item() for a, b in zip(gb, eb)))
        f32 = feats.float()
        times = {name: time_ms(fn, iters=3, warmup=1) for name, fn in (
            ("fwd", lambda: kernel.lace2_fwd_cuda(*args)),
            ("fwd_plain", lambda: ref.lace2_fwd_plain(*args)),
            ("bwd", lambda: kernel.lace2_bwd_cuda(*bargs)),
            ("bwd_plain", lambda: ref.lace2_bwd_plain(*bargs)),
            ("library", lambda: f32 @ w))}
        G = args[5].shape[0]
        el = feats.element_size()
        in_bytes = el * N * d + 4 * d * V + 4 * N * 2 + 4 * (1 + G) * V
        for kind, flops, nbytes in (
                ("fwd", 2 * N * d * V, in_bytes + 4 * 4 * N),
                ("bwd", 8 * N * d * V,
                 in_bytes + 4 * 4 * N + 4 * (2 * N * d + d * V))):
            t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], \
                nbytes / PEAK_BYTES
            rows[(case, kind)] = dict(
                ms=times[kind], plain_ms=times[kind + "_plain"],
                library_ms=times["library"],
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")
        say("kernels", f"lace2 N={N} d={d} V={V} feats {str(dtype)[6:]} "
            f"tau={tau}: rel err nll_s/nll_k/lse_s/lse_k "
            f"{'/'.join(f'{e:.3g}' for e in e_fwds)} (tol 1e-4), df_s/df_k/dW_s "
            f"{'/'.join(f'{e:.3g}' for e in e_bwds)} (tol 1e-5); df_s/df_k "
            f"of 256 tokens vs float64: kernel "
            f"{'/'.join(f'{e:.3g}' for e in e_exact)}, plain "
            f"{'/'.join(f'{e:.3g}' for e in e_exact_plain)} (tol 1e-5); "
            f"K1 {times['fwd']:.2f} ms (plain "
            f"{times['fwd_plain']:.2f}, bound "
            f"{rows[(case, 'fwd')]['bound_ms']:.2f}); K2 {times['bwd']:.2f} "
            f"ms (plain {times['bwd_plain']:.2f}, bound "
            f"{rows[(case, 'bwd')]['bound_ms']:.2f}); cuBLAS feats@W "
            f"{times['library']:.2f} ms")
    return rows, errs


def train_launches(spec, cfg):
    """Kernel launches one local step makes, from the layout: every
    client slot runs the client blocks once forward and pulls them back
    once; the server trunk (not rematerialized) runs once forward and is
    pulled back twice (the P_s cotangent for w_s, the P_k one for the
    activations); one K1 and one K2 launch at the boundary."""
    slots = spec.slots
    n_client = sum(cfg.block_spec(l).mixer == "attn"
                   for l in range(cfg.split_layer))
    n_server = sum(cfg.block_spec(l).mixer == "attn"
                   for l in range(cfg.split_layer, cfg.num_layers))
    return dict(flash_fwd=slots * n_client + n_server,
                flash_bwd=slots * n_client + 2 * n_server,
                lace_fwd=1, lace_bwd=1)


def read_counts():
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.lace import ops as lops
    return dict(flash_fwd=fops.LAUNCHES, flash_bwd=fops.LAUNCHES_BWD,
                lace_fwd=lops.LAUNCHES_FWD, lace_bwd=lops.LAUNCHES_BWD)


def zero_counts():
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.lace import ops as lops
    fops.LAUNCHES = fops.LAUNCHES_BWD = 0
    lops.LAUNCHES_FWD = lops.LAUNCHES_BWD = 0


def phase_train(device="cuda", flags=TRAIN_FLAGS, profile_round=True):
    """Full-width training through the CLI's spec and the Trainer: the
    kernels' launches per round against :func:`train_launches`, finite
    losses, round seconds (rounds 2 on; round 1 includes warm-up),
    tokens/s, peak memory, and a profiled extra round."""
    from repro_torch import api
    from repro_torch.launch import train

    spec = train.spec_from_args(train.build_parser().parse_args(flags))
    spec.validate()
    cfg = spec.model_config()
    t0 = time.perf_counter()
    trainer = api.Trainer(spec, device=device)
    sync(device)
    say("train", f"{cfg.name} {cfg.dtype} compute, {cfg.param_dtype} params: "
        f"{spec.scala.num_clients} clients, {spec.slots} per round, "
        f"{spec.scala.local_iters} local steps of "
        f"{spec.scala.server_batch} x {spec.data.seq} tokens; built in "
        f"{time.perf_counter() - t0:.1f} s")
    T = spec.scala.local_iters
    per_step = train_launches(spec, cfg)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    secs = []
    zero_counts()
    before = read_counts()
    for r in range(spec.rounds):
        t0 = time.perf_counter()
        m = trainer.step()
        sync(device)
        secs.append(time.perf_counter() - t0)
        now = read_counts()
        got = {k: now[k] - before[k] for k in now}
        before = now
        check(all(np.isfinite(m[k]) for k in ("loss_server", "loss_client")),
              f"finite losses in round {r}: {m}")
        if torch.device(device).type == "cuda":
            want = {k: T * n for k, n in per_step.items()}
            check(got == want, f"round {r} launches {got} != {want} "
                  f"({T} steps x {per_step})")
        say("train", f"round {r} loss_s={m['loss_server']:.4f} "
            f"loss_c={m['loss_client']:.4f} in {secs[-1]:.3f} s; launches "
            f"K3 fwd {got['flash_fwd']} bwd {got['flash_bwd']}, K1 "
            f"{got['lace_fwd']}, K2 {got['lace_bwd']}")
    counts = read_counts()
    steady = secs[1:] or secs
    round_s = float(np.mean(steady))
    tokens = T * spec.scala.server_batch * spec.data.seq
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    say("train", f"round seconds (rounds 1..{len(secs) - 1}, round 0 has "
        f"the warm-up): {[round(x, 3) for x in steady]}, mean "
        f"{round_s:.3f} s -> {tokens / round_s:.0f} training tokens/s; "
        f"round 0 {secs[0]:.3f} s; peak {peak / 2**20:.0f} MiB allocated; "
        f"per step: {per_step}")
    if profile_round and torch.device(device).type == "cuda":
        profile("training round", trainer.step, 8)
    return counts


def phase_train_check(device="cuda", reduced=False, C=2, S=64, T=2):
    """float32 at full width, TF32 off: one split step and one round on
    ``device`` (the kernels) against the same on the CPU (the plain
    versions), from the same params and batches."""
    from repro_torch.configs import ScalaConfig, get_config
    from repro_torch.core import engine
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import transformer as Tm
    from repro_torch.optim import optimizers
    from repro_torch.tree import leaves, tree_map

    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator(device)
    gen.manual_seed(2)
    full = Tm.init_params(gen, cfg)
    params = {"client": stack_client_params(full["client"], C),
              "server": full["server"]}
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (T, C, 1, S + 1))
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
               "weights": np.ones((T, C, 1, S), np.float32)}
    sizes = np.array([3.0, 1.0][:C], np.float32)
    sc = ScalaConfig(num_clients=C, lr=0.01)
    model = transformer_split_model(cfg)

    def on(dev):
        return (tree_map(lambda a: a.to(dev), params),
                {k: torch.from_numpy(v).to(dev) for k, v in batches.items()},
                torch.from_numpy(sizes).to(dev))

    res = {}
    for dev in (device, "cpu"):
        p, b, _ = on(dev)
        t0 = time.perf_counter()
        res[dev] = engine.split_step_grads(model, p, {k: v[0] for k, v in
                                                      b.items()}, sc)
        sync(dev)
        say("train-check", f"split step on {dev}: "
            f"{time.perf_counter() - t0:.2f} s")
    (g_dev, m_dev), (g_cpu, m_cpu) = res[device], res["cpu"]
    for k in ("loss_server", "loss_client"):
        a, b = float(m_dev[k]), float(m_cpu[k])
        check(abs(a - b) <= LOSS_RTOL * abs(b), f"{k} {a} vs cpu {b}")
    head = rel_err(g_dev["server"]["head"]["out"].cpu(),
                   g_cpu["server"]["head"]["out"])
    worst = max(rel_err(a.cpu(), b) for a, b in zip(leaves(g_dev),
                                                     leaves(g_cpu)))
    check(head <= LEAF_RTOL and worst <= LEAF_RTOL,
          f"grads: head dW {head}, worst leaf {worst} > {LEAF_RTOL}")
    say("train-check", f"{cfg.name} float32 split step, {C} clients x {S} "
        f"tokens, {device} (kernels) vs cpu (plain): loss_s "
        f"{float(m_dev['loss_server']):.6f} vs {float(m_cpu['loss_server']):.6f}, "
        f"loss_c {float(m_dev['loss_client']):.6f} vs "
        f"{float(m_cpu['loss_client']):.6f} (rtol {LOSS_RTOL}); head dW rel "
        f"err {head:.3g}, worst of {len(leaves(g_cpu))} grad leaves "
        f"{worst:.3g} (tol {LEAF_RTOL})")
    del res, g_dev, g_cpu

    new = {}
    for dev in (device, "cpu"):
        p, b, s = on(dev)
        round_fn = engine.make_round_runner(model, sc)
        state, _ = round_fn(engine.init_train_state(p, optimizers.sgd()),
                            b, s)
        new[dev] = [a.cpu() for a in leaves(state.params["client"])]
    # Each device rounds the update p - lr * g, the client weight's product
    # and the weighted sum to float32 on its own (half an ulp each), so
    # the two may land up to three ulps apart where the updates agree:
    # that is allowed, and the rest of the difference is measured against
    # the leaf's largest update.
    ulp = torch.finfo(torch.float32).eps
    worst = max(
        ((a - b).abs() - 3 * ulp * b.abs()).clamp(min=0).max().item()
        / max((b - b0.cpu()).abs().max().item(), 1e-30)
        for a, b, b0 in zip(new[device], new["cpu"],
                            leaves(params["client"])))
    check(worst <= LEAF_RTOL, f"round client params: {worst} > {LEAF_RTOL}")
    say("train-check", f"one round ({T} steps + FedAvg): aggregated client "
        f"params, {device} vs cpu, worst leaf difference beyond 3 ulps "
        f"{worst:.3g} of the leaf's largest update (tol {LEAF_RTOL})")


def kernel_row(name, source, replaces, launches, max_err, r):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi = phase_device()
    phase_build()
    rows, max_err = phase_kernels()
    bwd_rows, bwd_err = phase_flash_bwd()
    lace_rows, lace_err = phase_lace()
    serve_launches = phase_serve()
    phase_check()
    zero_counts()
    train = phase_train()
    phase_train_check()
    csrc = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        # forward launches: the serve path's plus the training path's
        kernel_row("flash_attn_fwd", csrc + "flash_attn.cu",
                   "src/repro/kernels/flash_attn/kernel.py:23",
                   serve_launches + train["flash_fwd"], max_err,
                   rows[REPORT_CASE]),
        # the backward of K3 (the JAX package trains through autodiff)
        kernel_row("flash_attn_bwd", csrc + "flash_attn_bwd.cu",
                   "src/repro/kernels/flash_attn/kernel.py:23",
                   train["flash_bwd"], bwd_err, bwd_rows[FLASH_BWD_REPORT]),
        kernel_row("lace2_fwd", csrc + "lace.cu",
                   "src/repro/kernels/lace/kernel.py:219", train["lace_fwd"],
                   lace_err["fwd"], lace_rows[(LACE_REPORT, "fwd")]),
        kernel_row("lace2_bwd", csrc + "lace.cu",
                   "src/repro/kernels/lace/kernel.py:261", train["lace_bwd"],
                   lace_err["bwd"], lace_rows[(LACE_REPORT, "bwd")])]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
