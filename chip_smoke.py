#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build: every kernel source in ``src/repro_torch/kernels/csrc``
   (flash_attn, flash_attn_bwd, lace, lace1, mlstm; the headers
   flash_common.cuh and lace_common.cuh), one nvcc each, all at once,
   for sm_90a; each kernel's registers and spills by name; the LACE
   and K6 kernels' tensor-core TF32 and FFMA instruction counts from
   ``cuobjdump -sass`` (each product body must hold TF32 products);
3. kernels: each kernel against its plain PyTorch version at the shapes
   its path gives it, with the stated tolerance; then its time (CUDA
   events), the plain version's, PyTorch's own call's (``library_ms``, a
   yardstick only), for K3 also the card's time alone (``device_ms``:
   the calls queued behind a sleep kernel, no host time), and the card's
   bound for the work -- the attention forward (K3) at the serving
   shapes and the training trunk's, then the attention backward (two
   runs bitwise equal), the fused LACE boundary (K1, K2) and the
   single-prior LACE kernels of the dual boundary (K4, K5; server side
   with dW, client side without) at the training shapes (each with its
   bound, the split-TF32 route's cost and the f32 CUDA cores' beside it,
   and a bitwise repeat at the main path's case), and the chunkwise
   mLSTM (K6) at the served xlstm-1.3b's prefill shapes, every prompt
   length of the serving mix, q, k, v in float32 and in bfloat16 (h and
   the final C, n, m against the plain version, a bitwise repeat, the
   bound at the tensor cores' rate, the split products' and the q/k
   re-reads' rates, and a profile of its four kernels);
4. serve: full-width qwen1.5-0.5b in bf16 through ServeSpec ->
   build_serve -> ServeEngine.serve, dense and paged cache; paged tokens
   must equal dense tokens, and every admitted request must have
   launched the attention kernel once per layer;
5. check: full width in float32, TF32 off -- the fused prefill's logits
   and decode cache (through the kernel) against the token-by-token
   decode loop's (no kernel), and the engine's greedy tokens against the
   loop's;
5b. serve-xlstm: phase 4 for full-width xlstm-1.3b (42 mLSTM, 6 sLSTM
   layers) in bf16: K6 launched once per mLSTM layer and admit, none of
   K3; an admit split by mixer (host time, K6's device time) and a
   decode step with every slot busy, profiled;
5c. check-xlstm: phase 5 for xlstm-1.3b at full width and 8 layers (one
   period of its pattern) on an odd prompt of 77 tokens: logits and
   every layer's final state (mLSTM C, n, m through K6 against the
   per-step recurrence);
6. train: full-width qwen1.5-0.5b through the training CLI's spec and
   Trainer on the card -- 16 clients, 4 sampled per round, 2 local steps
   of 16 x 512 tokens, 3 rounds; finite losses, the kernels' launch
   counts per round against the layout's formula, round seconds, tokens/s,
   peak memory and a profiled round's device-busy share;
7. train-check: full width in float32, TF32 off -- one split step and
   one round on the card (K1, K2, K3 forward and backward) against the
   same on the CPU (the plain versions);
8. train-dual: the training cell of phase 6 with ``--boundary dual`` --
   the launches per round (K4 and K5 twice a step, K1 and K2 never), the
   same numbers as phase 6 and a profiled round;
9. dual-check: full width in float32, TF32 off -- one split step with
   the dual boundary on the card (K4, K5) against the fused one on the
   card (K1, K2), then against the dual one on the CPU;
10. alexnet: the paper's model at full width (s2, 10 classes) through
   ``ExperimentSpec`` -> ``Trainer`` with the paper-table settings, 3
   rounds on each boundary (finite losses, round seconds, ``evaluate()``'s
   accuracy and class-balanced accuracy), then one split step per
   boundary on the card in float32 with cuDNN off, held against the same
   step in float64 on the CPU (cuDNN's and the CPU's own float32 steps
   are reported beside it);
11. baselines: the same AlexNet and settings, one round of every method
   but scala (the FL / SFL baselines and scala_noadj) from one seeded
   state, held against the round on the CPU in float64 (every leaf's
   update within 1e-3 of its largest entry): over one local step the
   card's float32 round with cuDNN off, over the tables' five the card's
   float64 round (float32 reported beside it); then the paper tables T1,
   T5 and T8 (quick) through the port's table runner at width 1.0 -- the
   reference's CSV rows, each experiment's round seconds and peak device
   memory, and whether its final state is finite (a diverged baseline
   row is marked; a diverged SCALA row fails);
12. resume: ``Trainer.save`` -> a fresh Trainer -> ``resume`` against an
   uninterrupted run whose state is finite, bitwise in every leaf and in
   the history: AlexNet (scala, feddyn, splitfed_v1, sfl_localloss at
   its own rate; cuDNN deterministic in this phase), then phase 6's
   full-width qwen1.5-0.5b training (K1, K2, K3 forward and backward);
   the ``.npz`` size, save and restore seconds.

Then one JSON line of kernel numbers, the ``nvidia-smi`` line again, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
exits nonzero; without a GPU it exits nonzero before printing a result.

``python3 chip_smoke.py attention`` runs phases 1 and 2 and the
attention kernels of phase 3 (K3 forward and backward), then stops;
``python3 chip_smoke.py lace`` the same for the LACE kernels (K1, K2,
K4, K5); ``python3 chip_smoke.py mlstm`` the same for K6, then
check-xlstm (5c).
``python3 chip_smoke.py baselines`` runs phases 1, 2, 11 and 12.
``python3 chip_smoke.py xlstm-rounding`` runs phases 1 and 2, then only
the probe behind check-xlstm's depth: full-depth float32 xlstm-1.3b
through the prefill (K6, the plain version) and the decode loop (two
summation orders), the last position compared pairwise.
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
              torch.float32: 67e12,     # float32 outside the tensor cores
              "tf32": 495e12}           # dense tensor-core TF32
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
TRAIN_CASE = KERNEL_CASES[-1]                                # and beside it
XLSTM = "xlstm-1.3b"
# the chunkwise mLSTM (K6), (B, S, H, dk, dv, q/k/v dtype): the served
# xlstm-1.3b's prefill (4 heads of 1024, chunk 64) at every prompt of the
# serving mix (777 odd: a ragged last chunk) and an odd prompt below one
# chunk, in float32, then the mix in bfloat16 (as the served bf16 model
# passes q, k, v), held against the plain version on the same values in
# float32 (TF32 off): h and the final C, n, m within 1e-4 of each one's
# largest entry (sums over 1024 products in another order). Two runs of
# each case are bitwise equal.
SERVE_LENS, SERVE_REQS = (128, 333, 512, 777), 16
MLSTM_CASES = ([(1, S, 4, 1024, 1024, torch.float32)
                for S in SERVE_LENS + (37,)]
               + [(1, S, 4, 1024, 1024, torch.bfloat16) for S in SERVE_LENS])
MLSTM_REPORT = (1, 777, 4, 1024, 1024, torch.bfloat16)   # as served
MLSTM_CHUNK, MLSTM_RTOL = 64, 1e-4
# the prefill against its token-by-token decode, float32: every layer's
# final state within 1e-3 of its largest entry. xlstm-1.3b is checked at
# full width on one period of its 7:1 layer pattern (8 layers: 7 mLSTM, 1
# sLSTM): its 48 random layers amplify float32 rounding until two decode
# loops that differ only in the order of one product part by 1.6e-2 in
# the logits (``python3 chip_smoke.py xlstm-rounding``, PERF.md), so at
# full depth no check can tell the kernel from rounding
STATE_RTOL = 1e-3
XLSTM_CHECK_LAYERS = 8
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
# Tolerance against the plain version (f32 products, TF32 off; the
# kernels' split-TF32 products keep f32 accuracy): nll and lse within 1e-4
# of their largest entry, df and dW within 1e-5 of theirs; df of the first
# 256 tokens also within 1e-5 of the float64 value. At the main path's
# case two runs of K1, K2 (and of K4, K5 per side) are bitwise equal.
LACE_CASES = [(8192, torch.bfloat16, 1.0), (8192, torch.float32, 1.0),
              (2048, torch.bfloat16, 1.0), (2048, torch.float32, 0.0),
              (2047, torch.bfloat16, 1.0)]
LACE_REPORT = LACE_CASES[0]
LACE_CLIENTS = 4
# the single-prior LACE kernels (K4, K5) of the dual boundary, (N tokens,
# feats dtype, side) at the training width: the server side (one
# concatenated prior row, dW) and the client side (4 per-client rows
# picked per token, no dW), at the main path's 8192 tokens and at 2048.
# Tolerance against the plain version: nll and lse within 1e-4 of their
# largest entry, df and dW within 1e-5 of theirs.
LACE1_CASES = [(N, dt, side) for N in (8192, 2048)
               for dt in (torch.bfloat16, torch.float32)
               for side in ("server", "client")]
LACE1_REPORT = {"server": LACE1_CASES[0], "client": LACE1_CASES[1]}
# the training phase: the reference LM training CLI's defaults (SCALA, subset
# sampling, fused LACE boundary, weighted FedAvg, SGD) at full width
TRAIN_FLAGS = ["--arch", ARCH, "--clients", "16", "--participation", "0.25",
               "--local-iters", "2", "--seq", "512", "--server-batch", "16",
               "--docs-per-client", "8", "--rounds", "3", "--seed", "0"]
TRAIN_DUAL_FLAGS = TRAIN_FLAGS + ["--boundary", "dual"]
# the paper's AlexNet setup (benchmarks/common.py:experiment_spec): 20
# clients, 4 sampled per round, 5 local steps, 48 images a step, SGD at
# lr 0.05, 2000 training images, 2 classes per client, at full width
ALEXNET = dict(num_clients=20, participation=0.2, local_iters=5,
               server_batch=48, lr=0.05, n_train=2000, alpha=2, width=1.0)
# f32 full-width step and round, card against CPU: losses within 1e-4
# relative, every grad leaf within 1e-3 of its largest entry, every
# aggregated client param within 3 ulps plus 1e-3 of its leaf's largest
# update (float32 sums in other orders through 24 layers)
LOSS_RTOL, LEAF_RTOL = 1e-4, 1e-3
# the dual boundary against the fused one, and against the CPU; AlexNet's
# card step against the CPU: losses within 1e-5 relative, every grad leaf
# within 1e-4 of its largest entry. AlexNet's conv weight gradients sum
# thousands of terms that nearly cancel: the float32 convolutions of cuDNN
# and of the CPU libraries each land up to ~2e-2 of the largest entry
# from the exact value, so its card step runs its convolutions without
# cuDNN (im2col and float32 products, as TF32 is off for the matmuls) and
# is held against the step in float64 on the CPU.
DUAL_LOSS_RTOL, DUAL_LEAF_RTOL = 1e-5, 1e-4


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


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of ``fn``, without the host's time to
    issue it (which ``time_ms`` includes when the host is the slower of
    the two): the calls are queued behind a sleep kernel that outlasts
    their issue, so the events time the card running them back to back.
    A sleep that the issue outlasted is tried again, four times longer."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = 4 * iters * (time.perf_counter() - t0) + 2e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda._sleep(int(sleep_s * 2e9))  # >= sleep_s: SM clock < 2 GHz
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if issue_s < sleep_s:
            return start.elapsed_time(end) / iters
        sleep_s *= 4
    raise RuntimeError(f"issuing {iters} calls took {issue_s:.4f} s, longer "
                       f"than a {sleep_s / 4:.4f} s sleep")


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


def kernel_label(mangled: str) -> str:
    """A readable name for a kernel symbol of the port's sources, e.g.
    ``flash_fwd_mma_kernel<64>`` for its Itanium-mangled name (the
    kernels live in a namespace of their file, anonymous or named, and
    take int and type template arguments only)."""
    s = mangled

    def name_at(i):
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        if j == i:
            raise ValueError(mangled)
        n = int(s[i:j])
        return s[j:j + n], j + n

    try:
        if not s.startswith("_ZN"):
            return s
        name, i = name_at(3)
        while s[i].isdigit():                # nested names: keep the last
            name, i = name_at(i)
        if s[i] != "I":
            return name
        i += 1
        args, named = [], "?"
        while s[i] != "E":
            if s[i] == "L":                  # a literal: L<type><value>E
                end = s.index("E", i)
                args.append(s[i + 2:end])
                i = end + 1
            elif s[i].isdigit():             # a named type
                arg, i = name_at(i)
                args.append(arg.replace("__nv_bfloat16", "bf16"))
                named = args[-1]
            elif s[i] == "S":                # a repeat: the last named type
                i = s.index("_", i) + 1
                args.append(named)
            else:                            # a builtin type
                args.append({"f": "float", "i": "int"}.get(s[i], s[i]))
                i += 1
        return f"{name}<{','.join(args)}>"
    except (IndexError, ValueError):
        return mangled


def phase_build():
    """Builds every source; prints each kernel's registers and spills
    from ``ptxas -v``, by kernel name."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(["flash_attn", "flash_attn_bwd", "lace", "lace1",
                        "mlstm"])
    for name, log in logs.items():
        kern, spill = None, ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kern = kernel_label(line.split("'")[1])
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                regs = line.split("Used", 1)[1].split(",")[0].strip()
                say("build", f"{name}: {kern}: {regs}; {spill}")
            elif "built in" in line:
                say("build", f"{name}: {line.strip()}")
    say("build", f"all kernels ready in {time.perf_counter() - t0:.1f} s")
    for name in ("lace", "lace1", "mlstm"):
        sass_mix(build.library_path(name), name)


# the kernels of split-TF32 sources whose bodies run tensor-core products
PRODUCT_BODIES = ("lace_fwd_kernel", "lace_grad_kernel", "lace_gemm_kernel",
                  "mlstm_scores_kernel", "mlstm_state_kernel")


def sass_mix(path, name):
    """The LACE and K6 kernels' instruction mix from ``cuobjdump -sass``:
    each product body (PRODUCT_BODIES) must hold tensor-core TF32 products
    (HMMA ... TF32); FFMA counts the CUDA-core multiply-adds left (the
    epilogues' exponentials, K6's n and q.n0)."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", path], capture_output=True, text=True,
                         check=True).stdout
    counts, kern = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            kern = kernel_label(line.split("Function : ", 1)[1].strip())
            counts[kern] = [0, 0]
        elif kern is not None:
            counts[kern][0] += "HMMA" in line and "TF32" in line
            counts[kern][1] += " FFMA" in line
    for kern, (hmma, ffma) in sorted(counts.items()):
        say("build", f"{name}: {kern}: {hmma} HMMA.TF32, {ffma} FFMA")
        if kern.split("<")[0] in PRODUCT_BODIES:
            check(hmma > 0, f"{name}: {kern} has no TF32 tensor-core product")


def phase_kernels():
    from repro_torch.kernels.flash_attn import kernel, ref
    import torch.nn.functional as F

    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    # the launchers' own cost: a call that gives the card next to no work
    tiny = [torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16, device="cuda")
            for _ in range(3)]
    host_ms = time_ms(lambda: kernel.flash_attention_cuda(*tiny), iters=200,
                      warmup=10)
    lib_host_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in tiny), is_causal=True), iters=200,
        warmup=10)
    say("kernels", f"flash_attn_fwd at 1 token, 1 head: {host_ms:.4f} ms a "
        f"call (sdpa {lib_host_ms:.4f} ms): below this the host, not the "
        "card, sets a call's time")
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
        dev_ms, lib_dev_ms = device_ms(run_kernel), device_ms(run_library)
        bound_ms, bound_by = attention_bound(B, P, H, KV, hd, window, dtype)
        rows[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          device_ms=dev_ms, library_device_ms=lib_dev_ms)
        say("kernels", f"flash_attn_fwd B={B} P={P} H={H} KV={KV} hd={hd} "
            f"window={window} {str(dtype)[6:]}: max_abs_err={err:.3g} "
            f"(tol {TOL[dtype]}; sdpa vs plain {lib_err:.3g}) "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"sdpa={lib_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}); "
            f"device: kernel={dev_ms:.4f} ms sdpa={lib_dev_ms:.4f} ms")
    return rows, max_err


def serve_run(spec, reqs, warm_len: int):
    """Build ``spec``, warm up, serve ``reqs`` with every launch count set
    to 0 just before. Returns (engine, results, seconds, the launches of
    the run, peak bytes, cache bytes)."""
    from repro_torch.api import build_serve

    program = build_serve(spec)
    engine = program.engine
    engine.warmup([warm_len])
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    results = engine.serve(list(reqs))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return engine, results, dt, launches, peak, engine.state_bytes()


def profile(what: str, fn, top: int, watch=()) -> None:
    """Run ``fn`` once more under torch.profiler: the wall time, the
    device's busy time (the sum of kernel times), the ``top`` kernels
    that take the most of it and, for each (label, name part) in
    ``watch``, the share of the kernels whose name holds that part.
    Profiling slows the host, so only the device numbers are read from
    this run."""
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
    for label, parts in watch:
        parts = (parts,) if isinstance(parts, str) else parts
        hits = [e for e in kernels if any(p in e.key for p in parts)]
        t = sum(e.self_device_time_total for e in hits) / 1e6
        say("profile", f"  {label}: {t:.4f} s ({100 * t / busy:.1f}% of "
            f"busy) x{sum(e.count for e in hits)}, kernels named "
            f"{' or '.join(f'*{p}*' for p in parts)}")


def serve_launches(cfg, n_admits):
    """Kernel launches a serving run makes: every admit's fused prefill
    runs K3 once per attention layer and K6 once per mLSTM layer; decode
    runs neither."""
    n = {m: sum(s.mixer == m for s in cfg.block_specs)
         for m in ("attn", "mlstm")}
    return dict(flash_fwd=n_admits * n["attn"], flash_bwd=0, lace_fwd=0,
                lace_bwd=0, lace1_fwd=0, lace1_bwd=0,
                mlstm=n_admits * n["mlstm"])


def phase_serve(device="cuda", reduced=False, arch=ARCH, phase="serve",
                n_req=SERVE_REQS, lens=SERVE_LENS, gen=32, slots=8,
                max_len=1024, page_size=16):
    """Serve the request mix through ``ServeSpec`` -> ``build_serve`` ->
    ``ServeEngine.serve``, dense and then paged; returns the launch
    counts of the two runs together."""
    from repro_torch.api import ServeSpec
    from repro_torch.serve import Request

    spec = ServeSpec(arch=arch, reduced=reduced, slots=slots, max_len=max_len,
                     seed=0, device=device)
    cfg = spec.model_config()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(P)), gen)
            for i, P in enumerate(rng.choice(lens, n_req))]
    want = serve_launches(cfg, len(reqs))
    pages = slots * -(-max_len // page_size)
    launches, tokens = {}, None
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
        if engine.device.type == "cuda":
            check(n == want, f"kernel launches {n} != {want} for "
                  f"{len(reqs)} admits")
        launches = {k: launches.get(k, 0) + n[k] for k in n}
        got = {r.rid: results[r.rid].tokens for r in reqs}
        if tokens is None:
            tokens = got
        else:
            check(all(np.array_equal(tokens[i], got[i]) for i in tokens),
                  "paged tokens == dense tokens")
        lats = [results[r.rid].latency for r in reqs]
        say(phase, f"{cfg.name} {cfg.dtype} {'paged' if paged else 'dense'} "
            f"cache: {len(reqs)} reqs (prompts {sorted(set(len(r.tokens) for r in reqs))}) "
            f"x {gen} tok on {slots} slots in {dt:.3f} s: "
            f"{len(reqs) * gen / dt:.1f} tok/s, latency p50={np.percentile(lats, 50):.3f} s "
            f"p99={np.percentile(lats, 99):.3f} s, peak {peak / 2**20:.0f} MiB "
            f"allocated, cache {cache / 1e6:.1f} MB"
            + (f" ({engine.ops.pages_needed(max_len)} pages a request)"
               if paged else "")
            + f", launches K3 {n['flash_fwd']} K6 {n['mlstm']}")
        if not paged and engine.device.type == "cuda":
            if want["mlstm"]:
                xlstm_split(engine, phase, max(lens), gen)
            else:
                profile("dense run", lambda: engine.serve(list(reqs)), 6)
        del engine
    say(phase, "paged tokens == dense tokens; launches == admits x "
        f"({want['flash_fwd'] // len(reqs)} attention, "
        f"{want['mlstm'] // len(reqs)} mLSTM) layers")
    return launches


def xlstm_split(engine, phase, P, gen):
    """Where an xLSTM admit and decode step spend their time: one admit of
    a ``P``-token prompt into the idle engine with every mixer call timed
    on the host (synchronized before and after), K6's device time from
    CUDA events around each launch; then a profiled admit, and decode
    steps with every slot busy, timed and profiled."""
    from repro_torch.kernels.mlstm import ops as mops
    from repro_torch.models.layers import xlstm
    from repro_torch.serve import Request

    spent = {"mlstm_prefill": 0.0, "slstm_prefill": 0.0, "k6": 0.0}
    orig = {name: getattr(xlstm, name) for name in ("mlstm_prefill",
                                                    "slstm_prefill")}
    orig_k6 = mops.mlstm_chunkwise

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    def k6_events(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_k6(*args, **kw)
        end.record()
        end.synchronize()
        spent["k6"] += start.elapsed_time(end) / 1e3
        return out

    rng = np.random.default_rng(7)
    reqs = [Request(-100 - i, rng.integers(0, engine.cfg.vocab_size, P), gen)
            for i in range(engine.slots)]
    for name, fn in orig.items():
        setattr(xlstm, name, timed(name, fn))
    mops.mlstm_chunkwise = k6_events
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(engine.admit(reqs[0]), "a free slot for the split admit")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in orig.items():
            setattr(xlstm, name, fn)
        mops.mlstm_chunkwise = orig_k6
    cfg = engine.cfg
    n = {m: sum(s.mixer == m for s in cfg.block_specs)
         for m in ("mlstm", "slstm")}
    rest = wall - spent["mlstm_prefill"] - spent["slstm_prefill"]
    say(phase, f"admit of a {P}-token prompt: {wall:.3f} s host; "
        f"{n['slstm']} sLSTM layers {spent['slstm_prefill']:.3f} s "
        f"({100 * spent['slstm_prefill'] / wall:.1f}%, the per-step loop), "
        f"{n['mlstm']} mLSTM layers {spent['mlstm_prefill']:.3f} s "
        f"({100 * spent['mlstm_prefill'] / wall:.1f}%) of which K6 "
        f"{spent['k6']:.4f} s on the device ({n['mlstm']} launches, "
        f"{1e3 * spent['k6'] / n['mlstm']:.3f} ms each), the rest "
        f"(embedding, head, cache copy) {rest:.3f} s")
    profile(f"admit of a {P}-token prompt", lambda: engine.admit(reqs[1]), 6)
    for r in reqs[2:]:
        check(engine.admit(r), "a free slot for the decode profile")
    check(engine.n_active == engine.slots, "every slot busy")
    steps = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    say(phase, f"decode step with {engine.slots} busy slots: "
        f"{[round(x, 4) for x in steps]} s host; recurrent state "
        f"{engine.state_bytes() / 1e9:.2f} GB read and written each step")
    profile(f"decode step, {engine.slots} slots", engine.step, 6)


def phase_check(device="cuda", reduced=False, arch=ARCH, phase="check",
                prompt_len=64, max_len=128, layers=None):
    """float32, TF32 off: the fused prefill (through the kernels) against
    the token-by-token decode loop (no kernel) -- the last position's
    logits within LOGIT_ATOL, and every layer's decode cache within
    STATE_RTOL of its largest entry -- then the engine's greedy tokens
    against the loop's. ``layers`` cuts the depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32",
                              num_layers=layers or cfg.num_layers)
    gen = torch.Generator(device)
    gen.manual_seed(1)
    params = T.init_params(gen, cfg)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)),
                             device=device)
    with torch.no_grad():
        logits, cache = T.forward_prefill_cached(
            params, {"tokens": prompt}, cfg, max_len)
        loop = T.init_decode_cache(cfg, 1, max_len, device=device)
        for i in range(prompt_len):
            last, loop = T.decode_step(params, {"tokens": prompt[:, i:i + 1]},
                                       loop, i, cfg)
    err = (logits[0, 0] - last[0, 0]).abs().max().item()
    scale = last.abs().max().item()
    check(err <= LOGIT_ATOL, f"prefill vs loop logits {err} > {LOGIT_ATOL}")
    worst = {}
    for layer, leaves in loop.items():
        for key, want in leaves.items():
            e = rel_err(cache[layer][key], want)
            check(e <= STATE_RTOL, f"prefill vs loop {layer}/{key}: {e} > "
                  f"{STATE_RTOL} of its largest entry")
            worst[key] = max(worst.get(key, 0.0), e)
    say(phase, f"{cfg.name} float32, {cfg.num_layers} layers, a "
        f"{prompt_len}-token prompt: prefill "
        f"logits (kernels) vs token-by-token loop: max_abs_err={err:.3g} "
        f"(atol {LOGIT_ATOL}, max |logit| {scale:.3g}); cache leaves, worst "
        f"error over the largest entry (tol {STATE_RTOL}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))

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
    say(phase, f"engine greedy tokens == loop tokens for {len(reqs)} requests")


def phase_xlstm_rounding(device="cuda", reduced=False, prompt_len=77,
                         layers=None):
    """Why check-xlstm runs 8 layers: float32 xlstm-1.3b at full width and
    depth (random weights, TF32 off), the last prompt position through
    the fused prefill (K6, then the plain chunkwise version) and through
    the token-by-token loop (``mlstm_step`` as the port sums it, then in
    the reference's order): logits and every layer's output, each pair's
    largest difference. Run alone: ``python3 chip_smoke.py
    xlstm-rounding``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm import ops as mops
    from repro_torch.kernels.mlstm import ref as mref
    from repro_torch.models import blocks as B
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import xlstm

    cfg = get_config(XLSTM)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32",
                              num_layers=layers or cfg.num_layers)
    gen = torch.Generator(device)
    gen.manual_seed(1)
    params = T.init_params(gen, cfg)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, prompt_len)), device=device)
    outs = []

    def recorded(fn):
        def run(*args, **kw):
            y, cache = fn(*args, **kw)
            outs.append(y[:, -1].clone())
            return y, cache
        return run

    def prefill():
        outs.clear()
        logits, _ = T.forward_prefill_cached(params, {"tokens": prompt}, cfg,
                                             prompt_len)
        return logits[0, 0], list(outs)

    def loop():
        cache = T.init_decode_cache(cfg, 1, prompt_len, device=device)
        for i in range(prompt_len):
            outs.clear()
            logits, cache = T.decode_step(
                params, {"tokens": prompt[:, i:i + 1]}, cache, i, cfg)
        return logits[0, 0], list(outs)

    def step_reference_order(q, k, v, i_raw, f_log, state):
        """``xlstm.py:mlstm_step`` of the reference, op for op."""
        C0, n0, m0 = state
        m_t = torch.maximum(f_log + m0, i_raw)
        wf, wi = torch.exp(f_log + m0 - m_t), torch.exp(i_raw - m_t)
        C = C0 * wf[..., None, None] + wi[..., None, None] * (
            k[..., :, None] * v[..., None, :])
        n = n0 * wf[..., None] + wi[..., None] * k
        num = torch.einsum("bhd,bhde->bhe", q, C)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                            torch.exp(-m_t))
        return num / den[..., None], (C, n, m_t)

    patches = [(B, "block_prefill", recorded(B.block_prefill)),
               (B, "block_decode", recorded(B.block_decode))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    saved_k6, saved_step = mops.mlstm_chunkwise, xlstm.mlstm_step
    runs = {}
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        with torch.no_grad():
            runs["prefill (K6)"] = prefill()
            runs["loop"] = loop()
            mops.mlstm_chunkwise = mref.mlstm_chunk_plain
            runs["prefill (plain)"] = prefill()
            xlstm.mlstm_step = step_reference_order
            runs["loop (reference order)"] = loop()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        mops.mlstm_chunkwise = saved_k6
        xlstm.mlstm_step = saved_step
    at = sorted({0, 7} | set(range(15, cfg.num_layers, 8))
                | {cfg.num_layers - 1})
    for a, b in (("prefill (K6)", "loop"), ("prefill (plain)", "loop"),
                 ("prefill (K6)", "prefill (plain)"),
                 ("loop (reference order)", "loop")):
        (la, xa), (lb, xb) = runs[a], runs[b]
        err = (la - lb).abs().max().item()
        layer_errs = ", ".join(f"{l + 1}: {rel_err(xa[l], xb[l]):.2g}"
                               for l in at)
        say("xlstm-rounding", f"{cfg.name} float32, {cfg.num_layers} layers, "
            f"a {prompt_len}-token prompt, {a} vs {b}: logits max_abs "
            f"{err:.3g} (max |logit| {lb.abs().max().item():.3g}); output "
            f"after layer (over its largest entry) {layer_errs}")


def mlstm_bound(B, S, H, dk, dv, dtype, chunk=MLSTM_CHUNK):
    """(ms, 'operations' | 'bytes', f32 ms): the least time for the
    chunkwise mLSTM over these inputs, from the zero state (as the served
    prefill starts; no state is read). Its operations -- per chunk of L
    tokens and head, the state update of C and n (2 L dk dv + 2 L dk
    flops), q C0 and q.n0 (as many again, but not in the first chunk,
    whose state is zero), the causal pairs' q.k and score-times-v (L (L +
    1) (dk + dv)) -- once at TF32's tensor-core rate (the fastest that
    takes an f32 operand: the state is f32), or one read of q, k, v (in
    ``dtype``) and the gates and one write of h and the final state, the
    larger. The third, for the text only, is the operations at the f32
    CUDA cores' rate."""
    flops = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        flops += ((2 if t0 == 0 else 4) * L * (dk * dv + dk)
                  + L * (L + 1) * (dk + dv))
    flops *= B * H
    el = torch.empty((), dtype=dtype).element_size()
    nbytes = (el * B * S * H * (2 * dk + dv)
              + 4 * (B * S * H * (dv + 2) + B * H * (dk * dv + dk + 1)))
    t_ops = flops / PEAK_FLOPS["tf32"]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            flops / PEAK_FLOPS[torch.float32] * 1e3)


def mlstm_route(B, S, H, dk, dv, dtype, chunk=MLSTM_CHUNK):
    """(split-TF32 flops, bytes of q and k the state blocks read): what K6
    runs (csrc/mlstm.cu) from the zero state -- q k^T of every 64-row
    chunk tile (3 products with f32 q, k; 1 with bf16), the state update
    (3; 2 with bf16 q, k), q C0 (as many, from the second chunk on) and
    scores . v (3; 2 with bf16 v), each on the whole tile -- and the k
    chunks, and the q chunks from the second on, that each of a head's
    dv / 32 blocks reads (from L2: 16 MB in f32 at 777 tokens, the read
    once)."""
    f32 = dtype == torch.float32
    nc = -(-S // chunk)
    tiles = 2 * 64 * 64 * (dk * (3 if f32 else 1) + dv * (3 if f32 else 2))
    state = 2 * 64 * dk * dv * (3 if f32 else 2)
    el = torch.empty((), dtype=dtype).element_size()
    return (B * H * (nc * (tiles + state) + (nc - 1) * state),
            B * H * (dv // 32) * (2 * nc - 1) * 64 * dk * el)


def serve_mix():
    """{prompt length: requests} of the serving phases' mix (phase_serve's
    first draw from its generator)."""
    lens = np.random.default_rng(0).choice(SERVE_LENS, SERVE_REQS)
    return {int(P): int((lens == P).sum()) for P in SERVE_LENS}


def phase_mlstm():
    """K6 against its plain version at the served model's prefill shapes,
    q, k, v in f32 and in bf16 (the plain version on their f32 copies): h
    and the final (C, n, m), then a bitwise repeat; the kernel's time
    (events, and the card's alone), the plain version's and the bound's;
    then launches x (time - bound) over the serving mix, and a profile of
    the four kernels at 777 tokens. No PyTorch call computes this
    function."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm import kernel, ref

    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    rows, max_err, calls = {}, 0.0, {}
    for case in MLSTM_CASES:
        B, S, H, dk, dv, dtype = case

        def n(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        # q scaled as the model scales it; forget gates near 1
        q, k, v = (x.to(dtype) for x in (n(B, S, H, dk, scale=dk ** -0.5),
                                         n(B, S, H, dk), n(B, S, H, dv)))
        i_raw, f_log = n(B, S, H), F.logsigmoid(n(B, S, H) + 2.0)
        q32, k32, v32 = q.float(), k.float(), v.float()

        def run_kernel(q=q, k=k, v=v, i_raw=i_raw, f_log=f_log):
            return kernel.mlstm_chunk_cuda(q, k, v, i_raw, f_log,
                                           chunk=MLSTM_CHUNK)

        def run_plain():
            return ref.mlstm_chunk_plain(q32, k32, v32, i_raw, f_log,
                                         chunk=MLSTM_CHUNK)

        h, state = run_kernel()
        torch.cuda.synchronize()
        want_h, want = run_plain()
        errs = {"h": rel_err(h, want_h)}
        errs.update((name, rel_err(a, b))
                    for name, a, b in zip("Cnm", state, want))
        err = (h - want_h).abs().max().item()
        max_err = max(max_err, err)
        check(h.dtype == torch.float32 and all(e <= MLSTM_RTOL
                                               for e in errs.values()),
              f"mlstm kernel vs plain {case}: {errs} > {MLSTM_RTOL}")
        h2, state2 = run_kernel()
        torch.cuda.synchronize()
        check(torch.equal(h, h2) and all(torch.equal(a, b) for a, b in
                                         zip(state, state2)),
              f"K6 repeat bitwise {case}: h, C, n, m")
        ms, plain_ms = time_ms(run_kernel), time_ms(run_plain)
        dev_ms = device_ms(run_kernel)
        bound_ms, bound_by, f32_ms = mlstm_bound(B, S, H, dk, dv, dtype)
        route, l2 = mlstm_route(B, S, H, dk, dv, dtype)
        rows[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by,
                          device_ms=dev_ms)
        calls[case] = run_kernel
        say("kernels", f"mlstm_chunk B={B} S={S} H={H} dk={dk} dv={dv} "
            f"L={MLSTM_CHUNK} q/k/v {str(dtype)[6:]}: max_abs_err(h)="
            f"{err:.3g}, over the largest entry "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + f" (tol {MLSTM_RTOL}); repeat bitwise; kernel={ms:.4f} ms "
            f"device={dev_ms:.4f} ms plain={plain_ms:.4f} ms "
            f"bound={bound_ms:.4f} ms ({bound_by}; f32 CUDA cores "
            f"{f32_ms:.4f}); route {route / 1e9:.2f} GFLOP of split "
            f"products, {route / dev_ms / 1e9:.1f} TFLOP/s; q/k read by "
            f"the state blocks {l2 / 1e6:.0f} MB, "
            f"{l2 / dev_ms / 1e9:.2f} TB/s")
    # launches x (time - bound) over the serving mix: every admit runs K6
    # once per mLSTM layer, in the dense and the paged run
    layers = sum(s.mixer == "mlstm" for s in get_config(XLSTM).block_specs)
    mix = serve_mix()
    for dtype in (torch.bfloat16, torch.float32):
        parts = {P: 2 * c * layers * (rows[(1, P, 4, 1024, 1024, dtype)]["ms"]
                                      - rows[(1, P, 4, 1024, 1024, dtype)]
                                      ["bound_ms"])
                 for P, c in mix.items()}
        say("kernels", f"K6 over the serving mix, q/k/v {str(dtype)[6:]} "
            f"(prompts {mix}, {layers} launches an admit, dense + paged: "
            f"{2 * layers * sum(mix.values())} launches): launches x (ms - "
            f"bound) = {sum(parts.values()):.1f} ms ("
            + ", ".join(f"{P}: {x:.1f}" for P, x in parts.items()) + ")")
    for case in (MLSTM_REPORT, (1, 777, 4, 1024, 1024, torch.float32)):
        profile(f"K6 at {case[1]} tokens, q/k/v {str(case[5])[6:]}",
                calls[case], 5)
    return rows, max_err


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
        again = run_kernel()
        sync("cuda")
        # one summation order, no atomics: a second run is bitwise equal
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash bwd {case}: two runs differ")
        exp = run_plain()
        tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
        errs = [rel_err(a, b) for a, b in zip(got, exp)]
        max_err = max(max_err, max((a.float() - b.float()).abs().max().item()
                                   for a, b in zip(got, exp)))
        check(max(errs) <= tol,
              f"flash bwd vs autograd of plain {case}: {errs} > {tol}")
        ms, plain_ms, lib_ms = (time_ms(f, iters=5, warmup=1) for f in
                                (run_kernel, run_plain, run_library))
        dev_ms, lib_dev_ms = device_ms(run_kernel), device_ms(run_library)
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
                          else "bytes", device_ms=dev_ms,
                          library_device_ms=lib_dev_ms)
        say("kernels", f"flash_attn_bwd B={B} P={P} H={H} KV={KV} hd={hd} "
            f"window={window} {str(dtype)[6:]}: rel err dq/dk/dv "
            f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (tol {tol}; two "
            f"runs bitwise equal) kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"sdpa_bwd={lib_ms:.4f} ms bound={rows[case]['bound_ms']:.4f} "
            f"ms ({rows[case]['bound_by']}); device: kernel={dev_ms:.4f} ms "
            f"sdpa_bwd={lib_dev_ms:.4f} ms")
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


def lace_passes(feats_dtype, w_dtype):
    """The operand dtypes (a, b) of the LACE passes z = feats W, df =
    g W^T and dW = feats^T g (g is f32)."""
    return ((feats_dtype, w_dtype), (torch.float32, w_dtype),
            (feats_dtype, torch.float32))


def split_products(a, b):
    """Split-TF32 products the LACE kernels run for one a x b pass
    (csrc/lace_common.cuh): a bf16 operand is one TF32 term, an f32 one
    hi + lo; bf16 x bf16 takes 1, bf16 x f32 2, f32 x f32 3 (lo x lo
    dropped)."""
    return 1 + (a == torch.float32) + (b == torch.float32)


def tc_rate(a, b):
    """The fastest tensor-core rate that takes both operands of a pass:
    bf16 x bf16 on the bf16 tensor cores, anything with an f32 operand on
    the TF32 ones."""
    both_bf16 = a == b == torch.bfloat16
    return PEAK_FLOPS[torch.bfloat16 if both_bf16 else "tf32"]


def lace_bounds(N, d, V, passes, nbytes):
    """The bound of a LACE kernel whose function is ``passes``, one
    (a dtype, b dtype) pair per 2 N d V product (z = feats W, df = g W^T
    per side, dW = feats^T g; g is f32): ``bound_ms``, each pass once at
    the fastest tensor-core rate for its operands, or the bytes at HBM's
    rate, the larger. For the text only (not bounds of the function):
    ``route_ms``, the split-TF32 products the kernels run at TF32's rate,
    and ``f32_ms``, the passes at the CUDA cores' f32 rate."""
    flops = 2 * N * d * V
    t_ops = sum(flops / tc_rate(a, b) for a, b in passes)
    t_bytes = nbytes / PEAK_BYTES
    products = sum(split_products(a, b) for a, b in passes)
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                route_products=products,
                route_ms=products * flops / PEAK_FLOPS["tf32"] * 1e3,
                f32_ms=len(passes) * flops / PEAK_FLOPS[torch.float32] * 1e3)


def bounds_text(r):
    return (f"bound {r['bound_ms']:.2f} ({r['bound_by']}); route "
            f"{r['route_products']} split-TF32 products {r['route_ms']:.2f}; "
            f"f32 CUDA cores {r['f32_ms']:.2f}")


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
        z, df, dw = lace_passes(feats.dtype, w.dtype)
        for kind, passes, nbytes in (
                ("fwd", [z], in_bytes + 4 * 4 * N),
                ("bwd", [z, df, df, dw],
                 in_bytes + 4 * 4 * N + 4 * (2 * N * d + d * V))):
            rows[(case, kind)] = dict(
                ms=times[kind], plain_ms=times[kind + "_plain"],
                library_ms=times["library"],
                **lace_bounds(N, d, V, passes, nbytes))
        say("kernels", f"lace2 N={N} d={d} V={V} feats {str(dtype)[6:]} "
            f"tau={tau}: rel err nll_s/nll_k/lse_s/lse_k "
            f"{'/'.join(f'{e:.3g}' for e in e_fwds)} (tol 1e-4), df_s/df_k/dW_s "
            f"{'/'.join(f'{e:.3g}' for e in e_bwds)} (tol 1e-5); df_s/df_k "
            f"of 256 tokens vs float64: kernel "
            f"{'/'.join(f'{e:.3g}' for e in e_exact)}, plain "
            f"{'/'.join(f'{e:.3g}' for e in e_exact_plain)} (tol 1e-5); "
            f"K1 {times['fwd']:.2f} ms (plain "
            f"{times['fwd_plain']:.2f}, {bounds_text(rows[(case, 'fwd')])}); "
            f"K2 {times['bwd']:.2f} ms (plain {times['bwd_plain']:.2f}, "
            f"{bounds_text(rows[(case, 'bwd')])}); cuBLAS feats@W "
            f"{times['library']:.2f} ms")
        if case == LACE_REPORT:
            same = [torch.equal(a, b) for a, b in zip(
                got + gb, kernel.lace2_fwd_cuda(*args)
                + kernel.lace2_bwd_cuda(*bargs))]
            check(all(same), f"K1/K2 repeat bitwise {case}: nll_s, nll_k, "
                  f"lse_s, lse_k, df_s, df_k, dW_s equal {same}")
            say("kernels", f"K1, K2 repeat at N={N}: bitwise equal")
    return rows, errs


def boundary_launches(boundary):
    """The boundary's launches in one step: K1 + K2 once (fused), or K4 +
    K5 once per prior (dual: eq. 14, then eq. 15)."""
    fused = boundary == "fused"
    return dict(lace_fwd=int(fused), lace_bwd=int(fused),
                lace1_fwd=0 if fused else 2, lace1_bwd=0 if fused else 2)


def lace1_inputs(N, dtype, side, d=1024, V=151936, G=LACE_CLIENTS):
    """One side of the dual boundary at the training width, from a seeded
    generator: feats (N, d), w_head (d, V) f32, int32 labels, the side's
    prior table and per-token client ids (server: one concatenated row,
    no ids; client: G rows), and the per-token scale weight / sum."""
    args, weights, ts = lace_inputs(N, dtype, 1.0, d, V, G)
    feats, w, labels, adj_s, _, adj_k, ids_k = args
    adj, ids = (adj_s, None) if side == "server" else (adj_k, ids_k)
    return (feats, w, labels, adj, ids), weights, ts


def phase_lace1():
    """K4 and K5 against their plain versions (same arguments, logits in
    1024-token chunks summed in 1024-column slices); ``library_ms`` is
    the one cuBLAS product feats @ W, a yardstick only (no PyTorch call
    computes the adjusted loss or its gradients). K5 runs as each side
    of the dual boundary does: with dW on the server side, without on
    the client side."""
    from repro_torch.kernels.lace import kernel, ref

    rows, errs = {}, {"fwd": 0.0, "bwd": 0.0}
    for case in LACE1_CASES:
        N, dtype, side = case
        args, weights, ts = lace1_inputs(N, dtype, side)
        feats, w, _, adj, ids = args
        d, V = w.shape
        want_dw = side == "server"
        got = kernel.lace_fwd_cuda(*args)
        sync("cuda")
        exp = ref.lace_fwd_plain(*args)
        e_fwds = [rel_err(a, b) for a, b in zip(got, exp)]
        check(max(e_fwds) <= 1e-4, f"lace_fwd vs plain {case}: nll, lse "
              f"{e_fwds}")
        bargs = args + (got[1], ts, want_dw)
        gb = kernel.lace_bwd_cuda(*bargs)
        sync("cuda")
        eb = ref.lace_bwd_plain(*bargs)
        check((gb[1] is None) == (eb[1] is None) == (not want_dw),
              f"dW computed only on the server side {case}")
        pairs = [(a, b) for a, b in zip(gb, eb) if b is not None]
        e_bwds = [rel_err(a, b) for a, b in pairs]
        check(max(e_bwds) <= 1e-5, f"lace_bwd vs plain {case}: df, dW "
              f"{e_bwds}")
        check(bool((gb[0][weights == 0] == 0).all()),
              f"weight-0 rows get exactly zero df {case}")
        errs["fwd"] = max(errs["fwd"], max(
            (a - b).abs().max().item() for a, b in zip(got, exp)))
        errs["bwd"] = max(errs["bwd"], max(
            (a - b).abs().max().item() for a, b in pairs))
        f32 = feats.float()
        times = {name: time_ms(fn, iters=3, warmup=1) for name, fn in (
            ("fwd", lambda: kernel.lace_fwd_cuda(*args)),
            ("fwd_plain", lambda: ref.lace_fwd_plain(*args)),
            ("bwd", lambda: kernel.lace_bwd_cuda(*bargs)),
            ("bwd_plain", lambda: ref.lace_bwd_plain(*bargs)),
            ("library", lambda: f32 @ w))}
        el = feats.element_size()
        in_bytes = (el * N * d + 4 * d * V + 4 * N + 4 * adj.numel()
                    + (0 if ids is None else 4 * N))
        z, df, dw = lace_passes(feats.dtype, w.dtype)
        for kind, passes, nbytes in (
                ("fwd", [z], in_bytes + 2 * 4 * N),
                ("bwd", [z, df] + [dw] * want_dw,
                 in_bytes + 2 * 4 * N + 4 * N * d
                 + (4 * d * V if want_dw else 0))):
            rows[(case, kind)] = dict(
                ms=times[kind], plain_ms=times[kind + "_plain"],
                library_ms=times["library"],
                **lace_bounds(N, d, V, passes, nbytes))
        say("kernels", f"lace {side} side N={N} d={d} V={V} rows="
            f"{adj.shape[0]} feats {str(dtype)[6:]}: rel err nll/lse "
            f"{'/'.join(f'{e:.3g}' for e in e_fwds)} (tol 1e-4), df"
            f"{'/dW' if want_dw else ''} "
            f"{'/'.join(f'{e:.3g}' for e in e_bwds)} (tol 1e-5); K4 "
            f"{times['fwd']:.2f} ms (plain {times['fwd_plain']:.2f}, "
            f"{bounds_text(rows[(case, 'fwd')])}); K5 {times['bwd']:.2f} ms "
            f"(plain {times['bwd_plain']:.2f}, "
            f"{bounds_text(rows[(case, 'bwd')])}); cuBLAS feats@W "
            f"{times['library']:.2f} ms")
        if case in LACE1_REPORT.values():
            again = (kernel.lace_fwd_cuda(*args)
                     + kernel.lace_bwd_cuda(*bargs))
            same = [torch.equal(a, b) for a, b in zip(got + gb, again)
                    if b is not None]
            check(all(same), f"K4/K5 repeat bitwise {case}: nll, lse, df"
                  f"{', dW' if want_dw else ''} equal {same}")
            say("kernels", f"K4, K5 {side} side repeat at N={N}: bitwise "
                "equal")
    return rows, errs


def train_launches(spec, cfg):
    """Kernel launches one local step makes, from the layout: every
    client slot runs the client blocks once forward and pulls them back
    once; the server trunk (not rematerialized) runs once forward and is
    pulled back twice (the P_s cotangent for w_s, the P_k one for the
    activations); the boundary's launches (:func:`boundary_launches`)."""
    slots = spec.slots
    n_client = sum(cfg.block_spec(l).mixer == "attn"
                   for l in range(cfg.split_layer))
    n_server = sum(cfg.block_spec(l).mixer == "attn"
                   for l in range(cfg.split_layer, cfg.num_layers))
    return dict(flash_fwd=slots * n_client + n_server,
                flash_bwd=slots * n_client + 2 * n_server, mlstm=0,
                **boundary_launches(spec.execution.boundary))


def read_counts():
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.lace import ops as lops
    from repro_torch.kernels.mlstm import ops as mops
    return dict(flash_fwd=fops.LAUNCHES, flash_bwd=fops.LAUNCHES_BWD,
                lace_fwd=lops.LAUNCHES_FWD, lace_bwd=lops.LAUNCHES_BWD,
                lace1_fwd=lops.LAUNCHES_FWD1, lace1_bwd=lops.LAUNCHES_BWD1,
                mlstm=mops.LAUNCHES)


def zero_counts():
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.lace import ops as lops
    from repro_torch.kernels.mlstm import ops as mops
    fops.LAUNCHES = fops.LAUNCHES_BWD = 0
    lops.LAUNCHES_FWD = lops.LAUNCHES_BWD = 0
    lops.LAUNCHES_FWD1 = lops.LAUNCHES_BWD1 = 0
    mops.LAUNCHES = 0


def phase_train(device="cuda", flags=TRAIN_FLAGS, profile_round=True,
                phase="train"):
    """Full-width training through the CLI's spec and the Trainer: the
    kernels' launches per round against :func:`train_launches`, finite
    losses, round seconds (rounds 2 on; round 1 includes warm-up),
    tokens/s, peak memory, and a profiled extra round. Every launch count
    is set to 0 at the start; returns the counts of the measured rounds
    (the profiled round not included)."""
    from repro_torch import api
    from repro_torch.launch import train

    spec = train.spec_from_args(train.build_parser().parse_args(flags))
    spec.validate()
    cfg = spec.model_config()
    t0 = time.perf_counter()
    trainer = api.Trainer(spec, device=device)
    sync(device)
    say(phase, f"{cfg.name} {cfg.dtype} compute, {cfg.param_dtype} params: "
        f"{spec.scala.num_clients} clients, {spec.slots} per round, "
        f"{spec.scala.local_iters} local steps of "
        f"{spec.scala.server_batch} x {spec.data.seq} tokens, boundary "
        f"{spec.execution.boundary}; built in "
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
        say(phase, f"round {r} loss_s={m['loss_server']:.4f} "
            f"loss_c={m['loss_client']:.4f} in {secs[-1]:.3f} s; launches "
            f"K3 fwd {got['flash_fwd']} bwd {got['flash_bwd']}, K1 "
            f"{got['lace_fwd']}, K2 {got['lace_bwd']}, K4 "
            f"{got['lace1_fwd']}, K5 {got['lace1_bwd']}")
    counts = read_counts()
    steady = secs[1:] or secs
    round_s = float(np.mean(steady))
    tokens = T * spec.scala.server_batch * spec.data.seq
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    say(phase, f"round seconds (rounds 1..{len(secs) - 1}, round 0 has "
        f"the warm-up): {[round(x, 3) for x in steady]}, mean "
        f"{round_s:.3f} s -> {tokens / round_s:.0f} training tokens/s; "
        f"round 0 {secs[0]:.3f} s; peak {peak / 2**20:.0f} MiB allocated; "
        f"per step: {per_step}")
    if profile_round and torch.device(device).type == "cuda":
        profile(f"training round ({spec.execution.boundary} boundary)",
                trainer.step, 8, watch=[
                    ("LACE forward (K1/K4)", "lace_fwd"),
                    ("LACE backward (K2/K5)", ("lace_grad", "lace_gemm")),
                    ("K3 backward", "flash_bwd"),
                    ("K3 forward", "flash_fwd")])
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


def f32_qwen_step_inputs(device, reduced=False, C=2, S=64, seed=3):
    """float32 qwen1.5-0.5b (full width unless ``reduced``), its split
    model, stacked params made on ``device`` from a seed, and one step's
    numpy batch of C clients x S tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import transformer as Tm

    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    full = Tm.init_params(gen, cfg)
    params = {"client": stack_client_params(full["client"], C),
              "server": full["server"]}
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (C, 1, S + 1))
    weights = np.ones((C, 1, S), np.float32)
    weights[-1, 0, -S // 8:] = 0.0            # an eq. 3 padding tail
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "weights": weights}
    return cfg, transformer_split_model(cfg), params, batch


def step_on(model, params, batch, dev, scala, backend, boundary,
            cudnn=True):
    """One split step on ``dev`` from the same params and batch (in the
    params' dtype): (grads, metrics, seconds, launches). ``cudnn=False``
    runs the step's convolutions without cuDNN."""
    from repro_torch.core import engine
    from repro_torch.tree import tree_map

    p = tree_map(lambda a: a.to(dev), params)
    b = {k: torch.from_numpy(np.asarray(v)).to(dev)
         for k, v in batch.items()}
    zero_counts()
    t0 = time.perf_counter()
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        g, m = engine.split_step_grads(model, p, b, scala, backend=backend,
                                       boundary=boundary)
    finally:
        torch.backends.cudnn.enabled = prev
    sync(dev)
    return g, m, time.perf_counter() - t0, read_counts()


def compare_steps(phase, what, a, b, checked=True):
    """Losses within DUAL_LOSS_RTOL relative, every grad leaf within
    DUAL_LEAF_RTOL of its largest entry (``checked=False``: reported
    only); returns the worst leaf's relative error."""
    from repro_torch.tree import leaves

    (ga, ma), (gb, mb) = a[:2], b[:2]
    for k in ("loss_server", "loss_client"):
        x, y = float(ma[k]), float(mb[k])
        check(not checked or abs(x - y) <= DUAL_LOSS_RTOL * abs(y),
              f"{phase} {what}: {k} {x} vs {y}")
    la, lb = leaves(ga), leaves(gb)
    check(len(la) == len(lb), f"{phase} {what}: grad trees differ")
    worst = max(rel_err(x.cpu(), y.cpu()) for x, y in zip(la, lb))
    check(not checked or worst <= DUAL_LEAF_RTOL,
          f"{phase} {what}: worst grad leaf {worst} > {DUAL_LEAF_RTOL}")
    say(phase, f"{what}: loss_s {float(ma['loss_server']):.7f} vs "
        f"{float(mb['loss_server']):.7f}, loss_c "
        f"{float(ma['loss_client']):.7f} vs {float(mb['loss_client']):.7f}; "
        f"worst of {len(la)} grad leaves {worst:.3g} of its largest entry"
        + (f" (rtol {DUAL_LOSS_RTOL}, tol {DUAL_LEAF_RTOL})" if checked
           else " (reported, not checked)"))
    return worst


def phase_dual_check(device="cuda", reduced=False):
    """float32 at full width, TF32 off: one split step with the dual
    boundary on ``device`` (K4, K5) against the fused one on ``device``
    (K1, K2), then against the dual one on the CPU (the plain
    versions)."""
    from repro_torch.configs import ScalaConfig

    cfg, model, params, batch = f32_qwen_step_inputs(device, reduced)
    sc = ScalaConfig(num_clients=2)
    res = {}
    for dev, boundary in ((device, "dual"), (device, "fused"),
                          ("cpu", "dual")):
        res[(dev, boundary)] = r = step_on(model, params, batch, dev, sc,
                                           "lace", boundary)
        n = r[3]
        if torch.device(dev).type == "cuda":
            want = boundary_launches(boundary)
            got = {k: n[k] for k in want}
            check(got == want, f"dual-check {boundary} step launches {got} "
                  f"!= {want}")
        say("dual-check", f"{cfg.name} float32 split step, 2 clients x 64 "
            f"tokens, {boundary} boundary on {dev}: {r[2]:.2f} s, launches "
            f"K1 {n['lace_fwd']} K2 {n['lace_bwd']} K4 {n['lace1_fwd']} "
            f"K5 {n['lace1_bwd']}")
    compare_steps("dual-check", f"dual vs fused on {device}",
                  res[(device, "dual")], res[(device, "fused")])
    compare_steps("dual-check", f"dual on {device} vs dual on cpu",
                  res[(device, "dual")], res[("cpu", "dual")])


def alexnet_spec(boundary, rounds=3, width=ALEXNET["width"]):
    """The paper's AlexNet experiment (benchmarks/common.py's
    experiment_spec, SCALA in subset mode) as the port's ExperimentSpec."""
    from repro_torch import api
    from repro_torch.configs import ScalaConfig

    a = ALEXNET
    return api.ExperimentSpec(
        arch="alexnet-cifar", split="s2", width=width, method="scala",
        rounds=rounds, seed=0,
        scala=ScalaConfig(num_clients=a["num_clients"],
                          participation=a["participation"],
                          local_iters=a["local_iters"],
                          server_batch=a["server_batch"], lr=a["lr"]),
        fed=api.FedSpec(aggregator="weighted"),
        execution=api.ExecutionSpec(mode="subset", backend="logits",
                                    boundary=boundary, unroll=0),
        data=api.DataSpec(kind="image_synthetic", n_train=a["n_train"],
                          num_classes=10, alpha=a["alpha"])).validate()


def phase_alexnet(device="cuda", width=ALEXNET["width"], rounds=3):
    """The paper's path: AlexNet through ExperimentSpec -> Trainer on
    ``device``, ``rounds`` rounds on each boundary (finite losses, round
    seconds, evaluate()'s acc and balanced_acc); then one float32 split
    step on ``device`` against the CPU per boundary."""
    from repro_torch import api
    from repro_torch.configs import ScalaConfig
    from repro_torch.core.scala import alexnet_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import alexnet as A
    from repro_torch.tree import tree_map

    for boundary in ("fused", "dual"):
        spec = alexnet_spec(boundary, rounds, width)
        t0 = time.perf_counter()
        trainer = api.Trainer(spec, device=device)
        sync(device)
        built = time.perf_counter() - t0
        secs = []
        for r in range(rounds):
            t0 = time.perf_counter()
            m = trainer.step()
            sync(device)
            secs.append(time.perf_counter() - t0)
            check(all(np.isfinite(m[k]) for k in ("loss_server",
                                                  "loss_client")),
                  f"alexnet {boundary}: finite losses in round {r}: {m}")
            say("alexnet", f"{boundary} round {r} loss_s="
                f"{m['loss_server']:.4f} loss_c={m['loss_client']:.4f} "
                f"acc={m['accuracy']:.3f} in {secs[-1]:.3f} s")
        t0 = time.perf_counter()
        ev = trainer.evaluate()
        sync(device)
        steady = secs[1:] or secs
        say("alexnet", f"alexnet-cifar width {width} s2, {boundary} "
            f"boundary: {spec.scala.num_clients} clients, {spec.slots} per "
            f"round, {spec.scala.local_iters} local steps of "
            f"{spec.scala.server_batch} images; built in {built:.1f} s; "
            f"round seconds {[round(x, 4) for x in steady]} (round 0 "
            f"{secs[0]:.3f} s); evaluate() on {spec.data.n_test} images in "
            f"{time.perf_counter() - t0:.3f} s: acc={ev['acc']:.4f} "
            f"balanced_acc={ev['balanced_acc']:.4f}")
        del trainer

    gen = torch.Generator(device)
    gen.manual_seed(4)
    full = A.init_params(gen, width=width)
    wc, ws = A.split_params(full, "s2")
    C, B = 4, 12
    params = {"client": stack_client_params(wc, C), "server": ws}
    rng = np.random.default_rng(4)
    batch = {"x": rng.standard_normal((C, B, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (C, B)),
             "weights": np.ones((C, B), np.float32)}
    model = alexnet_split_model("s2")
    sc = ScalaConfig(num_clients=C)
    params64 = tree_map(lambda a: a.double(), params)
    batch64 = dict(batch, x=batch["x"].astype(np.float64))
    for boundary in ("fused", "dual"):
        want = step_on(model, params64, batch64, "cpu", sc, "logits",
                       boundary)
        for what, dev, cudnn, checked in (
                (f"{device} float32, cuDNN off", device, False, True),
                (f"{device} float32, cuDNN", device, True, False),
                ("cpu float32", "cpu", True, False)):
            got = step_on(model, params, batch, dev, sc, "logits", boundary,
                          cudnn=cudnn)
            compare_steps("alexnet", f"split step ({boundary}), {C} clients "
                          f"x {B} images, {what} vs cpu float64", got, want,
                          checked)


# the round check of phase 11: one round of every method but scala (the
# baselines and scala_noadj) from one seeded state, on the card against the
# CPU in float64; every leaf of the round's update (w' - w) within 1e-3 of
# that update's largest entry. Over one local step the card's float32 round
# (cuDNN off) is held so. Over the tables' 5 local steps float32 is no
# check: a ReLU or max-pool input within rounding of its switch point falls
# on the other side from the second forward on, a bias with 12 terms a
# gradient then moves by a visible part of its update, and the difference
# grows through the later steps (PERF.md §6); at 5 steps the card runs the
# round in float64, its float32 round and the CPU's reported beside it.
UPDATE_RTOL = 1e-3
# FedDecorr divides each feature by its std over a client's ~12 images
# plus 1e-5: over 5 local steps its round amplifies differences in the
# last bits by ~1e8 (float64 on the card and on the CPU part by 9% of the
# update), so its float64 round is checked over one local step and
# reported over five
CHAOTIC = ("feddecorr",)
# sfl_localloss's one local step already holds a second client forward:
# the server half trains on the activations recomputed after the client's
# update. So over one step the float32 update of its server half (leaves
# under this path) is reported, and the client half and aux head checked
F32_ONE_STEP_REPORTED = {"sfl_localloss": ".inner/ws/"}
# the CPU's own float32 round, reported for these (it lands further from
# float64 than the card's: its convolutions' weight gradients)
F32_CPU_REPORTED = ("scala_noadj", "fedavg")
# the tables of phase 11 (benchmarks/run.py's quick settings) and the
# methods of phase 12's AlexNet resume check, each with its learning rate:
# sfl_localloss at the tables' 0.05 diverges at width 1.0 (its server
# leaves hold inf or NaN by round 3), so it runs at a rate where it stays
# finite and the bitwise check compares real values
BASELINE_TABLES = ("t1", "t5", "t8")
RESUME_METHODS = (("scala", ALEXNET["lr"]), ("feddyn", ALEXNET["lr"]),
                  ("splitfed_v1", ALEXNET["lr"]), ("sfl_localloss", 0.01))


def alexnet_method_spec(method, rounds, width=ALEXNET["width"],
                        local_iters=ALEXNET["local_iters"], lr=ALEXNET["lr"]):
    """:func:`alexnet_spec`'s experiment (fused boundary) for ``method``:
    SCALA, scala_noadj or an FL / SFL baseline."""
    return dataclasses.replace(
        alexnet_spec("fused", rounds, width), method=method,
        scala=dataclasses.replace(alexnet_spec("fused").scala,
                                  local_iters=local_iters, lr=lr)).validate()


def state_leaves(state):
    """{path: leaf} of a program state (the checkpoint's own paths)."""
    from repro_torch.checkpoint.checkpoint import flatten_with_paths
    return flatten_with_paths(state)


def update_gap(old, want, got, reported=None):
    """How far ``got``'s round lies from ``want``'s (both from ``old``):
    over all leaves, the worst leaf's largest error over its update's
    largest entry, that leaf, the entries over UPDATE_RTOL and the worst
    ||got - want|| / ||update||; and the worst of the first over the
    leaves whose path does not start with ``reported``."""
    worst, worst_key, n_off, fro, checked = 0.0, "", 0, 0.0, 0.0
    for key, b in want.items():
        if not isinstance(b, torch.Tensor):
            check(got[key] == b, f"{key}: {got[key]} != {b}")
            continue
        a = got[key].double().cpu()
        check(bool(torch.isfinite(a).all()), f"{key} finite")
        upd = b - old[key]
        top = max(upd.abs().max().item(), 1e-30)
        err = (a - b).abs()
        gap = err.max().item() / top
        if gap > worst:
            worst, worst_key = gap, key
        if not (reported and key.startswith(reported)):
            checked = max(checked, gap)
        n_off += int((err > UPDATE_RTOL * top).sum())
        fro = max(fro, ((a - b).norm() / max(upd.norm().item(),
                                             1e-30)).item())
    return worst, worst_key, n_off, fro, checked


def phase_baselines(device="cuda", width=ALEXNET["width"],
                    local_iters=ALEXNET["local_iters"]):
    """The paper's baselines on the card. One round of every method but
    scala from one seeded state, against the CPU in float64, every leaf's
    update within UPDATE_RTOL of its largest entry: over 1 local step on
    ``device`` in float32 (cuDNN off), over ``local_iters`` in float64
    (the float32 rounds reported beside it). Then the paper tables T1, T5
    and T8 (quick) through the port's table runner at ``width``: the
    reference's CSV rows, each experiment's steady round seconds and peak
    device memory, finite losses, and each row's final state checked for
    inf and NaN (a diverged row is marked and counted)."""
    from repro_torch import api
    from repro_torch.benchmarks import run as tables_run
    from repro_torch.benchmarks.common import run_experiment
    from repro_torch.tree import tree_map

    cuda = torch.device(device).type == "cuda"
    cpu_s, failed = 0.0, []
    for method in (m for m in api.METHODS if m != "scala"):
        for T in (local_iters, 1):
            spec = alexnet_method_spec(method, 1, width, T)
            host = api.Trainer(spec, device="cpu")
            batches, sizes = host._next_round_batches()
            p0 = (host.state.inner.params if method in api.SCALA_METHODS
                  else host.state.inner)

            def round_on(dev, dtype, cudnn):
                program = api.build(spec, device=dev, params=tree_map(
                    lambda a: a.to(dtype), p0))
                state = program.init()
                b = {k: v.to(dev, dtype if k == "x" else v.dtype)
                     for k, v in batches.items()}
                prev = torch.backends.cudnn.enabled
                torch.backends.cudnn.enabled = cudnn
                t0 = time.perf_counter()
                try:
                    new, _ = program.step(state, b, sizes.to(dev))
                finally:
                    torch.backends.cudnn.enabled = prev
                sync(dev)
                return (state_leaves(state), state_leaves(new),
                        time.perf_counter() - t0)

            old_c, new_c, sec_c = round_on("cpu", torch.float64, True)
            cpu_s += sec_c
            f32 = f"{device} float32 cuDNN off"
            # (what, device, dtype, cuDNN, checked, leaves reported)
            if T == 1:
                variants = [(f32, device, torch.float32, False, True,
                             F32_ONE_STEP_REPORTED.get(method))]
                if method in CHAOTIC:
                    variants.append((f"{device} float64", device,
                                     torch.float64, True, True, None))
            else:
                variants = [(f"{device} float64", device, torch.float64,
                             True, method not in CHAOTIC, None)]
                if method not in CHAOTIC:
                    variants.append((f32, device, torch.float32, False,
                                     False, None))
                if method in F32_CPU_REPORTED:
                    variants.append(("cpu float32", "cpu", torch.float32,
                                     True, False, None))
            for what, dev, dtype, cudnn, checked, reported in variants:
                _, new_d, sec_d = round_on(dev, dtype, cudnn)
                check(new_d.keys() == new_c.keys(),
                      f"{method}: state trees differ")
                worst, worst_key, n_off, fro, gated = update_gap(
                    old_c, new_c, new_d, reported)
                if checked and gated > UPDATE_RTOL:
                    failed.append((method, T, what, gated))
                say("baselines", f"{method}: one round ({T} local steps, "
                    f"{spec.slots} clients), {what} {sec_d:.3f} s vs cpu "
                    f"float64 {sec_c:.2f} s: worst leaf update off by "
                    f"{worst:.3g} of its largest entry ({worst_key}; "
                    f"{n_off} entries over {UPDATE_RTOL}), worst leaf's "
                    f"||a - b|| / ||update|| {fro:.3g}"
                    + ("" if not checked else
                       f" (tol {UPDATE_RTOL})" if not reported else
                       f" (leaves under {reported} reported; the others' "
                       f"worst {gated:.3g}, tol {UPDATE_RTOL})")
                    + ("" if checked else " (reported, not checked)"))
            del host
    say("baselines", f"round check: cpu float64 side {cpu_s:.1f} s in all, "
        f"T = {local_iters} and 1")
    check(not failed, f"round updates off: {failed}")
    print(tables_run.HEADER, flush=True)
    timings = []

    def run(method, **kw):
        """run_experiment at ``width`` on ``device``, its round seconds,
        peak memory, finite losses and final state recorded."""
        secs, finite = [], []

        def on_round(rnd, metrics, dt):
            secs.append(dt)
            finite.append(all(np.isfinite(v) for v in metrics.values()))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res = run_experiment(method, device=device, width=width,
                             on_round=on_round, **kw)
        check(all(finite) and np.isfinite(res["acc"])
              and np.isfinite(res["balanced_acc"]),
              f"{method} {kw}: finite losses and accuracies")
        timings.append((method, kw, secs,
                        torch.cuda.max_memory_allocated() if cuda else 0,
                        res["nonfinite_leaves"]))
        return res

    rows = []
    for name in BASELINE_TABLES:
        tables_run.TABLES[name](True, run, rows)
    diverged = []
    for method, kw, secs, peak, nonfinite in timings:
        steady = secs[1:] or secs
        setting = ",".join(f"{k}={v}" for k, v in kw.items())
        if nonfinite:
            diverged.append(f"{method} [{setting}]")
        say("baselines", f"{method} [{setting}]: round seconds (rounds "
            f"1..{len(secs) - 1}) mean {float(np.mean(steady)):.4f} "
            f"{[round(x, 4) for x in steady]}; round 0 {secs[0]:.3f} s; "
            f"peak {peak / 2**20:.0f} MiB; final state "
            + (f"DIVERGED, {nonfinite} leaves hold inf or NaN (its acc is "
               f"argmax over non-finite logits)" if nonfinite
               else "finite"))
    check(not any(m.split()[0] in api.SCALA_METHODS for m in diverged),
          f"a SCALA row diverged: {diverged}")
    say("baselines", f"{len(timings)} table rows, {len(diverged)} diverged "
        f"(marked, not failed: the baselines at the paper's lr): "
        f"{diverged or 'none'}")


def bits(t):
    """A tensor's bytes (a NaN equals itself bit for bit)."""
    return t.contiguous().view(torch.uint8)


def states_equal(a, b, what):
    """Check two flattened program states bit for bit; returns the leaf
    count."""
    check(a.keys() == b.keys(), f"{what}: state trees differ")
    for key, x in a.items():
        y = b[key]
        if isinstance(x, torch.Tensor):
            check(x.dtype == y.dtype and x.shape == y.shape
                  and torch.equal(bits(x), bits(y.to(x.device))),
                  f"{what}: leaf {key} differs")
        else:
            check(x == y, f"{what}: leaf {key} {x} != {y}")
    return len(a)


def resume_check(what, make_trainer, rounds_before, rounds_after, device):
    """``rounds_before + rounds_after`` rounds uninterrupted against
    ``rounds_before``, ``Trainer.save``, a fresh Trainer, ``resume`` and
    ``rounds_after``: bitwise equal states and histories. One Trainer is
    alive at a time; the uninterrupted state is kept on the host."""
    import shutil
    import tempfile

    t = make_trainer()
    t.run(rounds_before + rounds_after)
    want = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in state_leaves(t.state).items()}
    want_hist = list(t.history)
    del t
    nonfinite = [k for k, v in want.items()
                 if isinstance(v, torch.Tensor) and v.is_floating_point()
                 and not bool(torch.isfinite(v).all())]
    check(not nonfinite, f"{what}: the uninterrupted run diverged ("
          f"{len(nonfinite)} leaves hold inf or NaN), so a bitwise check "
          f"would compare NaN payloads")
    directory = tempfile.mkdtemp(prefix="resume-")
    try:
        t = make_trainer()
        t.run(rounds_before)
        sync(device)
        t0 = time.perf_counter()
        path = t.save(directory)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del t
        t = make_trainer()
        t0 = time.perf_counter()
        got_round = t.resume(directory)
        sync(device)
        restore_s = time.perf_counter() - t0
        check(got_round == rounds_before, f"{what}: resumed at round "
              f"{got_round}")
        t.run(rounds_after)
        n = states_equal(state_leaves(t.state), want, what)
        check(t.history == want_hist, f"{what}: histories differ: "
              f"{t.history} vs {want_hist}")
        del t
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    say("resume", f"{what}: {rounds_before} rounds, save, resume, "
        f"{rounds_after} more == {rounds_before + rounds_after} rounds "
        f"uninterrupted, bitwise in all {n} leaves (finite) and the "
        f"history; npz "
        f"{size} bytes ({size / 2**30:.3f} GiB), save {save_s:.3f} s, "
        f"restore {restore_s:.3f} s")


def phase_resume(device="cuda", width=ALEXNET["width"], flags=TRAIN_FLAGS):
    """Trainer.save -> resume, bit for bit, on finite states: AlexNet at
    ``width`` with scala, feddyn, splitfed_v1 and sfl_localloss (2 rounds,
    save, 1 more against 3; cuDNN deterministic in this phase only;
    sfl_localloss at its own rate, its run at the tables' rate reported),
    then the training cell of phase 6 (full-width qwen1.5-0.5b, K1, K2, K3
    forward and backward; 1 round, save, 1 more against 2), its launches
    counted."""
    from repro_torch import api
    from repro_torch.benchmarks.common import nonfinite_leaves
    from repro_torch.launch import train

    t = api.Trainer(alexnet_method_spec("sfl_localloss", 3, width),
                    device=device)
    t.run()
    say("resume", f"sfl_localloss width {width} at lr {ALEXNET['lr']}: "
        f"after 3 rounds {nonfinite_leaves(t.state)} leaves hold inf or NaN "
        f"(reported; its resume check runs at lr "
        f"{dict(RESUME_METHODS)['sfl_localloss']})")
    del t
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for method, lr in RESUME_METHODS:
            spec = alexnet_method_spec(method, 3, width, lr=lr)
            resume_check(f"alexnet-cifar width {width} {method} lr {lr}",
                         lambda: api.Trainer(spec, device=device), 2, 1,
                         device)
    finally:
        torch.backends.cudnn.deterministic = prev
    spec = train.spec_from_args(train.build_parser().parse_args(flags))
    zero_counts()
    resume_check(f"{spec.arch} {'reduced' if spec.reduced else 'full'} "
                 f"width, {spec.slots} slots, boundary "
                 f"{spec.execution.boundary}",
                 lambda: api.Trainer(spec, device=device), 1, 1, device)
    n = read_counts()
    if torch.device(device).type == "cuda":
        check(all(n[k] > 0 for k in ("flash_fwd", "flash_bwd", "lace_fwd",
                                     "lace_bwd")),
              f"resume: the qwen rounds launched {n}")
    say("resume", f"launches in the qwen resume check (2 + 1 + 1 rounds): K3 "
        f"fwd {n['flash_fwd']} bwd {n['flash_bwd']}, K1 {n['lace_fwd']}, "
        f"K2 {n['lace_bwd']}")


def run_phase(label, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then its wall seconds on a line of its own
    (what each phase adds to the run's time limit)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    say("time", f"{label}: {time.perf_counter() - t0:.1f} s")
    return out


def kernel_row(name, source, replaces, launches, max_err, r):
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max_err, "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
           "library_ms": r["library_ms"]}
    # the attention kernels' device times (device_ms), beside the calls'
    row.update({key: r[key] for key in ("device_ms", "library_device_ms")
                if key in r})
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi = phase_device()
    phase_build()
    if sys.argv[1:] == ["xlstm-rounding"]:
        phase_xlstm_rounding()
        return 0
    if sys.argv[1:] == ["baselines"]:
        run_phase("baselines", phase_baselines)
        run_phase("resume", phase_resume)
        return 0
    if sys.argv[1:] == ["mlstm"]:
        run_phase("kernels K6", phase_mlstm)
        run_phase("check-xlstm", phase_check, arch=XLSTM, phase="check-xlstm",
                  prompt_len=77, max_len=96, layers=XLSTM_CHECK_LAYERS)
        return 0
    if sys.argv[1:] != ["lace"]:
        rows, max_err = run_phase("kernels K3", phase_kernels)
        bwd_rows, bwd_err = run_phase("kernels K3 bwd", phase_flash_bwd)
    if sys.argv[1:] == ["attention"]:
        return 0
    lace_rows, lace_err = run_phase("kernels K1 K2", phase_lace)
    lace1_rows, lace1_err = run_phase("kernels K4 K5", phase_lace1)
    if sys.argv[1:] == ["lace"]:
        return 0
    mlstm_rows, mlstm_err = run_phase("kernels K6", phase_mlstm)
    serve = run_phase("serve", phase_serve)
    run_phase("check", phase_check)
    serve_x = run_phase("serve-xlstm", phase_serve, arch=XLSTM,
                    phase="serve-xlstm")
    run_phase("check-xlstm", phase_check, arch=XLSTM, phase="check-xlstm",
          prompt_len=77, max_len=96, layers=XLSTM_CHECK_LAYERS)
    train = run_phase("train", phase_train)
    run_phase("train-check", phase_train_check)
    dual = run_phase("train-dual", phase_train, flags=TRAIN_DUAL_FLAGS,
                 phase="train-dual")
    run_phase("dual-check", phase_dual_check)
    run_phase("alexnet", phase_alexnet)
    run_phase("baselines", phase_baselines)
    run_phase("resume", phase_resume)
    csrc = "src/repro_torch/kernels/csrc/"
    lace_src = "src/repro/kernels/lace/kernel.py:"
    # forward launches: the serve path's plus both training paths'; its
    # times at the serving prompt, and at the training trunk's shape beside
    fwd_row = kernel_row("flash_attn_fwd", csrc + "flash_attn.cu",
                         "src/repro/kernels/flash_attn/kernel.py:23",
                         serve["flash_fwd"] + train["flash_fwd"]
                         + dual["flash_fwd"], max_err, rows[REPORT_CASE])
    fwd_row.update({f"{key}_train": rows[TRAIN_CASE][key] for key in
                    ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
                     "library_device_ms")})
    print(json.dumps({"kernels": [
        fwd_row,
        # the backward of K3 (the JAX package trains through autodiff)
        kernel_row("flash_attn_bwd", csrc + "flash_attn_bwd.cu",
                   "src/repro/kernels/flash_attn/kernel.py:23",
                   train["flash_bwd"] + dual["flash_bwd"], bwd_err,
                   bwd_rows[FLASH_BWD_REPORT]),
        kernel_row("lace2_fwd", csrc + "lace.cu", lace_src + "219",
                   train["lace_fwd"], lace_err["fwd"],
                   lace_rows[(LACE_REPORT, "fwd")]),
        kernel_row("lace2_bwd", csrc + "lace.cu", lace_src + "261",
                   train["lace_bwd"], lace_err["bwd"],
                   lace_rows[(LACE_REPORT, "bwd")]),
        kernel_row("lace_fwd", csrc + "lace1.cu", lace_src + "41",
                   dual["lace1_fwd"], lace1_err["fwd"],
                   lace1_rows[(LACE1_REPORT["server"], "fwd")]),
        # the server side's K5 (with dW), the costlier of the two
        kernel_row("lace_bwd", csrc + "lace1.cu", lace_src + "74",
                   dual["lace1_bwd"], lace1_err["bwd"],
                   lace1_rows[(LACE1_REPORT["server"], "bwd")]),
        kernel_row("mlstm_chunk", csrc + "mlstm.cu",
                   "src/repro/kernels/mlstm/kernel.py:25", serve_x["mlstm"],
                   mlstm_err, mlstm_rows[MLSTM_REPORT])]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
