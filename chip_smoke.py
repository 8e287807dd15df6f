#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build: every kernel source in ``src/repro_torch/kernels/csrc``
   (flash_attn, flash_attn_bwd, lace, lace1, mlstm, mlstm_bwd; the
   headers flash_common.cuh, lace_common.cuh and mlstm_gates.cuh), one
   nvcc each, all at once, for sm_90a; each kernel's registers and
   spills by name; the LACE and K6 kernels' tensor-core TF32 and FFMA
   instruction counts from ``cuobjdump -sass`` (each product body must
   hold TF32 products);
3. kernels: each kernel against its plain PyTorch version at the shapes
   its path gives it, with the stated tolerance; then its time (CUDA
   events), the plain version's, PyTorch's own call's (``library_ms``, a
   yardstick only), for K3 also the card's time alone (``device_ms``:
   the calls queued behind a sleep kernel, no host time), and the card's
   bound for the work -- the attention forward (K3) at the serving
   shapes, the training trunk's, the served MoE model's (hd 128, 32
   heads on 4 KV heads) and the served jamba's (hd 128, 64 heads on 8 KV
   heads), then the attention backward (two
   runs bitwise equal; also at qwen3-moe-30b-a3b's training shapes, 32
   heads of 128 on 4 KV heads), the fused LACE boundary (K1, K2; also at the
   masked round's 16 client prior rows, 12 of them absent) and the
   single-prior LACE kernels of the dual boundary (K4, K5; server side
   with dW, client side without) at the training shapes, each also with
   a bf16 head as the bf16 compute policy hands it (each with its bound,
   every pass at TF32's rate, the split-TF32 route's cost and the f32
   CUDA cores' beside it, and a bitwise repeat at the main path's cases,
   float32 and bf16 head), K1 and K2 at xlstm-1.3b's boundary (d 2048,
   V 50304) and at qwen3-moe-30b-a3b's (d 2048, V 151936, bf16 head;
   a bitwise repeat), and the chunkwise
   mLSTM (K6) at the served xlstm-1.3b's prefill shapes, every prompt
   length of the serving mix, q, k, v in float32 and in bfloat16 (h and
   the final C, n, m against the plain version, a bitwise repeat, the
   bound at the tensor cores' rate, the split products' and the q/k
   re-reads' rates, and a profile of its four kernels); then K6's
   backward at phase 17's shapes (the server's 16 x 512 tokens, a
   client's 4 x 512, a ragged 2 x 200), q, k, v in bf16 and f32, against
   the plain backward and autograd of the plain forward, a bitwise
   repeat, its time, the plain backward's and the bound; then K3 at the
   frontend archs' shapes -- its non-causal mode (cross-attention over
   Skv != S keys: whisper-tiny's 16 x 448 queries and a decode step's
   8 x 1 on 1500 audio frames, 6 heads of 64), whisper's causal 16 x 448
   and internvl2-26b's causal 16 x 512 at 48 heads of 128 on 8 KV heads,
   forward and (but the decode step's) backward against the plain
   version, each twice bitwise, beside the bound (non-causal: S x Skv
   pairs, k and v bytes at Skv) and SDPA's time on the same inputs; and
   K1 / K2 at the frontend archs' odd vocabularies (whisper d 384, V
   51865, f32 head; internvl2 d 6144, V 92553, bf16 head: head rows off
   16-byte boundaries), a bitwise repeat each;
4. serve: full-width qwen1.5-0.5b in bf16 through ServeSpec ->
   build_serve -> ServeEngine.serve, dense and paged cache; paged tokens
   must equal dense tokens, and every admitted request must have
   launched the attention kernel once per layer;
5. check: full width in float32, TF32 off -- the fused prefill's logits
   and decode cache (through the kernel) against the token-by-token
   decode loop's (no kernel), and the engine's greedy tokens against the
   loop's;
5b. serve-xlstm: phase 4 for full-width xlstm-1.3b cut to one period of
   its pattern (8 of 48 layers: 7 mLSTM, 1 sLSTM; the cut config's
   params made from the seed on the card and served by ``ServeEngine``,
   as 5f) in bf16: K6 launched once per mLSTM layer and admit, none of
   K3; an admit split by mixer (host time, K6's device time) and a
   decode step with every slot busy, profiled;
5c. check-xlstm: phase 5 for xlstm-1.3b at full width and 8 layers (one
   period of its pattern) on an odd prompt of 77 tokens: logits and
   every layer's final state (mLSTM C, n, m through K6 against the
   per-step recurrence);
5d. serve-moe: phase 4 for full-width qwen3-moe-30b-a3b cut to 16 of
   its 48 layers (128 experts, top-8, bf16 weights: 20.4 GB, one copy at
   a time; served by ``ServeEngine`` as 5f)
   -- K3 once per attention layer and admit at 32 heads of 128 on 4 KV
   heads; the MoE FFN routes in float32, dropless in the prefill; an
   admit of the longest prompt and a decode step with every slot busy,
   each split into one layer's MoE FFN and attention (host and device ms,
   replayed on the run's inputs) and the rest, and the step profiled;
5e. check-moe: phase 5 for qwen3-moe-30b-a3b at full width and 8 layers
   in float32 (the fused prefill through K3 and the dropless MoE against
   the token-by-token loop), after a line with the smallest gap between
   a token's 8th and 9th router logit over the routings checked;
5f. serve-jamba: phase 4 for full-width jamba-1.5-large-398b cut to its
   first 5 of 72 layers (mamba 0-3, attention 4 at 64 heads of 128 on 8
   KV heads, MoE FFNs of 16 experts top-2 at 1 and 3, dense at 0, 2, 4;
   bf16 params: 24.05 B, 48.16 GB), the cut config's params made from
   the seed on the card and served by ``ServeEngine`` (a ``ServeSpec``
   has no depth) -- K3 once per admit; an admit of the longest prompt
   and a decode step with every slot busy, each split by mixer and FFN
   (mamba, attention, MoE FFN, dense FFN; host and device ms), and the
   step profiled;
5g. check-jamba: phase 5 for jamba at full width and 3 layers in
   float32 (mamba + dense, mamba + MoE, mamba + dense; 52.8 GB): the
   prefill's chunked scan against the one-step recurrence, every conv
   and h leaf;
6. train: full-width qwen1.5-0.5b through the training CLI's spec and
   Trainer on the card -- 16 clients, 4 sampled per round, 2 local steps
   of 16 x 512 tokens, 3 rounds; finite losses, the kernels' launch
   counts per round against the layout's formula, round seconds, tokens/s,
   peak memory and a profiled round's device-busy share;
7. train-check: full width in float32, TF32 off -- one split step and
   one round on the card (K1, K2, K3 forward and backward; the step's
   launches against the layout) against the same on the CPU (the plain
   versions);
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
   state at width 0.5 (FedDecorr 1.0), held against the round on the CPU
   in float64 (every leaf's update within 1e-3 of its largest entry):
   over one local step the card's float32 round with cuDNN off, over the
   tables' five the card's float64 round (float32 reported beside it);
   then the paper tables T1, T5 and T8 (quick) through the port's table runner at width 1.0 -- the
   reference's CSV rows, each experiment's round seconds and peak device
   memory, and whether its final state is finite (a diverged baseline
   row is marked; a diverged SCALA row fails);
12. resume: ``Trainer.save`` -> a fresh Trainer -> ``resume`` against an
   uninterrupted run whose state is finite, bitwise in every leaf and in
   the history: AlexNet (scala, feddyn, splitfed_v1, sfl_localloss at
   its own rate; cuDNN deterministic in this phase), then phase 6's
   full-width qwen1.5-0.5b training (K1, K2, K3 forward and backward);
   the ``.npz`` size, save and restore seconds;
13. fed: the synchronous federation layer on full-width qwen1.5-0.5b
   through the training CLI's spec and Trainer -- (a) masked, the
   reference driver's own example (16 slots all computed, uniform:0.25,
   bias_compensated, momentum, one document a slot) and (b) sparse (the
   4 participating slots gathered, 4 documents each, staleness_weighted,
   server FedAdam), each with phase 6's launch check against the
   computed slots, finite losses, round seconds, participating tokens/s,
   peak memory and a profiled round; (c) fed-check: f32 full width and 6
   layers, 4 slots, one masked round with injected masks (bias_compensated,
   momentum, server adamw) on the card against the CPU, then sparse
   against masked on the card (SGD); (d) resume with federation state,
   bitwise: (b)'s run, and masked AlexNet width 1.0 with
   staleness_weighted;
14. async: the asynchronous event runtime on full-width qwen1.5-0.5b
   through the training CLI's spec and Trainer -- (a) async-dense, the
   reference driver's async example (16 clients, ``--async --cohort 4
   --delay-spec lognormal:1:1.5 --staleness-decay 0.5``) with momentum
   carried per slot and a deadline of 2.0, the 4 arrivals' 4 documents
   each a step, 4 events; (b) async-delta, the same with delta snapshots
   in a ring of 8, the moments paged to the host, the top-k pop and the
   lr scaled by cohort / K, no deadline -- each with phase 6's launch
   check against the cohort's slots, finite losses, event seconds,
   arrival tokens/s, staleness, deadline misses, peak memory, the state's
   resident bytes (and the pager's host bytes and page seconds; its
   ``save`` must refuse) and a profiled event; (c) async-check: f32 full
   width and 6 layers, 4 slots, cohort 2 -- three events with recorded
   delays and a deadline, card against CPU under fed-check's rule, the
   host schedule equal; zero delays with cohort = K against the sync round on the card
   (atol = rtol = 1e-6); delta against dense snapshots on the card over
   six events, bitwise; (d) resume: (a)'s run saved after event 2 and
   resumed, events 3-4 bitwise against the uninterrupted run;
15. faults: fault injection and guarded aggregation on full-width
   qwen1.5-0.5b through the training CLI's spec and Trainer -- (a)
   fault-masked, phase 13(a)'s cell with ``--faults
   drop:0.1,corrupt:0.5:nan --guards nonfinite,clip:10``, 3 rounds, and
   (b) fault-async, phase 14(a)'s cell with ``--faults
   drop:0.1,corrupt:0.25:nan,stall:0.1 --guards nonfinite``, 4 events --
   each with phase 6's launch check per local pass (a round that
   rejected someone runs its local phase twice), the rejections per
   round, at least one, every leaf finite, and for (b) the schedule
   advanced; (c) fault-check: f32 full width, 4 slots -- guards at zero
   faults == no guards bitwise (masked, sparse, async dense; the
   screen's cost), and a recorded NaN corruption of one participant:
   the guarded round == the clean round whose mask is the survivors,
   bitwise; (d) at reduced width, a faulted guarded masked round and a
   faulted async event, card against CPU under fed-check's rule, the
   accept vectors equal;
16. dispatch: the dispatch knobs on full-width qwen1.5-0.5b through the
   training CLI's spec and Trainer -- (b) chunks: phase 6's cell at 3
   rounds a call over 5 rounds (3 + 2) against 1 a call from the same
   seed, history and every state leaf bitwise, seconds a round, and the
   synchronizing CUDA calls of one call of each (``torch.cuda.
   set_sync_debug_mode("warn")``, recorded, no bar); (a) bf16: phase 6's
   cell with ``--precision bf16``, 3 rounds, through phase 6's launch
   check (K1, K2 on their bf16-head build), master params and moments
   float32 and finite, each round's loss_server within 0.1 of (b)'s
   float32 run (the reference's bar), a profiled round; then one round
   of it with ``--boundary dual`` (K4, K5 on their bf16-head build);
   (c) dispatch-check: full width in the float32 policy, 4 slots -- 2
   rounds a call over 3 rounds against 1 a call in the subset, masked
   (bias_compensated, server FedAdam), sparse and async dense modes,
   bitwise; a guarded masked round with a recorded NaN corruption,
   donate on against off, bitwise; the masked round's peak memory at
   phase 13(a)'s cell with and without donation; (d) AlexNet at width
   1.0 in bf16, one round of scala, fedavg and splitfed_v1, every leaf
   float32 and finite;
17. train-xlstm: phase 6's cell on full-width xlstm-1.3b cut to 16 of
   its 48 layers (14 mLSTM with K6 and its backward, 2 sLSTM, the
   server's scan group 8-15 rematerialized) -- the launches per round
   against the layout (K6 forward 34 and backward 32 a step, K1 = K2 =
   1, K3 none),
   finite losses, round seconds, tokens/s, peak memory, the sLSTM loops'
   host seconds and a profiled round (device events only) split into K6
   forward, K6 backward and LACE;
17b. train-check-xlstm: phase 7 on xlstm-1.3b at full width and 8
   layers (one period of its pattern), 2 clients x 256 tokens (4 chunks:
   the backward's reverse walk crosses chunk boundaries);
18. train-moe: phase 6's cell on full-width qwen3-moe-30b-a3b in its own
   dtypes (bf16 params and compute, float32 routers) cut to 6 of 48
   layers (2 client, 4 server), through ``engine.make_round_runner``
   with ``api.build``'s arguments on params made once on the card (a
   spec has no depth) -- a memory reckoning printed first, then the
   launches per round against the cut layout, finite losses and router
   loss, round seconds, tokens/s, peak memory, the MoE slabs' rows and
   the host syncs of round 0, a profiled round (device events) and a
   round split into the MoE FFN and attention (forward and backward
   each) and the LACE boundary, host and device;
18b. check-moe-train: phase 7 on qwen3-moe-30b-a3b at full width and 3
   layers (one server MoE layer), 2 clients x 64 tokens (pairs drop), the
   nearest 8th / 9th router gap printed first, aux and the router grads
   (and the round's server routers) among the checks; then a bf16 step
   of 3 layers, 2 clients x 4 x 512 tokens, run twice: bitwise;
5h. serve-whisper: whisper-tiny at full width and depth in its dtypes
   (f32 params, bf16 compute) through ``forward_prefill_cached`` and
   ``decode_step`` (``ServeEngine`` refuses frontends, as the
   reference's): batches of 8 rows, each row its own 1500 x 384 encoder
   output, prompts of 4, 64, 128 and 224 tokens, 32 greedy new tokens
   each -- tok/s, prefill and step ms, peak memory, and K3's launches,
   self and cross, equal to the layout's (a decode step cross-attends
   through K3 in every layer);
5i. check-whisper: phase 5 for whisper-tiny in float32 at full depth, 2
   rows: the fused prefill against the token-by-token decode loop;
19. train-whisper: phase 6's cell on whisper-tiny at full width and
   depth, 2 steps of 16 x 448 tokens (Whisper's decoder context) on 1500
   frames a row, through ``engine.make_round_runner`` with
   ``api.build``'s arguments (a spec takes no frontend arch) -- the
   memory concatenated at the split and pulled back through each
   client's projector; the launches per round against the layout (K3
   self and cross, forward and backward), finite losses, round seconds,
   tokens/s, peak memory and a profiled round;
19b. check-whisper-train: phase 7 on whisper-tiny in float32 at full
   width and depth, 2 clients x 64 tokens on 1500 frames (the
   projector's and ``pos``'s grads printed); then a bf16 step of 2
   clients x 4 x 448 tokens twice: bitwise;
20. train-vlm: phase 6's cell on internvl2-26b at full width cut to 6 of
   48 layers (2 client, 4 server) in bf16, 4 slots x 4 rows x (256 image
   + 256 text) rows, the image rows' labels of weight 0 -- a memory
   reckoning first, the launches per round (K3 at 48 / 8 heads of 128,
   K1 / K2 at d 6144 x V 92553), the peak held under 72 GB, a profiled
   round;
20b. check-vlm: internvl2-26b's projector alone at full width in float32,
   (2, 256, 3200) -> (2, 256, 6144), card against CPU: its output and
   the grads of its four leaves.
22. tooling: (a) the boundary leg (``repro_torch.benchmarks.boundary``:
   the reference's grid on both backends, the bf16 leg, qwen1.5-0.5b's
   head at d 1024, V 151936, 4 x 2048 tokens, then the fused-against-dual
   guard; K1, K2, K4, K5 launched), (b) the serving leg
   (``repro_torch.benchmarks.serve`` at full-width qwen1.5-0.5b: 12
   requests, slots 2 and 4, 2 reps; paged tokens == continuous; K3 once
   a layer on every admit; then the continuous-against-static guard on
   MICRO), (c) the dry run of qwen1.5-0.5b x {train_4k, prefill_32k,
   decode_32k} on grids "1" and "16x16", its two report tables, the
   roofline leg and the top 5 of profile_collectives, (d) phase 6's
   local step (4 slots x 4 x 512) dry-run on ``meta`` and then run on
   the card: argument bytes equal exactly, the dry run's peak beside
   ``max_memory_allocated``, counted FLOPs and 6 N D over the step's
   seconds at the bf16 peak (the MFU); the phase's seconds (bar 90 s).

Then one JSON line of kernel numbers, the ``nvidia-smi`` line again, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
exits nonzero; without a GPU it exits nonzero before printing a result.

``python3 chip_smoke.py attention`` runs phases 1 and 2 and the
attention kernels of phase 3 (K3 forward and backward), then stops;
``python3 chip_smoke.py moe`` runs phases 1 and 2, K3's forward from
phase 3, then 5d and 5e; ``python3 chip_smoke.py jamba`` the same, then
5f and 5g;
``python3 chip_smoke.py lace`` the same for the LACE kernels (K1, K2,
K4, K5); ``python3 chip_smoke.py mlstm`` the same for K6, then
check-xlstm (5c).
``python3 chip_smoke.py baselines`` runs phases 1, 2, 11 and 12;
``python3 chip_smoke.py fed`` phases 1, 2 and 13; ``python3
chip_smoke.py async`` phases 1, 2 and 14; ``python3 chip_smoke.py
faults`` phases 1, 2 and 15; ``python3 chip_smoke.py dispatch`` phases
1, 2 and 16; ``python3 chip_smoke.py xlstm-train`` phases 1 and 2, K6's
backward and K1 / K2 at xlstm-1.3b's width from phase 3, then 17 and
17b; ``python3 chip_smoke.py moe-train`` phases 1 and 2, K3's backward
and K1 / K2 at qwen3-moe-30b-a3b's training shapes from phase 3, then 18
and 18b.
``python3 chip_smoke.py frontends`` runs phases 1 and 2, the frontend
cases of phase 3 (K3 and K1 / K2), then 5h, 5i, 19, 19b, 20 and 20b.
``python3 chip_smoke.py tooling`` runs phases 1, 2 and 22.
``python3 chip_smoke.py xlstm-rounding`` runs phases 1 and 2, then only
the probe behind check-xlstm's depth: full-depth float32 xlstm-1.3b
through the prefill (K6, the plain version) and the decode loop (two
summation orders), the last position compared pairwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.perf.roofline import (HBM_BW, PEAK_BY_KIND,  # noqa: E402
                                       work_bound)

ARCH = "qwen1.5-0.5b"
# the H100 SXM's published peaks (repro_torch/perf/roofline.py)
PEAK_FLOPS = {torch.bfloat16: PEAK_BY_KIND["bf16"],   # tensor-core bf16
              torch.float32: PEAK_BY_KIND["f32"],     # outside the cores
              "tf32": PEAK_BY_KIND["tf32"]}           # tensor-core TF32
PEAK_BYTES = HBM_BW                                   # HBM3
TOL = {torch.bfloat16: 3e-2,  # output rounded to bf16 (2^-8 relative)
       torch.float32: 1e-4}   # float32 sums over <= 2048 keys in another order
LOGIT_ATOL = 1e-3   # f32 logits of O(1) after 24 layers, sums in another order
# (B, P, H, KV, window, dtype, head dim): the prefill shapes of the served
# model, then the training trunk's (16 sequences of 512 tokens), then the
# served qwen3-moe-30b-a3b's longest prompt (32 heads of 128 on 4 KV heads)
# and the served jamba-1.5-large-398b's (64 heads of 128 on 8 KV heads)
KERNEL_CASES = [(1, P, 16, 16, None, dt, 64)
                for dt in (torch.bfloat16, torch.float32)
                for P in (128, 777, 2048)]
KERNEL_CASES += [(1, 777, 16, 2, None, torch.bfloat16, 64),      # GQA
                 (1, 1024, 16, 16, 256, torch.bfloat16, 64),     # window
                 (16, 512, 16, 16, None, torch.bfloat16, 64),    # training
                 (1, 777, 32, 4, None, torch.bfloat16, 128),     # MoE serving
                 (1, 777, 64, 8, None, torch.bfloat16, 128)]     # jamba
REPORT_CASE = (1, 777, 16, 16, None, torch.bfloat16, 64)     # the JSON line's
TRAIN_CASE = KERNEL_CASES[-3]                                # and beside it
MOE_CASE = KERNEL_CASES[-2]                                  # and beside it
JAMBA_CASE = KERNEL_CASES[-1]                                # and beside it
XLSTM = "xlstm-1.3b"
MOE = "qwen3-moe-30b-a3b"
JAMBA = "jamba-1.5-large-398b"
# jamba's depths on one card: 5 of 72 layers in bf16 (layers 0-3 mamba,
# 4 attention; 1 and 3 MoE FFNs of 16 experts, 19.3 GB each: 24.05 B
# parameters, 48.16 GB), the least depth that holds its attention layer;
# and 3 in float32 for check-jamba (mamba + dense, + MoE, + dense: 52.8
# GB; 5 would be 96 GB)
JAMBA_SERVE_LAYERS = 5
JAMBA_CHECK_LAYERS = 3
# check-moe's depth in float32 at full width: 2.49 GB a layer (the
# experts' 604 M parameters), 8 layers and the 2.5 GB embedding and head
# come to ~22 GB
MOE_CHECK_LAYERS = 8
# serve-moe's and serve-xlstm's depths, cut to keep the whole script well
# within its time limit (both serving runs are host-bound, their seconds
# a layer count's multiple): qwen3-moe-30b-a3b at 16 of 48 layers (20.4
# GB in bf16), xlstm-1.3b at one period of its 7:1 pattern (8 of 48: 7
# mLSTM, 1 sLSTM)
MOE_SERVE_LAYERS = 16
XLSTM_SERVE_LAYERS = 8
# train-moe's depth: full-width qwen3-moe-30b-a3b cut from 48 to 6 layers,
# the client's 2 (split_layer) and 4 server layers. A layer is 622.9 M bf16
# params (18.9 M of attention, 604.0 M of experts) and a float32 router;
# the embedding and the head 311.2 M each: 4 slots of the client half and
# the server half come to 18.07 GB, their gradients as much again
# (``memory_reckoning`` prints it). check-moe-train: float32, 3 layers
# (one server MoE layer), 2 clients x 64 tokens: capacity 5 a row for 8
# of 128 experts, so pairs drop.
MOE_TRAIN_LAYERS = 6
MOE_TRAIN_CHECK_LAYERS = 3
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
# K6's backward, (B, S, H, dk, dv, q/k/v dtype, initial state): the
# server's call in phase 17 (16 sequences of 512 tokens), a client's (4 of
# them), and a ragged last chunk, each with q, k, v in bf16 (as the bf16
# policy passes them) and in f32, from the zero state; then a client's
# call from a constant nonzero (C0, n0, m0), and 1000 tokens (past the
# backward's 512-token block, so its state walk between blocks runs; a
# ragged last chunk), both in bf16. Against the plain backward and
# autograd of the plain forward on the f32 copies (the state held
# constant): every gradient within 1e-4 of its largest entry (sums in
# another order), bf16 dq, dk, dv within 1e-4 + 2^-8 (rounded once to
# bf16: half an ulp, 2^-8 of the entry at most). Two runs of each case
# are bitwise equal.
MLSTM_BWD_CASES = ([(B, S, 4, 1024, 1024, dt, False)
                    for dt in (torch.bfloat16, torch.float32)
                    for B, S in ((16, 512), (4, 512), (2, 200))]
                   + [(4, 512, 4, 1024, 1024, torch.bfloat16, True),
                      (2, 1000, 4, 1024, 1024, torch.bfloat16, False)])
MLSTM_BWD_REPORT = MLSTM_BWD_CASES[0]
# the prefill against its token-by-token decode, float32: every layer's
# final state within 1e-3 of its largest entry. xlstm-1.3b is checked at
# full width on one period of its 7:1 layer pattern (8 layers: 7 mLSTM, 1
# sLSTM): its 48 random layers amplify float32 rounding until two decode
# loops that differ only in the order of one product part by 1.6e-2 in
# the logits (``python3 chip_smoke.py xlstm-rounding``, PERF.md), so at
# full depth no check can tell the kernel from rounding
STATE_RTOL = 1e-3
XLSTM_CHECK_LAYERS = 8
# attention backward, (B, P, H, KV, window, dtype, head dim): the training
# trunk's shape (16 sequences of 512 tokens) first, then other lengths, GQA
# and a window, then qwen3-moe-30b-a3b's training (32 heads of 128 on 4 KV
# heads): the server's 16 x 512 and a client's 4 x 512. Tolerance against
# autograd of the plain version, relative to the largest entry: bf16 3e-2
# (inputs, output and grads rounded to bf16), f32 1e-4 (sums in another
# order). Two runs of each case are bitwise equal.
FLASH_BWD_CASES = [(16, 512, 16, 16, None, torch.bfloat16, 64),
                   (16, 512, 16, 16, None, torch.float32, 64),
                   (1, 777, 16, 16, None, torch.bfloat16, 64),
                   (1, 777, 16, 16, None, torch.float32, 64),
                   (4, 512, 16, 2, None, torch.bfloat16, 64),      # GQA
                   (2, 1024, 16, 16, 256, torch.bfloat16, 64),     # window
                   (16, 512, 32, 4, None, torch.bfloat16, 128),    # MoE server
                   (4, 512, 32, 4, None, torch.bfloat16, 128)]     # MoE client
FLASH_BWD_REPORT = FLASH_BWD_CASES[0]
FLASH_BWD_MOE = FLASH_BWD_CASES[-2]        # the JSON line's *_moe keys
FLASH_BWD_MOE_CASES = FLASH_BWD_CASES[-2:]
# the fused LACE boundary (K1, K2), (N tokens, feats dtype, tau, G client
# prior rows, absent clients, head dtype) at the training width (d 1024, V
# 151936, G per-client prior rows, one concatenated row, the last eighth of
# each client's tokens weight 0): the main path's 8192 tokens first, then
# 2048, a ragged N and tau = 0, then the masked round's shape: 16 prior
# rows, 12 of them absent clients (every token weight 0, a uniform prior
# row), then the main path under the bf16 compute policy: a bf16 head
# (held against the plain version on its float32 copy).
# Tolerance against the plain version (f32 products, TF32 off; the
# kernels' split-TF32 products keep f32 accuracy): nll and lse within 1e-4
# of their largest entry, df and dW within 1e-5 of theirs; df of the first
# 256 tokens also within 1e-5 of the float64 value. At the main path's
# cases (f32 and bf16 head) two runs of K1, K2 (and of K4, K5 per side)
# are bitwise equal.
LACE_CLIENTS = 4
F32, BF16 = torch.float32, torch.bfloat16
LACE_CASES = [(8192, BF16, 1.0, LACE_CLIENTS, 0, F32),
              (8192, F32, 1.0, LACE_CLIENTS, 0, F32),
              (2048, BF16, 1.0, LACE_CLIENTS, 0, F32),
              (2048, F32, 0.0, LACE_CLIENTS, 0, F32),
              (2047, BF16, 1.0, LACE_CLIENTS, 0, F32),
              (8192, BF16, 1.0, 16, 12, F32),
              (8192, BF16, 1.0, LACE_CLIENTS, 0, BF16)]
LACE_REPORT = LACE_CASES[0]
# the boundary of xlstm-1.3b's training (phase 17): d 2048 (the first width
# above the kernels' KSEG = 1024 on a card), V 50304, bf16 feats
LACE_XLSTM = (8192, BF16, 1.0, LACE_CLIENTS, 0, F32, 2048, 50304)
# the boundary of qwen3-moe-30b-a3b's training (train-moe): d 2048, V
# 151936, its params (the head too) stored in bf16
LACE_MOE = (8192, BF16, 1.0, LACE_CLIENTS, 0, BF16, 2048, 151936)
# the boundaries of the frontend archs' training (phases 19, 20), at odd
# vocabularies whose head rows miss 16-byte boundaries (the kernels'
# plain-copy path): whisper-tiny's server batch of 16 x 448 tokens, d 384,
# V 51865, its f32 head; internvl2-26b's 16 x (256 + 256) rows, d 6144, V
# 92553, its bf16 head
LACE_WHISPER = (7168, BF16, 1.0, LACE_CLIENTS, 0, F32, 384, 51865)
LACE_VLM = (8192, BF16, 1.0, LACE_CLIENTS, 0, BF16, 6144, 92553)
LACE_BF16_HEAD = LACE_CASES[-1]          # the bf16 policy's main path
# the lace_dp boundary's raw sums (mean=False: each token's scale its
# weight, no 1 / W) at the per-rank shape of phase 21's cell on a
# two-rank grid: 8 client slots x 512 tokens, 8 prior rows
LACE_RAW = (4096, BF16, 1.0, 8, 0, F32, 1024, 151936)
# the single-prior LACE kernels (K4, K5) of the dual boundary, (N tokens,
# feats dtype, side, head dtype) at the training width: the server side
# (one concatenated prior row, dW) and the client side (4 per-client rows
# picked per token, no dW), at the main path's 8192 tokens and at 2048,
# then the main path's sides with a bf16 head (the bf16 policy). Tolerance
# against the plain version: nll and lse within 1e-4 of their largest
# entry, df and dW within 1e-5 of theirs.
LACE1_CASES = [(N, dt, side, F32) for N in (8192, 2048)
               for dt in (BF16, F32) for side in ("server", "client")]
LACE1_CASES += [(8192, BF16, side, BF16) for side in ("server", "client")]
LACE1_REPORT = {"server": LACE1_CASES[0], "client": LACE1_CASES[1]}
LACE1_BF16_HEAD = {"server": LACE1_CASES[-2], "client": LACE1_CASES[-1]}
# K4, K5 in raw-sum mode (the lace_dp dual boundary) at LACE_RAW's shape
LACE1_RAW = {side: (4096, BF16, side, F32, "raw")
             for side in ("server", "client")}
LACE1_CASES += list(LACE1_RAW.values())
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
# the federation phase: (a) the reference driver's own example at full
# width, masked -- 16 client slots all computed, a quarter of them
# participating, one document a slot (16 x 512 tokens at the boundary);
# (b) sparse at phase 6's shape -- the scheduler's 4 slots gathered, 4
# documents each -- with staleness-weighted FedAvg and server FedAdam at
# lr 1e-3 (the reference driver's default server lr, 1.0, moves every
# server weight by about 1 a round: FedAdam's first step is ~sign(delta))
FED_MASKED_FLAGS = ["--arch", ARCH, "--clients", "16", "--participation",
                    "uniform:0.25", "--aggregator", "bias_compensated",
                    "--optimizer", "momentum", "--local-iters", "2", "--seq",
                    "512", "--server-batch", "16", "--docs-per-client", "8",
                    "--rounds", "3", "--seed", "0"]
FED_SPARSE_FLAGS = ["--arch", ARCH, "--clients", "16", "--participation",
                    "uniform:0.25", "--slot-gather", "--aggregator",
                    "staleness_weighted", "--server-optimizer", "fedadam",
                    "--server-lr", "1e-3", "--local-iters", "2", "--seq",
                    "512", "--server-batch", "64", "--docs-per-client", "8",
                    "--rounds", "3", "--seed", "0"]
# (c) fed-check: f32 full width, 4 slots, uniform:0.5 masks injected,
# S = 64, T = 2, bias_compensated, momentum and server adamw. The server
# adamw runs at eps 1e-3 there: its first step is delta / (|delta| + eps),
# so at the default 1e-8 an entry whose round delta is float32 noise
# would flip its step's sign between two devices, which says nothing
# about the kernels. Card against CPU, every param (the server half also
# before its FedOpt step, w_start - delta) is held by phase 7's rule and
# every other float leaf to LEAF_RTOL of its largest entry, except the
# server optimizer's state: delta is the difference of two float32
# params, so between devices it parts by their rounding however small the
# update. That state is held on each device instead, bit for bit, against
# Adam's first step on that device's own delta, written out here
# (:func:`adam_first_step`); the delta itself against the reference's
# round is the CPU parity tests' (tests/test_torch_fed.py).
FED_CHECK_SERVER_EPS, FED_CHECK_SERVER_LR = 1e-3, 1e-3
FED_CHECK_LAYERS = 6        # of 24: the CPU's masked round is the cost
ADAM_B1, ADAM_B2 = 0.9, 0.95          # repro_torch.optim.adamw's defaults


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


def attention_bound(B, P, H, KV, hd, window, dtype, Skv=None, causal=True):
    """(ms, 'operations' | 'bytes'): the least time for attention over B
    rows of P queries, from the (q, k) pairs it must score
    (``kernels/flash_attn/ops.py:scored_pairs``), or from its bytes: q
    and the output at P rows, k and v at ``Skv`` (default P)."""
    from repro_torch.kernels.flash_attn import ops

    t, bound_by = work_bound(ops.work(B, P, H, KV, hd, dtype, window=window,
                                      Skv=Skv, causal=causal))
    return t * 1e3, bound_by


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
                        "mlstm", "mlstm_bwd"])
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
    for name in ("lace", "lace1", "mlstm", "mlstm_bwd"):
        sass_mix(build.library_path(name), name)


# the kernels of split-TF32 sources whose bodies run tensor-core products
PRODUCT_BODIES = ("lace_fwd_kernel", "lace_grad_kernel", "lace_gemm_kernel",
                  "mlstm_scores_kernel", "mlstm_state_kernel",
                  "mlstm_bwd_gemm_kernel")


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
        B, P, H, KV, window, dtype, hd = case
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


def serve_run(engine, reqs, warm_len: int):
    """Warm ``engine`` up, serve ``reqs`` with every launch count set to 0
    just before. Returns (results, seconds, the launches of the run, peak
    bytes, cache bytes)."""
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
    return results, dt, launches, peak, engine.state_bytes()


def device_events(prof):
    """{name: [seconds, count]} of the device events a torch.profiler run
    recorded: the sums ``key_averages()`` gives for them, read from the
    raw events without the tree of host events that ``key_averages()``
    builds first (more than a minute for a serving run's host ops)."""
    cuda = torch.autograd.DeviceType.CUDA
    per = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != cuda or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        acc = per.setdefault(e.name(), [0.0, 0])
        acc[0] += e.duration_ns() / 1e9
        acc[1] += 1
    return per


def profile(what: str, fn, top: int, watch=()) -> None:
    """Run ``fn`` once more under torch.profiler, recording device events
    only: the wall time, the device's busy time (the sum of kernel
    times), the ``top`` kernels that take the most of it and, for each
    (label, name part) in ``watch``, the share of the kernels whose name
    holds that part. No host op is recorded: no number here reads one,
    and recording them slows a serving run's host and takes seconds to
    collect."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    t_start = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_events(prof)
    say("profile", f"collecting the trace took "
        f"{time.perf_counter() - t_start - wall:.1f} s")
    busy = sum(t for t, _ in kernels.values())
    if busy == 0:
        say("profile", "device time not measured (the profiler saw no "
            "kernels)")
        return
    say("profile", f"profiled {what}: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), {len(kernels)} kernel "
        "names")
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]
                               )[:top]:
        short = name.replace("void (anonymous namespace)::", "").replace(
            "__nv_bfloat16", "bf16")
        say("profile", f"  {t:.4f} s ({100 * t / busy:.1f}% of busy) "
            f"x{n}: {short[:90]}")
    for label, parts in watch:
        parts = (parts,) if isinstance(parts, str) else parts
        hits = [v for name, v in kernels.items()
                if any(p in name for p in parts)]
        t = sum(v[0] for v in hits)
        say("profile", f"  {label}: {t:.4f} s ({100 * t / busy:.1f}% of "
            f"busy) x{sum(v[1] for v in hits)}, kernels named "
            f"{' or '.join(f'*{p}*' for p in parts)}")


def serve_launches(cfg, n_admits):
    """Kernel launches a serving run makes: every admit's fused prefill
    runs K3 once per attention layer and K6 once per mLSTM layer; decode
    runs neither."""
    n = {m: sum(s.mixer == m for s in cfg.block_specs)
         for m in ("attn", "mlstm")}
    return dict(flash_fwd=n_admits * n["attn"], flash_bwd=0, lace_fwd=0,
                lace_bwd=0, lace1_fwd=0, lace1_bwd=0,
                mlstm=n_admits * n["mlstm"], mlstm_bwd=0)


def free_device_memory():
    """Return every cached block to the card: the next model's weights
    (a 12.9 GB float32 expert stack at a time) need room the last one's
    smaller blocks would split."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase_serve(device="cuda", reduced=False, arch=ARCH, phase="serve",
                n_req=SERVE_REQS, lens=SERVE_LENS, gen=32, slots=8,
                max_len=1024, page_size=16, layers=None):
    """Serve the request mix through ``ServeSpec`` -> ``build_serve`` ->
    ``ServeEngine.serve``, dense and then paged; returns the launch
    counts of the two runs together. ``layers`` cuts the depth: a
    ``ServeSpec`` has no depth, so the cut config's params are made once
    from the seed on the device and each engine built on them
    (``ServeEngine(params, cfg, ...)``, the engine ``build_serve``
    returns)."""
    from repro_torch.api import ServeSpec, build_serve
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import leaves

    free_device_memory()
    spec = ServeSpec(arch=arch, reduced=reduced, slots=slots, max_len=max_len,
                     seed=0, device=device)
    cfg = spec.model_config()
    if layers is None:
        def make_engine(s):
            return build_serve(s).engine
    else:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        param_gen = torch.Generator(device)
        param_gen.manual_seed(spec.seed)
        params = T.init_params(param_gen, cfg)
        say(phase, f"{cfg.name} cut to {layers} of "
            f"{spec.model_config().num_layers} layers: "
            f"{sum(t.numel() for t in leaves(params)) / 1e9:.2f} B params, "
            f"{sum(t.nbytes for t in leaves(params)) / 1e9:.2f} GB")

        def make_engine(s):
            return ServeEngine(params, cfg, slots=s.slots, max_len=s.max_len,
                               pages=s.pages, page_size=s.page_size,
                               seed=s.seed, device=s.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(P)), gen)
            for i, P in enumerate(rng.choice(lens, n_req))]
    want = serve_launches(cfg, len(reqs))
    pages = slots * -(-max_len // page_size)
    launches, tokens = {}, None
    for paged in (False, True):
        s = dataclasses.replace(spec, pages=pages if paged else 0,
                                page_size=page_size)
        engine = make_engine(s)
        results, dt, n, peak, cache = serve_run(engine, reqs, min(lens))
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
            elif cfg.mamba is not None:
                jamba_split(engine, phase, max(lens), gen)
            elif cfg.moe is not None:
                moe_split(engine, phase, max(lens), gen)
            else:
                profile("dense run", lambda: engine.serve(list(reqs)), 6)
        # the next build holds a second copy of the weights: this one
        # must be gone (61 GB of qwen3-moe twice would not fit)
        del engine
        gc.collect()
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


class _Mark(torch.autograd.Function):
    """Identity on its tensors; when autograd's backward pass reaches it,
    it synchronizes the card and calls ``hook()``. A missing cotangent
    stays missing (nothing is pushed into a branch the pass skips)."""

    @staticmethod
    def forward(ctx, hook, *xs):
        ctx.hook = hook
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        torch.cuda.synchronize()
        ctx.hook()
        return (None,) + grads


@contextlib.contextmanager
def synced_calls(module, name, backward=False):
    """While open, each call of ``module.<name>`` starts and ends
    synchronized, and the dict it yields sums their host seconds
    (``seconds``), counts them (``calls``) and keeps the first one's
    (args, kwargs) (``first``). ``backward=True``, for a function
    ``(params, x, ...)`` under autograd: each backward pass through a
    call starts and ends synchronized too, from autograd reaching its
    outputs to its input x (``bwd_seconds``, ``bwd_calls``; nothing else
    runs in between, as autograd takes the ready node created last
    first), and ``first`` keeps the call with the largest x."""
    spent = {"seconds": 0.0, "calls": 0, "bwd_seconds": 0.0,
             "bwd_calls": 0, "first": None}
    orig = getattr(module, name)

    def call(*args, **kw):
        if spent["first"] is None or (
                backward and args[1].numel() > spent["first"][0][1].numel()):
            spent["first"] = (args, kw)
        marks = (backward and torch.is_grad_enabled()
                 and args[1].requires_grad)
        t = {}
        if marks:
            def end():
                if "t0" in t:
                    spent["bwd_seconds"] += time.perf_counter() - t.pop("t0")
                    spent["bwd_calls"] += 1

            args = (args[0],) + _Mark.apply(end, args[1]) + args[2:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        spent["seconds"] += time.perf_counter() - t0
        spent["calls"] += 1
        if marks:
            def start():
                t["t0"] = time.perf_counter()

            outs = list(out) if isinstance(out, tuple) else [out]
            idx = [i for i, o in enumerate(outs)
                   if isinstance(o, torch.Tensor) and o.requires_grad]
            for i, o in zip(idx, _Mark.apply(start, *[outs[i] for i in idx])):
                outs[i] = o
            out = tuple(outs) if isinstance(out, tuple) else outs[0]
        return out

    setattr(module, name, call)
    try:
        yield spent
    finally:
        setattr(module, name, orig)


def busy_ms(fn, reps=5):
    """The card's busy time a call of ``fn`` (the sum of its kernels'
    times in a device-only profile of ``reps`` calls, after one)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return 1e3 * sum(t for t, _ in device_events(prof).values()) / reps


def timed_ms(fn):
    """Host milliseconds of ``fn()``, synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def component_split(phase, what, run, parts, wall_ms=None):
    """Where ``run()`` (host ms) spends its time: it runs as it is (unless
    ``wall_ms`` gives that time), then again with every call of each
    (label, module, function name, calls expected[, backward passes
    expected]) in ``parts`` synchronized before and after and timed
    (:func:`synced_calls`; with backward passes given, each backward pass
    through the function too), the rest the difference; each part's
    device time from its first call (the largest, with backward passes)
    replayed on its inputs under a device-only profile, forward and
    backward apart. Returns each part's first (args, kwargs)."""
    wall = run() if wall_ms is None else wall_ms
    with contextlib.ExitStack() as stack:
        spent = [stack.enter_context(synced_calls(
            part[1], part[2], backward=len(part) > 4)) for part in parts]
        synced = run()
    rest, text = synced, []
    for (label, module, name, layers, *bwd), sp in zip(parts, spent):
        check(sp["calls"] == layers, f"{layers} {name} calls, "
              f"{sp['calls']} seen")
        ms = 1e3 * sp["seconds"]
        rest -= ms
        args, kw = sp["first"]
        fn = getattr(module, name)
        dev = busy_ms(lambda: fn(*args, **kw))
        line = (f"{layers} x {label} {ms:.2f} ms ({100 * ms / synced:.1f}%; "
                f"a call {ms / layers:.3f} ms host, {dev:.3f} ms device)")
        if bwd:
            check(sp["bwd_calls"] == bwd[0], f"{bwd[0]} backward passes "
                  f"through {name}, {sp['bwd_calls']} seen")
            bms = 1e3 * sp["bwd_seconds"]
            rest -= bms
            line += (f", backward {bwd[0]} passes {bms:.2f} ms "
                     f"({100 * bms / synced:.1f}%; the largest call's "
                     f"{replay_bwd_ms(fn, args, kw):.3f} ms device)")
        text.append(line)
    say(phase, f"{what}: {wall:.2f} ms host; with each part's calls "
        f"synchronized {synced:.2f} ms: " + "; ".join(text)
        + f"; the rest {rest:.2f} ms")
    return [sp["first"] for sp in spent]


def replay_bwd_ms(fn, args, kw):
    """The card's busy ms of one backward pass through ``fn(*args,
    **kw)`` (params, x, ...), rebuilt on the same inputs: the gradients of
    its outputs (cotangents of ones) with respect to x and every param
    leaf that takes one."""
    from repro_torch.tree import leaves

    params, x = args[0], args[1].detach().requires_grad_()
    with torch.enable_grad():
        out = fn(params, x, *args[2:], **kw)
        outs = [o for o in (out if isinstance(out, tuple) else (out,))
                if isinstance(o, torch.Tensor) and o.requires_grad]
        inputs = [x] + [p for p in leaves(params) if p.requires_grad]
        cots = [torch.ones_like(o) for o in outs]
        return busy_ms(lambda: torch.autograd.grad(
            outs, inputs, cots, retain_graph=True, allow_unused=True))


def busy_admits(engine, P, gen):
    """``engine.slots`` requests of ``P`` random tokens and ``gen`` new
    ones each, for an engine whose slots are all free."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(7)
    return iter([Request(-100 - i, rng.integers(0, engine.cfg.vocab_size, P),
                         gen) for i in range(engine.slots)])


def fill_slots(engine, admits):
    """Admit the rest of ``admits`` (every slot busy), then one step."""
    for r in admits:
        check(engine.admit(r), "a free slot for the decode split")
    check(engine.n_active == engine.slots, "every slot busy")
    engine.step()


def moe_split(engine, phase, P, gen):
    """Where an MoE admit and decode step spend their time: one admit of
    a ``P``-token prompt into the idle engine and one decode step with
    every slot busy, each split by :func:`component_split` into the MoE
    FFN (routing, dispatch, the expert products, combine), attention and
    the rest (embedding, norms, head, cache copy). A profile of the
    decode step follows."""
    from repro_torch.models.layers import attention, moe

    cfg = engine.cfg
    n_moe = sum(s.ffn == "moe" for s in cfg.block_specs)
    n_attn = sum(s.mixer == "attn" for s in cfg.block_specs)
    admits = busy_admits(engine, P, gen)
    (params, x, moe_cfg), _ = component_split(
        phase, f"admit of a {P}-token prompt",
        lambda: timed_ms(lambda: check(engine.admit(next(admits)),
                                       "a free slot for the split admit")),
        [(f"MoE FFN (dropless, {P * cfg.moe.top_k} pairs)", moe,
          "moe_apply", n_moe),
         ("attention (K3)", attention, "attn_apply", n_attn)])[0]
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    _, _, top_i = moe.route(params, x, moe_cfg.moe)
    busiest = int(torch.bincount(top_i.flatten(), minlength=E).max())
    say(phase, f"layer 0's prefill slab: {E} experts x {busiest} rows (its "
        f"busiest expert's pairs) for {P * K} pairs, {E * busiest / (P * K):.2f}"
        f"x the rows an even routing ({P * K / E:.1f} an expert) would take")
    fill_slots(engine, admits)
    # a replayed attn_decode writes its k, v rows again at the same index:
    # the engine's cache holds the same values after it
    component_split(
        phase, f"decode step with {engine.slots} busy slots",
        lambda: timed_ms(engine.step),
        [(f"MoE FFN ({engine.slots} x {cfg.moe.top_k} pairs)", moe,
          "moe_apply", n_moe),
         ("attention decode", attention, "attn_decode", n_attn)])
    profile(f"decode step, {engine.slots} slots", engine.step, 8)


def jamba_split(engine, phase, P, gen):
    """:func:`moe_split` for a hybrid of mamba, attention, MoE and dense
    FFNs: an admit of a ``P``-token prompt and a decode step with every
    slot busy, each split by mixer and FFN (host and device), then the
    decode step profiled (the device's busy share)."""
    from repro_torch.models.layers import attention, mamba, mlp, moe

    cfg = engine.cfg
    n = {key: sum(getattr(s, attr) == key for s in cfg.block_specs)
         for attr, key in (("mixer", "mamba"), ("mixer", "attn"),
                           ("ffn", "moe"), ("ffn", "dense"))}
    ffns = [(f"MoE FFN ({cfg.moe.num_experts} experts, top-{cfg.moe.top_k})",
             moe, "moe_apply", n["moe"]),
            ("dense FFN", mlp, "mlp_apply", n["dense"])]
    admits = busy_admits(engine, P, gen)
    component_split(
        phase, f"admit of a {P}-token prompt",
        lambda: timed_ms(lambda: check(engine.admit(next(admits)),
                                       "a free slot for the split admit")),
        [("mamba (chunked scan)", mamba, "mamba_prefill", n["mamba"]),
         ("attention (K3)", attention, "attn_apply", n["attn"])] + ffns)
    fill_slots(engine, admits)
    component_split(
        phase, f"decode step with {engine.slots} busy slots",
        lambda: timed_ms(engine.step),
        [("mamba decode", mamba, "mamba_decode", n["mamba"]),
         ("attention decode", attention, "attn_decode", n["attn"])] + ffns)
    profile(f"decode step, {engine.slots} slots", engine.step, 8)


@contextlib.contextmanager
def router_gaps(cfg):
    """While open, every MoE routing appends each token's gap between its
    top_k-th and (top_k+1)-th router logit to the list it yields (nothing
    for an arch without MoE)."""
    from repro_torch.models.layers import moe

    gaps, orig = [], moe.route

    def route(params, x, m):
        top = (x.float() @ params["router"].float()).topk(m.top_k + 1).values
        gaps.extend((top[..., -2] - top[..., -1]).flatten().tolist())
        return orig(params, x, m)

    if cfg.moe is not None:
        moe.route = route
    try:
        yield gaps
    finally:
        moe.route = orig


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
    from repro_torch.tree import leaves

    free_device_memory()
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32",
                              num_layers=layers or cfg.num_layers)
    gen = torch.Generator(device)
    gen.manual_seed(1)
    params = T.init_params(gen, cfg)
    say(phase, f"{cfg.name} float32, {cfg.num_layers} layers: "
        f"{sum(t.nbytes for t in leaves(params)) / 1e9:.2f} GB of params")
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)),
                             device=device)
    with torch.no_grad(), router_gaps(cfg) as gaps:
        logits, cache = T.forward_prefill_cached(
            params, {"tokens": prompt}, cfg, max_len)
        loop = T.init_decode_cache(cfg, 1, max_len, device=device)
        for i in range(prompt_len):
            last, loop = T.decode_step(params, {"tokens": prompt[:, i:i + 1]},
                                       loop, i, cfg)
    if cfg.moe is not None:
        # a near-tie here would let rounding flip an expert between the
        # prefill and the loop: this line, printed before the checks, says
        # how near the nearest came
        K = cfg.moe.top_k
        say(phase, f"smallest gap between a token's router logits {K} "
            f"and {K + 1} (descending) over the {len(gaps)} routings "
            f"checked (prefill and "
            f"loop, {cfg.num_layers} layers x {prompt_len} tokens each): "
            f"{min(gaps):.3g}")
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
    CUDA cores' rate. The work is K6's own (``kernels/mlstm/ops.py:
    work``)."""
    from repro_torch.kernels.mlstm import ops

    w = ops.work(B, S, H, dk, dv, dtype, chunk=chunk)
    t, bound_by = work_bound(w)
    return t * 1e3, bound_by, w.total_flops / PEAK_FLOPS[torch.float32] * 1e3


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
    # once per mLSTM layer of serve-xlstm's depth, in the dense and the
    # paged run
    served = dataclasses.replace(get_config(XLSTM),
                                 num_layers=XLSTM_SERVE_LAYERS)
    layers = sum(s.mixer == "mlstm" for s in served.block_specs)
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


def mlstm_bwd_bound(B, S, H, dk, dv, dtype, state=False,
                    chunk=MLSTM_CHUNK):
    """(ms, 'operations' | 'bytes', f32 ms, flops): the least time for
    K6's backward over these inputs, counting the cheaper of its two
    algorithms' operations (the backward may block the sequence as it
    likes: m cancels in h):
    * chunkwise, chunks of L tokens with the states recomputed: per chunk
      and head, the forward's state rerun (2 L dk dv + 2 L dk, not after
      the last chunk), C0 g (2 L dk dv, not in a first chunk from the zero
      state), dC v and dC^T k (4 L dk dv, not in the last chunk, whose dC
      is zero), the dC and dn update (2 L dk dv + 2 L dk, not in the
      first chunk), the causal pairs' q.k, dP k, dP^T q (dk each) and
      g.v, (S / den)^T g (dv each), and q.n0, q.(C0 g), k.(dC v + dn) (2
      L dk each);
    * all pairs over the whole sequence: the causal pairs' products (2 (3
      dk + 2 dv) a pair) and no state, but for a given initial state its
      C0 g (2 S dk dv) and q.n0, q.(C0 g) and dq's r1 C0 g + r2 n0 (6 S
      dk).
    Each route's time puts its q.k products (dk a pair) at the fastest
    tensor-core rate for q's and k's type (bf16 x bf16 on the bf16 tensor
    cores) and every other product, which has an f32 operand, at TF32's;
    the faster route's time, or one read of q, k, v (in ``dtype``), the
    gates and dh (and the state) and one write of dq, dk, dv and the
    gates' gradients, the larger. The third, for the text only: the
    faster route's operations at the f32 CUDA cores' rate. The work is
    K6's backward's own (``kernels/mlstm/ops.py:work``)."""
    from repro_torch.kernels.mlstm import ops

    w = ops.work(B, S, H, dk, dv, dtype, chunk=chunk, state=state,
                 backward=True)
    t, bound_by = work_bound(w)
    flops = w.total_flops
    return (t * 1e3, bound_by, flops / PEAK_FLOPS[torch.float32] * 1e3,
            flops)


def mlstm_bwd_route(B, S, H, dk, dv, dtype, state=False):
    """(split-TF32 flops, bytes of the pair matrices and the state): what
    K6's backward runs (csrc/mlstm_bwd.cu; its constants read from the
    source). Every product runs whole BM x BN tiles over BK-deep stages,
    as its grid and depth ranges give them (the causal triangle's tiles
    only), each at its term count: 1 for bf16 x bf16, 2 for bf16 x f32, 3
    for f32 x f32 (P = Q K^T, G V^T, dq, dk, dv in each block of LB
    tokens; past one block or from a state the walk's Y = G C^T, the
    state update, dC, U and W). Bytes: each pair matrix element (f32, the
    triangle) written by its product, read and written by the token pass
    and read by its one or two products (P 5 times, G V^T 4), and each
    (dk, dv) f32 state that the walk reads or writes."""
    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "src/repro_torch/kernels/csrc/mlstm_bwd.cu")).read()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                           src)}
    LB, BM, BN, BK = c["LB"], c["BM"], c["BN"], c["BK"]
    f32 = dtype == torch.float32
    t_qkv = 3 if f32 else 1          # q k^T
    t_mix = 3 if f32 else 2          # an f32 operand against q, k or v
    Lp = min(LB, -(-S // 64) * 64)

    def tiles(M, N, K, tri, terms, Lm, Ln, Lk):
        flops = 0
        for m0 in range(0, M, BM):
            for n0 in range(0, N, BN):
                if m0 >= Lm or n0 >= Ln or (tri == 1 and n0 > m0 + BM - 1):
                    continue
                kb = m0 if tri == 3 else 0
                ke = min(Lk, m0 + BM) if tri == 2 else Lk
                flops += 2 * BM * BN * BK * (-(-(ke - kb) // BK)) * terms
        return flops

    nb = -(-S // LB)
    flops = nbytes = 0
    walk = state or nb > 1
    for j in range(nb):
        L = min(LB, S - j * LB)
        flops += (tiles(Lp, Lp, dk, 1, t_qkv, L, L, dk)
                  + tiles(Lp, Lp, dv, 1, t_mix, L, L, dv)
                  + tiles(Lp, dk, Lp, 2, t_mix, L, dk, L)
                  + tiles(Lp, dk, Lp, 3, t_mix, L, dk, L)
                  + tiles(Lp, dv, Lp, 3, 3, L, dv, L))
        nbytes += 9 * 4 * L * (L + 1) // 2
        if walk and (j > 0 or state):           # Y = G C^T
            flops += tiles(Lp, dk, dv, 0, 3, L, dk, dv)
            nbytes += 4 * dk * dv
        if j + 1 < nb:                           # the state update
            flops += tiles(dk, dv, Lp, 0, t_mix, dk, dv, L)
            nbytes += 4 * dk * dv * (2 if j > 0 or state else 1)
        if j > 0:                                # dC, then U, W of j - 1
            flops += (tiles(dk, dv, Lp, 0, 3, dk, dv, L)
                      + tiles(Lp, dk, dv, 0, t_mix, LB, dk, dv)
                      + tiles(Lp, dv, dk, 0, t_mix, LB, dv, dk))
            nbytes += 4 * dk * dv * (4 if j + 1 < nb else 3)
    return B * H * flops, B * H * nbytes


def phase_mlstm_bwd():
    """K6's backward against the plain backward (the same function) and
    against autograd of the plain forward, both on the f32 copies of the
    inputs (an initial state held constant), at the training shapes
    (MLSTM_BWD_CASES); a bitwise repeat; the kernel's time (events, and
    the card's alone), the plain backward's, the bound and the route's
    rate. No PyTorch call computes this function."""
    import torch.nn.functional as F
    from repro_torch.kernels.mlstm import kernel, ref

    gen = torch.Generator("cuda")
    gen.manual_seed(1)
    rows, max_err = {}, 0.0
    for case in MLSTM_BWD_CASES:
        B, S, H, dk, dv, dtype, with_state = case

        def n(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        q, k, v = (x.to(dtype) for x in (n(B, S, H, dk, scale=dk ** -0.5),
                                         n(B, S, H, dk), n(B, S, H, dv)))
        i_raw, f_log = n(B, S, H), F.logsigmoid(n(B, S, H) + 2.0)
        dh = n(B, S, H, dv)
        state = ((n(B, H, dk, dv, scale=0.1), n(B, H, dk, scale=0.1).abs(),
                  n(B, H)) if with_state else None)
        x32 = [q.float(), k.float(), v.float(), i_raw, f_log]

        def run_kernel():
            return kernel.mlstm_chunk_bwd_cuda(q, k, v, i_raw, f_log, dh,
                                               state, chunk=MLSTM_CHUNK)

        def run_plain():
            return ref.mlstm_chunk_bwd_plain(*x32, dh, state,
                                             chunk=MLSTM_CHUNK)

        got = run_kernel()
        sync("cuda")
        want = run_plain()[:5]
        xs = [x.clone().requires_grad_() for x in x32]
        h, _ = ref.mlstm_chunk_plain(*xs, state, chunk=MLSTM_CHUNK)
        auto = torch.autograd.grad((h * dh).sum(), xs)
        del h, xs
        names = ("dq", "dk", "dv", "di", "df")
        # bf16 dq, dk, dv: the f32 sums rounded once to bf16 (half an ulp,
        # 2^-8 of the entry at most, beside the sums' order)
        tols = [MLSTM_RTOL + (2 ** -8 if dtype == BF16 and i < 3 else 0.0)
                for i in range(5)]
        errs = {nm: (rel_err(g, w), rel_err(g, a))
                for nm, g, w, a in zip(names, got, want, auto)}
        max_err = max(max_err, max((g.float() - w).abs().max().item()
                                   for g, w in zip(got, want)))
        check(all(max(errs[nm]) <= t for nm, t in zip(names, tols)),
              f"K6 backward vs plain / autograd {case}: {errs} > {tols}")
        check(all(g.dtype == (dtype if i < 3 else F32)
                  for i, g in enumerate(got)), f"K6 backward dtypes {case}")
        again = run_kernel()
        sync("cuda")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K6 backward repeat bitwise {case}")
        del got, want, auto, again
        ms = time_ms(run_kernel, iters=5, warmup=1)
        dev_ms = device_ms(run_kernel, iters=5)
        plain_ms = time_ms(run_plain, iters=2, warmup=1)
        bound_ms, bound_by, f32_ms, flops = mlstm_bwd_bound(
            B, S, H, dk, dv, dtype, with_state)
        route, nbytes = mlstm_bwd_route(B, S, H, dk, dv, dtype, with_state)
        rows[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by,
                          device_ms=dev_ms)
        say("kernels", f"mlstm_chunk_bwd B={B} S={S} H={H} dk={dk} dv={dv} "
            f"L={MLSTM_CHUNK} q/k/v {str(dtype)[6:]}"
            + (", from a constant state" if with_state else "")
            + ": over the largest entry (vs plain, vs autograd) "
            + ", ".join(f"{nm} {a:.3g}/{b:.3g}" for nm, (a, b)
                        in errs.items())
            + f" (tol {tols[0]:.3g} dq/dk/dv, {tols[3]:.3g} di/df); repeat "
            f"bitwise; kernel={ms:.3f} ms device={dev_ms:.3f} ms "
            f"plain={plain_ms:.3f} ms bound={bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.1f} GFLOP, {flops / dev_ms / 1e9:.1f} TFLOP/s of "
            f"it; f32 CUDA cores {f32_ms:.3f}); route {route / 1e9:.1f} "
            f"GFLOP of split products, {route / dev_ms / 1e9:.1f} TFLOP/s; "
            f"pair matrices and states {nbytes / 1e6:.0f} MB, "
            f"{nbytes / dev_ms / 1e9:.2f} TB/s")
        if case == MLSTM_BWD_REPORT:
            # bound now: run_kernel reads the loop's names when it runs
            report = functools.partial(
                kernel.mlstm_chunk_bwd_cuda, q, k, v, i_raw, f_log, dh,
                state, chunk=MLSTM_CHUNK)
    profile(f"K6 backward at B, S = {MLSTM_BWD_REPORT[:2]}, q/k/v bf16",
            report, 12)
    return rows, max_err


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (at least 1e-30)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def phase_flash_bwd(cases=FLASH_BWD_CASES):
    """The attention backward kernel against autograd of the plain
    version; ``library_ms`` is SDPA's backward alone, timed through
    autograd with the graph kept (the forward outside the timed
    region)."""
    from repro_torch.kernels.flash_attn import kernel, ops, ref
    import torch.nn.functional as F

    gen = torch.Generator("cuda")
    gen.manual_seed(1)
    rows, max_err = {}, 0.0
    for case in cases:
        B, P, H, KV, window, dtype, hd = case
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
        # S, dP, dV, dK, dQ: 5 products; read q, o, dO, k, v and lse,
        # write dq, dk, dv (K3's backward's work)
        t, bound_by = work_bound(ops.work(B, P, H, KV, hd, dtype,
                                          window=window, backward=True))
        rows[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=t * 1e3, bound_by=bound_by,
                          device_ms=dev_ms, library_device_ms=lib_dev_ms)
        say("kernels", f"flash_attn_bwd B={B} P={P} H={H} KV={KV} hd={hd} "
            f"window={window} {str(dtype)[6:]}: rel err dq/dk/dv "
            f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (tol {tol}; two "
            f"runs bitwise equal) kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"sdpa_bwd={lib_ms:.4f} ms bound={rows[case]['bound_ms']:.4f} "
            f"ms ({rows[case]['bound_by']}); device: kernel={dev_ms:.4f} ms "
            f"sdpa_bwd={lib_dev_ms:.4f} ms")
    return rows, max_err


def lace_inputs(N, dtype, tau, G=LACE_CLIENTS, absent=0, w_dtype=F32,
                d=1024, V=151936, raw=False):
    """Boundary inputs at the training width, from a seeded generator:
    feats (N, d), w_head (d, V) in ``w_dtype`` (bf16: the same draws
    rounded), labels, the two sides' prior tables and per-token client
    ids, and the per-token scale weight / sum (``raw``: the weight alone,
    the raw-sum mode ``mean=False``). The last ``absent`` of the G
    clients are masked out, as a masked round gives them: every token
    weight 0 and the uniform prior row."""
    from repro_torch.kernels.lace import ops

    gen = torch.Generator("cuda")
    gen.manual_seed(N)
    feats = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d, V), generator=gen, device="cuda")
         * d ** -0.5).to(w_dtype)
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    cid = (torch.arange(N, device="cuda") * G // N)
    weights = torch.ones(N, device="cuda")
    for c in range(G):            # the last eighth of each client: weight 0
        rows = (cid == c).nonzero()[:, 0]
        weights[rows[-(len(rows) // 8):]] = 0.0
    weights[cid >= G - absent] = 0.0
    p = torch.rand((1 + G, V), generator=gen, device="cuda") ** 4
    p[1:, : V // 10] = 0.0        # classes a client never saw
    p = p / p.sum(-1, keepdim=True)
    if absent:
        p[1 + G - absent:] = 1.0 / V
    adj_s, _ = ops._side_table(p[:1], None, tau, 1e-8, 1, N)
    adj_k = (tau * torch.log(p[1:] + 1e-8)).contiguous()
    ts = (weights if raw else weights / weights.sum()).contiguous()
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


def lace_bounds(N, d, V, passes, work):
    """The bound of a LACE kernel whose function is ``passes``, one
    (a dtype, b dtype) pair per 2 N d V product (z = feats W, df = g W^T
    per side, dW = feats^T g; g is f32), and whose ``work`` is
    ``kernels/lace/ops.py:work``'s: ``bound_ms``, each pass once at the
    fastest tensor-core rate for its operands (a bf16 x bf16 pass at the
    bf16 rate), or the bytes at HBM's rate, the larger. For the text only
    (not bounds of the function): ``tf32_ms``, every pass once at TF32's
    rate (the bound of a kernel that keeps all its products on the TF32
    tensor cores); ``route_ms``, the split-TF32 products the kernels run
    at TF32's rate; and ``f32_ms``, the passes at the CUDA cores' f32
    rate."""
    flops = 2 * N * d * V
    t, bound_by = work_bound(work)
    products = sum(split_products(a, b) for a, b in passes)
    return dict(bound_ms=t * 1e3, bound_by=bound_by,
                tf32_ms=len(passes) * flops / PEAK_FLOPS["tf32"] * 1e3,
                route_products=products,
                route_ms=products * flops / PEAK_FLOPS["tf32"] * 1e3,
                f32_ms=len(passes) * flops / PEAK_FLOPS[torch.float32] * 1e3)


def bounds_text(r):
    return (f"bound {r['bound_ms']:.2f} ({r['bound_by']}); all passes at "
            f"TF32 {r['tf32_ms']:.2f}; route {r['route_products']} "
            f"split-TF32 products {r['route_ms']:.2f}; f32 CUDA cores "
            f"{r['f32_ms']:.2f}")


def phase_lace(cases=LACE_CASES + [LACE_XLSTM, LACE_MOE, LACE_WHISPER,
                                   LACE_VLM, LACE_RAW]):
    """K1 and K2 against their plain versions (same arguments, chunked
    logits); ``library_ms`` is the one cuBLAS product feats @ W in
    float32, a yardstick only (no PyTorch call computes the fused
    boundary). A case is (N, feats dtype, tau, G, absent, head dtype[, d,
    V]), d 1024 and V 151936 (qwen1.5-0.5b) unless it says."""
    from repro_torch.kernels.lace import kernel, ref
    from repro_torch.kernels.lace import ops as lops

    rows, errs = {}, {"fwd": 0.0, "bwd": 0.0}
    for case in cases:
        N, dtype, tau, G, absent, w_dtype, *dV = case
        args, weights, ts = lace_inputs(N, dtype, tau, G, absent, w_dtype,
                                        *dV, raw=case == LACE_RAW)
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
        f32, w32 = feats.float(), w.float()
        times = {name: time_ms(fn, iters=3, warmup=1) for name, fn in (
            ("fwd", lambda: kernel.lace2_fwd_cuda(*args)),
            ("fwd_plain", lambda: ref.lace2_fwd_plain(*args)),
            ("bwd", lambda: kernel.lace2_bwd_cuda(*bargs)),
            ("bwd_plain", lambda: ref.lace2_bwd_plain(*bargs)),
            ("library", lambda: f32 @ w32))}
        G = args[5].shape[0]
        z, df, dw = lace_passes(feats.dtype, w.dtype)
        for kind, name, passes in (("fwd", "K1", [z]),
                                   ("bwd", "K2", [z, df, df, dw])):
            # one server prior row and G client rows, the client ids
            work = lops.work(name, N, d, V, feats.dtype, w.dtype,
                             table_rows=1 + G, id_arrays=1)
            rows[(case, kind)] = dict(
                ms=times[kind], plain_ms=times[kind + "_plain"],
                library_ms=times["library"],
                **lace_bounds(N, d, V, passes, work))
        say("kernels", f"lace2 N={N} d={d} V={V} feats {str(dtype)[6:]} "
            f"head {str(w_dtype)[6:]} tau={tau}"
            f"{' raw sums (mean=False)' if case == LACE_RAW else ''}, "
            f"{G} client prior rows "
            f"({absent} absent): rel err "
            f"nll_s/nll_k/lse_s/lse_k "
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
        if case in (LACE_REPORT, LACE_BF16_HEAD, LACE_XLSTM, LACE_MOE,
                    LACE_WHISPER, LACE_VLM, LACE_RAW):
            same = [torch.equal(a, b) for a, b in zip(
                got + gb, kernel.lace2_fwd_cuda(*args)
                + kernel.lace2_bwd_cuda(*bargs))]
            check(all(same), f"K1/K2 repeat bitwise {case}: nll_s, nll_k, "
                  f"lse_s, lse_k, df_s, df_k, dW_s equal {same}")
            say("kernels", f"K1, K2 repeat at N={N}, head "
                f"{str(w_dtype)[6:]}: bitwise equal")
    return rows, errs


def boundary_launches(boundary):
    """The boundary's launches in one step: K1 + K2 once (fused), or K4 +
    K5 once per prior (dual: eq. 14, then eq. 15)."""
    fused = boundary == "fused"
    return dict(lace_fwd=int(fused), lace_bwd=int(fused),
                lace1_fwd=0 if fused else 2, lace1_bwd=0 if fused else 2)


def lace1_inputs(N, dtype, side, w_dtype=F32, d=1024, V=151936,
                 G=LACE_CLIENTS, raw=False):
    """One side of the dual boundary at the training width, from a seeded
    generator: feats (N, d), w_head (d, V) in ``w_dtype``, int32 labels,
    the side's prior table and per-token client ids (server: one
    concatenated row, no ids; client: G rows), and the per-token scale
    weight / sum (``raw``: the weight, as :func:`lace_inputs`)."""
    args, weights, ts = lace_inputs(N, dtype, 1.0, G, w_dtype=w_dtype, d=d,
                                    V=V, raw=raw)
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
    from repro_torch.kernels.lace import ops as lops

    rows, errs = {}, {"fwd": 0.0, "bwd": 0.0}
    for case in LACE1_CASES:
        N, dtype, side, w_dtype, *raw = case
        args, weights, ts = lace1_inputs(
            N, dtype, side, w_dtype, G=8 if raw else LACE_CLIENTS,
            raw=bool(raw))
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
        f32, w32 = feats.float(), w.float()
        times = {name: time_ms(fn, iters=3, warmup=1) for name, fn in (
            ("fwd", lambda: kernel.lace_fwd_cuda(*args)),
            ("fwd_plain", lambda: ref.lace_fwd_plain(*args)),
            ("bwd", lambda: kernel.lace_bwd_cuda(*bargs)),
            ("bwd_plain", lambda: ref.lace_bwd_plain(*bargs)),
            ("library", lambda: f32 @ w32))}
        z, df, dw = lace_passes(feats.dtype, w.dtype)
        for kind, name, passes in (("fwd", "K4", [z]),
                                   ("bwd", "K5", [z, df] + [dw] * want_dw)):
            work = lops.work(name, N, d, V, feats.dtype, w.dtype,
                             table_rows=adj.shape[0],
                             id_arrays=int(ids is not None), want_dw=want_dw)
            rows[(case, kind)] = dict(
                ms=times[kind], plain_ms=times[kind + "_plain"],
                library_ms=times["library"],
                **lace_bounds(N, d, V, passes, work))
        say("kernels", f"lace {side} side N={N} d={d} V={V} rows="
            f"{adj.shape[0]}{' raw sums (mean=False)' if raw else ''} "
            f"feats {str(dtype)[6:]} head "
            f"{str(w_dtype)[6:]}: rel err nll/lse "
            f"{'/'.join(f'{e:.3g}' for e in e_fwds)} (tol 1e-4), df"
            f"{'/dW' if want_dw else ''} "
            f"{'/'.join(f'{e:.3g}' for e in e_bwds)} (tol 1e-5); K4 "
            f"{times['fwd']:.2f} ms (plain {times['fwd_plain']:.2f}, "
            f"{bounds_text(rows[(case, 'fwd')])}); K5 {times['bwd']:.2f} ms "
            f"(plain {times['bwd_plain']:.2f}, "
            f"{bounds_text(rows[(case, 'bwd')])}); cuBLAS feats@W "
            f"{times['library']:.2f} ms")
        if case in (*LACE1_REPORT.values(), *LACE1_BF16_HEAD.values(),
                    *LACE1_RAW.values()):
            again = (kernel.lace_fwd_cuda(*args)
                     + kernel.lace_bwd_cuda(*bargs))
            same = [torch.equal(a, b) for a, b in zip(got + gb, again)
                    if b is not None]
            check(all(same), f"K4/K5 repeat bitwise {case}: nll, lse, df"
                  f"{', dW' if want_dw else ''} equal {same}")
            say("kernels", f"K4, K5 {side} side repeat at N={N}, head "
                f"{str(w_dtype)[6:]}: bitwise equal")
    return rows, errs


def participants(spec):
    """The client slots that take part in a round: the scheduler's subset
    size, an async event's cohort, or every stacked slot without a
    scheduler (subset mode)."""
    if spec.execution.mode == "async":
        return spec.execution.resolve_cohort(spec.slots)
    if spec.fed.participation is None:
        return spec.slots
    return spec.fed.make_participation(spec.slots).subset_size


def compute_slots(spec):
    """The client slots a local step computes: every stacked slot (subset,
    masked), or the gathered subset (sparse) or arrival cohort (async;
    a deadline masks late arrivals out but still computes them)."""
    if spec.execution.mode in ("sparse", "async"):
        return participants(spec)
    return spec.slots


def participating_tokens(spec):
    """Training tokens of the participating clients in one round: T x
    :func:`participants` x a slot's mean eq. 3 rows x seq. The scheduler
    draws the participants anew each round; the mean is any slot's rows
    where every slot holds the same documents, as lm_synthetic's do."""
    from repro_torch.core.split import client_minibatch_sizes

    sc = spec.scala
    bk = client_minibatch_sizes(np.full(spec.slots, spec.data.docs_per_client),
                                sc.server_batch)
    return round(sc.local_iters * participants(spec) * float(bk.mean())
                 * spec.data.seq)


def train_launches(spec, cfg):
    """:func:`slot_launches` of ``spec``'s computed slots and boundary."""
    return slot_launches(compute_slots(spec), cfg, spec.execution.boundary)


def slot_launches(slots, cfg, boundary="fused"):
    """Kernel launches one local step makes, from the layout: every
    computed client slot runs the client blocks once forward and pulls
    them back once; the server trunk runs once forward and is pulled back
    twice (the P_s cotangent for w_s, the P_k one for the activations);
    where the server's scan groups are rematerialized (the recurrent
    archs, ``models.transformer.default_remat``) each pullback reruns
    their forward, so a grouped layer launches its forward three times a
    step (the prologue's layers once); the boundary's launches
    (:func:`boundary_launches`)."""
    from repro_torch.models.transformer import _layout, default_remat

    _, prologue, first, n_groups = _layout(cfg)
    grouped = range(first, first + n_groups * cfg.group_size)

    def count(mixer, layers):
        # a cross-attention sublayer runs K3 as an attention mixer does
        return sum((s.mixer == mixer) + (mixer == "attn" and s.cross_attn)
                   for s in map(cfg.block_spec, layers))

    out = {}
    for mixer, fwd, bwd in (("attn", "flash_fwd", "flash_bwd"),
                            ("mlstm", "mlstm", "mlstm_bwd")):
        n_client = count(mixer, range(cfg.split_layer))
        n_pro, n_grp = count(mixer, prologue), count(mixer, grouped)
        reruns = 3 if default_remat(cfg) else 1
        out[fwd] = slots * n_client + n_pro + reruns * n_grp
        out[bwd] = slots * n_client + 2 * (n_pro + n_grp)
    return dict(out, **boundary_launches(boundary))


def read_counts():
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.lace import ops as lops
    from repro_torch.kernels.mlstm import ops as mops
    return dict(flash_fwd=fops.LAUNCHES, flash_bwd=fops.LAUNCHES_BWD,
                lace_fwd=lops.LAUNCHES_FWD, lace_bwd=lops.LAUNCHES_BWD,
                lace1_fwd=lops.LAUNCHES_FWD1, lace1_bwd=lops.LAUNCHES_BWD1,
                mlstm=mops.LAUNCHES, mlstm_bwd=mops.LAUNCHES_BWD)


def read_counts_raw():
    """:func:`read_counts`, plus ``raw_*``: the LACE launches with
    ``mean=False`` (the ``lace_dp`` boundary's raw sums), a subset of
    ``lace_*`` / ``lace1_*``."""
    from repro_torch.kernels.lace import ops as lops

    raw = lops.LAUNCHES_RAW
    return dict(read_counts(), raw_lace_fwd=raw["K1"],
                raw_lace_bwd=raw["K2"], raw_lace1_fwd=raw["K4"],
                raw_lace1_bwd=raw["K5"])


def zero_counts():
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.lace import ops as lops
    from repro_torch.kernels.mlstm import ops as mops
    fops.LAUNCHES = fops.LAUNCHES_BWD = 0
    lops.LAUNCHES_FWD = lops.LAUNCHES_BWD = 0
    lops.LAUNCHES_FWD1 = lops.LAUNCHES_BWD1 = 0
    for key in lops.LAUNCHES_RAW:
        lops.LAUNCHES_RAW[key] = 0
    mops.LAUNCHES = mops.LAUNCHES_BWD = 0


TRAIN_WATCH = [("LACE forward (K1/K4)", "lace_fwd"),
               ("LACE backward (K2/K5)", ("lace_grad", "lace_gemm")),
               ("K3 backward", "flash_bwd"), ("K3 forward", "flash_fwd")]


def phase_train(device="cuda", flags=TRAIN_FLAGS, profile_round=True,
                phase="train", on_done=None, watch=TRAIN_WATCH):
    """Full-width training through the CLI's spec and the Trainer: the
    kernels' launches per round (an async event) against
    :func:`train_launches`, finite losses, round seconds (rounds 2 on;
    round 1 includes warm-up), tokens/s, peak memory, and a profiled extra
    round (``watch``: the kernel groups whose shares it prints). Every
    launch count is set to 0 at the start; returns the counts of the
    measured rounds (the profiled round not included). ``on_done(trainer)``
    runs after the measured rounds."""
    from repro_torch import api
    from repro_torch.launch import train

    spec = train.spec_from_args(train.build_parser().parse_args(flags))
    spec.validate()
    cfg = spec.model_config()
    t0 = time.perf_counter()
    trainer = api.Trainer(spec, device=device)
    sync(device)
    say(phase, f"{cfg.name} ({cfg.num_layers} layers) {cfg.dtype} compute, "
        f"{cfg.param_dtype} params: "
        f"{spec.scala.num_clients} clients, mode {spec.execution.mode} "
        f"({spec.slots} slots, {compute_slots(spec)} computed, "
        f"participation {spec.fed.participation or spec.scala.participation}"
        f"), {spec.scala.local_iters} local steps of "
        f"{spec.scala.server_batch} x {spec.data.seq} tokens, boundary "
        f"{spec.execution.boundary}, aggregator {spec.fed.aggregator}, "
        f"optimizer {spec.optim.name}, server optimizer "
        f"{spec.execution.server_optimizer and spec.execution.server_optimizer.spec}"
        f"; built in {time.perf_counter() - t0:.1f} s")
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
        # a guarded round that rejected someone runs its local phase twice
        passes = 2 if m.get("guard_rejected", 0.0) > 0 else 1
        if torch.device(device).type == "cuda":
            want = {k: passes * T * n for k, n in per_step.items()}
            check(got == want, f"round {r} launches {got} != {want} "
                  f"({passes} pass(es) x {T} steps x {per_step})")
        extra = ""
        if "t_event" in m:
            extra = (f" t={m['t_event']:.3f} staleness_mean="
                     f"{m['staleness_mean']:.3f} server_version="
                     f"{m['server_version']:.0f}" + (
                         f" deadline_missed={m['deadline_missed']:.0f}"
                         if "deadline_missed" in m else ""))
        if "guard_rejected" in m:
            extra += (f" guard_rejected={m['guard_rejected']:.0f}"
                      f" passes={passes}")
        say(phase, f"round {r} loss_s={m['loss_server']:.4f} "
            f"loss_c={m['loss_client']:.4f}{extra} in {secs[-1]:.3f} s; "
            f"launches "
            f"K3 fwd {got['flash_fwd']} bwd {got['flash_bwd']}, K1 "
            f"{got['lace_fwd']}, K2 {got['lace_bwd']}, K4 "
            f"{got['lace1_fwd']}, K5 {got['lace1_bwd']}, K6 fwd "
            f"{got['mlstm']} bwd {got['mlstm_bwd']}")
    counts = read_counts()
    steady = secs[1:] or secs
    round_s = float(np.mean(steady))
    tokens = participating_tokens(spec)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    say(phase, f"round seconds (rounds 1..{len(secs) - 1}, round 0 has "
        f"the warm-up): {[round(x, 3) for x in steady]}, mean "
        f"{round_s:.3f} s -> {tokens / round_s:.0f} training tokens/s "
        f"({tokens} participating tokens a round); "
        f"round 0 {secs[0]:.3f} s; peak {peak / 2**20:.0f} MiB allocated; "
        f"per step: {per_step}")
    if on_done is not None:
        on_done(trainer)
    if profile_round and torch.device(device).type == "cuda":
        profile(f"training round ({spec.execution.boundary} boundary)",
                trainer.step, 8, watch=watch)
    return counts


XLSTM_TRAIN_FLAGS = ["--arch", XLSTM] + TRAIN_FLAGS[2:]
# phase 17's depth since the MoE training phases joined the run: 16 of
# xlstm-1.3b's 48 layers, two periods of its 7:1 pattern (14 mLSTM, the
# sLSTM layers 3 and 11; the prologue 2-7 and one rematerialized scan
# group 8-15), to keep the script within its time limit: the sLSTM
# loops' host time is most of a round (13.5-18.3 s of ~18 at 48 layers)
XLSTM_TRAIN_LAYERS = 16


@contextlib.contextmanager
def depth_cut(layers):
    """While open, every ``ExperimentSpec``'s model config is cut to its
    first ``layers`` layers (a spec has no depth of its own), so the
    Trainer and :func:`phase_train`'s launch counts see the cut model."""
    from repro_torch.api import specs

    orig = specs.ExperimentSpec.model_config

    def cut(self):
        cfg = orig(self)
        return dataclasses.replace(cfg, num_layers=min(layers,
                                                       cfg.num_layers))

    specs.ExperimentSpec.model_config = cut
    try:
        yield
    finally:
        specs.ExperimentSpec.model_config = orig
XLSTM_WATCH = [("K6 forward", ("mlstm_gate", "mlstm_scores", "mlstm_decay",
                               "mlstm_state")),
               ("K6 backward", "mlstm_bwd"),
               ("LACE forward (K1)", "lace_fwd"),
               ("LACE backward (K2)", ("lace_grad", "lace_gemm"))]


def phase_train_xlstm(device="cuda", flags=XLSTM_TRAIN_FLAGS,
                      profile_round=True, layers=XLSTM_TRAIN_LAYERS):
    """Phase 17: phase 6's cell on xlstm-1.3b at full width, its depth
    cut to ``layers`` (:func:`depth_cut`), through :func:`phase_train` --
    the launches per round against the
    layout (K6 forward and backward, the rematerialized groups' reruns,
    K1, K2; K3 none), finite losses, round seconds, tokens/s, peak
    memory, then a profiled round (device events only: a round launches
    about a million kernels) split into K6 forward (the backward's own
    gate pass, a few microseconds, counts here too), K6 backward and
    LACE -- with the host seconds of the sLSTM layers' forward loops (the
    reruns included) and of their backward loops
    (``xlstm.SLSTMScan.backward``)."""
    from repro_torch.models.layers import xlstm

    spent = {"forward": [], "backward": []}
    orig = xlstm.slstm_scan, xlstm.SLSTMScan.backward

    def timed(kind, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            spent[kind].append(time.perf_counter() - t0)
            return out
        return run

    def report(trainer):
        rounds = trainer.spec.rounds
        say("train-xlstm", "sLSTM loops over the rounds, host seconds: "
            + "; ".join(f"{kind} {len(v)} calls, {sum(v):.3f} s "
                        f"({sum(v) / rounds:.3f} s a round)"
                        for kind, v in spent.items()))

    xlstm.slstm_scan = timed("forward", orig[0])
    xlstm.SLSTMScan.backward = staticmethod(timed("backward", orig[1]))
    try:
        with depth_cut(layers):
            return phase_train(device, flags, profile_round=profile_round,
                               phase="train-xlstm", on_done=report,
                               watch=XLSTM_WATCH)
    finally:
        xlstm.slstm_scan = orig[0]
        xlstm.SLSTMScan.backward = staticmethod(orig[1])


def phase_train_check(device="cuda", reduced=False, C=2, S=64, T=2,
                      arch=ARCH, layers=None, phase="train-check"):
    """float32 at full width, TF32 off: one split step and one round on
    ``device`` (the kernels) against the same on the CPU (the plain
    versions), from the same params and batches; ``layers`` cuts the
    depth."""
    from repro_torch.configs import ScalaConfig, get_config
    from repro_torch.core import engine
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import transformer as Tm
    from repro_torch.optim import optimizers
    from repro_torch.tree import leaves, tree_map

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32",
                              num_layers=layers or cfg.num_layers)
    gen = torch.Generator(device)
    gen.manual_seed(2)
    full = Tm.init_params(gen, cfg)
    params = {"client": stack_client_params(full["client"], C),
              "server": full["server"]}
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (T, C, 1, S + 1))
    batches = frontend_batch(cfg, rng, {
        "tokens": toks[..., :-1], "labels": toks[..., 1:],
        "weights": np.ones((T, C, 1, S), np.float32)})
    sizes = np.array([3.0, 1.0][:C], np.float32)
    sc = ScalaConfig(num_clients=C, lr=0.01)
    model = transformer_split_model(cfg)
    copies = {}

    def on(dev):
        # one copy of the params a device: neither the step nor the round
        # (not donated) writes to the params it is given
        if dev not in copies:
            copies[dev] = tree_map(lambda a: a.to(dev), params)
        return (copies[dev],
                {k: torch.from_numpy(v).to(dev) for k, v in batches.items()},
                torch.from_numpy(sizes).to(dev))

    def err(a, b):
        # the card's leaf against the CPU's, on the card (the same
        # arithmetic; the CPU took ~1 s a GB)
        return rel_err(a, b.to(a.device))

    res, gaps = {}, {}
    for dev in (device, "cpu"):
        p, b, _ = on(dev)
        zero_counts()
        t0 = time.perf_counter()
        with router_gaps(cfg) as gaps[dev]:
            res[dev] = engine.split_step_grads(model, p, {k: v[0] for k, v
                                                          in b.items()}, sc)
        sync(dev)
        n = read_counts()
        say(phase, f"split step on {dev}: "
            f"{time.perf_counter() - t0:.2f} s, launches {n}")
        if torch.device(dev).type == "cuda":
            want = slot_launches(C, cfg)
            check(n == want, f"{phase} step launches {n} != {want}")
        del p, b
    if cfg.moe is not None:
        # a near-tie would let rounding send a token to another expert on
        # one device: printed before the checks
        K = cfg.moe.top_k
        say(phase, "smallest gap between a token's router logits "
            f"{K} and {K + 1} (descending) over the step's routings "
            f"({C} clients x {cfg.split_layer} layers, then the server's "
            f"{cfg.num_layers - cfg.split_layer}; {S} tokens a client): "
            + ", ".join(f"{dev} {min(g):.3g}" for dev, g in gaps.items()))
    (g_dev, m_dev), (g_cpu, m_cpu) = res[device], res["cpu"]
    # the router loss is 0 on both devices for the archs without MoE
    for k in ("loss_server", "loss_client", "aux"):
        a, b = float(m_dev[k]), float(m_cpu[k])
        check(abs(a - b) <= LOSS_RTOL * abs(b), f"{k} {a} vs cpu {b}")
    head = err(g_dev["server"]["head"]["out"], g_cpu["server"]["head"]["out"])
    want = state_leaves(g_cpu)
    worst, worst_key = max((err(a, want[key]), key)
                           for key, a in state_leaves(g_dev).items())
    check(head <= LEAF_RTOL and worst <= LEAF_RTOL,
          f"grads: head dW {head}, worst leaf {worst} > {LEAF_RTOL}")
    say(phase, f"{cfg.name} float32 split step, {C} clients x {S} "
        f"tokens, {device} (kernels) vs cpu (plain): loss_s "
        f"{float(m_dev['loss_server']):.6f} vs {float(m_cpu['loss_server']):.6f}, "
        f"loss_c {float(m_dev['loss_client']):.6f} vs "
        f"{float(m_cpu['loss_client']):.6f}, aux {float(m_dev['aux']):.6f} "
        f"vs {float(m_cpu['aux']):.6f} (rtol {LOSS_RTOL}); head dW rel "
        f"err {head:.3g}, worst of {len(leaves(g_cpu))} grad leaves "
        f"{worst:.3g} ({worst_key}; tol {LEAF_RTOL})")
    if cfg.frontend is not None:
        front = {key: err(a, want[key])
                 for key, a in state_leaves(g_dev).items()
                 if "projector" in key or key.endswith("embed/pos")}
        say(phase, f"the frontend's grads (the projector through the "
            f"split's cotangent), rel err (within the {LEAF_RTOL} above): "
            + ", ".join(f"{k} {v:.3g}" for k, v in front.items()))
    if cfg.moe is not None:
        routers = {key: err(a, want[key])
                   for key, a in state_leaves(g_dev).items()
                   if key.endswith("router")}
        say(phase, f"router grads, rel err (within the {LEAF_RTOL} above): "
            + ", ".join(f"{k} {v:.3g}" for k, v in routers.items()))
    del res, g_dev, g_cpu, want

    # the client half, and for an MoE arch the server's routers too
    def kept(params):
        out = leaves(params["client"])
        if cfg.moe is not None:
            out += [a for key, a in state_leaves(params["server"]).items()
                    if key.endswith("router")]
        return out

    new, round_m = {}, {}
    for dev in (device, "cpu"):
        p, b, s = on(dev)
        round_fn = engine.make_round_runner(model, sc)
        t0 = time.perf_counter()
        with router_gaps(cfg) as gaps:
            state, round_m[dev] = round_fn(
                engine.init_train_state(p, optimizers.sgd()), b, s)
        sync(dev)
        say(phase, f"round on {dev}: {time.perf_counter() - t0:.2f} s"
            + (f"; smallest router gap over its {T} steps' routings "
               f"{min(gaps):.3g}" if gaps else ""))
        # each device's leaves stay where they are
        new[dev] = kept(state.params)
        del p, b, state
    for k in ("loss_server", "loss_client", "aux"):
        a, b = float(round_m[device][k]), float(round_m["cpu"][k])
        check(abs(a - b) <= LOSS_RTOL * abs(b), f"round {k} {a} vs cpu {b}")
    # Each device rounds the update p - lr * g, the client weight's product
    # and the weighted sum to float32 on its own (half an ulp each), so
    # the two may land up to three ulps apart where the updates agree:
    # that is allowed, and the rest of the difference is measured against
    # the leaf's largest update. Computed on the card, from the CPU's
    # leaves copied there one at a time.
    ulp = torch.finfo(torch.float32).eps
    worst = 0.0
    for a, b, b0 in zip(new[device], new["cpu"], kept(params)):
        b = b.to(a.device)
        worst = max(worst, ((a - b).abs() - 3 * ulp * b.abs()).clamp(
            min=0).max().item() / max((b - b0).abs().max().item(), 1e-30))
        del b
    check(worst <= LEAF_RTOL, f"round client params: {worst} > {LEAF_RTOL}")
    say(phase, f"one round ({T} steps + FedAvg): aggregated client "
        f"params{' and the server routers' if cfg.moe is not None else ''}, "
        f"{device} vs cpu, worst leaf difference beyond 3 ulps "
        f"{worst:.3g} of the leaf's largest update (tol {LEAF_RTOL}); "
        f"the round's last losses and aux within {LOSS_RTOL}")


def phase_xlstm_train_check(device="cuda", reduced=False):
    """Phase 17b: :func:`phase_train_check` on xlstm-1.3b at full width
    and one period of its layer pattern (8 layers; deeper random stacks
    amplify float32 rounding, phase 5c), 2 clients x 256 tokens (4 chunks
    of 64: the backward's reverse walk crosses chunk boundaries)."""
    phase_train_check(device, reduced, C=2, S=256, arch=XLSTM,
                      layers=XLSTM_CHECK_LAYERS, phase="train-check-xlstm")


# ---------------------------------------------------------------------------
# MoE training: train-moe and check-moe-train
# ---------------------------------------------------------------------------

MOE_TRAIN_FLAGS = ["--arch", MOE] + TRAIN_FLAGS[2:]


@contextlib.contextmanager
def moe_routings():
    """While open, every MoE routing appends (rows G, tokens a row n, the
    top-k expert ids (G, n, K)) to the list it yields."""
    from repro_torch.models.layers import moe

    seen, orig = [], moe.route

    def route(params, x, m):
        out = orig(params, x, m)
        seen.append((x.shape[0], x.shape[1], out[2].detach()))
        return out

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = orig


def slab_rows(seen, m):
    """For each routing of :func:`moe_routings`: (the slab's rows an
    expert as ``moe_apply`` lays them out, whether that is the static
    bound G x min(cap, n) or the exact count read back to the host, the
    kept pairs, the routed pairs)."""
    import torch.nn.functional as F
    from repro_torch.models.layers import moe

    out = []
    for G, n, top_i in seen:
        cap = moe.capacity(n, m)
        bound = G * min(cap, n)
        counts = F.one_hot(top_i.reshape(G, -1), m.num_experts).sum(1)
        kept = counts.clamp(max=cap)
        static = bound <= moe.STATIC_ROWS
        rows = bound if static else max(1, int(kept.sum(0).max()))
        out.append((rows, static, int(kept.sum()), G * n * m.top_k))
    return out


def slab_text(seen, m):
    """The slabs of a list of routings, grouped by (G, n)."""
    groups = {}
    for (G, n, _), r in zip(seen, slab_rows(seen, m)):
        groups.setdefault((G, n), []).append(r)
    return "; ".join(
        f"{len(rs)} routings of {G} rows x {n} tokens: slab rows "
        f"{min(r[0] for r in rs)}-{max(r[0] for r in rs)} an expert "
        f"({'the static bound' if rs[0][1] else 'the exact count, read back'}"
        f"), kept {sum(r[2] for r in rs)} of {sum(r[3] for r in rs)} pairs"
        for (G, n), rs in groups.items())


def update_slice_gb(params):
    """GB of float32 in the largest slice the optimizer's update takes at
    a time (``optim.optimizers._slices``: ~2^26 entries, or one row of
    the first axis where a row holds more, such as a client slot's
    embedding; the client leaves carry the slot axis already)."""
    from repro_torch.optim.optimizers import _slices
    from repro_torch.tree import leaves

    return max(_slices(a)[0].numel() for a in leaves(params)) * 4 / 1e9


def memory_reckoning(cfg, params, slots, rows, seq):
    """The peak a training step should reach, from the params on the card
    and the shapes (printed before the run): the larger of the backward
    pass's -- every slot's client half and the server half, their
    gradients as much, each layer's saved activations at the server's
    ``rows`` rows of ``seq`` (+ an image prefix) tokens at most and the
    boundary's float32 dW -- and the update's: SGD writes bf16 params anew
    (the float32 result is rounded into a new leaf), so params, gradients
    and the new params are live at once, with three float32 temporaries
    of the largest slice the update takes (:func:`update_slice_gb`). A
    layer saves ~8 (tokens, d) tensors of attention and norms, and an MoE
    FFN the slab at its bound with its three expert products and the
    (token, k) outputs the combine keeps, a dense MLP 4 (tokens, d_ff), a
    cross-attention the memory's k and v. Returns (text, GB)."""
    from repro_torch.models.layers import moe
    from repro_torch.tree import leaves

    d, el = cfg.d_model, 2 if cfg.dtype == "bfloat16" else 4
    client = sum(a[0].numel() * a.element_size()
                 for a in leaves(params["client"])) / 1e9
    server = sum(a.numel() * a.element_size()
                 for a in leaves(params["server"])) / 1e9
    total = slots * client + server
    largest = update_slice_gb(params)
    prefix = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
    tokens = rows * (prefix + seq)
    layer = 8 * tokens * d
    if cfg.moe is not None:
        m, per_slot = cfg.moe, tokens // slots
        slab_rows = slots * min(moe.capacity(per_slot, m), per_slot)
        layer += (m.num_experts * slab_rows * (d + 3 * m.d_expert)
                  + tokens * m.top_k * d)
    else:
        layer += 4 * tokens * cfg.d_ff
    if cfg.frontend == "audio":
        layer += (rows * cfg.num_prefix_tokens * 4 * cfg.num_kv_heads
                  * cfg.head_dim)
    layer *= el / 1e9
    act = cfg.num_layers * layer
    dw = 4 * d * cfg.vocab_size / 1e9
    step = 2 * total + act + dw
    update = 3 * total + 3 * largest
    return (f"client half {client:.2f} GB a slot x {slots}, server half "
            f"{server:.2f} GB: params {total:.2f} GB; the backward pass: "
            f"params, gradients as much, saved activations at most "
            f"~{act:.1f} GB ({cfg.num_layers} layers at {tokens} server "
            f"rows, ~{layer:.2f} a layer), the boundary's dW {dw:.2f}: "
            f"~{step:.1f} GB; the update: params, gradients, the new params "
            f"and 3 float32 temporaries of its largest slice ({largest:.2f} "
            f"GB each): ~{update:.1f} GB; peak at most "
            f"~{max(step, update):.1f} GB"), max(step, update)


class RoundCell:
    """``api.build``'s round of a plain subset-mode SCALA spec (``flags``)
    on a model config that no spec names: ``cfg`` (by default the spec's
    own) cut to ``layers``. An ``ExperimentSpec`` has no depth and takes
    no frontend arch, so the round runs through
    ``engine.make_round_runner`` with the arguments ``build`` passes for
    the spec, on params made once on ``device`` from the spec's seed
    (``build``'s ``init`` would copy them under donation), and the
    Trainer's host data stream, each batch with the arch's encoder output
    (:func:`frontend_batch`). Prints the cell and the memory reckoning
    (:func:`memory_reckoning`) before any round."""

    def __init__(self, phase, flags, device, cfg=None, layers=None):
        from repro_torch.api.build import _server_optimizer
        from repro_torch.api.trainer import build_lm_data
        from repro_torch.core import engine, scala as core_scala
        from repro_torch.launch import train
        from repro_torch.models import transformer as Tm

        self.phase, self.device = phase, device
        self.on_card = torch.device(device).type == "cuda"
        spec = train.spec_from_args(train.build_parser().parse_args(flags))
        spec.validate()
        ex, fd, sc = spec.execution, spec.fed, spec.scala
        faults, guards = fd.make_faults(), fd.make_guards()
        server_opt, server_lr = _server_optimizer(spec)
        agg = fd.make_aggregator()
        # build()'s round for this spec: subset mode, no scheduler, no fed
        # state
        check(ex.mode == "subset" and spec.method == "scala"
              and faults is None and guards is None and server_opt is None
              and not agg.stateful,
              f"{phase}: the cell is a plain subset-mode SCALA spec")
        full = cfg or spec.model_config()
        cfg = dataclasses.replace(full, num_layers=min(
            layers or full.num_layers, full.num_layers))
        free_device_memory()
        t0 = time.perf_counter()
        gen = torch.Generator(device)
        gen.manual_seed(spec.seed)
        made = Tm.init_params(gen, cfg)
        params = engine.init_scala_params(gen, lambda _: made["client"],
                                          lambda _: made["server"],
                                          spec.slots)
        del made
        opt = spec.optim.make()
        self.round_fn = engine.make_round_runner(
            core_scala.transformer_split_model(cfg), sc, backend=ex.backend,
            boundary=ex.boundary, optimizer=opt,
            schedule=spec.optim.make_schedule(spec.rounds * sc.local_iters,
                                              default_lr=sc.lr),
            aggregator=agg, participation=None,
            opt_state_policy=fd.opt_state_policy, slot_gather=False,
            server_optimizer=server_opt, server_lr=server_lr,
            precision=ex.precision, faults=faults, guards=guards,
            donate=ex.donate)
        reckoning, self.predicted = memory_reckoning(
            cfg, params, spec.slots, sc.server_batch, spec.data.seq)
        self.state = engine.init_train_state(params, opt)
        del params
        sync(device)
        prefix = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
        say(phase, f"{cfg.name} ({cfg.num_layers} of {full.num_layers} "
            f"layers: {cfg.split_layer} client, "
            f"{cfg.num_layers - cfg.split_layer} server), {cfg.dtype} "
            f"compute, {cfg.param_dtype} params"
            + (", float32 routers" if cfg.moe is not None else "")
            + (f", frontend {cfg.frontend} ({cfg.num_prefix_tokens} x "
               f"{cfg.frontend_dim} a row)" if cfg.frontend else "")
            + f"; {sc.num_clients} clients, {spec.slots} slots, "
            f"{sc.local_iters} local steps of {sc.server_batch} x "
            + (f"({prefix} + {spec.data.seq}) rows" if prefix else
               f"{spec.data.seq} tokens")
            + f", boundary {ex.boundary}, {fd.aggregator} FedAvg, "
            f"{spec.optim.name}; params made in "
            f"{time.perf_counter() - t0:.1f} s")
        say(phase, f"memory reckoning before the run: {reckoning}")
        self.spec, self.cfg = spec, cfg
        self.data = build_lm_data(cfg, sc.num_clients,
                                  spec.data.docs_per_client, spec.data.seq,
                                  spec.seed)
        self.rng = np.random.default_rng(spec.seed)

    def draw(self):
        """One round's batches and client sizes, on the device."""
        from repro_torch.data.loader import lm_round_batches, sample_clients

        sc = self.spec.scala
        rb = lm_round_batches(self.data, sample_clients(
            sc.num_clients, sc.clients_per_round, self.rng), sc.server_batch,
            sc.local_iters, self.rng)
        sizes = torch.from_numpy(rb.pop("sizes")).to(self.device)
        rb = frontend_batch(self.cfg, self.rng, rb)
        return ({k: torch.from_numpy(v).to(self.device)
                 for k, v in rb.items()}, sizes)

    def run(self, drawn=None):
        """One round on ``drawn`` (:meth:`draw`; a fresh draw if None);
        returns its losses and router loss."""
        self.state, m = self.round_fn(self.state, *(drawn or self.draw()))
        return {k: float(m[k]) for k in ("loss_server", "loss_client",
                                         "aux")}

    def rounds(self, watch=lambda r, run: run(), peak_bar=None):
        """The spec's rounds on batches drawn before them (set-up, not
        timed: a frontend arch's encoder outputs are ~74-105 MB a round),
        ``watch(r, run)`` running round r (``run()``) and returning its
        metrics. Checks them finite and, on a card, each round's launches
        against the layout (:func:`train_launches`), and the peak against
        ``peak_bar``; prints each round (K3's calls self and cross), the
        seconds of rounds 1.., tokens/s and the peak beside the
        reckoning. Returns (the launches of the rounds, the mean seconds
        of rounds 1..)."""
        spec, cfg, phase = self.spec, self.cfg, self.phase
        T = spec.scala.local_iters
        t0 = time.perf_counter()
        drawn = [self.draw() for _ in range(spec.rounds)]
        say(phase, f"{len(drawn)} rounds' batches drawn in "
            f"{time.perf_counter() - t0:.1f} s (set-up, not timed)")
        per_step = train_launches(spec, cfg)
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        before = read_counts()
        secs = []
        for r in range(spec.rounds):
            t0 = time.perf_counter()
            with k3_calls() as seen:
                m = watch(r, lambda: self.run(drawn[r]))
            sync(self.device)
            secs.append(time.perf_counter() - t0)
            now = read_counts()
            got = {k: now[k] - before[k] for k in now}
            before = now
            check(all(np.isfinite(v) for v in m.values()),
                  f"{phase} round {r}: finite losses and router loss {m}")
            if self.on_card:
                want = {k: T * n for k, n in per_step.items()}
                check(got == want, f"{phase} round {r} launches {got} != "
                      f"{want} ({T} steps x {per_step})")
            say(phase, f"round {r} loss_s={m['loss_server']:.4f} "
                f"loss_c={m['loss_client']:.4f} aux={m['aux']:.4f} in "
                f"{secs[-1]:.3f} s; launches K3 fwd {got['flash_fwd']} "
                f"(self {sum(seen)}, cross {len(seen) - sum(seen)}) bwd "
                f"{got['flash_bwd']}, K1 {got['lace_fwd']}, K2 "
                f"{got['lace_bwd']}")
        del drawn
        counts = read_counts()
        steady = secs[1:] or secs
        round_s = float(np.mean(steady))
        tokens = participating_tokens(spec)
        peak = torch.cuda.max_memory_allocated() if self.on_card else 0
        say(phase, f"round seconds (rounds 1..{len(secs) - 1}, round 0 has "
            f"the warm-up): {[round(x, 3) for x in steady]}, mean "
            f"{round_s:.3f} s -> {tokens / round_s:.0f} training tokens/s "
            f"({tokens} text tokens a round); round 0 {secs[0]:.3f} s; peak "
            f"{peak / 2**20:.0f} MiB allocated ({peak / 1e9:.2f} GB; "
            f"reckoned at most ~{self.predicted:.1f} GB"
            + (f", bar {peak_bar / 1e9:.0f} GB" if peak_bar else "")
            + f"); per step: {per_step}")
        if peak_bar is not None and self.on_card:
            check(peak < peak_bar, f"{phase}: peak {peak / 1e9:.2f} GB >= "
                  f"{peak_bar / 1e9:.0f} GB")
        return counts, round_s

    def close(self):
        """Frees the train state on the device."""
        del self.state
        free_device_memory()


def phase_train_moe(device="cuda", flags=MOE_TRAIN_FLAGS,
                    layers=MOE_TRAIN_LAYERS, phase="train-moe"):
    """train-moe: phase 6's cell (``TRAIN_FLAGS``: 16 clients, 4 slots, 2
    local steps of 16 x 512 tokens, SCALA, the fused ``lace`` boundary,
    weighted FedAvg, SGD, 3 rounds) on full-width qwen3-moe-30b-a3b in its
    own dtypes (bf16 params and compute, float32 routers), the depth cut
    to ``layers``, as a :class:`RoundCell`: the memory reckoning (before
    the run), the launches per round against :func:`train_launches` on
    the cut config, finite losses and router loss, the seconds of rounds
    1-2, tokens/s and the peak; then the slab's rows and the host syncs
    of round 0, a profiled round (device only) and a round split into the
    MoE FFN, attention (forward and backward each) and the LACE boundary
    (:func:`component_split`). Returns the launches of the 3 rounds."""
    from repro_torch.core import engine
    from repro_torch.models.layers import attention, moe

    cell = RoundCell(phase, flags, device, layers=layers)
    first = {}

    def watch(r, run):
        if r or not cell.on_card:
            return run()
        with moe_routings() as first["seen"]:
            m, first["syncs"] = count_syncs(run)
        return m

    counts, round_s = cell.rounds(watch)
    if not cell.on_card:
        cell.close()
        return counts
    spec, cfg = cell.spec, cell.cfg
    T = spec.scala.local_iters
    reads = sum(not r[1] for r in slab_rows(first["seen"], cfg.moe))
    say(phase, f"round 0's MoE routings: {slab_text(first['seen'], cfg.moe)}"
        f"; {reads / T:.0f} exact slab counts read back a step; "
        f"synchronizing CUDA calls in round 0: {first['syncs']} "
        f"({first['syncs'] / T:.1f} a step, the round's host copy of the "
        f"metrics among them)")
    del first
    profile("MoE training round", cell.run, 10, watch=TRAIN_WATCH)
    n_moe = sum(s.ffn == "moe" for s in cfg.block_specs)
    n_attn = sum(s.mixer == "attn" for s in cfg.block_specs)
    slots, split = spec.slots, cfg.split_layer

    def passes(n_client_layers, n_layers):
        # the client layers once forward and once back a slot, the
        # server's once forward and twice back (one pullback per prior)
        n_server = n_layers - n_client_layers
        return (T * (slots * n_client_layers + n_server),
                T * (slots * n_client_layers + 2 * n_server))

    client_moe = sum(s.ffn == "moe" for s in cfg.block_specs[:split])
    client_attn = sum(s.mixer == "attn" for s in cfg.block_specs[:split])
    component_split(
        phase, f"a training round ({T} steps + FedAvg; the largest call: "
        "the server's)", lambda: timed_ms(cell.run), [
            ("MoE FFN", moe, "moe_apply", *passes(client_moe, n_moe)),
            ("attention (K3)", attention, "attn_apply",
             *passes(client_attn, n_attn)),
            ("LACE boundary (K1, K2)", engine, "_lace_boundary", T)],
        wall_ms=1e3 * round_s)
    cell.close()
    return counts


def step_repeat(cfg, device, C, Bk, S, seed, phase):
    """One split step of ``cfg`` in its own dtypes, C clients x Bk x S
    tokens (each row with the arch's encoder output), run twice on the
    same params and batch: every gradient and metric bitwise equal."""
    from repro_torch.configs import ScalaConfig
    from repro_torch.core import engine
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import transformer as Tm
    from repro_torch.tree import leaves

    free_device_memory()
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    full = Tm.init_params(gen, cfg)
    params = {"client": stack_client_params(full["client"], C),
              "server": full["server"]}
    del full
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (C, Bk, S + 1))
    b = frontend_batch(cfg, rng, {"tokens": toks[..., :-1],
                                  "labels": toks[..., 1:],
                                  "weights": np.ones((C, Bk, S), np.float32)})
    batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    model = transformer_split_model(cfg)
    sc = ScalaConfig(num_clients=C)
    runs = []
    for _ in range(2):
        with moe_routings() as seen:
            g, m = engine.split_step_grads(model, params, batch, sc)
        sync(device)
        runs.append((leaves(g), m))
    (g1, m1), (g2, m2) = runs
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    same_m = all(torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m2[k]))
                 for k in m1)
    check(same and same_m, f"{phase}: a {cfg.param_dtype} {cfg.name} step "
          f"repeated: grads bitwise {same}, metrics bitwise {same_m}")
    say(phase, f"{cfg.name} {cfg.param_dtype} params, {cfg.dtype} compute, "
        f"{cfg.num_layers} layers, {C} clients x {Bk} x {S} tokens"
        + (f" on {cfg.num_prefix_tokens} frames a row"
           if cfg.frontend == "audio" else "")
        + f": one split step twice, all {len(g1)} grad leaves and the "
        f"metrics bitwise equal (loss_s {float(m1['loss_server']):.4f}"
        + (f", aux {float(m1['aux']):.4f}); routings: "
           f"{slab_text(seen, cfg.moe)}" if cfg.moe is not None else ")"))
    del runs, g1, g2, params, batch
    free_device_memory()


def moe_step_repeat(device="cuda", reduced=False, layers=MOE_TRAIN_CHECK_LAYERS,
                    C=2, Bk=4, S=512, phase="check-moe-train"):
    """:func:`step_repeat` on qwen3-moe-30b-a3b in its own dtypes (bf16
    params and compute, float32 routers; full width unless ``reduced``,
    cut to ``layers``). At C clients x Bk x S tokens each MoE layer's
    slab takes the exact count (read back) and pairs drop."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              num_layers=layers)
    step_repeat(cfg, device, C, Bk, S, 5, phase)


def phase_moe_train_check(device="cuda", reduced=False):
    """check-moe-train: :func:`phase_train_check` on qwen3-moe-30b-a3b in
    float32 at full width (unless ``reduced``) and 3 layers, 2 clients x
    64 tokens (the nearest 8th / 9th router gap printed first; aux and
    the router grads among the checks; the round's server routers too),
    then a bf16 step twice, bitwise (:func:`moe_step_repeat`)."""
    free_device_memory()
    phase_train_check(device, reduced, C=2, S=64, T=2, arch=MOE,
                      layers=MOE_TRAIN_CHECK_LAYERS, phase="check-moe-train")
    free_device_memory()
    moe_step_repeat(device, reduced)


def f32_qwen_step_inputs(device, reduced=False, C=2, S=64, seed=3,
                         layers=None):
    """float32 qwen1.5-0.5b (full width unless ``reduced``; ``layers``
    cuts the depth), its split model, stacked params made on ``device``
    from a seed, and one step's numpy batch of C clients x S tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import transformer as Tm

    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              dtype="float32", param_dtype="float32",
                              num_layers=layers or cfg.num_layers)
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
# the round check's width: its float64 CPU rounds took 117 s at width 1.0
# (the tables stay at 1.0). FedDecorr's stays at 1.0: its decorrelation
# term amplifies float32 rounding, and at 0.5 its float32 one-step round
# landed 1.04e-3 from float64, over the 1e-3 bar (PERF.md §6)
BASELINE_CHECK_WIDTH = 0.5
BASELINE_FULL_WIDTH = ("feddecorr",)
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
    leaves whose path does not start with ``reported``. Computed where
    ``got``'s leaves lie."""
    worst, worst_key, n_off, fro, checked = 0.0, "", 0, 0.0, 0.0
    for key, b in want.items():
        if not isinstance(b, torch.Tensor):
            check(got[key] == b, f"{key}: {got[key]} != {b}")
            continue
        a = got[key].double()
        b = b.to(a.device)
        check(bool(torch.isfinite(a).all()), f"{key} finite")
        upd = b - old[key].to(a.device)
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
    scala from one seeded state at BASELINE_CHECK_WIDTH (at most
    ``width``; BASELINE_FULL_WIDTH's methods at ``width``),
    against the CPU in float64, every leaf's update within UPDATE_RTOL of
    its largest entry: over 1 local step on ``device`` in float32 (cuDNN
    off), over ``local_iters`` in float64 (the float32 rounds reported
    beside it). Then the paper tables T1, T5
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
            spec = alexnet_method_spec(method, 1, width if method in
                                       BASELINE_FULL_WIDTH else
                                       min(width, BASELINE_CHECK_WIDTH), T)
            host = api.Trainer(spec, device="cpu")
            batches, sizes = host._next_round_batches()
            p0 = (host.state.inner.params if method in api.SCALA_METHODS
                  else host.state.inner)

            def round_on(dev, dtype, cudnn):
                program = api.build(spec, device=dev, params=tree_map(
                    lambda a: a.to(dtype), p0))
                state = program.init()
                # the step may overwrite the state it is given (donation):
                # the round's start is read before it
                old = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in state_leaves(state).items()}
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
                return old, state_leaves(new), time.perf_counter() - t0

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
    say("baselines", f"round check at width "
        f"{min(width, BASELINE_CHECK_WIDTH)} ({', '.join(BASELINE_FULL_WIDTH)}"
        f" at {width}): cpu float64 side {cpu_s:.1f} s in all, T = "
        f"{local_iters} and 1")
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
    return t.contiguous().reshape(-1).view(torch.uint8)


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
        elif isinstance(x, (np.ndarray, np.generic)):
            # the async runtime's host schedule
            check(type(x) is type(y) and x.dtype == y.dtype
                  and np.array_equal(x, y), f"{what}: leaf {key} differs")
        else:
            check(x == y, f"{what}: leaf {key} {x} != {y}")
    return len(a)


def resume_check(what, make_trainer, rounds_before, rounds_after, device):
    """``rounds_before + rounds_after`` rounds uninterrupted against
    ``rounds_before``, ``Trainer.save``, a fresh Trainer, ``resume`` and
    ``rounds_after``: bitwise equal states and histories. One Trainer is
    alive at a time; the uninterrupted state is kept on the host (its
    leaves checked finite where they lie: on the CPU that check took
    longer than the copy)."""
    import shutil
    import tempfile

    t = make_trainer()
    t.run(rounds_before + rounds_after)
    final = state_leaves(t.state)
    nonfinite = [k for k, v in final.items()
                 if isinstance(v, torch.Tensor) and v.is_floating_point()
                 and not bool(torch.isfinite(v).all())]
    want = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in final.items()}
    want_hist = list(t.history)
    del t, final
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


def recorded_scheduler(masks):
    """A participation scheduler that hands out ``masks`` in order (its
    state: the index of the next one; its subset size: the first mask's
    count): the same masks on every device."""
    from repro_torch import fed

    def sample(state):
        return np.array(masks[int(state)], np.float32), state + 1

    return fed.ParticipationScheduler(
        name="recorded", num_clients=len(masks[0]),
        init=lambda seed: torch.tensor(0), sample=sample,
        subset_size=int(masks[0].sum()))


def recording(opt):
    """``opt`` whose update keeps the pseudo-gradient it was given
    (``seen["delta"]``: the server's round delta)."""
    seen = {}

    def update(grads, state, params, lr, **kw):
        seen["delta"] = grads
        return opt.update(grads, state, params, lr, **kw)

    return dataclasses.replace(opt, update=update), seen


def fed_round(model, params, batches, sizes, masks, dev, opt, gather,
              server_opt=None):
    """One round of T steps with the injected ``masks`` (bias_compensated;
    ``server_opt`` at FED_CHECK_SERVER_LR) on ``dev`` from ``params``:
    (state and fed-state leaves, on ``dev``, the server half's leaves
    before its FedOpt step (w_start - delta; {} without one), metrics,
    seconds, launches). ``server_opt`` is adamw from zero moments: fails
    unless its state and the server half are, bit for bit,
    :func:`adam_first_step` on this round's own delta."""
    from repro_torch import fed
    from repro_torch.configs import ScalaConfig
    from repro_torch.core import engine
    from repro_torch.tree import tree_map

    C = len(masks[0])
    part, agg = recorded_scheduler(masks), fed.bias_compensated()
    rec, seen = (recording(server_opt) if server_opt is not None
                 else (None, {}))
    runner = engine.make_round_runner(
        model, ScalaConfig(num_clients=C, lr=0.01), optimizer=opt,
        aggregator=agg, participation=part, slot_gather=gather,
        server_optimizer=rec, server_lr=FED_CHECK_SERVER_LR)
    p = tree_map(lambda a: a.to(dev), params)
    state = engine.init_train_state(p, opt)
    fs = fed.init_fed_state(0, agg, part, server_optimizer=server_opt,
                            server_params=p["server"], device=dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches.items()}
    zero_counts()
    t0 = time.perf_counter()
    state, fs, m = runner(state, b, torch.from_numpy(sizes).to(dev), fs)
    sync(dev)
    secs = time.perf_counter() - t0
    n = read_counts()
    pre = {}
    if seen:
        so = fs["server_opt"]
        got = [state_leaves(t) for t in (state.params["server"], so["mu"],
                                         so["nu"])]
        delta = state_leaves(seen["delta"])
        for key, w in state_leaves(p["server"]).items():
            for name, a, b in zip(("param", "mu", "nu"),
                                  adam_first_step(w, delta[key]),
                                  (g[key] for g in got)):
                check(torch.equal(bits(a), bits(b)),
                      f"fed-check on {dev}: server {name} {key} is not "
                      "Adam's first step on the round's own delta")
        check(int(so["count"]) == 1,
              f"fed-check on {dev}: server count {so['count']}")
        pre = state_leaves({"state": {".params": {
            "server": tree_map(lambda w, d: w - d, p["server"],
                               seen["delta"])}}})
    return (state_leaves({"state": state, "fed": fs}), pre, {k: float(v) for k, v in m.items() if v.dim() == 0},
            secs, n)


def adam_first_step(w, d, lr=FED_CHECK_SERVER_LR, eps=FED_CHECK_SERVER_EPS):
    """Adam from zero moments, one step on the pseudo-gradient ``d`` from
    ``w``, written out in adamw's float32 operations: (w', mu, nu)."""
    one = torch.ones((), device=d.device)
    c1, c2 = 1 - ADAM_B1 ** one, 1 - ADAM_B2 ** one
    mu, nu = (1 - ADAM_B1) * d, (1 - ADAM_B2) * d * d
    return w - lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)), mu, nu


def fed_round_gap(got, want, start):
    """A round on the card (``got``, leaves or pre-FedOpt leaves of
    :func:`fed_round`) against the same round on the CPU (``want``), both
    from the params ``start``: {kind: (worst, leaf)}. "params": beyond 3
    ulps (phase 7's rule), over the leaf's largest update; "moments": the
    other float leaves over their largest entry, except the server
    optimizer's (held on each device by :func:`fed_round`). Integer leaves
    must be equal. Computed where ``got``'s leaves lie, ``want``'s and
    ``start``'s copied there a leaf at a time."""
    ulp = torch.finfo(torch.float32).eps
    worst = {"params": (0.0, ""), "moments": (0.0, "")}
    for key, b in want.items():
        a = got[key]
        if isinstance(b, torch.Tensor):
            b = b.to(a.device)
        if not isinstance(b, torch.Tensor) or not b.is_floating_point():
            check(torch.equal(a, b) if isinstance(b, torch.Tensor)
                  else np.array_equal(a, b),
                  f"fed-check leaf {key}: {a} vs {b}")
            continue
        if key.startswith("fed/server_opt/"):
            continue
        p0 = start.get(key)
        if p0 is not None:
            p0 = p0.to(a.device)
            kind, err = "params", (
                ((a - b).abs() - 3 * ulp * b.abs()).clamp(min=0).max()
                / (b - p0.expand(b.shape)).abs().max().clamp(min=1e-30))
        else:
            kind, err = "moments", ((a - b).abs().max()
                                    / b.abs().max().clamp(min=1e-30))
        worst[kind] = max(worst[kind], (err.item(), key))
    return worst


def fed_check_inputs(device, reduced, C, S, T, layers=None):
    """f32 qwen1.5-0.5b (full width unless ``reduced``; ``layers`` cuts
    the depth), its split model, params on ``device``, one round's numpy
    batches of C slots x S tokens and T steps (an eq. 3 padding tail on
    the last slot), data sizes and a uniform:0.5 mask."""
    from repro_torch import fed

    cfg, model, params, _ = f32_qwen_step_inputs(device, reduced, C, S,
                                                 seed=4, layers=layers)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (T, C, 1, S + 1))
    weights = np.ones((T, C, 1, S), np.float32)
    weights[:, -1, 0, -S // 8:] = 0.0
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
               "weights": weights}
    sizes = np.array([3.0, 1.0, 2.0, 4.0][:C], np.float32)
    part = fed.uniform(C, 0.5)
    return cfg, model, params, batches, sizes, [part.sample(part.init(4))[0]]


def fed_check_masked(device="cuda", reduced=False, C=4, S=64, T=2):
    """float32, TF32 off: one masked round (bias_compensated, momentum,
    server adamw) on ``device`` (K1, K2, K3) against the same round on
    the CPU (the plain versions), at full width and FED_CHECK_LAYERS deep
    (the CPU's round took 30 s at all 24 layers)."""
    from repro_torch.optim import optimizers

    cfg, model, params, batches, sizes, masks = fed_check_inputs(
        device, reduced, C, S, T, FED_CHECK_LAYERS)
    say("fed-check", f"{cfg.name} float32, {cfg.num_layers} layers, {C} "
        f"slots x {S} tokens, {T} steps, mask {masks[0].tolist()}")
    res = {}
    for dev in (device, "cpu"):
        res[dev] = fed_round(model, params, batches, sizes, masks, dev,
                             optimizers.momentum(0.9), False,
                             optimizers.adamw(eps=FED_CHECK_SERVER_EPS))
        say("fed-check", f"masked round on {dev}: {res[dev][3]:.2f} s, "
            f"launches K3 fwd {res[dev][4]['flash_fwd']} bwd "
            f"{res[dev][4]['flash_bwd']}, K1 {res[dev][4]['lace_fwd']}, K2 "
            f"{res[dev][4]['lace_bwd']}; the server step is Adam's first "
            "step on this device's own delta, bit for bit")
    if torch.device(device).type == "cuda":
        want = {k: T * n for k, n in slot_launches(C, cfg).items()}
        got = {k: res[device][4][k] for k in want}
        check(got == want, f"fed-check masked launches {got} != {want}")
    (got, got_pre, m_dev), (want, want_pre, m_cpu) = (res[device][:3],
                                                      res["cpu"][:3])
    for k in ("loss_server", "loss_client"):
        check(abs(m_dev[k] - m_cpu[k]) <= LOSS_RTOL * abs(m_cpu[k]),
              f"fed-check {k} {m_dev[k]} vs cpu {m_cpu[k]}")
    start = state_leaves({"state": {".params": params}})
    worst = fed_round_gap(got, want, start)
    pre = fed_round_gap(got_pre, want_pre, start)["params"]
    check(max(w for w, _ in (*worst.values(), pre)) <= LEAF_RTOL,
          f"fed-check leaves {worst}, before FedOpt {pre} > {LEAF_RTOL}")
    say("fed-check", f"masked round, {device} vs cpu: loss_s "
        f"{m_dev['loss_server']:.6f} vs {m_cpu['loss_server']:.6f}, loss_c "
        f"{m_dev['loss_client']:.6f} vs {m_cpu['loss_client']:.6f} (rtol "
        f"{LOSS_RTOL}); {len(want)} leaves of the state and fed state: "
        f"params worst {worst['params'][0]:.3g} of the leaf's largest "
        f"update beyond 3 ulps ({worst['params'][1]}), the server half "
        f"before FedOpt {pre[0]:.3g} ({pre[1]}), moments worst "
        f"{worst['moments'][0]:.3g} of the largest entry "
        f"({worst['moments'][1]}) (tol {LEAF_RTOL})")


def fed_check_sparse(device="cuda", reduced=False, C=4, S=64, T=2):
    """float32, TF32 off: the same round sparse against masked on
    ``device`` with SGD."""
    from repro_torch.optim import optimizers

    cfg, model, params, batches, sizes, masks = fed_check_inputs(
        device, reduced, C, S, T)
    out = {}
    for gather in (False, True):
        out[gather] = fed_round(model, params, batches, sizes, masks, device,
                                optimizers.sgd(), gather)
    (ms, mm) = out[True][2], out[False][2]
    for k in ("loss_server", "loss_client"):
        check(abs(ms[k] - mm[k]) <= DUAL_LOSS_RTOL * abs(mm[k]),
              f"fed-check sparse {k} {ms[k]} vs masked {mm[k]}")
    worst = max(rel_err(out[True][0][k], b) for k, b in out[False][0].items()
                if "/.params/" in k)
    check(worst <= DUAL_LEAF_RTOL, f"fed-check sparse vs masked params "
          f"{worst} > {DUAL_LEAF_RTOL}")
    n = out[True][4]
    say("fed-check", f"sparse vs masked on {device} (SGD, same mask): loss_s "
        f"{ms['loss_server']:.7f} vs {mm['loss_server']:.7f}, loss_c "
        f"{ms['loss_client']:.7f} vs {mm['loss_client']:.7f} (rtol "
        f"{DUAL_LOSS_RTOL}); params worst {worst:.3g} of the leaf's largest "
        f"entry (tol {DUAL_LEAF_RTOL}); sparse launches K3 fwd "
        f"{n['flash_fwd']} bwd {n['flash_bwd']}, K1 {n['lace_fwd']}; "
        f"{out[True][3]:.2f} s vs masked {out[False][3]:.2f} s")


def phase_fed_check(device="cuda", reduced=False):
    """(c): :func:`fed_check_masked`, then :func:`fed_check_sparse`, at
    full width unless ``reduced``."""
    fed_check_masked(device, reduced)
    fed_check_sparse(device, reduced)


def phase_fed_resume(device="cuda", width=ALEXNET["width"],
                     flags=FED_SPARSE_FLAGS):
    """Trainer.save -> resume, bit for bit, with federation state: (b)'s
    sparse qwen run (the scheduler's state, the ages, server adamw's
    moments; 1 round, save, 1 more against 2), then masked AlexNet at
    ``width`` with staleness_weighted (2, save, 1 against 3; cuDNN
    deterministic)."""
    from repro_torch import api
    from repro_torch.launch import train

    spec = train.spec_from_args(train.build_parser().parse_args(flags))
    zero_counts()
    resume_check(f"{spec.arch} {'reduced' if spec.reduced else 'full'} "
                 f"width, {spec.execution.mode}, {spec.fed.aggregator}, "
                 f"server {spec.execution.server_optimizer.spec}",
                 lambda: api.Trainer(spec, device=device), 1, 1, device)
    n = read_counts()
    if torch.device(device).type == "cuda":
        check(all(n[k] > 0 for k in ("flash_fwd", "flash_bwd", "lace_fwd",
                                     "lace_bwd")),
              f"fed-resume: the qwen rounds launched {n}")
    a = alexnet_spec("fused", 3, width)
    a = dataclasses.replace(
        a, fed=api.FedSpec(participation=f"uniform:{ALEXNET['participation']}",
                           aggregator="staleness_weighted"),
        execution=dataclasses.replace(a.execution, mode="masked")).validate()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        resume_check(f"alexnet-cifar width {width} masked "
                     f"{a.fed.participation} staleness_weighted",
                     lambda: api.Trainer(a, device=device), 2, 1, device)
    finally:
        torch.backends.cudnn.deterministic = prev


def phase_fed(device="cuda"):
    """(a) masked, (b) sparse, through :func:`phase_train`; (c)
    fed-check; (d) resume with federation state. Returns the launch
    counts of (a) and (b) together."""
    masked = phase_train(device, FED_MASKED_FLAGS, phase="fed-masked")
    sparse = phase_train(device, FED_SPARSE_FLAGS, phase="fed-sparse")
    phase_fed_check(device)
    phase_fed_resume(device)
    return {k: masked[k] + sparse[k] for k in masked}


def async_report(phase):
    """``on_done`` of an async cell: its events' staleness and deadline
    misses from the history, the state's resident bytes, and the host
    pager's bytes and page-in / page-out seconds (a paged run's
    ``Trainer.save`` must refuse)."""
    def report(trainer):
        import tempfile

        from repro_torch import fed

        h = trainer.history
        stale = [m["staleness_mean"] for m in h]
        missed = sum(m.get("deadline_missed", 0.0) for m in h)
        b = fed.async_state_bytes(trainer.state.fed)
        say(phase, f"{len(h)} events: staleness_mean per event {stale}, "
            f"deadline misses {missed:.0f}, clock {h[-1]['t_event']:.3f}; "
            f"async_state_bytes: snapshots {b['snapshot_bytes']} "
            f"({b['snapshot_bytes'] / 2**30:.3f} GiB), per-client scalars "
            f"{b['per_client_scalar_bytes']}, other {b['other_bytes']}")
        pager = trainer.program.metadata.get("pager")
        if pager is not None:
            n = len(h)
            say(phase, f"host pager: {pager.nbytes()} bytes "
                f"({pager.nbytes() / 2**30:.3f} GiB) on the host; page-in "
                f"{pager.seconds['page_in']:.3f} s, page-out "
                f"{pager.seconds['page_out']:.3f} s over {n} events "
                f"({pager.seconds['page_in'] / n:.3f} / "
                f"{pager.seconds['page_out'] / n:.3f} s an event)")
            try:
                trainer.save(os.path.join(tempfile.gettempdir(),
                                          "paged-save"))
            except ValueError as e:
                say(phase, f"save refused, as it must: {e}")
            else:
                check(False, f"{phase}: save of a host-paged run did not "
                      "raise")
    return report


def async_events(model, params, batches, sizes, dev, events, opt, delays,
                 cohort, every=False, **kw):
    """``events`` async events on ``dev`` from ``params`` (each event's
    batches the same): (the final state and async state's leaves, on
    ``dev``, the metrics of each event, seconds, launches; with ``every``
    also copies of the leaves after each event)."""
    from repro_torch import fed
    from repro_torch.configs import ScalaConfig
    from repro_torch.core import engine
    from repro_torch.tree import leaves, tree_map

    C = len(sizes)
    delta = kw.get("snapshots") == "delta"
    event = fed.make_async_runner(model, ScalaConfig(num_clients=C,
                                                     lr=0.01),
                                  backend="lace", optimizer=opt,
                                  delays=delays, cohort=cohort,
                                  num_clients=C, **kw)
    p = tree_map(lambda a: a.to(dev), params)
    if delta:
        p = dict(p, client=tree_map(lambda a: a[:1], p["client"]))
    state = engine.init_train_state(p, opt)
    afed = fed.init_async_state(7, p["client"], delays, num_clients=C,
                                snapshots=kw.get("snapshots", "dense"),
                                ring_size=kw.get("ring_size", 64))
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches.items()}
    sz = torch.from_numpy(sizes).to(dev)

    zero_counts()
    t0 = time.perf_counter()
    mets, per_event = [], []
    for _ in range(events):
        state, afed, m = event(state, afed, b, sz)
        mets.append({k: (float(v) if np.ndim(v) == 0 else v)
                     for k, v in m.items()})
        if every:
            per_event.append((tree_map(lambda a: a[0].clone(),
                                       state.params["client"]),
                              [a.clone() for a in
                               leaves(state.params["server"])]))
    sync(dev)
    secs = time.perf_counter() - t0
    return (state_leaves({"state": state, "fed": afed}), mets, secs,
            read_counts(), per_event)


# (c) async-check: f32 full width, 4 slots, cohort 2, T = 2, S = 64.
# Recorded delays with a deadline of 1.0: the first event's second arrival
# (finish 2.5) misses its cut (0.5 + 1.0), backs off (retries 1, its delay
# x 2) and keeps its snapshot; draw v is the event that makes version v.
ASYNC_CHECK_DELAYS = ([0.5, 2.5, 3.0, 4.0], [1.0, 1.0], [0.5, 2.0],
                      [1.0, 1.0])
ASYNC_CHECK_DEADLINE = 1.0
ASYNC_CHECK_LAYERS = 6      # of 24: the CPU's events are the phase's cost


def phase_async_check(device="cuda", reduced=False, C=4, S=64, T=2,
                      cohort=2):
    """(c): three events with recorded delays and a deadline on
    ``device`` (K1, K2, K3) against the CPU (the plain versions) under
    fed-check's rule; zero delays with cohort = K against the sync round
    on ``device`` (the reference's tolerance, atol = rtol = 1e-6); delta
    against dense snapshots on ``device`` over six events, bitwise. At
    full width and ASYNC_CHECK_LAYERS deep (the CPU's events took 48 s
    at all 24 layers)."""
    from repro_torch import fed
    from repro_torch.configs import ScalaConfig
    from repro_torch.core import engine
    from repro_torch.optim import optimizers
    from repro_torch.tree import leaves, tree_map

    cfg, model, params, batches, sizes, _ = fed_check_inputs(
        device, reduced, C, S, T, ASYNC_CHECK_LAYERS)
    say("async-check", f"{cfg.name} float32, {cfg.num_layers} layers, {C} "
        f"slots, cohort {cohort}, {T} steps of 1 x {S} tokens a slot")
    rec = fed.delays.recorded(ASYNC_CHECK_DELAYS)
    res = {}
    for dev in (device, "cpu"):
        res[dev] = async_events(model, params, batches, sizes, dev, 3,
                                optimizers.momentum(0.9), rec, cohort,
                                deadline=ASYNC_CHECK_DEADLINE, mix_rate=0.8)
        n = res[dev][3]
        say("async-check", f"3 events on {dev}: {res[dev][2]:.2f} s, "
            f"launches K3 fwd {n['flash_fwd']} bwd {n['flash_bwd']}, K1 "
            f"{n['lace_fwd']}, K2 {n['lace_bwd']}; deadline misses "
            f"{[m['deadline_missed'] for m in res[dev][1]]}, clock "
            f"{[round(m['t_event'], 3) for m in res[dev][1]]}")
    if torch.device(device).type == "cuda":
        want = {k: 3 * T * v for k, v in slot_launches(cohort, cfg).items()}
        got = {k: res[device][3][k] for k in want}
        check(got == want, f"async-check launches {got} != {want}")
    (got, m_dev), (want, m_cpu) = res[device][:2], res["cpu"][:2]
    check(sum(m["deadline_missed"] for m in m_cpu) > 0,
          "async-check: the recorded delays made no deadline miss")
    for e, (a, b) in enumerate(zip(m_dev, m_cpu)):
        for k in ("loss_server", "loss_client"):
            check(abs(a[k] - b[k]) <= LOSS_RTOL * abs(b[k]),
                  f"async-check event {e} {k} {a[k]} vs cpu {b[k]}")
    start = state_leaves({"state": {".params": params}})
    worst = fed_round_gap(got, want, start)
    check(max(w for w, _ in worst.values()) <= LEAF_RTOL,
          f"async-check leaves {worst} > {LEAF_RTOL}")
    say("async-check", f"3 events, {device} vs cpu: losses within "
        f"{LOSS_RTOL} relative; the host schedule (versions, finish times, "
        f"retries, clock) equal; {len(want)} leaves: params worst "
        f"{worst['params'][0]:.3g} of the leaf's largest update beyond 3 "
        f"ulps ({worst['params'][1]}), snapshots and moments worst "
        f"{worst['moments'][0]:.3g} of the largest entry "
        f"({worst['moments'][1]}) (tol {LEAF_RTOL})")
    del res, got, want

    # zero delays, cohort = K: every slot arrives at every event, at
    # staleness 0 -- the synchronous round
    opt = optimizers.momentum(0.9)
    p = tree_map(lambda a: a.to(device), params)
    b = {k: torch.from_numpy(v).to(device) for k, v in batches.items()}
    sz = torch.from_numpy(sizes).to(device)
    sync_fn = engine.make_round_runner(model, ScalaConfig(num_clients=C,
                                                          lr=0.01),
                                       optimizer=opt)
    s_sync = engine.init_train_state(p, opt)
    zero = fed.delays.constant(0.0)
    event = fed.make_async_runner(model, ScalaConfig(num_clients=C,
                                                     lr=0.01),
                                  backend="lace", optimizer=opt,
                                  delays=zero, cohort=C)
    s_async = engine.init_train_state(p, opt)
    afed = fed.init_async_state(0, p["client"], zero)
    gap, lgap = 0.0, 0.0
    for _ in range(2):
        s_sync, m_sync = sync_fn(s_sync, b, sz)
        s_async, afed, m_async = event(s_async, afed, b, sz)
        for k in ("loss_server", "loss_client"):
            x, y = float(m_async[k]), float(m_sync[k])
            lgap = max(lgap, abs(x - y) / abs(y))
            check(abs(x - y) <= 1e-6 * abs(y), f"async-check zero delay "
                  f"{k} {x} vs sync {y}")
    for tree in ("params", "opt_state"):
        for x, y in zip(leaves(getattr(s_async, tree)),
                        leaves(getattr(s_sync, tree))):
            ok = bool(((x - y).abs() <= 1e-6 + 1e-6 * y.abs()).all())
            gap = max(gap, (x - y).abs().max().item())
            check(ok, f"async-check zero delay {tree} beyond atol = rtol "
                  "= 1e-6 of the sync round")
    check(bool((afed.version == 2).all()) and afed.server_version == 2,
          f"async-check zero delay versions {afed.version}")
    say("async-check", f"zero delays, cohort {C} = K, 2 events == 2 sync "
        f"rounds on {device} (momentum): params and moments within atol = "
        f"rtol = 1e-6 (largest difference {gap:.3g}), losses {lgap:.3g} "
        "relative")
    del s_sync, s_async, afed, p

    # delta snapshots against dense, staleness below the ring: bitwise
    dm = fed.make_delays("lognormal:1:1")
    runs = {}
    for snaps in ("dense", "delta"):
        runs[snaps] = async_events(model, params, batches, sizes, device, 6,
                                   optimizers.sgd(), dm, cohort, every=True,
                                   snapshots=snaps, ring_size=8)
    stale = max(max(m["staleness"]) for m in runs["dense"][1])
    check(stale < 8, f"async-check delta: staleness {stale} reached the "
          "ring")
    for e, ((ca, sa), (cb, sb)) in enumerate(zip(runs["dense"][4],
                                                 runs["delta"][4])):
        for x, y in zip(leaves(ca) + sa, leaves(cb) + sb):
            check(torch.equal(bits(x), bits(y)),
                  f"async-check delta != dense after event {e}")
    for key in ("loss_server", "loss_client", "t_event"):
        check([m[key] for m in runs["dense"][1]]
              == [m[key] for m in runs["delta"][1]],
              f"async-check delta != dense {key}")
    for key in ("fed/.version", "fed/.finish_time"):
        check(np.array_equal(runs["dense"][0][key], runs["delta"][0][key]),
              f"async-check delta != dense {key}")
    say("async-check", f"delta (ring 8) == dense snapshots on {device} "
        f"over 6 events (SGD, lognormal:1:1, largest staleness {stale:.0f}):"
        " the global client half and the server half after every event, "
        "losses, versions and finish times bitwise")


# (a) async-dense: the reference driver's async example
# (repro/launch/train.py:66-68) at full width -- 16 clients, cohort 4,
# lognormal:1:1.5 delays, staleness decay 0.5 -- with momentum carried per
# slot and a deadline of 2.0; the 4 arrivals' 4 documents each a step
# (16 x 512 tokens at the boundary, phase 6's shape), 4 events. (b)
# async-delta: the same with delta snapshots in a ring of 8, the moments
# paged to the host, the top-k pop and the lr scaled by cohort / K, no
# deadline (the reference refuses one with paging).
ASYNC_DENSE_FLAGS = ["--arch", ARCH, "--clients", "16", "--async",
                     "--cohort", "4", "--delay-spec", "lognormal:1:1.5",
                     "--staleness-decay", "0.5", "--optimizer", "momentum",
                     "--local-iters", "2", "--seq", "512", "--server-batch",
                     "64", "--docs-per-client", "8", "--rounds", "4",
                     "--seed", "0"]
ASYNC_DELTA_FLAGS = ASYNC_DENSE_FLAGS + [
    "--snapshots", "delta", "--ring-size", "8", "--opt-paging", "host",
    "--arrival", "topk", "--lr-scale", "cohort"]
ASYNC_DENSE_FLAGS = ASYNC_DENSE_FLAGS + ["--deadline", "2.0"]


def phase_async_resume(device="cuda", flags=ASYNC_DENSE_FLAGS):
    """(d): (a)'s run saved after event 2, resumed, and events 3-4 held
    bitwise against the uninterrupted run: every leaf (the snapshots, the
    moment stack, the host schedule) and the history."""
    from repro_torch import api
    from repro_torch.launch import train

    spec = train.spec_from_args(train.build_parser().parse_args(flags))
    zero_counts()
    resume_check(f"{spec.arch} {'reduced' if spec.reduced else 'full'} "
                 f"width, async {spec.execution.snapshots}, cohort "
                 f"{spec.execution.cohort}/{spec.slots}, deadline "
                 f"{spec.execution.deadline}",
                 lambda: api.Trainer(spec, device=device), 2, 2, device)
    n = read_counts()
    if torch.device(device).type == "cuda":
        check(all(n[k] > 0 for k in ("flash_fwd", "flash_bwd", "lace_fwd",
                                     "lace_bwd")),
              f"async-resume: the events launched {n}")


def phase_async(device="cuda"):
    """(a) async-dense, (b) async-delta through :func:`phase_train`; (c)
    async-check; (d) resume. Returns the launch counts of (a) and (b)
    together."""
    dense = phase_train(device, ASYNC_DENSE_FLAGS, phase="async-dense",
                        on_done=async_report("async-dense"))
    delta = phase_train(device, ASYNC_DELTA_FLAGS, phase="async-delta",
                        on_done=async_report("async-delta"))
    phase_async_check(device)
    phase_async_resume(device)
    return {k: dense[k] + delta[k] for k in dense}


# phase 15 (faults): (a) fault-masked, phase 13(a)'s cell with drops and
# NaN corruption under non-finite rejection and median clipping, 3 rounds;
# (b) fault-async, phase 14(a)'s cell (deadline 2.0) with drops, NaN
# corruption and stalls under non-finite rejection, 4 events. The masks
# are host numpy draws from the spec's seed, the same on every device.
FAULT_MASKED_FLAGS = FED_MASKED_FLAGS + [
    "--faults", "drop:0.1,corrupt:0.5:nan", "--guards", "nonfinite,clip:10"]
FAULT_ASYNC_FLAGS = ASYNC_DENSE_FLAGS + [
    "--faults", "drop:0.1,corrupt:0.25:nan,stall:0.1", "--guards",
    "nonfinite"]
# (c) fault-check: guards at zero faults (clip far above any update: it
# never triggers) against no guards, bitwise, on the card
FAULT_CHECK_GUARDS = "nonfinite,clip:1e6"


def fault_report(phase, time_screen=False):
    """``on_done`` of a faulted cell: the rejections and re-runs per round
    from the history (at least one round must reject someone), and every
    float leaf of the final state finite. ``time_screen``: also the
    screen's seconds alone over a dense copy of the client stack against
    the state's own (a round's read: the trained stack and its start)."""
    def report(trainer):
        from repro_torch.tree import leaves

        h = trainer.history
        rej = [m["guard_rejected"] for m in h]
        check(sum(rej) >= 1, f"{phase}: no round rejected anyone: {rej}")
        bad = [a for a in leaves((trainer.state.inner.params,
                                  trainer.state.inner.opt_state))
               if isinstance(a, torch.Tensor) and a.is_floating_point()
               and not bool(torch.isfinite(a).all())]
        check(not bad, f"{phase}: {len(bad)} leaves hold inf or NaN")
        extra = ""
        if "t_event" in h[-1]:
            check(trainer.state.fed.server_version == len(h)
                  and np.isfinite(h[-1]["t_event"]),
                  f"{phase}: the schedule stalled at version "
                  f"{trainer.state.fed.server_version}")
            extra = (f"; deadline misses "
                     f"{sum(m.get('deadline_missed', 0.0) for m in h):.0f}, "
                     f"server_version {trainer.state.fed.server_version}, "
                     f"clock {h[-1]['t_event']:.3f}")
        say(phase, f"{len(h)} rounds: guard_rejected per round {rej}, "
            f"re-run rounds {[i for i, x in enumerate(rej) if x > 0]}; "
            f"every param and moment finite{extra}")
        if time_screen:
            screen_seconds(phase, trainer)
    return report


def screen_seconds(phase, trainer, reps=3):
    """The guards' screen alone at the cell's size: a dense copy of the
    client stack screened against the state's own, ``nonfinite,clip``,
    with its host copy; the best of ``reps``, and the bytes it reads."""
    from repro_torch.fed import guards as G
    from repro_torch.tree import leaves, tree_map

    start = trainer.state.inner.params["client"]
    dev = leaves(start)[0].device
    trained = tree_map(
        lambda a: a.clone(memory_format=torch.contiguous_format), start)
    C = leaves(start)[0].shape[0]
    policy, state = G.make_guards("nonfinite,clip:10"), G.init_state(dev)
    mask = torch.ones(C, device=dev)
    best = float("inf")
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        acc, fac, _, _ = G.screen(policy, trained, start, mask, state)
        torch.stack([acc, fac]).cpu()
        best = min(best, time.perf_counter() - t0)
    nbytes = sum(a.numel() * a.element_size() for a in leaves(trained))
    del trained
    say(phase, f"the screen alone over {C} slots ({nbytes / 2**30:.2f} GiB "
        f"dense, against the round's start): {best * 1e3:.2f} ms, best of "
        f"{reps}, with its host copy")


def fault_runs(model, params, batches, sizes, dev, mode, rounds, opt,
               sched_masks, faults=None, guards=None, donate=False, **kw):
    """``rounds`` rounds (or async events) on ``dev`` from ``params`` with
    the scheduler's recorded ``sched_masks`` (masked, sparse) or the
    lognormal:1:1 delays of seed 7 (async, cohort 2, or ``delays=``):
    (the state's and fed state's leaves, on ``dev``, the metrics of each
    round, each round's seconds). ``donate``: the sync rounds may
    overwrite their state from the first step on (a copy of ``params``)."""
    from repro_torch import fed
    from repro_torch.api.build import fresh
    from repro_torch.configs import ScalaConfig
    from repro_torch.core import engine
    from repro_torch.tree import tree_map

    C = len(sizes)
    sc = ScalaConfig(num_clients=C, lr=0.01)
    p = tree_map(lambda a: a.to(dev), params)
    if donate:
        p = fresh(p)
    state = engine.init_train_state(p, opt)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches.items()}
    sz = torch.from_numpy(sizes).to(dev)
    if mode == "async":
        delays = kw.pop("delays", fed.make_delays("lognormal:1:1"))
        run = fed.make_async_runner(model, sc, backend="lace", optimizer=opt,
                                    delays=delays, cohort=2, num_clients=C,
                                    faults=faults, guards=guards, **kw)
        fs = fed.init_async_state(7, p["client"], delays, guards=guards)
        step = lambda st, f: run(st, f, b, sz)             # noqa: E731
    else:
        part = recorded_scheduler(sched_masks)
        run = engine.make_round_runner(
            model, sc, optimizer=opt, aggregator=fed.weighted(),
            participation=part, slot_gather=mode == "sparse",
            faults=faults, guards=guards, donate=donate)
        fs = fed.init_fed_state(0, fed.weighted(), part, faults=faults,
                                guards=guards, device=dev)
        step = lambda st, f: run(st, b, sz, f)             # noqa: E731
    mets, secs = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state, fs, m = step(state, fs)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        mets.append({k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                     for k, v in m.items()})
    return state_leaves({"state": state, "fed": fs}), mets, secs


def leaves_bitwise(a, b, what):
    """Every leaf of the :func:`fault_runs` result ``a`` bit for bit in
    ``b``, which may hold the guards' state besides."""
    extra = set(b) - set(a)
    check(set(a) <= set(b) and all("guard/" in k for k in extra),
          f"{what}: different leaves {sorted(set(a) ^ set(b))}")
    for key, x in a.items():
        y = b[key]
        same = (torch.equal(bits(x), bits(y)) if isinstance(x, torch.Tensor)
                else np.array_equal(x, y))
        check(same, f"{what}: {key} differs")


def phase_fault_check(device="cuda", reduced=False, C=4, S=64, T=2):
    """(c): (1) guards at zero faults == no guards, bitwise (params,
    moments, fed state, the plain metrics), masked, sparse and async
    dense, 3 rounds or events each, with the screen's cost; (2) a recorded
    NaN corruption on one participant: the guarded masked round == the
    clean round whose recorded scheduler mask is the survivors, bitwise in
    params and loss_server."""
    from repro_torch.fed import faults as F
    from repro_torch.optim import optimizers

    cfg, model, params, batches, sizes, masks = fed_check_inputs(
        device, reduced, C, S, T)
    say("fault-check", f"{cfg.name} float32, {C} slots x {S} tokens, {T} "
        f"steps, mask {masks[0].tolist()}")
    opt = optimizers.momentum(0.9)
    for mode in ("masked", "sparse", "async"):
        guards = "nonfinite" if mode == "async" else FAULT_CHECK_GUARDS
        plain = fault_runs(model, params, batches, sizes, device, mode, 3,
                           opt, masks * 3)
        guarded = fault_runs(model, params, batches, sizes, device, mode, 3,
                             opt, masks * 3, guards=guards)
        leaves_bitwise(plain[0], guarded[0], f"fault-check {mode} zero "
                       "faults, guarded vs unguarded")
        for mp, mg in zip(plain[1], guarded[1]):
            check(mg["guard_rejected"] == 0.0,
                  f"fault-check {mode}: a zero-fault round rejected")
            for k, v in mp.items():
                same = (torch.equal(v, mg[k]) if isinstance(v, torch.Tensor)
                        else np.array_equal(v, mg[k]))
                check(same, f"fault-check {mode} zero faults: metric {k}")
        tg, tp = min(guarded[2][1:]), min(plain[2][1:])
        say("fault-check", f"{mode}: guards {guards!r} at zero faults == "
            f"no guards over 3 {'events' if mode == 'async' else 'rounds'},"
            f" every leaf and metric bitwise; seconds (the best of the "
            f"last two) guarded {tg:.4f} vs unguarded {tp:.4f} "
            f"({tg / tp:.3f}x)")
        del plain, guarded
    fault_survivor_check(device, model, params, batches, sizes, masks)


def fault_survivor_check(device, model, params, batches, sizes, masks):
    """(c)(2): a recorded NaN corruption of the first participant of
    ``masks[0]``: the guarded masked round == the clean round whose
    recorded scheduler mask is the survivors, bitwise in params and
    loss_server."""
    from repro_torch.fed import faults as F
    from repro_torch.optim import optimizers

    C, opt = len(sizes), optimizers.momentum(0.9)
    first = int(np.flatnonzero(masks[0])[0])
    corrupt = np.zeros(C, np.float32)
    corrupt[first] = 1.0
    rec = F.recorded([{"corrupt": corrupt}])
    got = fault_runs(model, params, batches, sizes, device, "masked", 1, opt,
                     masks, faults=rec, guards="nonfinite")
    accept = got[1][0]["guard_accept"].numpy()
    survivors = masks[0] * accept
    check(got[1][0]["guard_rejected"] == 1.0 and accept[first] == 0.0,
          f"fault-check: the corrupted slot {first} was not rejected "
          f"({accept})")
    clean = fault_runs(model, params, batches, sizes, device, "masked", 1,
                       opt, [survivors])
    for key, b in clean[0].items():
        if "/.params/" in key:
            check(torch.equal(bits(got[0][key]), bits(b)),
                  f"fault-check survivor round: {key} differs")
    check(torch.equal(got[1][0]["loss_server"], clean[1][0]["loss_server"]),
          "fault-check survivor round: loss_server differs")
    say("fault-check", f"NaN corruption of slot {first} (mask "
        f"{masks[0].tolist()}): rejected, the round re-ran over the "
        f"survivors {survivors.tolist()} and equals the clean round with "
        "that mask bit for bit (params, loss_server); guarded "
        f"{got[2][0]:.3f} s vs clean {clean[2][0]:.3f} s "
        f"({got[2][0] / clean[2][0]:.2f}x: the re-run)")


def phase_fault_cpu_check(device="cuda", C=4, S=64, T=2):
    """(d): at reduced width, one faulted guarded masked round (a slot
    dropped, one corrupted: the survivors re-run) and one faulted async
    event (an arrival corrupted, recorded delays) on ``device`` against
    the CPU under fed-check's rule; the rejections equal."""
    from repro_torch import fed
    from repro_torch.fed import faults as F
    from repro_torch.optim import optimizers

    cfg, model, params, batches, sizes, _ = fed_check_inputs(
        device, True, C, S, T)
    cases = (
        ("masked", dict(sched_masks=[np.ones(C, np.float32)],
                        faults=F.recorded([{"drop": [0, 0, 1, 0],
                                            "corrupt": [0, 1, 0, 0]}]),
                        guards="nonfinite,clip:10")),
        ("async", dict(sched_masks=None,
                       faults=F.recorded([{"corrupt": [0, 1]}]),
                       guards="nonfinite",
                       delays=fed.delays.recorded(ASYNC_CHECK_DELAYS))))
    start = state_leaves({"state": {".params": params}})
    for mode, kw in cases:
        res = {dev: fault_runs(model, params, batches, sizes, dev, mode, 1,
                               optimizers.momentum(0.9), **kw)
               for dev in (device, "cpu")}
        (got, m_dev, _), (want, m_cpu, _) = res[device], res["cpu"]
        m_dev, m_cpu = m_dev[0], m_cpu[0]
        check(m_cpu["guard_rejected"] == 1.0
              and m_dev["guard_rejected"] == m_cpu["guard_rejected"]
              and torch.equal(m_dev["guard_accept"], m_cpu["guard_accept"]),
              f"fault-cpu {mode}: accept {m_dev['guard_accept']} vs cpu "
              f"{m_cpu['guard_accept']}")
        for k in ("loss_server", "loss_client"):
            check(abs(float(m_dev[k]) - float(m_cpu[k]))
                  <= LOSS_RTOL * abs(float(m_cpu[k])),
                  f"fault-cpu {mode} {k} {m_dev[k]} vs cpu {m_cpu[k]}")
        worst = fed_round_gap(got, want, start)
        check(max(w for w, _ in worst.values()) <= LEAF_RTOL,
              f"fault-cpu {mode} leaves {worst} > {LEAF_RTOL}")
        say("fault-cpu", f"{cfg.name} float32 {mode}, a rejection and its "
            f"re-run, {device} vs cpu: accept {m_cpu['guard_accept'].tolist()}"
            f" equal; loss_s {float(m_dev['loss_server']):.6f} vs "
            f"{float(m_cpu['loss_server']):.6f}; params worst "
            f"{worst['params'][0]:.3g} of the leaf's largest update beyond 3 "
            f"ulps, moments worst {worst['moments'][0]:.3g} (tol "
            f"{LEAF_RTOL})")


def phase_faults(device="cuda"):
    """(a) fault-masked, (b) fault-async through :func:`phase_train`; (c)
    fault-check; (d) the card against the CPU at reduced width. Returns
    the launch counts of (a) and (b) together."""
    masked = phase_train(device, FAULT_MASKED_FLAGS, profile_round=False,
                         phase="fault-masked",
                         on_done=fault_report("fault-masked",
                                              time_screen=True))
    events = phase_train(device, FAULT_ASYNC_FLAGS, profile_round=False,
                         phase="fault-async",
                         on_done=fault_report("fault-async"))
    phase_fault_check(device)
    phase_fault_cpu_check(device)
    return {k: masked[k] + events[k] for k in masked}


# the dispatch phase: (a) phase 6's cell under the bf16 compute policy,
# 3 rounds; (b) phase 6's cell at 3 rounds a call over 5 rounds (chunks
# 3 + 2) against 1 a call; (c) dispatch-check at full width in the f32
# policy, 4 slots, 64 tokens a document: R = 2 over 3 rounds (2 + 1)
# against R = 1 in the subset, masked (bias_compensated, server FedAdam),
# sparse and async dense modes, bitwise; a guarded masked round with a
# recorded NaN corruption, donate on against off, bitwise; the masked
# round's peak memory with and without donation at phase 13(a)'s cell;
# (d) AlexNet at width 1.0 in bf16, one round of scala, fedavg and
# splitfed_v1. (a) holds each round's loss_server within 0.1 of phase 6's
# float32 run from the same seed, the reference's own bar
# (tests/test_dispatch.py): (b)'s unchunked run is that run (the same
# flags, seed and constant schedule; two rounds more).
DISPATCH_BF16_FLAGS = TRAIN_FLAGS + ["--precision", "bf16"]
DISPATCH_CHUNK_FLAGS = TRAIN_FLAGS + ["--rounds", "5"]
DISPATCH_CHUNK, DISPATCH_LOSS_ATOL = 3, 0.1
DISPATCH_CHECK_FLAGS = {
    "subset": ["--clients", "8", "--participation", "0.5"],
    "masked": ["--clients", "4", "--participation", "uniform:0.5",
               "--aggregator", "bias_compensated", "--server-optimizer",
               "fedadam", "--server-lr", "1e-3"],
    "sparse": ["--clients", "4", "--participation", "uniform:0.5",
               "--slot-gather"],
    "async": ["--clients", "4", "--async", "--cohort", "2", "--delay-spec",
              "lognormal:1:1.5"]}
DISPATCH_CHECK_COMMON = ["--arch", ARCH, "--local-iters", "2", "--seq", "64",
                         "--server-batch", "4", "--docs-per-client", "2",
                         "--optimizer", "momentum", "--rounds", "3",
                         "--seed", "0"]
DISPATCH_METHODS = ("scala", "fedavg", "splitfed_v1")


def trainer_from_flags(flags, device="cuda"):
    from repro_torch import api
    from repro_torch.launch import train

    spec = train.spec_from_args(train.build_parser().parse_args(
        flags + ["--device", str(device)]))
    return api.Trainer(spec.validate(), device=device)


def kept_leaves(state):
    """A program state's leaves, copied where they lie (a state of a
    dozen GB compares on the card in a fraction of its trip to the
    host)."""
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state_leaves(state).items()}


def float_leaves_report(state):
    """(every float leaf is float32 (or bf16 nowhere), count of leaves
    holding inf or NaN) over a program state's tensors."""
    vals = [v for v in state_leaves(state).values()
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    return (all(v.dtype == torch.float32 for v in vals),
            sum(not bool(torch.isfinite(v).all()) for v in vals))


def count_syncs(fn):
    """(``fn()``, the synchronizing CUDA calls it made): the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, recorded."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def dispatch_chunks(device="cuda", extra=()):
    """(b): the cell at 1 and at DISPATCH_CHUNK rounds a call, 5 rounds
    each from the same seed: history and final state bitwise; seconds a
    round; then one call more of each under the sync debug mode: the
    synchronizing calls a round against a chunk. Returns the unchunked
    run's history (phase 6's float32 run)."""
    runs = {}
    for rpc in (1, DISPATCH_CHUNK):
        t = trainer_from_flags(DISPATCH_CHUNK_FLAGS + [
            "--rounds-per-call", str(rpc)] + list(extra), device)
        zero_counts()
        secs = []
        t.run(on_round=lambda i, m, dt: secs.append(dt))
        counts = read_counts()
        state = kept_leaves(t.state)
        syncs = (count_syncs(t.step)[1]
                 if torch.device(device).type == "cuda" else None)
        runs[rpc] = dict(history=list(t.history[:5]), state=state,
                         secs=secs, syncs=syncs, counts=counts)
        del t
    one, chunked = runs[1], runs[DISPATCH_CHUNK]
    check(one["history"] == chunked["history"],
          f"dispatch-chunks: history at {DISPATCH_CHUNK} a call differs")
    n = states_equal(one["state"], chunked["state"],
                     "dispatch-chunks: 1 vs 3 rounds a call")
    check(one["counts"] == chunked["counts"],
          f"dispatch-chunks: launches {one['counts']} vs "
          f"{chunked['counts']}")
    say("dispatch-chunks", f"5 rounds at {DISPATCH_CHUNK} a call (chunks 3 "
        f"+ 2) == 1 a call: history and all {n} state leaves bitwise; "
        f"launches equal {chunked['counts']}")
    for rpc, r in runs.items():
        say("dispatch-chunks", f"{rpc} a call: seconds a round "
            f"{[round(x, 3) for x in r['secs']]} (rounds 1-4 mean "
            f"{np.mean(r['secs'][1:]):.3f} s); synchronizing CUDA calls in "
            f"one call of {rpc} round(s): {r['syncs']}")
    return one["history"]


def dispatch_bf16(f32_history, device="cuda", extra=()):
    """(a): phase 6's cell in bf16 through :func:`phase_train` (the launch
    check per round: K1, K2, K3 as in phase 6), master params and
    optimizer state float32 and finite, loss_server within
    DISPATCH_LOSS_ATOL of the float32 run's each round, a profiled
    round; then one round of it with the dual boundary (K4, K5 on their
    bf16-head build, twice a step). Returns the launches of both."""
    hist = {}

    def report(trainer):
        f32, bad = float_leaves_report(trainer.state)
        check(f32 and bad == 0, f"dispatch-bf16: master state float32 "
              f"{f32}, {bad} leaves hold inf or NaN")
        hist["h"] = list(trainer.history)
        if torch.device(device).type != "cuda":
            return
        profile("bf16 training round (fused boundary, bf16 head)",
                trainer.step, 8, watch=[
                    ("LACE forward, bf16 head (K1)",
                     "lace_fwd_kernel<__nv_bfloat16, __nv_bfloat16"),
                    ("LACE backward, bf16 head (K2)",
                     ("lace_grad_kernel<__nv_bfloat16, __nv_bfloat16",
                      "lace_gemm_kernel")),
                    ("K3 backward", "flash_bwd"), ("K3 forward",
                                                   "flash_fwd")])

    counts = phase_train(device, DISPATCH_BF16_FLAGS + list(extra),
                         profile_round=False, phase="dispatch-bf16",
                         on_done=report)
    gaps = [abs(b["loss_server"] - a["loss_server"])
            for a, b in zip(f32_history, hist["h"])]
    check(len(gaps) == 3 and max(gaps) <= DISPATCH_LOSS_ATOL,
          f"dispatch-bf16: loss_server gaps {gaps} > {DISPATCH_LOSS_ATOL}")
    say("dispatch-bf16", f"loss_server bf16 "
        f"{[round(m['loss_server'], 4) for m in hist['h']]} vs float32 "
        f"{[round(m['loss_server'], 4) for m in f32_history[:3]]}: gaps "
        f"{[f'{g:.4f}' for g in gaps]} (bar {DISPATCH_LOSS_ATOL}); master "
        "params and moments float32, every leaf finite")
    dual = phase_train(device, DISPATCH_BF16_FLAGS + [
        "--boundary", "dual", "--rounds", "1"] + list(extra),
        profile_round=False, phase="dispatch-bf16-dual")
    return {k: counts[k] + dual[k] for k in counts}


def dispatch_check(device="cuda", extra=()):
    """(c): R = 2 against R = 1 over 3 rounds (events) per mode, bitwise;
    the guarded masked round with a recorded NaN corruption, donate on ==
    off; the masked round's peak memory with and without donation."""
    from repro_torch.fed import faults as F
    from repro_torch.optim import optimizers

    for mode, flags in DISPATCH_CHECK_FLAGS.items():
        out = {}
        for rpc in (1, 2):
            t = trainer_from_flags(DISPATCH_CHECK_COMMON + flags + [
                "--rounds-per-call", str(rpc)] + list(extra), device)
            t0 = time.perf_counter()
            t.run()
            sync(device)
            out[rpc] = (list(t.history), state_leaves(t.state),
                        time.perf_counter() - t0)
            del t
        check(out[1][0] == out[2][0], f"dispatch-check {mode}: history")
        n = states_equal(out[1][1], out[2][1], f"dispatch-check {mode}")
        unit = "events" if mode == "async" else "rounds"
        say("dispatch-check", f"{mode}: 3 {unit} "
            f"at 2 a call (2 + 1) == 1 a call, history and {n} leaves "
            f"bitwise ({out[1][2]:.2f} s vs {out[2][2]:.2f} s)")
        del out        # both runs' states, kept on the card
    cfg, model, params, batches, sizes, masks = fed_check_inputs(
        device, bool(extra), 4, 64, 2)
    first = int(np.flatnonzero(masks[0])[0])
    corrupt = np.zeros(4, np.float32)
    corrupt[first] = 1.0
    res = {}
    for donate in (True, False):
        res[donate] = fault_runs(
            model, params, batches, sizes, device, "masked", 2,
            optimizers.momentum(0.9), masks * 2,
            faults=F.recorded([{"corrupt": corrupt}] * 2),
            guards="nonfinite,clip:10", donate=donate)
    check(all(m["guard_rejected"] == 1.0 for m in res[True][1]),
          "dispatch-check: the corrupted slot was not rejected")
    leaves_bitwise(res[False][0], res[True][0], "dispatch-check guarded "
                   "masked, donate on vs off")
    for a, b in zip(res[False][1], res[True][1]):
        check(torch.equal(a["loss_server"], b["loss_server"]),
              "dispatch-check guarded: loss_server differs")
    say("dispatch-check", f"guarded masked (nonfinite,clip:10), NaN "
        f"corruption of slot {first} in 2 rounds, each rejected and re-run:"
        f" donate on == off, every leaf bitwise")
    del res, params
    if torch.device(device).type != "cuda":
        return
    for donate in (True, False):
        t = trainer_from_flags(FED_MASKED_FLAGS + ["--rounds", "1"] + (
            [] if donate else ["--no-donate"]) + list(extra), device)
        sync(device)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = t.step()
        sync(device)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(np.isfinite(m["loss_server"]), "dispatch-memory: loss")
        say("dispatch-memory", f"masked round (phase 13(a)'s cell, 16 "
            f"slots, momentum), donate {'on' if donate else 'off'}: peak "
            f"{peak / 2**20:.0f} MiB allocated ({base / 2**20:.0f} MiB "
            f"before the round), {dt:.3f} s (the first round, warm-up in it)")
        del t


def dispatch_alexnet(device="cuda", width=ALEXNET["width"]):
    """(d): one round of each of DISPATCH_METHODS at ``width`` in bf16:
    every float leaf finite and float32."""
    from repro_torch import api

    for method in DISPATCH_METHODS:
        spec = alexnet_method_spec(method, rounds=1, width=width)
        spec = dataclasses.replace(spec, execution=dataclasses.replace(
            spec.execution, precision="bf16")).validate()
        t = api.Trainer(spec, device=device)
        t0 = time.perf_counter()
        t.run()
        sync(device)
        dt = time.perf_counter() - t0
        f32, bad = float_leaves_report(t.state)
        check(f32 and bad == 0, f"dispatch-alexnet {method}: float32 "
              f"{f32}, {bad} leaves hold inf or NaN")
        acc = t.evaluate()
        say("dispatch-alexnet", f"{method} width {width} bf16, one round "
            f"{dt:.3f} s (the first, warm-up in it): every leaf float32 and "
            f"finite; acc {acc['acc']:.4f}, balanced "
            f"{acc['balanced_acc']:.4f}")
        del t


def phase_dispatch(device="cuda", extra=(), width=ALEXNET["width"]):
    """Phase 16: (b) chunks, then (a) bf16 against (b)'s float32 run, (c)
    dispatch-check, (d) AlexNet in bf16, each part's seconds on a line.
    Returns (a)'s launch counts. ``extra`` flags go to every qwen run (a
    CPU rehearsal: ``["--reduced", "--seq", "16", "--docs-per-client",
    "3"]``, with a small ``width``)."""
    f32_history = run_phase("dispatch (b)", dispatch_chunks, device, extra)
    counts = run_phase("dispatch (a)", dispatch_bf16, f32_history, device,
                       extra)
    run_phase("dispatch (c)", dispatch_check, device, extra)
    run_phase("dispatch (d)", dispatch_alexnet, device, width)
    return counts


# ---------------------------------------------------------------------------
# frontends and cross-attention: whisper-tiny and internvl2-26b
# ---------------------------------------------------------------------------

WHISPER = "whisper-tiny"
VLM = "internvl2-26b"
# K3 at the frontend archs' shapes, (B, S, Skv, H, KV, hd, causal, dtype):
# whisper-tiny's cross-attention (non-causal, 6 heads of 64 on its 1500
# audio frames) at a training step's 16 x 448 text queries and a decode
# step's 8 x 1, its causal self-attention at 16 x 448, and internvl2-26b's
# causal server call at 16 x (256 + 256) rows, 48 heads of 128 on 8 KV
# heads; then two non-causal cases whose key count leaves a short last
# tile (65 = 64 + 1 keys under a decode step's single queries, 130 = 2 x
# 64 + 2 under 16 queries), where a key tile dropped or left unmasked
# past Skv moves the output by 10-40% of its largest entry (at 1500 keys
# an unmasked tail moves it by ~1%). The forward against the plain
# version within FRONTEND_FWD_RTOL of the plain output's largest entry
# (~1 bf16 ulp of it; at 1500 keys that entry is ~0.3, so an absolute
# TOL would pass a tail fault); the backward (every case with more than
# one query) against autograd of it, relative to the largest entry
# (bf16 3e-2); two runs of each bitwise equal.
FRONTEND_ATTN_CASES = [(16, 448, 1500, 6, 6, 64, False, BF16),
                       (8, 1, 1500, 6, 6, 64, False, BF16),
                       (16, 448, 448, 6, 6, 64, True, BF16),
                       (16, 512, 512, 48, 8, 128, True, BF16),
                       (8, 1, 65, 6, 6, 64, False, BF16),
                       (4, 16, 130, 6, 6, 64, False, BF16)]
CROSS_CASE, CROSS_DECODE_CASE, WHISPER_SELF_CASE, VLM_CASE = \
    FRONTEND_ATTN_CASES[:4]
FRONTEND_FWD_RTOL = 1e-2
# serve-whisper: batches of 8 rows, each row its own 1500 x 384 encoder
# output, prompts of these text lengths, 32 greedy new tokens each
WHISPER_SERVE_ROWS, WHISPER_SERVE_LENS, WHISPER_SERVE_GEN = 8, (4, 64, 128,
                                                               224), 32
# phase 6's cell (16 clients, 4 slots, 2 local steps of 16 rows, SCALA,
# fused LACE, weighted FedAvg, SGD, 3 rounds) at the frontend archs' text
# lengths: Whisper's decoder context (448), and 256 text tokens after
# internvl2's 256 image rows. A spec takes no frontend arch, so the flags
# are the text arch's and the model config the frontend arch's.
WHISPER_SEQ, VLM_SEQ = 448, 256
def frontend_train_flags(seq):
    """``TRAIN_FLAGS`` at ``seq`` text tokens a row."""
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--seq") + 1] = str(seq)
    return flags
# internvl2-26b's depth on one card: 6 of 48 layers (2 client, 4 server),
# bf16 params: ~7.75 B parameters with 4 client slots; the peak held under
# phase 18's bar
VLM_TRAIN_LAYERS = 6
PEAK_BAR = 72e9
# 20b: the projector at full width, (B, 256, 3200) -> (B, 256, 6144)
VLM_PROJECTOR_ROWS = 2


def frontend_batch(cfg, rng, batch):
    """``batch`` (numpy tokens of shape (..., S); for a vision arch also
    labels and weights) with a frontend arch's encoder output drawn from
    ``rng`` (normal x 0.1, float32): an audio arch's ``memory_emb``
    (..., M, fd); a vision arch's ``prefix_emb`` (..., P, fd) with its P
    rows put before the labels and weights (weight 0: the priors and
    losses leave them out). A text arch's batch comes back as it was."""
    if cfg.frontend is None:
        return batch
    lead = batch["tokens"].shape[:-1]
    emb = (0.1 * rng.standard_normal(
        lead + (cfg.num_prefix_tokens, cfg.frontend_dim),
        dtype=np.float32))
    if cfg.frontend == "audio":
        return dict(batch, memory_emb=emb)
    pad = lead + (cfg.num_prefix_tokens,)
    return dict(batch, prefix_emb=emb,
                labels=np.concatenate([np.zeros(pad, batch["labels"].dtype),
                                       batch["labels"]], -1),
                weights=np.concatenate([np.zeros(pad, np.float32),
                                        batch["weights"]], -1))


def attn_case_text(case):
    B, S, Skv, H, KV, hd, causal, dtype = case
    return (f"B={B} S={S} Skv={Skv} H={H} KV={KV} hd={hd} "
            f"{'causal' if causal else 'non-causal'} {str(dtype)[6:]}")


def phase_frontend_attention(cases=FRONTEND_ATTN_CASES):
    """K3 forward and backward at the frontend archs' shapes (``cases``):
    each against its plain version, two runs bitwise equal, times (CUDA
    events and the card's alone, ``device_ms``), the bound (non-causal:
    S x Skv pairs, k and v bytes at Skv) and SDPA's on the same inputs
    (no mask where non-causal). Returns ({(case, 'fwd' | 'bwd'): row},
    {'fwd': err, 'bwd': err})."""
    from repro_torch.kernels.flash_attn import kernel, ref
    from repro_torch.kernels.flash_attn import ops as fops
    import torch.nn.functional as F

    gen = torch.Generator("cuda")
    gen.manual_seed(11)
    rows, errs = {}, {"fwd": 0.0, "bwd": 0.0}
    for case in cases:
        B, S, Skv, H, KV, hd, causal, dtype = case
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   .requires_grad_() for shape in ((B, S, H, hd),
                                                   (B, Skv, KV, hd),
                                                   (B, Skv, KV, hd)))
        gout = torch.randn((B, S, H, hd), generator=gen,
                           device="cuda").to(dtype)
        qd, kd, vd = (t.detach() for t in (q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))
        gqa = {"enable_gqa": True} if KV != H else {}

        def run_kernel():
            return kernel.flash_attention_cuda(qd, kd, vd, causal=causal)

        def run_plain():
            return ref.mha_ref(qd, kd, vd, causal=causal)

        def run_library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal, **gqa)

        out, again = run_kernel(), run_kernel()
        sync("cuda")
        check(torch.equal(out, again), f"K3 fwd {case}: two runs differ")
        want = run_plain()
        err = (out.float() - want.float()).abs().max().item()
        tol = FRONTEND_FWD_RTOL * want.float().abs().max().item()
        lib_err = (run_library().transpose(1, 2).float()
                   - want.float()).abs().max().item()
        errs["fwd"] = max(errs["fwd"], err)
        check(err <= tol, f"K3 fwd vs plain {case}: {err} > {tol} "
              f"({FRONTEND_FWD_RTOL} of the plain output's largest entry)")
        ms, plain_ms, lib_ms = (time_ms(f) for f in
                                (run_kernel, run_plain, run_library))
        dev_ms, lib_dev_ms = device_ms(run_kernel), device_ms(run_library)
        bound_ms, bound_by = attention_bound(B, S, H, KV, hd, None, dtype,
                                             Skv, causal)
        rows[(case, "fwd")] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, device_ms=dev_ms, library_device_ms=lib_dev_ms)
        say("kernels", f"flash_attn_fwd {attn_case_text(case)}: "
            f"max_abs_err={err:.3g} (tol {tol:.3g}, {FRONTEND_FWD_RTOL} of "
            f"the largest entry; sdpa vs plain {lib_err:.3g}; two runs "
            f"bitwise equal) kernel={ms:.4f} ms "
            f"plain={plain_ms:.4f} ms sdpa={lib_ms:.4f} ms "
            f"bound={bound_ms:.4f} ms ({bound_by}); device: "
            f"kernel={dev_ms:.4f} ms sdpa={lib_dev_ms:.4f} ms")
        if S == 1:          # a decode step's: served only, no backward
            continue
        with torch.no_grad():
            o, lse = kernel.flash_attention_cuda(qd, kd, vd, causal=causal,
                                                 return_lse=True)
        wantg = ref.mha_ref(q, k, v, causal=causal)
        lib = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, **gqa)
        gout_t = gout.transpose(1, 2)

        def run_kernel_bwd():
            return kernel.flash_attention_bwd_cuda(qd, kd, vd, o, lse, gout,
                                                   causal=causal)

        def run_plain_bwd():
            return torch.autograd.grad(wantg, (q, k, v), gout,
                                       retain_graph=True)

        def run_library_bwd():
            return torch.autograd.grad(lib, (q, k, v), gout_t,
                                       retain_graph=True)

        got, again = run_kernel_bwd(), run_kernel_bwd()
        sync("cuda")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K3 bwd {case}: two runs differ")
        exp = run_plain_bwd()
        tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
        rels = [rel_err(a, b) for a, b in zip(got, exp)]
        errs["bwd"] = max(errs["bwd"], max(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(got, exp)))
        check(max(rels) <= tol, f"K3 bwd vs autograd of plain {case}: "
              f"{rels} > {tol}")
        ms, plain_ms, lib_ms = (time_ms(f, iters=5, warmup=1) for f in
                                (run_kernel_bwd, run_plain_bwd,
                                 run_library_bwd))
        dev_ms = device_ms(run_kernel_bwd)
        lib_dev_ms = device_ms(run_library_bwd)
        # S, dP, dV, dK, dQ: 5 products; read q, o, dO, k, v and lse,
        # write dq, dk, dv (K3's backward's work)
        t, bound_by = work_bound(fops.work(B, S, H, KV, hd, dtype, Skv=Skv,
                                           causal=causal, backward=True))
        rows[(case, "bwd")] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=t * 1e3, bound_by=bound_by,
            device_ms=dev_ms, library_device_ms=lib_dev_ms)
        r = rows[(case, "bwd")]
        say("kernels", f"flash_attn_bwd {attn_case_text(case)}: rel err "
            f"dq/dk/dv {'/'.join(f'{e:.3g}' for e in rels)} (tol {tol}; "
            f"two runs bitwise equal) kernel={ms:.4f} ms plain="
            f"{plain_ms:.4f} ms sdpa_bwd={lib_ms:.4f} ms bound="
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); device: kernel="
            f"{dev_ms:.4f} ms sdpa_bwd={lib_dev_ms:.4f} ms")
        del got, again, exp, wantg, lib
    return rows, errs


@contextlib.contextmanager
def k3_calls():
    """While open, every model attention call through K3's entry point
    appends its ``causal`` flag to the list it yields: self-attention
    (True) and cross-attention (False) told apart, on any device."""
    from repro_torch.models.layers import attention

    seen, orig = [], attention.flash_attention

    def counted(q, k, v, *, causal=True, **kw):
        seen.append(causal)
        return orig(q, k, v, causal=causal, **kw)

    attention.flash_attention = counted
    try:
        yield seen
    finally:
        attention.flash_attention = orig


def frontend_cfg(arch, reduced=False, f32=False, layers=None):
    """``arch``'s config (reduced, in float32, cut to ``layers``)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    return dataclasses.replace(cfg, num_layers=min(layers or cfg.num_layers,
                                                   cfg.num_layers))


def phase_serve_whisper(device="cuda", reduced=False,
                        rows=WHISPER_SERVE_ROWS, lens=WHISPER_SERVE_LENS,
                        gen=WHISPER_SERVE_GEN, phase="serve-whisper"):
    """5h: whisper-tiny at full width and depth in its dtypes (f32 params,
    bf16 compute) through the model-level path the reference serves audio
    with (``ServeEngine`` refuses frontends in both packages): for each
    prompt length, a batch of ``rows`` rows, each with its own encoder
    output, through ``forward_prefill_cached`` and ``gen - 1`` greedy
    ``decode_step`` calls (the memory re-projected and cross-attended
    every step, as the reference). K3's launches, self and cross, against
    the layout: a prefill runs both in every layer, a decode step the
    cross-attention alone (its self-attention reads the cache with plain
    products). Returns the run's launch counts."""
    from repro_torch.models import transformer as Tm

    on_card = torch.device(device).type == "cuda"
    free_device_memory()
    cfg = frontend_cfg(WHISPER, reduced)
    g = torch.Generator(device)
    g.manual_seed(4)
    params = Tm.init_params(g, cfg)
    rng = np.random.default_rng(4)
    max_len = max(lens) + gen
    batches = []
    for P in (lens[0],) + tuple(lens):      # the first is the warm-up's
        b = frontend_batch(cfg, rng, {
            "tokens": rng.integers(0, cfg.vocab_size, (rows, P))})
        batches.append({k: torch.from_numpy(v).to(device)
                        for k, v in b.items()})

    def run(batch):
        P = batch["tokens"].shape[1]
        t0 = time.perf_counter()
        logits, cache = Tm.forward_prefill_cached(params, batch, cfg, max_len)
        tok = logits.argmax(-1)
        sync(device)
        t1 = time.perf_counter()
        out = [tok]
        for i in range(gen - 1):
            logits, cache = Tm.decode_step(params, dict(batch, tokens=tok),
                                           cache, P + i, cfg)
            tok = logits.argmax(-1)
            out.append(tok)
        sync(device)
        t2 = time.perf_counter()
        check(bool(torch.isfinite(logits).all()), f"{phase}: finite logits "
              f"at prompt {P}")
        return torch.cat(out, 1), t1 - t0, (t2 - t1) / max(1, gen - 1)

    with torch.no_grad():
        run(batches[0])
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with k3_calls() as seen:
            res = [run(b) for b in batches[1:]]
        wall = time.perf_counter() - t0
    counts = read_counts()
    n_attn = sum(s.mixer == "attn" for s in cfg.block_specs)
    n_cross = sum(s.cross_attn for s in cfg.block_specs)
    want_self = len(lens) * n_attn
    want_cross = len(lens) * n_cross * gen      # prefill + (gen - 1) steps
    n_self, n_x = sum(seen), len(seen) - sum(seen)
    check((n_self, n_x) == (want_self, want_cross),
          f"{phase}: K3 calls self {n_self} cross {n_x} != layout "
          f"{want_self} / {want_cross}")
    if on_card:
        check(counts["flash_fwd"] == want_self + want_cross and
              counts["flash_bwd"] == 0, f"{phase}: K3 launches {counts} != "
              f"{want_self + want_cross}")
    tokens = rows * gen * len(lens)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say(phase, f"{cfg.name} ({cfg.num_layers} layers, {n_cross} "
        f"cross-attending) {cfg.param_dtype} params, {cfg.dtype} compute: "
        f"{len(lens)} batches of {rows} rows, prompts {lens}, {gen} new "
        f"tokens each, a {cfg.num_prefix_tokens} x {cfg.frontend_dim} "
        f"encoder output a row: {tokens} tokens in {wall:.3f} s -> "
        f"{tokens / wall:.1f} tok/s; prefill ms "
        + ", ".join(f"{P}: {1e3 * r[1]:.2f}" for P, r in zip(lens, res))
        + "; decode step ms "
        + ", ".join(f"{P}: {1e3 * r[2]:.2f}" for P, r in zip(lens, res))
        + f"; peak {peak / 2**20:.0f} MiB allocated; K3 launches "
        f"{counts['flash_fwd']} (self {n_self}, cross {n_x}: the layout's "
        f"{want_self} + {want_cross})")
    del params, batches
    free_device_memory()
    return counts


def phase_check_whisper(device="cuda", reduced=False, rows=2, prompt_len=64,
                        max_len=96, phase="check-whisper"):
    """5i: whisper-tiny in float32 at full width and depth, TF32 off, 2
    rows with their own encoder output: the fused prefill (K3, self and
    cross) against the token-by-token decode loop (the cross-attention
    through K3's non-causal mode at one query, the self-attention plain)
    -- the last position's logits within LOGIT_ATOL, every layer's cache
    within STATE_RTOL of its largest entry."""
    from repro_torch.models import transformer as Tm

    free_device_memory()
    cfg = frontend_cfg(WHISPER, reduced, f32=True)
    g = torch.Generator(device)
    g.manual_seed(5)
    params = Tm.init_params(g, cfg)
    rng = np.random.default_rng(5)
    b = frontend_batch(cfg, rng, {
        "tokens": rng.integers(0, cfg.vocab_size, (rows, prompt_len))})
    batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    with torch.no_grad():
        logits, cache = Tm.forward_prefill_cached(params, batch, cfg, max_len)
        loop = Tm.init_decode_cache(cfg, rows, max_len, device=device)
        for i in range(prompt_len):
            last, loop = Tm.decode_step(
                params, dict(batch, tokens=batch["tokens"][:, i:i + 1]),
                loop, i, cfg)
    err = (logits[:, 0] - last[:, 0]).abs().max().item()
    check(err <= LOGIT_ATOL, f"{phase}: prefill vs loop logits {err} > "
          f"{LOGIT_ATOL}")
    worst = {}
    for layer, leaves_ in loop.items():
        for key, want in leaves_.items():
            e = rel_err(cache[layer][key], want)
            check(e <= STATE_RTOL, f"{phase}: prefill vs loop {layer}/{key}:"
                  f" {e} > {STATE_RTOL} of its largest entry")
            worst[key] = max(worst.get(key, 0.0), e)
    say(phase, f"{cfg.name} float32, {cfg.num_layers} layers, {rows} rows "
        f"of a {prompt_len}-token prompt on {cfg.num_prefix_tokens} encoder "
        f"frames: prefill logits (K3) vs token-by-token loop: "
        f"max_abs_err={err:.3g} (atol {LOGIT_ATOL}, max |logit| "
        f"{last.abs().max().item():.3g}); cache leaves, worst error over "
        f"the largest entry (tol {STATE_RTOL}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    del params, cache, loop
    free_device_memory()


def phase_train_frontend(device="cuda", arch=WHISPER, seq=WHISPER_SEQ,
                         layers=None, phase="train-whisper", peak_bar=None,
                         reduced=False):
    """19 (whisper-tiny, full depth) and 20 (internvl2-26b cut to
    ``layers``): phase 6's cell (:func:`frontend_train_flags` at ``seq``
    text tokens a row) in the arch's own dtypes (at reduced width with
    ``reduced``) as a :class:`RoundCell`, each row with its own encoder
    output (whisper's 1500 audio frames; internvl2's 256 patches, put
    before the text with labels of weight 0): the memory reckoning (before
    the run; the peak checked against ``peak_bar``), the launches per
    round against the layout (K3 self and cross, K1 = K2 = 1 a step),
    finite losses, round seconds, tokens/s (text tokens), peak memory and
    a profiled round. Returns the launches of the rounds."""
    cell = RoundCell(phase, frontend_train_flags(seq), device,
                     cfg=frontend_cfg(arch, reduced), layers=layers)
    counts, _ = cell.rounds(peak_bar=peak_bar)
    if cell.on_card:
        profile(f"{cell.cfg.name} training round", cell.run, 8,
                watch=TRAIN_WATCH)
    cell.close()
    return counts


def phase_whisper_train_check(device="cuda", reduced=False):
    """19b: :func:`phase_train_check` on whisper-tiny in float32 at full
    width and depth (unless ``reduced``), 2 clients x 64 tokens, each on
    its own 1500 encoder frames: losses, every grad leaf (the projector's
    through the memory's cotangent, and ``pos``, printed) and one round's
    client updates, card against CPU; then a step in its own dtypes (f32
    params, bf16 compute) at 2 clients x 4 x 448 tokens twice, bitwise
    (:func:`step_repeat`)."""
    free_device_memory()
    phase_train_check(device, reduced, C=2, S=64, T=2, arch=WHISPER,
                      phase="check-whisper-train")
    step_repeat(frontend_cfg(WHISPER, reduced), device, C=2, Bk=4,
                S=WHISPER_SEQ, seed=6, phase="check-whisper-train")


def phase_vlm_projector_check(device="cuda", reduced=False,
                              rows=VLM_PROJECTOR_ROWS, phase="check-vlm"):
    """20b: internvl2-26b's projector alone at full width (unless
    ``reduced``) in float32, TF32 off: (rows, 256, 3200) -> (rows, 256,
    6144), its output and the gradients of all four leaves (the layer
    norm's scale and bias, fc1, fc2) under a random cotangent, card
    against CPU, each within LEAF_RTOL of its largest entry. (A
    full-width split step of internvl2 on the CPU would take minutes.)"""
    from repro_torch.models.layers import frontends
    from repro_torch.tree import leaves, tree_map

    cfg = frontend_cfg(VLM, reduced, f32=True)
    g = torch.Generator("cpu")
    g.manual_seed(7)
    params = frontends.projector_init(g, cfg)
    rng = np.random.default_rng(7)
    params["norm"]["bias"] = torch.from_numpy(0.1 * rng.standard_normal(
        cfg.frontend_dim, dtype=np.float32))
    emb = torch.from_numpy(0.1 * rng.standard_normal(
        (rows, cfg.num_prefix_tokens, cfg.frontend_dim), dtype=np.float32))
    ct = torch.from_numpy(rng.standard_normal(
        (rows, cfg.num_prefix_tokens, cfg.d_model), dtype=np.float32))
    res = {}
    for dev in (device, "cpu"):
        p = tree_map(lambda a: a.to(dev).requires_grad_(), params)
        out = frontends.projector_apply(p, emb.to(dev), cfg)
        grads = torch.autograd.grad(out, leaves(p), ct.to(dev))
        sync(dev)
        res[dev] = [out.detach().cpu()] + [a.cpu() for a in grads]
    names = ["output", "norm.scale", "norm.bias", "fc1", "fc2"]
    errs = [rel_err(a, b) for a, b in zip(res[device], res["cpu"])]
    check(max(errs) <= LEAF_RTOL, f"{phase}: projector card vs cpu "
          f"{dict(zip(names, errs))} > {LEAF_RTOL}")
    say(phase, f"{cfg.name}'s projector, float32, ({rows}, "
        f"{cfg.num_prefix_tokens}, {cfg.frontend_dim}) -> ({rows}, "
        f"{cfg.num_prefix_tokens}, {cfg.d_model}), {device} vs cpu, error "
        f"over the largest entry (tol {LEAF_RTOL}): "
        + ", ".join(f"{n} {e:.3g}" for n, e in zip(names, errs)))


def phase_frontends(device="cuda"):
    """5h, 5i, 19, 19b, 20 and 20b; returns the launches of the served
    and trained runs: {'serve-whisper', 'train-whisper', 'train-vlm'}."""
    out = {}
    out["serve-whisper"] = run_phase("serve-whisper", phase_serve_whisper,
                                     device)
    run_phase("check-whisper", phase_check_whisper, device)
    out["train-whisper"] = run_phase("train-whisper", phase_train_frontend,
                                     device)
    run_phase("check-whisper-train", phase_whisper_train_check, device)
    out["train-vlm"] = run_phase(
        "train-vlm", phase_train_frontend, device, arch=VLM, seq=VLM_SEQ,
        layers=VLM_TRAIN_LAYERS, phase="train-vlm", peak_bar=PEAK_BAR)
    run_phase("check-vlm", phase_vlm_projector_check, device)
    return out


# ---------------------------------------------------------------------------
# phase 21 (dp, PR 29): the multi-device path, backend lace_dp
# ---------------------------------------------------------------------------
# Phase 13's cell (full-width qwen1.5-0.5b, SCALA, 16 clients, uniform:0.25
# balanced over 2 client shards, one 512-token document a slot, 2 local
# steps, split after layer 2, SGD) through ExperimentSpec(backend=
# "lace_dp") -> build(spec, mesh=grid, batch_specs=) -> Trainer, and the
# async event through fed.make_async_runner. (a) A world of one over NCCL
# in this process: the masked round (bias_compensated), the sparse round
# with the in-shard gather (weighted), a dual-boundary step and a
# faulted, guarded masked step (a NaN corruption rejected, the step
# re-run over the survivors), each against the single-program ``lace``
# program of the same spec (the same
# seeded params, host batches and masks), the gradients float32 on the
# wire (as the reference's own test); then one masked step in the spec's
# default bfloat16 on the wire against ``lace``'s, within DP_WIRE_RTOL:
# twice one bf16 rounding of a gradient (up to 2^-8 of itself), for a
# leaf that starts at zero -- the biases -- is measured against its own
# update (over two steps the second's gradients move with the first's
# rounding: 1.5e-2 of a bias at this lr in the first run). (b)
# Two ranks on the one
# card over gloo (client axis 2, 8 of the 16 clients a rank), spawned
# here: the sparse round, held against (a)'s, and the lace_dp async event
# (cohort 4, the two-shard pop: two arrivals a shard) held against the
# single-program ``lace`` event on the same arrivals. The arrivals' delays
# are zero; a recorded delay model makes the single program pop the same
# four slots (0, 1 of shard 0; 8, 9 of shard 1) the shards pop. Every
# comparison runs on the card ((b)'s references shared with the ranks
# over CUDA IPC): every weight leaf within DP_PARAM_RTOL of its largest
# entry (the reference's own bar, tests/test_fed.py:624-625); the bias
# leaves, which start at zero, against the largest entry of their half's
# biases (:func:`dp_gap`; the key bias's update is rounding alone, its
# exact gradient zero), within DP_PARAM_RTOL, and the last step's
# loss_server within DP_LOSS_ATOL, where both sides run the same
# products on the same per-token scales (4 x 512 participating tokens:
# 1 / W exact, so ``lace_dp``'s raw sums divided by W are ``lace``'s
# scaled sums bit for bit). The cell computes in bfloat16, so where the
# products' shapes differ (the sparse round's gathered slots against the
# masked round's 16, two ranks' halves against one rank's whole) or 1 / W
# is inexact (the faulted step's survivors) the biases within
# DP_SHAPE_RTOL (2^-5: a bias's gradient, a sum over the tokens of
# cotangents that cancel, is rounded to bf16 at the cast to the float32
# master, about 2^-8 of itself; the async event's value biases came to
# 1.33e-2 of the server's largest bias in the run that set this bar)
# and the last step's loss within DP_SHAPE_LOSS_RTOL relative: the first
# step at this lr takes the loss from 11.9 to 5.8, so the second step's
# loss carries the first's rounding (two ranks against one: 1.4e-4
# absolute, 2.5e-5 relative; the weights within 7.2e-5).
DP_FLAGS = ["--arch", ARCH, "--clients", "16", "--participation",
            "uniform:0.25:2", "--aggregator", "bias_compensated",
            "--local-iters", "2", "--seq", "512", "--server-batch", "16",
            "--docs-per-client", "8", "--rounds", "1", "--seed", "0"]
DP_SPARSE_FLAGS = DP_FLAGS[:6] + ["--slot-gather", "--aggregator",
                                  "weighted"] + DP_FLAGS[8:]
DP_STEP_FLAGS = DP_FLAGS[:8] + ["--local-iters", "1"] + DP_FLAGS[10:]
DP_DUAL_FLAGS = DP_STEP_FLAGS + ["--boundary", "dual"]
# a masked step under drops and a NaN corruption, guarded: the guards
# reject the corrupted slots and re-run the step over the survivors
DP_FAULT_FLAGS = DP_STEP_FLAGS + ["--faults", "drop:0.2,corrupt:0.25:nan",
                                  "--guards", "nonfinite,clip:10"]
DP_PARAM_RTOL, DP_LOSS_ATOL = 5e-4, 1e-5
DP_SHAPE_RTOL, DP_SHAPE_LOSS_RTOL = 2 ** -5, 1e-4
DP_WIRE_RTOL = 2 ** -7
DP_COHORT = 4
DP_ARRIVALS = (0, 1, 8, 9)


def dp_spec(flags, backend, wire=None, reduced=False):
    """The spec of ``flags`` on ``backend``, its gradients all_reduced in
    ``wire`` (None: float32)."""
    from repro_torch.launch import train

    spec = train.spec_from_args(train.build_parser().parse_args(
        flags + (["--reduced"] if reduced else [])))
    return dataclasses.replace(
        spec, scala=dataclasses.replace(spec.scala, grad_reduce_dtype=wire),
        execution=dataclasses.replace(spec.execution,
                                      backend=backend)).validate()


def dp_batch_specs(spec, grid):
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.input_specs import train_batch_specs
    from repro_torch.sharding import tree_specs

    C = spec.slots
    shapes, axes = train_batch_specs(spec.model_config(), InputShape(
        "dp", spec.data.seq, C, "train"), C)
    return tree_specs(axes, shapes, grid)


def dp_global(params):
    """The global model of a state after its FL phase: the client half
    (every slot holds it; row 0 taken) and the server half."""
    from repro_torch.tree import tree_map

    return {"client": tree_map(lambda a: a[0], params["client"]),
            "server": params["server"]}


def dp_trainer_round(phase, spec, device, grid=None):
    """One round of ``spec`` through the Trainer (``grid``: on that grid):
    (global params, last loss_server, seconds, launches, the grid's
    collective stats, peak bytes, clients the guards rejected)."""
    from repro_torch import api

    free_device_memory()
    kw = ({} if grid is None else
          dict(mesh=grid, batch_specs=dp_batch_specs(spec, grid)))
    tr = api.Trainer(spec, device=device, **kw)
    if grid is not None:
        grid.reset_stats()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    zero_counts()
    t0 = time.perf_counter()
    hist = tr.run()
    sync(device)
    secs = time.perf_counter() - t0
    rejected = sum(h.get("guard_rejected", 0.0) for h in hist)
    n = read_counts_raw()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    stats = None if grid is None else {g: dict(v) for g, v in
                                       grid.stats.items()}
    out = dp_global(tr.state.inner.params)
    del tr
    return out, hist[-1]["loss_server"], secs, n, stats, peak, rejected


def dp_gap(got, want):
    """How far ``got`` lies from ``want``: (the worst weight leaf's max
    |got - want| over its max |want|, its name; the worst bias leaf's max
    |got - want| over the largest entry of its half's biases, its name).
    The biases start at zero, so their largest entry is their update, and
    the key bias's is rounding alone (its exact gradient is zero: a key
    bias shifts all of a query's scores alike); a half's biases together
    scale them by the q and v biases' real updates. Computed where
    ``got`` lies (``want`` copied there a leaf at a time)."""
    got, want = state_leaves(got), state_leaves(want)
    is_bias = lambda key: key.rsplit("/", 1)[-1].startswith("b")  # noqa
    scale = {}
    for key, b in want.items():
        if is_bias(key):
            half = key.split("/", 1)[0]
            scale[half] = max(scale.get(half, 0.0), b.abs().max().item())
    worst = {False: (0.0, ""), True: (0.0, "")}
    for key, b in want.items():
        a = got[key]
        b = b.to(a.device)
        den = (scale[key.split("/", 1)[0]] if is_bias(key)
               else b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item() / max(den, 1e-30)
        worst[is_bias(key)] = max(worst[is_bias(key)], (err, key))
    return worst[False] + worst[True]


def dp_gap_text(gap):
    w_err, w_leaf, b_err, b_leaf = gap
    return (f"worst weight leaf {w_err:.3g} of its largest entry ({w_leaf}), "
            f"worst bias leaf {b_err:.3g} of its half's largest bias "
            f"({b_leaf})")


def dp_loss_ok(loss, want, shapes_differ):
    if shapes_differ:
        return abs(loss - want) <= DP_SHAPE_LOSS_RTOL * abs(want)
    return abs(loss - want) <= DP_LOSS_ATOL


def dp_gap_ok(gap, bias_rtol, weight_rtol=DP_PARAM_RTOL):
    return gap[0] <= weight_rtol and gap[2] <= bias_rtol


def dp_check(phase, what, got, want, loss, want_loss, bias_rtol=DP_PARAM_RTOL,
             weight_rtol=DP_PARAM_RTOL):
    gap = dp_gap(got, want)
    shapes = bias_rtol == DP_SHAPE_RTOL
    check(dp_gap_ok(gap, bias_rtol, weight_rtol)
          and dp_loss_ok(loss, want_loss, shapes),
          f"{phase} {what}: {dp_gap_text(gap)}, loss_server {loss} vs "
          f"{want_loss}")
    say(phase, f"{what}: loss_server {loss:.7f} vs {want_loss:.7f} ("
        + (f"rtol {DP_SHAPE_LOSS_RTOL}" if shapes else f"atol {DP_LOSS_ATOL}")
        + f"); {len(state_leaves(want))} leaves, {dp_gap_text(gap)} (tol "
        f"{weight_rtol:.3g}, {bias_rtol:.3g})")
    return gap


def dp_stats_text(stats, steps):
    return ", ".join(f"{g} {v['calls'] / steps:g} calls "
                     f"{v['bytes'] / steps / 1e6:.1f} MB" for g, v in
                     stats.items()) + " a step"


def dp_launch_check(phase, spec, n, slots, steps, device,
                    boundary="fused"):
    """On a card, a lace_dp run's launches: the layout's a step over
    ``slots`` computed slots, the boundary's in raw-sum mode (every LACE
    launch). The CPU's plain versions launch nothing."""
    cfg = spec.model_config()
    want = {k: steps * v for k, v in slot_launches(slots, cfg,
                                                    boundary).items()}
    got = {k: n[k] for k in want}
    raw = {k: n["raw_" + k] for k in ("lace_fwd", "lace_bwd", "lace1_fwd",
                                      "lace1_bwd")}
    if torch.device(device).type == "cuda":
        check(got == want and raw == {k: want[k] for k in raw},
              f"{phase} launches {got} (raw {raw}) != {want}")


def dp_async_inputs(spec, device):
    """The async cell: the spec's model and seeded params, one event's
    round batches (T, 16, 1, 512) and data sizes from a seeded host
    stream, and the recorded delays under which the 16-slot pop takes
    DP_ARRIVALS (their delays 0, the others' 1; the re-dispatch 0)."""
    from repro_torch import fed
    from repro_torch.api.build import text_split_init

    K, T, S = spec.slots, spec.scala.local_iters, spec.data.seq
    model, params = text_split_init(spec, K, device)
    cfg = spec.model_config()
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (T, K, 1, S + 1))
    batches = {"tokens": torch.from_numpy(toks[..., :-1]).to(device),
               "labels": torch.from_numpy(toks[..., 1:]).to(device),
               "weights": torch.ones((T, K, 1, S), device=device)}
    sizes = torch.from_numpy(rng.integers(1, 9, K).astype(np.float32)
                             ).to(device)
    first = np.ones(K, np.float32)
    first[list(DP_ARRIVALS)] = 0.0
    delays = fed.delays.recorded([first, np.zeros(DP_COHORT, np.float32)])
    return model, params, batches, sizes, delays


def dp_event(spec, device, grid=None):
    """One event of the async cell: the single program's (``grid`` None,
    backend lace) or the lace_dp event on ``grid``: (global params,
    loss_server, seconds, launches, stats, the arrivals' slot ids)."""
    from repro_torch import fed
    from repro_torch.core import engine

    free_device_memory()
    model, params, batches, sizes, delays = dp_async_inputs(spec, device)
    if grid is not None:
        params = {"client": grid.local_clients(params["client"]),
                  "server": params["server"]}
    state = engine.init_train_state(params, spec.optim.make())
    afed = fed.init_async_state(3, params["client"], delays,
                                num_clients=spec.slots, mesh=grid)
    ev = fed.make_async_runner(
        model, spec.scala, backend="lace" if grid is None else "lace_dp",
        delays=delays, cohort=DP_COHORT, mesh=grid,
        batch_specs=None if grid is None else dp_batch_specs(spec, grid))
    if grid is not None:
        grid.reset_stats()
    sync(device)
    zero_counts()
    t0 = time.perf_counter()
    state, afed, m = ev(state, afed, batches, sizes)
    sync(device)
    secs = time.perf_counter() - t0
    n = read_counts_raw()
    mask = m["arrival_mask"]
    if grid is not None:
        mask = grid.all_gather_host(mask)
    arrivals = tuple(np.flatnonzero(mask).tolist())
    stats = None if grid is None else {g: dict(v) for g, v in
                                       grid.stats.items()}
    return (dp_global(state.params), float(m["loss_server"]), secs, n, stats,
            arrivals)


def dp_rank(rank, world, port, device, reduced, refs, queue):
    """One rank of (b): a (data=2, model=1) grid over gloo; the sparse
    round against (a)'s, the async event against the single program's,
    both compared on the card. Puts its report on ``queue``."""
    import torch.distributed as dist

    from repro_torch.sharding import Grid

    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    phase = f"dp-gloo rank {rank}"
    try:
        grid = Grid(("data", "model"), (world, 1))
        check(grid.backend == "gloo", f"{phase}: backend {grid.backend}")
        t0 = time.perf_counter()
        sparse = dp_trainer_round(phase, dp_spec(DP_SPARSE_FLAGS, "lace_dp",
                                                 reduced=reduced),
                                  device, grid)
        sparse_err = dp_gap(sparse[0], refs["sparse"]["params"])
        event = dp_event(dp_spec(DP_FLAGS, "lace_dp", reduced=reduced),
                         device, grid)
        event_err = dp_gap(event[0], refs["async"]["params"])
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(device).type == "cuda" else 0)
        queue.put({"rank": rank, "seconds": time.perf_counter() - t0,
                   "sparse": (sparse[1:5], sparse_err),
                   "async": (event[1:], event_err), "peak": peak})
    except BaseException as e:                      # noqa: BLE001
        queue.put({"rank": rank, "error": repr(e)})
        raise
    finally:
        # release (a)'s shared tensors before the parent collects them
        del refs
        gc.collect()
        dist.destroy_process_group()


def phase_dp(device="cuda", reduced=False):
    """Phase 21: (a) a world of one over NCCL (gloo on the CPU), (b) two
    ranks on the one card over gloo; returns the launches of the lace_dp
    runs of (a) and (b) together."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.sharding import free_port, init_local_group, \
        make_host_grid

    on_card = torch.device(device).type == "cuda"
    steps = 2
    total = None

    def add(n):
        nonlocal total
        total = dict(n) if total is None else {k: total[k] + n[k]
                                               for k in total}

    # --- (a) a world of one ---
    made = init_local_group("nccl" if on_card else "gloo")
    try:
        grid = make_host_grid()
        say("dp", f"(a) {grid}: client shards {grid.n_client_shards}, inner "
            f"{grid.inner_size}")
        want = dp_trainer_round("dp", dp_spec(DP_FLAGS, "lace", None,
                                              reduced), device)
        got = dp_trainer_round("dp", dp_spec(DP_FLAGS, "lace_dp", None,
                                             reduced), device, grid)
        dp_check("dp", "(a) masked lace_dp (float32 wire) vs lace", got[0],
                 want[0], got[1], want[1])
        dp_launch_check("dp (a) masked", dp_spec(DP_FLAGS, "lace_dp",
                                                 None, reduced), got[3],
                        16, steps, device)
        add(got[3])
        say("dp", f"(a) masked round: lace_dp {got[2]:.3f} s, lace "
            f"{want[2]:.3f} s; launches K3 fwd {got[3]['flash_fwd']} bwd "
            f"{got[3]['flash_bwd']}, K1 {got[3]['lace_fwd']} (raw "
            f"{got[3]['raw_lace_fwd']}), K2 {got[3]['lace_bwd']} (raw "
            f"{got[3]['raw_lace_bwd']}); all_reduce "
            f"{dp_stats_text(got[4], steps)}; peak "
            f"{got[5] / 2**20:.0f} MiB")
        del want, got
        want = dp_trainer_round("dp", dp_spec(DP_STEP_FLAGS, "lace", None,
                                              reduced), device)
        wire = dp_trainer_round("dp", dp_spec(DP_STEP_FLAGS, "lace_dp",
                                              "bfloat16", reduced), device,
                                grid)
        dp_check("dp", "(a) masked lace_dp step, bfloat16 on the wire, vs "
                 "lace", wire[0], want[0], wire[1], want[1], DP_WIRE_RTOL,
                 DP_WIRE_RTOL)
        add(wire[3])
        say("dp", f"(a) masked step, bfloat16 wire: {wire[2]:.3f} s; "
            f"all_reduce {dp_stats_text(wire[4], 1)}")
        del want, wire
        want = dp_trainer_round("dp", dp_spec(
            DP_SPARSE_FLAGS[:6] + DP_SPARSE_FLAGS[7:], "lace", None,
            reduced), device)
        sparse = dp_trainer_round("dp", dp_spec(DP_SPARSE_FLAGS, "lace_dp",
                                                reduced=reduced), device,
                                  grid)
        dp_check("dp", "(a) sparse in-shard lace_dp vs the masked lace "
                 "round", sparse[0], want[0], sparse[1], want[1],
                 DP_SHAPE_RTOL)
        add(sparse[3])
        dp_launch_check("dp (a) sparse", dp_spec(DP_SPARSE_FLAGS, "lace_dp",
                                                 reduced=reduced),
                        sparse[3], 4, steps, device)
        say("dp", f"(a) sparse round: lace_dp {sparse[2]:.3f} s, masked "
            f"lace {want[2]:.3f} s; all_reduce "
            f"{dp_stats_text(sparse[4], steps)}; peak "
            f"{sparse[5] / 2**20:.0f} MiB")
        del want
        want = dp_trainer_round("dp", dp_spec(DP_DUAL_FLAGS, "lace", None,
                                              reduced), device)
        got = dp_trainer_round("dp", dp_spec(DP_DUAL_FLAGS, "lace_dp", None,
                                             reduced), device, grid)
        dp_check("dp", "(a) dual-boundary lace_dp step vs lace", got[0],
                 want[0], got[1], want[1])
        dp_launch_check("dp (a) dual", dp_spec(DP_DUAL_FLAGS, "lace_dp",
                                               None, reduced), got[3], 16,
                        1, device, "dual")
        add(got[3])
        say("dp", f"(a) dual step: lace_dp {got[2]:.3f} s, lace "
            f"{want[2]:.3f} s; K4 {got[3]['lace1_fwd']} (raw "
            f"{got[3]['raw_lace1_fwd']}), K5 {got[3]['lace1_bwd']} (raw "
            f"{got[3]['raw_lace1_bwd']})")
        del want, got
        want = dp_trainer_round("dp", dp_spec(DP_FAULT_FLAGS, "lace", None,
                                              reduced), device)
        got = dp_trainer_round("dp", dp_spec(DP_FAULT_FLAGS, "lace_dp",
                                             None, reduced), device, grid)
        # the survivors' weight sum (3 x 512 tokens) makes the per-token
        # scale 1 / W inexact, where ``lace`` scales inside the kernels
        # and ``lace_dp`` after its raw sums: a last-bit difference in the
        # cotangent, which the bf16 trunk rounds on (shapes differ in
        # effect: DP_SHAPE_RTOL)
        dp_check("dp", "(a) faulted, guarded masked lace_dp step vs lace",
                 got[0], want[0], got[1], want[1], DP_SHAPE_RTOL)
        check(got[6] == want[6] and got[6] > 0, f"dp faulted step: "
              f"rejected {got[6]} vs lace's {want[6]}")
        add(got[3])
        say("dp", f"(a) faulted step: {got[6]:g} slots rejected (lace "
            f"{want[6]:g}), the step re-run over the survivors; lace_dp "
            f"{got[2]:.3f} s, lace {want[2]:.3f} s")
        del want, got
        event = dp_event(dp_spec(DP_FLAGS, "lace", reduced=reduced), device)
        check(event[5] == DP_ARRIVALS, f"dp single-program event popped "
              f"{event[5]}, not {DP_ARRIVALS}")
        say("dp", f"(b)'s reference: the single-program lace event on "
            f"arrivals {event[5]}, {event[2]:.3f} s")
    finally:
        if made:
            dist.destroy_process_group()

    # --- (b) two ranks on the one card over gloo ---
    refs = {"sparse": {"params": sparse[0], "loss": sparse[1]},
            "async": {"params": event[0], "loss": event[1]}}
    free_device_memory()      # the ranks need the room (a) cached
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    t0 = time.perf_counter()
    # the ranks' reports are a few kB, below a pipe's buffer: joining
    # before reading the queue cannot block
    mp.start_processes(dp_rank, args=(2, free_port(), device, reduced, refs,
                                      queue), nprocs=2, join=True,
                       start_method="spawn")
    reports = sorted((queue.get() for _ in range(2)),
                     key=lambda r: r["rank"])
    secs = time.perf_counter() - t0
    ref_loss = {k: v["loss"] for k, v in refs.items()}
    del refs, sparse, event
    if on_card:
        torch.cuda.ipc_collect()       # the ranks' handles on (a)'s refs
    for r in reports:
        check("error" not in r, f"dp rank {r['rank']}: {r.get('error')}")
    for r in reports:
        (loss, s_secs, n, stats), gap = r["sparse"]
        check(dp_gap_ok(gap, DP_SHAPE_RTOL)
              and dp_loss_ok(loss, ref_loss["sparse"], True),
              f"dp (b) rank {r['rank']} sparse: {dp_gap_text(gap)}, loss "
              f"{loss} vs {ref_loss['sparse']}")
        (e_loss, e_secs, e_n, e_stats, arrivals), e_gap = r["async"]
        check(dp_gap_ok(e_gap, DP_SHAPE_RTOL) and arrivals == DP_ARRIVALS
              and dp_loss_ok(e_loss, ref_loss["async"], True),
              f"dp (b) rank {r['rank']} async: {dp_gap_text(e_gap)}, "
              f"arrivals {arrivals}, loss {e_loss} vs "
              f"{ref_loss['async']}")
        dp_launch_check(f"dp (b) rank {r['rank']} sparse", dp_spec(
            DP_SPARSE_FLAGS, "lace_dp", reduced=reduced), n, 2, steps,
            device)
        dp_launch_check(f"dp (b) rank {r['rank']} async", dp_spec(
            DP_FLAGS, "lace_dp", reduced=reduced), e_n, 2, steps, device)
        add(n)
        add(e_n)
        say("dp", f"(b) rank {r['rank']} over gloo: sparse round "
            f"{s_secs:.3f} s, loss_server {loss:.7f} vs (a) "
            f"{ref_loss['sparse']:.7f}, {dp_gap_text(gap)}; all_reduce "
            f"{dp_stats_text(stats, steps)}; async event {e_secs:.3f} s on "
            f"arrivals {arrivals}, loss_server {e_loss:.7f} vs "
            f"{ref_loss['async']:.7f}, {dp_gap_text(e_gap)} (tol "
            f"{DP_PARAM_RTOL}, {DP_SHAPE_RTOL:.3g}, loss rtol "
            f"{DP_SHAPE_LOSS_RTOL}); "
            f"all_reduce "
            f"{dp_stats_text(e_stats, steps)}; rank {r['seconds']:.1f} s, "
            f"peak {r['peak'] / 2**20:.0f} MiB")
    say("dp", f"(b) two ranks over gloo: {secs:.1f} s with the spawn")
    return total



# ---------------------------------------------------------------------------
# phase 22: the tooling (boundary and serve legs, the dry run, and the dry
# run held against the card)
# ---------------------------------------------------------------------------

TOOLING_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
TOOLING_GRIDS = ("1", "16x16")
# phase 6's local step: slots x rows a slot x tokens (the LM driver's
# defaults: lace backend, fused boundary, plain SGD)
TOOLING_STEP = (4, 4, 512)
TOOLING_STEP_REPS = 3
TOOLING_BAR_S = 90          # the phase's share of the run's time limit
SERVE_REQUESTS, SERVE_SLOTS, SERVE_REPS = 12, (2, 4), 2   # run.py's call


def launches_text(c):
    return (f"K1 {c['lace_fwd']}, K2 {c['lace_bwd']}, K4 {c['lace1_fwd']}, "
            f"K5 {c['lace1_bwd']}, K3 fwd {c['flash_fwd']} bwd "
            f"{c['flash_bwd']}")


def tooling_boundary(device="cuda", grid=None, qwen_cell=True):
    """(a) The boundary leg: the reference's grid on both backends (and
    the bf16 leg on a card), qwen1.5-0.5b's head (d 1024, V 151936, 4 x
    2048 tokens), then the fused-against-dual guard. Returns the launch
    counts (K1, K2, K4 and K5 must launch on a card)."""
    from repro_torch.benchmarks import boundary as bb

    cuda = torch.device(device).type == "cuda"
    grid = bb.GRID if grid is None else grid
    zero_counts()
    res = bb.bench_boundary(grid=grid, reps=3, device=device)
    legs = {f"{b} f32": e for b, e in res["backends"].items()}
    if cuda:
        legs["lace bf16"] = bb.bench_boundary_bf16(grid=grid, reps=3,
                                                   device=device)
    if qwen_cell:
        legs["lace qwen head"] = bb.bench_boundary(
            grid=bb.QWEN_CELL, backends=("lace",), reps=3,
            classes=bb.QWEN_CLASSES, device=device)["backends"]["lace"]
    for leg, entry in legs.items():
        for cell, r in entry.items():
            if isinstance(r, dict):
                say("tooling", f"boundary {leg} {cell}: fused "
                    f"{r['fused_ms']:.3f} ms, dual {r['dual_ms']:.3f} ms, "
                    f"fused_speedup {r['fused_speedup']}")
    guard = bb.smoke_guard(device)
    counts = read_counts()
    say("tooling", f"boundary guard: fused_speedup "
        f"{guard['backends']['lace']['max_speedup']} (>= 1); launches "
        f"{launches_text(counts)}")
    if cuda:
        check(all(counts[k] > 0 for k in ("lace_fwd", "lace_bwd",
                                          "lace1_fwd", "lace1_bwd")),
              f"the boundary leg launched K1, K2, K4 and K5: {counts}")
    return counts


def serve_admits(n_requests, lens, reps, slots_list):
    """The admits of :func:`repro_torch.benchmarks.serve.bench_serve`: per
    slot count and leg one warm-up request per prompt length, then the
    requests once a rep (batch static, continuous, paged: ``reps``; the
    open loop's two legs: once)."""
    per_leg = [reps, reps, 1, 1, reps]
    return len(slots_list) * sum(len(set(lens)) + r * n_requests
                                 for r in per_leg)


def tooling_serve(device="cuda", reduced=False):
    """(b) The serving leg at full-width qwen1.5-0.5b (12 requests, slots
    2 and 4, 2 reps), then the continuous-against-static guard on MICRO.
    The paged leg's greedy tokens must equal the continuous batch leg's;
    static against continuous is compared and the differing requests
    counted. K3 launches once a layer on every admit. Returns the launch
    counts."""
    from repro_torch.benchmarks import serve as bs

    cuda = torch.device(device).type == "cuda"
    zero_counts()
    res = bs.bench_serve(ARCH, reduced=reduced, n_requests=SERVE_REQUESTS,
                         slots_list=SERVE_SLOTS, reps=SERVE_REPS,
                         device=device)
    k3 = read_counts()["flash_fwd"]
    cfg = bs.config(ARCH, reduced)
    for slots, entry in res["slots"].items():
        cont = entry["batch"]["continuous"]["tokens"]
        static = entry["batch"]["static"]["tokens"]
        check(entry["paged"]["tokens"] == cont,
              f"slots {slots}: paged greedy tokens == continuous")
        differ = sum(static[r] != cont[r] for r in cont)
        for leg in ("batch", "open_loop"):
            e = entry[leg]
            say("tooling", f"serve slots={slots} {leg}: static "
                f"{e['static']['tok_per_sec']} tok/s, continuous "
                f"{e['continuous']['tok_per_sec']} tok/s, continuous_speedup "
                f"{e['continuous_speedup']}" + (
                    f"; latency p50/p99 continuous "
                    f"{e['continuous']['latency_p50_s']}/"
                    f"{e['continuous']['latency_p99_s']} s"
                    if leg == "open_loop" else ""))
        say("tooling", f"serve slots={slots} paged: "
            f"{entry['paged']['tok_per_sec']} tok/s, cache "
            f"{entry['paged']['cache_ratio_vs_dense']} of dense; greedy "
            f"tokens paged == continuous; static differs from continuous in "
            f"{differ} of {len(cont)} requests")
    admits = serve_admits(SERVE_REQUESTS, bs.PROMPT_LENS, SERVE_REPS,
                          SERVE_SLOTS)
    say("tooling", f"serve: K3 launches {k3} over {admits} admits of "
        f"{cfg.num_layers} layers")
    if cuda:
        check(k3 == admits * cfg.num_layers,
              f"K3 once a layer on every admit: {k3} != {admits} x "
              f"{cfg.num_layers}")
    guard = bs.smoke_guard(device)
    say("tooling", f"serve guard: continuous_speedup "
        f"{guard['slots']['2']['batch']['continuous_speedup']} (>= 1)")
    return read_counts()


def tooling_dryrun():
    """(c) The dry run of qwen1.5-0.5b x TOOLING_SHAPES on TOOLING_GRIDS
    (all ok), the report's two tables, the roofline leg over those
    records and the top 5 of profile_collectives for train_4k on 16x16.
    Returns the records."""
    import tempfile

    from repro_torch.benchmarks.run import leg_roofline
    from repro_torch.launch import profile_collectives as pc
    from repro_torch.launch.dryrun import dryrun_one, summary
    from repro_torch.perf import report

    recs = []
    for shape in TOOLING_SHAPES:
        for g in TOOLING_GRIDS:
            rec = dryrun_one(ARCH, shape, grid_name=g)
            say("tooling", "dryrun " + summary(rec))
            check(rec["status"] == "ok", f"dry run {ARCH} {shape} {g}: "
                  f"{rec.get('error', rec.get('reason'))}")
            recs.append(rec)
    for g in TOOLING_GRIDS:
        print(report.dryrun_table(recs, g), flush=True)
        print(report.roofline_table(recs, g), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for rec in recs:
            with open(os.path.join(tmp, f"{rec['arch']}__{rec['shape']}__"
                                   f"{rec['mesh']}.json"), "w") as f:
                json.dump(rec, f)
        leg_roofline(tmp)
    rows, total, _ = pc.profile(ARCH, "train_4k", top=5)
    pc.print_rows(ARCH, "train_4k", rows, total)
    return recs


def tooling_card_step(device="cuda", smi="", reduced=False):
    """(d) Phase 6's local step (qwen1.5-0.5b, lace fused, 4 slots x 4 x
    512) dry-run on ``meta``, then run on ``device``: the argument bytes
    (equal exactly to the card's tensors' summed nbytes), the dry run's
    peak beside ``max_memory_allocated``, counted FLOPs and the model's
    6 N D over the step's seconds at the bf16 peak (the MFU), with the
    card's name and power limit. Returns the launch counts of the timed
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.dryrun import build_step, count_step, realize
    from repro_torch.models import transformer as T
    from repro_torch.perf import roofline
    from repro_torch.tree import leaves, tree_map

    cuda = torch.device(device).type == "cuda"
    C, Bk, S = TOOLING_STEP
    shape = InputShape("phase6_step", S, C * Bk, "train")
    cfg = get_config(ARCH)
    cfg = cfg.reduced() if reduced else cfg
    step, args, _, cfg = build_step(ARCH, shape.name, cfg=cfg, shape=shape,
                                    num_clients=C)
    _, dry = count_step(step, args)
    # what earlier phases still hold on the card is not this step's
    base = torch.cuda.memory_allocated() if cuda else 0
    gen = torch.Generator(device).manual_seed(0)
    params = T.init_params(gen, cfg)
    params["client"] = tree_map(
        lambda t: t.expand((C,) + tuple(t.shape)).clone(), params["client"])
    batch = realize(args[1], cfg.vocab_size, device)
    arg_bytes = sum(t.nbytes for t in leaves((params, batch)))
    mem = dry["memory"]
    say("tooling", f"step {C} slots x {Bk} x {S}: argument bytes dry run "
        f"{mem['argument_bytes']}, {device} {arg_bytes}")
    check(arg_bytes == mem["argument_bytes"],
          f"dry-run argument bytes {mem['argument_bytes']} == the "
          f"tensors' nbytes {arg_bytes}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = step(params, batch)                       # warm-up
        sync(device)
        check(all(np.isfinite(float(out[1][k]))
                  for k in ("loss_server", "loss_client")),
              f"finite losses: {out[1]}")
        del out
        zero_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(TOOLING_STEP_REPS):
            t0 = time.perf_counter()
            out = step(params, batch)
            sync(device)
            secs.append(time.perf_counter() - t0)
            del out
    counts = read_counts()
    step_s = float(np.median(secs))
    peak = torch.cuda.max_memory_allocated() - base if cuda else 0
    active = roofline.count_params(*ispec.param_specs(cfg, C))["active"]
    mf = roofline.model_flops(active, C * Bk * S, "train")
    per_s = step_s * roofline.PEAK_FLOPS
    say("tooling", f"step on {smi}: {[round(s, 4) for s in secs]} s, "
        f"median {step_s:.4f} s; launches {launches_text(counts)}")
    say("tooling", f"peak bytes: dry run {mem['peak_bytes']} (argument "
        f"{mem['argument_bytes']} + temp {mem['temp_bytes']}), "
        f"max_memory_allocated {peak} above the {base} allocated before "
        f"the step's tensors, ratio {peak / mem['peak_bytes']:.4f}")
    say("tooling", f"counted FLOPs {dry['flops']:.4e} -> "
        f"{dry['flops'] / per_s:.4f} of the bf16 peak; model FLOPs 6 N D "
        f"= 6 x {active:.6e} x {C * Bk * S} = {mf:.4e} -> MFU "
        f"{mf / per_s:.4f} ({smi}; the published 989 TFLOP/s bf16 peak)")
    return counts


def phase_tooling(device="cuda", smi="", reduced=False, boundary_grid=None,
                  qwen_cell=True):
    """Phase 22 (a)-(d); returns the launch counts of (a), (b) and (d)
    summed. On the CPU (a rehearsal) ``reduced`` cuts the serve leg and
    the step to reduced qwen, ``boundary_grid`` the boundary grid, and
    ``qwen_cell=False`` drops the qwen-head cell."""
    t0 = time.perf_counter()
    parts = [run_phase("tooling (a) boundary", tooling_boundary, device,
                       boundary_grid, qwen_cell),
             run_phase("tooling (b) serve", tooling_serve, device, reduced)]
    run_phase("tooling (c) dry run", tooling_dryrun)
    parts.append(run_phase("tooling (d) step", tooling_card_step, device,
                           smi, reduced))
    seconds = time.perf_counter() - t0
    say("tooling", f"phase 22 took {seconds:.1f} s (bar {TOOLING_BAR_S} s"
        f"{'' if seconds <= TOOLING_BAR_S else '; OVER the bar'})")
    return {k: sum(p[k] for p in parts) for k in parts[0]}


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
    if sys.argv[1:] == ["fed"]:
        run_phase("fed", phase_fed)
        return 0
    if sys.argv[1:] == ["async"]:
        run_phase("async", phase_async)
        return 0
    if sys.argv[1:] == ["faults"]:
        run_phase("faults", phase_faults)
        return 0
    if sys.argv[1:] == ["dispatch"]:
        run_phase("dispatch", phase_dispatch)
        return 0
    if sys.argv[1:] == ["mlstm-bwd"]:
        run_phase("kernels K6 bwd", phase_mlstm_bwd)
        return 0
    if sys.argv[1:] == ["xlstm-train"]:
        run_phase("kernels K6 bwd", phase_mlstm_bwd)
        run_phase("kernels K1 K2 (xLSTM width)", phase_lace, [LACE_XLSTM])
        run_phase("train-xlstm", phase_train_xlstm)
        run_phase("train-check-xlstm", phase_xlstm_train_check)
        return 0
    if sys.argv[1:] == ["mlstm"]:
        run_phase("kernels K6", phase_mlstm)
        run_phase("check-xlstm", phase_check, arch=XLSTM, phase="check-xlstm",
                  prompt_len=77, max_len=96, layers=XLSTM_CHECK_LAYERS)
        return 0
    if sys.argv[1:] == ["moe-train"]:
        run_phase("kernels K3 bwd (MoE training)", phase_flash_bwd,
                  FLASH_BWD_MOE_CASES)
        run_phase("kernels K1 K2 (MoE width)", phase_lace, [LACE_MOE])
        run_phase("train-moe", phase_train_moe)
        run_phase("check-moe-train", phase_moe_train_check)
        return 0
    if sys.argv[1:] == ["frontends"]:
        run_phase("kernels K3 (frontends)", phase_frontend_attention)
        run_phase("kernels K1 K2 (frontends)", phase_lace,
                  [LACE_WHISPER, LACE_VLM])
        phase_frontends()
        return 0
    if sys.argv[1:] == ["dp"]:
        run_phase("kernels K1 K2 (raw sums)", phase_lace, [LACE_RAW])
        run_phase("dp", phase_dp)
        return 0
    if sys.argv[1:] == ["tooling"]:
        run_phase("tooling", phase_tooling, smi=smi)
        return 0
    if sys.argv[1:] != ["lace"]:
        rows, max_err = run_phase("kernels K3", phase_kernels)
    if sys.argv[1:] == ["moe"]:
        run_phase("serve-moe", phase_serve, arch=MOE, phase="serve-moe",
                  layers=MOE_SERVE_LAYERS)
        run_phase("check-moe", phase_check, arch=MOE, phase="check-moe",
                  layers=MOE_CHECK_LAYERS)
        return 0
    if sys.argv[1:] == ["jamba"]:
        run_phase("serve-jamba", phase_serve, arch=JAMBA, phase="serve-jamba",
                  layers=JAMBA_SERVE_LAYERS)
        run_phase("check-jamba", phase_check, arch=JAMBA,
                  phase="check-jamba", layers=JAMBA_CHECK_LAYERS)
        return 0
    if sys.argv[1:] != ["lace"]:
        bwd_rows, bwd_err = run_phase("kernels K3 bwd", phase_flash_bwd)
    if sys.argv[1:] != ["lace"]:
        front_rows, front_err = run_phase("kernels K3 (frontends)",
                                          phase_frontend_attention)
    if sys.argv[1:] == ["attention"]:
        return 0
    lace_rows, lace_err = run_phase("kernels K1 K2", phase_lace)
    lace1_rows, lace1_err = run_phase("kernels K4 K5", phase_lace1)
    if sys.argv[1:] == ["lace"]:
        return 0
    mlstm_rows, mlstm_err = run_phase("kernels K6", phase_mlstm)
    bwd6_rows, bwd6_err = run_phase("kernels K6 bwd", phase_mlstm_bwd)
    serve = run_phase("serve", phase_serve)
    run_phase("check", phase_check)
    serve_x = run_phase("serve-xlstm", phase_serve, arch=XLSTM,
                        phase="serve-xlstm", layers=XLSTM_SERVE_LAYERS)
    run_phase("check-xlstm", phase_check, arch=XLSTM, phase="check-xlstm",
          prompt_len=77, max_len=96, layers=XLSTM_CHECK_LAYERS)
    serve_m = run_phase("serve-moe", phase_serve, arch=MOE, phase="serve-moe",
                        layers=MOE_SERVE_LAYERS)
    run_phase("check-moe", phase_check, arch=MOE, phase="check-moe",
              layers=MOE_CHECK_LAYERS)
    serve_j = run_phase("serve-jamba", phase_serve, arch=JAMBA,
                        phase="serve-jamba", layers=JAMBA_SERVE_LAYERS)
    run_phase("check-jamba", phase_check, arch=JAMBA, phase="check-jamba",
              layers=JAMBA_CHECK_LAYERS)
    train = run_phase("train", phase_train)
    run_phase("train-check", phase_train_check)
    dual = run_phase("train-dual", phase_train, flags=TRAIN_DUAL_FLAGS,
                 phase="train-dual")
    run_phase("dual-check", phase_dual_check)
    run_phase("alexnet", phase_alexnet)
    run_phase("baselines", phase_baselines)
    run_phase("resume", phase_resume)
    fed = run_phase("fed", phase_fed)
    events = run_phase("async", phase_async)
    faults = run_phase("faults", phase_faults)
    dispatch = run_phase("dispatch", phase_dispatch)
    xtrain = run_phase("train-xlstm", phase_train_xlstm)
    run_phase("train-check-xlstm", phase_xlstm_train_check)
    mtrain = run_phase("train-moe", phase_train_moe)
    run_phase("check-moe-train", phase_moe_train_check)
    front = phase_frontends()
    serve_w, wtrain, vtrain = (front[k] for k in (
        "serve-whisper", "train-whisper", "train-vlm"))
    dp = run_phase("dp", phase_dp)
    tool = run_phase("tooling", phase_tooling, smi=smi)
    # the federation layer's launches: phase 13's rounds, phase 14's
    # events and phase 15's faulted rounds and events; and phase 16(a)'s
    # bf16 rounds (K1, K2 on their bf16-head build)
    fed = {k: fed[k] + events[k] + faults[k] + dispatch[k] for k in fed}
    # phase 21's lace_dp runs (its world of one and both gloo ranks): K1,
    # K2 (fused) and K4, K5 (the dual step) all in raw-sum mode, K3 in the
    # trunk; in ``launches`` beside the rest
    fed = {k: fed[k] + dp[k] for k in fed}
    # phase 22's boundary leg (K1, K2, K4, K5), serving leg (K3 forward)
    # and card step (K1, K2, K3): in ``launches``, and beside as
    # ``launches_tooling``
    fed = {k: fed[k] + tool[k] for k in fed}
    csrc = "src/repro_torch/kernels/csrc/"
    lace_src = "src/repro/kernels/lace/kernel.py:"
    # forward launches: the serve paths' plus both training paths'; its
    # times at the serving prompt, and at the training trunk's shape and
    # the served MoE model's (hd 128, 32 heads on 4 KV heads) and jamba's
    # (hd 128, 64 heads on 8 KV heads) beside
    fwd_row = kernel_row("flash_attn_fwd", csrc + "flash_attn.cu",
                         "src/repro/kernels/flash_attn/kernel.py:23",
                         serve["flash_fwd"] + serve_m["flash_fwd"]
                         + serve_j["flash_fwd"] + train["flash_fwd"]
                         + dual["flash_fwd"] + fed["flash_fwd"]
                         + mtrain["flash_fwd"] + serve_w["flash_fwd"]
                         + wtrain["flash_fwd"] + vtrain["flash_fwd"],
                         max(max_err, front_err["fwd"]),
                         rows[REPORT_CASE])
    for suffix, case in (("train", TRAIN_CASE), ("moe", MOE_CASE),
                         ("jamba", JAMBA_CASE)):
        fwd_row.update({f"{key}_{suffix}": rows[case][key] for key in
                        ("ms", "plain_ms", "bound_ms", "library_ms",
                         "device_ms", "library_device_ms")})
    fwd_row["launches_moe"] = serve_m["flash_fwd"]
    fwd_row["launches_tooling"] = tool["flash_fwd"]
    fwd_row["launches_jamba"] = serve_j["flash_fwd"]
    # the frontend archs' shapes (non-causal: whisper's cross-attention at
    # a training step's 16 x 448 on 1500 frames and a decode step's 8 x 1;
    # causal: whisper's 16 x 448, internvl2's 16 x 512 at 48 / 8 heads of
    # 128) beside, and their phases' launches (also in ``launches``)
    for suffix, case in (("cross", CROSS_CASE),
                         ("cross_decode", CROSS_DECODE_CASE),
                         ("whisper", WHISPER_SELF_CASE), ("vlm", VLM_CASE)):
        fwd_row.update({f"{key}_{suffix}": front_rows[(case, "fwd")][key]
                        for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms",
                                    "library_device_ms")})
    fwd_row.update(launches_whisper_serve=serve_w["flash_fwd"],
                   launches_whisper_train=wtrain["flash_fwd"],
                   launches_vlm_train=vtrain["flash_fwd"])
    lace_row = {
        kname: kernel_row(kname, csrc + src, lace_src + line, launches, err,
                          rows_[(case, kind)])
        for kname, src, line, launches, err, rows_, case, kind in (
            ("lace2_fwd", "lace.cu", "219",
             train["lace_fwd"] + fed["lace_fwd"] + xtrain["lace_fwd"]
             + mtrain["lace_fwd"] + wtrain["lace_fwd"] + vtrain["lace_fwd"],
             lace_err["fwd"], lace_rows, LACE_REPORT, "fwd"),
            ("lace2_bwd", "lace.cu", "261",
             train["lace_bwd"] + fed["lace_bwd"] + xtrain["lace_bwd"]
             + mtrain["lace_bwd"] + wtrain["lace_bwd"] + vtrain["lace_bwd"],
             lace_err["bwd"], lace_rows, LACE_REPORT, "bwd"),
            ("lace_fwd", "lace1.cu", "41",
             dual["lace1_fwd"] + fed["lace1_fwd"], lace1_err["fwd"],
             lace1_rows, LACE1_REPORT["server"], "fwd"),
            # the server side's K5 (with dW), the costlier of the two
            ("lace_bwd", "lace1.cu", "74",
             dual["lace1_bwd"] + fed["lace1_bwd"], lace1_err["bwd"],
             lace1_rows, LACE1_REPORT["server"], "bwd"))}
    # the bf16-head build (the bf16 policy's main path) beside each: its
    # times, its bound and the all-TF32 one, and phase 16(a)'s launches
    # (also in ``launches``, every launch on the main paths)
    for kname, rows_, case, kind, launches, f32_case in (
            ("lace2_fwd", lace_rows, LACE_BF16_HEAD, "fwd",
             dispatch["lace_fwd"], LACE_REPORT),
            ("lace2_bwd", lace_rows, LACE_BF16_HEAD, "bwd",
             dispatch["lace_bwd"], LACE_REPORT),
            ("lace_fwd", lace1_rows, LACE1_BF16_HEAD["server"], "fwd",
             dispatch["lace1_fwd"], LACE1_REPORT["server"]),
            ("lace_bwd", lace1_rows, LACE1_BF16_HEAD["server"], "bwd",
             dispatch["lace1_bwd"], LACE1_REPORT["server"])):
        r = rows_[(case, kind)]
        lace_row[kname].update({f"{key}_bf16_head": r[key] for key in (
            "ms", "plain_ms", "bound_ms", "tf32_ms", "route_ms")},
            launches_bf16_head=launches,
            tf32_ms=rows_[(f32_case, kind)]["tf32_ms"])
    # the raw-sum mode (mean=False, the lace_dp boundary) at phase 21's
    # per-rank shape beside each, and phase 21's launches (also in
    # ``launches``): all of them raw sums
    for kname, rows_, case, kind, key in (
            ("lace2_fwd", lace_rows, LACE_RAW, "fwd", "lace_fwd"),
            ("lace2_bwd", lace_rows, LACE_RAW, "bwd", "lace_bwd"),
            ("lace_fwd", lace1_rows, LACE1_RAW["server"], "fwd",
             "lace1_fwd"),
            ("lace_bwd", lace1_rows, LACE1_RAW["server"], "bwd",
             "lace1_bwd")):
        r = rows_[(case, kind)]
        lace_row[kname].update({f"{k}_raw": r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            launches_dp=dp["raw_" + key])
    # xlstm-1.3b's boundary (d 2048, V 50304) beside K1, K2, and phase 17's
    # launches (also in ``launches``)
    for kname, kind in (("lace2_fwd", "fwd"), ("lace2_bwd", "bwd")):
        r = lace_rows[(LACE_XLSTM, kind)]
        lace_row[kname].update({f"{key}_xlstm": r[key] for key in (
            "ms", "plain_ms", "bound_ms", "library_ms")},
            launches_xlstm=xtrain[f"lace_{kind}"])
    # qwen3-moe-30b-a3b's boundary (d 2048, V 151936, bf16 head) beside
    # K1, K2, and train-moe's launches (also in ``launches``)
    for kname, kind in (("lace2_fwd", "fwd"), ("lace2_bwd", "bwd")):
        r = lace_rows[(LACE_MOE, kind)]
        lace_row[kname].update({f"{key}_moe": r[key] for key in (
            "ms", "plain_ms", "bound_ms", "library_ms")},
            launches_moe=mtrain[f"lace_{kind}"])
    # the frontend archs' boundaries (odd V) beside K1, K2, and their
    # training phases' launches (also in ``launches``)
    for kname, kind in (("lace2_fwd", "fwd"), ("lace2_bwd", "bwd")):
        for suffix, case, launches in (("whisper", LACE_WHISPER, wtrain),
                                       ("vlm", LACE_VLM, vtrain)):
            r = lace_rows[(case, kind)]
            lace_row[kname].update({f"{key}_{suffix}": r[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")})
            lace_row[kname][f"launches_{suffix}"] = launches[f"lace_{kind}"]
    fwd_row["launches_moe_train"] = mtrain["flash_fwd"]
    # the backward of K3 (the JAX package trains through autodiff); its
    # times at qwen3-moe's server call (16 x 512, 32 heads of 128 on 4 KV
    # heads) and train-moe's launches beside
    bwd_row = kernel_row("flash_attn_bwd", csrc + "flash_attn_bwd.cu",
                         "src/repro/kernels/flash_attn/kernel.py:23",
                         train["flash_bwd"] + dual["flash_bwd"]
                         + fed["flash_bwd"] + mtrain["flash_bwd"]
                         + wtrain["flash_bwd"] + vtrain["flash_bwd"],
                         max(bwd_err, front_err["bwd"]),
                         bwd_rows[FLASH_BWD_REPORT])
    bwd_row.update({f"{key}_moe": bwd_rows[FLASH_BWD_MOE][key] for key in (
        "ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
        "library_device_ms")}, launches_moe=mtrain["flash_bwd"])
    for suffix, case in (("cross", CROSS_CASE), ("whisper", WHISPER_SELF_CASE),
                         ("vlm", VLM_CASE)):
        bwd_row.update({f"{key}_{suffix}": front_rows[(case, "bwd")][key]
                        for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms",
                                    "library_device_ms")})
    bwd_row.update(launches_whisper_train=wtrain["flash_bwd"],
                   launches_vlm_train=vtrain["flash_bwd"],
                   launches_tooling=tool["flash_bwd"])
    for kname, key in (("lace2_fwd", "lace_fwd"), ("lace2_bwd", "lace_bwd"),
                       ("lace_fwd", "lace1_fwd"), ("lace_bwd", "lace1_bwd")):
        lace_row[kname]["launches_tooling"] = tool[key]
    print(json.dumps({"kernels": [
        fwd_row, bwd_row,
        lace_row["lace2_fwd"], lace_row["lace2_bwd"],
        lace_row["lace_fwd"], lace_row["lace_bwd"],
        kernel_row("mlstm_chunk", csrc + "mlstm.cu",
                   "src/repro/kernels/mlstm/kernel.py:25",
                   serve_x["mlstm"] + xtrain["mlstm"], mlstm_err,
                   mlstm_rows[MLSTM_REPORT]),
        # the backward of K6 (the JAX package trains through autodiff)
        kernel_row("mlstm_chunk_bwd", csrc + "mlstm_bwd.cu",
                   "src/repro/kernels/mlstm/kernel.py:25",
                   xtrain["mlstm_bwd"], bwd6_err,
                   bwd6_rows[MLSTM_BWD_REPORT])]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
