#!/usr/bin/env python3
"""Where the bf16 attention forward (K3, ``csrc/flash_attn.cu``) spends its
time on one NVIDIA GPU, by ablation.

    python3 scripts/flash_fwd_ablation.py

Builds copies of the kernel's source, each with one part of the key-tile
loop taken out, and times each on the serving prompt (1 x 777 tokens) and
the training trunk (16 x 512), 16 heads, hd 64, with chip_smoke.py's
``device_ms`` (the card's time, not the host's). The copies compute
wrong outputs; only their times are read. Variants:

  base            the kernel as it is;
  no-softmax      no online softmax (P is the raw scores);
  no-PV, no-QK    no P V / no Q K^T products (mma.sync);
  no-loads        no K/V tile copies after the first tile;
  no-tiles        no key tile at all (Q in, O out: the block's fixed cost);
  skeleton        no products, softmax or copies: the loop's barriers,
                  waits, masks, packing and ldmatrix reads;
  skeleton-no-ldsm  the skeleton without the ldmatrix reads;
  8-warps         the whole kernel with 8 warps (128 query rows) a block
                  instead of 4 (64 rows).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attn import kernel  # noqa: E402

NAMES = ["base", "no-softmax", "no-PV", "no-QK", "no-loads", "no-tiles",
         "skeleton", "skeleton-no-ldsm", "8-warps"]
# (text in csrc/flash_attn.cu, its replacement under the macro ABL)
EDITS = [
    ("""  static constexpr int WARPS = 4;""",
     """  static constexpr int WARPS = ABL == 8 ? 8 : 4;"""),
    ("""      kstream.load(ks + st * BN * LD, Skv);
      vstream.load(vs + st * BN * LD, Skv);""",
     """      if (ABL != 4 && !SKELETON) {
        kstream.load(ks + st * BN * LD, Skv);
        vstream.load(vs + st * BN * LD, Skv);
      }"""),
    ("""          flash::load_b_nk<LD>(bk, kst, jp * 16, kk * 16);""",
     """          if (ABL != 7) flash::load_b_nk<LD>(bk, kst, jp * 16, kk * 16);
          else bk[0] = bk[1] = bk[2] = bk[3] = jp + kk;"""),
    ("""          flash::load_b_kn<LD>(bv, vst, kk * 16, jp * 16);""",
     """          if (ABL != 7) flash::load_b_kn<LD>(bv, vst, kk * 16, jp * 16);
          else bv[0] = bv[1] = bv[2] = bv[3] = jp + kk;"""),
    ("""          flash::mma16816(s[2 * jp], qa[kk], bk[0], bk[1]);
          flash::mma16816(s[2 * jp + 1], qa[kk], bk[2], bk[3]);""",
     """          if (ABL != 3 && !SKELETON) {
            flash::mma16816(s[2 * jp], qa[kk], bk[0], bk[1]);
            flash::mma16816(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
          } else {  // keep the fragments live
            s[2 * jp][0] += __uint_as_float(bk[0]);
            s[2 * jp + 1][0] += __uint_as_float(bk[2]);
          }"""),
    ("""      flash::online_softmax(s, acc, m, l, qscale);""",
     """      if (ABL != 1 && !SKELETON) flash::online_softmax(s, acc, m, l, qscale);"""),
    ("""          flash::mma16816(acc[2 * jp], pa, bv[0], bv[1]);
          flash::mma16816(acc[2 * jp + 1], pa, bv[2], bv[3]);""",
     """          if (ABL != 2 && !SKELETON) {
            flash::mma16816(acc[2 * jp], pa, bv[0], bv[1]);
            flash::mma16816(acc[2 * jp + 1], pa, bv[2], bv[3]);
          } else {
            acc[2 * jp][0] += __uint_as_float(bv[0] ^ pa[0]);
            acc[2 * jp + 1][1] += __uint_as_float(bv[2] ^ pa[1]);
          }"""),
    ("""  const int nkt = hi > kt0 * BN ? (hi - kt0 * BN + BN - 1) / BN : 0;""",
     """  const int nkt =
      ABL == 5 ? 0 : hi > kt0 * BN ? (hi - kt0 * BN + BN - 1) / BN : 0;"""),
]


def build_variants(out_dir):
    with open(os.path.join(build.CSRC, "flash_attn.cu")) as f:
        src = f.read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"flash_attn.cu changed; no unique {old!r}")
        src = src.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "flash_attn_ablation.cu")
    with open(cu, "w") as f:
        f.write("#define SKELETON (ABL == 6 || ABL == 7)\n" + src)
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    procs = [subprocess.Popen([build._nvcc(), *flags, f"-DABL={i}",
                               "-I", build.CSRC, "-o",
                               os.path.join(out_dir, f"lib{i}.so"), cu])
             for i in range(len(NAMES))]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    fns = []
    for i in range(len(NAMES)):
        fn = ctypes.CDLL(os.path.join(out_dir, f"lib{i}.so")).flash_attn_fwd
        fn.argtypes = kernel._ARGTYPES["flash_attn_fwd"]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    fns = build_variants(os.path.join(build.BUILD_DIR, "ablation"))
    gen = torch.Generator("cuda").manual_seed(0)
    for B, P in ((1, 777), (16, 512)):
        q, k, v = (torch.randn((B, P, 16, 64), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     1, B, P, P, 16, 16, 64, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                     64 ** -0.5, 1, 0, None, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        times = [min(chip_smoke.device_ms(lambda: call(fn)) for _ in range(3))
                 for fn in fns]
        print(f"B={B} P={P} H=16 hd=64 bf16, device ms: " + " ".join(
            f"{n}={t:.4f}" for n, t in zip(NAMES, times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
