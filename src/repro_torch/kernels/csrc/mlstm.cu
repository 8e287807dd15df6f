// Chunkwise stabilized mLSTM forward (K6) for Hopper (sm_90a).
//
// Replaces repro/kernels/mlstm/kernel.py:_mlstm_kernel, the Pallas TPU
// kernel behind mlstm_chunk_pallas (one head per call, vmapped over batch
// and heads by mlstm/ops.py:mlstm_chunkwise). Per head, with log-sigmoid
// forget gates f and raw input gates i, over chunks of L tokens:
//
//   b_t = cumsum f, a_t = i_t - b_t, m_t = max(m0 + b_t, b_t + cummax a)
//   h_t = (w_t (q_t C0) + sum_{s<=t} (q_t.k_s) e^{b_t-b_s+i_s-m_t} v_s)
//         / max(|w_t (q_t.n0) + sum_{s<=t} ...|, e^{-m_t}),
//   w_t = e^{m0+b_t-m_t}
//   C' = e^{m0+F-m'} C0 + sum_s e^{F-b_s+i_s-m'} k_s v_s^T   (F = b_{L-1})
//
// and the same for n (v = 1), computed in float32 from q, k, v in float32
// or bfloat16 (the TPU kernel casts them to float32 inside; a bf16 value is
// exact in float32). Beyond the TPU kernel it takes the initial (C, n, m)
// and writes the final one (serving caches it for decode), and a ragged
// last chunk is masked by index: its missing rows act as i = -inf, f = 0,
// which leaves h of the real rows and the final state exact, where the
// Pallas kernel shrinks L until it divides S (down to L = 1 for an odd
// prompt).
//
// Bound. At B = 1, H = 4, dk = dv = 1024 the work is ~4 L dk dv flops a
// chunk and head (q C0 and the state update) against one read of q, k, v
// and the state: 13.5 GFLOP against 84 MB at S = 777, so the tensor
// cores' rate bounds the function (0.027 ms at TF32's 495 TFLOP/s), the
// bytes only below ~300 tokens. The TPU kernel keeps the (dk, dv) state in
// VMEM and walks the chunks in a sequential grid; at dk = dv = 1024 the
// state is 4 MB a head, far above the 227 KB of shared memory a block has.
//
// Design. Four launches on one stream:
//  * mlstm_gate_kernel, one warp per head, walks the chunks in order with
//    warp scans: the only sequential dependency among the gates is the
//    scalar m carried across chunks. It writes, for every token, b_t, i_t
//    (-inf past the chunk), m_t, w0_t = e^{m0+b_t-m_t} and wk_s =
//    e^{F-b_s+i_s-m'}, each chunk's wC0 = e^{m0+F-m'}, and the final m;
//  * mlstm_scores_kernel computes the state-free q k^T of every chunk in
//    parallel over (head, chunk) and over slices of dk, on the tensor
//    cores: the grid splits dk until it fills the SMs (16 ways at 128
//    tokens, 4 at 777), each split a partial tile;
//  * mlstm_decay_kernel sums the partials in a fixed order, applies the
//    decay e^{b_t-b_s+i_s-m_t} on and below the diagonal and writes the
//    decayed scores and their row sums;
//  * mlstm_state_kernel, grid (B*H, dv / TV), keeps a TV-column slice of
//    one head's C (and all of n) in shared memory and walks the chunks in
//    order: no atomics and no cross-block sum, so two runs are bitwise
//    equal. Each chunk streams q and k in DKT-row slices of dk through a
//    double-buffered cp.async ring that also brings the next chunk's first
//    slice (they do not depend on C). Warp pair qr owns rows 16 qr .. 16
//    qr + 15 of every slice: warp 2 qr + hf adds their part of q C0 to
//    rows 32 hf .. 32 hf + 31 of its (L x TV) tile; after a barrier of the
//    pair it folds the chunk into columns 16 hf .. 16 hf + 15 of the same
//    rows of C (and of n). The update's chunk-wide operand, wk v for the
//    warp's 16 columns, is split once a chunk into registers, so the
//    slice loop reads from shared memory only q, k and C, each about once.
//    At the chunk's end each warp scales its tile by w0 and adds its pair's
//    16-deep share of scores . V, and the four pairs' tiles are summed in a
//    fixed order through shared memory.
//
// Products: split TF32 on the tensor cores, at float32 accuracy, as
// lace_common.cuh documents. Every product is mma.sync.m16n8k8 with TF32
// operands and f32 accumulators; a bf16 operand is exact in TF32 and is one
// term, an f32 one splits into hi = tf32(x) and lo = tf32(x - hi), and f32 x
// f32 takes hi.hi + hi.lo + lo.hi (bf16 x f32 two products, bf16 x bf16
// one). The tensor cores' own accumulation truncates, so every chain of
// at most CHAIN products is a fresh partial, added into the f32
// accumulator on the CUDA cores (tests/test_torch_mlstm_split.py emulates
// the order). q C0 takes 3 products with f32 q, 2 with bf16; the update
// k^T (wk V) 3 or 2 (wk V is split once a chunk, into registers); q k^T
// 3 or 1; scores . V 3 or 2. Shared layouts are swizzled so that every
// fragment read of the slice loop is free of bank conflicts.
//
// What bounds it now (chip_smoke.py's K6 lines: the split products' rate
// and the q/k bytes read from L2 over the kernel's device time, on an
// H100): at 777 tokens the split products run at about half the rate
// mma.sync reaches in the LACE kernels, and the q/k copies (each of a
// head's dv / TV blocks reads the head's q and k chunks: 839 MB from L2
// in f32) at under half of HBM's rate, which L2 exceeds, so neither
// alone sets the pace. What remains is the instructions around the
// products -- fragment reads, the TF32 splits, n and q.n0, the barriers
// -- which two warps a scheduler do not hide behind the tensor cores,
// and each chunk's fixed work (scores . V, the sum of the warps' tiles,
// h) with the three small kernels. From the zero state the first chunk
// has no q C0 and no q.n0: the state kernel neither copies its q slices
// nor runs those products. wgmma on operands in shared memory, which
// needs no fragment reads, is the next step; a TMA multicast of q and k
// to a cluster of a head's blocks would cut the smaller share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mlstm_gates.cuh"

namespace {

constexpr int LC = 64;      // rows of a chunk tile: the longest chunk
constexpr int DKT = 64;     // rows of dk in one q / k slice
constexpr int TV = 32;      // columns of dv (of C) a state block owns
constexpr int NT = 256;     // threads per block
constexpr int NW = NT / 32;
constexpr int CHAIN = 32;   // products per tensor-core chain (fresh partial)
constexpr int KSTEP = 8;    // products per m16n8k8 instruction
constexpr int KCH = CHAIN / KSTEP;  // k steps per chain
constexpr int SPLIT_BLOCKS = 132;   // the scores pass splits dk to fill the SMs
static_assert(DKT == KSTEP * NW, "a warp owns 8 rows of each dk slice");
static_assert(LC == GLC, "the gate pass writes rows of LC");
static_assert(TV == 32, "two 16-row m tiles of C^T; four 8-column n tiles");

struct Strides {
  long long b, s, h;
};

// A flag fixed at compile time: a loop that tests it is compiled once for
// each value, with no test inside.
template <bool B>
struct Fixed {
  __device__ constexpr operator bool() const { return B; }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Round to TF32 (to nearest, ties away from zero): the low 13 bits are 0.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x as its TF32 terms: P == 1 for a bf16 value (exact), P == 2 for f32.
template <int P>
__device__ __forceinline__ void terms(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (P == 1) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    const float h = tf32(x);
    hi = __float_as_uint(h);
    lo = __float_as_uint(tf32(x - h));
  }
}

// c += a b for one 16 x 8 x 8 tile. Lane 4g + t holds A (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (k = t, n = g), (k = t + 4, n = g); C (g,
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) (PTX ISA, m16n8k8 .tf32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c = a b: the first product of a chain.
__device__ __forceinline__ void mma_fresh(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// cp.async: a 16-byte chunk global -> shared without a register round
// trip; the bytes past `bytes` (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Tiles of W elements a row, copied in 16-byte chunks (E elements). Chunk
// c of row r sits at position c ^ (r & 7) (SWZ_ROW: fragments read (row g,
// column t), as q and both tiles of the scores pass are), c ^ ((r & 3) <<
// 1) (SWZ_COL: read (row t, column g), as the state kernel's k tile is),
// or c (SWZ_NONE): with those, a warp's 32 fragment reads hit 32 banks.
enum Swizzle { SWZ_ROW, SWZ_COL, SWZ_NONE };

template <typename T, Swizzle SW, int W>
__device__ __forceinline__ int tidx(int r, int d) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int c = d / E;
  const int p = SW == SWZ_ROW ? c ^ (r & 7) : SW == SWZ_COL ? c ^ ((r & 3) << 1)
                                                            : c;
  return r * W + p * E + d % E;
}

// Start the copy of rows r < Lc of x (row r at x + r * ld, W elements)
// into a tile; rows Lc .. LC - 1 are zero. vec: x and ld on 16-byte
// boundaries, so cp.async; else plain copies. A thread copies the same
// chunk of every STEP-th row, so its offsets and swizzle are fixed.
template <typename T, Swizzle SW, int W>
__device__ __forceinline__ void load_tile(T* tile, const T* x, long long ld,
                                          int Lc, bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = W / E;      // chunks a row
  constexpr int STEP = NT / CPR;  // rows between a thread's chunks
  static_assert(NT % CPR == 0 && LC % STEP == 0 && STEP % 8 == 0,
                "a thread's rows share one swizzle");
  const int r0 = threadIdx.x / CPR, c = threadIdx.x % CPR;
  T* dst = tile + tidx<T, SW, W>(r0, c * E);
  const T* src = x + r0 * ld + c * E;
#pragma unroll
  for (int i = 0; i < LC / STEP; ++i) {
    const bool real = r0 + i * STEP < Lc;
    const T* from = real ? src + i * STEP * ld : x;
    if (vec) {
      cp_async16(dst + i * STEP * W, from, real ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[i * STEP * W + e] = real ? from[e] : zero_of<T>();
    }
  }
}

// 1. The gates: mlstm_gate_kernel of mlstm_gates.cuh.

// ---------------------------------------------------------------------------
// 2. q k^T of every chunk, a slice of dk a block: grid (B * H * nc, P).
// part[(p * tiles + bhc) * LC * LC + t * LC + s] over rows p * dks ..
// (p + 1) * dks of dk; only tiles on or below the diagonal are written.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ part,
    int S, int H, int chunk, int nc, int dks, Strides sq, Strides sk, int vq,
    int vk) {
  constexpr int P = sizeof(T) == 4 ? 2 : 1;  // TF32 terms of an operand
  constexpr int TILE = LC * DKT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [2 stages][q, k][LC][DKT]

  const int bhc = blockIdx.x, p = blockIdx.y;
  const int bh = bhc / nc, c = bhc % nc, b = bh / H, h = bh % H;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = warp & 3;          // m tile: rows 16 mi .. 16 mi + 15
  const int nb = (warp >> 2) * 4;   // n tiles nb .. nb + 3: 8 columns each
  // n tiles on or below the diagonal: 8 (nb + j) <= 16 mi + 15
  const int nn = max(0, min(4, 2 * mi + 2 - nb));
  const T* qb = q + b * sq.b + h * sq.h + t0 * sq.s + p * dks;
  const T* kb = k + b * sk.b + h * sk.h + t0 * sk.s + p * dks;
  const int ns = dks / DKT;

  float acc[4][4] = {}, prt[4][4];
  load_tile<T, SWZ_ROW, DKT>(tiles, qb, sq.s, Lc, vq);
  load_tile<T, SWZ_ROW, DKT>(tiles + TILE, kb, sk.s, Lc, vk);
  cp_async_commit();
  for (int sl = 0; sl < ns; ++sl) {
    cp_async_wait_all();
    __syncthreads();  // slice sl landed for every thread; sl - 1 is free
    if (sl + 1 < ns) {
      T* nxt = tiles + ((sl + 1) & 1) * 2 * TILE;
      load_tile<T, SWZ_ROW, DKT>(nxt, qb + (sl + 1) * DKT, sq.s, Lc, vq);
      load_tile<T, SWZ_ROW, DKT>(nxt + TILE, kb + (sl + 1) * DKT, sk.s, Lc,
                                 vk);
    }
    cp_async_commit();
    const T* tq = tiles + (sl & 1) * 2 * TILE;
    const T* tk = tq + TILE;
#pragma unroll
    for (int kk = 0; kk < DKT / KSTEP; ++kk) {
      if (kk % KCH == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) prt[j][e] = 0.f;
      }
      const int d = kk * KSTEP + t;
      const float x[4] = {
          to_f32(tq[tidx<T, SWZ_ROW, DKT>(16 * mi + g, d)]),
          to_f32(tq[tidx<T, SWZ_ROW, DKT>(16 * mi + g + 8, d)]),
          to_f32(tq[tidx<T, SWZ_ROW, DKT>(16 * mi + g, d + 4)]),
          to_f32(tq[tidx<T, SWZ_ROW, DKT>(16 * mi + g + 8, d + 4)])};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) terms<P>(x[r], ah[r], al[r]);
      uint32_t bh_[4][2], bl_[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 8 * (nb + j) + g;
        terms<P>(to_f32(tk[tidx<T, SWZ_ROW, DKT>(s, d)]), bh_[j][0],
                 bl_[j][0]);
        terms<P>(to_f32(tk[tidx<T, SWZ_ROW, DKT>(s, d + 4)]), bh_[j][1],
                 bl_[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nn) mma(prt[j], ah, bh_[j]);
      if constexpr (P == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nn) mma(prt[j], ah, bl_[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nn) mma(prt[j], al, bh_[j]);
      }
      if (kk % KCH == KCH - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += prt[j][e];
      }
    }
  }
  float* out = part + (static_cast<long long>(p) * gridDim.x + bhc) * LC * LC;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nn) continue;
    const int col = 8 * (nb + j) + 2 * t;
    const int row = 16 * mi + g;
    *reinterpret_cast<float2*>(out + row * LC + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (row + 8) * LC + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// 3. The decayed scores of a chunk: the partials summed in order p = 0 ..
// P - 1, times e^{b_t - b_s + i_s - m_t} where s <= t < Lc, else 0; and
// each row's sum. One block a chunk, a row per 4 threads, 16 columns each.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) mlstm_decay_kernel(
    const float* __restrict__ part, int P, const float* __restrict__ gates,
    float* __restrict__ sc, float* __restrict__ rs, int S, int chunk,
    int nc) {
  const int bhc = blockIdx.x;
  const int c = bhc % nc;
  const int Lc = min(chunk, S - c * chunk);
  const int row = threadIdx.x >> 2, q4 = threadIdx.x & 3;
  const float* gt = gates + static_cast<long long>(bhc) * GROWS * LC;
  const float bt = gt[row], mt = gt[2 * LC + row];
  const long long tile = static_cast<long long>(bhc) * LC * LC + row * LC;
  const long long pstride = static_cast<long long>(gridDim.x) * LC * LC;
  float sum = 0.f;
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) {
    const int s0 = 16 * q4 + 4 * j4;
    float4 gs = *reinterpret_cast<const float4*>(part + tile + s0);
    for (int p = 1; p < P; ++p) {
      const float4 o =
          *reinterpret_cast<const float4*>(part + p * pstride + tile + s0);
      gs.x += o.x, gs.y += o.y, gs.z += o.z, gs.w += o.w;
    }
    const float gv[4] = {gs.x, gs.y, gs.z, gs.w};
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = s0 + e;
      out[e] = (s <= row && row < Lc)
                   ? gv[e] * expf(bt - gt[s] + gt[LC + s] - mt)
                   : 0.f;
      sum += out[e];
    }
    *reinterpret_cast<float4*>(sc + tile + s0) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (q4 == 0) rs[static_cast<long long>(bhc) * LC + row] = sum;
}

// ---------------------------------------------------------------------------
// 4. The state: block (bh, y) owns columns y * TV .. y * TV + TV - 1 of C.
// Warp w = 2 qr + hf takes, of every DKT-row slice of dk, rows 16 qr ..
// 16 qr + 15: their share of q C0 for chunk rows 32 hf .. 32 hf + 31 (all
// TV columns), then their update C = wC0 C + k^T (wk v) for columns 16 hf
// .. 16 hf + 15. The two warps of a pair (same qr) read the same rows of C
// and write halves of them, so a barrier of the pair sits between.
// ---------------------------------------------------------------------------

// C[d][j] in shared memory: fragment reads (d = t, j = g) and (d = t + 4)
// hit 32 banks, and so do a half warp's float2 writes (d = g, j = 2t).
__device__ __forceinline__ int cidx(int d, int j) {
  return d * TV + (j ^ ((d & 3) << 3));
}
// A reduction slot [LC / 2][TV]: float2 writes of a fragment row and
// float4 reads of a row's 8 columns.
__device__ __forceinline__ int sidx(int r, int j) {
  return r * TV + (j ^ ((r & 3) << 3));
}

constexpr int SLOT = LC / 2 * TV;  // floats of a warp's tile
using Acc = float[2][4][4];        // [m tile][n tile][C fragment]

// Wait at the barrier of warps 2 qr and 2 qr + 1 (ids 1 .. 4; 0 is the
// block's).
__device__ __forceinline__ void pair_sync(int qr) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(qr + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) mlstm_state_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ gates, const float* __restrict__ wc0,
    const float* __restrict__ sc, const float* __restrict__ rs,
    const float* __restrict__ C0, const float* __restrict__ n0,
    float* __restrict__ hout, float* __restrict__ C1, float* __restrict__ n1,
    int S, int H, int dk, int dv, int chunk, int nc, Strides sq, Strides sk,
    Strides sv, int vq, int vk, int vv) {
  constexpr int P = sizeof(T) == 4 ? 2 : 1;  // TF32 terms of q, k, v
  constexpr int TILE = LC * DKT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Cs = reinterpret_cast<float*>(smem_raw);  // [dk][TV], cidx
  float* nS = Cs + dk * TV;                        // [dk]
  float* red = nS + dk;                            // 4 reduction slots
  float* gw0 = red + 4 * SLOT;                     // [LC] w0
  float* gwk = gw0 + LC;                           // [LC] wk
  float* gmt = gwk + LC;                           // [LC] m_t
  float* grs = gmt + LC;                           // [LC] row sums
  float* den = grs + LC;                           // [LC] denominators
  float* dred = den + LC;                          // [NW][LC / 2] q.n0
  float* misc = dred + NW * LC / 2;                // [4] wC0
  T* Vt = reinterpret_cast<T*>(misc + 4);          // [LC][TV] v tile
  T* tiles = Vt + LC * TV;                         // [2 stages][q, k][LC][DKT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = warp >> 1, hf = warp & 1;
  const int bh = blockIdx.x, j0 = blockIdx.y * TV;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h + j0;
  const int ns = dk / DKT;
  const int nsl = nc * ns;  // slices over all chunks
  // C0, n0, m0 null: the zero state, so chunk 0 has no q C0 and no q.n0
  // and its q slices are not copied
  const bool zero0 = C0 == nullptr;

  // the initial state (C0 and n0 null: zeros)
  for (int e = tid; e < dk * TV / 4; e += NT) {
    const int d = e / (TV / 4), j = 4 * (e % (TV / 4));
    *reinterpret_cast<float4*>(Cs + cidx(d, j)) =
        C0 ? *reinterpret_cast<const float4*>(
                 C0 + (static_cast<long long>(bh) * dk + d) * dv + j0 + j)
           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int e = tid; e < dk; e += NT)
    nS[e] = n0 ? n0[static_cast<long long>(bh) * dk + e] : 0.f;

  // the copies of slice gs (chunk gs / ns, rows (gs % ns) * DKT of dk);
  // its q only when the chunk runs q C0
  auto load_slice = [&](int gs, bool with_q) {
    const int c = gs / ns, d0 = (gs % ns) * DKT;
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    T* st = tiles + (gs & 1) * 2 * TILE;
    if (with_q)
      load_tile<T, SWZ_ROW, DKT>(st, qb + t0 * sq.s + d0, sq.s, Lc, vq);
    load_tile<T, SWZ_COL, DKT>(st + TILE, kb + t0 * sk.s + d0, sk.s, Lc, vk);
  };
  // the v tile of chunk c: read only for the chunk's wk v, so the next
  // chunk's copy starts as soon as every warp has built its fragments
  auto load_v = [&](int c) {
    load_tile<T, SWZ_NONE, TV>(Vt, vb + c * chunk * sv.s, sv.s,
                               min(chunk, S - c * chunk), vv);
  };
  load_v(0);
  load_slice(0, !zero0);
  cp_async_commit();
  // a chunk's gates, loaded a chunk ahead by the first LC threads
  float gn[4] = {}, wcn = 0.f;
  auto load_gates = [&](int c) {
    const long long bc = static_cast<long long>(bh) * nc + c;
    if (tid < LC) {
      const float* gt = gates + bc * GROWS * LC;
      gn[0] = gt[3 * LC + tid], gn[1] = gt[4 * LC + tid];
      gn[2] = gt[2 * LC + tid], gn[3] = rs[bc * LC + tid];
    }
    if (tid == 0) wcn = wc0[bc];
  };
  load_gates(0);

  Acc acc, part;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * chunk;
    const int Lc = min(chunk, S - t0);
    if (tid < LC) gw0[tid] = gn[0], gwk[tid] = gn[1], gmt[tid] = gn[2],
                  grs[tid] = gn[3];
    if (tid == 0) misc[0] = wcn;
    if (c + 1 < nc) load_gates(c + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][ni][e] = 0.f;
    float dint[2][2] = {};  // q.n0 of rows 32 hf + 16 mi + g + 8 hh: a part
    // this warp's columns of wk v, the update's B fragments for the chunk:
    // [k step][n tile][b0, b1] as (hi, lo)
    uint32_t wbh[LC / KSTEP][2][2], wbl[LC / KSTEP][2][2];

    // the chunk's slices of dk, with q C0 and q.n0 or without (chunk 0
    // from the zero state)
    auto walk = [&](auto qc0) {
      for (int sl = 0; sl < ns; ++sl) {
        const int gs = c * ns + sl;
        cp_async_wait_all();
        // slice gs (and at sl 0 the v tile) landed; gs - 1 is free
        __syncthreads();
        if (sl == 0) {
#pragma unroll
          for (int kk = 0; kk < LC / KSTEP; ++kk)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int s = KSTEP * kk + t + 4 * e;
                const int j = 16 * hf + 8 * ni + g;
                terms<2>(gwk[s] * to_f32(Vt[s * TV + j]), wbh[kk][ni][e],
                         wbl[kk][ni][e]);
              }
        }
        if (gs + 1 < nsl) load_slice(gs + 1, qc0 || sl + 1 == ns);
        if (sl == 1 && c + 1 < nc) load_v(c + 1);  // every warp has its wk v
        cp_async_commit();
        const T* tq = tiles + (gs & 1) * 2 * TILE;
        const T* tk = tq + TILE;
        const int d0 = sl * DKT + 16 * qr;  // the pair's first row of dk

        // q C0 over the pair's 16 rows (two k steps) for this warp's half of
        // the chunk's rows: a fresh partial, added into acc; q.n0 beside it
        if (qc0) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int dl = 16 * qr + KSTEP * kk;  // row of the slice
            uint32_t bhi[4][2], blo[4][2];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              terms<2>(Cs[cidx(d0 + 8 * kk + t, 8 * ni + g)], bhi[ni][0],
                       blo[ni][0]);
              terms<2>(Cs[cidx(d0 + 8 * kk + t + 4, 8 * ni + g)], bhi[ni][1],
                       blo[ni][1]);
            }
            const float na = nS[d0 + 8 * kk + t], nb = nS[d0 + 8 * kk + t + 4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const int r = 32 * hf + 16 * mi + g;
              const float x[4] = {
                  to_f32(tq[tidx<T, SWZ_ROW, DKT>(r, dl + t)]),
                  to_f32(tq[tidx<T, SWZ_ROW, DKT>(r + 8, dl + t)]),
                  to_f32(tq[tidx<T, SWZ_ROW, DKT>(r, dl + t + 4)]),
                  to_f32(tq[tidx<T, SWZ_ROW, DKT>(r + 8, dl + t + 4)])};
              dint[mi][0] = fmaf(x[2], nb, fmaf(x[0], na, dint[mi][0]));
              dint[mi][1] = fmaf(x[3], nb, fmaf(x[1], na, dint[mi][1]));
              uint32_t ah[4], al[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) terms<P>(x[e], ah[e], al[e]);
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                if (kk == 0)
                  mma_fresh(part[mi][ni], ah, bhi[ni]);
                else
                  mma(part[mi][ni], ah, bhi[ni]);
              }
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) mma(part[mi][ni], ah, blo[ni]);
              if constexpr (P == 2)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma(part[mi][ni], al, bhi[ni]);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][ni][e] += part[i][ni][e];
        }
        pair_sync(qr);  // both warps of the pair have read these rows

        // C[rows][16 hf ..] = wC0 C + k^T (wk v), n[rows] = wC0 n + k^T wk:
        // the tokens in two chains (0 .. 31, 32 .. 63) interleaved, two
        // independent accumulators a tile
        {
          float up[2][2][4] = {};  // [chain][n tile][fragment]
          float nua = 0.f, nub = 0.f;
          const int dl = 16 * qr + g;  // rows dl and dl + 8 of the slice
#pragma unroll
          for (int kk = 0; kk < LC / KSTEP / 2; ++kk) {
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
              const int ks = kk + ch * (LC / KSTEP / 2);
              const int s = KSTEP * ks + t;
              const float x[4] = {
                  to_f32(tk[tidx<T, SWZ_COL, DKT>(s, dl)]),
                  to_f32(tk[tidx<T, SWZ_COL, DKT>(s, dl + 8)]),
                  to_f32(tk[tidx<T, SWZ_COL, DKT>(s + 4, dl)]),
                  to_f32(tk[tidx<T, SWZ_COL, DKT>(s + 4, dl + 8)])};
              const float wa = gwk[s], wb = gwk[s + 4];
              nua = fmaf(x[2], wb, fmaf(x[0], wa, nua));
              nub = fmaf(x[3], wb, fmaf(x[1], wa, nub));
              uint32_t ah[4], al[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) terms<P>(x[e], ah[e], al[e]);
#pragma unroll
              for (int ni = 0; ni < 2; ++ni) mma(up[ch][ni], ah, wbh[ks][ni]);
#pragma unroll
              for (int ni = 0; ni < 2; ++ni) mma(up[ch][ni], ah, wbl[ks][ni]);
              if constexpr (P == 2)
#pragma unroll
                for (int ni = 0; ni < 2; ++ni) mma(up[ch][ni], al, wbh[ks][ni]);
            }
          }
          const float wC0 = misc[0];
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float2* cp = reinterpret_cast<float2*>(
                  Cs + cidx(sl * DKT + dl + 8 * hh, 16 * hf + 8 * ni + 2 * t));
              float2 cv = *cp;
              cv.x = fmaf(cv.x, wC0, up[0][ni][2 * hh] + up[1][ni][2 * hh]);
              cv.y = fmaf(cv.y, wC0,
                          up[0][ni][2 * hh + 1] + up[1][ni][2 * hh + 1]);
              *cp = cv;
            }
          nua += __shfl_xor_sync(0xffffffffu, nua, 1);
          nua += __shfl_xor_sync(0xffffffffu, nua, 2);
          nub += __shfl_xor_sync(0xffffffffu, nub, 1);
          nub += __shfl_xor_sync(0xffffffffu, nub, 2);
          if (hf == 0 && t == 0) {
            float* np = nS + sl * DKT + dl;
            np[0] = fmaf(np[0], wC0, nua);
            np[8] = fmaf(np[8], wC0, nub);
          }
        }
      }
    };
    // bf16: a copy of the loop for each case, with no test inside; f32:
    // one loop that tests, as two copies of it spill at 255 registers
    const bool qc0 = c > 0 || !zero0;
    if constexpr (P == 1) {
      if (qc0)
        walk(Fixed<true>{});
      else
        walk(Fixed<false>{});
    } else {
      walk(qc0);
    }

    // the chunk's end: acc = w0 (q C0) + this pair's 16-deep share of
    // scores . v, both operands from global memory (L2), loaded
    // before the barrier
    {
      const float* scb = sc + (static_cast<long long>(bh) * nc + c) * LC * LC;
      float xs[2][2][4], xv[2][4][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int s0 = 16 * qr + KSTEP * kk + t;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = 32 * hf + 16 * mi + g;
          xs[mi][kk][0] = scb[r * LC + s0];
          xs[mi][kk][1] = scb[(r + 8) * LC + s0];
          xs[mi][kk][2] = scb[r * LC + s0 + 4];
          xs[mi][kk][3] = scb[(r + 8) * LC + s0 + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = s0 + 4 * e;
            xv[kk][ni][e] =
                s < Lc ? to_f32(vb[(t0 + s) * sv.s + 8 * ni + g]) : 0.f;
          }
      }
      __syncthreads();  // every warp is done with the slices and this stage
      if (ns == 1 && c + 1 < nc) load_v(c + 1);
      cp_async_commit();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = 32 * hf + 16 * mi + g;
        const float wa = gw0[r], wb = gw0[r + 8];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          acc[mi][ni][0] *= wa, acc[mi][ni][1] *= wa;
          acc[mi][ni][2] *= wb, acc[mi][ni][3] *= wb;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) terms<2>(xs[mi][kk][e], ah[e], al[e]);
          uint32_t vh[4][2], vl[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              terms<P>(xv[kk][ni][e], vh[ni][e], vl[ni][e]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (kk == 0)
              mma_fresh(part[mi][ni], ah, vh[ni]);
            else
              mma(part[mi][ni], ah, vh[ni]);
          }
          if constexpr (P == 2)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma(part[mi][ni], ah, vl[ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma(part[mi][ni], al, vh[ni]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][ni][e] += part[i][ni][e];
    }
    // q.n0: the lane's part, then the row over the warp's 4 t lanes
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = dint[mi][hh];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (t == 0) dred[warp * (LC / 2) + 16 * mi + g + 8 * hh] = x;
      }
    // the eight tiles through eight slots: four in the free stage, four in
    // red; then each row sums its half's four in a fixed order
    float* st = reinterpret_cast<float*>(tiles +
                                         ((c * ns + ns - 1) & 1) * 2 * TILE);
    auto slot = [&](int i) {
      return i < 4 ? st + i * SLOT : red + (i - 4) * SLOT;
    };
    {
      float* mine = slot(warp);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            *reinterpret_cast<float2*>(
                mine + sidx(16 * mi + g + 8 * hh, 8 * ni + 2 * t)) =
                make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
    }
    __syncthreads();  // every warp has read w0 and written its slot
    if (tid < LC) {
      const int half = tid / (LC / 2), rl = tid % (LC / 2);
      float x = dred[half * (LC / 2) + rl];
      for (int qq = 1; qq < NW / 2; ++qq)
        x += dred[(2 * qq + half) * (LC / 2) + rl];
      den[tid] = fmaxf(fabsf(fmaf(x, gw0[tid], grs[tid])), expf(-gmt[tid]));
    }
    __syncthreads();
    {
      const int row = KSTEP * warp + g, col = 8 * t;
      const int half = row / (LC / 2), rl = row % (LC / 2);
      if (row < Lc) {
        float o[4][8];
#pragma unroll
        for (int qq = 0; qq < NW / 2; ++qq) {
          const float* p = slot(2 * qq + half) + sidx(rl, col);
          const float4 a = *reinterpret_cast<const float4*>(p);
          const float4 bq = *reinterpret_cast<const float4*>(p + 4);
          o[qq][0] = a.x, o[qq][1] = a.y, o[qq][2] = a.z, o[qq][3] = a.w;
          o[qq][4] = bq.x, o[qq][5] = bq.y, o[qq][6] = bq.z, o[qq][7] = bq.w;
        }
        const float inv = 1.f / den[row];
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = ((o[0][e] + o[1][e]) + (o[2][e] + o[3][e])) * inv;
        float* out = hout +
                     ((static_cast<long long>(b) * S + t0 + row) * H + h) * dv +
                     j0 + col;
        *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<float4*>(out + 4) =
            make_float4(y[4], y[5], y[6], y[7]);
      }
    }
  }
  __syncthreads();
  float* Cout = C1 + static_cast<long long>(bh) * dk * dv + j0;
  for (int e = tid; e < dk * TV / 4; e += NT) {
    const int d = e / (TV / 4), j = 4 * (e % (TV / 4));
    *reinterpret_cast<float4*>(Cout + static_cast<long long>(d) * dv + j) =
        *reinterpret_cast<const float4*>(Cs + cidx(d, j));
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < dk; e += NT)
      n1[static_cast<long long>(bh) * dk + e] = nS[e];
}

// The workspace, in floats: the gates, wC0, the split q k^T partials, the
// decayed scores and their row sums, each region on a 256-byte boundary.
struct Work {
  long long gates, wc0, part, sc, rs, total;
  int tiles, splits;
  Work(int B, int S, int H, int dk, int chunk) {
    const int nc = (S + chunk - 1) / chunk;
    tiles = B * H * nc;
    const int ns = dk / DKT;
    splits = ns;  // the fewest splits of dk that fill the SMs
    for (int p = 1; p <= ns; ++p)
      if (ns % p == 0 && static_cast<long long>(tiles) * p >= SPLIT_BLOCKS) {
        splits = p;
        break;
      }
    auto up = [](long long n) { return (n + 63) / 64 * 64; };
    const long long T = tiles;
    gates = 0;
    wc0 = gates + up(T * GROWS * LC);
    part = wc0 + up(T);
    sc = part + up(static_cast<long long>(splits) * T * LC * LC);
    rs = sc + up(T * LC * LC);
    total = rs + up(T * LC);
  }
};

// A pointer and (batch, seq, head) strides on 16-byte boundaries.
bool on16(const void* p, long long sb, long long ss, long long sh, int E) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % E == 0 &&
         ss % E == 0 && sh % E == 0;
}

template <typename T>
int launch(const void* q_, const void* k_, const void* v_, const float* ig,
           const float* fg, const float* C0, const float* n0, const float* m0,
           float* hout, float* C1, float* n1, float* m1, float* work, int B,
           int S, int H, int dk, int dv, int chunk, Strides sq, Strides sk,
           Strides sv, cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int vq = on16(q, sq.b, sq.s, sq.h, E);
  const int vk = on16(k, sk.b, sk.s, sk.h, E);
  const int vv = on16(v, sv.b, sv.s, sv.h, E);
  const int nc = (S + chunk - 1) / chunk;
  const Work w(B, S, H, dk, chunk);
  float* gates = work + w.gates;
  float* wc0 = work + w.wc0;
  float* part = work + w.part;
  float* sc = work + w.sc;
  float* rs = work + w.rs;

  mlstm_gate_kernel<<<B * H, 32, 0, st>>>(ig, fg, m0, gates, wc0, m1, S, H,
                                          chunk, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int sc_smem = 4 * LC * DKT * static_cast<int>(sizeof(T));
  err = cudaFuncSetAttribute(mlstm_scores_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sc_smem);
  if (err != cudaSuccess) return err;
  mlstm_scores_kernel<T><<<dim3(w.tiles, w.splits), NT, sc_smem, st>>>(
      q, k, part, S, H, chunk, nc, dk / w.splits, sq, sk, vq, vk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mlstm_decay_kernel<<<w.tiles, NT, 0, st>>>(part, w.splits, gates, sc, rs, S,
                                             chunk, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int st_smem = static_cast<int>(
      sizeof(float) * (static_cast<size_t>(dk) * (TV + 1) + 4 * SLOT +
                       5 * LC + NW * LC / 2 + 4) +
      sizeof(T) * (LC * TV + 4 * LC * DKT));
  err = cudaFuncSetAttribute(mlstm_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             st_smem);
  if (err != cudaSuccess) return err;
  mlstm_state_kernel<T><<<dim3(B * H, dv / TV), NT, st_smem, st>>>(
      q, k, v, gates, wc0, sc, rs, C0, n0, hout, C1, n1, S, H, dk, dv, chunk,
      nc, sq, sk, sv, vq, vk, vv);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch mlstm_fwd needs for these shapes.
extern "C" long long mlstm_workspace(int B, int S, int H, int dk, int chunk) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dk % DKT != 0 || chunk < 1)
    return -1;
  return Work(B, S, H, dk, chunk).total;
}

// Chunkwise mLSTM forward over B * H heads. q, k: (B, S, H, dk) and v:
// (B, S, H, dv), all float32 (dtype 0) or all bfloat16 (dtype 1), with unit
// stride on the last axis and the given (batch, seq, head) strides; ig,
// fg: (B, S, H) float32, contiguous; C0 / C1: (B, H, dk, dv), n0 / n1: (B,
// H, dk), m0 / m1: (B, H), float32, contiguous (C0, n0, m0 null: the zero
// state); hout: (B, S, H, dv) float32, contiguous; work:
// mlstm_workspace(...) floats of scratch. dk a
// multiple of 64 up to 1024, dv a multiple of 32, 1 <= chunk <= 64.
// Returns the launches' cudaGetLastError().
extern "C" int mlstm_fwd(const void* q, const void* k, const void* v,
                         int dtype, const float* ig, const float* fg,
                         const float* C0, const float* n0, const float* m0,
                         float* hout, float* C1, float* n1, float* m1,
                         float* work, int B, int S, int H, int dk, int dv,
                         int chunk, long long sqb, long long sqs,
                         long long sqh, long long skb, long long sks,
                         long long skh, long long svb, long long svs,
                         long long svh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dk % DKT != 0 || dk > 1024 ||
      dv <= 0 || dv % TV != 0 || chunk < 1 || chunk > LC)
    return cudaErrorInvalidValue;
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, ig, fg, C0, n0, m0, hout, C1, n1, m1, work,
                         B, S, H, dk, dv, chunk, sq, sk, sv, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ig, fg, C0, n0, m0, hout, C1, n1,
                                 m1, work, B, S, H, dk, dv, chunk, sq, sk, sv,
                                 st);
  return cudaErrorInvalidValue;
}
