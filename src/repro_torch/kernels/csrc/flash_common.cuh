// Device code shared by the attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu): the strides and element helpers of every body, and
// the pieces of the bf16 tensor-core bodies -- tiles staged by cp.async,
// ldmatrix fragment loaders, mma.sync.m16n8k16, the causal / window /
// ragged mask on accumulator fragments and the log2-domain online softmax.
//
// Tiles. A tile is `rows` rows of one head, bf16, in shared memory with a
// row stride of HD + 8 elements (HD / 2 + 4 words): every row starts on a
// 16-byte boundary (a cp.async destination), and the eight 16-byte row
// reads of one ldmatrix phase land on distinct banks for every HD in
// {16, 32, 64, 128}, so the reads are conflict-free.
// Rows past the sequence end are zero-filled by the copy itself (src-size
// 0), so the ragged edge needs no branch. The global rows must start on
// 16-byte boundaries: the launchers demand a 16-byte aligned start and
// strides that are multiples of 8 elements for bf16.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t holds
//   A (16 x 16):  (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B (16 x 8):   (k = 2t..2t+1, n = g), (k = 2t+8.., n = g)
//   C (16 x 8):   (g, 2t..2t+1), (g+8, 2t..2t+1)
// so the accumulators of two neighbouring n-tiles, rounded to bf16, are
// the A operand of the next product over those 16 columns (acc_to_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// The row's log-sum-exp of the scaled scores, in natural-log units, from
// the running max m (log2 units) and sum l of exp2(s - m).
__device__ __forceinline__ float natural_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : -CUDART_INF_F;
}

// Whether query qi sees key kj.
__device__ __forceinline__ bool visible(int qi, int kj, int S, int Skv,
                                        int causal, int window) {
  bool ok = qi < S && kj < Skv;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && qi - kj < window;
  return ok;
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared without a register round trip
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;  // row stride in elements
};

// Consecutive ROWS-row tiles of one head (row stride ld elements; src is
// the head's row 0), from row r0 on: each thread keeps a pointer to its
// 16-byte column of the next tile, so a tile's copy is N cp.async and
// pointer steps, with no index arithmetic. A loop walks the tiles in
// order; a single tile is TileStream(src, ld, r0).load(dst, n).
template <int ROWS, int HD, int NT>
struct TileStream {
  static constexpr int CPR = HD / 8;
  static constexpr int RSTEP = NT / CPR;
  static constexpr int N = (ROWS + RSTEP - 1) / RSTEP;
  static_assert(NT % CPR == 0, "a thread keeps one column");
  const bf16* base;  // the head's row 0: the address of a masked copy
  const bf16* g;     // this thread's element of the next tile
  long long step;    // RSTEP rows
  long long adv;     // ROWS rows
  int row;           // this thread's first row of the next tile
  int r;             // its row in a tile

  __device__ __forceinline__ TileStream(const bf16* src, long long ld,
                                        int r0)
      : base(src), step(RSTEP * ld), adv(ROWS * ld) {
    r = threadIdx.x / CPR;
    row = r0 + r;
    g = src + static_cast<long long>(row) * ld + (threadIdx.x % CPR) * 8;
  }

  // The next tile into dst, zeros for rows >= n; then step past it.
  __device__ __forceinline__ void load(bf16* dst, int n) {
    bf16* d = dst + r * Tile<HD>::LD + (threadIdx.x % CPR) * 8;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (ROWS % RSTEP == 0 || r + i * RSTEP < ROWS) {
        const bool ok = row + i * RSTEP < n;
        cp_async16(d + i * RSTEP * Tile<HD>::LD, ok ? g + i * step : base,
                   ok);
      }
    }
    g += adv;
    row += ROWS;
  }
};

// src[r0 .. r0 + ROWS) of a float row vector into dst, zeros past n.
template <int ROWS, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int n) {
  static_assert(ROWS <= NT, "one element a thread");
  const int i = threadIdx.x;
  if (i < ROWS) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// ---------------------------------------------------------------------------
// ldmatrix and mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The A operand of rows [r0, r0 + 16), columns [c0, c0 + 16) of a
// row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (r0 + lane % 16) * LD + c0 + (lane / 16) * 8);
}

// B operands of two n-tiles (n0 .. n0 + 16) at k-step (k0 .. k0 + 16), B
// stored transposed: the tile's rows are n, its columns k (K for Q K^T).
// b[0], b[1] feed n-tile n0 / 8, b[2], b[3] the next.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * LD + k0 +
                 ((lane / 8) % 2) * 8);
}

// The same with B stored as is: the tile's rows are k, its columns n (V
// for P V), read transposed by ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + n0 +
                       (lane / 16) * 8);
}

// 2^x in one MUFU instruction (subnormal results flush to 0; -inf gives 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a b, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two accumulator n-tiles (16 rows x 16 columns), rounded to bf16, as the
// A operand of a product over those columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Sets to `fill` the entries of a warp's 16-row accumulator strip (rows
// r0 + g and r0 + g + 8, columns c0 + 8 j + 2t + {0, 1}) that the mask
// hides. KEY_ROWS: the rows are keys and the columns queries (the
// transposed products of the dk/dv pass); else the rows are queries.
template <bool KEY_ROWS, int N>
__device__ __forceinline__ void mask_acc(float (&s)[N][4], int r0, int c0,
                                         int S, int Skv, int causal,
                                         int window, float fill) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + (e >= 2 ? 8 : 0);
      const int c = c0 + j * 8 + 2 * t + (e & 1);
      const bool ok = KEY_ROWS ? visible(c, r, S, Skv, causal, window)
                               : visible(r, c, S, Skv, causal, window);
      if (!ok) s[j][e] = fill;
    }
  }
}

// Whether every (query, key) pair of queries [q0, q0 + nq) and keys
// [k0, k0 + nk) is visible, so the tile needs no mask.
__device__ __forceinline__ bool tile_visible(int q0, int nq, int k0, int nk,
                                             int S, int Skv, int causal,
                                             int window) {
  bool ok = q0 + nq <= S && k0 + nk <= Skv;
  if (causal) ok = ok && k0 + nk - 1 <= q0;
  if (window > 0) ok = ok && (q0 + nq - 1) - k0 < window;
  return ok;
}

// Max and sum over the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax update of a 16-row strip: s holds one key tile's raw
// scores q.k (masked entries -inf) and becomes exp2(s * qscale - m) with
// the new running max m of the scaled scores (log2 units; qscale > 0, so
// the max of the raw scores gives it); acc (the output strip) and this
// lane's share of the running sums l are rescaled to it. Rows 0 and 1 are
// g and g + 8.
template <int NS, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4],
                                               float (&acc)[NO][4],
                                               float (&m)[2], float (&l)[2],
                                               float qscale) {
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    const float mn = fmaxf(m[r], quad_max(mx) * qscale);
    // A row with no visible key yet keeps a zero reference, not -inf.
    mu[r] = mn == -CUDART_INF_F ? 0.f : mn;
    const float alpha = exp2_ftz(m[r] - mu[r]);
    m[r] = mn;
    l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][2 * r] *= alpha;
      acc[j][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_ftz(fmaf(s[j][e], qscale, -mu[e / 2]));
      l[e / 2] += s[j][e];
    }
  }
}

// Copies a warp's 16 x HD strip of a tile (rows tr0.. in shared memory) to
// rows gr0.. of one head in global memory (row stride ld), 16 bytes a
// lane, rows >= n skipped. The strip must be written and __syncwarp'd.
template <int HD>
__device__ __forceinline__ void store_strip(bf16* dst, long long ld,
                                            const bf16* tile, int tr0,
                                            int gr0, int n) {
  constexpr int CPR = HD / 8;
  constexpr int RSTEP = 32 / CPR;  // rows a pass of the warp covers
  const int lane = threadIdx.x % 32;
  const int c = (lane % CPR) * 8;
#pragma unroll
  for (int r = lane / CPR; r < 16; r += RSTEP) {
    if (gr0 + r < n)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(gr0 + r) * ld +
                                c) =
          *reinterpret_cast<const uint4*>(tile + (tr0 + r) * Tile<HD>::LD + c);
  }
}

// Writes an accumulator strip (16 rows x HD, rows r0.. of a tile), times
// mul per row (mul0 for row g, mul1 for g + 8), rounded to bf16.
template <int HD, int NO>
__device__ __forceinline__ void acc_to_tile(bf16* tile, int r0,
                                            const float (&acc)[NO][4],
                                            float mul0, float mul1) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr int LD = Tile<HD>::LD;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + (r0 + g) * LD + c) =
        pack_bf16(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<uint32_t*>(tile + (r0 + g + 8) * LD + c) =
        pack_bf16(acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

}  // namespace flash
