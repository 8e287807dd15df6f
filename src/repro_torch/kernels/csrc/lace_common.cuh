// Logit-adjusted cross-entropy (LACE) for Hopper (sm_90a): the device code
// shared by the fused dual-prior kernels K1/K2 (lace.cu) and the single-prior
// kernels K4/K5 (lace1.cu). Every kernel below is templated on NS, the number
// of prior sides it streams: 2 for K1/K2 (eq. 14 with P_s and eq. 15 with
// P_k from one z tile), 1 for K4/K5 (one side, "s" below).
//
// Per token i and side x:
//   z_i      = f_i @ W                       (f32 accumulation)
//   lse_x,i  = logsumexp_c(z_i,c + adj_x[id_x,i][c])
//   nll_x,i  = lse_x,i - (z_i,y_i + adj_x[id_x,i][y_i])
//   g_x,i,c  = (exp(z_i,c + adj_x - lse_x,i) - [c == y_i]) * token_scale_x,i
//   df_x     = g_x @ W^T,  dW_s = feats^T @ g_s
// where adj_x = tau * log(P_x + eps) is a (rows, V) table and id_x,i picks
// the row of token i (the Pallas kernels take one row per call). A null
// table adds nothing (plain CE on that side).
//
// Design. The TPU walks the vocab grid in order and carries the running
// (max, sumexp, label logit) in scratch; blocks here run in no order. The
// forward gives each block one 128-token tile and one 128-column vocab
// tile: each warp reduces its rows' (max, sumexp) over the tile's columns
// with shuffles in a fixed order, the label logit is written by the one
// thread whose columns hold it, and a second small kernel merges each
// token's partials over the vocab tiles. Columns are masked by index
// (c < V), never by a -inf prior: at tau = 0 a padded prior would mask
// nothing. The backward's two reductions run over different axes (df over
// the vocab, dW over the tokens), so it walks the vocab in chunks of vc
// columns: one kernel recomputes the z tiles of the chunk and writes each
// side's cotangent tile g_x (N, vc) to a workspace -- the sides share one
// z tile -- then product kernels fold the chunk into every df_x
// (accumulated over chunks) and, when asked, write dW_s's vc columns. No
// atomics: two runs on the same inputs are bitwise equal. Each df and dW
// entry sums in chains of at most KSEG = 1024 products, each a fresh
// accumulator added into the output, as the plain version slices its
// sums, so the two round alike.
//
// Products: split TF32 on the tensor cores, at f32 accuracy. Every product
// is mma.sync.m16n8k8 with TF32 operands and f32 accumulators. A bf16
// operand is exact in TF32 (8 significant bits of TF32's 11) and enters as
// one term; an f32 operand x splits into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: to nearest, ties away), and every TF32 x TF32 product is exact
// in f32. bf16 x f32 takes a.hi + a.lo: 2 products; f32 x f32 takes hi.hi +
// hi.lo + lo.hi: 3 (lo.lo, under 2^-22 of the term, is dropped). What is
// lost is lo's own rounding and lo.lo, both near 2^-22 relative, against
// f32's 2^-24 per operation; the products' sums carry more error than
// that, so the result keeps the f32 product's accuracy, provided the sums
// round to nearest: the tensor cores' own accumulation truncates, so each
// chain on them is one 32-deep stage, added into the accumulator on the
// CUDA cores (tests/test_torch_lace_split.py emulates the scheme); bf16 x
// bf16 takes 1 product. Training feats are bf16 and W f32: z and dW take 2
// products, df 3.
//
// Tile. A block of 8 warps computes a 128 x 128 output tile, each warp
// 64 x 32 (4 x 4 mma tiles, 64 f32 accumulators a thread), over stages of
// 32 in the reduction, 4 in flight in shared memory. cp.async copies each
// operand's stage as it lies in memory (bf16 or f32, 16-byte chunks;
// ragged edges zero-filled by the copy, nothing read out of bounds; rows
// not on 16-byte boundaries go through plain copies) in the layout its
// memory order gives, [mn][k] or [k][mn], padded so that every fragment
// read is conflict-free. A fragment is split into its TF32 terms as it is
// read (3 instructions an f32 value), so no register holds a copy in
// flight: the loads overlap the products (register-staged copies, split
// at the store, did not: the products and the copies took as long as
// each alone, summed). Every epilogue reads the finished tile back from
// shared memory a row a warp (stash), so none of its registers is live
// during the products: no kernel here spills.
//
// Bound. At the training shapes (N = 8192 tokens, d = 1024, V = 151936)
// one product pass 2*N*d*V is 2.55 TFLOP: 5.15 ms at TF32's 495 TFLOP/s,
// the bound of z; its 2 split products take 10.3 ms at that rate (one
// pass takes 38 ms at the f32 CUDA-core rate of 67 TFLOP/s). Far above
// the ridge point: operations bound every kernel here, not the 622 MB of
// W.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // rows (tokens, or d for dW) per block
constexpr int BN = 128;     // columns per block
constexpr int BK = 32;      // reduction depth per shared-memory stage
constexpr int NT = 256;     // threads: 8 warps, 2 x 4 of 64 x 32 outputs
constexpr int KSEG = 1024;  // products per accumulator chain in the GEMMs
constexpr int AP = BN + 8;  // row pitch of a stashed accumulator tile
constexpr int ROWS_PER_WARP = BM / (NT / 32);  // in the epilogues
static_assert(BN == 4 * 32, "an epilogue lane takes 4 columns of a row");
static_assert(BM == BN, "one MN-major pitch serves both operands");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round to TF32 (to nearest, ties away from zero): the low 13 bits are 0.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// c += a b for one 16 x 8 x 8 tile. Lane 4g + t holds A (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (k = t, n = g), (k = t + 4, n = g); C (g,
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) (PTX ISA, m16n8k8 .tf32).
// fresh: c = a b (the chain's first product).
template <bool fresh>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (fresh)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cp.async: a 16-byte chunk global -> shared without a register round
// trip; the bytes past `bytes` (0..16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x as its TF32 terms: a bf16 value is exact (P == 1); an f32 one is
// hi = tf32(x) and lo = tf32(x - hi) (P == 2).
template <int P>
__device__ __forceinline__ void terms(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (P == 1) {
    hi = __float_as_uint(x);
  } else {
    const float h = tf32(x);
    hi = __float_as_uint(h);
    lo = __float_as_uint(tf32(x - h));
  }
}

// One operand of a product tile, the (MN x K) matrix whose element (mn, k)
// is p[mn * ld + k] (KMAJ) or p[k * ld + mn], staged as it lies in memory
// (bf16 or f32) in 16-byte chunks: a K-major stage as [mn][k] rows of BK +
// E elements, an MN-major one as [k][mn] rows of BM + 2E (E elements a
// chunk). Every fragment read is then conflict-free: lane 4g + t reads
// (mn = g, k = t) at word 4g + t (f32) or 20g + t/2 (bf16), or (k = t, mn =
// g) at word 8t + g or 8t + g/2, mod 32, two bf16 lanes sharing a word.
template <typename T, bool KMAJ>
struct Operand {
  static constexpr int P = sizeof(T) == 4 ? 2 : 1;  // TF32 terms
  static constexpr int E = 16 / static_cast<int>(sizeof(T));
  static constexpr int PITCH = KMAJ ? BK + E : BM + 2 * E;
  static constexpr int ROWS = KMAJ ? BM : BK;
  static constexpr int BYTES = ROWS * PITCH * static_cast<int>(sizeof(T));
  static constexpr int CPR = (KMAJ ? BK : BM) / E;  // chunks a row
  static constexpr int PER_THREAD = ROWS * CPR / NT;
  static_assert(ROWS * CPR % NT == 0 && BYTES % 16 == 0, "whole chunks");
  const T* p;
  long long ld;
  int MN, K;
  bool vec;  // rows on 16-byte boundaries: cp.async; else plain copies

  __device__ __forceinline__ Operand(const T* p_, long long ld_, int MN_,
                                     int K_)
      : p(p_), ld(ld_), MN(MN_), K(K_) {
    vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % E == 0;
  }

  // Start the copy of the stage at (mn0, k0) into s: past the edges zeros.
  __device__ __forceinline__ void load(T* s, int mn0, int k0) const {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int id = e * NT + threadIdx.x;
      const int row = id / CPR, j = id % CPR;
      const int outer = (KMAJ ? mn0 : k0) + row;
      const int inner = (KMAJ ? k0 : mn0) + j * E;
      int n = outer < (KMAJ ? MN : K) ? (KMAJ ? K : MN) - inner : 0;
      n = n < 0 ? 0 : (n > E ? E : n);
      T* dst = s + row * PITCH + j * E;
      const T* src = n > 0 ? p + outer * ld + inner : p;
      if (vec) {
        cp_async16(dst, src, n * static_cast<int>(sizeof(T)));
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) dst[i] = i < n ? src[i] : from_f32<T>(0.f);
      }
    }
  }

  // Element (mn, k) of the stage at s.
  __device__ __forceinline__ float at(const T* s, int mn, int k) const {
    return to_f32(s[KMAJ ? mn * PITCH + k : k * PITCH + mn]);
  }
};

// A thread's accumulators: [m tile][n tile][C fragment].
using Acc = float[4][4][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
}

// Where acc[mi][ni][c] of this thread lies in the block's 128 x 128 tile.
struct Frag {
  int g, t, wm, wn;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2, t = lane & 3;
    wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  }
  // row of m tile mi, half h (c >> 1); first column of n tile ni (c & 1 adds)
  __device__ __forceinline__ int row(int mi, int h) const {
    return wm + mi * 16 + g + 8 * h;
  }
  __device__ __forceinline__ int col(int ni) const {
    return wn + ni * 8 + 2 * t;
  }
};

// The product tile: acc += A(m0.., k) B(k, n0..) over k < K, with A the
// (M x K) operand and B the (Nc x K) one (so B(k, n) is element (n, k)).
// Rows m >= M, columns n >= Nc and depth k >= K read as 0. Every thread of
// the block calls it; smem holds SMEM bytes; it returns with the block
// synchronised and the buffers free.
//
// NSTAGE stages in flight: while the tensor cores work on one, cp.async
// brings the next NSTAGE - 1 (no register holds a copy in flight). Each
// fragment is split into its TF32 terms as it is read. Each 32-deep stage
// sums in a fresh partial on the tensor cores (up to 12 products a chain),
// added into acc on the CUDA cores: the tensor cores' own accumulation
// truncates, and a chain over all K would add that bias up. An m tile's
// products go out a term at a time for its 4 n tiles, so consecutive
// products never wait on one another, and one m tile's A fragment is live
// at a time.
template <typename TA, bool AK, typename TB, bool BKM>
struct Tile {
  using OA = Operand<TA, AK>;
  using OB = Operand<TB, BKM>;
  static constexpr int NSTAGE = 4;
  static constexpr int STAGE = OA::BYTES + OB::BYTES;
  static constexpr int SMEM = NSTAGE * STAGE;
  static_assert(SMEM >= BM * AP * 4, "the stages hold a stashed tile");
  char* sm;
  OA a;
  OB b;

  __device__ __forceinline__ Tile(float* sm_, const TA* A, long long lda,
                                  int M, const TB* B, long long ldb, int Nc,
                                  int K)
      : sm(reinterpret_cast<char*>(sm_)), a(A, lda, M, K), b(B, ldb, Nc, K) {}

  __device__ __forceinline__ void load(int slot, int m0, int n0,
                                       int k0) const {
    char* s = sm + slot * STAGE;
    a.load(reinterpret_cast<TA*>(s), m0, k0);
    b.load(reinterpret_cast<TB*>(s + OA::BYTES), n0, k0);
  }

  __device__ __forceinline__ void run(int m0, int n0, Acc& acc) const {
    const Frag f;
    const int nk = (a.K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nk) load(s, m0, n0, s * BK);
      cp_async_commit();
    }
    Acc part;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<NSTAGE - 2>();  // stage kt has landed
      __syncthreads();              // ... for every thread; kt - 1 is free
      const int nxt = kt + NSTAGE - 1;
      if (nxt < nk) load(nxt % NSTAGE, m0, n0, nxt * BK);
      cp_async_commit();
      const char* s = sm + (kt % NSTAGE) * STAGE;
      const TA* sa = reinterpret_cast<const TA*>(s);
      const TB* sb = reinterpret_cast<const TB*>(s + OA::BYTES);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t fb[OB::P][4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = f.wn + ni * 8 + f.g;
          terms<OB::P>(b.at(sb, n, kk + f.t), fb[0][ni][0],
                       fb[OB::P - 1][ni][0]);
          terms<OB::P>(b.at(sb, n, kk + f.t + 4), fb[0][ni][1],
                       fb[OB::P - 1][ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int m = f.wm + mi * 16 + f.g;
          const float x[4] = {a.at(sa, m, kk + f.t), a.at(sa, m + 8, kk + f.t),
                              a.at(sa, m, kk + f.t + 4),
                              a.at(sa, m + 8, kk + f.t + 4)};
          uint32_t fa[OA::P][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            terms<OA::P>(x[r], fa[0][r], fa[OA::P - 1][r]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {  // hi.hi
            if (kk == 0)
              mma_tf32<true>(part[mi][ni], fa[0], fb[0][ni]);
            else
              mma_tf32<false>(part[mi][ni], fa[0], fb[0][ni]);
          }
          if constexpr (OB::P == 2)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)  // hi.lo
              mma_tf32<false>(part[mi][ni], fa[0], fb[OB::P - 1][ni]);
          if constexpr (OA::P == 2)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)  // lo.hi
              mma_tf32<false>(part[mi][ni], fa[OA::P - 1], fb[0][ni]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[mi][ni][c];
    }
    cp_async_wait<0>();
    __syncthreads();  // the next run's copies may overwrite every slot
  }
};

// The forward's and the z recompute's tile: feats (N x d, K-major) times W
// (d x V: element (c, j) at w[j * V + c], MN-major).
template <typename TF, typename TW>
using ZTile = Tile<TF, true, TW, false>;

// The block's 128 x 128 accumulator tile through shared memory: acc to
// rows of AP floats at s (conflict-free 8-byte stores), then a barrier.
// The epilogues read it back a row a warp, 4 adjacent columns a lane:
// their loads and stores of the row are 16-byte vectors, and no register
// of theirs is live during the products.
__device__ __forceinline__ void stash(float* s, const Acc& acc) {
  const Frag f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(s + f.row(mi, h) * AP + f.col(ni)) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  __syncthreads();
}

// Row r of a stashed tile: this lane's 4 columns.
__device__ __forceinline__ void row4(const float* s, int r, float (&z)[4]) {
  const float4 v =
      *reinterpret_cast<const float4*>(s + r * AP + 4 * (threadIdx.x & 31));
  z[0] = v.x, z[1] = v.y, z[2] = v.z, z[3] = v.w;
}

// One side's online (max, sumexp) update of a row from one vocab tile: the
// lanes' columns c .. c + 3 (real where c < V; adj the row's prior-
// adjustment row, null: none), reduced across the warp in a fixed order.
// Lane `keeper` holds the row's running (m, s). The exponentials are
// ex2.approx (__expf, ~2^-22 relative): the lse's tolerance is 1e-4.
__device__ __forceinline__ void row_online(const float (&z)[4],
                                           const float* adj, int c, int V,
                                           int keeper, float& m, float& s) {
  float zz[4];
  float mt = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    zz[j] = -CUDART_INF_F;
    if (c + j < V) zz[j] = adj ? z[j] + adj[c + j] : z[j];
    mt = fmaxf(mt, zz[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
  if (mt == -CUDART_INF_F) return;  // no column of this tile is real
  const float mn = fmaxf(__shfl_sync(0xffffffffu, m, keeper), mt);
  float e = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (zz[j] != -CUDART_INF_F) e += __expf(zz[j] - mn);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    e += __shfl_xor_sync(0xffffffffu, e, off);
  if ((threadIdx.x & 31) == keeper) {
    s = s * __expf(m - mn) + e;  // exactly e while m is still -inf
    m = mn;
  }
}

// z[lab - c] when lab is one of the lane's columns c .. c + 3.
__device__ __forceinline__ bool pick(const float (&z)[4], int lab, int c,
                                     float& out) {
  if (lab < c || lab >= c + 4) return false;
  out = lab == c ? z[0] : lab == c + 1 ? z[1] : lab == c + 2 ? z[2] : z[3];
  return true;
}

// Merge (m, s) with another stream's (mo, so).
__device__ __forceinline__ void merge(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -CUDART_INF_F) return;  // both empty
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

// Forward, pass 1. Grid (token tiles, vocab tiles): block (x, p) computes
// z for token tile x and vocab tile p and writes per-token partials over
// the tile's columns, part[(q * n_vt + p) * N + row] for q = 0 .. 2 NS:
// (m, s) of each side, then the label logit (0 where the label is not in
// the tile).
template <typename TF, typename TW, int NS>
__global__ void __launch_bounds__(NT, 1)
    lace_fwd_kernel(const TF* __restrict__ feats, long long ldf,
                    const TW* __restrict__ w, const int* __restrict__ labels,
                    const float* __restrict__ adj_s,
                    const int* __restrict__ ids_s,
                    const float* __restrict__ adj_k,
                    const int* __restrict__ ids_k, int N, int d, int V,
                    float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lab[BM];
  __shared__ long long s_rs[BM], s_rk[BM];  // prior row offsets
  __shared__ float s_zl[BM];                // label logit (one writer a row)

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int row = m0 + r;
    const bool ok = row < N;
    s_lab[r] = ok ? labels[row] : -1;
    s_rs[r] = (ok && ids_s) ? static_cast<long long>(ids_s[row]) * V : 0;
    s_rk[r] = (NS == 2 && ok && ids_k) ? static_cast<long long>(ids_k[row]) * V
                                       : 0;
    s_zl[r] = 0.f;
  }
  // (Tile::run synchronises before any read of these)
  const ZTile<TF, TW> tile(smem, feats, ldf, N, w, V, V, d);
  Acc acc;
  zero(acc);
  tile.run(m0, n0, acc);
  stash(smem, acc);
  // Warp w reduces its rows w * 16 + rr; lane rr keeps row rr's (m, s).
  const int c = n0 + 4 * lane;
  float ms = -CUDART_INF_F, ss = 0.f, mk = -CUDART_INF_F, sk = 0.f;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (m0 + r >= N) break;
    float z[4];
    row4(smem, r, z);
    float zl;
    if (pick(z, s_lab[r], c, zl)) s_zl[r] = zl;
    row_online(z, adj_s ? adj_s + s_rs[r] : nullptr, c, V, rr, ms, ss);
    if constexpr (NS == 2)
      row_online(z, adj_k ? adj_k + s_rk[r] : nullptr, c, V, rr, mk, sk);
  }
  __syncthreads();  // every s_zl written
  const int r = warp * ROWS_PER_WARP + lane;
  if (lane < ROWS_PER_WARP && m0 + r < N) {
    const long long o = static_cast<long long>(blockIdx.y) * N + m0 + r;
    const long long q = static_cast<long long>(gridDim.y) * N;
    part[o] = ms;
    part[q + o] = ss;
    if constexpr (NS == 2) {
      part[2 * q + o] = mk;
      part[3 * q + o] = sk;
    }
    part[2 * NS * q + o] = s_zl[r];
  }
}

// Forward, pass 2: merge the splits' partials of one token per thread.
template <int NS>
__global__ void lace_fwd_merge_kernel(
    const float* __restrict__ part, int splits, int N, int V,
    const int* __restrict__ labels, const float* __restrict__ adj_s,
    const int* __restrict__ ids_s, const float* __restrict__ adj_k,
    const int* __restrict__ ids_k, float* __restrict__ nll_s,
    float* __restrict__ nll_k, float* __restrict__ lse_s,
    float* __restrict__ lse_k) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long q = static_cast<long long>(splits) * N;
  float m_s = -CUDART_INF_F, s_s = 0.f, m_k = -CUDART_INF_F, s_k = 0.f;
  float z = 0.f;
  for (int p = 0; p < splits; ++p) {
    const long long o = static_cast<long long>(p) * N + row;
    merge(m_s, s_s, part[o], part[q + o]);
    if constexpr (NS == 2) merge(m_k, s_k, part[2 * q + o], part[3 * q + o]);
    z += part[2 * NS * q + o];
  }
  const int lab = labels[row];
  const bool hit = lab >= 0 && lab < V;  // out of range: no label logit
  float ll_s = hit ? z : 0.f;
  if (hit && adj_s)
    ll_s += adj_s[(ids_s ? static_cast<long long>(ids_s[row]) * V : 0) + lab];
  const float ls = logf(s_s) + m_s;
  lse_s[row] = ls;
  nll_s[row] = ls - ll_s;
  if constexpr (NS == 2) {
    float ll_k = hit ? z : 0.f;
    if (hit && adj_k)
      ll_k += adj_k[(ids_k ? static_cast<long long>(ids_k[row]) * V : 0) + lab];
    const float lk = logf(s_k) + m_k;
    lse_k[row] = lk;
    nll_k[row] = lk - ll_k;
  }
}

// Backward, step 1 of a chunk: g_x[row][c - v0] for columns v0 <= c < v_end.
template <typename TF, typename TW, int NS>
__global__ void __launch_bounds__(NT, 1) lace_grad_kernel(
    const TF* __restrict__ feats, long long ldf, const TW* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ adj_s,
    const int* __restrict__ ids_s, const float* __restrict__ adj_k,
    const int* __restrict__ ids_k, const float* __restrict__ lse_s,
    const float* __restrict__ lse_k, const float* __restrict__ ts_s,
    const float* __restrict__ ts_k, int N, int d, int V, int v0, int v_end,
    int ldg, float* __restrict__ g_s, float* __restrict__ g_k) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lab[BM];
  __shared__ long long s_rs[BM], s_rk[BM];
  __shared__ float s_ls[BM], s_lk[BM], s_ts[BM], s_tk[BM];

  const int m0 = blockIdx.x * BM;
  const int n0 = v0 + blockIdx.y * BN;
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int row = m0 + r;
    const bool ok = row < N;
    s_lab[r] = ok ? labels[row] : -1;
    s_rs[r] = (ok && ids_s) ? static_cast<long long>(ids_s[row]) * V : 0;
    s_ls[r] = ok ? lse_s[row] : 0.f;
    s_ts[r] = ok ? ts_s[row] : 0.f;
    if constexpr (NS == 2) {
      s_rk[r] = (ok && ids_k) ? static_cast<long long>(ids_k[row]) * V : 0;
      s_lk[r] = ok ? lse_k[row] : 0.f;
      s_tk[r] = ok ? ts_k[row] : 0.f;
    }
  }
  const ZTile<TF, TW> tile(smem, feats, ldf, N, w, V, v_end, d);
  Acc acc;
  zero(acc);
  tile.run(m0, n0, acc);
  stash(smem, acc);
  const int warp = threadIdx.x >> 5;
  const int c = n0 + 4 * (threadIdx.x & 31);
  const bool full = ldg % 4 == 0 && c + 3 < v_end;  // one 16-byte store
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    const int row = m0 + r;
    if (row >= N) break;
    float z[4], gs[4], gk[4];
    row4(smem, r, z);
    const float* as = adj_s ? adj_s + s_rs[r] : nullptr;
    const float* ak = (NS == 2 && adj_k) ? adj_k + s_rk[r] : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool real = c + j < v_end;
      const float onehot = c + j == s_lab[r] ? 1.f : 0.f;
      const float zs = (as && real) ? z[j] + as[c + j] : z[j];
      gs[j] = (expf(zs - s_ls[r]) - onehot) * s_ts[r];
      if constexpr (NS == 2) {
        const float zk = (ak && real) ? z[j] + ak[c + j] : z[j];
        gk[j] = (expf(zk - s_lk[r]) - onehot) * s_tk[r];
      }
    }
    const long long o = static_cast<long long>(row) * ldg + c - v0;
    if (full) {
      *reinterpret_cast<float4*>(g_s + o) = make_float4(gs[0], gs[1], gs[2],
                                                        gs[3]);
      if constexpr (NS == 2)
        *reinterpret_cast<float4*>(g_k + o) =
            make_float4(gk[0], gk[1], gk[2], gk[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j >= v_end) continue;
        g_s[o + j] = gs[j];
        if constexpr (NS == 2) g_k[o + j] = gk[j];
      }
    }
  }
}

// The backward's df and dW products: C = A B, or C += A B when accumulate,
// A the (M x K) operand, B the (Nc x K) one (AK, BKM: K-major). blockIdx.z
// picks one of two (A, C) pairs sharing B. Each output sums its K products
// in segments of KSEG, each a fresh accumulator chain added into C: the
// rounding of the f32 sum then grows with the segment, not with all of K
// (the vocab chunk for df, every token for dW).
template <typename TA, bool AK, typename TB, bool BKM>
__global__ void __launch_bounds__(NT, 1)
    lace_gemm_kernel(const TA* __restrict__ a0, const TA* __restrict__ a1,
                     long long lda, const TB* __restrict__ b, long long ldb,
                     float* __restrict__ c0, float* __restrict__ c1,
                     long long ldc, int M, int Nc, int K, int accumulate) {
  extern __shared__ __align__(16) float smem[];
  const TA* a = blockIdx.z == 0 ? a0 : a1;
  float* c = blockIdx.z == 0 ? c0 : c1;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int n = n0 + 4 * (threadIdx.x & 31);
  // one 16-byte read-modify-write of C a row
  const bool full = reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                    ldc % 4 == 0 && n + 3 < Nc;
  Acc acc;
  for (int k0 = 0; k0 < K; k0 += KSEG) {
    const long long kk = k0;
    const Tile<TA, AK, TB, BKM> tile(smem, a + (AK ? kk : kk * lda), lda, M,
                                     b + (BKM ? kk : kk * ldb), ldb, Nc,
                                     min(KSEG, K - k0));
    zero(acc);
    tile.run(m0, n0, acc);
    stash(smem, acc);
    const bool add = accumulate || k0 > 0;
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int m = m0 + r;
      if (m >= M) break;
      float v[4];
      row4(smem, r, v);
      float* cr = c + static_cast<long long>(m) * ldc + n;
      if (full) {
        float4 o = make_float4(v[0], v[1], v[2], v[3]);
        if (add) {
          const float4 old = *reinterpret_cast<const float4*>(cr);
          o.x += old.x, o.y += old.y, o.z += old.z, o.w += old.w;
        }
        *reinterpret_cast<float4*>(cr) = o;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < Nc) cr[j] = add ? cr[j] + v[j] : v[j];
      }
    }
    __syncthreads();  // the next segment's copies overwrite the stash
  }
}

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Allow a kernel its dynamic shared memory (above 48 KB only on request).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The forward of NS sides: pass 1 over (token tiles, vocab tiles), then
// the merge of each token's splits = cdiv(V, BN) partials. The _k
// arguments are unused when NS == 1.
template <typename TF, typename TW, int NS>
cudaError_t fwd(const void* feats, long long ldf, const void* w,
                const int* labels, const float* adj_s, const int* ids_s,
                const float* adj_k, const int* ids_k, int N, int d, int V,
                int splits, float* part, float* nll_s, float* nll_k,
                float* lse_s, float* lse_k, cudaStream_t st) {
  if (splits != cdiv(V, BN)) return cudaErrorInvalidValue;
  constexpr int smem = ZTile<TF, TW>::SMEM;
  cudaError_t err = allow_smem(lace_fwd_kernel<TF, TW, NS>, smem);
  if (err != cudaSuccess) return err;
  lace_fwd_kernel<TF, TW, NS><<<dim3(cdiv(N, BM), splits), NT, smem, st>>>(
      static_cast<const TF*>(feats), ldf, static_cast<const TW*>(w), labels,
      adj_s, ids_s, adj_k, ids_k, N, d, V, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lace_fwd_merge_kernel<NS><<<cdiv(N, 256), 256, 0, st>>>(
      part, splits, N, V, labels, adj_s, ids_s, adj_k, ids_k, nll_s, nll_k,
      lse_s, lse_k);
  return cudaGetLastError();
}

// The backward of NS sides over vocab chunks of vc columns; dw null skips
// the dW_s product (a side whose head gradient nobody reads).
template <typename TF, typename TW, int NS>
cudaError_t bwd(const void* feats_v, long long ldf, const void* w_v,
                const int* labels, const float* adj_s, const int* ids_s,
                const float* adj_k, const int* ids_k, const float* lse_s,
                const float* lse_k, const float* ts_s, const float* ts_k,
                int N, int d, int V, int vc, float* g_s, float* g_k,
                float* df_s, float* df_k, float* dw, cudaStream_t st) {
  const TF* feats = static_cast<const TF*>(feats_v);
  const TW* w = static_cast<const TW*>(w_v);
  // df_x = g_x (N x width, K-major) W[:, chunk]^T (d x width, K-major);
  // dW = feats^T (d x N, MN-major) g_s (width x N, MN-major)
  using DfTile = Tile<float, true, TW, true>;
  using DwTile = Tile<TF, false, float, false>;
  constexpr int z_smem = ZTile<TF, TW>::SMEM;
  cudaError_t err = allow_smem(lace_grad_kernel<TF, TW, NS>, z_smem);
  if (err == cudaSuccess)
    err = allow_smem(lace_gemm_kernel<float, true, TW, true>, DfTile::SMEM);
  if (err == cudaSuccess)
    err = allow_smem(lace_gemm_kernel<TF, false, float, false>, DwTile::SMEM);
  if (err != cudaSuccess) return err;
  for (int v0 = 0; v0 < V; v0 += vc) {
    const int v_end = v0 + vc < V ? v0 + vc : V;
    const int width = v_end - v0;
    lace_grad_kernel<TF, TW, NS><<<dim3(cdiv(N, BM), cdiv(width, BN)), NT,
                                   z_smem, st>>>(
        feats, ldf, w, labels, adj_s, ids_s, adj_k, ids_k, lse_s, lse_k,
        ts_s, ts_k, N, d, V, v0, v_end, vc, g_s, g_k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // df_x (N, d) (+)= g_x (N, width) @ W[:, v0:v_end]^T, one z slice a side
    lace_gemm_kernel<float, true, TW, true>
        <<<dim3(cdiv(N, BM), cdiv(d, BN), NS), NT, DfTile::SMEM, st>>>(
            g_s, g_k, vc, w + v0, V, df_s, df_k, d, N, d, width, v0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (dw == nullptr) continue;
    // dW[:, v0:v_end] (d, width) = feats^T (d, N) @ g_s (N, width)
    lace_gemm_kernel<TF, false, float, false>
        <<<dim3(cdiv(d, BM), cdiv(width, BN), 1), NT, DwTile::SMEM, st>>>(
            feats, nullptr, ldf, g_s, vc, dw + v0, nullptr, V, d, width, N, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Instantiate the templated entry for every (feats, w) dtype pair: codes
// 0 = float32, 1 = bfloat16.
#define LACE_DISPATCH(feats_dtype, w_dtype, CALL)                        \
  do {                                                                   \
    if (feats_dtype == 0 && w_dtype == 0) return CALL(float, float);     \
    if (feats_dtype == 1 && w_dtype == 0)                                \
      return CALL(__nv_bfloat16, float);                                 \
    if (feats_dtype == 0 && w_dtype == 1)                                \
      return CALL(float, __nv_bfloat16);                                 \
    if (feats_dtype == 1 && w_dtype == 1)                                \
      return CALL(__nv_bfloat16, __nv_bfloat16);                         \
    return cudaErrorInvalidValue;                                        \
  } while (0)
