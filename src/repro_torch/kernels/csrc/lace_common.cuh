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
// forward gives each block one 128-token tile and a strided share of the
// 128-column vocab tiles ("splits"): every thread keeps its own online
// (max, sum) per row and side over the columns it computes, the 16 threads
// of a row merge theirs with shuffles, and a second small kernel merges the
// splits' partial (max, sum, label logit) per token. The split count is
// chosen by the caller so the grid fills the SMs (N = 8192 is only 64 token
// tiles). Columns are masked by index (c < V), never by a -inf prior: at
// tau = 0 a padded prior would mask nothing. The backward's two reductions
// run over different axes (df over the vocab, dW over the tokens), so it
// walks the vocab in chunks of vc columns: one kernel recomputes the z
// tiles of the chunk and writes each side's cotangent tile g_x (N, vc) to a
// workspace -- the sides share one z tile -- then plain GEMMs fold the
// chunk into every df_x (accumulated over chunks) and, when asked, write
// dW_s's vc columns. No atomics, so the sums are deterministic; each
// output's sum runs in chains of at most 1024 products (gemm_kernel), which
// keeps its f32 rounding near that of the chunked plain version.
//
// Every product runs on the CUDA cores in f32 (the reference upcasts each
// chunk to f32; TF32 or bf16 tensor cores would change the numbers): a
// 128x128x8 tile per block, 8x8 outputs per thread, a register-staged
// double buffer in shared memory. At the training shapes (N = 8192 tokens,
// d = 1024, V = 151936) one z pass is 2*N*d*V = 2.55 TFLOP, far above the
// ridge point: the f32 rate bounds every kernel here (38 ms a pass at 67
// TFLOP/s), not the 622 MB of W.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // rows (tokens, or d for dW) per block
constexpr int BN = 128;   // columns per block
constexpr int BK = 8;     // reduction depth per shared-memory stage
constexpr int NT = 256;   // threads: 16 x 16, 8 x 8 outputs each
constexpr int KSEG = 1024;  // products per register chain in the GEMMs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row i (0..7) and column j (0..7) of a thread's 8 x 8 outputs: two 4-wide
// groups 64 apart, so the shared-memory reads are 16-byte vectors.
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

// C(BM x BN) += A(m0.., k) B(k, n0..) over k < K, in f32.
//   A(m, k) = TA_T ? A[k * lda + m] : A[m * lda + k]
//   B(k, n) = TB_T ? B[n * ldb + k] : B[k * ldb + n]
// Rows m >= M, columns n >= Nc and depth k >= K read as 0. Every thread of
// the block must call it; it leaves the shared buffers free on return.
template <typename TA, bool TA_T, typename TB, bool TB_T>
struct Gemm {
  float (*As)[BK][BM];
  float (*Bs)[BK][BN];
  const TA* A;
  long long lda;
  const TB* B;
  long long ldb;
  int M, Nc, K;

  __device__ __forceinline__ void load(int m0, int n0, int k0, float (&ra)[4],
                                       float (&rb)[4]) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int m, k;
      if (TA_T) {
        k = k0 + (t >> 5);
        m = m0 + (t & 31) * 4 + e;
      } else {
        m = m0 + (t >> 1);
        k = k0 + (t & 1) * 4 + e;
      }
      float a = 0.f;
      if (m < M && k < K)
        a = to_f32(TA_T ? A[static_cast<long long>(k) * lda + m]
                        : A[static_cast<long long>(m) * lda + k]);
      ra[e] = a;
      int n;
      if (TB_T) {
        n = n0 + (t >> 1);
        k = k0 + (t & 1) * 4 + e;
      } else {
        k = k0 + (t >> 5);
        n = n0 + (t & 31) * 4 + e;
      }
      float b = 0.f;
      if (n < Nc && k < K)
        b = to_f32(TB_T ? B[static_cast<long long>(n) * ldb + k]
                        : B[static_cast<long long>(k) * ldb + n]);
      rb[e] = b;
    }
  }

  __device__ __forceinline__ void store(int buf, const float (&ra)[4],
                                        const float (&rb)[4]) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (TA_T)
        As[buf][t >> 5][(t & 31) * 4 + e] = ra[e];
      else
        As[buf][(t & 1) * 4 + e][t >> 1] = ra[e];
      if (TB_T)
        Bs[buf][(t & 1) * 4 + e][t >> 1] = rb[e];
      else
        Bs[buf][t >> 5][(t & 31) * 4 + e] = rb[e];
    }
  }

  __device__ __forceinline__ void run(int m0, int n0,
                                      float (&acc)[8][8]) const {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    float ra[4], rb[4];
    __syncthreads();  // the caller may still read the buffers
    load(m0, n0, 0, ra, rb);
    store(0, ra, rb);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const bool next = k0 + BK < K;
      if (next) load(m0, n0, k0 + BK, ra, rb);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (next) store(buf ^ 1, ra, rb);
      __syncthreads();
      buf ^= 1;
    }
  }
};

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// One side's online (max, sumexp) update over a thread's 8 columns of row
// i; adj is the row's prior-adjustment row (null: no adjustment).
__device__ __forceinline__ void online(const float (&z)[8], const float* adj,
                                       int n0, int tx, int V, float& m,
                                       float& s) {
  float zz[8];
  float mt = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + col_of(tx, j);
    zz[j] = -CUDART_INF_F;
    if (c < V) {
      zz[j] = adj ? z[j] + adj[c] : z[j];
      mt = fmaxf(mt, zz[j]);
    }
  }
  if (mt == -CUDART_INF_F) return;  // no column of this tile is real
  const float mn = fmaxf(m, mt);
  s *= expf(m - mn);  // exactly 0 while m is still -inf
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (zz[j] != -CUDART_INF_F) s += expf(zz[j] - mn);
  m = mn;
}

// Merge (m, s) with another stream's (mo, so).
__device__ __forceinline__ void merge(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -CUDART_INF_F) return;  // both empty
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

// Forward, pass 1. Grid (token tiles, splits); split p computes the vocab
// tiles p, p + splits, ... and writes per-token partials
// part[(q * splits + p) * N + row] for q = 0 .. 2 NS: (m, s) of each side,
// then the label logit z_label.
template <typename TF, typename TW, int NS>
__global__ void __launch_bounds__(NT, 1)
    lace_fwd_kernel(const TF* __restrict__ feats, long long ldf,
                    const TW* __restrict__ w, const int* __restrict__ labels,
                    const float* __restrict__ adj_s,
                    const int* __restrict__ ids_s,
                    const float* __restrict__ adj_k,
                    const int* __restrict__ ids_k, int N, int d, int V,
                    int n_vt, int splits, float* __restrict__ part) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ int s_lab[BM];
  __shared__ long long s_rs[BM], s_rk[BM];  // prior row offsets

  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int row = m0 + r;
    const bool ok = row < N;
    s_lab[r] = ok ? labels[row] : -1;
    s_rs[r] = (ok && ids_s) ? static_cast<long long>(ids_s[row]) * V : 0;
    s_rk[r] = (NS == 2 && ok && ids_k) ? static_cast<long long>(ids_k[row]) * V
                                       : 0;
  }
  // (the first Gemm::run synchronises before any read of these)

  const Gemm<TF, false, TW, false> gemm{As, Bs, feats, ldf, w, V, N, V, d};
  float ms[8], ss[8], mk[8], sk[8], zl[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ms[i] = mk[i] = -CUDART_INF_F;
    ss[i] = sk[i] = zl[i] = 0.f;
  }
  float acc[8][8];
  for (int vt = split; vt < n_vt; vt += splits) {
    const int n0 = vt * BN;
    zero(acc);
    gemm.run(m0, n0, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row_of(ty, i);
      const int lab = s_lab[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n0 + col_of(tx, j) == lab) zl[i] = acc[i][j];
      online(acc[i], adj_s ? adj_s + s_rs[r] : nullptr, n0, tx, V, ms[i],
             ss[i]);
      if constexpr (NS == 2)
        online(acc[i], adj_k ? adj_k + s_rk[r] : nullptr, n0, tx, V, mk[i],
               sk[i]);
    }
  }
  // The 16 threads that hold a row (one half-warp) merge their streams.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float mso = __shfl_xor_sync(0xffffffffu, ms[i], off);
      const float sso = __shfl_xor_sync(0xffffffffu, ss[i], off);
      zl[i] += __shfl_xor_sync(0xffffffffu, zl[i], off);  // one holder
      merge(ms[i], ss[i], mso, sso);
      if constexpr (NS == 2) {
        const float mko = __shfl_xor_sync(0xffffffffu, mk[i], off);
        const float sko = __shfl_xor_sync(0xffffffffu, sk[i], off);
        merge(mk[i], sk[i], mko, sko);
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + row_of(ty, i);
      if (row >= N) continue;
      const long long o = static_cast<long long>(split) * N + row;
      const long long q = static_cast<long long>(splits) * N;
      part[o] = ms[i];
      part[q + o] = ss[i];
      if constexpr (NS == 2) {
        part[2 * q + o] = mk[i];
        part[3 * q + o] = sk[i];
      }
      part[2 * NS * q + o] = zl[i];
    }
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
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ int s_lab[BM];
  __shared__ long long s_rs[BM], s_rk[BM];
  __shared__ float s_ls[BM], s_lk[BM], s_ts[BM], s_tk[BM];

  const int m0 = blockIdx.x * BM;
  const int n0 = v0 + blockIdx.y * BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
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
  const Gemm<TF, false, TW, false> gemm{As, Bs, feats, ldf, w, V, N, v_end, d};
  float acc[8][8];
  zero(acc);
  gemm.run(m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(ty, i);
    const int row = m0 + r;
    if (row >= N) continue;
    const float* as = adj_s ? adj_s + s_rs[r] : nullptr;
    const float* ak = (NS == 2 && adj_k) ? adj_k + s_rk[r] : nullptr;
    const long long o = static_cast<long long>(row) * ldg - v0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c >= v_end) continue;
      const float onehot = c == s_lab[r] ? 1.f : 0.f;
      const float zs = as ? acc[i][j] + as[c] : acc[i][j];
      g_s[o + c] = (expf(zs - s_ls[r]) - onehot) * s_ts[r];
      if constexpr (NS == 2) {
        const float zk = ak ? acc[i][j] + ak[c] : acc[i][j];
        g_k[o + c] = (expf(zk - s_lk[r]) - onehot) * s_tk[r];
      }
    }
  }
}

// Plain GEMM for the backward's df and dW steps: C = A B, or C += A B when
// accumulate. blockIdx.z picks one of two (A, C) pairs sharing B. Each
// output sums its K products in segments of KSEG, each a fresh register
// chain added into C: the rounding of the f32 sum then grows with the
// segment, not with all of K (the vocab chunk for df, every token for dW).
template <typename TA, bool TA_T, typename TB, bool TB_T>
__global__ void __launch_bounds__(NT, 2)
    gemm_kernel(const TA* __restrict__ a0, const TA* __restrict__ a1,
                long long lda, const TB* __restrict__ b, long long ldb,
                float* __restrict__ c0, float* __restrict__ c1,
                long long ldc, int M, int Nc, int K, int accumulate) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const TA* a = blockIdx.z == 0 ? a0 : a1;
  float* c = blockIdx.z == 0 ? c0 : c1;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][8];
  for (int k0 = 0; k0 < K; k0 += KSEG) {
    const long long kk = k0;
    const Gemm<TA, TA_T, TB, TB_T> gemm{
        As, Bs, a + (TA_T ? kk * lda : kk), lda, b + (TB_T ? kk : kk * ldb),
        ldb, M, Nc, min(KSEG, K - k0)};
    zero(acc);
    gemm.run(m0, n0, acc);
    const bool add = accumulate || k0 > 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row_of(ty, i);
      if (m >= M) continue;
      float* cr = c + static_cast<long long>(m) * ldc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + col_of(tx, j);
        if (n >= Nc) continue;
        cr[n] = add ? cr[n] + acc[i][j] : acc[i][j];
      }
    }
  }
}

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The forward of NS sides: pass 1 over (token tiles, splits), then the
// merge. The _k arguments are unused when NS == 1.
template <typename TF, typename TW, int NS>
cudaError_t fwd(const void* feats, long long ldf, const void* w,
                const int* labels, const float* adj_s, const int* ids_s,
                const float* adj_k, const int* ids_k, int N, int d, int V,
                int splits, float* part, float* nll_s, float* nll_k,
                float* lse_s, float* lse_k, cudaStream_t st) {
  const int n_vt = cdiv(V, BN);
  lace_fwd_kernel<TF, TW, NS><<<dim3(cdiv(N, BM), splits), NT, 0, st>>>(
      static_cast<const TF*>(feats), ldf, static_cast<const TW*>(w), labels,
      adj_s, ids_s, adj_k, ids_k, N, d, V, n_vt, splits, part);
  cudaError_t err = cudaGetLastError();
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
  for (int v0 = 0; v0 < V; v0 += vc) {
    const int v_end = v0 + vc < V ? v0 + vc : V;
    const int width = v_end - v0;
    lace_grad_kernel<TF, TW, NS><<<dim3(cdiv(N, BM), cdiv(width, BN)), NT, 0,
                                   st>>>(
        feats, ldf, w, labels, adj_s, ids_s, adj_k, ids_k, lse_s, lse_k,
        ts_s, ts_k, N, d, V, v0, v_end, vc, g_s, g_k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // df_x (N, d) (+)= g_x (N, width) @ W[:, v0:v_end]^T, one z slice a side
    gemm_kernel<float, false, TW, true>
        <<<dim3(cdiv(N, BM), cdiv(d, BN), NS), NT, 0, st>>>(
            g_s, g_k, vc, w + v0, V, df_s, df_k, d, N, d, width, v0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (dw == nullptr) continue;
    // dW[:, v0:v_end] (d, width) = feats^T (d, N) @ g_s (N, width)
    gemm_kernel<TF, true, float, false>
        <<<dim3(cdiv(d, BM), cdiv(width, BN), 1), NT, 0, st>>>(
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
