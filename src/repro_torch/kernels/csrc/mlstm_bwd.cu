// Chunkwise stabilized mLSTM backward (K6 backward) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through autodiff of
// repro/models/layers/xlstm.py:mlstm_chunk (its forward is K6,
// repro/kernels/mlstm/kernel.py). It computes what
// repro_torch/kernels/mlstm/ref.py:mlstm_chunk_bwd_plain spells out: from
// q, k, v, the gates and dh, the gradients dq, dk, dv (f32 sums, rounded
// once to q's dtype), d i_raw and d f_log (f32), with the final state's
// cotangent zero and the initial state the zero state or a constant.
//
// The algorithm, per head and chunk of L tokens (m held constant: h does
// not depend on it; ref.py says why). With g = dh, den_t the forward's
// denominator, S_ts = (q_t.k_s) e^{b_t-b_s+i_s-m_t} (s <= t):
//  * Y_t = C0 g_t and z_t = q_t.Y_t give g_t.num_t = w0_t z_t + sum_s
//    S_ts (g_t.v_s), so dd_t (the denominator's branch) and dw0_t = z_t /
//    den_t + (q_t.n0) dd_t need no h;
//  * intra: dS_ts = (g_t.v_s) / den_t + dd_t; dP = dS . D; dq += dP K,
//    dk += dP^T Q, dv += (S / den)^T G; the gradient of log D is dS . S;
//  * inter: dq += (w0 / den) Y + w0 dd n0; with (dC, dn) the end state's
//    cotangent, U_s = dC v_s + dn, dk_s += wk_s U_s, dv_s += wk_s dC^T
//    k_s, dwk_s = k_s.U_s; then dC <- wC0 dC + Q^T diag(w0 / den) G and
//    dn <- wC0 dn + Q^T (w0 dd);
//  * gates: with Phi_c = <C_c, dC_c> + <n_c, dn_c>, the gradient of F =
//    b_{L-1} is Phi_{c+1} and Phi_c = Phi_{c+1} - sum wk dwk + sum w0
//    dw0, so the reverse walk reads no state; df is a reversed cumsum
//    over the chunk of the gradient of b.
//
// Design: the chunk-level products are batched matrix products over (head,
// chunk) or, where a state is carried, over heads with one launch a chunk
// (mlstm_bwd_gemm_kernel: 64 x 64 output tiles, f32 FFMA, fixed-order
// sums). The forward's state walk reruns (pass A) into one (dk, dv) state a head,
// updated in place, computing Y from it chunk by chunk; the reverse walk
// (pass B) carries dC in the same buffer. Nothing is reduced across
// tiles of dk or dv: each product's output tile sums its whole depth
// itself. The states are never stored: one state a head, plus f32 tiles
// of Y, U, W and the intra parts of dq, dk, dv (mlstm_bwd_workspace: 1.10
// GB at 16 x 512 tokens, 4 heads of dk = dv = 1024, where every chunk's
// stored state would take 2 GiB).
// Per-token scalars (den, dd, dw0, the rows and columns of dS . S, dwk)
// and the gate gradients come from small kernels with fixed-order warp
// sums. No atomics: two runs are bitwise equal.
//
// Bound: about 12 L dk dv flops a chunk and head (the state rerun, Y,
// U, W and the dC update, each 2 L dk dv; the first chunk from the zero
// state and the last's zero dC skip some) against one read of q, k, v,
// dh and one write of the gradients, so the operations bound it. This
// first version runs on the CUDA cores in f32 (67 TFLOP/s), not the
// tensor cores; chip_smoke.py prints its time beside the TF32 bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mlstm_gates.cuh"

namespace {

constexpr int LC = GLC;    // rows of a chunk tile: the longest chunk
constexpr int NT = 256;    // threads per block
constexpr int NW = NT / 32;
constexpr int TM = 64;     // product tile rows
constexpr int TN = 64;     // product tile columns
constexpr int TK = 16;     // product depth a shared-memory stage
constexpr int PADT = 4;    // pad of a shared tile row (float4-aligned)
constexpr int TOKR = 6;    // per-token rows: r1, r2, dw0, rowE, colE, dwk
enum TokRow { R1 = 0, R2 = 1, DW0 = 2, ROWE = 3, COLE = 4, DWK = 5 };
static_assert(NT == 16 * 16 && TM == 4 * 16 && TN == TM,
              "a thread owns a 4 x 4 block of the 64 x 64 tile");
static_assert(NT == 4 * LC, "the token kernel takes four threads a row");
static_assert(NT == TK * TM / 4, "a float4 of A's tile a thread to scale");

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// The batched product. Batch z = (b * H + h) * NC + c for head (b, h) and
// chunk c0 + c; an operand's element (z, i, j) lies at p + b sb + h sh + c
// sc + i s0 + j s1.
// ---------------------------------------------------------------------------
struct Opd {
  const void* p;
  long long sb, sh, sc, s0, s1;
};

struct Gemm {
  Opd a, b;         // A (M x K) and B (K x N), of types TA, TB
  Opd out;          // Out (M x N), f32
  // Out = beta * Out + sum_k A(m, k) scale(k) B(k, n); beta at beta[zc]
  // (null: Out is overwritten, not read), scale at scale + zc * sstride
  // (null: 1), zc = (b * H + h) * nc + c0 + c the chunk's index
  const float* beta;
  const float* scale;
  long long sstride;
  int M, N, K;
  int tok;          // bits 0, 1, 2: M, N, K run over the chunk's tokens,
                    // masked at its length
  int H, NC, c0, nc, S, chunk;
};

// Rows x0 .. x0 + 63 and depths k0 .. k0 + TK - 1 of an operand into
// dst[k][x] (zero past xlim or klim). The threads walk the operand's unit
// stride, so the loads coalesce whichever axis it is.
template <typename T>
__device__ __forceinline__ void load_tile(float (*dst)[TM + PADT],
                                          const T* base, long long sx,
                                          long long sk, int x0, int k0,
                                          int xlim, int klim) {
  const bool kfast = sk == 1;
#pragma unroll
  for (int i = 0; i < TM * TK / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int x = kfast ? e / TK : e % TM;
    const int k = kfast ? e % TK : e / TM;
    const int gx = x0 + x, gk = k0 + k;
    dst[k][x] = (gx < xlim && gk < klim)
                    ? to_f32(base[gx * sx + gk * sk])
                    : 0.f;
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(NT) mlstm_bwd_gemm_kernel(Gemm g) {
  __shared__ __align__(16) float As[TK][TM + PADT];
  __shared__ __align__(16) float Bs[TK][TN + PADT];
  const int z = blockIdx.z;
  const int c = z % g.NC, bh = z / g.NC, b = bh / g.H, h = bh % g.H;
  const int cabs = g.c0 + c;
  const long long zc = static_cast<long long>(bh) * g.nc + cabs;
  const int Lc = min(g.chunk, g.S - cabs * g.chunk);
  const int Mlim = (g.tok & 1) ? Lc : g.M;
  const int Nlim = (g.tok & 2) ? Lc : g.N;
  const int Klim = (g.tok & 4) ? Lc : g.K;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const TA* A = static_cast<const TA*>(g.a.p) + b * g.a.sb + h * g.a.sh +
                c * g.a.sc;
  const TB* Bm = static_cast<const TB*>(g.b.p) + b * g.b.sb + h * g.b.sh +
                 c * g.b.sc;
  const float* sc = g.scale ? g.scale + zc * g.sstride : nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < Klim; k0 += TK) {
    load_tile<TA>(As, A, g.a.s0, g.a.s1, m0, k0, Mlim, Klim);
    load_tile<TB>(Bs, Bm, g.b.s1, g.b.s0, n0, k0, Nlim, Klim);
    __syncthreads();
    if (sc != nullptr) {
      // the depth's scale on A's tile: row k of As times scale(k0 + k), a
      // float4 a thread
      const int k = threadIdx.x / (TM / 4), x = 4 * (threadIdx.x % (TM / 4));
      const float s = k0 + k < Klim ? sc[k0 + k] : 0.f;
      float4* p = reinterpret_cast<float4*>(&As[k][x]);
      float4 v = *p;
      v.x *= s, v.y *= s, v.z *= s, v.w *= s;
      *p = v;
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* O = static_cast<float*>(const_cast<void*>(g.out.p)) + b * g.out.sb +
             h * g.out.sh + c * g.out.sc;
  const float beta = g.beta ? g.beta[zc] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= Mlim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= Nlim) continue;
      float* p = O + m * g.out.s0 + n * g.out.s1;
      *p = g.beta ? fmaf(beta, *p, acc[i][j]) : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// n at the start of every chunk: nst[(bh * nc + c) * dk + r]. Grid (B * H,
// ceil(dk / NT)), a thread a row of dk. n0 null: the zero state.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_nwalk_kernel(
    const T* __restrict__ k, const float* __restrict__ gates,
    const float* __restrict__ wc0, const float* __restrict__ n0,
    float* __restrict__ nst, int S, int H, int dk, int chunk, int nc,
    Strides sk) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r = blockIdx.y * NT + threadIdx.x;
  if (r >= dk) return;
  const T* kb = k + b * sk.b + h * sk.h + r;
  float n = n0 ? n0[static_cast<long long>(bh) * dk + r] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long zc = static_cast<long long>(bh) * nc + c;
    nst[zc * dk + r] = n;
    if (c + 1 == nc) break;
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const float* wk = gates + zc * GROWS * LC + 4 * LC;
    float acc = 0.f;
    for (int s = 0; s < Lc; ++s)
      acc = fmaf(wk[s], to_f32(kb[(t0 + s) * sk.s]), acc);
    n = fmaf(wc0[zc], n, acc);
  }
}

// ---------------------------------------------------------------------------
// The per-token scalars of a chunk and its (L x L) intra terms: grid B * H
// * nc, a block a chunk. P holds q k^T on entry and dP on exit; Gr holds
// g v^T on entry and S / den on exit; tok gets r1 = w0 / den, r2 = w0 dd,
// dw0 and the row and column sums of dS . S. has_y: Y holds C0 g (false:
// the first chunk from the zero state, where C0 = 0).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_token_kernel(
    const T* __restrict__ q, const float* __restrict__ gates,
    const float* __restrict__ nst, const float* __restrict__ Y,
    float* __restrict__ P, float* __restrict__ Gr, float* __restrict__ tok,
    int S, int H, int dk, int chunk, int nc, Strides sq, int zero0) {
  __shared__ float sg[GROWS][LC];
  __shared__ float qn[LC], zt[LC];
  __shared__ float Et[LC][LC + 1];
  const long long zc = blockIdx.x;
  const int bh = static_cast<int>(zc / nc), c = static_cast<int>(zc % nc);
  const int b = bh / H, h = bh % H;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_y = c > 0 || !zero0;
  for (int e = tid; e < GROWS * LC; e += NT)
    sg[e / LC][e % LC] = gates[zc * GROWS * LC + e];
  // q_t.n0 and z_t = q_t.Y_t, a warp a row
  const float* n0 = nst + zc * dk;
  for (int t = warp; t < LC; t += NW) {
    float a = 0.f, zz = 0.f;
    if (t < Lc) {
      const T* qt = q + b * sq.b + h * sq.h + (t0 + t) * sq.s;
      const float* yt = Y + (zc * LC + t) * dk;
      for (int r = lane; r < dk; r += 32) {
        const float x = to_f32(qt[r]);
        a = fmaf(x, n0[r], a);
        if (has_y) zz = fmaf(x, yt[r], zz);
      }
    }
    a = warp_sum(a), zz = warp_sum(zz);
    if (lane == 0) qn[t] = a, zt[t] = zz;
  }
  __syncthreads();
  // four threads a row t, 16 columns s each
  const int t = tid / 4, s0 = 16 * (tid % 4);
  const bool real = t < Lc;
  const float bt = sg[0][t], mt = sg[2][t], w0 = sg[3][t];
  float* Pt = P + (zc * LC + t) * LC;
  float* Gt = Gr + (zc * LC + t) * LC;
  float Sv[16], Dv[16], Gv[16], rs = 0.f, sgv = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int s = s0 + e;
    const bool on = real && s <= t;
    Dv[e] = on ? expf(bt - sg[0][s] + sg[1][s] - mt) : 0.f;
    Sv[e] = on ? Pt[s] * Dv[e] : 0.f;
    Gv[e] = on ? Gt[s] : 0.f;
    rs += Sv[e];
    sgv = fmaf(Sv[e], Gv[e], sgv);
  }
  rs += __shfl_xor_sync(0xffffffffu, rs, 1);
  rs += __shfl_xor_sync(0xffffffffu, rs, 2);
  sgv += __shfl_xor_sync(0xffffffffu, sgv, 1);
  sgv += __shfl_xor_sync(0xffffffffu, sgv, 2);
  const float d = fmaf(w0, qn[t], rs);
  const float floor_ = expf(-mt);
  const float den = real ? fmaxf(fabsf(d), floor_) : 1.f;
  const float gnum = fmaf(w0, zt[t], sgv);
  const float sgn = static_cast<float>((d > 0.f) - (d < 0.f));
  const float dd = real && fabsf(d) >= floor_ ? -sgn * gnum / (den * den)
                                              : 0.f;
  const float inv = 1.f / den;
  float rowE = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int s = s0 + e;
    const bool on = real && s <= t;
    const float dS = on ? fmaf(Gv[e], inv, dd) : 0.f;
    const float E = dS * Sv[e];
    Pt[s] = dS * Dv[e];
    Gt[s] = Sv[e] * inv;
    Et[t][s] = E;
    rowE += E;
  }
  rowE += __shfl_xor_sync(0xffffffffu, rowE, 1);
  rowE += __shfl_xor_sync(0xffffffffu, rowE, 2);
  float* tk = tok + zc * TOKR * LC;
  if (tid % 4 == 0) {
    tk[R1 * LC + t] = real ? w0 * inv : 0.f;
    tk[R2 * LC + t] = real ? w0 * dd : 0.f;
    tk[DW0 * LC + t] = real ? fmaf(zt[t], inv, qn[t] * dd) : 0.f;
    tk[ROWE * LC + t] = rowE;
  }
  __syncthreads();
  if (tid < LC) {
    float col = 0.f;
    for (int r = 0; r < LC; ++r) col += Et[r][tid];
    tk[COLE * LC + tid] = col;
  }
}

// ---------------------------------------------------------------------------
// dn at the end of every chunk: dnE[(bh * nc + c) * dk + r], from zero
// after the last; dn <- wC0 dn + sum_t r2_t q_t. Grid (B * H, ceil(dk /
// NT)).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_dnwalk_kernel(
    const T* __restrict__ q, const float* __restrict__ wc0,
    const float* __restrict__ tok, float* __restrict__ dnE, int S, int H,
    int dk, int chunk, int nc, Strides sq) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r = blockIdx.y * NT + threadIdx.x;
  if (r >= dk) return;
  const T* qb = q + b * sq.b + h * sq.h + r;
  float dn = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long zc = static_cast<long long>(bh) * nc + c;
    dnE[zc * dk + r] = dn;
    if (c == 0) break;
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const float* r2 = tok + zc * TOKR * LC + R2 * LC;
    float acc = 0.f;
    for (int t = 0; t < Lc; ++t)
      acc = fmaf(r2[t], to_f32(qb[(t0 + t) * sq.s]), acc);
    dn = fmaf(wc0[zc], dn, acc);
  }
}

// ---------------------------------------------------------------------------
// dq, dk, dv of a chunk from their intra parts and the inter terms, in the
// inputs' dtype, and dwk_s = k_s.(dC v_s + dn): grid B * H * nc, a warp a
// row. has_uw: U and W hold dC v and dC^T k (false: the last chunk, whose
// dC is zero).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_assemble_kernel(
    const T* __restrict__ k, const float* __restrict__ gates,
    const float* __restrict__ nst, const float* __restrict__ dnE,
    const float* __restrict__ Y, const float* __restrict__ U,
    const float* __restrict__ W, const float* __restrict__ dqi,
    const float* __restrict__ dki, const float* __restrict__ dvi,
    float* __restrict__ tok, T* __restrict__ gq, T* __restrict__ gk,
    T* __restrict__ gv, int S, int H, int dk, int dv, int chunk, int nc,
    Strides sk, int zero0) {
  const long long zc = blockIdx.x;
  const int bh = static_cast<int>(zc / nc), c = static_cast<int>(zc % nc);
  const int b = bh / H, h = bh % H;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool has_y = c > 0 || !zero0, has_uw = c + 1 < nc;
  float* tk = tok + zc * TOKR * LC;
  const float* n0 = nst + zc * dk;
  const float* dn = dnE + zc * dk;
  for (int t = warp; t < Lc; t += NW) {
    const float r1 = tk[R1 * LC + t], r2 = tk[R2 * LC + t];
    const float wk = gates[zc * GROWS * LC + 4 * LC + t];
    const long long row = zc * LC + t;
    const long long o = ((static_cast<long long>(b) * S + t0 + t) * H + h);
    const T* kt = k + b * sk.b + h * sk.h + (t0 + t) * sk.s;
    float dwk = 0.f;
    for (int r = lane; r < dk; r += 32) {
      float x = fmaf(r2, n0[r], dqi[row * dk + r]);
      if (has_y) x = fmaf(r1, Y[row * dk + r], x);
      store(gq + o * dk + r, x);
      const float u = has_uw ? U[row * dk + r] + dn[r] : dn[r];
      store(gk + o * dk + r, fmaf(wk, u, dki[row * dk + r]));
      dwk = fmaf(to_f32(kt[r]), u, dwk);
    }
    for (int j = lane; j < dv; j += 32) {
      float x = dvi[row * dv + j];
      if (has_uw) x = fmaf(wk, W[row * dv + j], x);
      store(gv + o * dv + j, x);
    }
    dwk = warp_sum(dwk);
    if (lane == 0) tk[DWK * LC + t] = dwk;
  }
}

// ---------------------------------------------------------------------------
// d i_raw and d f_log: one warp a head, the chunks in reverse, two rows a
// lane. di_s = colE_s + wk_s dwk_s; db_t = rowE_t - colE_t + w0_t dw0_t -
// wk_t dwk_t, plus dF = Phi_{c+1} at the chunk's last row; df the reversed
// cumsum of db over the chunk; Phi_c = Phi_{c+1} - sum wk dwk + sum w0 dw0.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32) mlstm_bwd_gategrad_kernel(
    const float* __restrict__ gates, const float* __restrict__ tok,
    float* __restrict__ gi, float* __restrict__ gf, int S, int H, int chunk,
    int nc) {
  const unsigned full = 0xffffffffu;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x;
  float phi = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long zc = static_cast<long long>(bh) * nc + c;
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const float* g = gates + zc * GROWS * LC;
    const float* tk = tok + zc * TOKR * LC;
    float db[2], sw = 0.f, s0 = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      db[e] = 0.f;
      if (t >= Lc) continue;
      const float w0 = g[3 * LC + t], wk = g[4 * LC + t];
      const float a0 = w0 * tk[DW0 * LC + t], ak = wk * tk[DWK * LC + t];
      const float col = tk[COLE * LC + t];
      db[e] = tk[ROWE * LC + t] - col + a0 - ak;
      if (t == Lc - 1) db[e] += phi;
      sw += ak, s0 += a0;
      gi[(static_cast<long long>(b) * S + t0 + t) * H + h] = col + ak;
    }
    // reversed inclusive sums: the lane's pair, then a scan down the lanes
    float inc = db[0] + db[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(full, inc, off);
      if (lane + off < 32) inc += y;
    }
    float after = __shfl_down_sync(full, inc, 1);
    if (lane == 31) after = 0.f;
    const float f1 = after + db[1], f0 = f1 + db[0];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      if (t < Lc)
        gf[(static_cast<long long>(b) * S + t0 + t) * H + h] = e ? f1 : f0;
    }
    phi = phi - warp_sum(sw) + warp_sum(s0);
  }
}

// The workspace, in floats, each region on a 256-byte boundary.
struct Work {
  long long gates, wc0, m1, nst, dnE, tok, P, Gr, state, Y, U, W, dqi, dki,
      dvi, total;
  Work(int B, int S, int H, int dk, int dv, int chunk) {
    const long long nc = (S + chunk - 1) / chunk;
    const long long T = static_cast<long long>(B) * H * nc;  // chunk tiles
    auto up = [](long long n) { return (n + 63) / 64 * 64; };
    gates = 0;
    wc0 = gates + up(T * GROWS * LC);
    m1 = wc0 + up(T);
    nst = m1 + up(static_cast<long long>(B) * H);
    dnE = nst + up(T * dk);
    tok = dnE + up(T * dk);
    P = tok + up(T * TOKR * LC);
    Gr = P + up(T * LC * LC);
    state = Gr + up(T * LC * LC);
    Y = state + up(static_cast<long long>(B) * H * dk * dv);
    U = Y + up(T * LC * dk);
    W = U + up(T * LC * dk);
    dqi = W + up(T * LC * dv);
    dki = dqi + up(T * LC * dk);
    dvi = dki + up(T * LC * dk);
    total = dvi + up(T * LC * dv);
  }
};

Opd opd(const void* p, long long sb, long long sh, long long sc, long long s0,
        long long s1) {
  return Opd{p, sb, sh, sc, s0, s1};
}

template <typename TA, typename TB>
cudaError_t bgemm(Gemm g, int B, cudaStream_t st) {
  const dim3 grid((g.N + TN - 1) / TN, (g.M + TM - 1) / TM, B * g.H * g.NC);
  mlstm_bwd_gemm_kernel<TA, TB><<<grid, NT, 0, st>>>(g);
  return cudaGetLastError();
}

#define CHECK(x)                                  \
  do {                                            \
    const cudaError_t e_ = (x);                   \
    if (e_ != cudaSuccess) return e_;             \
  } while (0)

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* ig,
           const float* fg, const float* C0, const float* n0, const float* m0,
           const float* dh, T* gq, T* gk, T* gv, float* gi, float* gf,
           float* work, int B, int S, int H, int dk, int dv, int chunk,
           Strides sq, Strides sk, Strides sv, cudaStream_t st) {
  const int nc = (S + chunk - 1) / chunk;
  const Work w(B, S, H, dk, dv, chunk);
  float* gates = work + w.gates;
  float* wc0 = work + w.wc0;
  float* tok = work + w.tok;
  float* state = work + w.state;
  const int zero0 = C0 == nullptr;
  const long long HD = static_cast<long long>(dk) * dv;  // a head's state
  // tile buffers [(bh * nc + c)][LC][width]: strides of (b, h, c)
  auto tiles = [&](const float* p, int width) {
    const long long c = static_cast<long long>(LC) * width;
    return opd(p, H * nc * c, nc * c, c, width, 1);
  };
  // (B, S, H, width) inputs: strides of (b, h, chunk c), token, column
  auto seq = [&](const void* p, Strides s) {
    return opd(p, s.b, s.h, chunk * s.s, s.s, 1);
  };
  const Strides sg{static_cast<long long>(S) * H * dv,
                   static_cast<long long>(H) * dv, dv};  // dh's
  auto base = [&](int NC, int c0, int M, int N, int K, int tok_) {
    Gemm g{};
    g.M = M, g.N = N, g.K = K, g.tok = tok_;
    g.H = H, g.NC = NC, g.c0 = c0, g.nc = nc, g.S = S, g.chunk = chunk;
    return g;
  };
  const dim3 rows(B * H, (dk + NT - 1) / NT);

  mlstm_gate_kernel<<<B * H, 32, 0, st>>>(ig, fg, m0, gates, wc0,
                                          work + w.m1, S, H, chunk, nc);
  CHECK(cudaGetLastError());
  mlstm_bwd_nwalk_kernel<T><<<rows, NT, 0, st>>>(
      k, gates, wc0, n0, work + w.nst, S, H, dk, chunk, nc, sk);
  CHECK(cudaGetLastError());

  // the intra products of every chunk: P = Q K^T, Gr = G V^T
  {
    Gemm g = base(nc, 0, chunk, chunk, dk, 3);
    g.a = seq(q, sq);
    g.b = opd(k, sk.b, sk.h, chunk * sk.s, 1, sk.s);  // (r, s) of k^T
    g.out = tiles(work + w.P, LC);
    CHECK((bgemm<T, T>(g, B, st)));
    g = base(nc, 0, chunk, chunk, dv, 3);
    g.a = seq(dh, sg);
    g.b = opd(v, sv.b, sv.h, chunk * sv.s, 1, sv.s);
    g.out = tiles(work + w.Gr, LC);
    CHECK((bgemm<float, T>(g, B, st)));
  }

  // pass A: the state walk, Y_c = G_c C_c^T from each chunk's start state
  if (!zero0)
    CHECK(cudaMemcpyAsync(state, C0, sizeof(float) * B * H * HD,
                          cudaMemcpyDeviceToDevice, st));
  for (int c = 0; c < nc; ++c) {
    const long long off = static_cast<long long>(c) * LC;
    if (c > 0 || !zero0) {
      Gemm g = base(1, c, chunk, dk, dv, 1);
      g.a = seq(dh + c * chunk * sg.s, sg);
      g.b = opd(state, H * HD, HD, 0, 1, dv);  // (j, r) of C^T
      g.out = tiles(work + w.Y + off * dk, dk);
      CHECK((bgemm<float, float>(g, B, st)));
    }
    if (c + 1 < nc) {
      // C <- wC0 C + K^T diag(wk) V
      Gemm g = base(1, c, dk, dv, chunk, 4);
      g.a = opd(k + c * chunk * sk.s, sk.b, sk.h, 0, 1, sk.s);
      g.b = opd(v + c * chunk * sv.s, sv.b, sv.h, 0, sv.s, 1);
      g.out = opd(state, H * HD, HD, 0, dv, 1);
      g.scale = gates + 4 * LC, g.sstride = GROWS * LC;
      g.beta = (c > 0 || !zero0) ? wc0 : nullptr;
      CHECK((bgemm<T, T>(g, B, st)));
    }
  }

  mlstm_bwd_token_kernel<T><<<B * H * nc, NT, 0, st>>>(
      q, gates, work + w.nst, work + w.Y, work + w.P, work + w.Gr, tok, S, H,
      dk, chunk, nc, sq, zero0);
  CHECK(cudaGetLastError());
  mlstm_bwd_dnwalk_kernel<T><<<rows, NT, 0, st>>>(
      q, wc0, tok, work + w.dnE, S, H, dk, chunk, nc, sq);
  CHECK(cudaGetLastError());

  // the intra gradients of every chunk: dP K, dP^T Q, (S / den)^T G
  {
    Gemm g = base(nc, 0, chunk, dk, chunk, 5);
    g.a = tiles(work + w.P, LC);
    g.b = seq(k, sk);
    g.out = tiles(work + w.dqi, dk);
    CHECK((bgemm<float, T>(g, B, st)));
    g.a = opd(work + w.P, H * nc * LC * LC, nc * LC * LC, LC * LC, 1, LC);
    g.b = seq(q, sq);
    g.out = tiles(work + w.dki, dk);
    CHECK((bgemm<float, T>(g, B, st)));
    g = base(nc, 0, chunk, dv, chunk, 5);
    g.a = opd(work + w.Gr, H * nc * LC * LC, nc * LC * LC, LC * LC, 1, LC);
    g.b = seq(dh, sg);
    g.out = tiles(work + w.dvi, dv);
    CHECK((bgemm<float, float>(g, B, st)));
  }

  // pass B: dC at the end of chunk c - 1, then U = V dC^T, W = K dC there
  for (int c = nc - 1; c >= 1; --c) {
    Gemm g = base(1, c, dk, dv, chunk, 4);
    g.a = opd(q + c * chunk * sq.s, sq.b, sq.h, 0, 1, sq.s);
    g.b = seq(dh + c * chunk * sg.s, sg);
    g.out = opd(state, H * HD, HD, 0, dv, 1);
    g.scale = tok + R1 * LC, g.sstride = TOKR * LC;
    g.beta = c + 1 < nc ? wc0 : nullptr;
    CHECK((bgemm<T, float>(g, B, st)));
    const long long off = static_cast<long long>(c - 1) * LC;
    g = base(1, c - 1, chunk, dk, dv, 1);
    g.a = seq(v + (c - 1) * chunk * sv.s, sv);
    g.b = opd(state, H * HD, HD, 0, 1, dv);  // (j, r) of dC^T
    g.out = tiles(work + w.U + off * dk, dk);
    CHECK((bgemm<T, float>(g, B, st)));
    g = base(1, c - 1, chunk, dv, dk, 1);
    g.a = seq(k + (c - 1) * chunk * sk.s, sk);
    g.b = opd(state, H * HD, HD, 0, dv, 1);
    g.out = tiles(work + w.W + off * dv, dv);
    CHECK((bgemm<T, float>(g, B, st)));
  }

  mlstm_bwd_assemble_kernel<T><<<B * H * nc, NT, 0, st>>>(
      k, gates, work + w.nst, work + w.dnE, work + w.Y, work + w.U,
      work + w.W, work + w.dqi, work + w.dki, work + w.dvi, tok, gq, gk, gv,
      S, H, dk, dv, chunk, nc, sk, zero0);
  CHECK(cudaGetLastError());
  mlstm_bwd_gategrad_kernel<<<B * H, 32, 0, st>>>(gates, tok, gi, gf, S, H,
                                                  chunk, nc);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch mlstm_bwd needs for these shapes.
extern "C" long long mlstm_bwd_workspace(int B, int S, int H, int dk, int dv,
                                         int chunk) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || chunk < 1 ||
      chunk > LC)
    return -1;
  return Work(B, S, H, dk, dv, chunk).total;
}

// The chunkwise mLSTM backward over B * H heads. q, k: (B, S, H, dk), v:
// (B, S, H, dv), all float32 (dtype 0) or all bfloat16 (dtype 1), unit
// stride on the last axis, the given (batch, seq, head) strides; ig, fg:
// (B, S, H) float32, contiguous; C0 (B, H, dk, dv), n0 (B, H, dk), m0 (B,
// H): the initial state, float32, contiguous (all null: the zero state);
// dh: (B, S, H, dv) float32, contiguous. Writes gq, gk (B, S, H, dk), gv
// (B, S, H, dv) in q's dtype and gi, gf (B, S, H) float32, contiguous.
// work: mlstm_bwd_workspace(...) floats. 1 <= chunk <= 64. Returns the
// launches' cudaGetLastError().
extern "C" int mlstm_bwd(const void* q, const void* k, const void* v,
                         int dtype, const float* ig, const float* fg,
                         const float* C0, const float* n0, const float* m0,
                         const float* dh, void* gq, void* gk, void* gv,
                         float* gi, float* gf, float* work, int B, int S,
                         int H, int dk, int dv, int chunk, long long sqb,
                         long long sqs, long long sqh, long long skb,
                         long long sks, long long skh, long long svb,
                         long long svs, long long svh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || chunk < 1 ||
      chunk > LC)
    return cudaErrorInvalidValue;
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), ig, fg, C0, n0, m0, dh,
        static_cast<float*>(gq), static_cast<float*>(gk),
        static_cast<float*>(gv), gi, gf, work, B, S, H, dk, dv, chunk, sq, sk,
        sv, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), ig, fg, C0, n0, m0, dh,
        static_cast<__nv_bfloat16*>(gq), static_cast<__nv_bfloat16*>(gk),
        static_cast<__nv_bfloat16*>(gv), gi, gf, work, B, S, H, dk, dv, chunk,
        sq, sk, sv, st);
  return cudaErrorInvalidValue;
}
