// Causal / sliding-window flash-attention backward for Hopper (sm_90a).
//
// The JAX package has no attention backward kernel: it trains through
// autodiff of models/layers/attention.py:attend_dense, so this replaces no
// TPU kernel. It is the backward of the port's forward (flash_attn.cu,
// which replaces repro/kernels/flash_attn/kernel.py:_flash_kernel), so that
// training keeps attention on the hand-written path. With S = scale q k^T,
// P = softmax(S) under the causal / window mask, O = P v and the forward's
// per-row log-sum-exp L:
//   D_i   = sum_d dO_id O_id
//   P_ij  = exp(S_ij - L_i)
//   dS_ij = P_ij ((dO v^T)_ij - D_i)
//   dv_j  = sum_i P_ij dO_i,  dk_j = scale sum_i dS_ij q_i,
//   dq_i  = scale sum_j dS_ij k_j
// Three kernels, FA2-style: a pass for D (a warp a row, coalesced); one
// block per (batch, kv head, 64-key tile) that walks every reachable query
// tile of every query head sharing the kv head (GQA summed in place, no
// repeat) and keeps its dk, dv in registers; one block per (batch, head,
// query tile) that walks the reachable key tiles for dq. The third
// recomputes S and dP instead of adding dq with atomics, so every sum has
// one order and the gradients are the same from run to run. Both walk only
// the reachable tiles (the causal end, the window start), as the forward
// does, so windowed cost stays O(S*w); ragged S is masked, strides come
// from the caller.
//
// Two bodies:
//  * bf16 with hd a multiple of 16 (the trained model): every product on
//    the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate;
//    flash_common.cuh). The dk/dv block's four warps own 16 keys each and
//    compute S^T = K Q^T and dP^T = V dO^T, so the accumulators of P^T and
//    dS^T, rounded to bf16 as FA2 rounds them, are already the A operands
//    of dV += P^T dO and dK += dS^T Q; Q and dO are B operands through
//    ldmatrix (.trans for the second pair), L and D are read by column.
//    Q, dO, L and D of the next query tile load by cp.async while the
//    present one is computed. The dq block's warps own 16 query rows,
//    compute S = Q K^T and dP = dO V^T, and dQ += dS K with K through
//    ldmatrix.trans, K and V double-buffered by cp.async;
//  * float32, and bf16 with hd = 8: the CUDA cores in f32, operands staged
//    in shared memory (what the f32 card-vs-CPU checks run).
//
// Bound. At the training shape (16 sequences x 512 tokens, 16 heads, hd
// 64, bf16) the function does 10*hd flops per reachable (q, k) pair (S,
// dP, dV, dK, dQ) against one read of q, k, v, o, dO and the lse and one
// write of dq, dk, dv: chip_smoke.py's phase_flash_bwd counts 21.5 GFLOP
// (22 us at 989 TFLOP/s) against 135 MB (40 us), so the bytes bound it.
// This kernel does 7 products to those 5 (the dq pass recomputes S and
// dP) and mma.sync runs at a fraction of the dense rate, so the products
// set its time; the design keeps the tensor cores fed: no exposed copy
// latency, conflict-free ldmatrix reads, accumulators reused as operands
// in registers, and no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::LOG2E;
using flash::store;
using flash::Strides;
using flash::to_f32;

constexpr int NT = 128;  // threads per block
constexpr int BQ = 32;   // query rows per tile of the CUDA-core body

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), (B, H, S) f32: a warp a row, the lanes on
// neighbouring elements.
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                         int S, int H, int rows, Strides so, Strides sd,
                         float* __restrict__ dvec) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int qi = r % S;
  const int bh = r / S;
  const int b = bh / H;
  const int h = bh % H;
  const T* op = o + b * so.b + static_cast<long long>(qi) * so.s + h * so.h;
  const T* gp = dout + b * sd.b + static_cast<long long>(qi) * sd.s + h * sd.h;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f32(op[d]), to_f32(gp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[r] = acc;
}

// ---------------------------------------------------------------------------
// CUDA-core body (float32; bf16 with hd = 8)
// ---------------------------------------------------------------------------

template <int HD>
struct Cfg {
  static constexpr int BKV = HD <= 64 ? 64 : 32;  // keys per tile
  static constexpr int LD = HD + 1;               // padded row, no conflicts
  static constexpr int LP = BKV + 1;
  // floats: k, v tiles; q, dO tiles; P, dS tiles; lse, D
  static constexpr int FLOATS = 2 * BKV * LD + 2 * BQ * LD + 2 * BQ * LP +
                                2 * BQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// rows [r0, r0 + n) of one head of x (B, S, heads, hd) into dst[n][LD],
// zero past S.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long ss, int r0, int n,
                                          int S) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < n * HD; idx += NT) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = r0 + r;
    dst[r * LD + d] =
        row < S ? to_f32(base[static_cast<long long>(row) * ss + d]) : 0.f;
  }
}

// P and dS of one (32-row query tile, key tile) pair, from q, dO, k, v
// tiles in shared memory: P = exp2(S * qscale - L2) with the mask, dS =
// P (dP - D). Thread t computes key j = t % BKV for rows t / BKV + G r.
template <int HD>
__device__ __forceinline__ void score_tile(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* l2, const float* dd, float* ps, float* dss, int q0, int k0,
    int S, int Skv, int causal, int window, float qscale) {
  using C = Cfg<HD>;
  constexpr int G = NT / C::BKV;
  const int j = threadIdx.x % C::BKV;
  const int kj = k0 + j;
  const float* kr = ks + j * C::LD;
  const float* vr = vs + j * C::LD;
  for (int i = threadIdx.x / C::BKV; i < BQ; i += G) {
    const int qi = q0 + i;
    bool ok = qi < S && kj < Skv;
    if (causal) ok = ok && kj <= qi;
    if (window > 0) ok = ok && qi - kj < window;
    float p = 0.f, ds = 0.f;
    if (ok) {
      const float* qr = qs + i * C::LD;
      const float* gr = dos + i * C::LD;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(gr[d], vr[d], dp);
      }
      p = exp2f(s * qscale - l2[i]);
      ds = p * (dp - dd[i]);
    }
    ps[i * C::LP + j] = p;
    dss[i * C::LP + j] = ds;
  }
}

// dk, dv for one (batch, kv head, key tile).
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
    int S, int Skv, int H, int KV, int group, int nkt, Strides sq,
    Strides sk, Strides sv, Strides sd, Strides sdk, Strides sdv,
    float qscale, float scale, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV;
  constexpr int LD = C::LD;
  constexpr int G = NT / BKV;            // d groups of the accumulators
  constexpr int NE = BKV * HD / NT;      // dk (and dv) entries per thread
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + BKV * LD;
  float* qs = vs + BKV * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * C::LP;
  float* l2 = dss + BQ * C::LP;
  float* dd = l2 + BQ;

  const int kt = blockIdx.x % nkt;
  const int bk = blockIdx.x / nkt;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int k0 = kt * BKV;
  load_rows<T, HD>(ks, k + b * sk.b + kvh * sk.h, sk.s, k0, BKV, Skv);
  load_rows<T, HD>(vs, v + b * sv.b + kvh * sv.h, sv.s, k0, BKV, Skv);

  const int j = threadIdx.x % BKV;
  const int dg = threadIdx.x / BKV;
  float adk[NE], adv[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) adk[e] = adv[e] = 0.f;

  // query rows that can see a key of this tile: [qlo, qhi)
  const int qlo = causal ? k0 : 0;
  int qhi = S;
  if (window > 0) qhi = min(qhi, k0 + BKV - 1 + window);
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long bhS = (static_cast<long long>(b) * H + h) * S;
    for (int q0 = (qlo / BQ) * BQ; q0 < qhi; q0 += BQ) {
      __syncthreads();  // the previous tile is no longer read
      load_rows<T, HD>(qs, q + b * sq.b + h * sq.h, sq.s, q0, BQ, S);
      load_rows<T, HD>(dos, dout + b * sd.b + h * sd.h, sd.s, q0, BQ, S);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const int qi = q0 + i;
        l2[i] = qi < S ? lse[bhS + qi] * LOG2E : 0.f;
        dd[i] = qi < S ? dvec[bhS + qi] : 0.f;
      }
      __syncthreads();
      score_tile<HD>(qs, dos, ks, vs, l2, dd, ps, dss, q0, k0, S, Skv,
                     causal, window, qscale);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float p = ps[i * C::LP + j];
        const float ds = dss[i * C::LP + j];
        const float* gr = dos + i * LD;
        const float* qr = qs + i * LD;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int d = dg + G * e;
          adv[e] = fmaf(p, gr[d], adv[e]);
          adk[e] = fmaf(ds, qr[d], adk[e]);
        }
      }
    }
  }
  const int kj = k0 + j;
  if (kj < Skv) {
    T* dkr = dk + b * sdk.b + static_cast<long long>(kj) * sdk.s + kvh * sdk.h;
    T* dvr = dv + b * sdv.b + static_cast<long long>(kj) * sdv.s + kvh * sdv.h;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = dg + G * e;
      store(dkr + d, adk[e] * scale);
      store(dvr + d, adv[e]);
    }
  }
}

// dq for one (batch, head, 32-row query tile).
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dq, int S, int Skv,
    int H, int group, int nqt, Strides sq, Strides sk, Strides sv,
    Strides sd, Strides sdq, float qscale, float scale, int causal,
    int window) {
  using C = Cfg<HD>;
  constexpr int BKV = C::BKV;
  constexpr int LD = C::LD;
  constexpr int NE = BQ * HD / NT;  // dq entries per thread
  constexpr int G = NT / BQ;        // d groups
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + BKV * LD;
  float* qs = vs + BKV * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * C::LP;
  float* l2 = dss + BQ * C::LP;
  float* dd = l2 + BQ;

  const int qt = blockIdx.x % nqt;
  const int bh = blockIdx.x / nqt;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const int q0 = qt * BQ;
  const long long bhS = static_cast<long long>(bh) * S;
  load_rows<T, HD>(qs, q + b * sq.b + h * sq.h, sq.s, q0, BQ, S);
  load_rows<T, HD>(dos, dout + b * sd.b + h * sd.h, sd.s, q0, BQ, S);
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const int qi = q0 + i;
    l2[i] = qi < S ? lse[bhS + qi] * LOG2E : 0.f;
    dd[i] = qi < S ? dvec[bhS + qi] : 0.f;
  }
  const int i = threadIdx.x % BQ;
  const int dg = threadIdx.x / BQ;
  float adq[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) adq[e] = 0.f;

  int hi = Skv;
  if (causal) hi = min(hi, q0 + BQ);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  for (int k0 = (lo / BKV) * BKV; k0 < hi; k0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
    load_rows<T, HD>(ks, kb, sk.s, k0, BKV, Skv);
    load_rows<T, HD>(vs, vb, sv.s, k0, BKV, Skv);
    __syncthreads();
    score_tile<HD>(qs, dos, ks, vs, l2, dd, ps, dss, q0, k0, S, Skv, causal,
                   window, qscale);
    __syncthreads();
    const float* dsr = dss + i * C::LP;
#pragma unroll 4
    for (int jj = 0; jj < BKV; ++jj) {
      const float ds = dsr[jj];
      const float* kr = ks + jj * LD;
#pragma unroll
      for (int e = 0; e < NE; ++e) adq[e] = fmaf(ds, kr[dg + G * e], adq[e]);
    }
  }
  const int qi = q0 + i;
  if (qi < S) {
    T* dqr = dq + b * sdq.b + static_cast<long long>(qi) * sdq.s + h * sdq.h;
#pragma unroll
    for (int e = 0; e < NE; ++e) store(dqr + dg + G * e, adq[e] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, float32 accumulation.
// ---------------------------------------------------------------------------

template <int HD>
struct MmaCfg {
  static constexpr int LD = flash::Tile<HD>::LD;
  static constexpr int BN = 64;                   // keys a dk/dv block
  static constexpr int BMQ = HD <= 64 ? 64 : 32;  // query rows a dk/dv step
  static constexpr int BQM = 64;                  // query rows a dq block
  static constexpr int BKD = 64;                  // keys a dq step
  // K, V; two stages of Q, dO; two stages of L, D
  static constexpr size_t DKV_BYTES =
      static_cast<size_t>(2 * BN + 4 * BMQ) * LD * sizeof(bf16) +
      4 * BMQ * sizeof(float);
  // Q, dO; two stages of K, V; L, D
  static constexpr size_t DQ_BYTES =
      static_cast<size_t>(2 * BQM + 4 * BKD) * LD * sizeof(bf16) +
      2 * BQM * sizeof(float);
};

// dk, dv for one (batch, kv head, 64-key tile); warp w owns keys
// k0 + 16 w .. k0 + 16 w + 15.
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Skv, int H,
    int KV, int group, int nkt, Strides sq, Strides sk, Strides sv,
    Strides sd, Strides sdk, Strides sdv, float qscale, float scale,
    int causal, int window) {
  using C = MmaCfg<HD>;
  constexpr int LD = C::LD, BN = C::BN, BMQ = C::BMQ;
  constexpr int KS = HD / 16;  // k-steps over the head dim
  constexpr int NQ = BMQ / 8;  // n-tiles of S^T, dP^T (queries)
  constexpr int NO = HD / 8;   // n-tiles of dK, dV (head dim)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BN * LD;
  bf16* qs = vs + BN * LD;        // [2][BMQ][LD]
  bf16* dos = qs + 2 * BMQ * LD;  // [2][BMQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BMQ * LD);  // [2][BMQ]
  float* ds = ls + 2 * BMQ;                                  // [2][BMQ]

  const int kt = blockIdx.x % nkt;
  const int bk = blockIdx.x / nkt;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int k0 = kt * BN;
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 4;
  const int kw = k0 + warp * 16;  // the warp's first key

  flash::TileStream<BN, HD, NT>(k + b * sk.b + kvh * sk.h, sk.s, k0)
      .load(ks, Skv);
  flash::TileStream<BN, HD, NT>(v + b * sv.b + kvh * sv.h, sv.s, k0)
      .load(vs, Skv);
  flash::cp_async_commit();

  // query rows that can see a key of this tile: [qlo, qhi)
  const int qlo = causal ? k0 : 0;
  int qhi = S;
  if (window > 0) qhi = min(qhi, k0 + BN - 1 + window);
  const int qt0 = qlo / BMQ;
  const int nqt = qlo < qhi ? (qhi - qt0 * BMQ + BMQ - 1) / BMQ : 0;
  const int items = group * nqt;  // (query head, query tile) pairs

  // Q, dO, L and D of item `it` into stage it % 2.
  auto issue = [&](int it) {
    const int st = it & 1;
    const int h = kvh * group + it / nqt;
    const int q0 = (qt0 + it % nqt) * BMQ;
    const long long bhS = (static_cast<long long>(b) * H + h) * S;
    flash::TileStream<BMQ, HD, NT>(q + b * sq.b + h * sq.h, sq.s, q0)
        .load(qs + st * BMQ * LD, S);
    flash::TileStream<BMQ, HD, NT>(dout + b * sd.b + h * sd.h, sd.s, q0)
        .load(dos + st * BMQ * LD, S);
    flash::load_vec<BMQ, NT>(ls + st * BMQ, lse + bhS, q0, S);
    flash::load_vec<BMQ, NT>(ds + st * BMQ, dvec + bhS, q0, S);
  };
  if (items > 0) issue(0);
  flash::cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) {  // the next item loads while this one is used
      issue(it + 1);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const int q0 = (qt0 + it % nqt) * BMQ;
    const bf16* qst = qs + st * BMQ * LD;
    const bf16* dost = dos + st * BMQ * LD;
    // Tiles where no key of this warp is seen.
    const bool skip = kw >= Skv || (causal && q0 + BMQ - 1 < kw) ||
                      (window > 0 && q0 - (kw + 15) >= window);
    if (!skip) {
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries.
      float sT[NQ][4], dpT[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        flash::load_a<LD>(ka, ks, warp * 16, kk * 16);
        flash::load_a<LD>(va, vs, warp * 16, kk * 16);
#pragma unroll
        for (int jp = 0; jp < NQ / 2; ++jp) {
          uint32_t bq[4], bo[4];
          flash::load_b_nk<LD>(bq, qst, jp * 16, kk * 16);
          flash::load_b_nk<LD>(bo, dost, jp * 16, kk * 16);
          flash::mma16816(sT[2 * jp], ka, bq[0], bq[1]);
          flash::mma16816(sT[2 * jp + 1], ka, bq[2], bq[3]);
          flash::mma16816(dpT[2 * jp], va, bo[0], bo[1]);
          flash::mma16816(dpT[2 * jp + 1], va, bo[2], bo[3]);
        }
      }
      // P^T and dS^T; L and D by column (query q0 + 8 j + 2 t + {0, 1}).
      const float* lst = ls + st * BMQ;
      const float* dst = ds + st * BMQ;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 L = *reinterpret_cast<const float2*>(lst + j * 8 + 2 * t);
        const float2 D = *reinterpret_cast<const float2*>(dst + j * 8 + 2 * t);
        const float lc[2] = {L.x * LOG2E, L.y * LOG2E};
        const float dc[2] = {D.x, D.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sT[j][e] = flash::exp2_ftz(fmaf(sT[j][e], qscale, -lc[e & 1]));
          dpT[j][e] = sT[j][e] * (dpT[j][e] - dc[e & 1]);
        }
      }
      if (!flash::tile_visible(q0, BMQ, kw, 16, S, Skv, causal, window)) {
        flash::mask_acc<true>(sT, kw, q0, S, Skv, causal, window, 0.f);
        flash::mask_acc<true>(dpT, kw, q0, S, Skv, causal, window, 0.f);
      }
      // dV += P^T dO and dK += dS^T Q, k-steps over this tile's queries.
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t pa[4], da[4];
        flash::acc_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
        flash::acc_to_a(da, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          uint32_t bo[4], bq[4];
          flash::load_b_kn<LD>(bo, dost, kk * 16, jp * 16);
          flash::load_b_kn<LD>(bq, qst, kk * 16, jp * 16);
          flash::mma16816(dva[2 * jp], pa, bo[0], bo[1]);
          flash::mma16816(dva[2 * jp + 1], pa, bo[2], bo[3]);
          flash::mma16816(dka[2 * jp], da, bq[0], bq[1]);
          flash::mma16816(dka[2 * jp + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }
  flash::cp_async_wait<0>();  // K and V landed even when no item ran
  // The warp's own rows of the K and V tiles stage dk and dv.
  flash::acc_to_tile<HD>(ks, warp * 16, dka, scale, scale);
  flash::acc_to_tile<HD>(vs, warp * 16, dva, 1.f, 1.f);
  __syncwarp();
  flash::store_strip<HD>(dk + b * sdk.b + kvh * sdk.h, sdk.s, ks, warp * 16,
                         kw, Skv);
  flash::store_strip<HD>(dv + b * sdv.b + kvh * sdv.h, sdv.s, vs, warp * 16,
                         kw, Skv);
}

// dq for one (batch, head, 64-row query tile); warp w owns rows
// q0 + 16 w .. q0 + 16 w + 15.
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dq, int S, int Skv, int H, int group, int nqt,
    Strides sq, Strides sk, Strides sv, Strides sd, Strides sdq,
    float qscale, float scale, int causal, int window) {
  using C = MmaCfg<HD>;
  constexpr int LD = C::LD, BQM = C::BQM, BKD = C::BKD;
  constexpr int KS = HD / 16;  // k-steps over the head dim
  constexpr int NK = BKD / 8;  // n-tiles of S, dP (keys)
  constexpr int NO = HD / 8;   // n-tiles of dQ (head dim)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BQM * LD;
  bf16* ks = dos + BQM * LD;     // [2][BKD][LD]
  bf16* vs = ks + 2 * BKD * LD;  // [2][BKD][LD]
  float* ls = reinterpret_cast<float*>(vs + 2 * BKD * LD);  // [BQM]
  float* ds = ls + BQM;                                     // [BQM]

  const int qt = blockIdx.x % nqt;
  const int bh = blockIdx.x / nqt;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const int q0 = qt * BQM;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int wq = q0 + warp * 16;  // the warp's first row
  const long long bhS = static_cast<long long>(bh) * S;

  flash::TileStream<BQM, HD, NT>(q + b * sq.b + h * sq.h, sq.s, q0)
      .load(qs, S);
  flash::TileStream<BQM, HD, NT>(dout + b * sd.b + h * sd.h, sd.s, q0)
      .load(dos, S);
  flash::load_vec<BQM, NT>(ls, lse + bhS, q0, S);
  flash::load_vec<BQM, NT>(ds, dvec + bhS, q0, S);
  flash::cp_async_commit();

  int hi = Skv;
  if (causal) hi = min(hi, q0 + BQM);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));
  const int kt0 = lo / BKD;
  const int nkt = hi > kt0 * BKD ? (hi - kt0 * BKD + BKD - 1) / BKD : 0;
  flash::TileStream<BKD, HD, NT> kstream(k + b * sk.b + kvh * sk.h, sk.s,
                                         kt0 * BKD);
  flash::TileStream<BKD, HD, NT> vstream(v + b * sv.b + kvh * sv.h, sv.s,
                                         kt0 * BKD);
  if (nkt > 0) {
    kstream.load(ks, Skv);
    vstream.load(vs, Skv);
  }
  flash::cp_async_commit();

  float dqa[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    const int k0 = (kt0 + it) * BKD;
    if (it + 1 < nkt) {  // the next tile loads while this one is used
      const int st = (it + 1) & 1;
      kstream.load(ks + st * BKD * LD, Skv);
      vstream.load(vs + st * BKD * LD, Skv);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + (it & 1) * BKD * LD;
    const bf16* vst = vs + (it & 1) * BKD * LD;
    // Tiles no row of this warp can see.
    const bool skip = (causal && k0 > wq + 15) ||
                      (window > 0 && k0 + BKD - 1 < wq - (window - 1));
    if (!skip) {
      // S = Q K^T and dP = dO V^T: rows are queries, columns keys.
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], oa[4];
        flash::load_a<LD>(qa, qs, warp * 16, kk * 16);
        flash::load_a<LD>(oa, dos, warp * 16, kk * 16);
#pragma unroll
        for (int jp = 0; jp < NK / 2; ++jp) {
          uint32_t bk[4], bv[4];
          flash::load_b_nk<LD>(bk, kst, jp * 16, kk * 16);
          flash::load_b_nk<LD>(bv, vst, jp * 16, kk * 16);
          flash::mma16816(s[2 * jp], qa, bk[0], bk[1]);
          flash::mma16816(s[2 * jp + 1], qa, bk[2], bk[3]);
          flash::mma16816(dp[2 * jp], oa, bv[0], bv[1]);
          flash::mma16816(dp[2 * jp + 1], oa, bv[2], bv[3]);
        }
      }
      // dS = P (dP - D), L and D by row (g and g + 8).
      const int r = warp * 16 + g;
      const float lr[2] = {ls[r] * LOG2E, ls[r + 8] * LOG2E};
      const float dr[2] = {ds[r], ds[r + 8]};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = flash::exp2_ftz(fmaf(s[j][e], qscale, -lr[e / 2])) *
                     (dp[j][e] - dr[e / 2]);
      if (!flash::tile_visible(wq, 16, k0, BKD, S, Skv, causal, window))
        flash::mask_acc<false>(dp, wq, k0, S, Skv, causal, window, 0.f);
      // dQ += dS K, k-steps over this tile's keys.
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t da[4];
        flash::acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          uint32_t bk[4];
          flash::load_b_kn<LD>(bk, kst, kk * 16, jp * 16);
          flash::mma16816(dqa[2 * jp], da, bk[0], bk[1]);
          flash::mma16816(dqa[2 * jp + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }
  flash::cp_async_wait<0>();  // Q and dO landed even when no tile ran
  // The warp's own rows of the Q tile stage dq.
  flash::acc_to_tile<HD>(qs, warp * 16, dqa, scale, scale);
  __syncwarp();
  flash::store_strip<HD>(dq + b * sdq.b + h * sdq.h, sdq.s, qs, warp * 16,
                         wq, S);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* dvec;
  void *dq, *dk, *dv;
  int B, S, Skv, H, KV;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
  float scale;
  int causal, window;
};

template <int HD>
cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  using C = MmaCfg<HD>;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const float qscale = a.scale * LOG2E;

  auto* dkv = flash_bwd_dkv_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::DKV_BYTES));
  if (err != cudaSuccess) return err;
  const int nkt = (a.Skv + C::BN - 1) / C::BN;
  dkv<<<nkt * a.B * a.KV, NT, C::DKV_BYTES, st>>>(
      q, k, v, dout, a.lse, a.dvec, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.Skv, a.H, a.KV, a.H / a.KV, nkt, a.sq,
      a.sk, a.sv, a.sd, a.sdk, a.sdv, qscale, a.scale, a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* dqk = flash_bwd_dq_mma_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::DQ_BYTES));
  if (err != cudaSuccess) return err;
  const int nqt = (a.S + C::BQM - 1) / C::BQM;
  dqk<<<nqt * a.B * a.H, NT, C::DQ_BYTES, st>>>(
      q, k, v, dout, a.lse, a.dvec, static_cast<bf16*>(a.dq), a.S, a.Skv,
      a.H, a.H / a.KV, nqt, a.sq, a.sk, a.sv, a.sd, a.sdq, qscale, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_core(const Args& a, cudaStream_t st) {
  using C = Cfg<HD>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float qscale = a.scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::BYTES));
  if (err != cudaSuccess) return err;
  const int nkt = (a.Skv + C::BKV - 1) / C::BKV;
  flash_bwd_dkv_kernel<T, HD><<<nkt * a.B * a.KV, NT, C::BYTES, st>>>(
      q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.S, a.Skv, a.H, a.KV, a.H / a.KV, nkt, a.sq,
      a.sk, a.sv, a.sd, a.sdk, a.sdv, qscale, a.scale, a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::BYTES));
  if (err != cudaSuccess) return err;
  const int nqt = (a.S + BQ - 1) / BQ;
  flash_bwd_dq_kernel<T, HD><<<nqt * a.B * a.H, NT, C::BYTES, st>>>(
      q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dq), a.S, a.Skv, a.H,
      a.H / a.KV, nqt, a.sq, a.sk, a.sv, a.sd, a.sdq, qscale, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int rows = a.B * a.H * a.S;
  flash_bwd_pre_kernel<T, HD><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.S, a.H,
      rows, a.so, a.sd, a.dvec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, bf16> && HD % 16 == 0)
    return launch_mma<HD>(a, st);
  else
    return launch_core<T, HD>(a, st);
}

template <typename T>
cudaError_t launch_hd(int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 8:
      return launch<T, 8>(a, st);
    case 16:
      return launch<T, 16>(a, st);
    case 32:
      return launch<T, 32>(a, st);
    case 64:
      return launch<T, 64>(a, st);
    case 128:
      return launch<T, 128>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, Skv, KV, hd); the last
// axis contiguous, the other strides in elements (in the order b, s, h for
// each of the eight tensors); for bf16 every start 16-byte aligned and
// every stride a multiple of 8. lse: (B, H, S) f32 from flash_attn_fwd;
// dvec: (B, H, S) f32 scratch. dtype: 0 = float32, 1 = bfloat16. window
// <= 0 means no window. Returns the first launch error, or 0.
extern "C" int flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dvec, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int Skv, int H, int KV, int hd,
    const long long* strides, float scale, int causal, int window,
    void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dvec = dvec;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.S = S;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  Strides* all[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sd, &a.sdq, &a.sdk,
                     &a.sdv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(hd, a, st);
  if (dtype == 1) return launch_hd<bf16>(hd, a, st);
  return cudaErrorInvalidValue;
}
