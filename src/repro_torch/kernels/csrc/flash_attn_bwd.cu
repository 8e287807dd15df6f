// Causal / sliding-window flash-attention backward for Hopper (sm_90a).
//
// The JAX package has no attention backward kernel: it trains through
// autodiff of models/layers/attention.py:attend_dense. This is the backward
// of the port's forward (flash_attn.cu, which replaces
// repro/kernels/flash_attn/kernel.py:_flash_kernel), so that training keeps
// attention on the hand-written path. With S = scale * q k^T, P =
// softmax(S) under the causal / window mask, O = P v and the forward's
// per-row log-sum-exp L:
//   D_i   = sum_d dO_id O_id
//   P_ij  = exp(S_ij - L_i)
//   dS_ij = P_ij ((dO v^T)_ij - D_i)
//   dv_j  = sum_i P_ij dO_i,  dk_j = scale sum_i dS_ij q_i,
//   dq_i  = scale sum_j dS_ij k_j
// Three kernels, FA2-style: a pass for D; one block per (batch, kv head,
// 64-key tile) that walks every reachable 32-row query tile of every query
// head sharing the kv head (GQA summed in place, no repeat) and keeps its
// dk, dv in registers; one block per (batch, head, 32-row query tile) that
// walks the reachable key tiles for dq. The second recomputes S and dP
// instead of adding dq with atomics, so every sum has one order and the
// result is the same from run to run. Both walk only the reachable tiles
// (the causal end, the window start), as the forward does, so windowed cost
// stays O(S*w); ragged S is masked, strides come from the caller.
//
// Bound. At the training shapes (16 sequences x 512 tokens, 16 heads,
// hd 64, bf16) the work is ~10*hd flops per reachable (q, k) pair (the
// dkv pass's 4 products and the dq pass's 3, counting its recomputation)
// against one read of q, k, v, o, dO and one write of dq, dk, dv: the
// operations bound it. This first version runs every product on the CUDA
// cores in f32 (both dtypes; bf16 is read and written as bf16) with
// operands staged in shared memory; mma.sync / wgmma bodies are the way to
// the tensor-core rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int BQ = 32;   // query rows per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;
};

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

// D = rowsum(dO * O), (B, H, S) f32, one thread per row.
template <typename T, int HD>
__global__ void flash_bwd_pre_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout, int S,
                                     int H, int rows, Strides so, Strides sd,
                                     float* __restrict__ dvec) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int qi = r % S;
  const int bh = r / S;
  const int b = bh / H;
  const int h = bh % H;
  const T* op = o + b * so.b + static_cast<long long>(qi) * so.s + h * so.h;
  const T* gp = dout + b * sd.b + static_cast<long long>(qi) * sd.s + h * sd.h;
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc = fmaf(to_f32(op[d]), to_f32(gp[d]), acc);
  dvec[r] = acc;
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

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using C = Cfg<HD>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float qscale = a.scale * LOG2E;
  const int rows = a.B * a.H * a.S;
  flash_bwd_pre_kernel<T, HD><<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const T*>(a.o), dout, a.S, a.H, rows, a.so, a.sd, a.dvec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
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
// each of the eight tensors). lse: (B, H, S) f32 from flash_attn_fwd; dvec:
// (B, H, S) f32 scratch. dtype: 0 = float32, 1 = bfloat16. window <= 0
// means no window. Returns the first launch error, or 0.
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
  if (dtype == 1) return launch_hd<__nv_bfloat16>(hd, a, st);
  return cudaErrorInvalidValue;
}
