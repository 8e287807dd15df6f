// Causal / sliding-window flash-attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attn/kernel.py:_flash_kernel, the Pallas TPU
// kernel behind flash_attention_pallas. It computes the same function:
// softmax(q k^T * scale) v over the keys with ki <= qi (causal) and
// qi - ki < window, through the online (running max, running sum,
// accumulator) recurrence kept in float32, and writes the output in the
// input's dtype.
//
// Design. A loop inside each block replaces the Pallas grid's sequential
// kv axis: it walks only the reachable kv range (up to the tile's last row
// when causal, from its first row minus the window when windowed -- the
// block skipping of the Pallas kernel, so windowed cost stays O(S*w)) in
// tiles staged in shared memory. The ragged edges (ki < Skv, qi < S) are
// masked here, so the wrapper never pads. GQA reads kv head h / (H / KV)
// in place instead of repeating it, and all strides come from the caller,
// so the (B, S, H, hd) layout is read and written without a transpose
// copy. The heaviest causal tiles (the last query rows) launch first.
// Two bodies compute the function:
//  * bf16 with hd a multiple of 16 (the served model): four warps per
//    64-row query tile run Q K^T and P V on the tensor cores with
//    mma.sync.m16n8k16 (FA2-style: P stays in registers between the two);
//  * float32, and bf16 with hd = 8: one thread per query row, both
//    products on the CUDA cores in float32.
//
// Bound. At the prefill shapes (B=1, H=16, hd=64, S=128..2048) the work is
// 4*hd flops per reachable (q, k) pair against one read of q, k, v and one
// write of o: about 8.6 GFLOP against 16.8 MB at S=2048 in bf16, so the
// tensor-core rate bounds it, not the bytes. mma.sync reaches only part of
// that rate; wgmma with TMA-fed, double-buffered tiles is the way to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int CH = 16;   // keys per online-softmax rescale

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

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(BQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int Skv, int H, int group, int BH, int nq, Strides sq,
                     Strides sk, Strides sv, Strides so, float qscale,
                     int causal, int window) {
  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];

  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const int q0 = qt * BQ;
  const int qi = q0 + static_cast<int>(threadIdx.x);
  const bool active = qi < S;

  const T* kbase = k + b * sk.b + kvh * sk.h;
  const T* vbase = v + b * sv.b + kvh * sv.h;

  // q is pre-scaled by scale * log2(e): the softmax then runs on exp2.
  float qr[HD];
  float acc[HD];
  if (active) {
    const T* qp = q + b * sq.b + static_cast<long long>(qi) * sq.s + h * sq.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f32(qp[d]) * qscale;
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  // Reachable kv range of the whole tile (block-uniform).
  int hi = Skv;
  if (causal) hi = min(hi, q0 + BQ);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * HD; idx += BQ) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int kj = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (kj < Skv) {
        kk = to_f32(kbase[static_cast<long long>(kj) * sk.s + d]);
        vv = to_f32(vbase[static_cast<long long>(kj) * sv.s + d]);
      }
      ks[r][d] = kk;
      vs[r][d] = vv;
    }
    __syncthreads();
    if (!active) continue;

    // This row's keys in the tile: [jlo, jhi).
    int jhi = min(BK, Skv - k0);
    if (causal) jhi = min(jhi, qi - k0 + 1);
    int jlo = 0;
    if (window > 0) jlo = max(0, qi - (window - 1) - k0);

    for (int j0 = jlo; j0 < jhi; j0 += CH) {
      float s[CH];
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float dot = -CUDART_INF_F;
        if (j0 + c < jhi) {
          const float* kr = ks[j0 + c];
          dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        }
        s[c] = dot;
        mc = fmaxf(mc, dot);
      }
      // j0 < jhi, so mc is finite; on the first update m is -inf and
      // alpha is exactly 0.
      const float m_new = fmaxf(m, mc);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (j0 + c < jhi) {
          const float p = exp2f(s[c] - m_new);
          const float* vr = vs[j0 + c];
          l += p;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = o + b * so.b + static_cast<long long>(qi) * so.s + h * so.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) store(op + d, acc[d] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, float32 accumulation.
// ---------------------------------------------------------------------------

constexpr int MQ = 64;        // query rows per block: 4 warps x 16 rows
constexpr int MK = 64;        // keys per shared-memory tile
constexpr int MTHREADS = 128;

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One block per (64-row query tile, batch*head), four warps of 16 rows.
// Per 64-key tile: S = Q K^T on mma.sync from Q fragments held in
// registers and K rows in shared memory; scale, mask and the online
// softmax on the S fragments (each row's max and sum shared by the four
// lanes that hold it); P rounded to bf16 is reused in registers as the A
// operand of P V, with V staged transposed in shared memory. Shared rows
// are padded by 8 elements so the fragment reads hit 32 distinct banks.
template <int HD>
__global__ void __launch_bounds__(MTHREADS)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int S, int Skv, int H,
                         int group, int BH, int nq, Strides sq, Strides sk,
                         Strides sv, Strides so, float qscale, int causal,
                         int window) {
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NS = MK / 8;   // n-tiles of S (keys)
  constexpr int NO = HD / 8;   // n-tiles of O (head dim)
  __shared__ __align__(16) __nv_bfloat16 ks[MK][HD + 8];
  __shared__ __align__(16) __nv_bfloat16 vt[HD][MK + 8];

  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const int q0 = qt * MQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and key / column group)
  const int t = lane % 4;  // fragment column pair
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  const __nv_bfloat16* kbase = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vbase = v + b * sv.b + kvh * sv.h;

  // Q fragments (A operand, 16 x HD per warp), zero past the last row.
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
    const bool ok0 = row0 < S, ok1 = row1 < S;
    const __nv_bfloat16* r0 = qb + static_cast<long long>(row0) * sq.s;
    const __nv_bfloat16* r1 = qb + static_cast<long long>(row1) * sq.s;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = ok0 ? ld32(r0 + c) : 0u;
      qa[kk][1] = ok1 ? ld32(r1 + c) : 0u;
      qa[kk][2] = ok0 ? ld32(r0 + c + 8) : 0u;
      qa[kk][3] = ok1 ? ld32(r1 + c + 8) : 0u;
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;  // this lane's share of the running sums

  int hi = Skv;
  if (causal) hi = min(hi, q0 + MQ);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));
  const int warp_last = q0 + warp * 16 + 15;  // this warp's last row
  const int warp_first = q0 + warp * 16;

  for (int k0 = (lo / MK) * MK; k0 < hi; k0 += MK) {
    __syncthreads();  // the previous tile is no longer read
    // Stage K rows and V transposed, 2 elements per load; zeros past Skv.
    for (int idx = threadIdx.x; idx < MK * HD / 2; idx += MTHREADS) {
      const int r = idx / (HD / 2);
      const int d = (idx % (HD / 2)) * 2;
      const int kj = k0 + r;
      uint32_t kk2 = 0u, vv2 = 0u;
      if (kj < Skv) {
        kk2 = ld32(kbase + static_cast<long long>(kj) * sk.s + d);
        vv2 = ld32(vbase + static_cast<long long>(kj) * sv.s + d);
      }
      *reinterpret_cast<uint32_t*>(&ks[r][d]) = kk2;
      const __nv_bfloat162 vp = *reinterpret_cast<__nv_bfloat162*>(&vv2);
      vt[d][r] = vp.x;
      vt[d + 1][r] = vp.y;
    }
    __syncthreads();
    // Tiles no row of this warp can see.
    if (causal && k0 > warp_last) continue;
    if (window > 0 && k0 + MK - 1 < warp_first - (window - 1)) continue;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kr = &ks[j * 8 + g][kk * 16 + 2 * t];
        mma16816(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale into log2 units and mask; row maxima over the tile.
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        bool ok = key < Skv;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && row - key < window;
        s[j][e] = ok ? s[j][e] * qscale : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // A row with no visible key yet keeps a zero reference, not -inf.
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float a0 = exp2f(m0 - mu0), a1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - mu0);
      s[j][1] = exp2f(s[j][1] - mu0);
      s[j][2] = exp2f(s[j][2] - mu1);
      s[j][3] = exp2f(s[j][3] - mu1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V: the S accumulator layout is the A operand layout.
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const __nv_bfloat16* vr = &vt[j * 8 + g][kk * 16 + 2 * t];
        mma16816(acc[j], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row0) * so.s +
                                   c) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row1) * so.s +
                                   c) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Skv, int H, int KV, Strides sq,
                       Strides sk, Strides sv, Strides so, float qscale,
                       int causal, int window, cudaStream_t stream) {
  const int BH = B * H;
  const int nq = (S + MQ - 1) / MQ;
  flash_fwd_mma_kernel<HD><<<nq * BH, MTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Skv, H, H / KV, BH, nq, sq, sk, sv, so, qscale, causal, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Skv, int H, int KV, Strides sq,
                      Strides sk, Strides sv, Strides so, float qscale,
                      int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && HD % 16 == 0) {
    return launch_mma<HD>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                          qscale, causal, window, stream);
  } else {
    constexpr int BK = HD <= 64 ? 64 : 32;  // 2 * BK * HD * 4 <= 32 KB
    const int BH = B * H;
    const int nq = (S + BQ - 1) / BQ;
    flash_fwd_kernel<T, HD, BK><<<nq * BH, BQ, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, H / KV, BH,
        nq, sq, sk, sv, so, qscale, causal, window);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(int hd, const void* q, const void* k, const void* v,
                   void* o, int B, int S, int Skv, int H, int KV, Strides sq,
                   Strides sk, Strides sv, Strides so, float qscale,
                   int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch_hd<T, 8>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                             qscale, causal, window, stream);
    case 16:
      return launch_hd<T, 16>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                              qscale, causal, window, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                              qscale, causal, window, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                              qscale, causal, window, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                               qscale, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, hd), k/v: (B, Skv, KV, hd), o: (B, S, H, hd); the last axis
// contiguous, the other strides in elements. dtype: 0 = float32,
// 1 = bfloat16. window <= 0 means no window. Returns the launch's
// cudaGetLastError().
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int Skv, int H, int KV, int hd, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, long long sob,
    long long sos, long long soh, float scale, int causal, int window,
    void* stream) {
  if (B <= 0 || S <= 0 || Skv < 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh},
      so{sob, sos, soh};
  const float qscale = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(hd, q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                         qscale, causal, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(hd, q, k, v, o, B, S, Skv, H, KV, sq, sk,
                                 sv, so, qscale, causal, window, st);
  return cudaErrorInvalidValue;
}
