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
//  * bf16 with hd a multiple of 16 (the served and trained model): FA2's
//    shape on mma.sync.m16n8k16 (flash_common.cuh). Each warp owns 16
//    query rows; Q is staged once by cp.async and held in registers as A
//    fragments (ldmatrix); K and V tiles of 64 keys are double-buffered
//    by cp.async, so tile n + 1 loads while tile n is computed. S = Q K^T
//    reads K through ldmatrix; the scores are masked only in the tiles
//    that cross an edge and folded into the log2-domain online softmax
//    (the scale inside the exponent's FFMA); P, rounded to bf16, stays in
//    registers as the A operand of P V, whose B operand is V read
//    row-major through ldmatrix.trans. The output strip goes out through
//    shared memory in 16-byte stores. A block is 4 warps (64 rows): 8
//    warps (128 rows) were no faster at the shapes timed
//    (scripts/flash_fwd_ablation.py, PERF.md);
//  * float32, and bf16 with hd = 8: one thread per query row, both
//    products on the CUDA cores in float32.
//
// Bound. Per reachable (q, k) pair 4*hd flops against one read of q, k, v
// and one write of o. At the serving prefill (B=1, H=16, hd=64, P=777,
// bf16) that is 1.2 GFLOP against 6.4 MB, at the training trunk (16 x 512)
// 8.6 GFLOP against 67 MB: chip_smoke.py's attention_bound counts the
// 4*hd flops at 989 TFLOP/s and the bytes at 3.35 TB/s, and the larger,
// the bytes, bounds both (1.9 and 20 us). What the kernel reaches is set
// by the products and their operand traffic: mma.sync runs at a fraction
// of the dense rate, so the design keeps the tensor cores fed (no exposed
// copy latency, no scalar transposes, conflict-free ldmatrix reads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::natural_lse;
using flash::Strides;
using flash::store;
using flash::to_f32;

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int CH = 16;   // keys per online-softmax rescale

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(BQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int Skv, int H, int group, int BH, int nq, Strides sq,
                     Strides sk, Strides sv, Strides so, float qscale,
                     int causal, int window, float* __restrict__ lse) {
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
    if (lse) lse[static_cast<long long>(bh) * S + qi] = natural_lse(m, l);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, float32 accumulation.
// ---------------------------------------------------------------------------

// WARPS warps of 16 query rows each; key tiles of 64 keys.
template <int HD>
struct MmaCfg {
  static constexpr int WARPS = 4;
  static constexpr int BM = 16 * WARPS;  // query rows per block
  static constexpr int BN = 64;          // keys per tile
  static constexpr int NT = 32 * WARPS;
  static constexpr int LD = flash::Tile<HD>::LD;
  // the Q tile (reused to stage O), then two stages of K and of V
  static constexpr size_t BYTES =
      static_cast<size_t>(BM + 4 * BN) * LD * sizeof(bf16);
};

template <int HD>
__global__ void __launch_bounds__(MmaCfg<HD>::NT)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int S, int Skv, int H, int group, int BH, int nq,
                         Strides sq, Strides sk, Strides sv, Strides so,
                         float qscale, int causal, int window,
                         float* __restrict__ lse) {
  using C = MmaCfg<HD>;
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT, LD = C::LD;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NS = BN / 8;   // n-tiles of S (keys)
  constexpr int NO = HD / 8;   // n-tiles of O (head dim)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BM * LD;      // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;  // [2][BN][LD]

  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const int q0 = qt * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp * 16;  // the warp's first row in the tile
  const int wfirst = q0 + wr, wlast = wfirst + 15;

  // Reachable key tiles of the whole block.
  int hi = Skv;
  if (causal) hi = min(hi, q0 + BM);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - (window - 1));
  const int kt0 = lo / BN;
  const int nkt = hi > kt0 * BN ? (hi - kt0 * BN + BN - 1) / BN : 0;
  flash::TileStream<BN, HD, NT> kstream(k + b * sk.b + kvh * sk.h, sk.s,
                                        kt0 * BN);
  flash::TileStream<BN, HD, NT> vstream(v + b * sv.b + kvh * sv.h, sv.s,
                                        kt0 * BN);

  flash::TileStream<BM, HD, NT>(q + b * sq.b + h * sq.h, sq.s, q0)
      .load(qs, S);
  flash::cp_async_commit();
  if (nkt > 0) {
    kstream.load(ks, Skv);
    vstream.load(vs, Skv);
  }
  flash::cp_async_commit();
  flash::cp_async_wait<1>();
  __syncthreads();

  uint32_t qa[KS][4];  // the warp's Q rows as A fragments, held all along
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) flash::load_a<LD>(qa[kk], qs, wr, kk * 16);

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max (log2 units)
  float l[2] = {0.f, 0.f};  // this lane's share of the running sums

  for (int it = 0; it < nkt; ++it) {
    const int k0 = (kt0 + it) * BN;
    if (it + 1 < nkt) {  // the next tile loads while this one is used
      const int st = (it + 1) & 1;
      kstream.load(ks + st * BN * LD, Skv);
      vstream.load(vs + st * BN * LD, Skv);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + (it & 1) * BN * LD;
    const bf16* vst = vs + (it & 1) * BN * LD;
    // Tiles no row of this warp can see.
    const bool skip = (causal && k0 > wlast) ||
                      (window > 0 && k0 + BN - 1 < wfirst - (window - 1));
    if (!skip) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bk[4];
          flash::load_b_nk<LD>(bk, kst, jp * 16, kk * 16);
          flash::mma16816(s[2 * jp], qa[kk], bk[0], bk[1]);
          flash::mma16816(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
        }
      }
      if (!flash::tile_visible(wfirst, 16, k0, BN, S, Skv, causal, window))
        flash::mask_acc<false>(s, wfirst, k0, S, Skv, causal, window,
                               -CUDART_INF_F);
      flash::online_softmax(s, acc, m, l, qscale);
      // O += P V: P's accumulators are the A operand.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4];
        flash::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          uint32_t bv[4];
          flash::load_b_kn<LD>(bv, vst, kk * 16, jp * 16);
          flash::mma16816(acc[2 * jp], pa, bv[0], bv[1]);
          flash::mma16816(acc[2 * jp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

  // Normalise; the warp's own rows of the Q tile stage the output.
  const int g = lane / 4, t = lane % 4;
  const float l0 = flash::quad_sum(l[0]);
  const float l1 = flash::quad_sum(l[1]);
  if (lse && t == 0) {
    float* lb = lse + static_cast<long long>(bh) * S;
    if (wfirst + g < S) lb[wfirst + g] = natural_lse(m[0], l0);
    if (wfirst + g + 8 < S) lb[wfirst + g + 8] = natural_lse(m[1], l1);
  }
  flash::acc_to_tile<HD>(qs, wr, acc, l0 > 0.f ? 1.f / l0 : 0.f,
                         l1 > 0.f ? 1.f / l1 : 0.f);
  __syncwarp();
  flash::store_strip<HD>(o + b * so.b + h * so.h, so.s, qs, wr, wfirst, S);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Skv, int H, int KV, Strides sq,
                       Strides sk, Strides sv, Strides so, float qscale,
                       int causal, int window, float* lse,
                       cudaStream_t stream) {
  using C = MmaCfg<HD>;
  auto* kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::BYTES));
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  const int nq = (S + C::BM - 1) / C::BM;
  kern<<<nq * BH, C::NT, C::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Skv, H, H / KV,
      BH, nq, sq, sk, sv, so, qscale, causal, window, lse);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Skv, int H, int KV, Strides sq,
                      Strides sk, Strides sv, Strides so, float qscale,
                      int causal, int window, float* lse,
                      cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16> && HD % 16 == 0) {
    return launch_mma<HD>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                          qscale, causal, window, lse, stream);
  } else {
    constexpr int BK = HD <= 64 ? 64 : 32;  // 2 * BK * HD * 4 <= 32 KB
    const int BH = B * H;
    const int nq = (S + BQ - 1) / BQ;
    flash_fwd_kernel<T, HD, BK><<<nq * BH, BQ, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, H / KV, BH,
        nq, sq, sk, sv, so, qscale, causal, window, lse);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(int hd, const void* q, const void* k, const void* v,
                   void* o, int B, int S, int Skv, int H, int KV, Strides sq,
                   Strides sk, Strides sv, Strides so, float qscale,
                   int causal, int window, float* lse,
                   cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch_hd<T, 8>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                             qscale, causal, window, lse, stream);
    case 16:
      return launch_hd<T, 16>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                              qscale, causal, window, lse, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                              qscale, causal, window, lse, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                              qscale, causal, window, lse, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                               qscale, causal, window, lse, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, hd), k/v: (B, Skv, KV, hd), o: (B, S, H, hd); the last axis
// contiguous, the other strides in elements; for bf16 every start 16-byte
// aligned and every stride a multiple of 8. dtype: 0 = float32,
// 1 = bfloat16. window <= 0 means no window. lse: null, or (B, H, S) f32
// that receives each row's log-sum-exp of the scaled scores (what the
// backward recomputes the probabilities from). Returns the launch's
// cudaGetLastError().
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int Skv, int H, int KV, int hd, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, long long sob,
    long long sos, long long soh, float scale, int causal, int window,
    float* lse, void* stream) {
  if (B <= 0 || S <= 0 || Skv < 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh},
      so{sob, sos, soh};
  const float qscale = scale * flash::LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(hd, q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                         qscale, causal, window, lse, st);
  if (dtype == 1)
    return launch<bf16>(hd, q, k, v, o, B, S, Skv, H, KV, sq, sk, sv, so,
                        qscale, causal, window, lse, st);
  return cudaErrorInvalidValue;
}
