// Fused dual-prior logit-adjusted cross-entropy (LACE) for Hopper (sm_90a):
// the split boundary of a SCALA step, eq. 14 (prior P_s) and eq. 15 (per-
// client priors P_k) from one feats @ w_head product. The math, the design
// and the device code live in lace_common.cuh (its kernels with NS = 2
// sides); this file holds the entry points.
//
// K1, lace2_fwd, replaces repro/kernels/lace/kernel.py:_fwd2_kernel (the
// Pallas body behind lace2_fwd_pallas): per token, both sides' nll and lse.
//
// K2, lace2_bwd, replaces _bwd2_dfeats_kernel + _bwd_dw_kernel (behind
// lace2_bwd_pallas): df_s = g_s @ W^T, df_k = g_k @ W^T, dW_s = feats^T @
// g_s, both sides' g tiles from one recomputed z tile.
//
// Bound. At the training shapes (N = 8192 tokens, d = 1024, V = 151936)
// one product pass 2*N*d*V is 2.55 TFLOP, 5.15 ms at TF32's 495 TFLOP/s.
// K1 is one pass (z), K2 four (z, df_s, df_k, dW_s): bounds of 5.15 and
// 20.6 ms. Split TF32 on the tensor cores (lace_common.cuh) runs 2
// products for a bf16 x f32 pass and 3 for f32 x f32, so the route itself
// costs K1 2 products (10.3 ms) and K2 10 (51.5 ms), against 38 and 152 ms
// for its passes at the f32 CUDA-core rate of 67 TFLOP/s. The workspace
// traffic of K2 (the g tiles, written once and read twice) is ~30 GB at
// N = 8192, ~9 ms of HBM.

#include "lace_common.cuh"

// feats (N, d) with row stride ldf (elements), last axis contiguous; w
// (d, V) contiguous; labels, ids_* (N,) int32; adj_* (rows, V) f32 or null
// (side absent; ids_* null: row 0 for every token). dtype codes:
// 0 = float32, 1 = bfloat16. splits: cdiv(V, 128), the vocab tiles; part:
// 5 * splits * N floats of scratch.
// nll_*, lse_* (N,) f32. Returns the first launch error, or 0.
extern "C" int lace2_fwd(const void* feats, long long ldf, int feats_dtype,
                         const void* w, int w_dtype, const int* labels,
                         const float* adj_s, const int* ids_s,
                         const float* adj_k, const int* ids_k, int N, int d,
                         int V, int splits, float* part, float* nll_s,
                         float* nll_k, float* lse_s, float* lse_k,
                         void* stream) {
  if (N <= 0 || d <= 0 || V <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LACE2_FWD(TF, TW)                                                   \
  fwd<TF, TW, 2>(feats, ldf, w, labels, adj_s, ids_s, adj_k, ids_k, N, d,  \
                 V, splits, part, nll_s, nll_k, lse_s, lse_k, st)
  LACE_DISPATCH(feats_dtype, w_dtype, LACE2_FWD);
#undef LACE2_FWD
}

// As lace2_fwd, plus lse_* from it and ts_* (N,) the per-token
// weight * scale of each side. vc: vocab columns per chunk; g_s, g_k:
// (N, vc) f32 scratch each. Writes df_s, df_k (N, d) and dw (d, V) f32.
extern "C" int lace2_bwd(const void* feats, long long ldf, int feats_dtype,
                         const void* w, int w_dtype, const int* labels,
                         const float* adj_s, const int* ids_s,
                         const float* adj_k, const int* ids_k,
                         const float* lse_s, const float* lse_k,
                         const float* ts_s, const float* ts_k, int N, int d,
                         int V, int vc, float* g_s, float* g_k, float* df_s,
                         float* df_k, float* dw, void* stream) {
  if (N <= 0 || d <= 0 || V <= 0 || vc <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LACE2_BWD(TF, TW)                                                   \
  bwd<TF, TW, 2>(feats, ldf, w, labels, adj_s, ids_s, adj_k, ids_k, lse_s, \
                 lse_k, ts_s, ts_k, N, d, V, vc, g_s, g_k, df_s, df_k, dw, \
                 st)
  LACE_DISPATCH(feats_dtype, w_dtype, LACE2_BWD);
#undef LACE2_BWD
}
