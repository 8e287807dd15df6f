// Single-prior logit-adjusted cross-entropy (LACE) for Hopper (sm_90a): one
// adjusted loss per call, as the two-pass ("dual") split boundary of a
// SCALA step evaluates eq. 14 (prior P_s) and eq. 15 (per-client priors
// P_k) one after the other. The math, the design and the device code live
// in lace_common.cuh (its kernels with NS = 1 side, shared with K1/K2).
//
// K4, lace_fwd, replaces repro/kernels/lace/kernel.py:_fwd_kernel (the
// Pallas body behind lace_fwd_pallas): per token, nll and lse, the vocab
// streamed through an online (max, sumexp) with the label logit picked by
// column index.
//
// K5, lace_bwd, replaces _bwd_dfeats_kernel + _bwd_dw_kernel (behind
// lace_bwd_pallas): with z recomputed from the saved lse,
//   g = (softmax(z + adj) - onehot) * token_scale,
//   dfeats = g @ W^T,  dW = feats^T @ g  (dW only when asked: the client
// side of the dual boundary reads no head gradient).
//
// Bound. At the training shapes (N = 8192, d = 1024, V = 151936) one
// product pass 2*N*d*V is 2.55 TFLOP, 5.15 ms at TF32's 495 TFLOP/s: K4
// is one pass (z, 5.15 ms), K5 three on the server side (z, df, dW; 15.5
// ms) and two on the client side (z, df; 10.3 ms). Split TF32
// (lace_common.cuh) runs 2 products for bf16 feats x f32 W or for dW, 3
// for f32 x f32 (df), so the route itself costs K4 2 products (10.3 ms)
// and K5 7 (36.1 ms) or 5 (25.8 ms), against 38, 114 and 76 ms for the
// passes at the f32 CUDA-core rate of 67 TFLOP/s. The g tile of a vocab
// chunk goes through device memory (written once, read once or twice):
// ~10 GB at N = 8192, ~3 ms of HBM.

#include "lace_common.cuh"

// feats (N, d) with row stride ldf (elements), last axis contiguous; w
// (d, V) contiguous; labels, ids (N,) int32; adj (rows, V) f32 or null
// (plain CE; ids null: row 0 for every token). dtype codes: 0 = float32,
// 1 = bfloat16. splits: cdiv(V, 128), the vocab tiles; part: 3 * splits *
// N floats of scratch. nll, lse (N,) f32.
// Returns the first launch error, or 0.
extern "C" int lace_fwd(const void* feats, long long ldf, int feats_dtype,
                        const void* w, int w_dtype, const int* labels,
                        const float* adj, const int* ids, int N, int d, int V,
                        int splits, float* part, float* nll, float* lse,
                        void* stream) {
  if (N <= 0 || d <= 0 || V <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LACE_FWD(TF, TW)                                                  \
  fwd<TF, TW, 1>(feats, ldf, w, labels, adj, ids, nullptr, nullptr, N, d, \
                 V, splits, part, nll, nullptr, lse, nullptr, st)
  LACE_DISPATCH(feats_dtype, w_dtype, LACE_FWD);
#undef LACE_FWD
}

// As lace_fwd, plus lse from it and ts (N,) the per-token weight * scale.
// vc: vocab columns per chunk; g: (N, vc) f32 scratch. Writes df (N, d)
// f32 and, unless dw is null, dw (d, V) f32.
extern "C" int lace_bwd(const void* feats, long long ldf, int feats_dtype,
                        const void* w, int w_dtype, const int* labels,
                        const float* adj, const int* ids, const float* lse,
                        const float* ts, int N, int d, int V, int vc,
                        float* g, float* df, float* dw, void* stream) {
  if (N <= 0 || d <= 0 || V <= 0 || vc <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LACE_BWD(TF, TW)                                                    \
  bwd<TF, TW, 1>(feats, ldf, w, labels, adj, ids, nullptr, nullptr, lse,   \
                 nullptr, ts, nullptr, N, d, V, vc, g, nullptr, df, nullptr, \
                 dw, st)
  LACE_DISPATCH(feats_dtype, w_dtype, LACE_BWD);
#undef LACE_BWD
}
