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
// Bound. At the training shapes (N = 8192, d = 1024, V = 151936) one z
// pass is 2*N*d*V = 2.55 TFLOP, 38 ms at the f32 rate of 67 TFLOP/s: K4
// does one pass, K5 three with dW (z, df, dW: 114 ms) and two without
// (76 ms). The g tile of a vocab chunk goes through device memory (written
// once, read once or twice): ~10 GB at N = 8192, ~3 ms of HBM.

#include "lace_common.cuh"

// feats (N, d) with row stride ldf (elements), last axis contiguous; w
// (d, V) contiguous; labels, ids (N,) int32; adj (rows, V) f32 or null
// (plain CE; ids null: row 0 for every token). dtype codes: 0 = float32,
// 1 = bfloat16. part: 3 * splits * N floats of scratch. nll, lse (N,) f32.
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
