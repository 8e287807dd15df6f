// The gate pass of the chunkwise mLSTM (K6), shared by the forward
// (mlstm.cu) and the backward (mlstm_bwd.cu), which reruns it.
//
// One warp per head walks the chunks in order with warp scans: the only
// sequential dependency among the gates is the scalar m carried across
// chunks. For every token it writes b_t (the chunk's cumsum of f), i_t
// (-inf past the chunk), m_t, w0_t = e^{m0+b_t-m_t} and wk_t =
// e^{F-b_t+i_t-m'}; for every chunk wC0 = e^{m0+F-m'}; and the final m.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int GLC = 64;    // rows of a chunk tile: two a lane
constexpr int GROWS = 5;   // gate rows a chunk: b, i, m, w0, wk
static_assert(GLC == 2 * 32, "the gate scan takes two rows a lane");

// Grid B * H, one warp. gates[(bh * nc + c) * GROWS * GLC + q * GLC + r],
// q = 0 .. 4: b, i, m, w0, wk; wc0[bh * nc + c]; m1[bh]. m0 null: the
// zero state.
__global__ void __launch_bounds__(32) mlstm_gate_kernel(
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ m0, float* __restrict__ gates,
    float* __restrict__ wc0, float* __restrict__ m1, int S, int H, int chunk,
    int nc) {
  const unsigned full = 0xffffffffu;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x;
  const int r0 = 2 * lane, r1 = r0 + 1;
  // the lane's f and i of chunk c (f = 0, i = -inf past the chunk)
  auto load = [&](int c, float (&x)[4]) {
    const int t0 = c * chunk;
    const int Lc = min(chunk, S - t0);
    const long long base = (static_cast<long long>(b) * S + t0) * H + h;
    x[0] = r0 < Lc ? fg[base + static_cast<long long>(r0) * H] : 0.f;
    x[1] = r1 < Lc ? fg[base + static_cast<long long>(r1) * H] : 0.f;
    x[2] = r0 < Lc ? ig[base + static_cast<long long>(r0) * H] : -CUDART_INF_F;
    x[3] = r1 < Lc ? ig[base + static_cast<long long>(r1) * H] : -CUDART_INF_F;
  };
  float m = m0 ? m0[bh] : 0.f;  // null: the zero state
  float nxt[4];
  load(0, nxt);
  for (int c = 0; c < nc; ++c) {
    const float f0 = nxt[0], f1 = nxt[1], i0 = nxt[2], i1 = nxt[3];
    if (c + 1 < nc) load(c + 1, nxt);  // in flight during this chunk
    // b: inclusive sums of f, the lane's pair, then a scan across lanes
    float inc = f0 + f1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(full, inc, off);
      if (lane >= off) inc += y;
    }
    float exc = __shfl_up_sync(full, inc, 1);
    if (lane == 0) exc = 0.f;
    const float b0 = exc + f0, b1 = b0 + f1;
    // cummax of a = i - b
    const float a0 = i0 - b0, a1 = i1 - b1;
    float mx = fmaxf(a0, a1);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(full, mx, off);
      if (lane >= off) mx = fmaxf(mx, y);
    }
    float mex = __shfl_up_sync(full, mx, 1);
    if (lane == 0) mex = -CUDART_INF_F;
    const float c0 = fmaxf(mex, a0), c1 = fmaxf(c0, a1);
    const float mt0 = fmaxf(m + b0, b0 + c0), mt1 = fmaxf(m + b1, b1 + c1);
    const float F = __shfl_sync(full, b1, 31), A = __shfl_sync(full, c1, 31);
    const float mn = fmaxf(m + F, F + A);
    float* g = gates + (static_cast<long long>(bh) * nc + c) * GROWS * GLC;
    g[r0] = b0, g[r1] = b1;
    g[GLC + r0] = i0, g[GLC + r1] = i1;
    g[2 * GLC + r0] = mt0, g[2 * GLC + r1] = mt1;
    g[3 * GLC + r0] = expf(m + b0 - mt0), g[3 * GLC + r1] = expf(m + b1 - mt1);
    g[4 * GLC + r0] = expf(F - b0 + i0 - mn);
    g[4 * GLC + r1] = expf(F - b1 + i1 - mn);
    if (lane == 0) wc0[static_cast<long long>(bh) * nc + c] = expf(m + F - mn);
    m = mn;
  }
  if (lane == 0) m1[bh] = m;
}

}  // namespace
