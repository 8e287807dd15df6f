// Chunkwise stabilized mLSTM forward (K6) for Hopper (sm_90a).
//
// Replaces repro/kernels/mlstm/kernel.py:_mlstm_kernel, the Pallas TPU
// kernel behind mlstm_chunk_pallas (one head per call, vmapped over batch
// and heads by mlstm/ops.py:mlstm_chunkwise). Per head, with log-sigmoid
// forget gates f and raw input gates i, over chunks of L tokens:
//
//   b_t = cumsum f, a_t = i_t - b_t, m_t = max(m0 + b_t, b_t + cummax a)
//   h_t = (w_t (q_t C0) + sum_{s<=t} (q_t.k_s) e^{b_t-b_s+i_s-m_t} v_s)
//         / max(|w_t (q_t.n0) + sum_{s<=t} ...|, e^{-m_t}),
//   w_t = e^{m0+b_t-m_t}
//   C' = e^{m0+F-m'} C0 + sum_s e^{F-b_s+i_s-m'} k_s v_s^T   (F = b_{L-1})
//
// and the same for n (v = 1), all in float32. Beyond the TPU kernel it
// takes the initial (C, n, m) and writes the final one (serving caches it
// for decode), and a ragged last chunk is masked by index: its missing
// rows act as i = -inf, f = 0, which leaves h of the real rows and the
// final state exact, where the Pallas kernel shrinks L until it divides S
// (down to L = 1 for an odd prompt).
//
// Design. The TPU kernel keeps the (dk, dv) state in VMEM and walks the
// chunks in a sequential grid. At dk = dv = 1024 the state is 4 MB a head,
// far above the 227 KB of shared memory a block has, and one block per
// head would use 4 of 132 SMs. So:
//  * mlstm_qk_kernel, grid (B*H, chunks), computes every chunk's (L, L)
//    q k^T in parallel into a scratch buffer: it does not depend on the
//    carried state;
//  * mlstm_chunk_kernel, grid (B*H, dv / TV), gives each block a TV-column
//    slice C[:, j0:j0+TV] of one head's state in shared memory (dk * TV
//    floats, 128 KB at dk = 1024) and n in full. The block loops over the
//    chunks in order, as the Pallas grid does, and streams q and k in
//    DKT-row slices of dk: each slice adds q C0 to the chunk's output tile
//    and is then folded into the same rows of C. Every block recomputes the
//    chunk's gate scans, the decayed scores, q.n0 and n: O(L^2 + L dk) of
//    the O(L dk TV) work a block does, about 3% at dk = 1024.
//
// Bound. At B = 1, H = 4, dk = dv = 1024 the work is ~4 L dk dv flops a
// chunk and head (q C0 and the state update) against one read of q, k, v
// and the state: ~14 GFLOP against ~84 MB at S = 777, so the float32 rate
// of the CUDA cores bounds it, not the bytes. The products run on the CUDA
// cores from shared memory, two shared loads per eight FMAs; 3xTF32 mma or
// wgmma is the way to that rate.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int LC = 64;       // rows of a chunk tile: the longest chunk
constexpr int DKT = 64;      // rows of dk streamed per step
constexpr int TV = 32;       // columns of dv (of C) a block owns
constexpr int NT = 256;      // threads per block
constexpr int QP = LC + 1;   // row of the transposed q / k tiles (padded)
constexpr int SP = LC + 1;   // row of the score tile (padded)

struct Strides {
  long long b, s, h;
};

// T[dd][s] = x[t0 + s][d0 + dd] for s < Lc, 0 beyond: a warp reads 32
// consecutive floats of one row and writes them down one padded column.
__device__ __forceinline__ void load_tile_t(float* __restrict__ T,
                                            const float* __restrict__ x,
                                            long long stride, int t0, int Lc,
                                            int d0) {
  for (int e = threadIdx.x; e < LC * DKT; e += NT) {
    const int s = e / DKT;
    const int dd = e % DKT;
    T[dd * QP + s] =
        s < Lc ? x[static_cast<long long>(t0 + s) * stride + d0 + dd] : 0.f;
  }
}

__global__ void __launch_bounds__(NT)
    mlstm_qk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    float* __restrict__ G, int S, int H, int dk, int chunk,
                    int nc, Strides sq, Strides sk) {
  __shared__ float qT[DKT * QP];
  __shared__ float kT[DKT * QP];
  const int bh = blockIdx.x;
  const int c = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = c * chunk;
  const int Lc = min(chunk, S - t0);
  const int R = threadIdx.x / 16;   // rows 4R .. 4R+3
  const int Cg = threadIdx.x % 16;  // columns 4Cg .. 4Cg+3
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < dk; d0 += DKT) {
    __syncthreads();  // the previous slice is no longer read
    load_tile_t(qT, qb, sq.s, t0, Lc, d0);
    load_tile_t(kT, kb, sk.s, t0, Lc, d0);
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < DKT; ++dd) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qT[dd * QP + 4 * R + i];
        bb[i] = kT[dd * QP + 4 * Cg + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
  float* g = G + (static_cast<long long>(bh) * nc + c) * LC * LC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[(4 * R + i) * LC + 4 * Cg + j] = acc[i][j];
}

__device__ __forceinline__ void fma4(float a, const float4& x, float* acc) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

__global__ void __launch_bounds__(NT) mlstm_chunk_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ G,
    const float* __restrict__ C0, const float* __restrict__ n0,
    const float* __restrict__ m0, float* __restrict__ hout,
    float* __restrict__ C1, float* __restrict__ n1, float* __restrict__ m1,
    int S, int H, int dk, int dv, int chunk, int nc, Strides sq, Strides sk,
    Strides sv) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;             // [dk][TV]  this block's columns of C
  float* nS = Cs + dk * TV;     // [dk]      n
  float* qT = nS + dk;          // [DKT][QP] q slice, transposed
  float* kT = qT + DKT * QP;    // [DKT][QP] k slice, transposed
  float* vS = kT + DKT * QP;    // [LC][TV]  v tile
  float* vw = vS + LC * TV;     // [LC][TV]  v tile times the state weights
  float* Sc = vw + LC * TV;     // [LC][SP]  decayed scores
  float* gi = Sc + LC * SP;     // [LC] input gates (-inf beyond the chunk)
  float* bc = gi + LC;          // [LC] cumulative log forget gates
  float* mt = bc + LC;          // [LC] stabilizers m_t
  float* w0 = mt + LC;          // [LC] e^{m0 + b_t - m_t}
  float* wk = w0 + LC;          // [LC] e^{F - b_s + i_s - m'}
  float* dI = wk + LC;          // [LC] q.n0 terms, then the denominators
  float* sc = dI + LC;          // m0, F, m', e^{m0 + F - m'}

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * TV;
  const int b = bh / H;
  const int h = bh % H;
  const int r = tid / 8;   // output rows 2r, 2r+1 / state rows 2r, 2r+1
  const int cq = tid % 8;  // columns 4cq .. 4cq+3 of the tile
  const int rn = tid / 4;  // row of the q.n0 and n work
  const int qn = tid % 4;  // its quarter of the slice
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + j0;
  const float* ib = ig + static_cast<long long>(b) * S * H + h;
  const float* fb = fg + static_cast<long long>(b) * S * H + h;

  const float* Cin = C0 + static_cast<long long>(bh) * dk * dv + j0;
  for (int e = tid; e < dk * TV; e += NT)
    Cs[e] = Cin[static_cast<long long>(e / TV) * dv + e % TV];
  for (int e = tid; e < dk; e += NT)
    nS[e] = n0[static_cast<long long>(bh) * dk + e];
  if (tid == 0) sc[0] = m0[bh];

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * chunk;
    const int Lc = min(chunk, S - t0);
    __syncthreads();  // the previous chunk is done with the tiles
    if (tid < LC) {
      const long long t = static_cast<long long>(t0 + tid) * H;
      gi[tid] = tid < Lc ? ib[t] : -CUDART_INF_F;
      bc[tid] = tid < Lc ? fb[t] : 0.f;
    }
    for (int e = tid; e < LC * TV; e += NT) {
      const int s = e / TV;
      vS[e] = s < Lc ? vb[static_cast<long long>(t0 + s) * sv.s + e % TV]
                     : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // the gate scans: 64 steps, once per chunk
      const float m = sc[0];
      float cum = 0.f, amax = -CUDART_INF_F;
      for (int s = 0; s < LC; ++s) {
        cum += bc[s];
        bc[s] = cum;
        amax = fmaxf(amax, gi[s] - cum);
        mt[s] = fmaxf(m + cum, cum + amax);
      }
      const float mnew = fmaxf(m + cum, cum + amax);
      sc[1] = cum;
      sc[2] = mnew;
      sc[3] = expf(m + cum - mnew);
    }
    __syncthreads();
    const float m_old = sc[0], F = sc[1], mnew = sc[2], wC0 = sc[3];
    if (tid < LC) {
      w0[tid] = expf(m_old + bc[tid] - mt[tid]);
      wk[tid] = expf(F - bc[tid] + gi[tid] - mnew);
    }
    const float* g = G + (static_cast<long long>(bh) * nc + c) * LC * LC;
    for (int e = tid; e < LC * LC; e += NT) {
      const int t = e / LC;
      const int s = e % LC;
      float val = 0.f;
      if (s <= t && t < Lc) val = g[e] * expf(bc[t] - bc[s] + gi[s] - mt[t]);
      Sc[t * SP + s] = val;
    }
    __syncthreads();
    for (int e = tid; e < LC * TV; e += NT) vw[e] = vS[e] * wk[e / TV];

    float acc[2][4] = {};
    float dint = 0.f;  // row rn's q.n0 over this thread's quarters
    for (int d0 = 0; d0 < dk; d0 += DKT) {
      load_tile_t(qT, qb, sq.s, t0, Lc, d0);
      load_tile_t(kT, kb, sk.s, t0, Lc, d0);
      __syncthreads();
      // h_inter += q C0 over this slice
#pragma unroll 8
      for (int dd = 0; dd < DKT; ++dd) {
        const float4 cv =
            *reinterpret_cast<const float4*>(&Cs[(d0 + dd) * TV + 4 * cq]);
        fma4(qT[dd * QP + 2 * r], cv, acc[0]);
        fma4(qT[dd * QP + 2 * r + 1], cv, acc[1]);
      }
#pragma unroll
      for (int i = 0; i < DKT / 4; ++i) {
        const int dd = qn * (DKT / 4) + i;
        dint = fmaf(qT[dd * QP + rn], nS[d0 + dd], dint);
      }
      __syncthreads();  // C0 and n0 of the slice are read: fold the chunk in
      {
        float u[2][4] = {};
#pragma unroll 8
        for (int s = 0; s < LC; ++s) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vw[s * TV + 4 * cq]);
          fma4(kT[(2 * r) * QP + s], vv, u[0]);
          fma4(kT[(2 * r + 1) * QP + s], vv, u[1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float4* cp = reinterpret_cast<float4*>(
              &Cs[(d0 + 2 * r + i) * TV + 4 * cq]);
          float4 cv = *cp;
          cv.x = cv.x * wC0 + u[i][0];
          cv.y = cv.y * wC0 + u[i][1];
          cv.z = cv.z * wC0 + u[i][2];
          cv.w = cv.w * wC0 + u[i][3];
          *cp = cv;
        }
        float un = 0.f;
#pragma unroll
        for (int i = 0; i < LC / 4; ++i) {
          const int s = qn * (LC / 4) + i;
          un = fmaf(kT[rn * QP + s], wk[s], un);
        }
        un += __shfl_xor_sync(0xffffffffu, un, 1);
        un += __shfl_xor_sync(0xffffffffu, un, 2);
        if (qn == 0) nS[d0 + rn] = nS[d0 + rn] * wC0 + un;
      }
      __syncthreads();  // the next slice overwrites q and k
    }

    dint += __shfl_xor_sync(0xffffffffu, dint, 1);
    dint += __shfl_xor_sync(0xffffffffu, dint, 2);
    if (qn == 0) dI[rn] = dint;
    __syncthreads();
    if (tid < LC) {
      float di = 0.f;
      for (int s = 0; s < LC; ++s) di += Sc[tid * SP + s];
      dI[tid] = fmaxf(fabsf(dI[tid] * w0[tid] + di), expf(-mt[tid]));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= w0[2 * r + i];
#pragma unroll 8
    for (int s = 0; s < LC; ++s) {
      const float4 vv = *reinterpret_cast<const float4*>(&vS[s * TV + 4 * cq]);
      fma4(Sc[(2 * r) * SP + s], vv, acc[0]);
      fma4(Sc[(2 * r + 1) * SP + s], vv, acc[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * r + i;
      if (row < Lc) {
        const float den = dI[row];
        float4 o;
        o.x = acc[i][0] / den;
        o.y = acc[i][1] / den;
        o.z = acc[i][2] / den;
        o.w = acc[i][3] / den;
        const long long t = (static_cast<long long>(b) * S + t0 + row) * H + h;
        *reinterpret_cast<float4*>(&hout[t * dv + j0 + 4 * cq]) = o;
      }
    }
    if (tid == 0) sc[0] = mnew;
  }
  __syncthreads();
  float* Cout = C1 + static_cast<long long>(bh) * dk * dv + j0;
  for (int e = tid; e < dk * TV; e += NT)
    Cout[static_cast<long long>(e / TV) * dv + e % TV] = Cs[e];
  if (blockIdx.y == 0) {
    for (int e = tid; e < dk; e += NT)
      n1[static_cast<long long>(bh) * dk + e] = nS[e];
    if (tid == 0) m1[bh] = sc[0];
  }
}

}  // namespace

// Chunkwise mLSTM forward over B * H heads. q, k: (B, S, H, dk) and v:
// (B, S, H, dv) float32 with unit stride on the last axis and the given
// (batch, seq, head) strides; ig, fg: (B, S, H) float32, contiguous; C0 /
// C1: (B, H, dk, dv), n0 / n1: (B, H, dk), m0 / m1: (B, H), float32,
// contiguous; hout: (B, S, H, dv) float32, contiguous; G: scratch of
// B * H * ceil(S / chunk) * 64 * 64 floats. dk a multiple of 64 up to
// 1024, dv a multiple of 32, 1 <= chunk <= 64. Returns the launches'
// cudaGetLastError().
extern "C" int mlstm_fwd(const float* q, const float* k, const float* v,
                         const float* ig, const float* fg, const float* C0,
                         const float* n0, const float* m0, float* hout,
                         float* C1, float* n1, float* m1, float* G, int B,
                         int S, int H, int dk, int dv, int chunk,
                         long long sqb, long long sqs, long long sqh,
                         long long skb, long long sks, long long skh,
                         long long svb, long long svs, long long svh,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dk % DKT != 0 || dk > 1024 ||
      dv <= 0 || dv % TV != 0 || chunk < 1 || chunk > LC)
    return cudaErrorInvalidValue;
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh};
  const int nc = (S + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mlstm_qk_kernel<<<dim3(B * H, nc), NT, 0, st>>>(q, k, G, S, H, dk, chunk,
                                                  nc, sq, sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(dk) * (TV + 1) + 2 * DKT * QP +
                       2 * LC * TV + LC * SP + 6 * LC + 4);
  err = cudaFuncSetAttribute(mlstm_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mlstm_chunk_kernel<<<dim3(B * H, dv / TV), NT, smem, st>>>(
      q, k, v, ig, fg, G, C0, n0, m0, hout, C1, n1, m1, S, H, dk, dv, chunk,
      nc, sq, sk, sv);
  return cudaGetLastError();
}
