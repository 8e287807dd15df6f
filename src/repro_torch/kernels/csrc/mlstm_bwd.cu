// Stabilized mLSTM backward (K6 backward) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through autodiff of
// repro/models/layers/xlstm.py:mlstm_chunk (its forward is K6,
// repro/kernels/mlstm/kernel.py). It computes what
// repro_torch/kernels/mlstm/ref.py:mlstm_chunk_bwd_plain spells out: from
// q, k, v, the gates and dh, the gradients dq, dk, dv (f32 sums, rounded
// once to q's dtype), d i_raw and d f_log (f32), with the final state's
// cotangent zero and the initial state the zero state or a constant.
//
// The gradient does not depend on how the sequence is cut into chunks:
// m cancels in h (ref.py says why), so the forward's per-token m_t serves
// as the stabilizer of any blocking. This backward walks blocks of LB =
// 512 tokens (the training length) in the all-pairs form. With g = dh,
// Bg_t the cumsum of f over the sequence, alpha_t = Bg_t - m_t and beta_s
// = i_s - Bg_s (both in float64: from a float32 cumsum over 512 tokens D
// drifts by about 1e-5, a tenth of the tolerance, where the chunk-local
// sums carry only the rounding the forward shares), D_ts =
// e^{alpha_t + beta_s} <= 1 and S_ts = (q_t.k_s) D_ts (s <= t in one
// block):
//  * den_t = max(|w0_t q_t.n0 + sum_s S_ts|, e^{-m_t}), with (C0, n0) the
//    block's start state, w0_t its weight at t; dd_t the denominator's
//    branch, from g_t.num_t = w0_t z_t + sum_s S_ts (g_t.v_s), z_t =
//    q_t.(C0 g_t);
//  * dS_ts = (g_t.v_s) / den_t + dd_t; dq = (dS . D) K + r1 C0 g + r2 n0,
//    dk = (dS . D)^T Q, dv = (S / den)^T G, r1 = w0 / den, r2 = w0 dd;
//  * the gradient of alpha_t is the row sum of E = dS . S plus w0 dw0
//    (dw0 = z / den + (q.n0) dd), of beta_s its column sum plus wk dwk:
//    d i = d beta, d Bg = d alpha - d beta and d f its reversed cumsum.
//    The weights at a block's boundary (the state's e^{...} factors) cancel
//    between the two blocks, so they carry no gradient.
// Past one block the state walk between blocks remains (LB-deep products):
// C <- wC C + K^T diag(wk) V forward, then dC <- wC dC + Q^T diag(r1) G in
// reverse, with U = V dC^T + dn and W = K dC giving dk += wk U, dv += wk
// W, dwk = k.U.
//
// Bound. At the training call (16 x 512 tokens, 4 heads, dk = dv = 1024)
// the all-pairs form takes ~S (3 dk + 2 dv) flops a token, 86 GFLOP, and
// no state; the chunkwise form's state products take ~10 dk dv a token,
// 312 GFLOP, and carry 4 MB a head through HBM at every chunk. The two
// cost the same at S ~ 2048; LB is capped at 512 by the workspace (B H
// LB^2 f32, 67 MB a matrix at the cell, 268 MB at 1024), and the
// operations bound it (0.17 ms at TF32's rate).
//
// Design. About ten launches: the gate pass (mlstm_gates.cuh), a warp a
// head for alpha, beta and the weights, the batched products P = Q K^T and
// G V^T over the causal triangle, one token pass over full rows (den, dd,
// dS; dS . D and S / den written over P and G V^T; the row sums of E and
// each row block's column sums, summed in order later), the products dq,
// dk, dv with the inter terms in their epilogue, rounded once to q's
// dtype, and the gate gradients. Products (mlstm_bwd_gemm_kernel) are
// split TF32 on the tensor cores (mma.sync.m16n8k8), as csrc/mlstm.cu
// documents: a bf16 operand is one term, an f32 one hi + lo, f32 x f32
// three products, bf16 x f32 two; the split is done once, as a tile is
// staged from registers into shared memory (hi and lo planes), so the
// fragment reads are plain loads (ldmatrix where the tile is k-major,
// padded rows where it is not: no bank conflicts either way). Each BK =
// CHAIN-deep stage is a fresh tensor-core partial added into an f32
// accumulator (the tensor cores truncate; tests/test_torch_mlstm_bwd_split.py
// emulates the order). Output tiles sum their whole depth themselves, and
// the token pass's sums are fixed-order warp sums: no atomics, two runs
// are bitwise equal. What bounds it now: the products run near the rate
// that split-TF32 mma.sync reaches on this card (chip_smoke.py's route
// line; the LACE kernels' is alike). A wgmma.m64n128k8 version of the
// product kernel (K-major TF32 planes, the x-major operands transposed as
// they are stored) gave bitwise the same sums and no speed: each block
// then spends its time splitting and storing its operand tiles, which
// every block along the other axis repeats. Splitting each operand once,
// where it is made (the token pass writes dS . D and S / den), is the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mlstm_gates.cuh"

namespace {

constexpr int LB = 512;     // tokens of a backward block (all pairs)
constexpr int RB = 64;      // rows of a token-pass block
constexpr int NT = 256;     // threads per block
constexpr int NW = NT / 32;
constexpr int BM = 128;     // product tile rows
constexpr int BN = 128;     // product tile columns
constexpr int GT = 512;     // threads of a product block
constexpr int GWM = BM / 32;  // its warps along M, each 32 x 32
constexpr int BK = 32;      // product depth a stage
constexpr int CHAIN = 32;   // products per tensor-core chain (fresh partial)
constexpr int KSTEP = 8;    // products per m16n8k8 instruction
constexpr int XPAD = 8;     // pad of an x-major tile row, in words
constexpr int COLS = LB / 32;   // columns a lane owns in the token pass
static_assert(BK == CHAIN, "a stage's products are one chain");
static_assert(GT == 32 * GWM * (BN / 32), "a product warp a 32 x 32 tile");
static_assert(LB % BM == 0 && LB % RB == 0 && RB == 8 * NW,
              "blocks of whole tiles; eight rows a warp");
// per-token rows [q][B * H][S]
enum TokRow { W0 = 0, WK, FLR, R1, R2, A0, ROWE, AK, NTOK };

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

// Round to TF32 (to nearest, ties away from zero): the low 13 bits are 0.
// Integer operations on the bits give cvt.rna.tf32.f32's result for every
// finite value, in two simple instructions.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// c += a b for one 16 x 8 x 8 tile. Lane 4g + t holds A (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (k = t, n = g), (k = t + 4, n = g); C (g,
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) (PTX ISA, m16n8k8 .tf32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b: the first product of a chain.
__device__ __forceinline__ void mma_fresh(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Four 8 x 4-word matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and gets word l % 4 of row l / 4 of each.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint32_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// ---------------------------------------------------------------------------
// The batched product. Batch z = (b * H + h) * NJ + jj over head (b, h) and
// token block j = j0 + jj; an operand's element (z, r, c) lies at p + b sb
// + h sh + j sj + r s0 + c s1.
// ---------------------------------------------------------------------------
struct Opd {
  const void* p;
  long long sb, sh, sj, s0, s1;
};

struct Gemm {
  Opd a;       // A (M x K): s0 along M, s1 along K; type TA
  Opd b;       // B (K x N): s0 along K, s1 along N; type TB
  Opd out;     // Out (M x N), type TO
  Opd ksc;     // A(m, k) *= ksc(k) (s0 along K); p null: none
  // the epilogue, for blocks j0 .. with e0 <= j < e1: out += rs1(m) x1(m,
  // n) (rs1.p null: none) + rs2(m) v2(n) (v2.p null: none; rs2.p null: 1)
  Opd rs1, x1, rs2, v2;
  const float* beta;  // out = beta[bh * nbt + j] out + ...; null: overwrite
  int M, N, K;
  int tok;     // bits 0, 1, 2: M, N, K run over the block's tokens
  int tri;     // 1: a (t, s) output, tiles above the diagonal skipped;
               // 2: A(t, s), k <= m kept; 3: A(s, t), k >= m kept
  int H, NJ, j0, nbt, S, e0, e1;
  int avec, bvec;  // rows start on 16 bytes (f32) or 8 (bf16): vector loads
};

template <typename T>
__device__ __forceinline__ const T* at(const Opd& o, int b, int h, int j) {
  return static_cast<const T*>(o.p) + b * o.sb + h * o.sh + j * o.sj;
}

// 4 consecutive elements, raw (an f32 a word; bf16 two a word, the first
// in the low half); n of them real (0 past); vec: one aligned vector load.
// The bits are unpacked after the stage's products, so the load stays in
// flight behind them.
__device__ __forceinline__ void ldraw(uint32_t (&r)[4], const float* p, int n,
                                      bool vec) {
  if (vec && n == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = e < n ? __float_as_uint(p[e]) : 0u;
  }
}
__device__ __forceinline__ void ldraw(uint32_t (&r)[4],
                                      const __nv_bfloat16* p, int n,
                                      bool vec) {
  if (vec && n == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r[0] = v.x, r[1] = v.y;
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    uint32_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = e < n ? u[e] : 0u;
    r[0] = h[0] | (h[1] << 16), r[1] = h[2] | (h[3] << 16);
  }
}
__device__ __forceinline__ void unpack(float (&x)[4], const uint32_t (&r)[4],
                                       float) {
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(r[e]);
}
__device__ __forceinline__ void unpack(float (&x)[4], const uint32_t (&r)[4],
                                       __nv_bfloat16) {
  x[0] = __uint_as_float(r[0] << 16), x[1] = __uint_as_float(r[0] & 0xffff0000u);
  x[2] = __uint_as_float(r[1] << 16), x[3] = __uint_as_float(r[1] & 0xffff0000u);
}

// x's TF32 terms into one 16-byte chunk of each plane: split (hi, lo) or,
// for a bf16 value (exact in TF32), x itself.
template <bool SPLIT>
__device__ __forceinline__ void put4(uint32_t* hi, uint32_t* lo,
                                     const float (&x)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (SPLIT) {
      const float t = tf32(x[e]);
      h[e] = __float_as_uint(t);
      l[e] = __float_as_uint(tf32(x[e] - t));
    } else {
      h[e] = __float_as_uint(x[e]);
    }
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  if constexpr (SPLIT)
    *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ int clamp4(int n) { return max(0, min(4, n)); }

// Shared memory of a product kernel: two stages of TF32 planes (AW, BW,
// STAGE in words; BYTES in all).
template <bool SA, bool SB, bool AKC, bool BKC>
struct GemmSmem {
  static constexpr int AW = AKC ? BM * BK : BK * (BM + XPAD);  // a plane
  static constexpr int BW = BKC ? BN * BK : BK * (BN + XPAD);
  static constexpr int STAGE = (SA ? 2 : 1) * AW + (SB ? 2 : 1) * BW;
  static constexpr int BYTES = 2 * STAGE * 4;
};

// Out (M x N) = A B over the depth, batched. Tile BM x BN, 16 warps 4 x
// 4, each 32 x 32: two 16-row m tiles by four 8-column n tiles. A k-major
// operand (AKC / BKC) sits in shared memory as [x][BK] rows with its
// 16-byte chunks swizzled (chunk c of row r at c ^ (r & 7)) and is read with
// ldmatrix; an x-major one as [BK][x + XPAD] (a row stride of 8 banks mod
// 32), read one word a lane. Double-buffered through registers: the next
// stage's global loads are in flight while the current one's products
// run, then split into the other stage's planes. One block of 16 warps an
// SM (128 registers a thread); an element staged serves 128 products.
template <typename TA, typename TB, bool SA, bool SB, bool AKC, bool BKC,
          typename TO>
__global__ void __launch_bounds__(GT, 1) mlstm_bwd_gemm_kernel(Gemm g) {
  using L = GemmSmem<SA, SB, AKC, BKC>;
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int PA = SA ? 2 : 1;
  constexpr int AS = AKC ? BK : BM + XPAD;  // row stride of an A plane
  constexpr int BS = BKC ? BK : BN + XPAD;
  constexpr int AW = L::AW, BW = L::BW, STAGE = L::STAGE;
  constexpr int AG = BM * BK / 4 / GT;  // 4-element groups a thread
  constexpr int BG = BN * BK / 4 / GT;
  // groups along a row of a tile's contiguous axis, rows a pass
  constexpr int AX = AKC ? BK / 4 : BM / 4, BX = BKC ? BK / 4 : BN / 4;
  constexpr int AP = GT / AX, BP = GT / BX;

  const int z = blockIdx.z, jj = z % g.NJ, bh = z / g.NJ;
  const int b = bh / g.H, h = bh % g.H, j = g.j0 + jj;
  const int Lj = min(LB, g.S - j * LB);
  const int Mlim = (g.tok & 1) ? Lj : g.M;
  const int Nlim = (g.tok & 2) ? Lj : g.N;
  const int Klim = (g.tok & 4) ? Lj : g.K;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= Mlim || n0 >= Nlim) return;
  if (g.tri == 1 && n0 > m0 + BM - 1) return;
  const int kb = g.tri == 3 ? m0 : 0;
  const int ke = g.tri == 2 ? min(Klim, m0 + BM) : Klim;
  const int nk = (ke - kb + BK - 1) / BK;

  const TA* A = at<TA>(g.a, b, h, j);
  const TB* Bm = at<TB>(g.b, b, h, j);
  const float* ks = g.ksc.p ? at<float>(g.ksc, b, h, j) : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm0 = 32 * (warp % GWM), wn0 = 32 * (warp / GWM);

  // the thread's groups: 4 elements at 4 (tid % AX) along the tile's
  // contiguous axis, in rows tid / AX + AP i of the other (B: BX, BP)
  const int akg = 4 * (tid % AX), ak0 = tid / AX;
  const int bkg = 4 * (tid % BX), bk0 = tid / BX;
  // element offsets of the groups from the block's operand base
  int aoff[AG], boff[BG];
#pragma unroll
  for (int i = 0; i < AG; ++i)
    aoff[i] = AKC ? (m0 + ak0 + AP * i) * static_cast<int>(g.a.s0) + akg
                  : (ak0 + AP * i) * static_cast<int>(g.a.s1) + m0 + akg;
#pragma unroll
  for (int i = 0; i < BG; ++i)
    boff[i] = BKC ? (n0 + bk0 + BP * i) * static_cast<int>(g.b.s1) + bkg
                  : (bk0 + BP * i) * static_cast<int>(g.b.s0) + n0 + bkg;
  const int astep = AKC ? 1 : static_cast<int>(g.a.s1);  // a k step
  const int bstep = BKC ? 1 : static_cast<int>(g.b.s0);
  uint32_t ra[AG][4], rb[BG][4];
  float rs[AG];  // the k-scale of an x-major A group (one k a group)

  auto fetch = [&](int k0) {
    // a stage inside every limit takes one vector load a group
    const bool ain = g.avec && m0 + BM <= Mlim && k0 + BK <= ke;
    const bool bin = g.bvec && n0 + BN <= Nlim && k0 + BK <= ke;
#pragma unroll
    for (int i = 0; i < AG; ++i) {
      const int m = AKC ? m0 + ak0 + AP * i : m0 + akg;
      const int k = AKC ? k0 + akg : k0 + ak0 + AP * i;
      const int n = ain ? 4
                        : AKC ? (m < Mlim ? clamp4(ke - k) : 0)
                              : (k < ke ? clamp4(Mlim - m) : 0);
      ldraw(ra[i], A + aoff[i] + k0 * astep, n, ain);
      if (!AKC && ks != nullptr) rs[i] = k < ke ? ks[k * g.ksc.s0] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BG; ++i) {
      const int nn = BKC ? n0 + bk0 + BP * i : n0 + bkg;
      const int k = BKC ? k0 + bkg : k0 + bk0 + BP * i;
      const int n = bin ? 4
                        : BKC ? (nn < Nlim ? clamp4(ke - k) : 0)
                              : (k < ke ? clamp4(Nlim - nn) : 0);
      ldraw(rb[i], Bm + boff[i] + k0 * bstep, n, bin);
    }
  };

  auto put = [&](uint32_t* st, int k0) {
    uint32_t* ah = st;
    uint32_t* bh_ = st + PA * AW;
    // a stage the diagonal crosses: A(m, k) past it is zero
    const bool diag = (g.tri == 2 && k0 + BK - 1 > m0) ||
                      (g.tri == 3 && k0 < m0 + BM - 1);
#pragma unroll
    for (int i = 0; i < AG; ++i) {
      float x[4];
      unpack(x, ra[i], TA{});
      if (diag) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = AKC ? m0 + ak0 + AP * i : m0 + akg + e;
          const int k = AKC ? k0 + akg + e : k0 + ak0 + AP * i;
          if (g.tri == 2 ? k > m : k < m) x[e] = 0.f;
        }
      }
      if (!AKC && ks != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] *= rs[i];
      }
      const int idx = AKC ? (ak0 + AP * i) * BK +
                                (((akg >> 2) ^ ((ak0 + AP * i) & 7)) << 2)
                          : (ak0 + AP * i) * AS + akg;
      put4<SA>(ah + idx, ah + AW + idx, x);
    }
#pragma unroll
    for (int i = 0; i < BG; ++i) {
      float x[4];
      unpack(x, rb[i], TB{});
      const int idx = BKC ? (bk0 + BP * i) * BK +
                                (((bkg >> 2) ^ ((bk0 + BP * i) & 7)) << 2)
                          : (bk0 + BP * i) * BS + bkg;
      put4<SB>(bh_ + idx, bh_ + BW + idx, x);
    }
  };

  float acc[2][4][4] = {};
  if (nk > 0) {
    fetch(kb);
    put(smem, kb);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kb + (kt + 1) * BK);
    const uint32_t* st = smem + (kt & 1) * STAGE;
    const uint32_t* ahi = st;
    const uint32_t* alo = st + AW;
    const uint32_t* bhi = st + PA * AW;
    const uint32_t* blo = bhi + BW;
    float part[2][4][4];
#pragma unroll
    for (int kk = 0; kk < BK / KSTEP; ++kk) {
      uint32_t fa[2][4], fl[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (AKC) {
          const int row = wm0 + 16 * i + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int off = row * BK + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 2);
          ldsm4(fa[i], ahi + off);
          if constexpr (SA) ldsm4(fl[i], alo + off);
        } else {
          const int o = (KSTEP * kk + tq) * AS + wm0 + 16 * i + gq;
          fa[i][0] = ahi[o], fa[i][1] = ahi[o + 8];
          fa[i][2] = ahi[o + 4 * AS], fa[i][3] = ahi[o + 4 * AS + 8];
          if constexpr (SA) {
            fl[i][0] = alo[o], fl[i][1] = alo[o + 8];
            fl[i][2] = alo[o + 4 * AS], fl[i][3] = alo[o + 4 * AS + 8];
          }
        }
      }
#pragma unroll
      for (int jp = 0; jp < 4; jp += 2) {
        // B fragments of n tiles jp, jp + 1: [tile][k half]
        uint32_t fb[4], fbl[4];
        if constexpr (BKC) {
          const int mat = lane >> 3;
          const int row = wn0 + 8 * (jp + (mat >> 1)) + (lane & 7);
          const int off = row * BK + (((2 * kk + (mat & 1)) ^ (lane & 7)) << 2);
          ldsm4(fb, bhi + off);
          if constexpr (SB) ldsm4(fbl, blo + off);
        } else {
          const int o = (KSTEP * kk + tq) * BS + wn0 + 8 * jp + gq;
          fb[0] = bhi[o], fb[1] = bhi[o + 4 * BS];
          fb[2] = bhi[o + 8], fb[3] = bhi[o + 4 * BS + 8];
          if constexpr (SB) {
            fbl[0] = blo[o], fbl[1] = blo[o + 4 * BS];
            fbl[2] = blo[o + 8], fbl[3] = blo[o + 4 * BS + 8];
          }
        }
        // per tile: hi.hi (a fresh chain at the stage's first step), then
        // hi.lo, then lo.hi
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (kk == 0)
              mma_fresh(part[i][jp + q], fa[i], fb[2 * q], fb[2 * q + 1]);
            else
              mma(part[i][jp + q], fa[i], fb[2 * q], fb[2 * q + 1]);
          }
        if constexpr (SB) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma(part[i][jp + q], fa[i], fbl[2 * q], fbl[2 * q + 1]);
        }
        if constexpr (SA) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma(part[i][jp + q], fl[i], fb[2 * q], fb[2 * q + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] += part[i][q][e];
    if (kt + 1 < nk) put(smem + ((kt + 1) & 1) * STAGE, kb + (kt + 1) * BK);
    __syncthreads();
  }

  TO* O = const_cast<TO*>(at<TO>(g.out, b, h, j));
  const float beta = g.beta ? g.beta[static_cast<long long>(bh) * g.nbt + j]
                            : 0.f;
  const bool extra = j >= g.e0 && j < g.e1;
  const float* r1 = extra && g.rs1.p ? at<float>(g.rs1, b, h, j) : nullptr;
  const float* x1 = r1 ? at<float>(g.x1, b, h, j) : nullptr;
  const float* v2 = extra && g.v2.p ? at<float>(g.v2, b, h, j) : nullptr;
  const float* r2 = v2 && g.rs2.p ? at<float>(g.rs2, b, h, j) : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm0 + 16 * i + gq + 8 * (e >> 1);
        const int n = n0 + wn0 + 8 * q + 2 * tq + (e & 1);
        if (m >= Mlim || n >= Nlim) continue;
        TO* p = O + m * g.out.s0 + n * g.out.s1;
        float x = acc[i][q][e];
        if (g.beta) x = fmaf(beta, to_f32(*p), x);
        if (r1) x = fmaf(r1[m * g.rs1.s0], x1[m * g.x1.s0 + n * g.x1.s1], x);
        if (v2) x = fmaf(r2 ? r2[m * g.rs2.s0] : 1.f, v2[n * g.v2.s1], x);
        store(p, x);
      }
}

// ---------------------------------------------------------------------------
// alpha_t = Bg_t - m_t and beta_t = i_t - Bg_t in float64 (Bg the cumsum of
// f over the sequence: the gate pass's chunk-local b plus the chunks'
// totals), e^{-m_t}, and each block's weights: w0_t = e^{gamma_j +
// alpha_t} (0 where the block starts from the zero state), wk_s =
// e^{alpha_e + beta_s} (0 in the last block), wC_j = e^{gamma_j +
// alpha_e}, e the block's last token, gamma_0 = m0, gamma_j = -alpha at
// the end of block j - 1. Grid B * H, one warp.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32) mlstm_bwd_logd_kernel(
    const float* __restrict__ gates, const float* __restrict__ m0,
    double* __restrict__ alpha, double* __restrict__ beta,
    float* __restrict__ tok, float* __restrict__ wc, int BH, int S,
    int chunk, int nc, int nb) {
  const int bh = blockIdx.x, lane = threadIdx.x;
  const long long row = static_cast<long long>(bh) * S;
  double* al = alpha + row;
  double* be = beta + row;
  auto tk = [&](int q) { return tok + (static_cast<long long>(q) * BH + bh) * S; };
  double Fpre = 0.0;
  for (int c = 0; c < nc; ++c) {
    const float* g = gates + (static_cast<long long>(bh) * nc + c) * GROWS * GLC;
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    for (int r = lane; r < Lc; r += 32) {
      const double Bg = Fpre + static_cast<double>(g[r]);
      const float m = g[2 * GLC + r];
      al[t0 + r] = Bg - static_cast<double>(m);
      be[t0 + r] = static_cast<double>(g[GLC + r]) - Bg;
      tk(FLR)[t0 + r] = expf(-m);
    }
    Fpre += static_cast<double>(g[GLC - 1]);  // f = 0 past the chunk
  }
  __syncwarp();
  float* w0 = tk(W0);
  float* wk = tk(WK);
  for (int j = 0; j < nb; ++j) {
    const int t0 = j * LB, e = min(t0 + LB, S) - 1;
    const double ae = al[e];
    const double gam = j == 0 ? (m0 ? static_cast<double>(m0[bh]) : 0.0)
                              : -al[t0 - 1];
    const bool state = j > 0 || m0 != nullptr, last = j + 1 == nb;
    for (int t = t0 + lane; t <= e; t += 32) {
      w0[t] = state ? expf(static_cast<float>(gam + al[t])) : 0.f;
      wk[t] = last ? 0.f : expf(static_cast<float>(ae + be[t]));
    }
    if (lane == 0)
      wc[static_cast<long long>(bh) * nb + j] =
          expf(static_cast<float>(gam + ae));
  }
}

// ---------------------------------------------------------------------------
// n at the start of every block: nst[(bh * nb + j) * dk + r], n <- wC n +
// sum_s wk_s k_s. Grid (B * H, ceil(dk / NT)), a thread a row of dk. n0
// null: the zero state.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_nwalk_kernel(
    const T* __restrict__ k, const float* __restrict__ wk,
    const float* __restrict__ wc, const float* __restrict__ n0,
    float* __restrict__ nst, int S, int H, int dk, int nb, Strides sk) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r = blockIdx.y * NT + threadIdx.x;
  if (r >= dk) return;
  const T* kb = k + b * sk.b + h * sk.h + r;
  const float* w = wk + static_cast<long long>(bh) * S;
  float n = n0 ? n0[static_cast<long long>(bh) * dk + r] : 0.f;
  for (int j = 0; j < nb; ++j) {
    nst[(static_cast<long long>(bh) * nb + j) * dk + r] = n;
    if (j + 1 == nb) break;
    float acc = 0.f;
    for (int s = j * LB; s < (j + 1) * LB; ++s)
      acc = fmaf(w[s], to_f32(kb[s * sk.s]), acc);
    n = (j > 0 || n0) ? fmaf(wc[static_cast<long long>(bh) * nb + j], n, acc)
                      : acc;
  }
}

// ---------------------------------------------------------------------------
// dn at the end of every block: dnE[(bh * nb + j) * dk + r], zero after
// the last; dn <- wC dn + sum_t r2_t q_t. Grid (B * H, ceil(dk / NT)).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_dnwalk_kernel(
    const T* __restrict__ q, const float* __restrict__ r2,
    const float* __restrict__ wc, float* __restrict__ dnE, int S, int H,
    int dk, int nb, Strides sq) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r = blockIdx.y * NT + threadIdx.x;
  if (r >= dk) return;
  const T* qb = q + b * sq.b + h * sq.h + r;
  const float* w = r2 + static_cast<long long>(bh) * S;
  float dn = 0.f;
  for (int j = nb - 1; j >= 0; --j) {
    dnE[(static_cast<long long>(bh) * nb + j) * dk + r] = dn;
    if (j == 0) break;
    float acc = 0.f;
    for (int t = j * LB; t < min((j + 1) * LB, S); ++t)
      acc = fmaf(w[t], to_f32(qb[t * sq.s]), acc);
    dn = fmaf(wc[static_cast<long long>(bh) * nb + j], dn, acc);
  }
}

// ---------------------------------------------------------------------------
// The token pass: grid (B * H * nb, Lp / RB), a block RB rows of one token
// block, a warp eight rows, lane l the columns l + 32 i. P holds q k^T on
// entry and dS . D on exit, Gr g v^T and S / den; tok gets r1, r2, a0 =
// w0 dw0 and the row sums of E; cole the block's column sums of E,
// [(bh * nb + j) * NRB + rb][Lp]. Where the block has a start state, n0
// its n and Y its C0 g rows.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_token_kernel(
    const T* __restrict__ q, const double* __restrict__ alpha,
    const double* __restrict__ beta, float* __restrict__ tok,
    const float* __restrict__ nst, const float* __restrict__ Y,
    float* __restrict__ P, float* __restrict__ Gr, float* __restrict__ cole,
    int BH, int S, int H, int dk, int nb, int Lp, int has0, Strides sq) {
  __shared__ double sb[LB];
  __shared__ float colw[NW][LB];
  __shared__ float qn[RB], zt[RB];
  const int z = blockIdx.x, rb = blockIdx.y;
  const int bh = z / nb, j = z % nb, b = bh / H, h = bh % H;
  const int Lj = min(LB, S - j * LB);
  const int r0 = rb * RB;
  if (r0 >= Lj) return;
  const int ncol = min(r0 + RB, Lj);
  const long long trow = static_cast<long long>(bh) * S + j * LB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto tk = [&](int qq) {
    return tok + static_cast<long long>(qq) * BH * S + trow;
  };
  for (int s = tid; s < ncol; s += NT) sb[s] = beta[trow + s];
  const bool state = j > 0 || has0;
  // q_t.n0 and z_t = q_t.(C0 g_t), a warp a row
  for (int r = warp; r < RB; r += NW) {
    float a = 0.f, zz = 0.f;
    const int t = r0 + r;
    if (state && t < Lj) {
      const T* qt = q + b * sq.b + h * sq.h + (j * LB + t) * sq.s;
      const float* n0 = nst + (static_cast<long long>(bh) * nb + j) * dk;
      const float* yt = Y + (trow + t) * dk;
      for (int c = lane; c < dk; c += 32) {
        const float x = to_f32(qt[c]);
        a = fmaf(x, n0[c], a);
        zz = fmaf(x, yt[c], zz);
      }
    }
    a = warp_sum(a), zz = warp_sum(zz);
    if (lane == 0) qn[r] = a, zt[r] = zz;
  }
  __syncthreads();
  float col[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) col[i] = 0.f;
  const long long mat = static_cast<long long>(z) * Lp * Lp;
  for (int r = 8 * warp; r < 8 * warp + 8; ++r) {
    const int t = r0 + r;
    if (t >= Lj) break;
    float* Pt = P + mat + static_cast<long long>(t) * Lp;
    float* Gt = Gr + mat + static_cast<long long>(t) * Lp;
    const double at_ = alpha[trow + t];
    float Dv[COLS], Sv[COLS], Gv[COLS], rs = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int s = 32 * i + lane;
      Dv[i] = Sv[i] = Gv[i] = 0.f;
      if (s <= t) {
        Dv[i] = expf(static_cast<float>(at_ + sb[s]));
        Sv[i] = Pt[s] * Dv[i];
        Gv[i] = Gt[s];
      }
      rs += Sv[i];
      sg = fmaf(Sv[i], Gv[i], sg);
    }
    rs = warp_sum(rs), sg = warp_sum(sg);
    const float w0 = tk(W0)[t], fl = tk(FLR)[t];
    const float d = fmaf(w0, qn[r], rs);
    const float den = fmaxf(fabsf(d), fl);
    const float gnum = fmaf(w0, zt[r], sg);
    const float sgn = static_cast<float>((d > 0.f) - (d < 0.f));
    const float dd = fabsf(d) >= fl ? -sgn * gnum / (den * den) : 0.f;
    const float inv = 1.f / den;
    float rowE = 0.f;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int s = 32 * i + lane;
      const bool on = s <= t;
      const float dS = on ? fmaf(Gv[i], inv, dd) : 0.f;
      const float E = dS * Sv[i];
      if (on) {
        Pt[s] = dS * Dv[i];
        Gt[s] = Sv[i] * inv;
      }
      rowE += E;
      col[i] += E;
    }
    rowE = warp_sum(rowE);
    if (lane == 0) {
      tk(R1)[t] = w0 * inv;
      tk(R2)[t] = w0 * dd;
      tk(A0)[t] = w0 * fmaf(zt[r], inv, qn[r] * dd);
      tk(ROWE)[t] = rowE;
    }
  }
#pragma unroll
  for (int i = 0; i < COLS; ++i) colw[warp][32 * i + lane] = col[i];
  __syncthreads();
  float* ce = cole + (static_cast<long long>(z) * (Lp / RB) + rb) * Lp;
  for (int s = tid; s < ncol; s += NT) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) c += colw[w][s];
    ce[s] = c;
  }
}

// ---------------------------------------------------------------------------
// a_k = wk_t (k_t.U_t) for the tokens of every block but the last (U = dC
// v + dn there): grid ceil(B * H * (nb - 1) * LB / NW), a warp a row.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) mlstm_bwd_dwk_kernel(
    const T* __restrict__ k, const float* __restrict__ U,
    float* __restrict__ tok, int BH, int S, int H, int dk, int nb,
    Strides sk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * NW + warp;
  const int per = (nb - 1) * LB;
  if (w >= static_cast<long long>(BH) * per) return;
  const int bh = static_cast<int>(w / per), t = static_cast<int>(w % per);
  const int b = bh / H, h = bh % H;
  const T* kt = k + b * sk.b + h * sk.h + t * sk.s;
  const float* ut = U + (static_cast<long long>(bh) * S + t) * dk;
  float a = 0.f;
  for (int c = lane; c < dk; c += 32) a = fmaf(to_f32(kt[c]), ut[c], a);
  a = warp_sum(a);
  const long long o = static_cast<long long>(bh) * S + t;
  if (lane == 0) tok[AK * static_cast<long long>(BH) * S + o] =
      tok[WK * static_cast<long long>(BH) * S + o] * a;
}

// ---------------------------------------------------------------------------
// d i_raw and d f_log: one warp a head, 32 tokens at a time from the end.
// colE_s sums the token pass's row blocks in order; di_s = colE_s + ak_s;
// d Bg_t = rowE_t + a0_t - colE_t - ak_t (ak 0 in the last block); df the
// reversed cumsum of d Bg over the sequence.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32) mlstm_bwd_gategrad_kernel(
    const float* __restrict__ tok, const float* __restrict__ cole,
    float* __restrict__ gi, float* __restrict__ gf, int BH, int S, int H,
    int nb, int Lp) {
  const unsigned full = 0xffffffffu;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, lane = threadIdx.x;
  const long long row = static_cast<long long>(bh) * S;
  auto tk = [&](int q) { return tok + static_cast<long long>(q) * BH * S + row; };
  const int nrb = Lp / RB;
  float carry = 0.f;
  for (int g0 = (S - 1) / 32 * 32; g0 >= 0; g0 -= 32) {
    const int t = g0 + lane;
    float db = 0.f, di = 0.f;
    if (t < S) {
      const int j = t / LB, s = t % LB;
      const int Lj = min(LB, S - j * LB);
      const float* ce = cole + (static_cast<long long>(bh) * nb + j) * nrb * Lp;
      float c = 0.f;
      for (int r = s / RB; r < (Lj + RB - 1) / RB; ++r) c += ce[r * Lp + s];
      const float ak = j + 1 < nb ? tk(AK)[t] : 0.f;
      di = c + ak;
      db = tk(ROWE)[t] - c + tk(A0)[t] - ak;
    }
    // reversed inclusive sums down the lanes
    float inc = db;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(full, inc, off);
      if (lane + off < 32) inc += y;
    }
    if (t < S) {
      const long long o = (static_cast<long long>(b) * S + t) * H + h;
      gi[o] = di;
      gf[o] = inc + carry;
    }
    carry += __shfl_sync(full, inc, 0);
  }
}

// The workspace, in floats, each region on a 256-byte boundary. hasY: the
// state walk runs (a start state, or more than one block).
struct Work {
  long long gates, wc0, m1, alpha, beta, tok, wc, cole, P, Gr, state, nst,
      dnE, Y, U, W, total;
  Work(int B, int S, int H, int dk, int dv, int chunk, int has0) {
    const long long nc = (S + chunk - 1) / chunk;
    const long long BH = static_cast<long long>(B) * H;
    const long long nb = (S + LB - 1) / LB;
    const long long Lp = min(LB, (S + RB - 1) / RB * RB);
    const bool walk = has0 || nb > 1;
    auto up = [](long long n) { return (n + 63) / 64 * 64; };
    gates = 0;
    wc0 = gates + up(BH * nc * GROWS * GLC);
    m1 = wc0 + up(BH * nc);
    alpha = m1 + up(BH);
    beta = alpha + up(2 * BH * S);  // float64: two floats each
    tok = beta + up(2 * BH * S);
    wc = tok + up(NTOK * BH * S);
    cole = wc + up(BH * nb);
    P = cole + up(BH * nb * (Lp / RB) * Lp);
    Gr = P + up(BH * nb * Lp * Lp);
    state = Gr + up(BH * nb * Lp * Lp);
    nst = state + (walk ? up(BH * dk * dv) : 0);
    dnE = nst + (walk ? up(BH * nb * dk) : 0);
    Y = dnE + (nb > 1 ? up(BH * nb * dk) : 0);
    U = Y + (walk ? up(BH * S * dk) : 0);
    W = U + (nb > 1 ? up(BH * S * dk) : 0);
    total = W + (nb > 1 ? up(BH * S * dv) : 0);
  }
};

Opd opd(const void* p, long long sb, long long sh, long long sj,
        long long s0, long long s1) {
  return Opd{p, sb, sh, sj, s0, s1};
}

bool aligned(const Opd& o, int el) {
  // rows start where a 4-element vector may be loaded
  const long long a = 4;
  return reinterpret_cast<uintptr_t>(o.p) % (4 * el) == 0 && o.sb % a == 0 &&
         o.sh % a == 0 && o.sj % a == 0 && o.s0 % a == 0 && o.s1 % a == 0;
}

template <typename TA, typename TB, bool SA, bool SB, bool AKC, bool BKC,
          typename TO>
cudaError_t bgemm(Gemm g, int B, cudaStream_t st) {
  constexpr int bytes = GemmSmem<SA, SB, AKC, BKC>::BYTES;
  auto kern = mlstm_bwd_gemm_kernel<TA, TB, SA, SB, AKC, BKC, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  // the contiguous axis (s1 of a k-major A, s0 of an x-major one, ...) is
  // 1 and takes no part in the alignment test
  Opd a = g.a, bo = g.b;
  (AKC ? a.s1 : a.s0) = 0;
  (BKC ? bo.s0 : bo.s1) = 0;
  g.avec = aligned(a, sizeof(TA));
  g.bvec = aligned(bo, sizeof(TB));
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, B * g.H * g.NJ);
  kern<<<grid, GT, bytes, st>>>(g);
  return cudaGetLastError();
}

#define CHECK(x)                      \
  do {                                \
    const cudaError_t e_ = (x);       \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* ig,
           const float* fg, const float* C0, const float* n0, const float* m0,
           const float* dh, T* gq, T* gk, T* gv, float* gi, float* gf,
           float* work, int B, int S, int H, int dk, int dv, int chunk,
           Strides sq, Strides sk, Strides sv, cudaStream_t st) {
  constexpr bool F = sizeof(T) == 4;  // f32 q, k, v: split like dh
  using f32 = float;
  const int nc = (S + chunk - 1) / chunk;
  const int nb = (S + LB - 1) / LB;
  const int Lp = min(LB, (S + RB - 1) / RB * RB);
  const int BH = B * H;
  const int has0 = C0 != nullptr;
  const bool walk = has0 || nb > 1;
  const Work w(B, S, H, dk, dv, chunk, has0);
  float* tok = work + w.tok;
  float* wc = work + w.wc;
  float* state = work + w.state;
  const long long HD = static_cast<long long>(dk) * dv;  // a head's state
  const long long TS = static_cast<long long>(BH) * S;   // a token row
  // (B, S, H, width) inputs by token block: rows are tokens, or (T) columns
  auto seq = [&](const void* p, Strides s) {
    return opd(p, s.b, s.h, LB * s.s, s.s, 1);
  };
  auto seqT = [&](const void* p, Strides s) {
    return opd(p, s.b, s.h, LB * s.s, 1, s.s);
  };
  const Strides sg{static_cast<long long>(S) * H * dv,
                   static_cast<long long>(H) * dv, dv};  // dh's
  const long long LL = static_cast<long long>(Lp) * Lp;
  auto mat = [&](const float* p) {
    return opd(p, H * nb * LL, nb * LL, LL, Lp, 1);
  };
  auto matT = [&](const float* p) {
    return opd(p, H * nb * LL, nb * LL, LL, 1, Lp);
  };
  auto tokq = [&](int q_) {
    return opd(tok + q_ * TS, static_cast<long long>(H) * S, S, LB, 1, 0);
  };
  // [bh][S][width] f32 rows of Y, U, W
  auto rows = [&](const float* p, int width) {
    return opd(p, static_cast<long long>(H) * S * width,
               static_cast<long long>(S) * width,
               static_cast<long long>(LB) * width, width, 1);
  };
  // [bh][nb][dk] vectors of n, dn: v2(n)
  auto blockvec = [&](const float* p) {
    return opd(p, static_cast<long long>(H) * nb * dk,
               static_cast<long long>(nb) * dk, dk, 0, 1);
  };
  const Opd grad_q = opd(gq, static_cast<long long>(S) * H * dk, dk,
                         static_cast<long long>(LB) * H * dk,
                         static_cast<long long>(H) * dk, 1);
  const Opd grad_k = opd(gk, grad_q.sb, grad_q.sh, grad_q.sj, grad_q.s0, 1);
  const Opd grad_v = opd(gv, static_cast<long long>(S) * H * dv, dv,
                         static_cast<long long>(LB) * H * dv,
                         static_cast<long long>(H) * dv, 1);
  auto base = [&](int NJ, int j0, int M, int N, int K, int tok_) {
    Gemm g{};
    g.M = M, g.N = N, g.K = K, g.tok = tok_;
    g.H = H, g.NJ = NJ, g.j0 = j0, g.nbt = nb, g.S = S;
    return g;
  };
  const dim3 rowsgrid(BH, (dk + NT - 1) / NT);

  mlstm_gate_kernel<<<BH, 32, 0, st>>>(ig, fg, m0, work + w.gates,
                                       work + w.wc0, work + w.m1, S, H,
                                       chunk, nc);
  CHECK(cudaGetLastError());
  double* alpha = reinterpret_cast<double*>(work + w.alpha);
  double* beta = reinterpret_cast<double*>(work + w.beta);
  mlstm_bwd_logd_kernel<<<BH, 32, 0, st>>>(work + w.gates, m0, alpha, beta,
                                           tok, wc, BH, S, chunk, nc, nb);
  CHECK(cudaGetLastError());

  // the forward's state walk between blocks: n and C at each block's
  // start, Y = G C^T from each
  if (walk) {
    mlstm_bwd_nwalk_kernel<T><<<rowsgrid, NT, 0, st>>>(
        k, tok + WK * TS, wc, n0, work + w.nst, S, H, dk, nb, sk);
    CHECK(cudaGetLastError());
    if (has0)
      CHECK(cudaMemcpyAsync(state, C0, sizeof(float) * BH * HD,
                            cudaMemcpyDeviceToDevice, st));
    for (int j = 0; j < nb; ++j) {
      if (j > 0 || has0) {
        Gemm g = base(1, j, Lp, dk, dv, 1);
        g.a = seq(dh, sg);
        g.b = opd(state, H * HD, HD, 0, 1, dv);  // (e, d) of C^T
        g.out = rows(work + w.Y, dk);
        CHECK((bgemm<f32, f32, true, true, true, true, f32>(g, B, st)));
      }
      if (j + 1 < nb) {
        // C <- wC C + K^T diag(wk) V
        Gemm g = base(1, j, dk, dv, Lp, 4);
        g.a = seqT(k, sk);
        g.b = seq(v, sv);
        g.ksc = tokq(WK);
        g.out = opd(state, H * HD, HD, 0, dv, 1);
        g.beta = (j > 0 || has0) ? wc : nullptr;
        CHECK((bgemm<T, T, true, F, false, false, f32>(g, B, st)));
      }
    }
  }

  // the pairs of every block: P = Q K^T, G V^T on and below the diagonal
  {
    Gemm g = base(nb, 0, Lp, Lp, dk, 3);
    g.tri = 1;
    g.a = seq(q, sq);
    g.b = seqT(k, sk);  // (d, s) of K^T
    g.out = mat(work + w.P);
    CHECK((bgemm<T, T, F, F, true, true, f32>(g, B, st)));
    g = base(nb, 0, Lp, Lp, dv, 3);
    g.tri = 1;
    g.a = seq(dh, sg);
    g.b = seqT(v, sv);
    g.out = mat(work + w.Gr);
    CHECK((bgemm<f32, T, true, F, true, true, f32>(g, B, st)));
  }

  mlstm_bwd_token_kernel<T><<<dim3(BH * nb, Lp / RB), NT, 0, st>>>(
      q, alpha, beta, tok, work + w.nst, work + w.Y, work + w.P, work + w.Gr,
      work + w.cole, BH, S, H, dk, nb, Lp, has0, sq);
  CHECK(cudaGetLastError());

  // the reverse walk: dC at the start of block j (the end of j - 1), then
  // U = V dC^T + dn and W = K dC of block j - 1
  if (nb > 1) {
    mlstm_bwd_dnwalk_kernel<T><<<rowsgrid, NT, 0, st>>>(
        q, tok + R2 * TS, wc, work + w.dnE, S, H, dk, nb, sq);
    CHECK(cudaGetLastError());
    for (int j = nb - 1; j >= 1; --j) {
      Gemm g = base(1, j, dk, dv, Lp, 4);
      g.a = seqT(q, sq);
      g.ksc = tokq(R1);
      g.b = seq(dh, sg);
      g.out = opd(state, H * HD, HD, 0, dv, 1);
      g.beta = j + 1 < nb ? wc : nullptr;
      CHECK((bgemm<T, f32, true, true, false, false, f32>(g, B, st)));
      g = base(1, j - 1, Lp, dk, dv, 1);
      g.a = seq(v, sv);
      g.b = opd(state, H * HD, HD, 0, 1, dv);  // (e, d) of dC^T
      g.out = rows(work + w.U, dk);
      g.v2 = blockvec(work + w.dnE);
      g.e0 = 0, g.e1 = nb;
      CHECK((bgemm<T, f32, F, true, true, true, f32>(g, B, st)));
      g = base(1, j - 1, Lp, dv, dk, 1);
      g.a = seq(k, sk);
      g.b = opd(state, H * HD, HD, 0, dv, 1);  // (d, e) of dC
      g.out = rows(work + w.W, dv);
      CHECK((bgemm<T, f32, F, true, true, false, f32>(g, B, st)));
    }
    const long long nrow = static_cast<long long>(BH) * (nb - 1) * LB;
    mlstm_bwd_dwk_kernel<T><<<static_cast<unsigned>((nrow + NW - 1) / NW),
                              NT, 0, st>>>(k, work + w.U, tok, BH, S, H, dk,
                                           nb, sk);
    CHECK(cudaGetLastError());
  }

  // dq = (dS . D) K + r1 Y + r2 n0, dk = (dS . D)^T Q + wk U, dv = (S /
  // den)^T G + wk W, rounded once to q's dtype
  {
    Gemm g = base(nb, 0, Lp, dk, Lp, 5);
    g.tri = 2;
    g.a = mat(work + w.P);
    g.b = seq(k, sk);
    g.out = grad_q;
    if (walk) {
      g.rs1 = tokq(R1), g.x1 = rows(work + w.Y, dk);
      g.rs2 = tokq(R2), g.v2 = blockvec(work + w.nst);
      g.e0 = has0 ? 0 : 1, g.e1 = nb;
    }
    CHECK((bgemm<f32, T, true, F, true, false, T>(g, B, st)));
    g = base(nb, 0, Lp, dk, Lp, 5);
    g.tri = 3;
    g.a = matT(work + w.P);
    g.b = seq(q, sq);
    g.out = grad_k;
    if (nb > 1) {
      g.rs1 = tokq(WK), g.x1 = rows(work + w.U, dk);
      g.e0 = 0, g.e1 = nb - 1;
    }
    CHECK((bgemm<f32, T, true, F, false, false, T>(g, B, st)));
    g = base(nb, 0, Lp, dv, Lp, 5);
    g.tri = 3;
    g.a = matT(work + w.Gr);
    g.b = seq(dh, sg);
    g.out = grad_v;
    if (nb > 1) {
      g.rs1 = tokq(WK), g.x1 = rows(work + w.W, dv);
      g.e0 = 0, g.e1 = nb - 1;
    }
    CHECK((bgemm<f32, f32, true, true, false, false, T>(g, B, st)));
  }

  mlstm_bwd_gategrad_kernel<<<BH, 32, 0, st>>>(tok, work + w.cole, gi, gf, BH,
                                               S, H, nb, Lp);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch mlstm_bwd needs for these shapes; has_state: an
// initial state is given.
extern "C" long long mlstm_bwd_workspace(int B, int S, int H, int dk, int dv,
                                         int chunk, int has_state) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || chunk < 1 ||
      chunk > GLC)
    return -1;
  return Work(B, S, H, dk, dv, chunk, has_state != 0).total;
}

// The mLSTM backward over B * H heads. q, k: (B, S, H, dk), v: (B, S, H,
// dv), all float32 (dtype 0) or all bfloat16 (dtype 1), unit stride on the
// last axis, the given (batch, seq, head) strides; ig, fg: (B, S, H)
// float32, contiguous; C0 (B, H, dk, dv), n0 (B, H, dk), m0 (B, H): the
// initial state, float32, contiguous (all null: the zero state); dh: (B,
// S, H, dv) float32, contiguous. Writes gq, gk (B, S, H, dk), gv (B, S, H,
// dv) in q's dtype and gi, gf (B, S, H) float32, contiguous. work:
// mlstm_bwd_workspace(..., C0 != null) floats. chunk (1 .. 64) is the
// forward's, whose gate pass gives the stabilizer m. Returns the launches'
// cudaGetLastError().
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
      chunk > GLC)
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
