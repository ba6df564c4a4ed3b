// The DFT passes of fft='mxu' for Hopper (sm_90a): nine C entry
// points, replacing the TPU kernels of pmesh_tpu/ops/fft_mxu.py and
// pmesh_tpu/ops/fft_mxu_ref.py.
//
// The split-Nyquist Cooley-Tukey pipeline (ct2 shapes):
//
//   pmesh_zy_fwd_ct2      replaces _zy_fwd_ct2_call (kernel
//                         _zy_forward_real_h_ct2): per x-plane, the raw
//                         z-Nyquist row sum, the z half-DFT (dense, or the
//                         z Cooley-Tukey split) and the y CT;
//   pmesh_xct_multi       replaces _xct_call_multi (kernel
//                         _x_transform_ct_multi; also _xct_call): the x CT,
//                         forward x scale or inverse, optionally with a
//                         second table set and the 1/k^2 fold;
//   pmesh_zy_inv_ct2      replaces _zy_inv_ct2_call (kernel
//                         _zy_inverse_to_real_h_ct2): the inverse y CT, the
//                         z half -> real (dense or z-CT) and the Nyquist
//                         plane times (-1)^n;
//   pmesh_zy_inv_ct2_dual replaces _zy_inv_ct2_call_dual (kernel
//                         _zy_inverse_to_real_h_ct2_dual): two table sets
//                         on one spectrum read, the plane on set A only.
//
// The dense pipeline (every other shape; natural order, the z-Nyquist
// column kept among the Zh = N2/2 + 1 half-spectrum columns):
//
//   pmesh_zy_fwd_half     replaces pass 1 of fft3_real_forward_half
//                         (kernel _zy_forward_real_h): per x-plane, the
//                         real (N1, N2) plane times the (N2, Zh) half-DFT
//                         pair, then the dense (N1 x N1) y DFT;
//   pmesh_x_dense         replaces the x passes of fft3_real_forward_half
//                         and fft3_real_inverse_grad3_half (kernel
//                         _x_transform): the dense (N0 x N0) x DFT, forward
//                         times 1/(N0 N1 N2) or inverse;
//   pmesh_zy_inv_half     replaces the zy pass of
//                         fft3_real_inverse_grad3_half (kernel
//                         _zy_inverse_to_real_h): the dense inverse y DFT,
//                         then z half -> real through the (Zh, n2) irfft
//                         matrices.
//
// The older pipelines of fft_mxu_ref.py run on the same entry points:
//
//   pmesh_zy_fwd_half     at Zh = N2 with the full (N2, N2) DFT pair is
//                         the full-spectrum pass 1 (kernel _zy_forward_real);
//   pmesh_zy_inv_full     replaces the full-spectrum inverse (kernel
//                         _zy_inverse_to_real): the complex z DFT by the
//                         (N2, N2) pair entered as A = Re Wz, B = -Im Wz,
//                         then the real part of the inverse y DFT, in
//                         JAX's order, so that the bf16 form rounds the z
//                         output as JAX's does;
//   pmesh_x_dense         at W = N2 is their x pass (_x_transform);
//   pmesh_zy_fwd_half_ct  replaces _zy_forward_real_h_ct: the dense z
//                         half-DFT to Zh = N2/2 + 1 columns (the Nyquist
//                         column kept in place), then the y CT;
//   pmesh_xct_multi       at W = Zh is its x pass (_x_transform_ct);
//   pmesh_zy_inv_ct2      at Zm = Zh with the (Zh, n2) irfft pair and no
//                         plane is its inverse (_zy_inverse_to_real_h_ct).
//
// Two choices of the dense pipeline differ from the TPU kernels' block
// structure, not from what they compute: the two inverse x passes of the
// force triple (plain, and with i*k_x folded into the table's columns)
// run as ONE dual launch on one read of the spectrum, and the 1/k^2
// filter, which the JAX package applies as an elementwise pass over the
// spectrum before the inverse, is folded into that launch's operand
// loader from the three 1-d k^2 tables, as pmesh_xct_multi does.
//
// They compute what those kernels compute, in the same stored order (see
// pmesh_tpu_torch/ops/fft_mxu.py), not how.  The TPU kernels hold whole
// x-planes (or (N0, 8, W) column blocks) in VMEM and run every product on
// the MXU; here each pass is a short sequence of launches of ONE
// shared-memory-tiled complex product routine (cgemm below) with the
// butterflies, scales and filters fused into its operand loads and its
// stores, plus an in-place butterfly sweep after each inverse product.
//
// What bounds them on this card: FP32 FMA throughput.  The transforms
// are products with small dense matrices (M x M per CT chunk, K x Mq per
// z chunk, Zm x n2 for the dense z inverse): one spectral force at 512^3
// is about 0.47 T FMA, 0.95 TFLOP (forward zy 60 G FMA, forward x 34 G,
// dual inverse x 69 G, three zy inverses of 103 G each), at least 14 ms
// at the card's 67 TFLOP/s, while a pass moves only ~1-1.5 GB (< 0.5 ms).
// The dense pipeline is the same arithmetic with R = 1: at 384^3 one
// spectral force is ~0.39 T FMA (forward 109 G, force triple 284 G),
// at least 11.7 ms at the FP32 rate.  It adds no instantiation of the
// product routine; ragged widths (Zh = 193 at 384^3, odd x, y or z
// lengths) are covered by cgemm's guarded scalar global loads and stores.
// The design therefore spends its effort on the FMA loop:
//  - a 64 x 64 complex output tile per 256-thread block, 4 x 4 complex
//    accumulators per thread, operands staged through shared memory in
//    16-deep slices and read back as float4, so each thread does 64 FMA
//    per 4 shared loads;
//  - real operands (the real input mesh of the dense z forward, the real
//    output of the z inverse) run the 2-FMA form instead of 4;
//  - the dual variants keep two accumulator sets against one staged
//    input tile, so the input is read once for both table sets;
//  - the forward butterfly (R-way sum of input rows) is evaluated while
//    the input tile is loaded; the inverse butterfly runs as an in-place
//    sweep over the product's output, one thread per (row, column)
//    group; blocks that share an input tile are adjacent in launch order
//    so that its R-fold re-reads come from L2.
// No TF32 and no tensor cores in this form: f32 products and f32
// accumulation, the f32-exact 'mxu' mode.
//
// The bf16 forms, set per call by two flags of every entry point:
//
//  - bf16 (fft='mxu_bf16', precision='bf16'): the single-pass bf16
//    products of the TPU kernels at jax.lax.Precision('default'): each
//    operand of each product rounded to bf16, the products summed in f32.
//    cgemm_bf16 replaces cgemm under the same Op functors: the loader
//    rounds each la/lb value once with __float2bfloat16_rn into bf16
//    tiles in shared memory, after the butterfly, the 1/k^2 fold and the
//    conjugation that la/lb apply (the TPU rounds the operand it is
//    handed, after those), and each warp runs
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with f32 accumulators: a
//    complex product is four real MMAs, -Ai.Bi through the negated
//    imaginary fragment (negating a bf16 value is exact; no
//    3-multiplication trick, which would round differently).  Ragged
//    edges and a contraction that is not a multiple of 32 are zero-filled
//    tiles.  Everything between two products of one pass (the butterfly
//    sweeps, the z-CT combination, the scales, the plane) stays f32, and
//    the next product rounds it again as its operand, as on the TPU.
//    What bounds it: the tensor cores would run these products at 989
//    TFLOP/s, so the operand loads (the same guarded scalar loads as
//    cgemm, through the functors) and the single-stage staging bound it;
//    wgmma, TMA and a ring of stages are a later redesign.
//  - bf16s (fft='mxu_bf16s', the ct2 entry points' spectrum_dtype): the
//    spectra between the passes are stored in bf16: CtOp's loads upcast
//    them and its stores round once.  The products stay the f32 cgemm.
//    The inverse x pass writes its products to f32 scratch that the
//    wrapper passes, and its butterfly sweep rounds once at the store of
//    the bf16 output, as JAX rounds once at the kernel's output store.
//    The real meshes and the Nyquist plane stay f32.
//
// Indices into meshes are 64-bit.  C interface for ctypes: each entry
// point launches on the given stream, allocates nothing (the wrapper
// passes scratch) and returns the first CUDA error of its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 16;          // contraction slice staged per step
constexpr int NT = 256;         // threads per block: 16 x 16
constexpr int TM = BM / 16;     // accumulator rows per thread
constexpr int TN = BN / 16;     // accumulator columns per thread
static_assert(TM == 4 && TN == 4, "the operand reads are float4");
constexpr int kMaxR = 8;
// the bf16 product: 32-deep slices, each tile row padded by 8 bf16 (16
// bytes), so that the fragment reads of a warp fall on 32 distinct banks
constexpr int BKH = 32;
constexpr int SKH = BKH + 8;

typedef __nv_bfloat16 bf16_t;

// spectrum storage: f32, or bf16 upcast at each load and rounded once at
// each store
__device__ __forceinline__ float ldv(const float* p, long long a) {
  return p[a];
}
__device__ __forceinline__ float ldv(const bf16_t* p, long long a) {
  return __bfloat162float(p[a]);
}
__device__ __forceinline__ void stv(float* p, long long a, float v) {
  p[a] = v;
}
__device__ __forceinline__ void stv(bf16_t* p, long long a, float v) {
  p[a] = __float2bfloat16_rn(v);
}

struct Cplx {
  float r, i;
};

// butterfly or combination constants, filled from a host (R, R, 2) array
struct Butter {
  float r[kMaxR][kMaxR];
  float i[kMaxR][kMaxR];
};

Butter make_butter(const float* h, int R) {
  Butter b = {};
  for (int a = 0; a < R; ++a)
    for (int c = 0; c < R; ++c) {
      b.r[a][c] = h[(a * R + c) * 2];
      b.i[a][c] = h[(a * R + c) * 2 + 1];
    }
  return b;
}

// grid decomposition of a batched product C[o, j] (M x N) += A (M x K) B
// (K x N): the block index runs over (m tile, n tile, j, o).  When the
// data operand is B (the x/y stages), the m tiles and chunks j that read
// one input column tile are adjacent; when it is A (the z stages), the n
// tiles and chunks j that read one row tile are.
struct Dims {
  int M, N, K, nj, tiles_m, tiles_n, m_fast;
};

__device__ __forceinline__ void decompose(const Dims& g, int& o, int& j,
                                          int& tm, int& tn) {
  long long b = blockIdx.x;
  if (g.m_fast) {
    tm = (int)(b % g.tiles_m); b /= g.tiles_m;
    j = (int)(b % g.nj); b /= g.nj;
    tn = (int)(b % g.tiles_n); o = (int)(b / g.tiles_n);
  } else {
    tn = (int)(b % g.tiles_n); b /= g.tiles_n;
    j = (int)(b % g.nj); b /= g.nj;
    tm = (int)(b % g.tiles_m); o = (int)(b / g.tiles_m);
  }
}

__device__ __forceinline__ void ld4(float* v, const float* s) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// The shared product routine.  Op supplies la (A element), lb (B
// element), st (store) and, for DUAL only, la2 and st2 (a second A operand
// and its output against the same B).  A_REAL: A's imaginary part is zero;
// OUT_REAL: only the real part of C is wanted.
template <class Op, bool DUAL, bool A_REAL, bool OUT_REAL>
__global__ void __launch_bounds__(NT) cgemm(const Op op, const Dims g) {
  // rows of BM + 4 floats: 16-byte aligned for the float4 reads
  __shared__ __align__(16) float As_r[BK][BM + 4];
  __shared__ __align__(16) float As_i[A_REAL ? 1 : BK][BM + 4];
  __shared__ __align__(16) float A2s_r[DUAL ? BK : 1][BM + 4];
  __shared__ __align__(16) float A2s_i[DUAL ? BK : 1][BM + 4];
  __shared__ __align__(16) float Bs_r[BK][BN];
  __shared__ __align__(16) float Bs_i[BK][BN];

  int o, j, tmi, tni;
  decompose(g, o, j, tmi, tni);
  const long long m0 = (long long)tmi * BM, n0 = (long long)tni * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float cr[TM][TN], ci[TM][TN], c2r[DUAL ? TM : 1][DUAL ? TN : 1],
      c2i[DUAL ? TM : 1][DUAL ? TN : 1];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      cr[a][b] = 0.f;
      ci[a][b] = 0.f;
      if constexpr (DUAL) {
        c2r[a][b] = 0.f;
        c2i[a][b] = 0.f;
      }
    }

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    // stage A (BM x BK, k fastest in memory) and B (BK x BN, n fastest)
#pragma unroll
    for (int l = 0; l < BM * BK / NT; ++l) {
      const int e = tid + NT * l, mm = e / BK, kk = e % BK;
      const long long m = m0 + mm;
      const int k = k0 + kk;
      const bool in = m < g.M && k < g.K;
      Cplx v = in ? op.la(o, j, m, k) : Cplx{0.f, 0.f};
      As_r[kk][mm] = v.r;
      if constexpr (!A_REAL) As_i[kk][mm] = v.i;
      if constexpr (DUAL) {
        Cplx v2 = in ? op.la2(o, j, m, k) : Cplx{0.f, 0.f};
        A2s_r[kk][mm] = v2.r;
        A2s_i[kk][mm] = v2.i;
      }
    }
#pragma unroll
    for (int l = 0; l < BK * BN / NT; ++l) {
      const int e = tid + NT * l, kk = e / BN, nn = e % BN;
      const long long n = n0 + nn;
      const int k = k0 + kk;
      Cplx v = (n < g.N && k < g.K) ? op.lb(o, j, k, n) : Cplx{0.f, 0.f};
      Bs_r[kk][nn] = v.r;
      Bs_i[kk][nn] = v.i;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // each thread owns rows ty*TM.. and columns tx*TN.. of the tile:
      // one float4 shared load per operand part
      float ar[TM], ai[TM] = {}, a2r[TM], a2i[TM], br[TN], bi[TN];
      ld4(ar, &As_r[kk][ty * TM]);
      if constexpr (!A_REAL) ld4(ai, &As_i[kk][ty * TM]);
      if constexpr (DUAL) {
        ld4(a2r, &A2s_r[kk][ty * TM]);
        ld4(a2i, &A2s_i[kk][ty * TM]);
      }
      ld4(br, &Bs_r[kk][tx * TN]);
      ld4(bi, &Bs_i[kk][tx * TN]);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          cr[a][b] = fmaf(ar[a], br[b], cr[a][b]);
          if constexpr (!A_REAL) cr[a][b] = fmaf(-ai[a], bi[b], cr[a][b]);
          if constexpr (!OUT_REAL) {
            ci[a][b] = fmaf(ar[a], bi[b], ci[a][b]);
            if constexpr (!A_REAL) ci[a][b] = fmaf(ai[a], br[b], ci[a][b]);
          }
          if constexpr (DUAL) {
            c2r[a][b] = fmaf(a2r[a], br[b], c2r[a][b]);
            c2r[a][b] = fmaf(-a2i[a], bi[b], c2r[a][b]);
            c2i[a][b] = fmaf(a2r[a], bi[b], c2i[a][b]);
            c2i[a][b] = fmaf(a2i[a], br[b], c2i[a][b]);
          }
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const long long m = m0 + ty * TM + a, n = n0 + tx * TN + b;
      if (m < g.M && n < g.N) {
        op.st(o, j, m, n, cr[a][b], ci[a][b]);
        if constexpr (DUAL) op.st2(o, j, m, n, c2r[a][b], c2i[a][b]);
      }
    }
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two adjacent bf16 of a tile row: the lower index in the lower half
__device__ __forceinline__ uint32_t ld2(const bf16_t* s) {
  return *reinterpret_cast<const uint32_t*>(s);
}

// the four A-fragment registers of the 16 x 16 block at (row r, col c)
// of a [BM][SKH] tile: rows r + gid (+8), columns c + 2 tig (+1, +8, +9)
__device__ __forceinline__ void ld_afrag(uint32_t* f, const bf16_t (*t)[SKH],
                                         int r, int c) {
  f[0] = ld2(&t[r][c]);
  f[1] = ld2(&t[r + 8][c]);
  f[2] = ld2(&t[r][c + 8]);
  f[3] = ld2(&t[r + 8][c + 8]);
}

__device__ __forceinline__ void negate(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int q = 0; q < 4; ++q) dst[q] = src[q] ^ 0x80008000u;
}

// The bf16 form of cgemm: the same Op interface, tiles and grid.  Each of
// the 8 warps owns a 32 x 16 corner of the 64 x 64 output tile: 2 x 2
// m16n8 accumulator blocks per part (re, im; a second set for DUAL).  B is
// staged transposed ([n][k]) so that each B-fragment register is one
// 32-bit shared load.
template <class Op, bool DUAL, bool A_REAL, bool OUT_REAL>
__global__ void __launch_bounds__(NT) cgemm_bf16(const Op op, const Dims g) {
  __shared__ __align__(16) bf16_t As_r[BM][SKH];
  __shared__ __align__(16) bf16_t As_i[A_REAL ? 1 : BM][SKH];
  __shared__ __align__(16) bf16_t A2s_r[DUAL ? BM : 1][SKH];
  __shared__ __align__(16) bf16_t A2s_i[DUAL ? BM : 1][SKH];
  __shared__ __align__(16) bf16_t Bs_r[BN][SKH];
  __shared__ __align__(16) bf16_t Bs_i[BN][SKH];
  static_assert(!(DUAL && A_REAL), "a dual A operand is complex");

  int o, j, tmi, tni;
  decompose(g, o, j, tmi, tni);
  const long long m0 = (long long)tmi * BM, n0 = (long long)tni * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const int gid = lane / 4, tig = lane % 4;

  float cr[2][2][4] = {}, ci[2][2][4] = {};
  float c2r[DUAL ? 2 : 1][2][4] = {}, c2i[DUAL ? 2 : 1][2][4] = {};

  for (int k0 = 0; k0 < g.K; k0 += BKH) {
    // stage A (BM x BKH) and B (BKH x BN, stored [n][k]), rounded once
#pragma unroll
    for (int l = 0; l < BM * BKH / NT; ++l) {
      const int e = tid + NT * l, mm = e / BKH, kk = e % BKH;
      const long long m = m0 + mm;
      const int k = k0 + kk;
      const bool in = m < g.M && k < g.K;
      const Cplx v = in ? op.la(o, j, m, k) : Cplx{0.f, 0.f};
      As_r[mm][kk] = __float2bfloat16_rn(v.r);
      if constexpr (!A_REAL) As_i[mm][kk] = __float2bfloat16_rn(v.i);
      if constexpr (DUAL) {
        const Cplx v2 = in ? op.la2(o, j, m, k) : Cplx{0.f, 0.f};
        A2s_r[mm][kk] = __float2bfloat16_rn(v2.r);
        A2s_i[mm][kk] = __float2bfloat16_rn(v2.i);
      }
    }
#pragma unroll
    for (int l = 0; l < BKH * BN / NT; ++l) {
      const int e = tid + NT * l, kk = e / BN, nn = e % BN;
      const long long n = n0 + nn;
      const int k = k0 + kk;
      const Cplx v =
          (n < g.N && k < g.K) ? op.lb(o, j, k, n) : Cplx{0.f, 0.f};
      Bs_r[nn][kk] = __float2bfloat16_rn(v.r);
      Bs_i[nn][kk] = __float2bfloat16_rn(v.i);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BKH; ks += 16) {
      const int c = ks + tig * 2;
      uint32_t ar[2][4], ai[2][4], an[2][4];
      uint32_t a2r[DUAL ? 2 : 1][4], a2i[DUAL ? 2 : 1][4],
          a2n[DUAL ? 2 : 1][4];
      uint32_t br[2][2], bi[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + gid;
        ld_afrag(ar[mt], As_r, r, c);
        if constexpr (!A_REAL) {
          ld_afrag(ai[mt], As_i, r, c);
          negate(an[mt], ai[mt]);
        }
        if constexpr (DUAL) {
          ld_afrag(a2r[mt], A2s_r, r, c);
          ld_afrag(a2i[mt], A2s_i, r, c);
          negate(a2n[mt], a2i[mt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = wn + nt * 8 + gid;
        br[nt][0] = ld2(&Bs_r[n][c]);
        br[nt][1] = ld2(&Bs_r[n][c + 8]);
        bi[nt][0] = ld2(&Bs_i[n][c]);
        bi[nt][1] = ld2(&Bs_i[n][c + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(cr[mt][nt], ar[mt], br[nt]);
          if constexpr (!A_REAL) mma_bf16(cr[mt][nt], an[mt], bi[nt]);
          if constexpr (!OUT_REAL) {
            mma_bf16(ci[mt][nt], ar[mt], bi[nt]);
            if constexpr (!A_REAL) mma_bf16(ci[mt][nt], ai[mt], br[nt]);
          }
          if constexpr (DUAL) {
            mma_bf16(c2r[mt][nt], a2r[mt], br[nt]);
            mma_bf16(c2r[mt][nt], a2n[mt], bi[nt]);
            mma_bf16(c2i[mt][nt], a2r[mt], bi[nt]);
            mma_bf16(c2i[mt][nt], a2i[mt], br[nt]);
          }
        }
    }
    __syncthreads();
  }
  // accumulator q of block (mt, nt): row gid (+8 for q >= 2), column
  // 2 tig (+1 for odd q)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long m = m0 + wm + mt * 16 + gid + (q >= 2 ? 8 : 0);
        const long long n = n0 + wn + nt * 8 + tig * 2 + (q & 1);
        if (m < g.M && n < g.N) {
          op.st(o, j, m, n, cr[mt][nt][q], ci[mt][nt][q]);
          if constexpr (DUAL)
            op.st2(o, j, m, n, c2r[mt][nt][q], c2i[mt][nt][q]);
        }
      }
}

// --- the operand and store functors ------------------------------------

// A CT stage along the rows of (nouter, R*M, ncols) complex blocks:
// forward (INV false): out[o, j*M + q, n] = scale * sum_m W_j[q, m] u_j[m, n],
//   u_j[m, n] = sum_r bt[r][j] fold(x[o, r*M + m, n]);
// inverse (INV true): y_j[m, n] = sum_q W_j[m, q] fold(x[o, j*M + q, n]) is
//   stored at out[o, j*M + m, n]; the butterfly sweep (ct_inv_butterfly)
//   then turns the y_j into the natural-order output in place.
// fold multiplies by 1/k^2 (0 at k^2 = 0) from three 1-d tables when k2x is
// set: row index -> k2x, column n -> (n / W, n % W) -> k2y, k2z.
// TI, TO: the storage types of x and out (float, or bf16 for the bf16s
// form); outi null: only the real part is stored.
template <bool INV, class TI = float, class TO = float>
struct CtOp {
  const TI *xr, *xi;
  const float *wr, *wi, *w2r, *w2i;
  TO *outr, *outi, *out2r, *out2i;
  const float *k2x, *k2y, *k2z;
  long long ostride;
  int M, R, ncols, W;
  float scale;
  Butter bt;

  __device__ __forceinline__ float fold(long long row, long long n) const {
    if (k2x == nullptr) return 1.f;
    const float k2 = k2x[row] + k2y[n / W] + k2z[n % W];
    return k2 > 0.f ? 1.f / k2 : 0.f;
  }
  __device__ __forceinline__ Cplx la(int, int j, long long m, int k) const {
    const long long a = ((long long)j * M + m) * M + k;
    return Cplx{wr[a], wi[a]};
  }
  __device__ __forceinline__ Cplx la2(int, int j, long long m, int k) const {
    const long long a = ((long long)j * M + m) * M + k;
    return Cplx{w2r[a], w2i[a]};
  }
  __device__ __forceinline__ Cplx lb(int o, int j, int k,
                                     long long n) const {
    const long long base = (long long)o * ostride + n;
    if (INV) {
      const long long row = (long long)j * M + k;
      const long long a = base + row * ncols;
      const float f = fold(row, n);
      return Cplx{ldv(xr, a) * f, ldv(xi, a) * f};
    }
    Cplx u{0.f, 0.f};
    for (int r = 0; r < R; ++r) {
      const long long row = (long long)r * M + k;
      const long long a = base + row * ncols;
      const float f = fold(row, n);
      const float vr = ldv(xr, a) * f, vi = ldv(xi, a) * f;
      const float cr = bt.r[r][j], ci = bt.i[r][j];
      u.r = fmaf(cr, vr, fmaf(-ci, vi, u.r));
      u.i = fmaf(cr, vi, fmaf(ci, vr, u.i));
    }
    return u;
  }
  __device__ __forceinline__ void st(int o, int j, long long m, long long n,
                                     float vr, float vi) const {
    const long long a =
        (long long)o * ostride + ((long long)j * M + m) * ncols + n;
    stv(outr, a, vr * scale);
    if (outi != nullptr) stv(outi, a, vi * scale);
  }
  __device__ __forceinline__ void st2(int o, int j, long long m, long long n,
                                      float vr, float vi) const {
    const long long a =
        (long long)o * ostride + ((long long)j * M + m) * ncols + n;
    stv(out2r, a, vr * scale);
    stv(out2i, a, vi * scale);
  }
};

// {y_j at rows j*M + m} of (re, im) -> {out_r at rows r*M + m} of
// (ore, oim), out_r = scale * sum_j bt[r][j] y_j, one thread per (o, m, n);
// in place when (ore, oim) is (re, im) (f32), else into the bf16 output,
// rounded once at the store
template <class TO>
__global__ void ct_inv_butterfly(const float* re, const float* im, TO* ore,
                                 TO* oim, long long nouter,
                                 long long ostride, int M, int R, int ncols,
                                 float scale, const Butter bt) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)M * ncols;
  if (t >= nouter * per) return;
  const long long o = t / per, rem = t % per;
  const long long base = o * ostride + rem;   // row m, column n
  float yr[kMaxR], yi[kMaxR];
#pragma unroll
  for (int j = 0; j < kMaxR; ++j)
    if (j < R) {
      yr[j] = re[base + (long long)j * per];
      yi[j] = im[base + (long long)j * per];
    }
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    if (r < R) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j)
        if (j < R) {
          const float cr = bt.r[r][j], ci = bt.i[r][j];
          sr = fmaf(cr, yr[j], fmaf(-ci, yi[j], sr));
          si = fmaf(cr, yi[j], fmaf(ci, yr[j], si));
        }
      stv(ore, base + (long long)r * per, sr * scale);
      stv(oim, base + (long long)r * per, si * scale);
    }
}

// dense z forward: rows (n0*N1) of the real mesh times the (N2, Zm)
// half-DFT pair
struct ZFwdDense {
  const float *x, *wr, *wi;
  float *sr, *si;
  int N2, Zm;
  __device__ __forceinline__ Cplx la(int, int, long long m, int k) const {
    return Cplx{x[m * N2 + k], 0.f};
  }
  __device__ __forceinline__ Cplx lb(int, int, int k, long long n) const {
    const long long a = (long long)k * Zm + n;
    return Cplx{wr[a], wi[a]};
  }
  __device__ __forceinline__ void st(int, int, long long m, long long n,
                                     float vr, float vi) const {
    sr[m * Zm + n] = vr;
    si[m * Zm + n] = vi;
  }
};

// z-CT forward, stored chunk p (= j of the grid): u[m, k] =
// sum_r c[r][p] x[m, r*K + k] (the butterfly, conjugated for the upper
// chunks as the JAX package does), times (Er[p], Ei[p]) (K x Mq), into
// columns [p*Mq, (p+1)*Mq) of the row
struct ZFwdCT {
  const float *x, *er, *ei;
  float *sr, *si;
  int N2, Zm, Rz, Kc, Mq;
  Butter c;
  __device__ __forceinline__ Cplx la(int, int p, long long m, int k) const {
    Cplx u{0.f, 0.f};
    const float* row = x + m * N2 + k;
    for (int r = 0; r < Rz; ++r) {
      const float v = row[(long long)r * Kc];
      u.r = fmaf(c.r[r][p], v, u.r);
      u.i = fmaf(c.i[r][p], v, u.i);
    }
    return u;
  }
  __device__ __forceinline__ Cplx lb(int, int p, int k, long long n) const {
    const long long a = ((long long)p * Kc + k) * Mq + n;
    return Cplx{er[a], ei[a]};
  }
  __device__ __forceinline__ void st(int, int p, long long m, long long n,
                                     float vr, float vi) const {
    const long long a = m * Zm + (long long)p * Mq + n;
    sr[a] = vr;
    si[a] = vi;
  }
};

// dense z inverse: out[m, n] = yr[m] . A[:, n] + yi[m] . B[:, n], i.e. the
// real part of (yr + i yi)(A - i B), plus plane[m] (-1)^n
struct ZInvDense {
  const float *yr, *yi, *ta, *tb, *plane;
  float* out;
  int Zm, n2;
  __device__ __forceinline__ Cplx la(int, int, long long m, int k) const {
    return Cplx{yr[m * Zm + k], yi[m * Zm + k]};
  }
  __device__ __forceinline__ Cplx lb(int, int, int k, long long n) const {
    const long long a = (long long)k * n2 + n;
    return Cplx{ta[a], -tb[a]};
  }
  __device__ __forceinline__ void st(int, int, long long m, long long n,
                                     float vr, float) const {
    if (plane != nullptr) vr += (n & 1) ? -plane[m] : plane[m];
    out[m * n2 + n] = vr;
  }
};

// full-spectrum z inverse: (zr + i zi)[m, n] = (xr + i xi)[m] . Wz[:, n],
// Wz entered as A = Re Wz, B = -Im Wz (n2 x n2), the complex result kept
// for the y stage
struct ZFull {
  const float *xr, *xi, *ta, *tb;
  float *zr, *zi;
  int n2;
  __device__ __forceinline__ Cplx la(int, int, long long m, int k) const {
    return Cplx{xr[m * n2 + k], xi[m * n2 + k]};
  }
  __device__ __forceinline__ Cplx lb(int, int, int k, long long n) const {
    const long long a = (long long)k * n2 + n;
    return Cplx{ta[a], -tb[a]};
  }
  __device__ __forceinline__ void st(int, int, long long m, long long n,
                                     float vr, float vi) const {
    zr[m * n2 + n] = vr;
    zi[m * n2 + n] = vi;
  }
};

// z-CT inverse, chunk j < Ri: P_j + i Q_j = (yr + i yi)[:, j*Kin:(j+1)*Kin]
// (A_j - i B_j); P_j goes to out's column block j and Q_j to the scratch
// zq, and zct_combine then forms the output blocks in place
struct ZInvCT {
  const float *yr, *yi, *ta, *tb;
  float *out, *zq;
  int Zm, n2, Kin, Kb;
  __device__ __forceinline__ Cplx la(int, int j, long long m, int k) const {
    const long long a = m * Zm + (long long)j * Kin + k;
    return Cplx{yr[a], yi[a]};
  }
  __device__ __forceinline__ Cplx lb(int, int j, int k, long long n) const {
    const long long a = ((long long)j * Kin + k) * Kb + n;
    return Cplx{ta[a], -tb[a]};
  }
  __device__ __forceinline__ void st(int, int j, long long m, long long n,
                                     float vr, float vi) const {
    const long long a = m * n2 + (long long)j * Kb + n;
    out[a] = vr;
    zq[a] = vi;
  }
};

// in place: out block c = sum_j cs_r[j][c] P_j - cs_i[j][c] Q_j, plus
// plane[m] (-1)^n; one thread per (row m, column n < Kb)
__global__ void zct_combine(float* __restrict__ out,
                            const float* __restrict__ zq,
                            const float* __restrict__ plane, long long rows,
                            int n2, int Ri, int Kb, const Butter cs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * Kb) return;
  const long long m = t / Kb;
  const int n = (int)(t % Kb);
  const long long base = m * n2 + n;
  float P[kMaxR], Q[kMaxR];
#pragma unroll
  for (int j = 0; j < kMaxR; ++j)
    if (j < Ri) {
      P[j] = out[base + (long long)j * Kb];
      Q[j] = zq[base + (long long)j * Kb];
    }
  const float pl = plane != nullptr ? plane[m] : 0.f;
#pragma unroll
  for (int c = 0; c < kMaxR; ++c)
    if (c < Ri) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j)
        if (j < Ri) s = fmaf(cs.r[j][c], P[j], fmaf(-cs.i[j][c], Q[j], s));
      const int col = c * Kb + n;
      if (plane != nullptr) s += (col & 1) ? -pl : pl;
      out[base + (long long)c * Kb] = s;
    }
}

// nq[m] = sum_n x[m, n] (-1)^n: one warp per row
__global__ void nyquist_rowsum(const float* __restrict__ x,
                               float* __restrict__ nq, long long rows,
                               int N2) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const float* row = x + w * N2;
  float s = 0.f;
  for (int n = lane; n < N2; n += 32) s += (n & 1) ? -row[n] : row[n];
  for (int d = 16; d > 0; d /= 2) s += __shfl_down_sync(0xffffffffu, s, d);
  if (lane == 0) nq[w] = s;
}

// --- launch helpers -----------------------------------------------------

int cdiv_ll(long long a, long long b) { return (int)((a + b - 1) / b); }

#define PMESH_TRY_E(expr)           \
  do {                              \
    cudaError_t e_ = (expr);        \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

#define PMESH_TRY(expr)             \
  do {                              \
    cudaError_t e_ = (expr);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// one product of the pass: cgemm, or cgemm_bf16 for the bf16 form
template <class Op, bool DUAL, bool A_REAL, bool OUT_REAL>
cudaError_t launch_gemm(const Op& op, int nouter, int nj, long long M,
                        long long N, int K, bool m_fast, bool bf16,
                        cudaStream_t stream) {
  Dims g;
  g.M = (int)M;
  g.N = (int)N;
  g.K = K;
  g.nj = nj;
  g.tiles_m = cdiv_ll(M, BM);
  g.tiles_n = cdiv_ll(N, BN);
  g.m_fast = m_fast ? 1 : 0;
  const long long blocks = (long long)g.tiles_m * g.tiles_n * nj * nouter;
  if (M > INT32_MAX || N > INT32_MAX || blocks > INT32_MAX)
    return cudaErrorInvalidValue;
  if (bf16)
    cgemm_bf16<Op, DUAL, A_REAL, OUT_REAL>
        <<<(unsigned)blocks, NT, 0, stream>>>(op, g);
  else
    cgemm<Op, DUAL, A_REAL, OUT_REAL>
        <<<(unsigned)blocks, NT, 0, stream>>>(op, g);
  return cudaGetLastError();
}

template <class TO>
cudaError_t launch_butterfly(const float* re, const float* im, TO* ore,
                             TO* oim, long long nouter, long long ostride,
                             int M, int R, int ncols, float scale,
                             const Butter& bt, cudaStream_t stream) {
  const long long n = nouter * M * (long long)ncols;
  const long long blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  ct_inv_butterfly<TO><<<(unsigned)blocks, 256, 0, stream>>>(
      re, im, ore, oim, nouter, ostride, M, R, ncols, scale, bt);
  return cudaGetLastError();
}

// the inverse y CT of (n0, N1, Zm) (storage TI) into the f32 (sr, si),
// for one or two table sets (dual: both from one staged input tile)
template <class TI>
cudaError_t y_inverse(const TI* xr, const TI* xi, const float* wAr,
                      const float* wAi, const float* wBr, const float* wBi,
                      float* sAr, float* sAi, float* sBr, float* sBi, int n0,
                      int N1, int Zm, int Ry, int My, const float* ycoef,
                      bool bf16, cudaStream_t stream) {
  CtOp<true, TI, float> op = {};
  op.xr = xr;
  op.xi = xi;
  op.wr = wAr;
  op.wi = wAi;
  op.w2r = wBr;
  op.w2i = wBi;
  op.outr = sAr;
  op.outi = sAi;
  op.out2r = sBr;
  op.out2i = sBi;
  op.ostride = (long long)N1 * Zm;
  op.M = My;
  op.R = Ry;
  op.ncols = Zm;
  op.W = 1;
  op.scale = 1.f;
  const Butter bt = make_butter(ycoef, Ry);
  if (wBr != nullptr)
    PMESH_TRY_E((launch_gemm<CtOp<true, TI, float>, true, false, false>(
        op, n0, Ry, My, Zm, My, true, bf16, stream)));
  else
    PMESH_TRY_E((launch_gemm<CtOp<true, TI, float>, false, false, false>(
        op, n0, Ry, My, Zm, My, true, bf16, stream)));
  PMESH_TRY_E(launch_butterfly(sAr, sAi, sAr, sAi, n0, op.ostride, My, Ry,
                               Zm, 1.f, bt, stream));
  if (sBr == nullptr) return cudaSuccess;
  return launch_butterfly(sBr, sBi, sBr, sBi, n0, op.ostride, My, Ry, Zm,
                          1.f, bt, stream);
}

// the forward y CT of the f32 (n0, N1, ncols) z spectrum (xr, xi) into
// (outr, outi) (storage TO), chunk-permuted along y
template <class TO>
cudaError_t y_forward(const float* xr, const float* xi, const float* wyr,
                      const float* wyi, const float* ycoef, TO* outr,
                      TO* outi, int n0, int N1, int ncols, int Ry, int My,
                      bool bf16, cudaStream_t stream) {
  CtOp<false, float, TO> op = {};
  op.xr = xr;
  op.xi = xi;
  op.wr = wyr;
  op.wi = wyi;
  op.outr = outr;
  op.outi = outi;
  op.ostride = (long long)N1 * ncols;
  op.M = My;
  op.R = Ry;
  op.ncols = ncols;
  op.W = 1;
  op.scale = 1.f;
  op.bt = make_butter(ycoef, Ry);
  return launch_gemm<CtOp<false, float, TO>, false, false, false>(
      op, n0, Ry, My, ncols, My, true, bf16, stream);
}

// the x CT of pmesh_xct_multi with the spectra stored as TS: the inverse
// writes its products to (p1, p2), f32 (the output itself for f32
// storage, the scratch for bf16), and the sweep stores the output
template <class TS>
cudaError_t x_ct(const TS* xr, const TS* xi, const float* wr,
                 const float* wi, const float* w2r, const float* w2i,
                 const float* k2x, const float* k2y, const float* k2z,
                 TS* o1r, TS* o1i, TS* o2r, TS* o2i, float* s1r, float* s1i,
                 float* s2r, float* s2i, int n1, int W, int R, int M,
                 bool inverse, float scale, const Butter& bt, bool bf16,
                 cudaStream_t stream) {
  const long long ncols = (long long)n1 * W;
  if (ncols > INT32_MAX) return cudaErrorInvalidValue;
  const bool dual = w2r != nullptr;
  if (!inverse) {
    CtOp<false, TS, TS> op = {xr, xi, wr, wi, w2r, w2i, o1r, o1i, o2r, o2i,
                              k2x, k2y, k2z, 0, M, R, (int)ncols, W, scale,
                              bt};
    if (dual)
      return launch_gemm<CtOp<false, TS, TS>, true, false, false>(
          op, 1, R, M, ncols, M, true, bf16, stream);
    return launch_gemm<CtOp<false, TS, TS>, false, false, false>(
        op, 1, R, M, ncols, M, true, bf16, stream);
  }
  float *p1r, *p1i, *p2r, *p2i;
  if constexpr (std::is_same<TS, float>::value) {
    p1r = o1r;
    p1i = o1i;
    p2r = o2r;
    p2i = o2i;
  } else {
    p1r = s1r;
    p1i = s1i;
    p2r = s2r;
    p2i = s2i;
  }
  CtOp<true, TS, float> op = {xr, xi, wr, wi, w2r, w2i, p1r, p1i, p2r, p2i,
                              k2x, k2y, k2z, 0, M, R, (int)ncols, W, 1.f,
                              bt};
  if (dual)
    PMESH_TRY_E((launch_gemm<CtOp<true, TS, float>, true, false, false>(
        op, 1, R, M, ncols, M, true, bf16, stream)));
  else
    PMESH_TRY_E((launch_gemm<CtOp<true, TS, float>, false, false, false>(
        op, 1, R, M, ncols, M, true, bf16, stream)));
  PMESH_TRY_E(launch_butterfly(p1r, p1i, o1r, o1i, 1, 0, M, R, (int)ncols,
                               scale, bt, stream));
  if (!dual) return cudaSuccess;
  return launch_butterfly(p2r, p2i, o2r, o2i, 1, 0, M, R, (int)ncols, scale,
                          bt, stream);
}

// a dense complex DFT along the rows of (nouter, M, ncols) blocks: the
// CtOp stage at R = 1, whose butterfly is the identity, so forward and
// inverse differ only by the table; optionally dual (a second table on
// the same staged input) and with the 1/k^2 fold (W: the z width of a
// column index n = y * W + z); o1i null: only the real part (OUT_REAL)
cudaError_t dense_rows(const float* xr, const float* xi, const float* wr,
                       const float* wi, const float* w2r, const float* w2i,
                       const float* k2x, const float* k2y, const float* k2z,
                       float* o1r, float* o1i, float* o2r, float* o2i,
                       int nouter, int M, long long ncols, int W,
                       float scale, bool bf16, cudaStream_t stream) {
  if (ncols > INT32_MAX) return cudaErrorInvalidValue;
  Butter one = {};
  one.r[0][0] = 1.f;
  CtOp<false> op = {xr, xi, wr, wi, w2r, w2i, o1r, o1i, o2r, o2i,
                    k2x, k2y, k2z, (long long)M * ncols, M, 1, (int)ncols,
                    W, scale, one};
  if (w2r != nullptr)
    return launch_gemm<CtOp<false>, true, false, false>(
        op, nouter, 1, M, ncols, M, true, bf16, stream);
  if (o1i == nullptr)
    return launch_gemm<CtOp<false>, false, false, true>(
        op, nouter, 1, M, ncols, M, true, bf16, stream);
  return launch_gemm<CtOp<false>, false, false, false>(
      op, nouter, 1, M, ncols, M, true, bf16, stream);
}

// the z inverse of the natural-y (rows, Zm) spectrum (yr, yi) into real
// (rows, n2), plus the plane
cudaError_t z_inverse(const float* yr, const float* yi, const float* ta,
                      const float* tb, int zct, int Ri, int Kin, int Kb,
                      const float* plane, float* out, float* zq,
                      long long rows, int Zm, int n2, const float* zcoef,
                      bool bf16, cudaStream_t stream) {
  if (!zct) {
    ZInvDense op = {yr, yi, ta, tb, plane, out, Zm, n2};
    return launch_gemm<ZInvDense, false, false, true>(op, 1, 1, rows, n2, Zm,
                                                      false, bf16, stream);
  }
  ZInvCT op = {yr, yi, ta, tb, out, zq, Zm, n2, Kin, Kb};
  PMESH_TRY_E((launch_gemm<ZInvCT, false, false, false>(
      op, 1, Ri, rows, Kb, Kin, false, bf16, stream)));
  const long long n = rows * Kb;
  const long long blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  zct_combine<<<(unsigned)blocks, 256, 0, stream>>>(
      out, zq, plane, rows, n2, Ri, Kb, make_butter(zcoef, Ri));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pmesh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every entry point takes bf16 (1: the bf16 products of cgemm_bf16); the
// ct2 entry points also bf16s (1: the spectra they read or write are
// stored in bf16, as the void pointers say).

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zm), nq (n0, N1).
// zct = 0: (wzr, wzi) is the dense (N2, Zm) half-DFT pair; zct = 1: the
// (Rz, Kz, Mq) z-CT pair with zcoef the (Rz, Rz, 2) chunk coefficients
// c[r][p].  (wyr, wyi): (Ry, My, My), ycoef (Ry, Ry, 2) = b[r][j].
// (sr, si): (n0, N1, Zm) f32 scratch for the z stage.  bf16s: (outr, outi)
// are bf16.
int pmesh_zy_fwd_ct2(const float* x, const float* wzr, const float* wzi,
                     int zct, int Rz, int Kz, int Mq, const float* zcoef,
                     const float* wyr, const float* wyi, const float* ycoef,
                     void* outr, void* outi, float* nq, float* sr,
                     float* si, int n0, int N1, int N2, int Ry, int My,
                     int bf16, int bf16s, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long rows = (long long)n0 * N1;
  const int Zm = N2 / 2;
  {
    const long long blocks = (rows * 32 + 255) / 256;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    nyquist_rowsum<<<(unsigned)blocks, 256, 0, stream>>>(x, nq, rows, N2);
    PMESH_TRY(cudaGetLastError());
  }
  if (zct) {
    ZFwdCT op = {};
    op.x = x;
    op.er = wzr;
    op.ei = wzi;
    op.sr = sr;
    op.si = si;
    op.N2 = N2;
    op.Zm = Zm;
    op.Rz = Rz;
    op.Kc = Kz;
    op.Mq = Mq;
    op.c = make_butter(zcoef, Rz);
    PMESH_TRY((launch_gemm<ZFwdCT, false, false, false>(
        op, 1, Rz, rows, Mq, Kz, false, bf16, stream)));
  } else {
    ZFwdDense op = {x, wzr, wzi, sr, si, N2, Zm};
    PMESH_TRY((launch_gemm<ZFwdDense, false, true, false>(
        op, 1, 1, rows, Zm, N2, false, bf16, stream)));
  }
  if (bf16s)
    return (int)y_forward(sr, si, wyr, wyi, ycoef, (bf16_t*)outr, (bf16_t*)outi,
                          n0, N1, Zm, Ry, My, bf16, stream);
  return (int)y_forward(sr, si, wyr, wyi, ycoef, (float*)outr, (float*)outi,
                        n0, N1, Zm, Ry, My, bf16, stream);
}

// (xr, xi) (N0, n1, W) -> (o1r, o1i) [and (o2r, o2i) when w2r is set]:
// forward (coef = b[r][j] of W_R^{-rj}) times scale, or inverse (coef =
// b[r][j] of W_R^{+rj}); the 1/k^2 fold when k2x is set (k2x (N0,),
// k2y (n1,), k2z (W,), in stored order).  bf16s: input and outputs are
// bf16, and the inverse needs the f32 scratch (s1r, s1i) [(s2r, s2i)]
// (N0, n1, W) for its products.
int pmesh_xct_multi(const void* xr, const void* xi, const float* wr,
                    const float* wi, const float* w2r, const float* w2i,
                    const float* k2x, const float* k2y, const float* k2z,
                    void* o1r, void* o1i, void* o2r, void* o2i, float* s1r,
                    float* s1i, float* s2r, float* s2i, int N0, int n1,
                    int W, int R, int M, int inverse, float scale,
                    const float* coef, int bf16, int bf16s, void* stream_) {
  (void)N0;
  const Butter bt = make_butter(coef, R);
  if (bf16s)
    return (int)x_ct<bf16_t>(
        (const bf16_t*)xr, (const bf16_t*)xi, wr, wi, w2r, w2i, k2x, k2y, k2z,
        (bf16_t*)o1r, (bf16_t*)o1i, (bf16_t*)o2r, (bf16_t*)o2i, s1r, s1i, s2r, s2i,
        n1, W, R, M, inverse != 0, scale, bt, bf16, (cudaStream_t)stream_);
  return (int)x_ct<float>(
      (const float*)xr, (const float*)xi, wr, wi, w2r, w2i, k2x, k2y, k2z,
      (float*)o1r, (float*)o1i, (float*)o2r, (float*)o2i, s1r, s1i, s2r, s2i,
      n1, W, R, M, inverse != 0, scale, bt, bf16, (cudaStream_t)stream_);
}

// (xr, xi) (n0, N1, Zm) -> out (n0, N1, n2).  (wyr, wyi): inverse y CT
// (Ry, My, My), ycoef b[r][j] of W_R^{+rj}; zct = 0: (ta, tb) dense
// (Zm, n2); zct = 1: (Ri, Kin, Kb) with zcoef the (Ri, Ri, 2) combination
// cs[j][c].  plane (n0, N1) or null.  Scratch: (sr, si) (n0, N1, Zm) and,
// for zct, zq (n0, N1, n2).  bf16s: (xr, xi) are bf16.
int pmesh_zy_inv_ct2(const void* xr, const void* xi, const float* wyr,
                     const float* wyi, const float* ta, const float* tb,
                     int zct, int Ri, int Kin, int Kb, const float* plane,
                     float* out, float* sr, float* si, float* zq, int n0,
                     int N1, int Zm, int n2, int Ry, int My,
                     const float* ycoef, const float* zcoef, int bf16,
                     int bf16s, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (bf16s)
    PMESH_TRY(y_inverse((const bf16_t*)xr, (const bf16_t*)xi, wyr, wyi, nullptr,
                        nullptr, sr, si, nullptr, nullptr, n0, N1, Zm, Ry,
                        My, ycoef, bf16, stream));
  else
    PMESH_TRY(y_inverse((const float*)xr, (const float*)xi, wyr, wyi,
                        nullptr, nullptr, sr, si, nullptr, nullptr, n0, N1,
                        Zm, Ry, My, ycoef, bf16, stream));
  PMESH_TRY(z_inverse(sr, si, ta, tb, zct, Ri, Kin, Kb, plane, out, zq,
                      (long long)n0 * N1, Zm, n2, zcoef, bf16, stream));
  return 0;
}

// the dual form: set A (wyA, taA, tbA, planeA) -> outA, set B -> outB,
// both y stages from one staged input tile.  Scratch (sAr, sAi, sBr, sBi)
// (n0, N1, Zm) and, for zct, zq (n0, N1, n2).  bf16s: (xr, xi) are bf16.
int pmesh_zy_inv_ct2_dual(const void* xr, const void* xi,
                          const float* wyAr, const float* wyAi,
                          const float* taA, const float* tbA,
                          const float* wyBr, const float* wyBi,
                          const float* taB, const float* tbB, int zct, int Ri,
                          int Kin, int Kb, const float* planeA, float* outA,
                          float* outB, float* sAr, float* sAi, float* sBr,
                          float* sBi, float* zq, int n0, int N1, int Zm,
                          int n2, int Ry, int My, const float* ycoef,
                          const float* zcoef, int bf16, int bf16s,
                          void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long rows = (long long)n0 * N1;
  if (bf16s)
    PMESH_TRY(y_inverse((const bf16_t*)xr, (const bf16_t*)xi, wyAr, wyAi, wyBr,
                        wyBi, sAr, sAi, sBr, sBi, n0, N1, Zm, Ry, My, ycoef,
                        bf16, stream));
  else
    PMESH_TRY(y_inverse((const float*)xr, (const float*)xi, wyAr, wyAi,
                        wyBr, wyBi, sAr, sAi, sBr, sBi, n0, N1, Zm, Ry, My,
                        ycoef, bf16, stream));
  PMESH_TRY(z_inverse(sAr, sAi, taA, tbA, zct, Ri, Kin, Kb, planeA, outA, zq,
                      rows, Zm, n2, zcoef, bf16, stream));
  PMESH_TRY(z_inverse(sBr, sBi, taB, tbB, zct, Ri, Kin, Kb, nullptr, outB,
                      zq, rows, Zm, n2, zcoef, bf16, stream));
  return 0;
}

// --- the dense pipeline ---------------------------------------------------

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zh): the dense z half-DFT
// by (wzr, wzi) (N2, Zh) into the scratch (sr, si) (n0, N1, Zh), then
// the dense y DFT by (wyr, wyi) (N1, N1).  Natural order throughout.
int pmesh_zy_fwd_half(const float* x, const float* wzr, const float* wzi,
                      const float* wyr, const float* wyi, float* outr,
                      float* outi, float* sr, float* si, int n0, int N1,
                      int N2, int Zh, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  ZFwdDense zop = {x, wzr, wzi, sr, si, N2, Zh};
  PMESH_TRY((launch_gemm<ZFwdDense, false, true, false>(
      zop, 1, 1, (long long)n0 * N1, Zh, N2, false, bf16, stream)));
  PMESH_TRY(dense_rows(sr, si, wyr, wyi, nullptr, nullptr, nullptr, nullptr,
                       nullptr, outr, outi, nullptr, nullptr, n0, N1, Zh, 1,
                       1.f, bf16, stream));
  return 0;
}

// (xr, xi) (N0, n1, W) -> (o1r, o1i) by the (N0, N0) table (wr, wi)
// times scale [and (o2r, o2i) by (w2r, w2i) when w2r is set], with the
// 1/k^2 fold when k2x is set (k2x (N0,), k2y (n1,), k2z (W,), natural
// order).
int pmesh_x_dense(const float* xr, const float* xi, const float* wr,
                  const float* wi, const float* w2r, const float* w2i,
                  const float* k2x, const float* k2y, const float* k2z,
                  float* o1r, float* o1i, float* o2r, float* o2i, int N0,
                  int n1, int W, float scale, int bf16, void* stream_) {
  return (int)dense_rows(xr, xi, wr, wi, w2r, w2i, k2x, k2y, k2z, o1r, o1i,
                         o2r, o2i, 1, N0, (long long)n1 * W, W, scale, bf16,
                         (cudaStream_t)stream_);
}

// (xr, xi) (n0, N1, Zh) -> out (n0, N1, n2): the dense inverse y DFT by
// (wyr, wyi) (N1, N1) into the scratch (sr, si) (n0, N1, Zh), then
// z half -> real by the (Zh, n2) irfft pair (ta, tb).
int pmesh_zy_inv_half(const float* xr, const float* xi, const float* wyr,
                      const float* wyi, const float* ta, const float* tb,
                      float* out, float* sr, float* si, int n0, int N1,
                      int Zh, int n2, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  PMESH_TRY(dense_rows(xr, xi, wyr, wyi, nullptr, nullptr, nullptr, nullptr,
                       nullptr, sr, si, nullptr, nullptr, n0, N1, Zh, 1, 1.f,
                       bf16, stream));
  PMESH_TRY(z_inverse(sr, si, ta, tb, 0, 1, Zh, n2, nullptr, out, nullptr,
                      (long long)n0 * N1, Zh, n2, nullptr, bf16, stream));
  return 0;
}

// --- the older pipelines (fft_mxu_ref.py) ---------------------------------

// (xr, xi) (n0, N1, N2) full spectrum -> out (n0, N1, N2), the real part
// of the inverse z and y DFTs: the complex z product by the (N2, N2) pair
// (ta, tb) = (Re Wz, -Im Wz) into the scratch (sr, si) (n0, N1, N2), then
// the real part of the inverse y DFT by (wyr, wyi) (N1, N1).
int pmesh_zy_inv_full(const float* xr, const float* xi, const float* wyr,
                      const float* wyi, const float* ta, const float* tb,
                      float* out, float* sr, float* si, int n0, int N1,
                      int N2, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  ZFull zop = {xr, xi, ta, tb, sr, si, N2};
  PMESH_TRY((launch_gemm<ZFull, false, false, false>(
      zop, 1, 1, (long long)n0 * N1, N2, N2, false, bf16, stream)));
  PMESH_TRY(dense_rows(sr, si, wyr, wyi, nullptr, nullptr, nullptr, nullptr,
                       nullptr, out, nullptr, nullptr, nullptr, n0, N1, N2, 1,
                       1.f, bf16, stream));
  return 0;
}

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zh): the dense z half-DFT
// by (wzr, wzi) (N2, Zh) into the scratch (sr, si) (n0, N1, Zh), then
// the y CT by (wyr, wyi) (Ry, My, My) with ycoef b[r][j] of W_R^{-rj}.
// y leaves chunk-permuted; the z-Nyquist column stays at index Zh - 1.
int pmesh_zy_fwd_half_ct(const float* x, const float* wzr, const float* wzi,
                         const float* wyr, const float* wyi,
                         const float* ycoef, float* outr, float* outi,
                         float* sr, float* si, int n0, int N1, int N2,
                         int Zh, int Ry, int My, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  ZFwdDense zop = {x, wzr, wzi, sr, si, N2, Zh};
  PMESH_TRY((launch_gemm<ZFwdDense, false, true, false>(
      zop, 1, 1, (long long)n0 * N1, Zh, N2, false, bf16, stream)));
  return (int)y_forward(sr, si, wyr, wyi, ycoef, outr, outi, n0, N1, Zh, Ry,
                        My, bf16, stream);
}

}  // extern "C"
