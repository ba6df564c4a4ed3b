// The DFT passes of fft='mxu' for Hopper (sm_90a): eight C entry
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
//   pmesh_zy_inv_half     at Zh = n2 = N2 with A = Re Wz, B = -Im Wz is the
//                         full-spectrum inverse (kernel _zy_inverse_to_real):
//                         JAX runs z then y, this runs y then z, which is
//                         the same real part;
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
// No TF32 and no tensor cores: f32 products and f32 accumulation, the
// f32-exact 'mxu' mode.  (Split-precision tensor-core products are the
// lever for a later redesign.)
//
// Indices into meshes are 64-bit.  C interface for ctypes: each entry
// point launches on the given stream, allocates nothing (the wrapper
// passes scratch) and returns the first CUDA error of its launches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 16;          // contraction slice staged per step
constexpr int NT = 256;         // threads per block: 16 x 16
constexpr int TM = BM / 16;     // accumulator rows per thread
constexpr int TN = BN / 16;     // accumulator columns per thread
static_assert(TM == 4 && TN == 4, "the operand reads are float4");
constexpr int kMaxR = 8;

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

// --- the operand and store functors ------------------------------------

// A CT stage along the rows of (nouter, R*M, ncols) complex blocks:
// forward (INV false): out[o, j*M + q, n] = scale * sum_m W_j[q, m] u_j[m, n],
//   u_j[m, n] = sum_r bt[r][j] fold(x[o, r*M + m, n]);
// inverse (INV true): y_j[m, n] = sum_q W_j[m, q] fold(x[o, j*M + q, n]) is
//   stored at out[o, j*M + m, n]; the butterfly sweep (ct_inv_butterfly)
//   then turns the y_j into the natural-order output in place.
// fold multiplies by 1/k^2 (0 at k^2 = 0) from three 1-d tables when k2x is
// set: row index -> k2x, column n -> (n / W, n % W) -> k2y, k2z.
template <bool INV>
struct CtOp {
  const float *xr, *xi, *wr, *wi, *w2r, *w2i;
  float *outr, *outi, *out2r, *out2i;
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
      return Cplx{xr[a] * f, xi[a] * f};
    }
    Cplx u{0.f, 0.f};
    for (int r = 0; r < R; ++r) {
      const long long row = (long long)r * M + k;
      const long long a = base + row * ncols;
      const float f = fold(row, n);
      const float vr = xr[a] * f, vi = xi[a] * f;
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
    outr[a] = vr * scale;
    outi[a] = vi * scale;
  }
  __device__ __forceinline__ void st2(int o, int j, long long m, long long n,
                                      float vr, float vi) const {
    const long long a =
        (long long)o * ostride + ((long long)j * M + m) * ncols + n;
    out2r[a] = vr * scale;
    out2i[a] = vi * scale;
  }
};

// in place: {y_j at rows j*M + m} -> {out_r at rows r*M + m},
// out_r = scale * sum_j bt[r][j] y_j, one thread per (o, m, n)
__global__ void ct_inv_butterfly(float* __restrict__ re,
                                 float* __restrict__ im, long long nouter,
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
      re[base + (long long)r * per] = sr * scale;
      im[base + (long long)r * per] = si * scale;
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

template <class Op, bool DUAL, bool A_REAL, bool OUT_REAL>
cudaError_t launch_gemm(const Op& op, int nouter, int nj, long long M,
                        long long N, int K, bool m_fast,
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
  cgemm<Op, DUAL, A_REAL, OUT_REAL>
      <<<(unsigned)blocks, NT, 0, stream>>>(op, g);
  return cudaGetLastError();
}

cudaError_t launch_butterfly(float* re, float* im, long long nouter,
                             long long ostride, int M, int R, int ncols,
                             float scale, const Butter& bt,
                             cudaStream_t stream) {
  const long long n = nouter * M * (long long)ncols;
  const long long blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  ct_inv_butterfly<<<(unsigned)blocks, 256, 0, stream>>>(
      re, im, nouter, ostride, M, R, ncols, scale, bt);
  return cudaGetLastError();
}

#define PMESH_TRY(expr)             \
  do {                              \
    cudaError_t e_ = (expr);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// the inverse y CT of (n0, N1, Zm) into (sr, si), for one or two table
// sets (dual: both from one staged input tile)
cudaError_t y_inverse(const float* xr, const float* xi, const float* wAr,
                      const float* wAi, const float* wBr, const float* wBi,
                      float* sAr, float* sAi, float* sBr, float* sBi, int n0,
                      int N1, int Zm, int Ry, int My, const float* ycoef,
                      cudaStream_t stream) {
  CtOp<true> op = {};
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
  cudaError_t e;
  if (wBr != nullptr)
    e = launch_gemm<CtOp<true>, true, false, false>(op, n0, Ry, My, Zm, My,
                                                    true, stream);
  else
    e = launch_gemm<CtOp<true>, false, false, false>(op, n0, Ry, My, Zm, My,
                                                     true, stream);
  if (e != cudaSuccess) return e;
  e = launch_butterfly(sAr, sAi, n0, op.ostride, My, Ry, Zm, 1.f, bt,
                       stream);
  if (e != cudaSuccess || sBr == nullptr) return e;
  return launch_butterfly(sBr, sBi, n0, op.ostride, My, Ry, Zm, 1.f, bt,
                          stream);
}

// the forward y CT of the (n0, N1, ncols) z spectrum (xr, xi) into
// (outr, outi), chunk-permuted along y
cudaError_t y_forward(const float* xr, const float* xi, const float* wyr,
                      const float* wyi, const float* ycoef, float* outr,
                      float* outi, int n0, int N1, int ncols, int Ry, int My,
                      cudaStream_t stream) {
  CtOp<false> op = {};
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
  return launch_gemm<CtOp<false>, false, false, false>(op, n0, Ry, My, ncols,
                                                       My, true, stream);
}

// a dense complex DFT along the rows of (nouter, M, ncols) blocks: the
// CtOp stage at R = 1, whose butterfly is the identity, so forward and
// inverse differ only by the table; optionally dual (a second table on
// the same staged input) and with the 1/k^2 fold (W: the z width of a
// column index n = y * W + z)
cudaError_t dense_rows(const float* xr, const float* xi, const float* wr,
                       const float* wi, const float* w2r, const float* w2i,
                       const float* k2x, const float* k2y, const float* k2z,
                       float* o1r, float* o1i, float* o2r, float* o2i,
                       int nouter, int M, long long ncols, int W,
                       float scale, cudaStream_t stream) {
  if (ncols > INT32_MAX) return cudaErrorInvalidValue;
  Butter one = {};
  one.r[0][0] = 1.f;
  CtOp<false> op = {xr, xi, wr, wi, w2r, w2i, o1r, o1i, o2r, o2i,
                    k2x, k2y, k2z, (long long)M * ncols, M, 1, (int)ncols,
                    W, scale, one};
  if (w2r != nullptr)
    return launch_gemm<CtOp<false>, true, false, false>(op, nouter, 1, M,
                                                        ncols, M, true,
                                                        stream);
  return launch_gemm<CtOp<false>, false, false, false>(op, nouter, 1, M,
                                                       ncols, M, true, stream);
}

// the z inverse of the natural-y (rows, Zm) spectrum (yr, yi) into real
// (rows, n2), plus the plane
cudaError_t z_inverse(const float* yr, const float* yi, const float* ta,
                      const float* tb, int zct, int Ri, int Kin, int Kb,
                      const float* plane, float* out, float* zq,
                      long long rows, int Zm, int n2, const float* zcoef,
                      cudaStream_t stream) {
  if (!zct) {
    ZInvDense op = {yr, yi, ta, tb, plane, out, Zm, n2};
    return launch_gemm<ZInvDense, false, false, true>(op, 1, 1, rows, n2, Zm,
                                                      false, stream);
  }
  ZInvCT op = {yr, yi, ta, tb, out, zq, Zm, n2, Kin, Kb};
  cudaError_t e = launch_gemm<ZInvCT, false, false, false>(
      op, 1, Ri, rows, Kb, Kin, false, stream);
  if (e != cudaSuccess) return e;
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

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zm), nq (n0, N1).
// zct = 0: (wzr, wzi) is the dense (N2, Zm) half-DFT pair; zct = 1: the
// (Rz, Kz, Mq) z-CT pair with zcoef the (Rz, Rz, 2) chunk coefficients
// c[r][p].  (wyr, wyi): (Ry, My, My), ycoef (Ry, Ry, 2) = b[r][j].
// (sr, si): (n0, N1, Zm) scratch for the z stage.
int pmesh_zy_fwd_ct2(const float* x, const float* wzr, const float* wzi,
                     int zct, int Rz, int Kz, int Mq, const float* zcoef,
                     const float* wyr, const float* wyi, const float* ycoef,
                     float* outr, float* outi, float* nq, float* sr,
                     float* si, int n0, int N1, int N2, int Ry, int My,
                     void* stream_) {
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
        op, 1, Rz, rows, Mq, Kz, false, stream)));
  } else {
    ZFwdDense op = {x, wzr, wzi, sr, si, N2, Zm};
    PMESH_TRY((launch_gemm<ZFwdDense, false, true, false>(
        op, 1, 1, rows, Zm, N2, false, stream)));
  }
  return (int)y_forward(sr, si, wyr, wyi, ycoef, outr, outi, n0, N1, Zm, Ry,
                        My, stream);
}

// (xr, xi) (N0, n1, W) -> (o1r, o1i) [and (o2r, o2i) when w2r is set]:
// forward (coef = b[r][j] of W_R^{-rj}) times scale, or inverse (coef =
// b[r][j] of W_R^{+rj}); the 1/k^2 fold when k2x is set (k2x (N0,),
// k2y (n1,), k2z (W,), in stored order).
int pmesh_xct_multi(const float* xr, const float* xi, const float* wr,
                    const float* wi, const float* w2r, const float* w2i,
                    const float* k2x, const float* k2y, const float* k2z,
                    float* o1r, float* o1i, float* o2r, float* o2i, int N0,
                    int n1, int W, int R, int M, int inverse, float scale,
                    const float* coef, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long ncols = (long long)n1 * W;
  if (ncols > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Butter bt = make_butter(coef, R);
  const bool dual = w2r != nullptr;
  if (inverse) {
    CtOp<true> op = {xr, xi, wr, wi, w2r, w2i, o1r, o1i, o2r, o2i,
                     k2x, k2y, k2z, 0, M, R, (int)ncols, W, 1.f, bt};
    if (dual)
      PMESH_TRY((launch_gemm<CtOp<true>, true, false, false>(
          op, 1, R, M, ncols, M, true, stream)));
    else
      PMESH_TRY((launch_gemm<CtOp<true>, false, false, false>(
          op, 1, R, M, ncols, M, true, stream)));
    PMESH_TRY(launch_butterfly(o1r, o1i, 1, 0, M, R, (int)ncols, scale, bt,
                               stream));
    if (dual)
      PMESH_TRY(launch_butterfly(o2r, o2i, 1, 0, M, R, (int)ncols, scale,
                                 bt, stream));
    return 0;
  }
  CtOp<false> op = {xr, xi, wr, wi, w2r, w2i, o1r, o1i, o2r, o2i,
                    k2x, k2y, k2z, 0, M, R, (int)ncols, W, scale, bt};
  if (dual)
    PMESH_TRY((launch_gemm<CtOp<false>, true, false, false>(
        op, 1, R, M, ncols, M, true, stream)));
  else
    PMESH_TRY((launch_gemm<CtOp<false>, false, false, false>(
        op, 1, R, M, ncols, M, true, stream)));
  return 0;
}

// (xr, xi) (n0, N1, Zm) -> out (n0, N1, n2).  (wyr, wyi): inverse y CT
// (Ry, My, My), ycoef b[r][j] of W_R^{+rj}; zct = 0: (ta, tb) dense
// (Zm, n2); zct = 1: (Ri, Kin, Kb) with zcoef the (Ri, Ri, 2) combination
// cs[j][c].  plane (n0, N1) or null.  Scratch: (sr, si) (n0, N1, Zm) and,
// for zct, zq (n0, N1, n2).
int pmesh_zy_inv_ct2(const float* xr, const float* xi, const float* wyr,
                     const float* wyi, const float* ta, const float* tb,
                     int zct, int Ri, int Kin, int Kb, const float* plane,
                     float* out, float* sr, float* si, float* zq, int n0,
                     int N1, int Zm, int n2, int Ry, int My,
                     const float* ycoef, const float* zcoef, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  PMESH_TRY(y_inverse(xr, xi, wyr, wyi, nullptr, nullptr, sr, si, nullptr,
                      nullptr, n0, N1, Zm, Ry, My, ycoef, stream));
  PMESH_TRY(z_inverse(sr, si, ta, tb, zct, Ri, Kin, Kb, plane, out, zq,
                      (long long)n0 * N1, Zm, n2, zcoef, stream));
  return 0;
}

// the dual form: set A (wyA, taA, tbA, planeA) -> outA, set B -> outB,
// both y stages from one staged input tile.  Scratch (sAr, sAi, sBr, sBi)
// (n0, N1, Zm) and, for zct, zq (n0, N1, n2).
int pmesh_zy_inv_ct2_dual(const float* xr, const float* xi,
                          const float* wyAr, const float* wyAi,
                          const float* taA, const float* tbA,
                          const float* wyBr, const float* wyBi,
                          const float* taB, const float* tbB, int zct, int Ri,
                          int Kin, int Kb, const float* planeA, float* outA,
                          float* outB, float* sAr, float* sAi, float* sBr,
                          float* sBi, float* zq, int n0, int N1, int Zm,
                          int n2, int Ry, int My, const float* ycoef,
                          const float* zcoef, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long rows = (long long)n0 * N1;
  PMESH_TRY(y_inverse(xr, xi, wyAr, wyAi, wyBr, wyBi, sAr, sAi, sBr, sBi, n0,
                      N1, Zm, Ry, My, ycoef, stream));
  PMESH_TRY(z_inverse(sAr, sAi, taA, tbA, zct, Ri, Kin, Kb, planeA, outA, zq,
                      rows, Zm, n2, zcoef, stream));
  PMESH_TRY(z_inverse(sBr, sBi, taB, tbB, zct, Ri, Kin, Kb, nullptr, outB,
                      zq, rows, Zm, n2, zcoef, stream));
  return 0;
}

// --- the dense pipeline ---------------------------------------------------

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zh): the dense z half-DFT
// by (wzr, wzi) (N2, Zh) into the scratch (sr, si) (n0, N1, Zh), then
// the dense y DFT by (wyr, wyi) (N1, N1).  Natural order throughout.
int pmesh_zy_fwd_half(const float* x, const float* wzr, const float* wzi,
                      const float* wyr, const float* wyi, float* outr,
                      float* outi, float* sr, float* si, int n0, int N1,
                      int N2, int Zh, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  ZFwdDense zop = {x, wzr, wzi, sr, si, N2, Zh};
  PMESH_TRY((launch_gemm<ZFwdDense, false, true, false>(
      zop, 1, 1, (long long)n0 * N1, Zh, N2, false, stream)));
  PMESH_TRY(dense_rows(sr, si, wyr, wyi, nullptr, nullptr, nullptr, nullptr,
                       nullptr, outr, outi, nullptr, nullptr, n0, N1, Zh, 1,
                       1.f, stream));
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
                  int n1, int W, float scale, void* stream_) {
  return (int)dense_rows(xr, xi, wr, wi, w2r, w2i, k2x, k2y, k2z, o1r, o1i,
                         o2r, o2i, 1, N0, (long long)n1 * W, W, scale,
                         (cudaStream_t)stream_);
}

// (xr, xi) (n0, N1, Zh) -> out (n0, N1, n2): the dense inverse y DFT by
// (wyr, wyi) (N1, N1) into the scratch (sr, si) (n0, N1, Zh), then
// z half -> real by the (Zh, n2) irfft pair (ta, tb).
int pmesh_zy_inv_half(const float* xr, const float* xi, const float* wyr,
                      const float* wyi, const float* ta, const float* tb,
                      float* out, float* sr, float* si, int n0, int N1,
                      int Zh, int n2, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  PMESH_TRY(dense_rows(xr, xi, wyr, wyi, nullptr, nullptr, nullptr, nullptr,
                       nullptr, sr, si, nullptr, nullptr, n0, N1, Zh, 1, 1.f,
                       stream));
  PMESH_TRY(z_inverse(sr, si, ta, tb, 0, 1, Zh, n2, nullptr, out, nullptr,
                      (long long)n0 * N1, Zh, n2, nullptr, stream));
  return 0;
}

// --- the first-CT half pipeline (fft_mxu_ref.py) --------------------------

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zh): the dense z half-DFT
// by (wzr, wzi) (N2, Zh) into the scratch (sr, si) (n0, N1, Zh), then
// the y CT by (wyr, wyi) (Ry, My, My) with ycoef b[r][j] of W_R^{-rj}.
// y leaves chunk-permuted; the z-Nyquist column stays at index Zh - 1.
int pmesh_zy_fwd_half_ct(const float* x, const float* wzr, const float* wzi,
                         const float* wyr, const float* wyi,
                         const float* ycoef, float* outr, float* outi,
                         float* sr, float* si, int n0, int N1, int N2,
                         int Zh, int Ry, int My, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  ZFwdDense zop = {x, wzr, wzi, sr, si, N2, Zh};
  PMESH_TRY((launch_gemm<ZFwdDense, false, true, false>(
      zop, 1, 1, (long long)n0 * N1, Zh, N2, false, stream)));
  return (int)y_forward(sr, si, wyr, wyi, ycoef, outr, outi, n0, N1, Zh, Ry,
                        My, stream);
}

}  // extern "C"
