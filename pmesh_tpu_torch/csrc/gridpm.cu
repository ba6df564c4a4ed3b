// Lattice shift-sum paint and readout for Hopper (sm_90a).
//
// Particles live on the mesh lattice: particle q sits at q + s(q), with
// the displacement s stored as three mesh-shaped arrays (cell
// units).  A window W of integer offsets v in [vmin, vmax]^3 (nv per
// axis) then gives
//
//   paint:   rho[p]  = sum_v m(p - v) * prod_d W_d(v_d - s_d(p - v))
//   readout: out[q]  = sum_v prod_d W_d(v_d - s_d(q)) * mesh[q + v]
//
// with periodic wrap on every axis.  W_d is the window kernel, or -W'
// on the derivative axis (``diffdir``).
//
// The x-halo slab form (a slab-sharded mesh, one slab per rank) reads
// an x extent of n0_in = lo + rows + hi input planes and writes rows =
// n0 output planes, with no wrap on x (y and z still wrap): input plane
// xbase + i is the plane of output row i, so the paint reads plane
// i + xbase - v_x of its displacements and mass, and the readout plane
// i + xbase + v_x of its meshes (the displacements and outputs have the
// output's n0 planes).  xbase < 0 selects the wrapped single-mesh form,
// whose arithmetic is unchanged.
//
// paint_lattice replaces pmesh_tpu/ops/gridpm_pallas.py paint_fused_ext
// (reached through paint_fused / paint_fused_parts); readout_lattice
// replaces readout_fused_ext (through readout_fused / readout_fused_parts).
// They compute what those kernels compute, not how: the TPU kernels roll
// whole x-planes held in VMEM; here a block of 256 threads owns a brick
// of output cells, a TY x TZ tile of y-z marching through xc planes of x
// (TZ = 32; TY = 8 for the readout, one (y, z) column per thread, and 16
// for the paint, two y rows per thread).
//
// What bounds them on this card.  The compulsory traffic is small (16
// bytes a cell for a paint, 20 for a one-mesh readout, 36 for three
// meshes), but each output sums nv^3 taps, each a product of three axis
// weights.  A thread per output that loads and weighs every tap itself
// re-reads each source 81 times and evaluates each axis weight nv^2 = 9
// times over at nv = 3 (9-13x its bytes on an H100).  Here every value
// crosses device memory into shared memory once per block, every axis
// weight is evaluated once, and the taps read shared memory only:
//
// - readout: a ring of nv + 1 mesh planes of the tile plus its halo,
//   (TY + nv - 1) x (TZ + nv - 1) per mesh, the periodic wrap taken by
//   the loader (once per staged value, not per tap).  Each particle
//   forms its 3 nv axis weights (and the 3 nv derivatives for 'all')
//   once, in registers, and sums the taps of 1 to 3 meshes from the
//   ring in one pass.  The plane after the next is fetched into
//   registers during a plane's taps; one slot more than the window
//   lets one barrier a plane suffice.
// - paint (gather form, no atomics: deterministic, as on the TPU): the
//   block walks its source planes from high x to low.  For each, every
//   source cell of the tile plus its halo forms its 3 nv axis weights
//   (and its mass) once, into a table in shared memory (double-buffered
//   where it fits); each thread then adds the plane's taps to the nv
//   output planes it feeds, kept as a register ring of accumulators, and
//   stores the one that is complete.  A source cell's x weights, z
//   weight and mass are loaded once for its nv x-offsets and both of
//   the thread's rows, which share nv - 1 of their nv + 1 source rows.
//
// Sums run in the compute type (f32; f64 for f64 storage) in one
// order for every output, whatever the tiling:
// v_x, then v_y, then v_z ascending, each tap ((W_x * W_y) * W_z) * m
// (paint; a mass mesh's product fused into the sum) or ((W_x * W_y) *
// W_z) * mesh (readout), the plain version's order (the paint walks x
// downwards so that each output meets its v_x in ascending order).
// Indices are wrapped modulo N for any offset, so offsets wider than
// the mesh are right; plane offsets are 64-bit.
//
// The window's nv is compiled in for nv = 2..5 (the hot shapes: nv = 3
// on the lattice main path, CIC in (-1, 1); nv = 4 on the binned paths,
// (-0.5, 1.5) and their drift bounds); any other nv up to NV_MAX = 12
// (GRID_LIMIT) runs the same kernel with nv read at run time (the f64
// kernels compile every width).  The host
// planner (ops/gridpm_cuda.plan) owns the launch's xc, the paint's table
// buffers and the shared bytes, which it counts from the layouts below
// (the readout's ring, the paint's tables); the entry points take them
// as given.
//
// Storage: f32, or bf16 (a bf16 state or mesh, as the TPU kernels take
// one through _cdtype, pmesh_tpu/ops/gridpm_pallas.py:91): every load is
// upcast to f32 (shared memory holds f32), the weights and sums are f32,
// and each output is rounded once at its store.  The f64 forms (the JAX
// package's f8 meshes, which reach its Pallas kernels too) have kernel
// bodies of their own, built as a library of their own: gridpm64.cu
// includes this file with GRIDPM_F64 defined, takes its helpers and its
// entry points, and defines the kernels those entry points launch
// (launch_paint64, launch_readout64), so that the two compile in
// parallel.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16_t;

// the compute type of a storage type: f32 for f32 and bf16, f64 for f64
template <class T>
struct Compute {
  typedef float type;
};
template <>
struct Compute<double> {
  typedef double type;
};

__device__ __forceinline__ float ld(const float* p, int64_t a) {
  return p[a];
}
__device__ __forceinline__ float ld(const bf16_t* p, int64_t a) {
  return __bfloat162float(p[a]);
}
__device__ __forceinline__ double ld(const double* p, int64_t a) {
  return p[a];
}
__device__ __forceinline__ void st(float* p, int64_t a, float v) {
  p[a] = v;
}
__device__ __forceinline__ void st(bf16_t* p, int64_t a, float v) {
  p[a] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(double* p, int64_t a, double v) {
  p[a] = v;
}

// the arithmetic both compute types share, with the roundings spelled out
__device__ __forceinline__ float cabs(float x) { return fabsf(x); }
__device__ __forceinline__ double cabs(double x) { return fabs(x); }
__device__ __forceinline__ float cfloor(float x) { return floorf(x); }
__device__ __forceinline__ double cfloor(double x) { return floor(x); }
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

enum WindowKind {
  W_NEAREST = 0,
  W_LINEAR = 1,
  W_QUADRATIC = 2,
  W_CUBIC = 3,
  W_TABLE = 4,         // table addressed by |x| (lanczos, acg)
  W_TABLE_OFFSET = 5,  // one-sided table addressed by x + offset (db, sym)
};

enum { DIFF_NONE = -1, DIFF_ALL = 3 };

// a tabulated window: values t[0..n), and d[i] = (t[i+1] - t[i]) / step
// taken in f64 on the host (a difference of f32 neighbours would lose
// about four digits), stored in the compute type C; sym: addressed by |x|
// (W_TABLE), else one-sided by x + offset (W_TABLE_OFFSET)
template <class C>
struct Table {
  const C* t;
  const C* d;
  int n;
  C step;
  C offset;
  bool sym;
};

// a mod n in [0, n) for any a; the remainder only off the fast path
__device__ __forceinline__ int wrap(int a, int n) {
  if ((unsigned)a < (unsigned)n) return a;
  int r = a % n;
  return r < 0 ? r + n : r;
}

template <class C>
__device__ __forceinline__ C table_kernel(C f, const Table<C>& tb,
                                          bool valid) {
  int i = (int)cfloor(f);
  C frac = f - (C)i;
  if (!valid || i < 0 || i >= tb.n - 1) return C(0);
  return tb.t[i] * (C(1) - frac) + tb.t[i + 1] * frac;
}

template <class C>
__device__ __forceinline__ C table_diff(int i, const Table<C>& tb) {
  if (i < 0 || i >= tb.n - 1) return C(0);
  return tb.d[i];
}

template <int K, class C>
__device__ __forceinline__ C wkernel(C x, const Table<C>& tb) {
  C ax = cabs(x);
  if (K == W_NEAREST) return (x < C(0.5) && x >= C(-0.5)) ? C(1) : C(0);
  if (K == W_LINEAR) return ax < C(1) ? C(1) - ax : C(0);
  if (K == W_QUADRATIC) {
    if (ax <= C(0.5)) return C(0.75) - ax * ax;
    C t = C(1.5) - ax;
    return ax < C(1.5) ? C(0.5) * t * t : C(0);
  }
  if (K == W_CUBIC) {
    C xx = ax * ax;
    if (ax < C(1)) return (C(4) - C(6) * xx + C(3) * xx * ax) / C(6);
    C t = C(2) - ax;
    return ax < C(2) ? t * t * t / C(6) : C(0);
  }
  // both tabulated kinds (one instance, W_TABLE)
  C f = (tb.sym ? ax : x + tb.offset) / tb.step;
  return table_kernel(f, tb, tb.sym || f >= C(0));
}

// dW/dx
template <int K, class C>
__device__ __forceinline__ C wdiff(C x, const Table<C>& tb) {
  C ax = cabs(x);
  if (K == W_NEAREST) return C(0);
  if (K == W_LINEAR) {
    if (ax >= C(1)) return C(0);
    return x > C(0) ? C(-1) : (x < C(0) ? C(1) : C(0));
  }
  C factor = x < C(0) ? C(-1) : C(1);
  if (K == W_QUADRATIC) {
    if (ax <= C(0.5)) return factor * (C(-2) * ax);
    return ax < C(1.5) ? factor * -(C(1.5) - ax) : C(0);
  }
  if (K == W_CUBIC) {
    C xx = ax * ax;
    if (ax < C(1)) return factor * ((C(-12) * ax + C(9) * xx) / C(6));
    C t = C(2) - ax;
    return ax < C(2) ? factor * (C(-0.5) * t * t) : C(0);
  }
  C d = table_diff((int)((tb.sym ? ax : x + tb.offset) / tb.step), tb);
  return tb.sym ? (x >= C(0) ? C(1) : C(-1)) * d : d;
}

// weight of integer offset v for displacement s along one axis; the
// derivative axis takes -W'(v - s), which is +d/ds of the interpolation
template <int K, class C>
__device__ __forceinline__ C axis_w(int v, C s, bool diff,
                                    const Table<C>& tb) {
  C x = (C)v - s;
  return diff ? -wdiff<K>(x, tb) : wkernel<K>(x, tb);
}

// the tiles: kThreads threads in TROWS rows of TZ consecutive z cells (a
// warp is one row); the readout's tile has one y row per thread row
// (TY_READOUT x TZ), the paint's RY (TY_PAINT x TZ).  NV_MAX: the widest
// window GRID_LIMIT (12^3 offsets) lets through; NV_ANY: the instance
// that reads nv at run time
constexpr int TZ = 32, kThreads = 256, TROWS = kThreads / TZ, RY = 2;
constexpr int TY_READOUT = TROWS, TY_PAINT = TROWS * RY;
constexpr int NV_MAX = 12, NV_ANY = 0;
// readout modes: 1 to 3 meshes, or the three derivative readouts of one
constexpr int MODE_ALL = 4;

struct Geo {
  int n0, n1, n2;  // output planes, plane shape
  int xbase;       // < 0: x wraps modulo n0; else the x-halo input base
  int vmin, nv;    // the offsets vmin .. vmin + nv - 1 on each axis
  int xc;          // output planes per block
};

// offset of input plane p (in output x coordinates)
__device__ __forceinline__ int64_t plane_at(int p, const Geo& g) {
  int x = g.xbase < 0 ? wrap(p, g.n0) : p + g.xbase;
  return (int64_t)x * g.n1 * g.n2;
}

template <int K, int NVA, class C>
__device__ __forceinline__ void fill_weights(C (&w)[NVA], int nv, int vmin,
                                             C s, bool diff,
                                             const Table<C>& tb) {
#pragma unroll
  for (int a = 0; a < NVA; ++a)
    if (a < nv) w[a] = axis_w<K>(vmin + a, s, diff, tb);
}

// the nv axis weights w[a] of offsets vmin + a for displacement s
template <int NVA, class C>
__device__ __forceinline__ void axis_weights(C (&w)[NVA], int nv, int vmin,
                                             C s, bool diff, int kind,
                                             const Table<C>& tb) {
  switch (kind) {
    case W_NEAREST:
      fill_weights<W_NEAREST>(w, nv, vmin, s, diff, tb);
      break;
    case W_LINEAR:
      fill_weights<W_LINEAR>(w, nv, vmin, s, diff, tb);
      break;
    case W_QUADRATIC:
      fill_weights<W_QUADRATIC>(w, nv, vmin, s, diff, tb);
      break;
    case W_CUBIC:
      fill_weights<W_CUBIC>(w, nv, vmin, s, diff, tb);
      break;
    default:  // W_TABLE, W_TABLE_OFFSET
      fill_weights<W_TABLE>(w, nv, vmin, s, diff, tb);
      break;
  }
}

// cells of the staged region (TY + nv - 1 rows of szw = TZ + nv - 1,
// corner (y0, z0)) that this thread loads: cell threadIdx.x + r kThreads,
// its wrapped offset within a plane, or -1 past the region
template <int PER>
__device__ __forceinline__ void region_offsets(int (&off)[PER], int area,
                                               int szw, int y0, int z0,
                                               const Geo& g) {
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    int e = threadIdx.x + r * kThreads;
    int yy = e / szw, zz = e - yy * szw;
    off[r] = e < area ? wrap(y0 + yy, g.n1) * g.n2 + wrap(z0 + zz, g.n2)
                      : -1;
  }
}

// load the staged cells of plane `base` of arrays src[0 .. NS) into
// registers
template <int NS, int PER, class T, class C>
__device__ __forceinline__ void fetch(C (&pre)[NS][PER], const T* const* src,
                                      const int (&off)[PER], int64_t base) {
#pragma unroll
  for (int m = 0; m < NS; ++m)
#pragma unroll
    for (int r = 0; r < PER; ++r)
      pre[m][r] = off[r] >= 0 ? ld(src[m], base + off[r]) : C(0);
}

// the readout: one thread per particle column (j, k) of the tile, through
// output planes x0 .. x1 - 1; MODE meshes m0.. into o0.., or (MODE_ALL)
// the three derivative readouts of m0.  T: the storage of meshes,
// displacements and outputs, C its compute type.  Dynamic shared memory:
// (nv + 1) slots of NM meshes of the staged region, C.
template <int NV, int MODE, class T>
__global__ void __launch_bounds__(kThreads) readout_staged(
    const T* __restrict__ m0, const T* __restrict__ m1,
    const T* __restrict__ m2, const T* __restrict__ sx,
    const T* __restrict__ sy, const T* __restrict__ sz,
    T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2, Geo g,
    int diffdir, int kind, Table<typename Compute<T>::type> tb) {
  typedef typename Compute<T>::type C;
  constexpr int TZC = TZ, TYR = TY_READOUT;
  constexpr bool ALL = MODE == MODE_ALL;
  constexpr int NM = ALL ? 1 : MODE;
  constexpr int NVA = NV == NV_ANY ? NV_MAX : NV;
  constexpr int PER =  // staged cells per thread
      ((TYR + NVA - 1) * (TZC + NVA - 1) + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* ring = reinterpret_cast<C*>(smem_raw);
  const int nv = NV == NV_ANY ? g.nv : NV;
  const int vmin = g.vmin, vmax = vmin + nv - 1, depth = nv + 1;
  const int szw = TZC + nv - 1, area = (TYR + nv - 1) * szw;
  const int slot_size = NM * area;
  const int ty = threadIdx.x / TZC, tz = threadIdx.x % TZC;
  const int j = blockIdx.y * TYR + ty, k = blockIdx.x * TZC + tz;
  const int x0 = blockIdx.z * g.xc, x1 = min(x0 + g.xc, g.n0);
  const bool live = j < g.n1 && k < g.n2;
  const T* const mesh[3] = {m0, m1, m2};
  const int64_t pstride = (int64_t)g.n1 * g.n2;

  int off[PER];
  region_offsets(off, area, szw, blockIdx.y * TYR + vmin,
                 blockIdx.x * TZC + vmin, g);
  C pre[NM][PER];
  // slots 0 .. nv - 2: mesh planes x0 + vmin .. x0 + vmax - 1
  for (int t = 0; t + 1 < nv; ++t) {
    fetch(pre, mesh, off, plane_at(x0 + vmin + t, g));
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int r = 0; r < PER; ++r)
        if (off[r] >= 0)
          ring[t * slot_size + m * area + threadIdx.x + r * kThreads] =
              pre[m][r];
  }
  fetch(pre, mesh, off, plane_at(x0 + vmax, g));
  int64_t q = (int64_t)x0 * pstride + (int64_t)j * g.n2 + k;
  C d0 = C(0), d1 = C(0), d2 = C(0);
  if (live) {
    d0 = ld(sx, q);
    d1 = ld(sy, q);
    d2 = ld(sz, q);
  }
  // head: the slot of mesh plane i + vmin; tail: the slot that takes
  // plane i + vmax
  int head = 0, tail = nv - 1;
  for (int i = x0; i < x1; ++i, q += pstride) {
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int r = 0; r < PER; ++r)
        if (off[r] >= 0)
          ring[tail * slot_size + m * area + threadIdx.x + r * kThreads] =
              pre[m][r];
    tail = tail + 1 == depth ? 0 : tail + 1;
    __syncthreads();
    const C s0 = d0, s1 = d1, s2 = d2;
    if (i + 1 < x1) {
      fetch(pre, mesh, off, plane_at(i + 1 + vmax, g));
      if (live) {
        d0 = ld(sx, q + pstride);
        d1 = ld(sy, q + pstride);
        d2 = ld(sz, q + pstride);
      }
    }
    if (live) {
      C kx[NVA], ky[NVA], kz[NVA];
      axis_weights(kx, nv, vmin, s0, diffdir == 0, kind, tb);
      axis_weights(ky, nv, vmin, s1, diffdir == 1, kind, tb);
      axis_weights(kz, nv, vmin, s2, diffdir == 2, kind, tb);
      C kxd[ALL ? NVA : 1], kyd[ALL ? NVA : 1], kzd[ALL ? NVA : 1];
      if constexpr (ALL) {
        axis_weights(kxd, nv, vmin, s0, true, kind, tb);
        axis_weights(kyd, nv, vmin, s1, true, kind, tb);
        axis_weights(kzd, nv, vmin, s2, true, kind, tb);
      }
      C a0 = C(0), a1 = C(0), a2 = C(0);
#pragma unroll
      for (int a = 0; a < nv; ++a) {
        const int slot = head + a < depth ? head + a : head + a - depth;
        const C* plane = ring + slot * slot_size + ty * szw + tz;
#pragma unroll
        for (int b = 0; b < nv; ++b) {
          const C* row = plane + b * szw;
#pragma unroll
          for (int c = 0; c < nv; ++c) {
            if constexpr (ALL) {
              C v = row[c];
              a0 += (kxd[a] * ky[b]) * kz[c] * v;
              a1 += (kx[a] * kyd[b]) * kz[c] * v;
              a2 += (kx[a] * ky[b]) * kzd[c] * v;
            } else {
              C w = (kx[a] * ky[b]) * kz[c];
              a0 += w * row[c];
              if (NM > 1) a1 += w * row[area + c];
              if (NM > 2) a2 += w * row[2 * area + c];
            }
          }
        }
      }
      st(o0, q, a0);
      if (ALL || NM > 1) st(o1, q, a1);
      if (ALL || NM > 2) st(o2, q, a2);
    }
    head = head + 1 == depth ? 0 : head + 1;
  }
}

// the paint: each thread paints RY output columns (j, k), j = j0 + RY ty
// + r.  The block walks source planes s = x1 - 1 - vmin down to x0 -
// vmax; acc[r][a] holds output plane s + vmin + a of row r, which plane
// s feeds with v_x = vmin + a.  After plane s, output plane s + vmax
// (acc[r][nv - 1]) has all its taps.  Dynamic shared memory: nbuf tables
// of the staged region's weights, [3 nv (+ 1 mass)][area] C.  A source
// cell's x weights, z weight and mass serve every one of the thread's
// rows that it reaches: row t of the thread's window is v_y = vmin + nv
// - 1 + r - t of row r; the rows are walked from t = nv + RY - 2 down, so
// that each output meets its v_y in ascending order.
template <int NV, bool MASS, class T>
__global__ void __launch_bounds__(kThreads) paint_staged(
    const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ sz, const T* __restrict__ mass,
    typename Compute<T>::type scalar_mass, T* __restrict__ out, Geo g,
    int diffdir, int kind, Table<typename Compute<T>::type> tb, int nbuf) {
  typedef typename Compute<T>::type C;
  constexpr int TZC = TZ, TYP = TY_PAINT, RYC = RY;
  constexpr int NS = MASS ? 4 : 3;
  constexpr int NVA = NV == NV_ANY ? NV_MAX : NV;
  constexpr int PER =  // staged cells per thread
      ((TYP + NVA - 1) * (TZC + NVA - 1) + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* table = reinterpret_cast<C*>(smem_raw);
  const int nv = NV == NV_ANY ? g.nv : NV;
  const int vmin = g.vmin, vmax = vmin + nv - 1;
  const int szw = TZC + nv - 1, area = (TYP + nv - 1) * szw;
  const int tab_size = (3 * nv + (MASS ? 1 : 0)) * area;
  const int ty = threadIdx.x / TZC, tz = threadIdx.x % TZC;
  const int j = blockIdx.y * TYP + ty * RYC, k = blockIdx.x * TZC + tz;
  const int x0 = blockIdx.z * g.xc, x1 = min(x0 + g.xc, g.n0);
  bool live[RYC];
#pragma unroll
  for (int r = 0; r < RYC; ++r) live[r] = j + r < g.n1 && k < g.n2;
  const T* const src[4] = {sx, sy, sz, mass};

  int off[PER];
  region_offsets(off, area, szw, blockIdx.y * TYP - vmax,
                 blockIdx.x * TZC - vmax, g);
  C pre[NS][PER];
  const int s_hi = x1 - 1 - vmin, count = x1 - x0 + nv - 1;
  fetch(pre, src, off, plane_at(s_hi, g));
  C acc[RYC][NVA];
#pragma unroll
  for (int r = 0; r < RYC; ++r)
#pragma unroll
    for (int a = 0; a < NVA; ++a) acc[r][a] = C(0);
  // the thread's cell of window row t, v_z = vmin: offset v_z = vmin + c
  // is c cells before it
  const int cell0 = ty * RYC * szw + tz + nv - 1;
  int buf = 0;
  for (int it = 0; it < count; ++it) {
    const int s = s_hi - it;
    C* tab = table + buf * tab_size;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      if (off[r] < 0) continue;
      const int e = threadIdx.x + r * kThreads;
      C w[NVA];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        axis_weights(w, nv, vmin, pre[d][r], diffdir == d, kind, tb);
#pragma unroll
        for (int a = 0; a < nv; ++a) tab[(d * nv + a) * area + e] = w[a];
      }
      if (MASS) tab[3 * nv * area + e] = pre[NS - 1][r];
    }
    __syncthreads();
    if (it + 1 < count) fetch(pre, src, off, plane_at(s - 1, g));
#pragma unroll
    for (int t = nv + RYC - 2; t >= 0; --t) {
#pragma unroll
      for (int c = 0; c < nv; ++c) {
        const int cell = cell0 + t * szw - c;
        const C wz = tab[(2 * nv + c) * area + cell];
        const C m = MASS ? tab[3 * nv * area + cell] : C(1);
        C wx[NVA];
#pragma unroll
        for (int a = 0; a < nv; ++a) wx[a] = tab[a * area + cell];
#pragma unroll
        for (int r = 0; r < RYC; ++r) {
          const int b = nv - 1 + r - t;
          if (b < 0 || b >= nv) continue;
          const C wy = tab[(nv + b) * area + cell];
#pragma unroll
          for (int a = 0; a < nv; ++a) {
            // the roundings are spelled out, so the sum does not
            // depend on the compiler's choice: the z product rounded
            // apart, the mass product fused into the accumulate
            const C w = mul_rn(wx[a] * wy, wz);
            if (MASS)
              acc[r][a] = fma_rn(w, m, acc[r][a]);
            else
              acc[r][a] += w;
          }
        }
      }
    }
    const int o = s + vmax;
#pragma unroll
    for (int r = 0; r < RYC; ++r) {
      if (live[r] && o >= x0 && o < x1)
        st(out, ((int64_t)o * g.n1 + j + r) * g.n2 + k,
           acc[r][nv - 1] * scalar_mass);
#pragma unroll
      for (int a = nv - 1; a > 0; --a) acc[r][a] = acc[r][a - 1];
      acc[r][0] = C(0);
    }
    if (nbuf == 1)
      __syncthreads();
    else
      buf ^= 1;
  }
}

dim3 grid_of(const Geo& g, int ty, int tz) {
  return dim3((g.n2 + tz - 1) / tz, (g.n1 + ty - 1) / ty,
              (g.n0 + g.xc - 1) / g.xc);
}

// above the 48 KB a block gets by default, a kernel must ask for more
template <class F>
cudaError_t allow_smem(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// what an entry point hands every launch of storage T
template <class T>
struct Launch {
  typedef typename Compute<T>::type C;
  Geo g;
  int diffdir, kind;
  Table<C> tb;
  size_t smem;
  cudaStream_t stream;
};

template <int NV, bool MASS, class T>
cudaError_t launch_paint_t(const void* sx, const void* sy, const void* sz,
                           const void* mass, double scalar_mass, void* out,
                           const Launch<T>& L, int nbuf) {
  typedef typename Compute<T>::type C;
  cudaError_t err = allow_smem(paint_staged<NV, MASS, T>, L.smem);
  if (err != cudaSuccess) return err;
  paint_staged<NV, MASS, T><<<grid_of(L.g, TY_PAINT, TZ),
                              kThreads, L.smem, L.stream>>>(
      (const T*)sx, (const T*)sy, (const T*)sz, (const T*)mass,
      (C)scalar_mass, (T*)out, L.g, L.diffdir, L.kind, L.tb, nbuf);
  return cudaSuccess;
}

template <int NV, class T>
cudaError_t launch_paint_m(const void* sx, const void* sy, const void* sz,
                           const void* mass, double scalar_mass, void* out,
                           const Launch<T>& L, int nbuf) {
  if (mass != nullptr)
    return launch_paint_t<NV, true, T>(sx, sy, sz, mass, scalar_mass, out, L,
                                       nbuf);
  return launch_paint_t<NV, false, T>(sx, sy, sz, mass, scalar_mass, out, L,
                                      nbuf);
}

template <class T>
cudaError_t launch_paint(const void* sx, const void* sy, const void* sz,
                         const void* mass, double scalar_mass, void* out,
                         const Launch<T>& L, int nbuf) {
  switch (L.g.nv) {
#define PAINT_NV(NV)                                                       \
  case NV:                                                                 \
    return launch_paint_m<NV, T>(sx, sy, sz, mass, scalar_mass, out, L,    \
                                 nbuf);
    PAINT_NV(2)
    PAINT_NV(3)
    PAINT_NV(4)
    PAINT_NV(5)
#undef PAINT_NV
    default:
      return launch_paint_m<NV_ANY, T>(sx, sy, sz, mass, scalar_mass, out, L,
                                       nbuf);
  }
}

template <int NV, int MODE, class T>
cudaError_t launch_readout_t(const void* const* m, const void* sx,
                             const void* sy, const void* sz, void* const* o,
                             const Launch<T>& L) {
  typedef typename Compute<T>::type C;
  cudaError_t err = allow_smem(readout_staged<NV, MODE, T>, L.smem);
  if (err != cudaSuccess) return err;
  dim3 grid = grid_of(L.g, TY_READOUT, TZ);
  readout_staged<NV, MODE, T><<<grid, kThreads, L.smem, L.stream>>>(
      (const T*)m[0], (const T*)m[1], (const T*)m[2], (const T*)sx,
      (const T*)sy, (const T*)sz, (T*)o[0], (T*)o[1], (T*)o[2], L.g,
      L.diffdir, L.kind, L.tb);
  return cudaSuccess;
}

template <int NV, class T>
cudaError_t launch_readout_m(const void* const* m, int mode, const void* sx,
                             const void* sy, const void* sz, void* const* o,
                             const Launch<T>& L) {
  switch (mode) {
#define READOUT_MODE(MODE) \
  case MODE:               \
    return launch_readout_t<NV, MODE, T>(m, sx, sy, sz, o, L);
    READOUT_MODE(1)
    READOUT_MODE(2)
    READOUT_MODE(3)
    READOUT_MODE(MODE_ALL)
#undef READOUT_MODE
    default:
      return cudaErrorInvalidValue;
  }
}

template <class T>
cudaError_t launch_readout(const void* const* m, int mode, const void* sx,
                           const void* sy, const void* sz, void* const* o,
                           const Launch<T>& L) {
  switch (L.g.nv) {
#define READOUT_NV(NV) \
  case NV:             \
    return launch_readout_m<NV, T>(m, mode, sx, sy, sz, o, L);
    READOUT_NV(2)
    READOUT_NV(3)
    READOUT_NV(4)
    READOUT_NV(5)
#undef READOUT_NV
    default:
      return launch_readout_m<NV_ANY, T>(m, mode, sx, sy, sz, o, L);
  }
}

// the checks both entry points share: the window, xc and the grid
bool valid_geo(const Geo& g, int kind) {
  return kind >= W_NEAREST && kind <= W_TABLE_OFFSET && g.nv >= 1 &&
         g.nv <= NV_MAX && g.xc >= 1 && g.n0 >= 1 && g.n1 >= 1 &&
         g.n2 >= 1 && (int64_t)g.n1 * g.n2 <= INT32_MAX &&
         (g.n1 + TY_READOUT - 1) / TY_READOUT <= 65535 &&
         (g.n0 + g.xc - 1) / g.xc <= 65535;
}

// the storage codes of the entry points; this library takes f32 and bf16,
// or with GRIDPM_F64 (gridpm64.cu) f64 alone
enum { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };

template <class T>
Launch<T> launch_of(const Geo& g, int diffdir, int kind, const void* table,
                    int ntable, double step, double offset, long long smem,
                    void* stream) {
  typedef typename Compute<T>::type C;
  const C* t = (const C*)table;
  return Launch<T>{g,
                   diffdir,
                   kind,
                   Table<C>{t, t + ntable, ntable, (C)step, (C)offset,
                            kind == W_TABLE},
                   (size_t)smem,
                   (cudaStream_t)stream};
}

#ifdef GRIDPM_F64
// the f64 launches, defined by gridpm64.cu after this file
cudaError_t launch_paint64(const void* sx, const void* sy, const void* sz,
                           const void* mass, double scalar_mass, void* out,
                           const Launch<double>& L, int nbuf);
cudaError_t launch_readout64(const void* const* m, int mode, const void* sx,
                             const void* sy, const void* sz, void* const* o,
                             const Launch<double>& L);
#endif

}  // namespace

extern "C" {

const char* pmesh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// kind: WindowKind; diffdir: -1 none or the derivative axis 0, 1, 2;
// mass: a mesh, or NULL for the scalar scalar_mass; table (tabulated
// kinds only): 2 * ntable values of the compute type (f64 for f64
// storage, else f32), the values then the differences / step; xbase >=
// 0: the x-halo slab form, displacements and mass of n0_in planes (every
// plane i + xbase - v_x must lie in [0, n0_in)); dtype: the storage of
// the displacements, the mass mesh and the output (DT_F32, DT_BF16 or
// DT_F64); xc, nbuf, smem: the host's plan (planes per block, table
// buffers, dynamic shared bytes)
int pmesh_paint_lattice(const void* sx, const void* sy, const void* sz,
                        const void* mass, double scalar_mass, void* out,
                        int n0, int n1, int n2, int n0_in, int xbase,
                        int vmin, int vmax, int kind, int diffdir,
                        const void* table, int ntable, double step,
                        double offset, int dtype, int xc, int nbuf,
                        long long smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Geo g{n0, n1, n2, xbase, vmin, vmax - vmin + 1, xc};
  if (diffdir < DIFF_NONE || diffdir > 2 || !valid_geo(g, kind) ||
      (nbuf != 1 && nbuf != 2))
    return (int)cudaErrorInvalidValue;
  if (xbase >= 0 && (xbase - vmax < 0 || n0 - 1 + xbase - vmin >= n0_in))
    return (int)cudaErrorInvalidValue;
#ifdef GRIDPM_F64
  if (dtype != DT_F64) return (int)cudaErrorInvalidValue;
  err = launch_paint64(
      sx, sy, sz, mass, scalar_mass, out,
      launch_of<double>(g, diffdir, kind, table, ntable, step, offset, smem,
                        stream),
      nbuf);
#else
  if (dtype == DT_BF16)
    err = launch_paint<bf16_t>(
        sx, sy, sz, mass, scalar_mass, out,
        launch_of<bf16_t>(g, diffdir, kind, table, ntable, step, offset,
                          smem, stream),
        nbuf);
  else if (dtype == DT_F32)
    err = launch_paint<float>(
        sx, sy, sz, mass, scalar_mass, out,
        launch_of<float>(g, diffdir, kind, table, ntable, step, offset, smem,
                         stream),
        nbuf);
  else
    return (int)cudaErrorInvalidValue;
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// nmesh in 1..3 meshes m0..m2 into o0..o2; diffdir 3 ('all') reads m0
// into the three derivative outputs o0..o2; xbase >= 0: the x-halo slab
// form, meshes of n0_in planes (every plane i + xbase + v_x must lie in
// [0, n0_in)); dtype: the storage of meshes, displacements and outputs,
// and table, as pmesh_paint_lattice's; xc, smem: the host's plan
int pmesh_readout_lattice(const void* m0, const void* m1, const void* m2,
                          int nmesh, const void* sx, const void* sy,
                          const void* sz, void* o0, void* o1, void* o2,
                          int n0, int n1, int n2, int n0_in, int xbase,
                          int vmin, int vmax, int kind, int diffdir,
                          const void* table, int ntable, double step,
                          double offset, int dtype, int xc, long long smem,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Geo g{n0, n1, n2, xbase, vmin, vmax - vmin + 1, xc};
  if (diffdir < DIFF_NONE || diffdir > DIFF_ALL || nmesh < 1 || nmesh > 3 ||
      (diffdir == DIFF_ALL && nmesh != 1) || !valid_geo(g, kind))
    return (int)cudaErrorInvalidValue;
  if (xbase >= 0 && (xbase + vmin < 0 || n0 - 1 + xbase + vmax >= n0_in))
    return (int)cudaErrorInvalidValue;
  const void* m[3] = {m0, m1, m2};
  void* o[3] = {o0, o1, o2};
  int mode = diffdir == DIFF_ALL ? MODE_ALL : nmesh;
#ifdef GRIDPM_F64
  if (dtype != DT_F64) return (int)cudaErrorInvalidValue;
  err = launch_readout64(
      m, mode, sx, sy, sz, o,
      launch_of<double>(g, diffdir, kind, table, ntable, step, offset, smem,
                        stream));
#else
  if (dtype == DT_BF16)
    err = launch_readout<bf16_t>(
        m, mode, sx, sy, sz, o,
        launch_of<bf16_t>(g, diffdir, kind, table, ntable, step, offset,
                          smem, stream));
  else if (dtype == DT_F32)
    err = launch_readout<float>(
        m, mode, sx, sy, sz, o,
        launch_of<float>(g, diffdir, kind, table, ntable, step, offset, smem,
                         stream));
  else
    return (int)cudaErrorInvalidValue;
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
