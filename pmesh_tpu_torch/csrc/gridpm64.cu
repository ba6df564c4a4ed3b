// The f64 forms of the lattice paint and readout, and their x-halo slab
// forms: the counterparts on f8 meshes of
// pmesh_tpu/ops/gridpm_pallas.py:491 paint_fused_ext, :410
// paint_fused_parts, :171 readout_fused_ext and :347 readout_fused_parts
// (the JAX package takes its Pallas kernels for a 3-d mesh of any dtype,
// pmesh_tpu/ops/gridpm.py:172).  They compute what gridpm.cu's kernels
// compute (its header says what), in f64 throughout: the window table,
// the axis weights, the staged values and the sums, in the same order
// for every output whatever the tiling (v_x, then v_y, then v_z
// ascending, each tap ((W_x * W_y) * W_z) * value, the roundings spelled
// out: mul_rn for each product, a readout's mesh value or a paint's mass
// fused into the accumulate by fma_rn).  This file includes gridpm.cu for
// its helpers (Table, axis_w, region_offsets, fetch, mul_rn, fma_rn, the
// geometry) and its entry points, which launch the kernels defined here
// for f64 storage, so the f64 library compiles in parallel with the f32
// and bf16 one.
//
// What bounds them on this card.  The shared-memory pipe (about 128
// bytes a clock per SM), then the FP64 units (half the f32 rate, 34
// TFLOP/s).  A thread that owns one output reads one 8-byte staged value
// per tap and mesh (the readout: nv^3 NM values an output) or three axis
// weights and a mass per source cell for nv taps (the paint), more bytes
// of shared memory than of device memory past nv = 2.  Here each thread
// owns a register block of RY consecutive y rows of one z column, and
// every shared read serves each of those rows that it reaches:
//
// - readout: for each v_x, row t of the thread's window (RY + nv - 1
//   staged rows of nv cells; row r of the block reads t = r + v_y - vmin)
//   is read once per mesh and cell, and each value is applied to every
//   row r whose window covers it: (RY + nv - 1) nv reads per mesh for
//   RY nv^2 taps.  The ring of nv + 1 mesh planes of the tile plus its
//   nv - 1 halo is filled by asynchronous copies (cp.async) one plane
//   ahead, so no register holds a staged value in flight.  Each row's
//   weights (and derivatives for 'all') are formed once a plane, the x
//   ones once per v_x past nv = 5.
// - paint (gather form, no atomics, deterministic, as on the TPU): the
//   table of every source cell's 3 nv axis weights (and its mass) of a
//   source plane, as gridpm.cu's.  Up to nv = 4 a thread paints RY = 2
//   rows of one z cell: a source cell's nv x weights, its z weight and
//   mass are read once for the rows it feeds, each row's y weight once,
//   and each of those feeds nv taps.  From nv = 5 to 9 it paints RZ = 2
//   consecutive z cells of one row: the two cells' weights come in one
//   16-byte load each, a cell's x weights, mass and z weights are read
//   once for both outputs, and each (x, y) product serves both.
//
// Every width 1..NV_MAX is compiled in, and every per-thread array is
// indexed by compile-time values only (the loops over them are
// unrolled), so none goes to local memory at any width.  RY by width
// (ROWS64_*) and each instance's launch bound (blocks64) were chosen
// from ptxas's report and the timings of tools/time_lattice_kernels.py
// on an H100: the registers fit the blocks that the ring or the table
// lets an SM run, with no spill, and the shared bytes fit SMEM_LIMIT at
// every width; ops/gridpm_cuda.plan counts them from the same layouts
// and constants.  The shared reads per output: the three-mesh readout
// nv^2 (RY + nv - 1) NM / RY 8-byte values (432 B at nv = 3, RY = 2,
// against 648 one output a thread), the paint with a mass mesh
// [(RY + nv - 1) nv (nv + 2) + RY nv^2] / RY 8-byte values at RY = 2
// (312 B at nv = 3, against 432), nv [(nv + 1) (nv + 2) / 2 + 3 (nv +
// 1) / 2 - 2] / 2 16-byte loads at RZ = 2 and odd nv (2576 B at nv =
// 7, against 3920; at nv = 5 1120 B against 1040 at RY = 2, but half the
// load instructions, and faster).
#define GRIDPM_F64 1
#include "gridpm.cu"

namespace {

// the f64 tile: kThreads threads in TROWS64 rows of TZ64 (a half warp),
// each thread RY consecutive y rows of RZ consecutive z cells (RZ = 1
// but in the paint): TROWS64 * RY rows x TZ64 * RZ cells
constexpr int TZ64 = 16, TROWS64 = kThreads / TZ64;
// RY by nv (entry nv - 1): the readout of one to three meshes, the
// readout of 'all' (two weight sets a row), the paint
#define ROWS64_READOUT {2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1}
#define ROWS64_READOUT_ALL {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}
#define ROWS64_PAINT {2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1}
// the paint's RZ by nv: consecutive z cells a thread paints (1 or 2)
#define ZCELLS64_PAINT {1, 1, 1, 1, 2, 2, 2, 2, 2, 1, 1, 1}
enum { R64_READOUT = 0, R64_READOUT_ALL = 1, R64_PAINT = 2 };
// the widths this library compiles: 1..5, or (gridpm64w.cu, which
// defines GRIDPM64_WIDE) 6..NV_MAX, so that the two build in parallel
#ifdef GRIDPM64_WIDE
#define GRIDPM64_WIDTHS(X) X(6) X(7) X(8) X(9) X(10) X(11) X(12)
#else
#define GRIDPM64_WIDTHS(X) X(1) X(2) X(3) X(4) X(5)
#endif

__host__ __device__ constexpr int rows64(int which, int nv) {
  constexpr int rows[3][NV_MAX] = {ROWS64_READOUT, ROWS64_READOUT_ALL,
                                   ROWS64_PAINT};
  return rows[which][nv - 1];
}

__host__ __device__ constexpr int zcells64(int nv) {
  constexpr int cells[NV_MAX] = ZCELLS64_PAINT;
  return cells[nv - 1];
}

// the staged region of a tile of TY rows and TZ64 rz cells: TY + nv - 1
// rows of TZ64 rz + nv - 1 cells, rounded up to whole rz (so that a
// thread's rz cells load in one 16-byte load where rz = 2)
__host__ __device__ constexpr int width64(int nv, int rz) {
  return (TZ64 * rz + nv - 1 + rz - 1) / rz * rz;
}
__host__ __device__ constexpr int area64(int ty, int nv, int rz = 1) {
  return (ty + nv - 1) * width64(nv, rz);
}

// the blocks an SM holds by its 228 KB of shared memory (1 KB of it per
// block for the system), at most `cap`: each instance is built for that
// occupancy (__launch_bounds__), so that ptxas fits its registers to the
// blocks it can run, and spills nothing (ptxas left to itself aims at
// occupancy it cannot have and spills to reach it).  The caps, from
// ptxas's report at each width: the paint 3; the readout 3 up to nv = 3
// (2 for three meshes), 2 to nv = 7, 1 beyond
__host__ __device__ constexpr int blocks64(int smem, int cap) {
  return 233472 / (smem + 1024) < cap ? 233472 / (smem + 1024) : cap;
}
__host__ __device__ constexpr int readout_cap64(int nv, int mode) {
  return nv > 7 ? 1 : nv <= 3 && mode != 3 ? 3 : 2;
}
// the dynamic shared bytes of an instance: the readout's ring of nv + 1
// slots of NM meshes; the paint's one table of 3 nv weights (and the
// mass) per staged cell (ops/gridpm_cuda.plan counts the same)
__host__ __device__ constexpr int readout_smem64(int nv, int mode) {
  return (nv + 1) * (mode == MODE_ALL ? 1 : mode) * 8 *
         area64(TROWS64 * rows64(mode == MODE_ALL ? R64_READOUT_ALL
                                                  : R64_READOUT, nv),
                nv);
}
__host__ __device__ constexpr int paint_smem64(int nv, bool mass) {
  return (3 * nv + (mass ? 1 : 0)) * 8 *
         area64(TROWS64 * rows64(R64_PAINT, nv), nv, zcells64(nv));
}
#define READOUT_BOUNDS64(NV, MODE)                          \
  __launch_bounds__(kThreads,                               \
                    blocks64(readout_smem64(NV, MODE),      \
                             readout_cap64(NV, MODE)))
#define PAINT_BOUNDS64(NV, MASS) \
  __launch_bounds__(kThreads, blocks64(paint_smem64(NV, MASS), 3))

// an asynchronous copy of one f64 value from device to shared memory
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the weight of offset v for displacement s along one axis, the window
// kind read at run time
__device__ __forceinline__ double weight64(int kind, int v, double s,
                                           bool diff,
                                           const Table<double>& tb) {
  switch (kind) {
    case W_NEAREST:
      return axis_w<W_NEAREST>(v, s, diff, tb);
    case W_LINEAR:
      return axis_w<W_LINEAR>(v, s, diff, tb);
    case W_QUADRATIC:
      return axis_w<W_QUADRATIC>(v, s, diff, tb);
    case W_CUBIC:
      return axis_w<W_CUBIC>(v, s, diff, tb);
    default:  // W_TABLE, W_TABLE_OFFSET
      return axis_w<W_TABLE>(v, s, diff, tb);
  }
}

// stage mesh plane `base` of meshes 0 .. NM into the ring slot at dst
// (this thread's cells: dst + m * area + r * kThreads)
template <int NM, int PER>
__device__ __forceinline__ void stage64(double* dst,
                                        const double* const (&mesh)[3],
                                        const int (&off)[PER], int64_t base,
                                        int area) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int r = 0; r < PER; ++r)
      if (off[r] >= 0)
        cp_async8(dst + m * area + r * kThreads, mesh[m] + base + off[r]);
  cp_async_commit();
}

// the taps of one v_x (mesh plane `win` of the ring at the thread's
// window) for the thread's RY rows, whose x weights are wx (wxd, the
// derivatives, for 'all'): for each staged row t and cell c, the value
// read once per mesh and applied to every row r that reads it (v_y =
// vmin + t - r, v_z = vmin + c)
template <int NV, int RY, int NM, int NO, bool ALL>
__device__ __forceinline__ void readout_taps64(
    double (&acc)[RY][NO], const double* win, const double (&wx)[RY],
    const double (&wxd)[RY], const double (&ky)[RY][NV],
    const double (&kz)[RY][NV], const double (&kyd)[RY][NV],
    const double (&kzd)[RY][NV]) {
  constexpr int SZW = TZ64 + NV - 1, AREA = area64(TROWS64 * RY, NV);
#pragma unroll
  for (int t = 0; t < RY + NV - 1; ++t) {
    // the (x, y) products of the rows that read row t, and for 'all'
    // those with either derivative
    double wxy[RY], wdy[RY], wyd[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int b = t - r;
      if (b < 0 || b >= NV) continue;
      wxy[r] = mul_rn(wx[r], ky[r][b]);
      if constexpr (ALL) {
        wdy[r] = mul_rn(wxd[r], ky[r][b]);
        wyd[r] = mul_rn(wx[r], kyd[r][b]);
      }
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      double v[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) v[m] = win[m * AREA + t * SZW + c];
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int b = t - r;
        if (b < 0 || b >= NV) continue;
        if constexpr (ALL) {
          acc[r][0] = fma_rn(mul_rn(wdy[r], kz[r][c]), v[0], acc[r][0]);
          acc[r][1] = fma_rn(mul_rn(wyd[r], kz[r][c]), v[0], acc[r][1]);
          acc[r][2] = fma_rn(mul_rn(wxy[r], kzd[r][c]), v[0], acc[r][2]);
        } else {
          const double w = mul_rn(wxy[r], kz[r][c]);
#pragma unroll
          for (int m = 0; m < NM; ++m) acc[r][m] = fma_rn(w, v[m], acc[r][m]);
        }
      }
    }
  }
}

// the readout: each thread reads RY rows (j .. j + RY - 1, column k) of
// the tile through output planes x0 .. x1 - 1; MODE meshes m0.. into
// o0.., or (MODE_ALL) the three derivative readouts of m0.  Dynamic
// shared memory: DEPTH = nv + 1 slots of NM meshes of the staged region;
// the slot of mesh plane x0 + vmin + p is p % DEPTH.
template <int NV, int MODE>
__global__ void READOUT_BOUNDS64(NV, MODE) readout64(
    const double* __restrict__ m0, const double* __restrict__ m1,
    const double* __restrict__ m2, const double* __restrict__ sx,
    const double* __restrict__ sy, const double* __restrict__ sz,
    double* __restrict__ o0, double* __restrict__ o1,
    double* __restrict__ o2, Geo g, int diffdir, int kind,
    Table<double> tb) {
  constexpr bool ALL = MODE == MODE_ALL;
  constexpr int NM = ALL ? 1 : MODE, NO = ALL ? 3 : MODE;
  constexpr int RY = rows64(ALL ? R64_READOUT_ALL : R64_READOUT, NV);
  constexpr int TY = TROWS64 * RY, SZW = TZ64 + NV - 1;
  constexpr int AREA = area64(TY, NV), SLOT = NM * AREA, DEPTH = NV + 1;
  constexpr int PER = (AREA + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  const int vmin = g.vmin;
  const int ty = threadIdx.x / TZ64, tz = threadIdx.x % TZ64;
  const int j = blockIdx.y * TY + ty * RY, k = blockIdx.x * TZ64 + tz;
  const int x0 = blockIdx.z * g.xc, x1 = min(x0 + g.xc, g.n0);
  const double* const mesh[3] = {m0, m1, m2};
  const double* const disp[3] = {sx, sy, sz};
  double* const outs[3] = {o0, o1, o2};
  const int64_t pstride = (int64_t)g.n1 * g.n2;
  bool live[RY];
#pragma unroll
  for (int r = 0; r < RY; ++r) live[r] = j + r < g.n1 && k < g.n2;

  int off[PER];
  region_offsets(off, AREA, SZW, blockIdx.y * TY + vmin,
                 blockIdx.x * TZ64 + vmin, g);
  double* const mine = ring + threadIdx.x;
  // slots 0 .. nv - 1: mesh planes x0 + vmin .. x0 + vmax
  for (int p = 0; p < NV; ++p)
    stage64<NM>(mine + p * SLOT, mesh, off, plane_at(x0 + vmin + p, g),
                AREA);
  int64_t q = (int64_t)x0 * pstride + (int64_t)j * g.n2 + k;
  double dn[RY][3];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      dn[r][d] = live[r] ? disp[d][q + r * g.n2] : 0.0;
  // the thread's window in a slot: rows ty RY .., cells tz ..
  const int corner = ty * RY * SZW + tz;
  for (int i = x0; i < x1; ++i, q += pstride) {
    const int h = i - x0;  // the slot of mesh plane i + vmin: h % DEPTH
    cp_async_wait_all();
    __syncthreads();
    double s[RY][3];
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) s[r][d] = dn[r][d];
    if (i + 1 < x1) {
      // plane i + 1 + vmax into the slot plane i - 1 + vmin held
      stage64<NM>(mine + (h + NV) % DEPTH * SLOT, mesh, off,
                  plane_at(i + 1 + vmin + NV - 1, g), AREA);
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (live[r]) dn[r][d] = disp[d][q + pstride + r * g.n2];
    }
    double ky[RY][NV], kz[RY][NV], kyd[RY][NV], kzd[RY][NV];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      axis_weights(ky[r], NV, vmin, s[r][1], diffdir == 1, kind, tb);
      axis_weights(kz[r], NV, vmin, s[r][2], diffdir == 2, kind, tb);
      if constexpr (ALL) {
        axis_weights(kyd[r], NV, vmin, s[r][1], true, kind, tb);
        axis_weights(kzd[r], NV, vmin, s[r][2], true, kind, tb);
      }
    }
    double acc[RY][NO];
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int o = 0; o < NO; ++o) acc[r][o] = 0.0;
    // up to nv = 5 the x weights are formed once and the v_x loop is
    // unrolled; past it the loop runs at run time and forms each v_x's
    // weights in turn, so that no array is indexed by it
    if constexpr (NV <= 5) {
      double kx[RY][NV], kxd[RY][NV];
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        axis_weights(kx[r], NV, vmin, s[r][0], diffdir == 0, kind, tb);
        if constexpr (ALL)
          axis_weights(kxd[r], NV, vmin, s[r][0], true, kind, tb);
      }
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        double wx[RY], wxd[RY];
#pragma unroll
        for (int r = 0; r < RY; ++r) {
          wx[r] = kx[r][a];
          wxd[r] = ALL ? kxd[r][a] : 0.0;
        }
        readout_taps64<NV, RY, NM, NO, ALL>(
            acc, ring + (h + a) % DEPTH * SLOT + corner, wx, wxd, ky, kz,
            kyd, kzd);
      }
    } else {
#pragma unroll 1
      for (int a = 0; a < NV; ++a) {
        double wx[RY], wxd[RY];
#pragma unroll
        for (int r = 0; r < RY; ++r) {
          wx[r] = weight64(kind, vmin + a, s[r][0], diffdir == 0, tb);
          wxd[r] =
              ALL ? weight64(kind, vmin + a, s[r][0], true, tb) : 0.0;
        }
        readout_taps64<NV, RY, NM, NO, ALL>(
            acc, ring + (h + a) % DEPTH * SLOT + corner, wx, wxd, ky, kz,
            kyd, kzd);
      }
    }
#pragma unroll
    for (int r = 0; r < RY; ++r)
      if (live[r])
#pragma unroll
        for (int o = 0; o < NO; ++o) st(outs[o], q + r * g.n2, acc[r][o]);
  }
}

// RZ consecutive f64 cells of a table row from p: one 8-byte load, or
// one 16-byte load for two (p 16-byte aligned)
template <int RZ>
__device__ __forceinline__ void cells64(double (&v)[RZ], const double* p) {
  static_assert(RZ == 1 || RZ == 2, "a thread paints 1 or 2 z cells");
  if constexpr (RZ == 2) {
    const double2 x = *reinterpret_cast<const double2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// the taps of staged row t of the thread's paint window, whose cell e
// (z = k - vmax + e, e = 0 .. RZ + nv - 2) is at row0 + e: its cells
// walked from the last down, RZ at a time; of each block of RZ cells the
// x weights, the mass and the z weights it gives the thread's RZ outputs
// read once, each row r that it feeds (v_y = vmin + nv - 1 + r - t) its y
// weight once, and each cell's (x, y) products once for the outputs q it
// feeds (v_z = vmin + nv - 1 + q - e): nv taps each into the row's
// accumulators of output planes s + vmin + a
template <int NV, int RY, int RZ, bool MASS>
__device__ __forceinline__ void paint_row64(double (&acc)[RY][RZ][NV],
                                            const double* tab, int row0,
                                            int t) {
  constexpr int AREA = area64(TROWS64 * RY, NV, RZ), NE = RZ + NV - 1;
#pragma unroll
  for (int e0 = (NE - 1) / RZ * RZ; e0 >= 0; e0 -= RZ) {
    const double* cell = tab + row0 + e0;
    // wz[i]: offset c = nv - RZ - e0 + i, the ones that the block's cells
    // give its outputs
    double wx[NV][RZ], m[RZ], wz[2 * RZ - 1][RZ];
#pragma unroll
    for (int a = 0; a < NV; ++a) cells64(wx[a], cell + a * AREA);
    if constexpr (MASS) cells64(m, cell + 3 * NV * AREA);
#pragma unroll
    for (int i = 0; i < 2 * RZ - 1; ++i) {
      const int c = NV - RZ - e0 + i;
      if (c >= 0 && c < NV) cells64(wz[i], cell + (2 * NV + c) * AREA);
    }
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int b = NV - 1 + r - t;
      if (b < 0 || b >= NV) continue;
      double wy[RZ];
      cells64(wy, cell + (NV + b) * AREA);
#pragma unroll
      for (int u = RZ - 1; u >= 0; --u) {
        if (e0 + u >= NE) continue;  // the row's rounding cell
        double wxy[NV];
#pragma unroll
        for (int a = 0; a < NV; ++a) wxy[a] = mul_rn(wx[a][u], wy[u]);
#pragma unroll
        for (int q = 0; q < RZ; ++q) {
          const int i = RZ - 1 + q - u, c = NV - RZ - e0 + i;
          if (c < 0 || c >= NV) continue;
#pragma unroll
          for (int a = 0; a < NV; ++a) {
            const double w = mul_rn(wxy[a], wz[i][u]);
            if (MASS)
              acc[r][q][a] = fma_rn(w, m[u], acc[r][q][a]);
            else
              acc[r][q][a] += w;
          }
        }
      }
    }
  }
}

// the paint: each thread paints RY rows (j .. j + RY - 1) of RZ z cells
// (k .. k + RZ - 1).  The block walks source planes s = x1 - 1 - vmin
// down to x0 - vmax; acc[r][q][a] holds output plane s + vmin + a of
// row r, cell q, which plane s feeds with v_x = vmin + a; after plane s,
// output plane s + vmax (acc[r][q][nv - 1]) has all its taps.  Dynamic
// shared memory: one table of the staged region's weights, [3 nv (+ 1
// mass)][area], filled and read between two barriers a plane (one table
// and the blocks an SM it leaves room for were as fast as two or faster
// on an H100).  The rows of the window are walked from t = nv + RY - 2
// down and its cells from the last down, so that each output meets its
// v_y, then its v_z, in ascending order (unrolled up to nv = 5; past it
// the row loop runs at run time, every per-thread array still indexed by
// compile-time values).
template <int NV, bool MASS>
__global__ void PAINT_BOUNDS64(NV, MASS) paint64(
    const double* __restrict__ sx, const double* __restrict__ sy,
    const double* __restrict__ sz, const double* __restrict__ mass,
    double scalar_mass, double* __restrict__ out, Geo g, int diffdir,
    int kind, Table<double> tb) {
  constexpr int RY = rows64(R64_PAINT, NV), RZ = zcells64(NV);
  constexpr int NS = MASS ? 4 : 3;
  constexpr int TY = TROWS64 * RY, TZ = TZ64 * RZ, SZW = width64(NV, RZ);
  constexpr int AREA = area64(TY, NV, RZ);
  constexpr int PER = (AREA + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* tab = reinterpret_cast<double*>(smem_raw);
  const int vmin = g.vmin, vmax = vmin + NV - 1;
  const int ty = threadIdx.x / TZ64, tz = threadIdx.x % TZ64;
  const int j = blockIdx.y * TY + ty * RY, k = blockIdx.x * TZ + tz * RZ;
  const int x0 = blockIdx.z * g.xc, x1 = min(x0 + g.xc, g.n0);
  bool live[RY][RZ];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int q = 0; q < RZ; ++q) live[r][q] = j + r < g.n1 && k + q < g.n2;
  const double* const src[4] = {sx, sy, sz, mass};

  int off[PER];
  region_offsets(off, AREA, SZW, blockIdx.y * TY - vmax,
                 blockIdx.x * TZ - vmax, g);
  double pre[NS][PER];
  const int s_hi = x1 - 1 - vmin, count = x1 - x0 + NV - 1;
  fetch(pre, src, off, plane_at(s_hi, g));
  double acc[RY][RZ][NV];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int q = 0; q < RZ; ++q)
#pragma unroll
      for (int a = 0; a < NV; ++a) acc[r][q][a] = 0.0;
  // the thread's window cell e = 0 of row 0
  const int cell0 = ty * RY * SZW + tz * RZ;
  for (int it = 0; it < count; ++it) {
    const int s = s_hi - it;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      if (off[r] < 0) continue;
      const int e = threadIdx.x + r * kThreads;
      double w[NV];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        axis_weights(w, NV, vmin, pre[d][r], diffdir == d, kind, tb);
#pragma unroll
        for (int a = 0; a < NV; ++a) tab[(d * NV + a) * AREA + e] = w[a];
      }
      if (MASS) tab[3 * NV * AREA + e] = pre[NS - 1][r];
    }
    __syncthreads();
    if (it + 1 < count) fetch(pre, src, off, plane_at(s - 1, g));
    if constexpr (NV <= 5) {
#pragma unroll
      for (int t = NV + RY - 2; t >= 0; --t)
        paint_row64<NV, RY, RZ, MASS>(acc, tab, cell0 + t * SZW, t);
    } else {
#pragma unroll 1
      for (int t = NV + RY - 2; t >= 0; --t)
        paint_row64<NV, RY, RZ, MASS>(acc, tab, cell0 + t * SZW, t);
    }
    const int o = s + vmax;
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int q = 0; q < RZ; ++q) {
        if (live[r][q] && o >= x0 && o < x1)
          st(out, ((int64_t)o * g.n1 + j + r) * g.n2 + k + q,
             acc[r][q][NV - 1] * scalar_mass);
#pragma unroll
        for (int a = NV - 1; a > 0; --a) acc[r][q][a] = acc[r][q][a - 1];
        acc[r][q][0] = 0.0;
      }
    __syncthreads();
  }
}

template <int NV, bool MASS>
cudaError_t launch_paint64_t(const void* sx, const void* sy, const void* sz,
                             const void* mass, double scalar_mass, void* out,
                             const Launch<double>& L) {
  cudaError_t err = allow_smem(paint64<NV, MASS>, L.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of(L.g, TROWS64 * rows64(R64_PAINT, NV),
                            TZ64 * zcells64(NV));
  paint64<NV, MASS><<<grid, kThreads, L.smem, L.stream>>>(
      (const double*)sx, (const double*)sy, (const double*)sz,
      (const double*)mass, scalar_mass, (double*)out, L.g, L.diffdir, L.kind,
      L.tb);
  return cudaSuccess;
}

template <int NV, int MODE>
cudaError_t launch_readout64_t(const void* const* m, const void* sx,
                               const void* sy, const void* sz,
                               void* const* o, const Launch<double>& L) {
  cudaError_t err = allow_smem(readout64<NV, MODE>, L.smem);
  if (err != cudaSuccess) return err;
  constexpr int RY =
      rows64(MODE == MODE_ALL ? R64_READOUT_ALL : R64_READOUT, NV);
  readout64<NV, MODE>
      <<<grid_of(L.g, TROWS64 * RY, TZ64), kThreads, L.smem, L.stream>>>(
          (const double*)m[0], (const double*)m[1], (const double*)m[2],
          (const double*)sx, (const double*)sy, (const double*)sz,
          (double*)o[0], (double*)o[1], (double*)o[2], L.g, L.diffdir,
          L.kind, L.tb);
  return cudaSuccess;
}

template <int NV>
cudaError_t launch_readout64_m(const void* const* m, int mode,
                               const void* sx, const void* sy,
                               const void* sz, void* const* o,
                               const Launch<double>& L) {
  switch (mode) {
    case 1:
      return launch_readout64_t<NV, 1>(m, sx, sy, sz, o, L);
    case 2:
      return launch_readout64_t<NV, 2>(m, sx, sy, sz, o, L);
    case 3:
      return launch_readout64_t<NV, 3>(m, sx, sy, sz, o, L);
    case MODE_ALL:
      return launch_readout64_t<NV, MODE_ALL>(m, sx, sy, sz, o, L);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_paint64(const void* sx, const void* sy, const void* sz,
                           const void* mass, double scalar_mass, void* out,
                           const Launch<double>& L, int nbuf) {
  if (nbuf != 1) return cudaErrorInvalidValue;  // one table (paint64)
  switch (L.g.nv) {
#define PAINT64_NV(NV)                                                     \
  case NV:                                                                 \
    return mass != nullptr                                                 \
               ? launch_paint64_t<NV, true>(sx, sy, sz, mass, scalar_mass, \
                                            out, L)                        \
               : launch_paint64_t<NV, false>(sx, sy, sz, mass,             \
                                             scalar_mass, out, L);
    GRIDPM64_WIDTHS(PAINT64_NV)
#undef PAINT64_NV
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_readout64(const void* const* m, int mode, const void* sx,
                             const void* sy, const void* sz, void* const* o,
                             const Launch<double>& L) {
  switch (L.g.nv) {
#define READOUT64_NV(NV) \
  case NV:               \
    return launch_readout64_m<NV>(m, mode, sx, sy, sz, o, L);
    GRIDPM64_WIDTHS(READOUT64_NV)
#undef READOUT64_NV
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
