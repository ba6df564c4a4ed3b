// Lattice shift-sum paint and readout for Hopper (sm_90a).
//
// Particles live on the mesh lattice: particle q sits at q + s(q), with
// the displacement s stored as three mesh-shaped f32 arrays (cell
// units).  A window W of integer offsets v in [vmin, vmax]^3 then gives
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
// They compute what those kernels compute, not how: the TPU kernels walk
// x-planes held in VMEM and roll them; here every thread owns one output.
//
// What bounds them on this card.  Each output cell of the paint gathers
// its nv^3 source cells: about 3 * nv^3 displacement reads (4 bytes each,
// 324 bytes per cell at nv = 3) and 3 * nv^3 window evaluations, against
// 16 bytes of compulsory device-memory traffic per cell (three
// displacements in, one density out).  The readout reads its own three
// displacements once and nv^3 mesh values per mesh.  Neighbouring threads
// of a warp own neighbouring z cells, so for every offset they read
// neighbouring addresses: the repeated reads are coalesced and mostly
// L1/L2 hits, and each value crosses device memory about once.  The simple
// design leans on the caches for that reuse; staging x-planes in shared
// memory (or TMA tiles) would cut the L1/L2 traffic further.
//
// The paint is in gather form (no atomics), so it is deterministic, as
// on the TPU.  Sums run in f32 in the order v_x, v_y, v_z.  Indices are
// wrapped modulo N for any offset, so offsets wider than the mesh are
// right, and linear indices are 64-bit.
//
// Storage: f32, or bf16 (a bf16 state or mesh, as the TPU kernels take
// one through _cdtype, pmesh_tpu/ops/gridpm_pallas.py:91): every load is
// upcast to f32, the weights and sums are f32, and each output is
// rounded once at its store.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ float ld(const float* p, int64_t a) {
  return p[a];
}
__device__ __forceinline__ float ld(const bf16_t* p, int64_t a) {
  return __bfloat162float(p[a]);
}
__device__ __forceinline__ void st(float* p, int64_t a, float v) {
  p[a] = v;
}
__device__ __forceinline__ void st(bf16_t* p, int64_t a, float v) {
  p[a] = __float2bfloat16_rn(v);
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
// about four digits)
struct Table {
  const float* t;
  const float* d;
  int n;
  float step;
  float offset;
};

// a mod n in [0, n) for any a; the remainder only off the fast path
__device__ __forceinline__ int wrap(int a, int n) {
  if ((unsigned)a < (unsigned)n) return a;
  int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float table_kernel(float f, const Table& tb,
                                              bool valid) {
  int i = (int)floorf(f);
  float frac = f - (float)i;
  if (!valid || i < 0 || i >= tb.n - 1) return 0.f;
  return tb.t[i] * (1.f - frac) + tb.t[i + 1] * frac;
}

__device__ __forceinline__ float table_diff(int i, const Table& tb) {
  if (i < 0 || i >= tb.n - 1) return 0.f;
  return tb.d[i];
}

template <int K>
__device__ __forceinline__ float wkernel(float x, const Table& tb) {
  float ax = fabsf(x);
  if (K == W_NEAREST) return (x < 0.5f && x >= -0.5f) ? 1.f : 0.f;
  if (K == W_LINEAR) return ax < 1.f ? 1.f - ax : 0.f;
  if (K == W_QUADRATIC) {
    if (ax <= 0.5f) return 0.75f - ax * ax;
    float t = 1.5f - ax;
    return ax < 1.5f ? 0.5f * t * t : 0.f;
  }
  if (K == W_CUBIC) {
    float xx = ax * ax;
    if (ax < 1.f) return (4.f - 6.f * xx + 3.f * xx * ax) / 6.f;
    float t = 2.f - ax;
    return ax < 2.f ? t * t * t / 6.f : 0.f;
  }
  if (K == W_TABLE) return table_kernel(ax / tb.step, tb, true);
  float f = (x + tb.offset) / tb.step;
  return table_kernel(f, tb, f >= 0.f);
}

// dW/dx
template <int K>
__device__ __forceinline__ float wdiff(float x, const Table& tb) {
  float ax = fabsf(x);
  if (K == W_NEAREST) return 0.f;
  if (K == W_LINEAR) {
    if (ax >= 1.f) return 0.f;
    return x > 0.f ? -1.f : (x < 0.f ? 1.f : 0.f);
  }
  float factor = x < 0.f ? -1.f : 1.f;
  if (K == W_QUADRATIC) {
    if (ax <= 0.5f) return factor * (-2.f * ax);
    return ax < 1.5f ? factor * -(1.5f - ax) : 0.f;
  }
  if (K == W_CUBIC) {
    float xx = ax * ax;
    if (ax < 1.f) return factor * ((-12.f * ax + 9.f * xx) / 6.f);
    float t = 2.f - ax;
    return ax < 2.f ? factor * (-0.5f * t * t) : 0.f;
  }
  if (K == W_TABLE)
    return (x >= 0.f ? 1.f : -1.f) * table_diff((int)(ax / tb.step), tb);
  return table_diff((int)((x + tb.offset) / tb.step), tb);
}

// weight of integer offset v for displacement s along one axis; the
// derivative axis takes -W'(v - s), which is +d/ds of the interpolation
template <int K>
__device__ __forceinline__ float axis_w(int v, float s, bool diff,
                                        const Table& tb) {
  float x = (float)v - s;
  return diff ? -wdiff<K>(x, tb) : wkernel<K>(x, tb);
}

// one thread per output cell (i, j, k): k along x-threads, j and i on
// the grid's y and z; T: the storage of displacements, mass and output
template <int K, class T>
__global__ void paint_lattice_kernel(
    const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ sz, const T* __restrict__ mass,
    float scalar_mass, T* __restrict__ out, int n0, int n1, int n2,
    int xbase, int vmin, int vmax, int diffdir, Table tb) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int j = blockIdx.y;
  int i = blockIdx.z;
  if (k >= n2) return;
  float acc = 0.f;
  for (int vx = vmin; vx <= vmax; ++vx) {
    int64_t qx = xbase < 0 ? wrap(i - vx, n0) : (int64_t)(i + xbase - vx);
    for (int vy = vmin; vy <= vmax; ++vy) {
      int64_t row = (qx * n1 + wrap(j - vy, n1)) * n2;
      for (int vz = vmin; vz <= vmax; ++vz) {
        int64_t q = row + wrap(k - vz, n2);
        float w = axis_w<K>(vx, ld(sx, q), diffdir == 0, tb) *
                  axis_w<K>(vy, ld(sy, q), diffdir == 1, tb);
        w = w * axis_w<K>(vz, ld(sz, q), diffdir == 2, tb);
        if (mass != nullptr) w = w * ld(mass, q);
        acc += w;
      }
    }
  }
  st(out, ((int64_t)i * n1 + j) * n2 + k, acc * scalar_mass);
}

// one thread per particle q = (i, j, k); nmesh meshes share the weights,
// or (diffdir == DIFF_ALL) three derivative readouts of m0; T: the
// storage of meshes, displacements and outputs
template <int K, class T>
__global__ void readout_lattice_kernel(
    const T* __restrict__ m0, const T* __restrict__ m1,
    const T* __restrict__ m2, int nmesh, const T* __restrict__ sx,
    const T* __restrict__ sy, const T* __restrict__ sz,
    T* __restrict__ o0, T* __restrict__ o1, T* __restrict__ o2, int n0,
    int n1, int n2, int xbase, int vmin, int vmax, int diffdir, Table tb) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int j = blockIdx.y;
  int i = blockIdx.z;
  if (k >= n2) return;
  int64_t q = ((int64_t)i * n1 + j) * n2 + k;
  float s0 = ld(sx, q), s1 = ld(sy, q), s2 = ld(sz, q);
  bool all = diffdir == DIFF_ALL;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int vx = vmin; vx <= vmax; ++vx) {
    int64_t px = xbase < 0 ? wrap(i + vx, n0) : (int64_t)(i + xbase + vx);
    float kx = axis_w<K>(vx, s0, diffdir == 0, tb);
    float kxd = all ? axis_w<K>(vx, s0, true, tb) : 0.f;
    for (int vy = vmin; vy <= vmax; ++vy) {
      int64_t row = (px * n1 + wrap(j + vy, n1)) * n2;
      float ky = axis_w<K>(vy, s1, diffdir == 1, tb);
      float kyd = all ? axis_w<K>(vy, s1, true, tb) : 0.f;
      for (int vz = vmin; vz <= vmax; ++vz) {
        int64_t p = row + wrap(k + vz, n2);
        float kz = axis_w<K>(vz, s2, diffdir == 2, tb);
        if (all) {
          float kzd = axis_w<K>(vz, s2, true, tb);
          float v = ld(m0, p);
          a0 += (kxd * ky) * kz * v;
          a1 += (kx * kyd) * kz * v;
          a2 += (kx * ky) * kzd * v;
        } else {
          float w = (kx * ky) * kz;
          a0 += w * ld(m0, p);
          if (nmesh > 1) a1 += w * ld(m1, p);
          if (nmesh > 2) a2 += w * ld(m2, p);
        }
      }
    }
  }
  st(o0, q, a0);
  if (all || nmesh > 1) st(o1, q, a1);
  if (all || nmesh > 2) st(o2, q, a2);
}

constexpr int kThreads = 128;

dim3 grid_of(int n0, int n1, int n2) {
  return dim3((n2 + kThreads - 1) / kThreads, n1, n0);
}

// the storage T of every mesh: f32, or bf16 when bf16 is set
template <int K, class T>
void launch_paint_t(const void* sx, const void* sy, const void* sz,
                    const void* mass, float scalar_mass, void* out, int n0,
                    int n1, int n2, int xbase, int vmin, int vmax,
                    int diffdir, Table tb, cudaStream_t stream) {
  paint_lattice_kernel<K, T><<<grid_of(n0, n1, n2), kThreads, 0, stream>>>(
      (const T*)sx, (const T*)sy, (const T*)sz, (const T*)mass, scalar_mass,
      (T*)out, n0, n1, n2, xbase, vmin, vmax, diffdir, tb);
}

template <int K>
void launch_paint(const void* sx, const void* sy, const void* sz,
                  const void* mass, float scalar_mass, void* out, int n0,
                  int n1, int n2, int xbase, int vmin, int vmax, int diffdir,
                  Table tb, int bf16, cudaStream_t stream) {
  if (bf16)
    launch_paint_t<K, bf16_t>(sx, sy, sz, mass, scalar_mass, out, n0, n1, n2,
                              xbase, vmin, vmax, diffdir, tb, stream);
  else
    launch_paint_t<K, float>(sx, sy, sz, mass, scalar_mass, out, n0, n1, n2,
                             xbase, vmin, vmax, diffdir, tb, stream);
}

template <int K, class T>
void launch_readout_t(const void* m0, const void* m1, const void* m2,
                      int nmesh, const void* sx, const void* sy,
                      const void* sz, void* o0, void* o1, void* o2, int n0,
                      int n1, int n2, int xbase, int vmin, int vmax,
                      int diffdir, Table tb, cudaStream_t stream) {
  readout_lattice_kernel<K, T>
      <<<grid_of(n0, n1, n2), kThreads, 0, stream>>>(
          (const T*)m0, (const T*)m1, (const T*)m2, nmesh, (const T*)sx,
          (const T*)sy, (const T*)sz, (T*)o0, (T*)o1, (T*)o2, n0, n1, n2,
          xbase, vmin, vmax, diffdir, tb);
}

template <int K>
void launch_readout(const void* m0, const void* m1, const void* m2,
                    int nmesh, const void* sx, const void* sy,
                    const void* sz, void* o0, void* o1, void* o2, int n0,
                    int n1, int n2, int xbase, int vmin, int vmax, int diffdir,
                    Table tb, int bf16, cudaStream_t stream) {
  if (bf16)
    launch_readout_t<K, bf16_t>(m0, m1, m2, nmesh, sx, sy, sz, o0, o1, o2, n0,
                                n1, n2, xbase, vmin, vmax, diffdir, tb,
                                stream);
  else
    launch_readout_t<K, float>(m0, m1, m2, nmesh, sx, sy, sz, o0, o1, o2, n0,
                               n1, n2, xbase, vmin, vmax, diffdir, tb, stream);
}

}  // namespace

extern "C" {

const char* pmesh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// kind: WindowKind; diffdir: -1 none or the derivative axis 0, 1, 2;
// mass: a mesh, or NULL for the scalar scalar_mass; table (tabulated
// kinds only): 2 * ntable floats, the values then the differences / step;
// xbase >= 0: the x-halo slab form, displacements and mass of n0_in
// planes (every plane i + xbase - v_x must lie in [0, n0_in)); bf16: the
// displacements, the mass mesh and the output are bf16, else f32
int pmesh_paint_lattice(const void* sx, const void* sy, const void* sz,
                        const void* mass, float scalar_mass, void* out,
                        int n0, int n1, int n2, int n0_in, int xbase,
                        int vmin, int vmax, int kind, int diffdir,
                        const float* table, int ntable, float step,
                        float offset, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (diffdir < DIFF_NONE || diffdir > 2) return (int)cudaErrorInvalidValue;
  if (xbase >= 0 && (xbase - vmax < 0 || n0 - 1 + xbase - vmin >= n0_in))
    return (int)cudaErrorInvalidValue;
  Table tb{table, table + ntable, ntable, step, offset};
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
#define PAINT_CASE(K)                                                       \
  case K:                                                                   \
    launch_paint<K>(sx, sy, sz, mass, scalar_mass, out, n0, n1, n2, xbase,  \
                    vmin, vmax, diffdir, tb, bf16, s);                      \
    break;
    PAINT_CASE(W_NEAREST)
    PAINT_CASE(W_LINEAR)
    PAINT_CASE(W_QUADRATIC)
    PAINT_CASE(W_CUBIC)
    PAINT_CASE(W_TABLE)
    PAINT_CASE(W_TABLE_OFFSET)
#undef PAINT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// nmesh in 1..3 meshes m0..m2 into o0..o2; diffdir 3 ('all') reads m0
// into the three derivative outputs o0..o2; xbase >= 0: the x-halo slab
// form, meshes of n0_in planes (every plane i + xbase + v_x must lie in
// [0, n0_in)); bf16: meshes, displacements and outputs are bf16
int pmesh_readout_lattice(const void* m0, const void* m1, const void* m2,
                          int nmesh, const void* sx, const void* sy,
                          const void* sz, void* o0, void* o1, void* o2,
                          int n0, int n1, int n2, int n0_in, int xbase,
                          int vmin, int vmax, int kind, int diffdir,
                          const float* table, int ntable, float step,
                          float offset, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (diffdir < DIFF_NONE || diffdir > DIFF_ALL || nmesh < 1 || nmesh > 3 ||
      (diffdir == DIFF_ALL && nmesh != 1))
    return (int)cudaErrorInvalidValue;
  if (xbase >= 0 && (xbase + vmin < 0 || n0 - 1 + xbase + vmax >= n0_in))
    return (int)cudaErrorInvalidValue;
  Table tb{table, table + ntable, ntable, step, offset};
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
#define READOUT_CASE(K)                                                     \
  case K:                                                                   \
    launch_readout<K>(m0, m1, m2, nmesh, sx, sy, sz, o0, o1, o2, n0, n1,    \
                      n2, xbase, vmin, vmax, diffdir, tb, bf16, s);         \
    break;
    READOUT_CASE(W_NEAREST)
    READOUT_CASE(W_LINEAR)
    READOUT_CASE(W_QUADRATIC)
    READOUT_CASE(W_CUBIC)
    READOUT_CASE(W_TABLE)
    READOUT_CASE(W_TABLE_OFFSET)
#undef READOUT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
