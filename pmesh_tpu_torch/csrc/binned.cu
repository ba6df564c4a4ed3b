// Binned slot-lattice rebase for Hopper (sm_90a): assign and apply.
//
// A binned state holds K slots per mesh cell: slot k of cell c holds a
// particle at c + d_k(c) (three f32 displacement meshes, cell units)
// when valid_k(c) > 0.  After some steps the displacements have drifted
// by whole cells; the rebase moves every particle to the cell it drifted
// into.  Each (slot k, integer offset o) "image" of the source cell
// s = t - o arrives at the target cell t when valid_k(s) > 0 and
// floor(d_k(s)) == o on every axis.  Images are taken in a fixed order,
// k-major and the offsets lexicographic (ox slowest, oz fastest); the
// running arrival count at t is an image's rank, and rank j < Kout
// lands in output slot j with the displacement d - o, validity 1 and a
// route code k * n_off + offset index.  Arrivals of rank >= Kout are
// counted as overflow.  Empty output slots hold displacement 0,
// validity 0 and route -1.
//
//   rebase_assign replaces pmesh_tpu/ops/binned_pallas.py _run_assign_t
//     (kernel _assign_kernel_t, through _assign_split_t);
//   rebase_apply  replaces _run_apply_t (kernel _apply_kernel_t, through
//     _apply_split_t): it replays the routes on the extra payloads (the
//     velocities), so the old displacements are dead before the new
//     velocities are born.
//
// They compute what those kernels compute, not how.  The TPU kernels
// walk x-planes with three sliding source planes in VMEM, rotate the
// planes for the y/z offsets and patch the wrap planes with extra calls;
// here every thread owns one target cell and gathers its images from
// device memory (the gather form of the plain version's rolls), with any
// offset range [olo, ohi] per axis and the wrap taken per index.  The
// image order is the plain version's, so both are bitwise equal: the only
// arithmetic is one f32 subtraction per moved displacement.
//
// What bounds them on this card.  Per target cell the assign reads
// K * n_off validity values (4 B each; 27 offsets at the per-step drift)
// and the three displacements of each image that arrives, and writes
// Kout * 4 f32 + Kout int16 once.  Neighbouring threads own neighbouring
// z cells, so every image's reads are coalesced and mostly L1/L2 hits;
// compulsory device-memory traffic is the state read once and written
// once.  The apply reads Kout routes and gathers nextra * 3 values per
// filled slot.  Both lean on the caches for the image reuse.
//
// The x-halo slab form (a slab-sharded state, one slab per rank) reads
// inputs of n0_in = lo + rows + hi x planes and writes rows = n0 output
// planes, with no wrap on x (y and z still wrap): the source of target
// row x for offset o_x is input plane x + xbase - o_x, xbase = lo.  The
// image order is unchanged, so a sharded rebase is bitwise equal to the
// single-device rebase of the same global state.  xbase < 0 selects the
// wrapped form.
//
// The slot pointers travel by value in the kernel's parameter struct
// (at most kMaxSlots slots and kMaxExtras extra fields), so no (K, 3, N^3)
// stack of the state is ever made.  The overflow count is reduced per
// block and added with one integer atomic per block: deterministic.
// Linear indices are 64-bit.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 16;
constexpr int kMaxExtras = 4;
constexpr int kThreads = 128;

struct AssignArgs {
  const float* d[kMaxSlots][3];
  const float* v[kMaxSlots];
  float* nd[kMaxSlots][3];
  float* nv[kMaxSlots];
  int16_t* rt[kMaxSlots];
  unsigned long long* overflow;
  int K, Kout, n0, n1, n2, xbase, olo, ohi;
};

struct ApplyArgs {
  const float* e[kMaxExtras][kMaxSlots][3];
  float* ne[kMaxExtras][kMaxSlots][3];
  const int16_t* rt[kMaxSlots];
  int nextra, Kout, n0, n1, n2, xbase, olo, ohi;
};

// a mod n in [0, n) for any a; the remainder only off the fast path
__device__ __forceinline__ int wrap(int a, int n) {
  if ((unsigned)a < (unsigned)n) return a;
  int r = a % n;
  return r < 0 ? r + n : r;
}

// the source x plane of target row x for offset ox
__device__ __forceinline__ int64_t src_x(int x, int ox, int n0, int xbase) {
  return xbase < 0 ? (int64_t)wrap(x - ox, n0) : (int64_t)(x + xbase - ox);
}

// one thread per target cell (x, y, z): z along x-threads, y and x on
// the grid's y and z
__global__ void rebase_assign_kernel(AssignArgs a) {
  int z = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int x = blockIdx.z;
  unsigned int over = 0;
  if (z < a.n2) {
    int64_t t = ((int64_t)x * a.n1 + y) * a.n2 + z;
    int nr = a.ohi - a.olo + 1;
    int noff = nr * nr * nr;
    int running = 0;
    for (int k = 0; k < a.K; ++k) {
      const float* __restrict__ vk = a.v[k];
      const float* __restrict__ d0 = a.d[k][0];
      const float* __restrict__ d1 = a.d[k][1];
      const float* __restrict__ d2 = a.d[k][2];
      int code = k * noff;
      for (int ox = a.olo; ox <= a.ohi; ++ox) {
        int64_t sx = src_x(x, ox, a.n0, a.xbase);
        for (int oy = a.olo; oy <= a.ohi; ++oy) {
          int64_t row = (sx * a.n1 + wrap(y - oy, a.n1)) * a.n2;
          for (int oz = a.olo; oz <= a.ohi; ++oz, ++code) {
            int64_t s = row + wrap(z - oz, a.n2);
            // a NaN fails every test: that particle is lost, and the
            // caller's count re-validation sees it
            if (!(vk[s] > 0.f)) continue;
            float s0 = d0[s];
            if (floorf(s0) != (float)ox) continue;
            float s1 = d1[s];
            if (floorf(s1) != (float)oy) continue;
            float s2 = d2[s];
            if (floorf(s2) != (float)oz) continue;
            int rank = running++;
            if (rank >= a.Kout) {
              ++over;
              continue;
            }
            a.nd[rank][0][t] = s0 - (float)ox;
            a.nd[rank][1][t] = s1 - (float)oy;
            a.nd[rank][2][t] = s2 - (float)oz;
            a.nv[rank][t] = 1.f;
            a.rt[rank][t] = (int16_t)code;
          }
        }
      }
    }
    for (int j = running; j < a.Kout; ++j) {
      a.nd[j][0][t] = 0.f;
      a.nd[j][1][t] = 0.f;
      a.nd[j][2][t] = 0.f;
      a.nv[j][t] = 0.f;
      a.rt[j][t] = (int16_t)-1;
    }
  }
  // block sum of the overflow, then one atomic per block
  for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(0xffffffffu, over, o);
  __shared__ unsigned int warp_over[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_over[threadIdx.x >> 5] = over;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_over[w];
    if (sum) atomicAdd(a.overflow, sum);
  }
}

// one thread per target cell: slot j takes every extra field of the
// image its route names, or 0 where the route is -1
__global__ void rebase_apply_kernel(ApplyArgs a) {
  int z = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int x = blockIdx.z;
  if (z >= a.n2) return;
  int64_t t = ((int64_t)x * a.n1 + y) * a.n2 + z;
  int nr = a.ohi - a.olo + 1;
  int noff = nr * nr * nr;
  for (int j = 0; j < a.Kout; ++j) {
    int r = a.rt[j][t];
    if (r < 0) {
      for (int e = 0; e < a.nextra; ++e)
        for (int c = 0; c < 3; ++c) a.ne[e][j][c][t] = 0.f;
      continue;
    }
    int k = r / noff;
    int oi = r - k * noff;
    int ox = oi / (nr * nr) + a.olo;
    int oy = (oi / nr) % nr + a.olo;
    int oz = oi % nr + a.olo;
    int64_t s = (src_x(x, ox, a.n0, a.xbase) * a.n1 + wrap(y - oy, a.n1)) *
                    a.n2 +
                wrap(z - oz, a.n2);
    for (int e = 0; e < a.nextra; ++e)
      for (int c = 0; c < 3; ++c) a.ne[e][j][c][t] = a.e[e][k][c][s];
  }
}

dim3 grid_of(int n0, int n1, int n2) {
  return dim3((n2 + kThreads - 1) / kThreads, n1, n0);
}

bool shape_ok(int n0, int n1, int n2) {
  return n0 > 0 && n1 > 0 && n2 > 0 && n0 <= 65535 && n1 <= 65535;
}

}  // namespace

extern "C" {

const char* pmesh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pmesh_rebase_max_slots() { return kMaxSlots; }
int pmesh_rebase_max_extras() { return kMaxExtras; }

// whether the x-halo form's input planes hold every source plane
bool halo_ok(int n0, int n0_in, int xbase, int olo, int ohi) {
  return xbase < 0 || (xbase - ohi >= 0 && n0 - 1 + xbase - olo < n0_in);
}

// d: K * 3 displacement pointers, k-major; v: K validity pointers;
// nd: Kout * 3, nv: Kout, rt: Kout (int16) outputs; overflow: one
// device uint64, added to (the caller zeroes it); offsets [olo, ohi]
// on every axis; n0 output planes; xbase >= 0: the x-halo form, inputs
// of n0_in planes
int pmesh_rebase_assign(const void* const* d, const void* const* v, int K,
                        void* const* nd, void* const* nv, void* const* rt,
                        int Kout, void* overflow, int n0, int n1, int n2,
                        int n0_in, int xbase, int olo, int ohi, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxSlots || Kout < 1 || Kout > kMaxSlots ||
      ohi < olo || !shape_ok(n0, n1, n2) ||
      !halo_ok(n0, n0_in, xbase, olo, ohi))
    return (int)cudaErrorInvalidValue;
  int nr = ohi - olo + 1;
  if ((long long)K * nr * nr * nr > 32767) return (int)cudaErrorInvalidValue;
  AssignArgs a{};
  for (int k = 0; k < K; ++k) {
    for (int c = 0; c < 3; ++c) a.d[k][c] = (const float*)d[k * 3 + c];
    a.v[k] = (const float*)v[k];
  }
  for (int j = 0; j < Kout; ++j) {
    for (int c = 0; c < 3; ++c) a.nd[j][c] = (float*)nd[j * 3 + c];
    a.nv[j] = (float*)nv[j];
    a.rt[j] = (int16_t*)rt[j];
  }
  a.overflow = (unsigned long long*)overflow;
  a.K = K;
  a.Kout = Kout;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.xbase = xbase;
  a.olo = olo;
  a.ohi = ohi;
  rebase_assign_kernel<<<grid_of(n0, n1, n2), kThreads, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// e: nextra * K * 3 extra pointers, (e, k, axis)-major; rt: Kout route
// pointers (int16) from pmesh_rebase_assign with the same offsets;
// ne: nextra * Kout * 3 outputs, (e, j, axis)-major; n0 output
// planes; xbase >= 0: the x-halo form, extras of n0_in planes
int pmesh_rebase_apply(const void* const* e, int nextra, int K,
                       const void* const* rt, int Kout, void* const* ne,
                       int n0, int n1, int n2, int n0_in, int xbase, int olo,
                       int ohi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nextra < 1 || nextra > kMaxExtras || K < 1 || K > kMaxSlots ||
      Kout < 1 || Kout > kMaxSlots || ohi < olo || !shape_ok(n0, n1, n2) ||
      !halo_ok(n0, n0_in, xbase, olo, ohi))
    return (int)cudaErrorInvalidValue;
  ApplyArgs a{};
  for (int x = 0; x < nextra; ++x) {
    for (int k = 0; k < K; ++k)
      for (int c = 0; c < 3; ++c)
        a.e[x][k][c] = (const float*)e[(x * K + k) * 3 + c];
    for (int j = 0; j < Kout; ++j)
      for (int c = 0; c < 3; ++c)
        a.ne[x][j][c] = (float*)ne[(x * Kout + j) * 3 + c];
  }
  for (int j = 0; j < Kout; ++j) a.rt[j] = (const int16_t*)rt[j];
  a.nextra = nextra;
  a.Kout = Kout;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.xbase = xbase;
  a.olo = olo;
  a.ohi = ohi;
  rebase_apply_kernel<<<grid_of(n0, n1, n2), kThreads, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
