// Binned slot-lattice rebase for Hopper (sm_90a): assign and apply.
//
// A binned state holds K slots per mesh cell: slot k of cell c holds a
// particle at c + d_k(c) (three f32 or f64 displacement meshes, cell
// units) when valid_k(c) > 0.  After some steps the displacements have drifted
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
// planes for the y/z offsets and patch the wrap planes with extra calls.
// Here any offset range [olo, ohi] per axis (nr = ohi - olo + 1 offsets)
// is taken, with the wrap per index.  The image order is the plain
// version's, so both are bitwise equal: the only arithmetic is one
// subtraction per moved displacement, in the storage type (F, f32 or
// f64: the JAX package's f8 states reach its Pallas rebase too), and the
// tests are compares in F.
//
// What bounds the assign on this card.  Its compulsory traffic is the
// state read once (16 B per input slot-cell) and written once (18 B per
// output slot-cell): 9.1 GB at 512^3, K = 2 -> 2, 2.7 ms at 3.35 TB/s.
// Each target tests K nr^3 images (54 at K = 2, nr = 3), so a thread
// per target that loads each image's validity and floors itself fetches
// every source slot-cell nr^3 times, through L2 from nr^2 different
// blocks, and re-tests it each time in a chain of dependent loads and
// divergent branches; it ran at 10x the bytes bound.  assign_staged
// instead:
//
// - owns a TY x TZ tile of target columns (8 x 32, a thread each)
//   through xc target planes, and keeps a ring of nr + 1 source planes of
//   the tile plus its nr - 1 halo in y and z (wrapped per index), for
//   every slot;
// - stages each new source plane once per block, coalesced along z:
//   each source slot-cell's validity and three displacements are read
//   once, by asynchronous copies (cp.async) issued before the previous
//   target plane's tests, so that the loads are in flight during them,
//   and classified once, into one code, the index of the offset its
//   three floors name or "none" (a byte where nr^3 < 255, else 16 bits);
// - tests every target's K nr^3 images in the plain order on the ring:
//   one shared-memory read and one compare each, a hit setting a bit of
//   a mask (no branch per image); every 32 images the set bits are taken
//   in ascending order.  The ranks of the hits go to a per-thread list
//   in shared memory, so each target's Kout output slots are written
//   once each, every lane of a warp on the same slot, coalesced along z;
//   a hit's displacement is read back from the ring, where the planner
//   staged it (stage_d), or through the caches from device memory.
//
// What is left (tools/time_rebase_kernels.py, PERF.md): 1.7x the bytes
// bound at 512^3, K = 2 -> 2, 2.0x at 384^3, K = 4 -> 4 and with 64
// offsets.  The image tests, the classification and the block's barrier
// a plane share the time with the memory traffic; the branch per image
// and the loads exposed before each plane's barrier cost the first
// staged form 5.4 ms where this one takes 4.6.
//
// One barrier a plane suffices: the ring has one slot more than the nr
// planes a target plane reads, and each thread classifies the cells it
// copied.  Where the ring of every slot does not fit in shared memory
// (large K with wide offsets), the planner gives the kernel groups of
// slots: each group's nr planes are staged and tested in turn for every
// target plane, in the same image order.  ops/binned_cuda.plan owns the
// tile's planes per block (xc), the slot group, whether the
// displacements are staged and the shared bytes; the entry point takes
// them as given.
//
// The x-halo slab form (a slab-sharded state, one slab per rank) reads
// inputs of n0_in = lo + rows + hi x planes and writes rows = n0 output
// planes, with no wrap on x (y and z still wrap): the source of target
// row x for offset o_x is input plane x + xbase - o_x, xbase = lo.  The
// image order is unchanged, so a sharded rebase is bitwise equal to the
// single-device rebase of the same global state.  xbase < 0 selects the
// wrapped form.
//
// The apply keeps a thread per target cell: it reads Kout routes and
// gathers nextra * 3 values per filled slot, leaning on the caches for
// the image reuse.
//
// The slot pointers travel by value in the kernels' parameter structs
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
// the assign's tile: TY x TZ target columns, a thread each; the offsets
// per axis it compiles in (ASSIGN_NR below; the others read nr at run
// time, up to NR_MAX, the widest range the int16 route codes admit)
constexpr int TZ = 32, kAssignThreads = 256, TY = kAssignThreads / TZ;
constexpr int NR_ANY = 0, NR_MAX = 31;

template <class F>
struct AssignArgs {
  const F* d[kMaxSlots][3];
  const F* v[kMaxSlots];
  F* nd[kMaxSlots][3];
  F* nv[kMaxSlots];
  int16_t* rt[kMaxSlots];
  unsigned long long* overflow;
  int K, Kout, n0, n1, n2, xbase, olo, ohi, xc, group;
};

template <class F>
struct ApplyArgs {
  const F* e[kMaxExtras][kMaxSlots][3];
  F* ne[kMaxExtras][kMaxSlots][3];
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

// asynchronous copies of one value from device to shared memory
// (cp.async, 4 bytes for f32, 8 for f64): issued, then waited for by the
// issuing thread, which alone reads them
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ float cfloor(float x) { return floorf(x); }
__device__ __forceinline__ double cfloor(double x) { return floor(x); }
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the code of a source slot-cell: the index of (floor(s0), floor(s1),
// floor(s2)) among the offsets [olo, ohi]^3, ox slowest, where v > 0 and
// every floor lies in [olo, ohi]; else `none`.  The floors are compared
// in F before any conversion, so a NaN, an infinity or a value beyond
// int's range never matches, as in the plain version's compares.
template <class C, class F>
__device__ __forceinline__ C classify(F v, F s0, F s1, F s2, int olo,
                                      int ohi, int nr, C none) {
  if (!(v > F(0))) return none;
  const F lo = (F)olo, hi = (F)ohi;
  const F f0 = cfloor(s0), f1 = cfloor(s1), f2 = cfloor(s2);
  if (!(f0 >= lo && f0 <= hi && f1 >= lo && f1 <= hi && f2 >= lo &&
        f2 <= hi))
    return none;
  return (C)((((int)f0 - olo) * nr + ((int)f1 - olo)) * nr + (int)f2 - olo);
}

// the assign: one thread per target column (y, z) of the tile, through
// target planes x0 .. x1 - 1.  NR: the compiled nr, or NR_ANY; C: the
// code (uint8_t where nr^3 < 255, else uint16_t); SD: the hits'
// displacements are read from the ring (staged) or from device memory;
// F: the storage, f32 or f64.  Dynamic shared memory, in this order:
//   SD only: F dring[group][nr + 1][3][area], the staged displacements;
//   F raw[group][4][area], one plane's validity and displacements as
//     they land, each cell read and classified by the thread that
//     copied it;
//   int16 hits[Kout][kAssignThreads], each thread's route codes by rank;
//   C ring[group][nr + 1][area], the codes;
// area = (TY + nr - 1) x (TZ + nr - 1) cells of a plane's tile and halo;
// plane p of the window of target plane i (source plane i - ohi + p,
// p = 0 .. nr - 1) sits in ring slot (i - x0 + p) mod (nr + 1).
template <int NR, class C, bool SD, class F>
__global__ void __launch_bounds__(kAssignThreads)
    assign_staged(AssignArgs<F> a) {
  constexpr int NRA = NR == NR_ANY ? NR_MAX : NR;
  constexpr int PER =  // staged cells per thread
      ((TY + NRA - 1) * (TZ + NRA - 1) + kAssignThreads - 1) /
      kAssignThreads;
  constexpr C kNone = (C)~(C)0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int olo = a.olo, ohi = a.ohi;
  const int nr = NR == NR_ANY ? ohi - olo + 1 : NR;
  const int noff = nr * nr * nr, depth = nr + 1;
  const int szw = TZ + nr - 1, area = (TY + nr - 1) * szw;
  const int G = a.group, ngroups = (a.K + G - 1) / G;
  const int tid = threadIdx.x, ty = tid / TZ, tz = tid % TZ;
  const int y0 = (int)blockIdx.y * TY, z0 = (int)blockIdx.x * TZ;
  const int y = y0 + ty, z = z0 + tz;
  const int x0 = (int)blockIdx.z * a.xc, x1 = min(x0 + a.xc, a.n0);
  const bool live = y < a.n1 && z < a.n2;
  const int64_t pstride = (int64_t)a.n1 * a.n2;
  F* dring = (F*)smem;
  F* raw = dring + (SD ? G * depth * 3 * area : 0);
  int16_t* hits = (int16_t*)(raw + G * 4 * area);
  C* ring = (C*)(hits + a.Kout * kAssignThreads);

  // the region cells this thread stages: their wrapped offset within a
  // plane, or -1 past the region
  int off[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int e = tid + r * kAssignThreads;
    const int yy = e / szw, zz = e - yy * szw;
    off[r] = e < area ? wrap(y0 - ohi + yy, a.n1) * a.n2 +
                            wrap(z0 - ohi + zz, a.n2)
                      : -1;
  }

  // copy plane p of target plane i's window, slots k0 .. k0 + nk - 1,
  // into raw: every validity and displacement, coalesced along z
  auto fetch = [&](int i, int p, int k0, int nk) {
    const int64_t base = src_x(i, ohi - p, a.n0, a.xbase) * pstride;
    for (int kk = 0; kk < nk; ++kk) {
      const F* src[4] = {a.v[k0 + kk], a.d[k0 + kk][0], a.d[k0 + kk][1],
                         a.d[k0 + kk][2]};
#pragma unroll
      for (int r = 0; r < PER; ++r)
        if (off[r] >= 0)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            cp_async(raw + (kk * 4 + c) * area + tid + r * kAssignThreads,
                     src[c] + base + off[r]);
    }
    cp_async_commit();
  };
  // once this thread's copies have landed: classify them into the ring
  // slot of plane p of target plane i's window
  auto classify_plane = [&](int i, int p, int nk) {
    cp_async_wait_all();
    const int slot = (i - x0 + p) % depth;
    for (int kk = 0; kk < nk; ++kk) {
      const F* v = raw + kk * 4 * area;
      C* codes = ring + (kk * depth + slot) * area;
      F* disp = dring + (kk * depth + slot) * 3 * area;
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        if (off[r] < 0) continue;
        const int e = tid + r * kAssignThreads;
        const F s0 = v[area + e], s1 = v[2 * area + e], s2 = v[3 * area + e];
        codes[e] = classify<C>(v[e], s0, s1, s2, olo, ohi, nr, kNone);
        if (SD) {
          disp[e] = s0;
          disp[area + e] = s1;
          disp[2 * area + e] = s2;
        }
      }
    }
  };

  unsigned int over = 0;
  // one group: the ring slides a plane at a time, the next target
  // plane's new source plane copied while this one's images are tested
  if (ngroups == 1) {
    for (int p = 0; p < nr; ++p) {
      fetch(x0, p, 0, a.K);
      classify_plane(x0, p, a.K);
    }
    __syncthreads();
  }
  for (int i = x0; i < x1; ++i) {
    const bool next = ngroups == 1 && i + 1 < x1;
    if (next) fetch(i + 1, nr - 1, 0, a.K);
    int running = 0;
    for (int g = 0; g < ngroups; ++g) {
      const int k0 = g * G, nk = min(G, a.K - k0);
      if (ngroups > 1) {
        for (int p = 0; p < nr; ++p) {
          fetch(i, p, k0, nk);
          classify_plane(i, p, nk);
        }
        __syncthreads();
      }
      if (live) {
        for (int kk = 0; kk < nk; ++kk) {
          const int kcode = (k0 + kk) * noff;
          // the image (ox, oy, oz) = olo + (ia, ib, ic) of this target
          // reads the code at plane - ib szw - ic; a hit sets bit oi mod
          // 32 of m, and every 32 images (and after the slot's last) the
          // bits are taken in ascending order: ranks in image order
          const C* col = ring + kk * depth * area + (ty + nr - 1) * szw +
                         tz + nr - 1;
          unsigned m = 0;
          int oi = 0;
#pragma unroll
          for (int ia = 0; ia < nr; ++ia) {
            const C* plane = col + ((i - x0 + nr - 1 - ia) % depth) * area;
#pragma unroll
            for (int ib = 0; ib < nr; ++ib)
#pragma unroll
              for (int ic = 0; ic < nr; ++ic, ++oi) {
                if (plane[-ib * szw - ic] == oi) m |= 1u << (oi & 31);
                if ((oi & 31) == 31 || oi + 1 == noff)
                  for (; m; m &= m - 1) {
                    if (running < a.Kout)
                      hits[running * kAssignThreads + tid] =
                          (int16_t)(kcode + (oi & ~31) + __ffs(m) - 1);
                    ++running;
                  }
              }
          }
        }
      }
      // the next group's planes replace these
      if (ngroups > 1) __syncthreads();
    }
    if (live) {
      const int64_t t = (int64_t)i * pstride + (int64_t)y * a.n2 + z;
      const int cnt = min(running, a.Kout);
      over += running - cnt;
      // every lane of the warp stores slot j at once
#pragma unroll
      for (int j = 0; j < kMaxSlots; ++j) {
        if (j >= a.Kout) break;
        F e0 = F(0), e1 = F(0), e2 = F(0), ev = F(0);
        int16_t rc = -1;
        if (j < cnt) {
          const int code = hits[j * kAssignThreads + tid];
          const int k = code / noff, oi = code - k * noff;
          const int ia = oi / (nr * nr), ib = oi / nr - ia * nr,
                    ic = oi - (oi / nr) * nr;
          const int ox = olo + ia, oy = olo + ib, oz = olo + ic;
          F s0, s1, s2;
          if (SD) {
            const F* dd =
                dring + (k * depth + (i - x0 + nr - 1 - ia) % depth) * 3 *
                            area +
                (ty + nr - 1 - ib) * szw + tz + nr - 1 - ic;
            s0 = dd[0];
            s1 = dd[area];
            s2 = dd[2 * area];
          } else {
            const int64_t s = src_x(i, ox, a.n0, a.xbase) * pstride +
                              (int64_t)wrap(y - oy, a.n1) * a.n2 +
                              wrap(z - oz, a.n2);
            s0 = a.d[k][0][s];
            s1 = a.d[k][1][s];
            s2 = a.d[k][2][s];
          }
          e0 = s0 - (F)ox;
          e1 = s1 - (F)oy;
          e2 = s2 - (F)oz;
          ev = F(1);
          rc = (int16_t)code;
        }
        a.nd[j][0][t] = e0;
        a.nd[j][1][t] = e1;
        a.nd[j][2][t] = e2;
        a.nv[j][t] = ev;
        a.rt[j][t] = rc;
      }
    }
    // the next plane's codes, into the slot no thread reads here
    if (next) classify_plane(i + 1, nr - 1, a.K);
    __syncthreads();
  }
  // block sum of the overflow, then one atomic per block
  for (int o = 16; o > 0; o >>= 1)
    over += __shfl_down_sync(0xffffffffu, over, o);
  __shared__ unsigned int warp_over[kAssignThreads / 32];
  if ((tid & 31) == 0) warp_over[tid >> 5] = over;
  __syncthreads();
  if (tid == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kAssignThreads / 32; ++w) sum += warp_over[w];
    if (sum) atomicAdd(a.overflow, sum);
  }
}

// one thread per target cell: slot j takes every extra field of the
// image its route names, or 0 where the route is -1
template <class F>
__global__ void rebase_apply_kernel(ApplyArgs<F> a) {
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
        for (int c = 0; c < 3; ++c) a.ne[e][j][c][t] = F(0);
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

template <int NR, class C, bool SD, class F>
cudaError_t launch_assign_t(const AssignArgs<F>& a, int smem,
                            cudaStream_t stream) {
  // above the 48 KB a block gets by default, a kernel must ask for more
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)assign_staged<NR, C, SD, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((a.n2 + TZ - 1) / TZ, (a.n1 + TY - 1) / TY,
            (a.n0 + a.xc - 1) / a.xc);
  assign_staged<NR, C, SD, F><<<grid, kAssignThreads, smem, stream>>>(a);
  return cudaSuccess;
}

template <bool SD, class F>
cudaError_t launch_assign(const AssignArgs<F>& a, int smem,
                          cudaStream_t stream) {
  const int nr = a.ohi - a.olo + 1;
  switch (nr) {
#define ASSIGN_NR(NR) \
  case NR:            \
    return launch_assign_t<NR, uint8_t, SD, F>(a, smem, stream);
    ASSIGN_NR(2)
    ASSIGN_NR(3)
    ASSIGN_NR(4)
#undef ASSIGN_NR
    default:
      if (nr * nr * nr < 255)
        return launch_assign_t<NR_ANY, uint8_t, SD, F>(a, smem, stream);
      return launch_assign_t<NR_ANY, uint16_t, SD, F>(a, smem, stream);
  }
}

template <class F>
cudaError_t assign(const void* const* d, const void* const* v, int K,
                   void* const* nd, void* const* nv, void* const* rt,
                   int Kout, void* overflow, int n0, int n1, int n2,
                   int xbase, int olo, int ohi, int xc, int group,
                   int stage_d, int smem, cudaStream_t stream) {
  AssignArgs<F> a{};
  for (int k = 0; k < K; ++k) {
    for (int c = 0; c < 3; ++c) a.d[k][c] = (const F*)d[k * 3 + c];
    a.v[k] = (const F*)v[k];
  }
  for (int j = 0; j < Kout; ++j) {
    for (int c = 0; c < 3; ++c) a.nd[j][c] = (F*)nd[j * 3 + c];
    a.nv[j] = (F*)nv[j];
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
  a.xc = xc;
  a.group = group;
  return stage_d ? launch_assign<true, F>(a, smem, stream)
                 : launch_assign<false, F>(a, smem, stream);
}

template <class F>
void apply(const void* const* e, int nextra, int K, const void* const* rt,
           int Kout, void* const* ne, int n0, int n1, int n2, int xbase,
           int olo, int ohi, cudaStream_t stream) {
  ApplyArgs<F> a{};
  for (int x = 0; x < nextra; ++x) {
    for (int k = 0; k < K; ++k)
      for (int c = 0; c < 3; ++c)
        a.e[x][k][c] = (const F*)e[(x * K + k) * 3 + c];
    for (int j = 0; j < Kout; ++j)
      for (int c = 0; c < 3; ++c)
        a.ne[x][j][c] = (F*)ne[(x * Kout + j) * 3 + c];
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
  rebase_apply_kernel<F><<<grid_of(n0, n1, n2), kThreads, 0, stream>>>(a);
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
// of n0_in planes; xc, group, stage_d, smem: ops/binned_cuda.plan's
// target planes per block, slots per group, staged displacements and
// dynamic shared bytes; f64: the displacements, validity and outputs are
// f64, else f32
int pmesh_rebase_assign(const void* const* d, const void* const* v, int K,
                        void* const* nd, void* const* nv, void* const* rt,
                        int Kout, void* overflow, int n0, int n1, int n2,
                        int n0_in, int xbase, int olo, int ohi, int xc,
                        int group, int stage_d, int smem, int f64,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxSlots || Kout < 1 || Kout > kMaxSlots ||
      ohi < olo || ohi - olo + 1 > NR_MAX || !shape_ok(n0, n1, n2) ||
      !halo_ok(n0, n0_in, xbase, olo, ohi) || xc < 1 || group < 1 ||
      group > K || (stage_d && group != K) || smem < 1 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  int nr = ohi - olo + 1;
  if ((long long)K * nr * nr * nr > 32767) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = f64 ? assign<double>(d, v, K, nd, nv, rt, Kout, overflow, n0, n1, n2,
                             xbase, olo, ohi, xc, group, stage_d, smem, s)
            : assign<float>(d, v, K, nd, nv, rt, Kout, overflow, n0, n1, n2,
                            xbase, olo, ohi, xc, group, stage_d, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// e: nextra * K * 3 extra pointers, (e, k, axis)-major; rt: Kout route
// pointers (int16) from pmesh_rebase_assign with the same offsets;
// ne: nextra * Kout * 3 outputs, (e, j, axis)-major; n0 output
// planes; xbase >= 0: the x-halo form, extras of n0_in planes; f64: the
// extras and outputs are f64, else f32
int pmesh_rebase_apply(const void* const* e, int nextra, int K,
                       const void* const* rt, int Kout, void* const* ne,
                       int n0, int n1, int n2, int n0_in, int xbase, int olo,
                       int ohi, int f64, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nextra < 1 || nextra > kMaxExtras || K < 1 || K > kMaxSlots ||
      Kout < 1 || Kout > kMaxSlots || ohi < olo || !shape_ok(n0, n1, n2) ||
      !halo_ok(n0, n0_in, xbase, olo, ohi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    apply<double>(e, nextra, K, rt, Kout, ne, n0, n1, n2, xbase, olo, ohi, s);
  else
    apply<float>(e, nextra, K, rt, Kout, ne, n0, n1, n2, xbase, olo, ohi, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
