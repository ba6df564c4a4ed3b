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
// the MXU; here each pass is a short sequence of launches: split passes
// that form each product's data operand once (with the butterflies,
// folds and roundings), tensor-core product routines with the scales and
// the plane in their stores, and for the inverse x pass a butterfly
// sweep.
//
// The forward ct2 passes, pmesh_zy_fwd_ct2 (replacing _zy_fwd_ct2_call /
// _zy_forward_real_h_ct2) and pmesh_xct_multi (replacing _xct_call_multi
// / _x_transform_ct_multi and _xct_call), run their f32 products on the
// split-precision tensor-core routine (tc_ct, tc_z; see its section) and
// their bf16 products on tc_gemm behind split passes that fold the
// butterfly (see "the ct2 passes' bf16 products").
// What bounds them: the tensor cores at six bf16 products per real
// product against the bytes.  At 512^3 the forward zy pass is 60 G real
// FMA, the forward x pass 34 G, the dual inverse x pass 69 G: at 989
// TFLOP/s bf16 and 6 products per FMA, at least 0.73, 0.42 and 0.84 ms,
// against 0.32, 0.32 and 0.48 ms of compulsory bytes at 3.35 TB/s.  The
// design:
//  - one real GEMM per chunk on the host-laid-out block table, both
//    operands split into three bf16 parts, the data operand by the
//    threads; six products per real product on mma.sync.m16n8k16 (wgmma
//    needs swizzled descriptors that could not be checked without the
//    card: a later redesign), fragments by ldmatrix;
//  - each 16-deep step sums into a fresh partial that the CUDA cores add
//    to the accumulator, and a forward pass takes each data vector's
//    first element out before the products and adds it back through the
//    table's row or column sums in the epilogue: the tensor cores
//    truncate their sums, which is biased, and a large common value (the
//    mean density in the DC column) made that bias visible;
//  - the outputs that carry a mesh's mean (the first QZ modes of z chunk
//    0, column 0 of the y and x stages) are formed as the plain version
//    forms them, f32 FMA chains in contraction order: tc_z beside its
//    products, ct_fwd_col0 after tc_ct's (see their section);
//  - the operands through cp.async, 16-byte pieces where rows are
//    aligned (every ct2 shape of the main path), zero-filled tiles at a
//    ragged edge (row 13's W = 257), guarded scalar copies where a row
//    is not 16-byte aligned.  The ring is D = TC_DEPTH = 3 slices deep
//    where it fits: table tiles in D + 1 slots of 18,432 bytes, raw input
//    rows in D slots (R x 8 KB for an f32 forward, half for bf16), two
//    operand buffers.  Dynamic shared bytes: tc_ct forward R = 2 159,744,
//    R = 4 208,896, the inverse 135,168, tc_z 172,032 (Rz = 4) to 221,184
//    (Rz = 8); the f32 forward at R = 8 would need 307,200 of the 227 KB
//    and runs 2 deep (223,232: 3 table slots, 2 raw);
//  - the R-way forward butterfly, the 1/k^2 fold and the split computed
//    from shared memory into one of two operand buffers while the
//    tensor cores run the previous slice's products; one barrier per
//    slice.  The inverse butterfly stays a sweep of its own.
// ptxas (-O3, sm_90a, on the card): tc_ct 225-255 registers (the R = 8
// forward at 255 with 4 bytes of spill, the others none), tc_z 229,
// ct_fwd_col0 56; static shared memory 1024-1088 bytes (tc_ct) and 6208
// (tc_z) beside the ring: one block of 8 warps per SM.
//
// The dense forward passes, pmesh_x_dense (replacing _x_transform,
// pmesh_tpu/ops/fft_mxu.py:155: the forward, the dual inverse with the
// 1/k^2 fold, row 13's x pass at W = N2) and pmesh_zy_fwd_half
// (replacing _zy_forward_real_h, :470, through _zy_fwd_half_call; at Zh =
// N2 row 13's full-spectrum pass 1), run both their f32 and their
// bf16-product forms on tc_gemm, the same split products over operands
// that a split pass forms once per pass (see its section).  What bounds
// them: at 384^3 the forward x pass is 43.7 G real FMA, the z stage
// 21.9 G (real data: one real product per (row, k, mode part), the
// Nyquist mode chained, not tiled), the y stage 43.7 G: at six bf16
// products each and 989 TFLOP/s at least 0.53, 0.27 and 0.53 ms, against
// 0.136 ms of compulsory bytes per pass (and ~0.2 ms for the split
// tiles' round trip).  The outputs that carry the mean are formed as in
// the ct2 passes: z modes [0, QZ) in split_rows' chains, column 0 of the
// y and x stages by ct_fwd_col0 (its guarded form at M = 75 or 33).
// ptxas (-O3, sm_90a, on the card): see PERF.md's findings.
//
// The zy inverses, pmesh_zy_inv_ct2 and pmesh_zy_inv_ct2_dual (replacing
// _zy_inv_ct2_call / _zy_inverse_to_real_h_ct2 and its dual; at Zm = Zh
// row 13's half-CT inverse) and pmesh_zy_inv_half (replacing
// _zy_inverse_to_real_h through _zy_inv_half_call), run both product
// forms on tc_gemm: the y stage behind split_cols, the z stage as one
// real-output product behind split_zinv, which also forms the inverse y
// butterfly (see "the zy inverses on tc_gemm").  What bounds them: at
// 512^3 zy_inv_ct2 is 103 G real FMA (y 34.4 G, z 68.7 G), at least
// 1.25 ms at six bf16 products per FMA and 989 TFLOP/s, 0.21 ms at one,
// against 0.32 ms of compulsory bytes; zy_inv_half at 384^3 65.6 G.
//
// The rest of row 13 runs on the same routines, both product forms.
// pmesh_zy_inv_full: the complex z stage as ONE real-output tc_gemm of
// split_zinv's [xr | xi] tiles (R = 1) and the stacked table [[A, -B];
// [B, A]] (2 N2 output columns, zr then zi; at an odd N2 a tile's pair of
// columns can straddle the two), then the y stage's real part as one
// split_cols + tc_gemm (TG_YREAL) on the rows [Wr | -Wi] alone, 128 real
// outputs per table tile: half the products of the complex y DFT.  No
// first element is taken out (an inverse).  pmesh_zy_fwd_half_ct: the
// dense z stage of pmesh_zy_fwd_half (z_dense_tc, its scratch rows
// padded to 16 bytes), then the y CT behind split_ct, in three parts
// for the f32 products (each chunk's u_j[0] taken out and added back
// through the row sums, column 0 chained after by ct_fwd_col0, as every
// f32 forward CT stage does).  What bounds them: at 512^3 zy_inv_full
// is 412 G real FMA (z 275 G, y 137 G), at least 5.0 ms at six bf16
// products per FMA and 989 TFLOP/s, 0.83 ms at one; zy_fwd_half_ct 103
// G (z 69 G, y 34 G), 1.26 and 0.21 ms.
// The inverse CT butterfly of xct_multi runs as an in-place sweep over
// its products' output (ct_inv_butterfly), one thread per (row, column)
// group.

// The bf16 forms, set per call by two flags of every entry point:
//
//  - bf16 (fft='mxu_bf16', precision='bf16'): the single-pass bf16
//    products of the TPU kernels at jax.lax.Precision('default'): each
//    operand of each product rounded to bf16, the products summed in f32.
//    The passes of fft='mxu' run this form on tc_gemm (one part per
//    operand, one product per slice, no first element taken out, no
//    chains but the dense z stage's tail modes), their butterflies, folds
//    and roundings formed once per pass by the split passes.  Everything
//    between two products of one pass (the butterflies, the z-CT
//    combination, the scales, the plane) stays f32, and the next product
//    rounds it again as its operand, as on the TPU (row 13's full
//    inverse rounds its z output once, as the y stage's operand; a
//    negated table entry, -Im W, is exact in bf16).
//  - bf16s (fft='mxu_bf16s', the ct2 entry points' spectrum_dtype): the
//    spectra between the passes are stored in bf16: the loads upcast
//    them and the stores round once.  The products stay f32 (tc_ct and
//    tc_z for the forward passes; the zy inverses on tc_gemm, the bf16
//    spectrum one exact part against the three-part y table, three
//    products per real product).
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
#include <utility>

namespace {

constexpr int kMaxR = 8;

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

// --- the split-precision tensor-core products (tc_ct, tc_z) --------------
//
// The f32 products of pmesh_zy_fwd_ct2 and pmesh_xct_multi.  Each is ONE
// real GEMM: the complex table enters as the real block table
// [[Wr, -Wi], [Wi, Wr]] (two sets stacked for the dual), which the host
// lays out tile by tile and splits once into three bf16 parts, a = a1 +
// a2 + a3 (a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1 - a2): 24
// bits, f32's); the threads split the data operand the same way after
// the butterfly, the 1/k^2 fold and the scale.  A real product keeps the
// six terms down to 2^-16 of the leading one (a1b1; a1b2, a2b1; a1b3,
// a3b1, a2b2), each on mma.sync.m16n8k16.bf16 with f32 accumulators:
// bf16 products are exact in f32, and the dropped terms are below f32's
// rounding.  (Three TF32 terms keep each operand to 2^-22 only; a pass
// whose output sums large, nearly cancelling terms, as the imaginary
// part of a spectrum with a large mean does, then misses f32 by 10x.)
//
// A block computes a 128 x 128 output tile with 8 warps (2 x 4, 64 x 32
// each).  A table tile is 64 modes: its rows (tc_ct) or columns (tc_z)
// [0, 64) are the real parts and [64, 128) the imaginary parts.  Both
// operands sit in shared memory k-contiguous ([row][k], [col][k]) and
// reach the fragments through ldmatrix.  A slice of the contraction is
// 16 real columns, i.e. 8 complex data rows.  The operands arrive through
// cp.async (16-byte pieces, zero-filled past a ragged edge) into a ring
// D slices deep (tc_pipeline): the table tile of a slice into one of
// D + 1 slots, the RAW input rows it needs into one of D.  Iteration s
// waits for slice s + 1, issues the copies of slice s + D, forms the
// data operand of slice s + 1 from its raw rows (the R-way butterfly,
// the fold, the split) into one of two operand buffers and multiplies
// slice s from the other: one barrier per slice, and one warp's
// conversion overlaps another's products.

constexpr int TC_NT = 256;      // threads: 8 warps, 2 x 4 over the tile
constexpr int TC_ROWS = 128;    // rows of a block's output tile
constexpr int TC_COLS = 128;    // columns of a block's output tile
constexpr int TC_MODES = 64;    // complex modes per table tile
constexpr int TC_BK = 16;       // real contraction columns per slice
constexpr int TC_DR = TC_BK / 2;  // complex data rows per slice
constexpr int TC_PK = TC_BK + 8;  // k pitch (bf16) of an operand row:
                                  // 48 bytes, ldmatrix conflict-free
constexpr int TC_OPND = 3 * TC_ROWS * TC_PK * 2;  // bytes of a split tile
// dynamic shared bytes: the opt-in maximum less room for the static
// arrays (tc_z's 6.2 KB)
constexpr int TC_SMEM_MAX = 232448 - 7 * 1024;
// the copies of slice s + TC_DEPTH are issued while slice s is
// multiplied: TC_DEPTH + 1 table slots, TC_DEPTH raw slots, where they
// fit in shared memory (else 2: a forward pass at R = 8)
constexpr int TC_DEPTH = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when src_bytes
// is 0 (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices, lanes 8q .. 8q + 7 giving the row addresses
// of matrix q: r[q] holds row lane / 4, elements 2 (lane % 4) and + 1
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// the mbarriers and bulk copies (TMA) of tc_gemm's ring
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's generic-proxy accesses of shared memory before its
// later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16) global -> shared, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wait for the phase of bar with the given parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// the warpgroup products of tc_gemm (wgmma): a descriptor of a K-major
// operand tile of 32-byte rows (16 bf16) in the 32-byte swizzle (the two
// 16-byte halves of row r swapped where bit 2 of r is set, i.e. address
// bit 4 ^= bit 7, the tile 256-byte aligned): start >> 4, leading offset
// 1 (unused when swizzled), stride 256 bytes (8 rows) >> 4, layout
// SWIZZLE_32B
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin the 64 accumulator registers at this point: the compiler sees the
// products' asm as finished when issued, and would otherwise move reads
// and writes of the registers across the asynchronous products' wait
__device__ __forceinline__ void wg_pin(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (the warpgroup's 64 x 128 f32 tile: d[4 j + q] at row 16 (warp % 4) +
// lane / 4 + 8 (q / 2), column 8 j + 2 (lane % 4) + q % 2) = A B^T, plus d
// when acc: A (64 x 16) and B (128 x 16) K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// v = p1 + p2 + p3 in bf16 parts, each rounded to nearest even from the
// remainder (each remainder exact in f32): 24 bits of v, f32's
__device__ __forceinline__ void split3(float v, bf16_t* p) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

// the three parts of 4 values (consecutive k) into the rows of parts
// 0, 1, 2 at dst, dst + stride, dst + 2 stride: one 8-byte store each
__device__ __forceinline__ void st_split3(bf16_t* dst, int stride,
                                          const float* v) {
  bf16_t p[4][3];
#pragma unroll
  for (int q = 0; q < 4; ++q) split3(v[q], p[q]);
#pragma unroll
  for (int h = 0; h < 3; ++h) {
    __nv_bfloat162 lo, hi;
    lo.x = p[0][h];
    lo.y = p[1][h];
    hi.x = p[2][h];
    hi.y = p[3][h];
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst + h * stride) = w;
  }
}

// two adjacent outputs (a, a + 1): one 8- or 4-byte store when both are
// in range and a is even
__device__ __forceinline__ void st_pair(float* p, long long a, float v0,
                                        float v1, bool in0, bool in1) {
  if (in0 && in1 && (a & 1) == 0) {
    *reinterpret_cast<float2*>(p + a) = make_float2(v0, v1);
    return;
  }
  if (in0) p[a] = v0;
  if (in1) p[a + 1] = v1;
}
__device__ __forceinline__ void st_pair(bf16_t* p, long long a, float v0,
                                        float v1, bool in0, bool in1) {
  if (in0 && in1 && (a & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + a) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (in0) p[a] = __float2bfloat16_rn(v0);
  if (in1) p[a + 1] = __float2bfloat16_rn(v1);
}

// the accumulator of a warp's 64 x 32 corner
typedef float TcAcc[4][4][4];

__device__ __forceinline__ void zero_acc(TcAcc& a) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[mt][nt][q] = 0.f;
}

// acc += A (TC_ROWS x 16) B (16 x TC_COLS) for one slice: A split in
// [part][row][k], B in [part][col][k] (pitch TC_PK).  For each pair of
// 16-row tiles the six products sum into a fresh partial, smallest terms
// first, over all 4 column tiles, and the partial is added to acc on the
// CUDA cores: the tensor cores align a sum to its largest term and
// truncate it, so a running sum much larger than the new products would
// drop their low bits.  mid() runs while the first pair's products are
// in flight (the next slice's conversion: CUDA-core work that overlaps
// the tensor cores').
template <class Mid>
__device__ __forceinline__ void tc_mma_slice(TcAcc& acc, const bf16_t* A,
                                             const bf16_t* B, int wm, int wn,
                                             int lane, const Mid& mid) {
  constexpr int PART = TC_ROWS * TC_PK;
  uint32_t b[3][4][2];
#pragma unroll
  for (int h = 0; h < 3; ++h)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, B + h * PART +
                     (wn + np * 16 + lane % 8 + (lane / 16) * 8) * TC_PK +
                     ((lane / 8) % 2) * 8);
      b[h][2 * np][0] = r[0];
      b[h][2 * np][1] = r[1];
      b[h][2 * np + 1][0] = r[2];
      b[h][2 * np + 1][1] = r[3];
    }
  // (A part, B part) of the six terms, smallest first
  constexpr int PA_[6] = {1, 2, 0, 1, 0, 0}, PB_[6] = {1, 0, 2, 0, 1, 0};
#pragma unroll
  for (int mp = 0; mp < 2; ++mp) {
    uint32_t a[3][2][4];
#pragma unroll
    for (int h = 0; h < 3; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[h][i], A + h * PART +
                             (wm + (2 * mp + i) * 16 + lane % 16) * TC_PK +
                             (lane / 16) * 8);
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][nt][q] = 0.f;
#pragma unroll
    for (int t = 0; t < 6; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(part[i][nt], a[PA_[t]][i], b[PB_[t]][nt]);
    if (mp == 0) mid();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[2 * mp + i][nt][q] += part[i][nt][q];
  }
}

// The slice loop shared by tc_ct and tc_z, D copies deep: table tiles in
// a ring of D + 1 slots (slice s in slot s % (D + 1)), raw rows in a ring
// of D (s % D) and data operands in 2 buffers (s % 2).  Iteration s waits
// for slice s + 1's copies (those of s + 2 .. s + D - 1 may still be in
// flight), issues slice s + D's and multiplies slice s, converting slice
// s + 1 while the products run.  One commit group per slice.
template <int D, class Load, class Convert, class Mma>
__device__ __forceinline__ void tc_pipeline(int nks, const Load& load,
                                            const Convert& convert,
                                            const Mma& mma) {
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < nks) load(s);
    cp_async_commit();
  }
  cp_async_wait<D - 1>();
  __syncthreads();
  convert(0);
  for (int s = 0; s < nks; ++s) {
    cp_async_wait<D - 2>();
    __syncthreads();
    if (s + D < nks) load(s + D);
    cp_async_commit();
    mma(s, [&] {
      if (s + 1 < nks) convert(s + 1);
    });
  }
}

// the table tile of slice s: (3, 128, 16) bf16 from ts, contiguous, into
// rows of pitch TC_PK
__device__ __forceinline__ void load_table(bf16_t* dst, const bf16_t* ts,
                                           int tid) {
#pragma unroll
  for (int e = tid; e < 3 * TC_ROWS * 2; e += TC_NT)
    cp_async16(dst + (e / 2) * TC_PK + (e % 2) * 8, ts + e * 8, 16);
}

// The x / y CT (data = B).  Forward: out[o, j*M + q, n] = scale *
// sum_m W_j[q, m] u_j[m, n], u_j[m, n] = sum_r bt[r][j] fold(x[o, r*M + m,
// n]); inverse: y_j[m, n] = sum_q W_j[m, q] fold(x[o, j*M + q, n]) at
// out[o, j*M + m, n] (the butterfly sweep follows).  Block tile: table
// tile t (64 modes of set 1 for t < T1, else of set 2) x 128 columns.
template <class TI, class TO>
struct TcCt {
  const TI *xr, *xi;
  const bf16_t* tab;  // (R, T, nks, 3, TC_ROWS, TC_BK)
  const float* rsum;  // (nsets, R, M, 2): sum_m W_j[q, m] of each set
  TO *o1r, *o1i, *o2r, *o2i;
  const float *k2x, *k2y, *k2z;
  long long ostride;
  int M, R, ncols, W, T, T1, nks, aligned;
  float scale;
  Butter bt;
};

// shared bytes of a ring D deep over raw slots of raw_b bytes: the
// table ring, the raw ring, the operands
__host__ __device__ constexpr long long tc_ring_bytes(int D, long long raw_b) {
  return (D + 1LL) * TC_OPND + D * raw_b + 2LL * TC_OPND;
}
// the deepest ring up to TC_DEPTH that fits
__host__ __device__ constexpr int tc_depth(long long raw_b) {
  return tc_ring_bytes(TC_DEPTH, raw_b) <= TC_SMEM_MAX ? TC_DEPTH : 2;
}
template <class TI>
__host__ __device__ constexpr long long tc_ct_raw(int Rr) {
  return (long long)Rr * TC_DR * 2 * TC_COLS * (long long)sizeof(TI);
}
template <class TI>
__host__ __device__ constexpr long long tc_ct_smem(int Rr) {
  return tc_ring_bytes(tc_depth(tc_ct_raw<TI>(Rr)), tc_ct_raw<TI>(Rr));
}

// RR: the R of a forward pass (R raw rows per data row, summed by the
// butterfly), or 0 for an inverse (one raw row, row j*M + m)
template <class TI, class TO, int RR>
__global__ void __launch_bounds__(TC_NT) tc_ct(const TcCt<TI, TO> p) {
  constexpr bool INV = RR == 0;
  constexpr int Rr = INV ? 1 : RR;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float coef_r[kMaxR], coef_i[kMaxR];
  constexpr int EP = 16 / (int)sizeof(TI);   // elements per 16-byte piece
  constexpr int PCS = TC_COLS / EP;          // pieces per raw row
  constexpr int RSTEP = TC_NT / (2 * PCS);   // raw rows a pass of threads covers
  constexpr long long raw_b = tc_ct_raw<TI>(Rr);
  constexpr int D = tc_depth(raw_b);
  bf16_t* tabs = reinterpret_cast<bf16_t*>(tc_smem);
  unsigned char* raws = tc_smem + (D + 1) * TC_OPND;
  bf16_t* ops = reinterpret_cast<bf16_t*>(raws + D * raw_b);

  long long b = blockIdx.x;
  const int t = (int)(b % p.T);
  b /= p.T;
  const int j = (int)(b % p.R);
  b /= p.R;
  const long long tiles_n = (p.ncols + TC_COLS - 1) / TC_COLS;
  const long long n0 = (b % tiles_n) * TC_COLS, o = b / tiles_n;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid < p.R) {
    coef_r[tid] = p.bt.r[tid][j];
    coef_i[tid] = p.bt.i[tid][j];
  }
  const bf16_t* tsrc =
      p.tab + (long long)(j * p.T + t) * p.nks * (3 * TC_ROWS * TC_BK);
  const long long obase = o * p.ostride;

  // this thread's raw pieces: column piece pc of part (re, im) of the raw
  // rows rr0, rr0 + RSTEP, ...
  const int pc = tid % PCS, part = (tid / PCS) % 2, rr0 = tid / (2 * PCS);
  const bool pin = n0 + pc * EP < p.ncols;
  const TI* psrc = (part ? p.xi : p.xr) + obase + n0 + pc * EP;
  auto load = [&](int s) {
    load_table(tabs + (s % (D + 1)) * (TC_OPND / 2),
               tsrc + (long long)s * (3 * TC_ROWS * TC_BK), tid);
    TI* raw = reinterpret_cast<TI*>(raws + (s % D) * raw_b);
#pragma unroll
    for (int i = 0; i < Rr * TC_DR / RSTEP; ++i) {
      const int rr = rr0 + i * RSTEP;
      const long long row = (long long)(INV ? j : rr / TC_DR) * p.M +
                            s * TC_DR + rr % TC_DR;
      const TI* src = psrc + row * p.ncols;
      TI* dst = raw + (rr * 2 + part) * TC_COLS + pc * EP;
      if (p.aligned) {
        cp_async16(dst, pin ? src : p.xr, pin ? 16 : 0);
      } else {
        for (int q = 0; q < EP; ++q)
          stv(dst, q, n0 + pc * EP + q < p.ncols ? ldv(src, q) : 0.f);
      }
    }
  };

  // the data operand of slice s: thread (column c, data rows m4 .. m4 + 4)
  const int c = tid % TC_COLS, m4 = (tid / TC_COLS) * 4;
  const long long nc = n0 + c;
  const bool fold = p.k2x != nullptr;
  const float ky = fold && nc < p.ncols ? p.k2y[nc / p.W] : 0.f;
  const float kz = fold && nc < p.ncols ? p.k2z[nc % p.W] : 0.f;
  // u_j at data rows m4 + q (q < NQ) of slice s in this thread's column
  auto data = [&](const TI* raw, int s, int m4, auto nq, float* ur,
                  float* ui) {
    constexpr int NQ = decltype(nq)::value;
#pragma unroll
    for (int q = 0; q < NQ; ++q) ur[q] = ui[q] = 0.f;
#pragma unroll
    for (int r = 0; r < Rr; ++r) {
      const float cr = coef_r[r], ci = coef_i[r];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int mm = m4 + q;
        const int a = ((r * TC_DR + mm) * 2) * TC_COLS + c;
        float vr = ldv(raw, a), vi = ldv(raw, a + TC_COLS);
        if (fold) {
          const long long row =
              (long long)(INV ? j : r) * p.M + s * TC_DR + mm;
          const float k2 = p.k2x[row] + ky + kz;
          const float f = k2 > 0.f ? 1.f / k2 : 0.f;
          vr *= f;
          vi *= f;
        }
        if constexpr (INV) {
          ur[q] = vr;
          ui[q] = vi;
        } else {
          ur[q] = fmaf(cr, vr, fmaf(-ci, vi, ur[q]));
          ui[q] = fmaf(cr, vi, fmaf(ci, vr, ui[q]));
        }
      }
    }
  };
  // forward: the column's u_j at data row 0, taken out of every row
  // before the products (W (u - c) + c sum_m W) and added back in the
  // epilogue.  A column with a large mean (the DC column of a density)
  // otherwise sums large, nearly cancelling products, whose truncation
  // in the tensor cores is biased.  (An inverse pass reads a filtered
  // spectrum, whose first row is no common offset.)
  __shared__ float col0[2][TC_COLS];
  float c0r = 0.f, c0i = 0.f;
  auto convert = [&](int s) {
    const TI* raw = reinterpret_cast<const TI*>(raws + (s % D) * raw_b);
    if (s == 0 && !INV) {
      data(raw, 0, 0, std::integral_constant<int, 1>(), &c0r, &c0i);
      if (m4 == 0) {
        col0[0][c] = c0r;
        col0[1][c] = c0i;
      }
    }
    float ur[4], ui[4];
    data(raw, s, m4, std::integral_constant<int, 4>(), ur, ui);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ur[q] -= c0r;
      ui[q] -= c0i;
    }
    bf16_t* op = ops + (s % 2) * (TC_OPND / 2) + c * TC_PK;
    st_split3(op + m4, TC_ROWS * TC_PK, ur);
    st_split3(op + TC_DR + m4, TC_ROWS * TC_PK, ui);
  };

  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  TcAcc acc;
  zero_acc(acc);
  auto mma = [&](int s, const auto& mid) {
    tc_mma_slice(acc, tabs + (s % (D + 1)) * (TC_OPND / 2),
                 ops + (s % 2) * (TC_OPND / 2), wm, wn, lane, mid);
  };
  tc_pipeline<D>(p.nks, load, convert, mma);

  // rows [0, 64) of the tile are real parts (warps of wm = 0), the rest
  // imaginary; each output gets back c sum_m W[q, m]
  const bool set2 = t >= p.T1;
  const int tt = set2 ? t - p.T1 : t, gid = lane / 4, tig = lane % 4;
  TO* out = wm == 0 ? (set2 ? p.o2r : p.o1r) : (set2 ? p.o2i : p.o1i);
  const float* rs = p.rsum + ((long long)(set2 ? p.R : 0) + j) * p.M * 2;
  if (INV && tid < TC_COLS) col0[0][tid] = col0[1][tid] = 0.f;
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tt * TC_MODES + mt * 16 + gid + h * 8;
      const float sr = rs[2 * q], si = rs[2 * q + 1];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int lc = wn + nt * 8 + 2 * tig;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cr = col0[0][lc + e], ci = col0[1][lc + e];
          const float back = wm == 0 ? fmaf(cr, sr, -ci * si)
                                     : fmaf(cr, si, ci * sr);
          v[e] = (acc[mt][nt][2 * h + e] + back) * p.scale;
        }
        const long long n = n0 + lc;
        st_pair(out, obase + ((long long)j * p.M + q) * p.ncols + n, v[0],
                v[1], n < p.ncols, n + 1 < p.ncols);
      }
    }
}

// --- the outputs that carry the mean, summed as the plain version does ---
//
// On a mesh with a large mean (a density, 1 + delta), a few outputs of
// the forward passes are long sums of large, nearly cancelling terms:
// the first modes of z chunk 0 (whose butterfly sums the whole row, so
// its data carries Rz times the mean) and column 0 of the y and x CT
// stages (the kz = 0 column and the ky = kz = 0 line, which hold row and
// plane sums).  A sequential f32 sum rounds them by up to 4e-4 of
// max|imag| of the spectrum at (512, 256, 1024) (tools/plain_f32_gap.py);
// the split products round them far less, so kernel and plain version
// would differ there by the f32 sum's own error.  The passes form these
// outputs as the plain version (ops/fft_mxu.py) does, tc_z beside its
// products (the chunk-0 blocks of the first mode tile) and ct_fwd_col0
// after tc_ct's: its butterfly term by term (a coefficient
// of +-1 exact, |c| < 1e-30 skipped, no fused multiply-add), each real
// product one f32 fused multiply-add chain in contraction order (as
// torch.matmul's sgemm sums), the complex parts combined
// and scaled after.  Elsewhere the f32 sums round less, and the split
// products stay within 1e-5 of them.  QZ chunk-0 modes (z = 0, Rz, ...,
// (QZ - 1) Rz; stored columns [0, QZ)) are formed so: past them the f32
// sums round by less than 1e-6 of max|imag| (tools/plain_f32_gap.py,
// on the CPU at (512, 256, 1024)).
constexpr int QZ = 8;

// b + coef * a, as the plain butterfly (_cmadd) adds a term
__device__ __forceinline__ float bterm(float b, float coef, float a) {
  if (fabsf(coef) < 1e-30f) return b;
  const float t = coef == 1.f ? a : (coef == -1.f ? -a : __fmul_rn(a, coef));
  return __fadd_rn(b, t);
}

constexpr int C0_G = 4;     // outer blocks per ct_fwd_col0 block
constexpr int C0_Q = 64;    // outputs q per block, one per thread

// dynamic shared bytes of ct_fwd_col0: u of C0_G blocks
__host__ __device__ constexpr long long col0_smem(int M) {
  return 2LL * C0_G * M * 4;
}

// column 0 of a forward CT stage over (nouter, R M, ncols) blocks, for C0_G
// blocks o, one chunk j and C0_Q outputs q per block, one thread per q:
// u[m] = sum_r b[r][j] fold(x[o, r M + m, 0]) in shared memory, then
// out[o, j M + q, 0] = scale (sum_m wr[q, m] ur[m] - sum_m wi[q, m]
// ui[m]) + i scale (sum_m wr[q, m] ui[m] + sum_m wi[q, m] ur[m]), (wr, wi)
// the (R, M, M) tables, each sum one chain in m order, the thread reading
// its table rows as it goes (float4 where M is a multiple of 4, the rows
// then 16-byte aligned; else scalar: the dense passes' M = 75 or 33);
// fold as the plain version's: times 1/k^2 (0 at k^2 = 0) of row r M +
// m, k^2 = (k2x + k2y[0]) + k2z[0], when k2x is set.  x is read at o
// istride + row ipitch, out written at o ostride + row ncols.
template <class TI, class TO>
__global__ void __launch_bounds__(C0_Q)
    ct_fwd_col0(const TI* xr, const TI* xi, const float* __restrict__ wr,
                const float* __restrict__ wi, TO* outr, TO* outi,
                const float* k2x, const float* k2y, const float* k2z,
                long long nouter, long long istride, long long ipitch,
                long long ostride, int M, int R, int ncols, float scale,
                Butter bt) {
  extern __shared__ float c0_smem[];
  float* u = c0_smem;                 // [g][ur | ui][M]
  const long long o0 = (long long)blockIdx.x * C0_G;
  const int j = blockIdx.y, tid = threadIdx.x;
  const int q = blockIdx.z * C0_Q + tid;
  const int G = (int)min((long long)C0_G, nouter - o0);
  for (int e = tid; e < C0_G * M; e += blockDim.x) {
    const int g = e / M, m = e % M;
    float ar = 0.f, ai = 0.f;
    if (g < G) {
      const long long base = (o0 + g) * istride;
      for (int r = 0; r < R; ++r) {
        const long long a = base + (long long)(r * M + m) * ipitch;
        float vr = ldv(xr, a), vi = ldv(xi, a);
        if (k2x != nullptr) {
          const float kk =
              __fadd_rn(__fadd_rn(k2x[r * M + m], k2y[0]), k2z[0]);
          const float f = kk > 0.f ? __frcp_rn(kk) : 0.f;
          vr = __fmul_rn(vr, f);
          vi = __fmul_rn(vi, f);
        }
        const float cr = bt.r[r][j], ci = bt.i[r][j];
        ar = bterm(bterm(ar, cr, vr), -ci, vi);
        ai = bterm(bterm(ai, ci, vr), cr, vi);
      }
    }
    u[2 * g * M + m] = ar;
    u[(2 * g + 1) * M + m] = ai;
  }
  __syncthreads();
  if (q >= M) return;
  const float* ra = wr + ((long long)j * M + q) * M;
  const float* rb = wi + ((long long)j * M + q) * M;
  float acc[C0_G][4];  // [g][sum wr ur, wi ui, wr ui, wi ur]
#pragma unroll
  for (int g = 0; g < C0_G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  auto step = [&](int m, float a, float b) {
#pragma unroll
    for (int g = 0; g < C0_G; ++g) {
      const float ur = u[2 * g * M + m], ui = u[(2 * g + 1) * M + m];
      acc[g][0] = fmaf(a, ur, acc[g][0]);
      acc[g][1] = fmaf(b, ui, acc[g][1]);
      acc[g][2] = fmaf(a, ui, acc[g][2]);
      acc[g][3] = fmaf(b, ur, acc[g][3]);
    }
  };
  if (M % 4 == 0) {
    for (int m = 0; m < M; m += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(ra + m));
      const float4 b = __ldg(reinterpret_cast<const float4*>(rb + m));
      step(m, a.x, b.x);
      step(m + 1, a.y, b.y);
      step(m + 2, a.z, b.z);
      step(m + 3, a.w, b.w);
    }
  } else {
    for (int m = 0; m < M; ++m) step(m, __ldg(ra + m), __ldg(rb + m));
  }
#pragma unroll
  for (int g = 0; g < C0_G; ++g)
    if (g < G) {
      const long long at = (o0 + g) * ostride + (long long)(j * M + q) * ncols;
      stv(outr, at, __fmul_rn(__fsub_rn(acc[g][0], acc[g][1]), scale));
      stv(outi, at, __fmul_rn(__fadd_rn(acc[g][2], acc[g][3]), scale));
    }
}

// The z forward (data = A): chunk p of (rows, N2) real x, u[m, k] =
// sum_r c[r][p] x[m, r*K + k] (Rz = 1, c = 1: the dense half-DFT), times
// the chunk's (K x nmodes) complex table into columns [p*nmodes,
// (p+1)*nmodes) of the (rows, Zm) outputs.  Block tile: 128 rows x table
// tile t (64 modes).
struct TcZ {
  const float* x;
  const bf16_t* tab;  // (Rz, T, nks, 3, TC_COLS, TC_BK)
  const float* csum;  // (Rz, nmodes, 2): sum_k E_p[k, mode]
  const float *er, *ei;  // chunk 0's f32 (K, nmodes) tables
  float *sr, *si;
  long long rows;
  int N2, Rz, K, nmodes, Zm, T, nks, aligned;
  Butter c;
};

__host__ __device__ constexpr long long tc_z_raw(int Rz) {
  return (long long)TC_ROWS * (Rz * TC_DR + 8) * 4;
}
// tc_z's ring is TC_DEPTH deep at every Rz
static_assert(tc_depth(tc_z_raw(kMaxR)) == TC_DEPTH, "the tc_z ring fits");
__host__ __device__ constexpr long long tc_z_smem(int Rz) {
  return tc_ring_bytes(TC_DEPTH, tc_z_raw(Rz));
}

__global__ void __launch_bounds__(TC_NT) tc_z(const TcZ p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float coef_r[kMaxR], coef_i[kMaxR];
  const int RP = p.Rz * TC_DR + 8;  // raw row pitch (floats)
  constexpr int D = TC_DEPTH;
  const long long raw_b = tc_z_raw(p.Rz);
  bf16_t* tabs = reinterpret_cast<bf16_t*>(tc_smem);
  unsigned char* raws = tc_smem + (D + 1) * TC_OPND;
  bf16_t* ops = reinterpret_cast<bf16_t*>(raws + D * raw_b);

  long long b = blockIdx.x;
  const int t = (int)(b % p.T);
  b /= p.T;
  const int pc = (int)(b % p.Rz);
  const long long m0 = (b / p.Rz) * TC_ROWS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid < p.Rz) {
    coef_r[tid] = p.c.r[tid][pc];
    coef_i[tid] = p.c.i[tid][pc];
  }
  const bf16_t* tsrc =
      p.tab + (long long)(pc * p.T + t) * p.nks * (3 * TC_COLS * TC_BK);

  auto load = [&](int s) {
    load_table(tabs + (s % (D + 1)) * (TC_OPND / 2),
               tsrc + (long long)s * (3 * TC_COLS * TC_BK), tid);
    float* raw = reinterpret_cast<float*>(raws + (s % D) * raw_b);
    const int per = p.Rz * (TC_DR / 4);  // 16-byte pieces per raw row
    for (int e = tid; e < TC_ROWS * per; e += TC_NT) {
      const int mr = e / per, r = (e % per) / (TC_DR / 4), k4 = e % (TC_DR / 4);
      const long long m = m0 + mr;
      const int k = s * TC_DR + k4 * 4;
      const float* src = p.x + m * p.N2 + (long long)r * p.K + k;
      float* dst = raw + mr * RP + r * TC_DR + k4 * 4;
      if (p.aligned) {
        const bool in = m < p.rows && k < p.K;
        cp_async16(dst, in ? src : p.x, in ? 16 : 0);
      } else {
        for (int q = 0; q < 4; ++q)
          dst[q] = (m < p.rows && k + q < p.K) ? src[q] : 0.f;
      }
    }
  };

  // the data operand of slice s: thread (row mr, k0 .. k0 + 4); the
  // row's u at k = 0 is taken out of every k and added back in the
  // epilogue, as in tc_ct
  const int mr = tid / 2, k0 = (tid % 2) * 4;
  __shared__ float row0[2][TC_ROWS];
  float c0r = 0.f, c0i = 0.f;
  // the blocks of chunk 0's first mode tile also form its modes [0, nq)
  // as the plain version does: each row's u (the row's sum over the
  // chunks) through shared memory to the row's first thread, which runs
  // one f32 FMA chain per output in k order
  const bool mean = pc == 0 && t == 0;
  const int nq = min(QZ, p.nmodes);
  __shared__ float u0s[TC_ROWS][TC_DR];
  // (er, ei)[k, q < QZ] of slice s in etab[s % 2], staged during the
  // conversion of slice s - 1 (zero past K and nq)
  __shared__ float etab[2][TC_DR][2][QZ];
  auto etab_load = [&](int s) {
    if (tid < TC_DR * 2 * QZ) {
      const int kk = tid / (2 * QZ), h = (tid / QZ) % 2, q = tid % QZ;
      const int k = s * TC_DR + kk;
      etab[s % 2][kk][h][q] =
          k < p.K && q < nq ? (h ? p.ei : p.er)[(long long)k * p.nmodes + q]
                            : 0.f;
    }
  };
  if (mean) etab_load(0);
  float mzr[QZ], mzi[QZ];
#pragma unroll
  for (int q = 0; q < QZ; ++q) mzr[q] = mzi[q] = 0.f;
  auto convert = [&](int s) {
    const float* raw = reinterpret_cast<const float*>(raws + (s % D) * raw_b);
    float ur[4] = {0.f, 0.f, 0.f, 0.f}, ui[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= p.Rz) break;
      const float4 v = *reinterpret_cast<const float4*>(raw + mr * RP +
                                                        r * TC_DR + k0);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ur[q] = fmaf(coef_r[r], vv[q], ur[q]);
        ui[q] = fmaf(coef_i[r], vv[q], ui[q]);
      }
    }
    if (s == 0) {
      if (k0 == 0) {
        c0r = ur[0];
        c0i = ui[0];
        row0[0][mr] = c0r;
        row0[1][mr] = c0i;
      } else {
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r >= p.Rz) break;
          const float v = raw[mr * RP + r * TC_DR];
          c0r = fmaf(coef_r[r], v, c0r);
          c0i = fmaf(coef_i[r], v, c0i);
        }
      }
    }
    if (mean) {
      if (s + 1 < p.nks) etab_load(s + 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) u0s[mr][k0 + q] = ur[q];
      __syncwarp();
      if (k0 == 0) {
        const float(*e)[2][QZ] = etab[s % 2];
        for (int kk = 0; kk < TC_DR; ++kk) {
          if (s * TC_DR + kk >= p.K) break;
          const float u = u0s[mr][kk];
#pragma unroll
          for (int q = 0; q < QZ; ++q)
            if (q < nq) {
              mzr[q] = fmaf(u, e[kk][0][q], mzr[q]);
              mzi[q] = fmaf(u, e[kk][1][q], mzi[q]);
            }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ur[q] -= c0r;
      ui[q] -= c0i;
    }
    bf16_t* op = ops + (s % 2) * (TC_OPND / 2) + mr * TC_PK;
    st_split3(op + k0, TC_ROWS * TC_PK, ur);
    st_split3(op + TC_DR + k0, TC_ROWS * TC_PK, ui);
  };

  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  TcAcc acc;
  zero_acc(acc);
  auto mma = [&](int s, const auto& mid) {
    tc_mma_slice(acc, ops + (s % 2) * (TC_OPND / 2),
                 tabs + (s % (D + 1)) * (TC_OPND / 2), wm, wn, lane, mid);
  };
  tc_pipeline<D>(p.nks, load, convert, mma);

  // columns [0, 64) of the tile are real parts (warps of wn < 64); each
  // output gets back c sum_k E[k, mode]
  const int gid = lane / 4, tig = lane % 4;
  const bool re = wn < TC_MODES;
  float* out = re ? p.sr : p.si;
  const float* cs = p.csum + (long long)pc * p.nmodes * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int mode = t * TC_MODES + (wn % TC_MODES) + nt * 8 + 2 * tig;
    float sr[2], si[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = mode + e < p.nmodes;
      sr[e] = in ? cs[2 * (mode + e)] : 0.f;
      si[e] = in ? cs[2 * (mode + e) + 1] : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = wm + mt * 16 + gid + h * 8;
        const long long m = m0 + lr;
        const float cr = row0[0][lr], ci = row0[1][lr];
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = acc[mt][nt][2 * h + e] +
                 (re ? fmaf(cr, sr[e], -ci * si[e])
                                               : fmaf(cr, si[e], ci * sr[e]));
        st_pair(out, m * p.Zm + (long long)pc * p.nmodes + mode, v[0], v[1],
                m < p.rows && mode < p.nmodes,
                m < p.rows && mode + 1 < p.nmodes);
      }
  }
  // the mean's modes over the products' values
  if (mean) {
    __syncthreads();
    const long long m = m0 + mr;
    if (k0 == 0 && m < p.rows)
#pragma unroll
      for (int q = 0; q < QZ; ++q)
        if (q < nq) {
          p.sr[m * p.Zm + q] = mzr[q];
          p.si[m * p.Zm + q] = mzi[q];
        }
  }
}

// --- the dense passes on the tensor cores (tc_gemm) ---------------------
//
// The f32 and bf16-product forms of pmesh_x_dense and pmesh_zy_fwd_half.
// A dense pass is tc_ct at R = 1, but with no butterfly to fuse, each
// data slice would be re-read and re-split for every 64-mode table tile
// (6 times at N0 = 384, 12 for the dual): the ct2 routine spends as much
// on that conversion as on its products.  Here a split pass forms each data
// operand ONCE, as the GEMM's slice tiles in device memory (the fold,
// the taken-out first element, the three bf16 parts; one part, the
// rounding, in the bf16 form), and tc_gemm multiplies pre-split tiles
// only.  Since the tiles are contiguous and laid out in advance (in the
// 32-byte swizzle), each slice of both operands is two bulk copies (TMA)
// into a ring tg_depth slices deep, and two warpgroups multiply it with
// wgmma.m64n128k16 straight from shared memory, the six products of a
// slice into a fresh partial (as tc_mma_slice sums them) that the CUDA
// cores add to the accumulator.  The split tiles cost 12 bytes per
// complex element written and read once more (at 384^3 about 0.2 ms of a
// pass's bytes); the other table tiles of a column tile read them from
// L2 (blocks that share a data tile are adjacent in launch order).
// Measured on the card at 384^3 (PERF.md), the forward x pass's
// products: mma.sync fed by 16-byte cp.async 2.17 ms, fed by bulk copies
// 1.43, wgmma 1.18; a wgmma loop that kept one slice in flight (two
// partials) was slower, 1.29.
//
//   split_cols   the x / y stage's data: column c of (nouter, M, ncols)
//                complex blocks (c = o ncols + n), rows in slices of 8
//                (re | im), into (ceil(nall / 128), nks, NP, 128, 16);
//   split_rows   the z stage's real data: rows of (rows, N2) in slices of
//                16 k, into (ceil(rows / 128), nks, NP, 128, 16); it also
//                forms the chained modes (the first QZ, which carry the
//                mean, and a short tail past the last whole table tile,
//                the Nyquist mode at 384^3, whose tile would be 63/64
//                padding) in f32 FMA chains in k order, as plain does;
//   tc_gemm      a 128 x 128 output tile per block of 8 warps: table
//                tile t x data tile (x / y: rows = modes, re | im, or
//                128 real output rows; z: columns = modes, re | im; z
//                inverse: 128 real output columns), the first element
//                added back through the table's sums, then scaled and
//                stored.

// The output form of a tc_gemm: TG_XY, the data is the column operand
// and a table tile's rows are 64 modes (re | im); TG_YREAL, the data is
// the column operand and a table tile's rows are 128 real outputs (the
// real part of a dense complex DFT: rows [Wr | -Wi]); TG_Z, the data is
// the row operand and a table tile's columns are 64 modes (re | im);
// TG_ZREAL, the data is the row operand and a table tile's columns are
// 128 real outputs (the z inverse, see its section)
enum TgMode { TG_XY, TG_YREAL, TG_Z, TG_ZREAL };

// slices in flight in tc_gemm's ring by the parts of its two operands: 4
// of three-part tiles, 6 of a three-part table on one-part data, 8 of
// one-part ones (whose passes are 16 slices long at M = 128)
template <int NPT, int NPD>
__host__ __device__ constexpr int tg_depth() {
  return NPT + NPD <= 2 ? 8 : (NPT + NPD <= 4 ? 6 : 4);
}
constexpr int TG_SLICE = TC_ROWS * TC_BK;   // bf16 of one part of a slice tile
constexpr int ZCH = 16;        // chained z modes at most: QZ + a tail of 8

// the ring's bytes, and room to align it to 1024 bytes (the swizzle works
// on absolute shared-memory addresses, and the dynamic region starts
// after the static one)
template <int NPT, int NPD>
__host__ __device__ constexpr int tg_smem() {
  return tg_depth<NPT, NPD>() * (NPT + NPD) * TG_SLICE * 2 + 1024;
}

// the NP parts of 16 values (row r of a tile) into dst + h TG_SLICE (h <
// NP), 32 bytes each: three bf16 parts (split3), or the bf16 rounding (NP
// = 1); the two 16-byte halves swapped where bit 2 of r is set (the
// 32-byte swizzle of gmma_desc)
template <int NP>
__device__ __forceinline__ void st_parts16(bf16_t* dst, const float* v,
                                           int r) {
  uint32_t w[NP][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bf16_t a[3], b[3];
    if constexpr (NP == 3) {
      split3(v[2 * i], a);
      split3(v[2 * i + 1], b);
    } else {
      a[0] = __float2bfloat16_rn(v[2 * i]);
      b[0] = __float2bfloat16_rn(v[2 * i + 1]);
    }
#pragma unroll
    for (int h = 0; h < NP; ++h)
      w[h][i] = (uint32_t)__bfloat16_as_ushort(a[h]) |
                ((uint32_t)__bfloat16_as_ushort(b[h]) << 16);
  }
  const int sw = (r >> 2) & 1;
#pragma unroll
  for (int h = 0; h < NP; ++h) {
    uint4* d = reinterpret_cast<uint4*>(dst + h * TG_SLICE);
    d[sw] = make_uint4(w[h][0], w[h][1], w[h][2], w[h][3]);
    d[1 - sw] = make_uint4(w[h][4], w[h][5], w[h][6], w[h][7]);
  }
}

struct SplitCols {
  const void *xr, *xi;           // TI: f32, or bf16 (a bf16s spectrum)
  const float *k2x, *k2y, *k2z;  // the 1/k^2 fold, or null
  bf16_t* dst;                   // (ceil(nall / 128), nks, NP, 128, 16)
  float* c0;                     // (nall, 2): the taken-out u[0], or null
  long long istride, nall;       // input: outer stride; columns in all
  int M, ncols, ipitch, W, nks;
};

constexpr int SPLIT_SG = 8;   // slices per split_cols block

// one block of 128 threads per column tile and group of SPLIT_SG slices
// (blockIdx.y), one thread per column: data row m = 8 s + r of column c
// at slice s, column r (re) and 8 + r (im); zero past M and nall
template <int NP, class TI>
__global__ void __launch_bounds__(128) split_cols(const SplitCols p) {
  const TI* xr = static_cast<const TI*>(p.xr);
  const TI* xi = static_cast<const TI*>(p.xi);
  const long long tile = blockIdx.x;
  const int tid = threadIdx.x, s0 = blockIdx.y * SPLIT_SG;
  const long long c = tile * 128 + tid;
  const bool in = c < p.nall;
  long long base = 0;
  float ky = 0.f, kz = 0.f;
  if (in) {
    const long long o = c / p.ncols, n = c % p.ncols;
    base = o * p.istride + n;
    if (p.k2x != nullptr) {
      ky = p.k2y[n / p.W];
      kz = p.k2z[n % p.W];
    }
  }
  // fold(x[row m]) as the plain version's (1/k^2, 0 at k^2 = 0)
  auto val = [&](int m, float& vr, float& vi) {
    const long long a = base + (long long)m * p.ipitch;
    vr = ldv(xr, a);
    vi = ldv(xi, a);
    if (p.k2x != nullptr) {
      const float kk = __fadd_rn(__fadd_rn(p.k2x[m], ky), kz);
      const float f = kk > 0.f ? __frcp_rn(kk) : 0.f;
      vr = __fmul_rn(vr, f);
      vi = __fmul_rn(vi, f);
    }
  };
  float c0r = 0.f, c0i = 0.f;
  if (p.c0 != nullptr && in) {
    val(0, c0r, c0i);
    if (s0 == 0) {
      p.c0[2 * c] = c0r;
      p.c0[2 * c + 1] = c0i;
    }
  }
  bf16_t* dst = p.dst + tile * p.nks * (NP * TG_SLICE) + tid * TC_BK;
  for (int s = s0; s < min(p.nks, s0 + SPLIT_SG); ++s) {
    float v[16];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = s * 8 + r;
      v[r] = v[8 + r] = 0.f;
      if (in && m < p.M) {
        val(m, v[r], v[8 + r]);
        v[r] -= c0r;
        v[8 + r] -= c0i;
      }
    }
    st_parts16<NP>(dst + (long long)s * (NP * TG_SLICE), v, tid);
  }
}

struct SplitRows {
  const float* x;         // (rows, N2) real
  const float *er, *ei;   // the f32 (N2, Zh) half-DFT pair
  bf16_t* dst;            // (ceil(rows / 128), nks, NP, 128, 16)
  float* c0;              // (rows): the taken-out x[., 0], or null
  float *zr, *zi;         // the z output (rows, pitch): the chained modes
  long long rows;
  int N2, Zh, pitch, nlo, tail0, nks, aligned;
};

// one block of 128 threads per row tile, one thread per row: k = 16 s + kk
// at slice s, column kk, zero past N2.  Chained modes: [0, nlo) and
// [tail0, Zh), each an f32 FMA chain in k order over the row (in the
// bf16 form of operands rounded to bf16), the table's 16-k slice of them
// staged through shared memory.
template <int NP>
__global__ void __launch_bounds__(128) split_rows(const SplitRows p) {
  __shared__ __align__(16) float et[TC_BK][ZCH][2];
  __shared__ float xt[128][TC_BK + 1];   // the slice's rows, staged
  const long long tile = blockIdx.x;
  const int tid = threadIdx.x;
  const long long m = tile * 128 + tid;
  const bool in = m < p.rows;
  const int nch = p.nlo + (p.Zh - p.tail0);
  float c0 = 0.f;
  if (p.c0 != nullptr && in) {
    c0 = p.x[m * p.N2];
    p.c0[m] = c0;
  }
  float ar[ZCH], ai[ZCH];
#pragma unroll
  for (int i = 0; i < ZCH; ++i) ar[i] = ai[i] = 0.f;
  bf16_t* dst = p.dst + tile * p.nks * (NP * TG_SLICE) + tid * TC_BK;
  for (int s = 0; s < p.nks; ++s) {
    const int k0 = s * TC_BK;
    // the (128, 16) slice through shared memory, consecutive threads on
    // consecutive columns of a row (float4 where the rows allow it)
    __syncthreads();
    if (p.aligned && k0 + TC_BK <= p.N2) {
#pragma unroll
      for (int e = tid; e < 128 * 4; e += 128) {
        const long long mm = tile * 128 + e / 4;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (mm < p.rows)
          t = *reinterpret_cast<const float4*>(p.x + mm * p.N2 + k0 +
                                               4 * (e % 4));
        float* d = &xt[e / 4][4 * (e % 4)];
        d[0] = t.x;
        d[1] = t.y;
        d[2] = t.z;
        d[3] = t.w;
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < 128 * TC_BK; e += 128) {
        const long long mm = tile * 128 + e / TC_BK;
        const int k = k0 + e % TC_BK;
        xt[e / TC_BK][e % TC_BK] =
            mm < p.rows && k < p.N2 ? p.x[mm * p.N2 + k] : 0.f;
      }
    }
    __syncthreads();
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = xt[tid][q];
    if (nch > 0) {
      for (int e = tid; e < TC_BK * ZCH * 2; e += 128) {
        const int kk = e / (2 * ZCH), i = (e / 2) % ZCH, h = e % 2;
        const int k = k0 + kk;
        float w = 0.f;
        if (i < nch && k < p.N2) {
          const int mode = i < p.nlo ? i : p.tail0 + (i - p.nlo);
          w = (h ? p.ei : p.er)[(long long)k * p.Zh + mode];
          if constexpr (NP == 1) w = __bfloat162float(__float2bfloat16_rn(w));
        }
        et[kk][i][h] = w;
      }
      __syncthreads();
      const int kn = in ? min(TC_BK, p.N2 - k0) : 0;
      for (int kk = 0; kk < kn; ++kk) {
        float u = v[kk];
        if constexpr (NP == 1) u = __bfloat162float(__float2bfloat16_rn(u));
#pragma unroll
        for (int i = 0; i < ZCH; i += 2) {
          if (i >= nch) break;
          const float4 w = *reinterpret_cast<const float4*>(&et[kk][i][0]);
          ar[i] = fmaf(u, w.x, ar[i]);
          ai[i] = fmaf(u, w.y, ai[i]);
          ar[i + 1] = fmaf(u, w.z, ar[i + 1]);
          ai[i + 1] = fmaf(u, w.w, ai[i + 1]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (k0 + q < p.N2) v[q] -= c0;
    st_parts16<NP>(dst + (long long)s * (NP * TG_SLICE), v, tid);
  }
  if (in)
    for (int i = 0; i < nch; ++i) {
      const int mode = i < p.nlo ? i : p.tail0 + (i - p.nlo);
      p.zr[m * p.pitch + mode] = ar[i];
      p.zi[m * p.pitch + mode] = ai[i];
    }
}

// --- the ct2 passes' bf16 products on tc_gemm ------------------------------
//
// The bf16-product forms of pmesh_xct_multi and pmesh_zy_fwd_ct2, and
// both forms of the half-CT pass 1's y stage (its f32 products split in
// three parts, each chunk's first element taken out as tc_ct takes it
// out).  A forward CT stage's operand is a
// butterfly: u_j[m] = sum_r b[r][j] fold(x[r M + m]) for each of the R
// chunks j.  Formed in a product's operand loader, each input value
// would be read and butterflied once per chunk and table tile (8 times
// per x pass at 512^3); a split pass reads each input value once, forms
// every chunk's butterfly from the R values of a row in f32, term by
// term in the plain version's order (bterm_c), and rounds it once to
// bf16 into tc_gemm's data tiles, which hold R M rows per column as the
// input does.  tc_gemm then runs the R chunks' products, chunk j on
// its own (M, M) block table and its own slices of the data tiles.  An
// inverse stage has no butterfly before its products: split_cols folds
// 1/k^2 and rounds, tc_gemm multiplies, ct_inv_butterfly sweeps.  The
// z-CT stage forms the Rz/2 + 1 distinct butterflies of a real row
// (chunks 0 and Rz/2 real, 16 k per slice; the others complex, 8 k per
// slice); the conjugate chunks Rz - d read u_d, and their sign sits in
// their block table (negating a bf16 value is exact).
//
//   split_ct     the x / y stage's forward data: u_j of column c of
//                (nouter, R M, ncols) blocks into data slices j M / 8 + s
//                of column tile c / 128 (NP parts);
//   split_zct    the z-CT data of (rows, N2) real rows, u_d into the
//                slices dslice[d] .. of row tile m / 128.
//
// What bounds them: the bytes.  At 512^3 the forward x pass is 34.4 G
// real FMA, 0.07 ms at 989 TFLOP/s, against 0.32 ms of compulsory bytes;
// the split tiles add 4 bytes per complex element written and read once
// more.  The butterfly's coefficient classes (1, -1, 0, a product) are
// compiled in, so a split pass runs near its bytes (on an H100 80GB HBM3
// at 512^3 the z-CT split took 0.26 ms against 0.24 ms of bytes);
// tc_gemm stores each thread's two adjacent outputs at once, and its
// one-part ring is 8 slices deep (PERF.md's findings have the times).

// A butterfly coefficient's class, known at compile time from R and r j:
// the plain butterfly (_cmadd) adds a term a when the coefficient is 1,
// -a when it is -1, nothing when it is 0, else a c (one f32 product).
// W_R^{-rj} (R <= 8) is exactly 1 or -1 in f64, and so in f32, where r j
// mod R is 0 or R / 2 (real part) or R / 4 or 3 R / 4 (imaginary part),
// exactly 0 only at r j = 0 (imaginary part); elsewhere it is a product,
// the tiny ones (cos(pi / 2) in f64: 6.1e-17) included.  bt_check holds
// the host's f32 constants to these classes.
enum BtClass { BT_ZERO, BT_ONE, BT_MINUS, BT_MUL };

__host__ __device__ constexpr BtClass bt_re(int R, int r, int j) {
  return (r * j) % R == 0 ? BT_ONE
                          : (2 * ((r * j) % R) == R ? BT_MINUS : BT_MUL);
}
__host__ __device__ constexpr BtClass bt_im(int R, int r, int j) {
  return r * j == 0 ? BT_ZERO
                    : (4 * ((r * j) % R) == R
                           ? BT_MINUS
                           : (4 * ((r * j) % R) == 3 * R ? BT_ONE : BT_MUL));
}
__host__ __device__ constexpr BtClass bt_neg(BtClass c) {
  return c == BT_ONE ? BT_MINUS : (c == BT_MINUS ? BT_ONE : c);
}

// b + c a for a coefficient of class C (value coef): bterm's arithmetic
template <BtClass C>
__device__ __forceinline__ float bterm_c(float b, float coef, float a) {
  if constexpr (C == BT_ZERO) return b;
  if constexpr (C == BT_ONE) return __fadd_rn(b, a);
  if constexpr (C == BT_MINUS) return __fadd_rn(b, -a);
  return __fadd_rn(b, __fmul_rn(a, coef));
}

// whether the host constants b[r][j] (W_R^{-rj}) have the classes the
// split passes compile in
bool bt_check(const Butter& bt, int R) {
  auto is = [](BtClass c, float v) {
    return c == BT_ZERO ? fabsf(v) < 1e-30f
                        : c == BT_ONE ? v == 1.f
                                      : c == BT_MINUS ? v == -1.f
                                                      : fabsf(v) >= 1e-30f &&
                                                            fabsf(v) != 1.f;
  };
  for (int r = 0; r < R; ++r)
    for (int j = 0; j < R; ++j)
      if (!is(bt_re(R, r, j), bt.r[r][j]) || !is(bt_im(R, r, j), bt.i[r][j]))
        return false;
  return true;
}

struct SplitCt {
  const void *xr, *xi;           // TI
  const float *k2x, *k2y, *k2z;  // the 1/k^2 fold, or null
  bf16_t* dst;                   // (ceil(nall / 128), R nks, NP, 128, 16)
  float* c0;                     // NP = 3: (R, nall, 2), u_j[0] of each
                                 // chunk and column
  long long istride, nall;       // input: outer stride; columns in all
  int M, ncols, ipitch, W, nks;  // rows per chunk; nks = M / 8
  Butter bt;                     // b[r][j] = W_R^{-rj}
};

// the bf16 of v in the low or high half of a word
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// u[j] = (re, im) of sum_r b[r][j] (vr[r] + i vi[r]) for every chunk j,
// each term added as the plain butterfly adds it, in its order: re +=
// cr vr, re += -ci vi, im += ci vr, im += cr vi, r = 0, 1, ...
template <int R, int J, int Rr>
__device__ __forceinline__ void bt_terms(float (&u)[R][2],
                                         const float (&vr)[R],
                                         const float (&vi)[R],
                                         const Butter& bt) {
  if constexpr (Rr < R) {
    const float cr = bt.r[Rr][J], ci = bt.i[Rr][J];
    u[J][0] = bterm_c<bt_neg(bt_im(R, Rr, J))>(
        bterm_c<bt_re(R, Rr, J)>(u[J][0], cr, vr[Rr]), -ci, vi[Rr]);
    u[J][1] = bterm_c<bt_re(R, Rr, J)>(
        bterm_c<bt_im(R, Rr, J)>(u[J][1], ci, vr[Rr]), cr, vi[Rr]);
    bt_terms<R, J, Rr + 1>(u, vr, vi, bt);
  }
}
template <int R, int... J>
__device__ __forceinline__ void bt_chunks(float (&u)[R][2],
                                          const float (&vr)[R],
                                          const float (&vi)[R],
                                          const Butter& bt,
                                          std::integer_sequence<int, J...>) {
  ((u[J][0] = u[J][1] = 0.f, bt_terms<R, J, 0>(u, vr, vi, bt)), ...);
}

// the R chunks' u_j of one data row m (u[j] = (re, im)) of split_ct's
// column, term by term as the plain butterfly adds them
template <class TI, int R>
__device__ __forceinline__ void ct_row(const SplitCt& p, bool in,
                                       long long base, float ky, float kz,
                                       int m, float (&u)[R][2]) {
  const TI* xr = static_cast<const TI*>(p.xr);
  const TI* xi = static_cast<const TI*>(p.xi);
  float vr[R], vi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    vr[r] = vi[r] = 0.f;
    if (in) {
      const long long row = (long long)r * p.M + m;
      const long long a = base + row * p.ipitch;
      vr[r] = ldv(xr, a);
      vi[r] = ldv(xi, a);
      if (p.k2x != nullptr) {
        const float kk = __fadd_rn(__fadd_rn(p.k2x[row], ky), kz);
        const float f = kk > 0.f ? __frcp_rn(kk) : 0.f;
        vr[r] = __fmul_rn(vr[r], f);
        vi[r] = __fmul_rn(vi[r], f);
      }
    }
  }
  bt_chunks<R>(u, vr, vi, p.bt, std::make_integer_sequence<int, R>());
}

// one block of 128 threads per column tile and group of SPLIT_SG slices
// (blockIdx.y), one thread per column c: for each row m = 8 s + mm of
// slice s, the R values fold(x[o, r M + m, n]) read once and every
// chunk's u_j[m] formed from them; chunk j's slice s is data slice j nks
// + s, row c % 128 (re of the 8 rows | im, in the 32-byte swizzle); zero
// past nall.  NP = 1: each u_j rounded once to bf16 (the bf16
// products); NP = 3 (the f32 products): each chunk's u_j[0] taken out
// of its rows (and written to c0 by the blocks of slice 0, for tc_gemm
// to add back through the row sums), the rest split in three parts
template <class TI, int R, int NP>
__global__ void __launch_bounds__(128) split_ct(const SplitCt p) {
  const long long tile = blockIdx.x;
  const int tid = threadIdx.x, s0 = blockIdx.y * SPLIT_SG;
  const long long c = tile * 128 + tid;
  const bool in = c < p.nall;
  long long base = 0;
  float ky = 0.f, kz = 0.f;
  if (in) {
    const long long o = c / p.ncols, n = c % p.ncols;
    base = o * p.istride + n;
    if (p.k2x != nullptr) {
      ky = p.k2y[n / p.W];
      kz = p.k2z[n % p.W];
    }
  }
  bf16_t* dst =
      p.dst + tile * (long long)R * p.nks * (NP * TG_SLICE) + tid * TC_BK;
  if constexpr (NP == 1) {
    const int sw = (tid >> 2) & 1;
    for (int s = s0; s < min(p.nks, s0 + SPLIT_SG); ++s) {
      uint32_t w[R][8];   // chunk j: rows (2 i, 2 i + 1) re in w[j][i], im in 4 + i
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        float u[R][2];
        ct_row<TI, R>(p, in, base, ky, kz, s * 8 + mm, u);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float ur = u[j][0], ui = u[j][1];
          const int sh = (mm & 1) * 16;
          const uint32_t br = bf16_bits(ur) << sh, bi = bf16_bits(ui) << sh;
          w[j][mm / 2] = (mm & 1) ? (w[j][mm / 2] | br) : br;
          w[j][4 + mm / 2] = (mm & 1) ? (w[j][4 + mm / 2] | bi) : bi;
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uint4* d = reinterpret_cast<uint4*>(
            dst + ((long long)j * p.nks + s) * TG_SLICE);
        d[sw] = make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
        d[1 - sw] = make_uint4(w[j][4], w[j][5], w[j][6], w[j][7]);
      }
    }
  } else {
    float c0[R][2];
    ct_row<TI, R>(p, in, base, ky, kz, 0, c0);
    if (s0 == 0 && in)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        p.c0[2 * (j * p.nall + c)] = c0[j][0];
        p.c0[2 * (j * p.nall + c) + 1] = c0[j][1];
      }
    for (int s = s0; s < min(p.nks, s0 + SPLIT_SG); ++s) {
      float v[R][16];   // chunk j: re of the 8 rows, then im
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        float u[R][2];
        ct_row<TI, R>(p, in, base, ky, kz, s * 8 + mm, u);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          v[j][mm] = u[j][0] - c0[j][0];
          v[j][8 + mm] = u[j][1] - c0[j][1];
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j)
        st_parts16<NP>(dst + ((long long)j * p.nks + s) * (NP * TG_SLICE),
                       v[j], tid);
    }
  }
}

struct SplitZct {
  const float* x;            // (rows, N2) real
  bf16_t* dst;               // (ceil(rows / 128), nkd, 1, 128, 16)
  long long rows;
  int N2, K, nkd, aligned;
  int dslice[kMaxR / 2 + 1];  // the first slice of each u_d
  Butter bt;                 // b[r][d] = W_Rz^{-rd}
};

constexpr int SPLIT_ZT = 256;   // threads per split_zct block

// sum_r c[r] v[r][q] over the terms of class C(r) = bt_re or bt_im of
// (RZ, r, D), in r order (the plain z-CT's chain over xs[r])
template <int RZ, int D, bool IM, int R = 0>
__device__ __forceinline__ float zct_sum(float acc, const float (&v)[RZ][8],
                                         int q, const Butter& bt) {
  if constexpr (R == RZ) {
    return acc;
  } else {
    constexpr BtClass C = IM ? bt_im(RZ, R, D) : bt_re(RZ, R, D);
    const float c = IM ? bt.i[R][D] : bt.r[R][D];
    return zct_sum<RZ, D, IM, R + 1>(bterm_c<C>(acc, c, v[R][q]), v, q, bt);
  }
}

// u_D of split_zct's row and 8 k into its slice row (D = 0 and RZ / 2
// real, the others complex)
template <int RZ, int D>
__device__ __forceinline__ void zct_chunk(const SplitZct& p,
                                          const float (&v)[RZ][8],
                                          bf16_t* base, int g, int sw) {
  constexpr bool real = D == 0 || 2 * D == RZ;
  uint32_t wr[4], wi[4];
#pragma unroll
  for (int q = 0; q < 8; q += 2) {
    wr[q / 2] = bf16_bits(zct_sum<RZ, D, false>(0.f, v, q, p.bt)) |
                (bf16_bits(zct_sum<RZ, D, false>(0.f, v, q + 1, p.bt)) << 16);
    if constexpr (!real)
      wi[q / 2] =
          bf16_bits(zct_sum<RZ, D, true>(0.f, v, q, p.bt)) |
          (bf16_bits(zct_sum<RZ, D, true>(0.f, v, q + 1, p.bt)) << 16);
  }
  const uint4 re = make_uint4(wr[0], wr[1], wr[2], wr[3]);
  if constexpr (real) {
    uint4* dd = reinterpret_cast<uint4*>(
        base + (long long)(p.dslice[D] + g / 2) * TG_SLICE);
    dd[(g & 1) ^ sw] = re;
  } else {
    uint4* dd = reinterpret_cast<uint4*>(
        base + (long long)(p.dslice[D] + g) * TG_SLICE);
    dd[sw] = re;
    dd[1 - sw] = make_uint4(wi[0], wi[1], wi[2], wi[3]);
  }
}

template <int RZ, int... D>
__device__ __forceinline__ void zct_chunks(const SplitZct& p,
                                           const float (&v)[RZ][8],
                                           bf16_t* base, int g, int sw,
                                           std::integer_sequence<int, D...>) {
  (zct_chunk<RZ, D>(p, v, base, g, sw), ...);
}

// one thread per row m and 8 k (k = 8 g + q of every raw chunk r): the Rz
// values x[m, r K + k] read once (two float4 per r where aligned), u_d
// for d <= Rz / 2 as _zct_fwd_plain forms it (u_0 and u_{Rz/2} real, their
// coefficients +-1; the others complex, their re and im chains each in r
// order), each rounded once to bf16: a real u_d fills half a row of
// slice dslice[d] + g / 2, a complex one a row (re | im) of slice
// dslice[d] + g
template <int RZ>
__global__ void __launch_bounds__(SPLIT_ZT) split_zct(const SplitZct p) {
  const int G = p.K / 8;
  const long long e = (long long)blockIdx.x * SPLIT_ZT + threadIdx.x;
  const long long m = e / G;
  const int g = (int)(e % G);
  if (m >= p.rows) return;
  float v[RZ][8];
  const float* src = p.x + m * p.N2 + 8 * g;
#pragma unroll
  for (int r = 0; r < RZ; ++r) {
    const float* a = src + (long long)r * p.K;
    if (p.aligned) {
      const float4 lo = *reinterpret_cast<const float4*>(a);
      const float4 hi = *reinterpret_cast<const float4*>(a + 4);
      v[r][0] = lo.x; v[r][1] = lo.y; v[r][2] = lo.z; v[r][3] = lo.w;
      v[r][4] = hi.x; v[r][5] = hi.y; v[r][6] = hi.z; v[r][7] = hi.w;
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[r][q] = a[q];
    }
  }
  const int row = (int)(m % TC_ROWS), sw = (row >> 2) & 1;
  bf16_t* base = p.dst + (m / TC_ROWS) * p.nkd * TG_SLICE + row * TC_BK;
  zct_chunks<RZ>(p, v, base, g, sw,
                 std::make_integer_sequence<int, RZ / 2 + 1>());
}

// --- the zy inverses on tc_gemm ---------------------------------------------
//
// pmesh_zy_inv_ct2 (and its dual) and pmesh_zy_inv_half, both product
// forms.  The y stage is an inverse CT (ct2: split_cols, then tc_gemm over
// the Ry chunks, both table sets of the dual on one split) or a dense
// inverse DFT (dense_tc), into f32 scratch.  The z stage is ONE real
// product per row: out = yr A + yi B is [yr | yi] (rows, 2 Zm) times the
// stacked [A; B] (2 Zm, n2), half the products of a complex one, with
// the contraction in slices of 8 complex k (re | im, as split_cols lays
// out its columns) and 128 real output columns per table tile.  Its data
// tiles are the y output's rows, formed by split_zinv, which also runs
// the y CT's inverse butterfly out_r = sum_j b[r][j] y_j from the R chunk
// rows y_j of each row m (ct_inv_butterfly's fmaf chain), so that the
// y output is read once and never swept; the Nyquist plane (-1)^n is
// added in f32 after the products.  The z-CT inverse (Rz = 8, N2 >= 1024)
// is the same product over Ri chunks, chunk j of Kin complex k into P_j
// (columns [0, Kb)) and Q_j ([Kb, 2 Kb)), which zct_combine then combines.
// The f32 form splits every operand three ways by its own exponent and
// keeps a fresh partial per slice (no first element taken out: an
// inverse's data is no mean's carrier); a bf16-stored spectrum is one
// exact bf16 part against the three-part table.
//
//   split_zinv   the z data: row o N1 + r M + m of the (n0, N1, Zm) y
//                output, k in slices of 8 (re | im), into (ceil(n0 N1 /
//                128), ceil(Zm / 8), NP, 128, 16), zero past Zm.

struct SplitZinv {
  const float *yr, *yi;   // (nouter, R M, Zm): chunk j's y_j at rows j M + m
  bf16_t* dst;            // (ceil(nouter R M / 128), nks, NP, 128, 16)
  int M, Zm, nks, aligned;
  Butter bt;              // b[r][j] = W_R^{+rj}
};

constexpr int ZI_ROWS = 32;          // rows m per split_zinv block
constexpr int ZI_K = 8 * TC_DR;      // k per block: 8 slices
constexpr int ZI_PK = ZI_K + 4;      // staged row pitch (floats)

// dynamic shared bytes of split_zinv: the R chunks' (re, im) rows
__host__ __device__ constexpr int zi_smem(int R) {
  return R * 2 * ZI_ROWS * ZI_PK * 4;
}

// one block of 256 threads per outer block o, 32 rows m of a chunk
// (blockIdx.x = o mb + m / 32, mb blocks of rows per outer block: whole
// 128-row tiles at R = 1, zero rows past M) and 8 slices of k
// (blockIdx.y): the R chunks' (32, 64) pieces of y_j (re, im) staged
// through shared memory in 256-byte row pieces, then thread (slice tid /
// 32, row tid % 32) forms out_r = sum_j b[r][j] y_j of its 8 k (R = 1:
// y_0) in ct_inv_butterfly's fmaf chain and writes row o R M + r M + m
// of the tiles (re of the 8 k | im) for each r; zero past Zm and M
template <int NP, int R>
__global__ void __launch_bounds__(256) split_zinv(const SplitZinv p) {
  extern __shared__ __align__(16) float zs[];   // [j][re, im][row][k]
  const int mb = R == 1 ? (p.M + TC_ROWS - 1) / TC_ROWS * (TC_ROWS / ZI_ROWS)
                        : p.M / ZI_ROWS;
  const long long o = blockIdx.x / mb;
  const int m0 = (int)(blockIdx.x % mb) * ZI_ROWS;
  const int k0 = blockIdx.y * ZI_K, tid = threadIdx.x;
  const long long base = o * R * p.M;
  auto at = [&](int j, int a, int row) {
    return zs + ((j * 2 + a) * ZI_ROWS + row) * ZI_PK;
  };
  if (p.aligned) {
    for (int e = tid; e < R * 2 * ZI_ROWS * (ZI_K / 4); e += 256) {
      const int c4 = e % (ZI_K / 4), row = (e / (ZI_K / 4)) % ZI_ROWS;
      const int a = (e / (ZI_K / 4 * ZI_ROWS)) % 2;
      const int j = e / (ZI_K / 4 * ZI_ROWS * 2);
      const int m = m0 + row, k = k0 + 4 * c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < p.M && k < p.Zm)
        v = *reinterpret_cast<const float4*>(
            (a ? p.yi : p.yr) + (base + (long long)j * p.M + m) * p.Zm + k);
      *reinterpret_cast<float4*>(at(j, a, row) + 4 * c4) = v;
    }
  } else {
    for (int e = tid; e < R * 2 * ZI_ROWS * ZI_K; e += 256) {
      const int kk = e % ZI_K, row = (e / ZI_K) % ZI_ROWS;
      const int a = (e / (ZI_K * ZI_ROWS)) % 2, j = e / (ZI_K * ZI_ROWS * 2);
      const int m = m0 + row, k = k0 + kk;
      at(j, a, row)[kk] =
          m < p.M && k < p.Zm
              ? (a ? p.yi : p.yr)[(base + (long long)j * p.M + m) * p.Zm + k]
              : 0.f;
    }
  }
  __syncthreads();
  const int row = tid % ZI_ROWS, sl = tid / ZI_ROWS;
  const int s = blockIdx.y * (ZI_K / TC_DR) + sl;
  if (s >= p.nks) return;
  // the three-part form one r at a time: unrolled over r it took 130
  // registers at R = 4, one block of 256 threads per SM
  constexpr int UR = NP == 1 ? R : 1;
#pragma unroll UR
  for (int r = 0; r < R; ++r) {
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float yr[8], yi[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(
            at(j, 0, row) + sl * TC_DR + 4 * h);
        const float4 b = *reinterpret_cast<const float4*>(
            at(j, 1, row) + sl * TC_DR + 4 * h);
        yr[4 * h] = a.x; yr[4 * h + 1] = a.y;
        yr[4 * h + 2] = a.z; yr[4 * h + 3] = a.w;
        yi[4 * h] = b.x; yi[4 * h + 1] = b.y;
        yi[4 * h + 2] = b.z; yi[4 * h + 3] = b.w;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if constexpr (R == 1) {
          v[q] = yr[q];
          v[8 + q] = yi[q];
        } else {
          const float cr = p.bt.r[r][j], ci = p.bt.i[r][j];
          v[q] = fmaf(cr, yr[q], fmaf(-ci, yi[q], v[q]));
          v[8 + q] = fmaf(cr, yi[q], fmaf(ci, yr[q], v[8 + q]));
        }
      }
    }
    const long long orow = base + (long long)r * p.M + m0 + row;
    st_parts16<NP>(p.dst + ((orow / TC_ROWS) * p.nks + s) * (NP * TG_SLICE) +
                       (orow % TC_ROWS) * TC_BK,
                   v, (int)(orow % TC_ROWS));
  }
}

// Chunks: a CT stage at R > 1 is R products, one per chunk j, each
// reading its own table tiles and its own slices of the data tiles and
// writing its own output rows (x / y: rows j jstep + q) or columns (z:
// columns j jstep + mode).  A dense pass is one chunk.
struct TcGemm {
  const bf16_t* tab;    // table tile t of chunk j: slices tslice[j] + t nk[j] ..
  const bf16_t* dat;    // (tiles, nkd, NP, 128, 16): the data's tiles;
                        // chunk j's slices dslice[j] .. + nk[j] of each
  const float* sums;    // x / y: (sets, R, M, 2) row sums; z: (Zh, 2) column sums
  const float* c0;      // the taken-out first elements, or null; x / y:
                        // (R, nall, 2), u_j[0] of each chunk and column
  const float* plane;   // z inverse: plane[m] (-1)^n added, or null
  void *o1r, *o1i, *o2r, *o2i;   // TO
  long long ostride;    // x / y: output elements per outer block
  long long nall;       // x / y: data columns in all; z: rows
  int M;                // x / y: modes per chunk (TG_YREAL: output rows);
                        // z: tail0 (modes per chunk); z inverse: columns
                        // per output (o1r, then o1i)
  int ncols;            // x / y: columns per outer block; z: output pitch
  int lo;               // z: modes [0, lo) are chained, not stored here
  int T, T1;            // table tiles per chunk (both sets), of set 1
  int R, nkd, jstep;    // chunks; slices per data tile; output offset per chunk
  int tslice[kMaxR], dslice[kMaxR], nk[kMaxR];
  float scale;
};

// the one-chunk layout of a dense pass: nks slices per tile
void tg_one_chunk(TcGemm& g, int nks) {
  g.R = 1;
  g.nkd = g.nk[0] = nks;
  g.tslice[0] = g.dslice[0] = g.jstep = 0;
}

// NPT, NPD: the parts of the table and data tiles (3 and 3: the six
// products; 3 and 1: a three-part table on exact bf16 data, the three
// products of its parts; 1 and 1: one).  TO: the output storage (f32, or
// bf16 for the bf16s form of the x / y stages).  The ring: tg_depth slots
// of [row op | col op], each filled by two bulk copies of the operands'
// contiguous slice tiles (pre-swizzled in device memory, as gmma_desc
// reads them) issued by thread 0 and completing on the slot's mbarrier; a
// barrier after each slice's products frees its slot.  Block b: table
// tile b % T, chunk (b / T) % R, data tile b / (T R): the blocks that read
// one data tile are adjacent.
template <int NPT, int NPD, int MODE, class TO>
__global__ void __launch_bounds__(TC_NT, 1) tc_gemm(const TcGemm p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr bool DATA_A = MODE == TG_Z || MODE == TG_ZREAL;
  constexpr int D = tg_depth<NPT, NPD>();
  __shared__ __align__(8) uint64_t full[D];
  // bf16 of a slice tile: the table's, the data's, the row and the
  // column operand's
  constexpr int ST = NPT * TG_SLICE, SD = NPD * TG_SLICE;
  constexpr int SA = DATA_A ? SD : ST, SB = DATA_A ? ST : SD;
  constexpr int NPA = DATA_A ? NPD : NPT, NPB = DATA_A ? NPT : NPD;
  static_assert(NPA == NPB || NPA == 1 || NPB == 1, "the products' parts");
  bf16_t* ring = reinterpret_cast<bf16_t*>(
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023));
  const long long b = blockIdx.x;
  const int t = (int)(b % p.T);
  const int jc = (int)((b / p.T) % p.R);
  const long long dt = b / p.T / p.R;
  const int nks = p.nk[jc];
  const bf16_t* tsrc =
      p.tab + ((long long)p.tslice[jc] + (long long)t * nks) * ST;
  const bf16_t* dsrc = p.dat + (dt * p.nkd + p.dslice[jc]) * SD;
  const bf16_t* asrc = DATA_A ? dsrc : tsrc;
  const bf16_t* bsrc = DATA_A ? tsrc : dsrc;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) {
    for (int d = 0; d < D; ++d) mbar_init(&full[d], 1);
    fence_mbar_init();
  }
  __syncthreads();
  // by thread 0: the copies of slice s into slot s % D
  auto issue = [&](int s) {
    const int slot = s % D;
    bf16_t* st = ring + slot * (SA + SB);
    mbar_expect_tx(&full[slot], 2 * (SA + SB));
    tma_load(st, asrc + (long long)s * SA, 2 * SA, &full[slot]);
    tma_load(st + SA, bsrc + (long long)s * SB, 2 * SB, &full[slot]);
  };
  if (tid == 0)
    for (int s = 0; s < D && s < nks; ++s) issue(s);
  // warpgroup wg: rows [64 wg, 64 wg + 64) of the tile, all 128 columns;
  // per slice the products (three-part operands: the six, smallest
  // first, or the three of a three-part operand's parts with a one-part
  // one, into a fresh partial that the CUDA cores add to acc; one-part
  // operands: one, into acc), a wait for them, and a barrier that frees
  // the slice's slot
  constexpr bool ONE = NPA == 1 && NPB == 1;
  const int wg = warp / 4, w4 = warp % 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  constexpr int NPROD = ONE ? 1 : (NPA == NPB ? 6 : 3);
  constexpr int PA_[6] = {1, 2, 0, 1, 0, 0}, PB_[6] = {1, 0, 2, 0, 1, 0};
  for (int s = 0; s < nks; ++s) {
    const int slot = s % D;
    mbar_wait(&full[slot], (s / D) & 1);
    const bf16_t* A = ring + slot * (SA + SB) + wg * 64 * TC_BK;
    const bf16_t* B = ring + slot * (SA + SB) + SA;
    float* d = ONE ? acc : part;
    wg_pin(d);
    wg_fence();
    if constexpr (ONE) {
      wgmma_128(acc, gmma_desc(A), gmma_desc(B), 1);
    } else {
#pragma unroll
      for (int t = 0; t < NPROD; ++t) {
        // the three: part 2 - t of the three-part operand, part 0 of the other
        const int pa = NPROD == 6 ? PA_[t] : (NPA == 3 ? 2 - t : 0);
        const int pb = NPROD == 6 ? PB_[t] : (NPB == 3 ? 2 - t : 0);
        wgmma_128(part, gmma_desc(A + pa * TG_SLICE),
                  gmma_desc(B + pb * TG_SLICE), t > 0);
      }
    }
    wg_commit();
    wg_wait<0>();
    wg_pin(d);
    if constexpr (!ONE) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    __syncthreads();
    if (tid == 0 && s + D < nks) {
      fence_proxy_async();
      issue(s + D);
    }
  }

  // the stores: each thread's two adjacent columns in one 8- (f32) or
  // 4-byte (bf16) store where both are in range and aligned
  const int gid = lane / 4, tig = lane % 4;
  if constexpr (MODE == TG_ZREAL) {
    // z inverse: rows are data rows, columns real outputs; a chunk's
    // columns [0, M) go to o1r and [M, 2 M) to o1i (when set), at column
    // jc jstep + n of the row (pitch ncols), plus plane[m] (-1)^n
    long long m[2];
    float pl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = dt * TC_ROWS + wg * 64 + w4 * 16 + gid + h * 8;
      pl[h] = p.plane != nullptr && m[h] < p.nall ? p.plane[m[h]] : 0.f;
    }
    const int nout = p.o1i != nullptr ? 2 : 1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gc = t * TC_COLS + 8 * j + 2 * tig;
      const int part_ = gc / p.M, n = gc - part_ * p.M;
      if (part_ >= nout) continue;
      // column gc + 1: n + 1 of the same output, or at an odd M column 0
      // of o1i (the full z inverse at N2 = 75), or past the outputs
      const bool same = n + 1 < p.M, in1 = same || part_ + 1 < nout;
      TO* out = static_cast<TO*>(part_ ? p.o1i : p.o1r);
      const long long col = (long long)jc * p.jstep + n;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (m[h] < p.nall) {
          const float sg = (n & 1) ? -pl[h] : pl[h];
          const float v0 = acc[4 * j + 2 * h] + sg;
          if (same || !in1) {
            st_pair(out, m[h] * p.ncols + col, v0,
                    acc[4 * j + 2 * h + 1] - sg, true, same);
          } else {
            stv(out, m[h] * p.ncols + col, v0);
            stv(static_cast<TO*>(p.o1i), m[h] * p.ncols + jc * p.jstep,
                acc[4 * j + 2 * h + 1] + pl[h]);
          }
        }
    }
  } else if constexpr (DATA_A) {
    // z: rows are data rows, columns [0, 64) real parts of the tile's
    // modes, the rest imaginary; each output gets back c0 sum_k E[k, mode]
    long long m[2];
    float c0[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = dt * TC_ROWS + wg * 64 + w4 * 16 + gid + h * 8;
      c0[h] = p.c0 != nullptr && m[h] < p.nall ? p.c0[m[h]] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * tig;
      const bool re = col < TC_MODES;
      const int mode = t * TC_MODES + col % TC_MODES;
      const int oc = jc * p.jstep + mode;
      bool in[2];
      float sm[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        in[e] = mode + e >= p.lo && mode + e < p.M;
        sm[e] = p.c0 != nullptr && in[e] ? p.sums[2 * (oc + e) + (re ? 0 : 1)]
                                         : 0.f;
      }
      TO* out = static_cast<TO*>(re ? p.o1r : p.o1i);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (m[h] < p.nall)
          st_pair(out, m[h] * p.ncols + oc,
                  fmaf(c0[h], sm[0], acc[4 * j + 2 * h]),
                  fmaf(c0[h], sm[1], acc[4 * j + 2 * h + 1]), in[0], in[1]);
    }
  } else {
    // x / y: warpgroup 0 holds the real parts of the tile's modes,
    // warpgroup 1 the imaginary (TG_YREAL: the tile's 128 real output
    // rows, into o1r); each output gets back c0 sum_m W[q, m], c0 the
    // chunk's taken-out u_jc[0] of the column, then the scale
    constexpr bool YREAL = MODE == TG_YREAL;
    const bool set2 = t >= p.T1;
    const int tt = set2 ? t - p.T1 : t;
    TO* out = static_cast<TO*>(YREAL ? p.o1r
                               : wg == 0 ? (set2 ? p.o2r : p.o1r)
                                         : (set2 ? p.o2i : p.o1i));
    const float* rs =
        p.sums + ((set2 ? (long long)p.R : 0LL) + jc) * p.M * 2;
    const float* c0 =
        p.c0 != nullptr ? p.c0 + (long long)jc * p.nall * 2 : nullptr;
    const long long jrows = (long long)jc * p.jstep * p.ncols;
    int q[2];
    float sr[2], si[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q[h] = YREAL ? tt * TC_COLS + wg * 64 + w4 * 16 + gid + h * 8
                   : tt * TC_MODES + w4 * 16 + gid + h * 8;
      const bool sum = !YREAL && p.c0 != nullptr && q[h] < p.M;
      sr[h] = sum ? rs[2 * q[h]] : 0.f;
      si[h] = sum ? rs[2 * q[h] + 1] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long c = dt * TC_COLS + 8 * j + 2 * tig;
      if (c >= p.nall) continue;
      // columns c and c + 1: adjacent in memory unless c + 1 starts the
      // next outer block
      long long at[2];
      float cr[2], ci[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long ce = c + e < p.nall ? c + e : c;
        at[e] = (ce / p.ncols) * p.ostride + ce % p.ncols + jrows;
        cr[e] = p.c0 != nullptr ? c0[2 * ce] : 0.f;
        ci[e] = p.c0 != nullptr ? c0[2 * ce + 1] : 0.f;
      }
      const bool in1 = c + 1 < p.nall;
      const bool pair = in1 && at[1] == at[0] + 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (q[h] >= p.M) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float back = wg == 0 ? fmaf(cr[e], sr[h], -ci[e] * si[h])
                                     : fmaf(cr[e], si[h], ci[e] * sr[h]);
          v[e] = (acc[4 * j + 2 * h + e] + back) * p.scale;
        }
        const long long row = (long long)q[h] * p.ncols;
        if (pair) {
          st_pair(out, at[0] + row, v[0], v[1], true, true);
        } else {
          stv(out, at[0] + row, v[0]);
          if (in1) stv(out, at[1] + row, v[1]);
        }
      }
    }
  }
}

// --- the sweeps -----------------------------------------------------------

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

// launches of the product routines and the dense passes' split and chain
// kernels, counted where each is launched (pmesh_kernel_launches): the
// wrappers' counters say which entry point ran, these which kernels it ran
enum KernelKind { K_TC_CT, K_TC_Z, K_TC_GEMM, K_SPLIT, K_COL0, K_KINDS };
long long g_launches[K_KINDS] = {};

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

// --- the tensor-core passes -----------------------------------------------

bool aligned16(const void* a) { return ((uintptr_t)a & 15) == 0; }

template <class TI, class TO, int RR>
cudaError_t launch_tc_ct_r(const TcCt<TI, TO>& p, long long blocks,
                           cudaStream_t stream) {
  constexpr long long smem = tc_ct_smem<TI>(RR == 0 ? 1 : RR);
  static_assert(smem <= TC_SMEM_MAX, "the ring fits in shared memory");
  PMESH_TRY_E(cudaFuncSetAttribute(tc_ct<TI, TO, RR>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem));
  ++g_launches[K_TC_CT];
  tc_ct<TI, TO, RR><<<(unsigned)blocks, TC_NT, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

// one tc_ct launch (forward, or INV) over nouter blocks of rows
template <bool INV, class TI, class TO>
cudaError_t launch_tc_ct(TcCt<TI, TO> p, long long nouter,
                         cudaStream_t stream) {
  if (p.M % TC_MODES) return cudaErrorInvalidValue;
  p.nks = p.M / TC_DR;
  const int EP = 16 / (int)sizeof(TI);
  p.aligned = p.ncols % EP == 0 && p.ostride % EP == 0 && aligned16(p.xr) &&
              aligned16(p.xi);
  const long long tiles_n = ((long long)p.ncols + TC_COLS - 1) / TC_COLS;
  const long long blocks = (long long)p.T * p.R * tiles_n * nouter;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  if constexpr (INV) {
    return launch_tc_ct_r<TI, TO, 0>(p, blocks, stream);
  } else {
    switch (p.R) {
      case 2:
        return launch_tc_ct_r<TI, TO, 2>(p, blocks, stream);
      case 4:
        return launch_tc_ct_r<TI, TO, 4>(p, blocks, stream);
      case 8:
        return launch_tc_ct_r<TI, TO, 8>(p, blocks, stream);
    }
    return cudaErrorInvalidValue;
  }
}

// the z forward of (rows, N2) real x into the f32 (sr, si) (rows, N2/2):
// zct = 1: the (Rz, Kz, Mq) z-CT chunks with coefficients zcoef; zct = 0:
// the dense (N2, N2/2) half-DFT; tz: the split block table (bf16), (wzr,
// wzi) the f32 tables (for the mean's modes)
cudaError_t z_forward_tc(const void* tz, const float* zsum, const float* wzr,
                         const float* wzi, const float* x, int zct, int Rz,
                         int Kz, int Mq, const float* zcoef, float* sr,
                         float* si, long long rows, int N2,
                         cudaStream_t stream) {
  TcZ p = {};
  p.x = x;
  p.tab = (const bf16_t*)tz;
  p.csum = zsum;
  p.er = wzr;
  p.ei = wzi;
  p.sr = sr;
  p.si = si;
  p.rows = rows;
  p.N2 = N2;
  p.Zm = N2 / 2;
  if (zct) {
    p.Rz = Rz;
    p.K = Kz;
    p.nmodes = Mq;
    p.c = make_butter(zcoef, Rz);
  } else {
    p.Rz = 1;
    p.K = N2;
    p.nmodes = N2 / 2;
    p.c.r[0][0] = 1.f;
  }
  if (p.Rz > kMaxR) return cudaErrorInvalidValue;
  p.T = (p.nmodes + TC_MODES - 1) / TC_MODES;
  p.nks = (p.K + TC_DR - 1) / TC_DR;
  p.aligned = N2 % 4 == 0 && p.K % 4 == 0 && aligned16(x);
  const long long blocks =
      (long long)p.T * p.Rz * ((rows + TC_ROWS - 1) / TC_ROWS);
  const long long smem = tc_z_smem(p.Rz);
  if (blocks > INT32_MAX || smem > TC_SMEM_MAX) return cudaErrorInvalidValue;
  PMESH_TRY_E(cudaFuncSetAttribute(
      tc_z, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  ++g_launches[K_TC_Z];
  tc_z<<<(unsigned)blocks, TC_NT, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

// column 0 of a forward CT stage (see ct_fwd_col0) after its products
// (x read at o istride + row ipitch; ipitch = 0: ncols, the output's)
template <class TI, class TO>
cudaError_t launch_col0(const TI* xr, const TI* xi, const float* wr,
                        const float* wi, TO* outr, TO* outi,
                        const float* k2x, const float* k2y, const float* k2z,
                        long long nouter, long long ostride, int M, int R,
                        int ncols, float scale, const Butter& bt,
                        cudaStream_t stream, long long istride = -1,
                        long long ipitch = 0) {
  const long long blocks = (nouter + C0_G - 1) / C0_G;
  const long long smem = col0_smem(M);
  if (blocks > INT32_MAX || smem > TC_SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    PMESH_TRY_E(cudaFuncSetAttribute(
        ct_fwd_col0<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem));
  ++g_launches[K_COL0];
  ct_fwd_col0<TI, TO><<<dim3((unsigned)blocks, R, (M + C0_Q - 1) / C0_Q),
                        C0_Q, (size_t)smem, stream>>>(xr, xi, wr, wi, outr, outi, k2x, k2y, k2z,
                                  nouter, istride < 0 ? ostride : istride,
                                  ipitch > 0 ? ipitch : ncols, ostride, M, R,
                                  ncols, scale, bt);
  return cudaGetLastError();
}

// the forward y CT of the f32 (n0, N1, ncols) z spectrum (xr, xi) into
// (outr, outi) (storage TO), chunk-permuted along y; ty: the split block
// table (bf16), (wyr, wyi) the f32 tables (for column 0)
template <class TO>
cudaError_t y_forward_tc(const float* xr, const float* xi, const void* ty,
                         const float* ysum, const float* wyr,
                         const float* wyi, const float* ycoef, TO* outr,
                         TO* outi,
                         int n0, int N1, int ncols, int Ry, int My,
                         cudaStream_t stream) {
  TcCt<float, TO> p = {};
  p.xr = xr;
  p.xi = xi;
  p.tab = (const bf16_t*)ty;
  p.rsum = ysum;
  p.o1r = outr;
  p.o1i = outi;
  p.ostride = (long long)N1 * ncols;
  p.M = My;
  p.R = Ry;
  p.ncols = ncols;
  p.W = 1;
  p.T = p.T1 = My / TC_MODES;
  p.scale = 1.f;
  p.bt = make_butter(ycoef, Ry);
  PMESH_TRY_E(launch_tc_ct<false>(p, n0, stream));
  return launch_col0(xr, xi, wyr, wyi, outr, outi, (const float*)nullptr,
                     (const float*)nullptr, (const float*)nullptr, n0,
                     p.ostride, My, Ry, ncols, 1.f, p.bt, stream);
}

// the x CT of pmesh_xct_multi on the tensor cores, spectra stored as TS:
// the inverse writes its products to f32 (the output itself for f32
// storage, the scratch for bf16) and the sweep stores the output
template <class TS>
cudaError_t x_ct_tc(const TS* xr, const TS* xi, const void* tab_,
                    const float* rsum, const float* wr, const float* wi,
                    const float* w2r, const float* w2i, const float* k2x, const float* k2y, const float* k2z,
                    TS* o1r, TS* o1i, TS* o2r, TS* o2i, float* s1r,
                    float* s1i, float* s2r, float* s2i, int n1, int W, int R,
                    int M, bool inverse, float scale, const Butter& bt,
                    cudaStream_t stream) {
  const long long ncols = (long long)n1 * W;
  if (ncols > INT32_MAX) return cudaErrorInvalidValue;
  const bool dual = o2r != nullptr;
  const int T1 = M / TC_MODES;
  const bf16_t* tab = (const bf16_t*)tab_;
  if (!inverse) {
    TcCt<TS, TS> p = {xr, xi, tab, rsum, o1r, o1i, o2r, o2i, k2x, k2y, k2z,
                      0, M, R, (int)ncols, W, dual ? 2 * T1 : T1, T1, 0, 0,
                      scale, bt};
    PMESH_TRY_E(launch_tc_ct<false>(p, 1, stream));
    PMESH_TRY_E(launch_col0(xr, xi, wr, wi, o1r, o1i, k2x, k2y, k2z, 1, 0, M,
                            R, (int)ncols, scale, bt, stream));
    if (!dual) return cudaSuccess;
    return launch_col0(xr, xi, w2r, w2i, o2r, o2i, k2x, k2y, k2z, 1, 0, M, R,
                       (int)ncols, scale, bt, stream);
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
  TcCt<TS, float> p = {xr, xi, tab, rsum, p1r, p1i, p2r, p2i, k2x, k2y, k2z,
                       0, M, R, (int)ncols, W, dual ? 2 * T1 : T1, T1, 0, 0,
                       1.f, bt};
  PMESH_TRY_E(launch_tc_ct<true>(p, 1, stream));
  PMESH_TRY_E(launch_butterfly(p1r, p1i, o1r, o1i, 1, 0, M, R, (int)ncols,
                               scale, bt, stream));
  if (!dual) return cudaSuccess;
  return launch_butterfly(p2r, p2i, o2r, o2i, 1, 0, M, R, (int)ncols, scale,
                          bt, stream);
}

template <int NPT, int NPD, int MODE, class TO = float>
cudaError_t launch_tc_gemm(const TcGemm& p, long long dtiles,
                           cudaStream_t stream) {
  constexpr int smem = tg_smem<NPT, NPD>();
  static_assert(smem <= TC_SMEM_MAX, "the ring fits in shared memory");
  const long long blocks = (long long)p.T * p.R * dtiles;
  if (blocks < 1 || blocks > INT32_MAX || p.R < 1 || p.R > kMaxR)
    return cudaErrorInvalidValue;
  PMESH_TRY_E(cudaFuncSetAttribute(tc_gemm<NPT, NPD, MODE, TO>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem));
  ++g_launches[K_TC_GEMM];
  tc_gemm<NPT, NPD, MODE, TO><<<(unsigned)blocks, TC_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// the dense DFT along the rows of (nouter, M, ncols) complex blocks (x
// read at o istride + row ipitch) into (nouter, M, ncols) outputs by the
// (M, M) table set(s) of the block table tab (one set, or two when o2r
// is set) times scale, with the 1/k^2 fold when k2x is set (W: the z
// width of a column n = y W + z), on the tensor cores: split_cols, then
// tc_gemm, NP parts.  center: the first element of each column is taken
// out and added back through the row sums, and column 0 is formed in
// chains after the products (ct_fwd_col0, by the f32 tables (wr, wi)
// [(w2r, w2i)]).  Scratch: split (the data's tiles), c0 (2 nouter ncols).
template <int NP>
cudaError_t dense_tc(const float* xr, const float* xi, const void* tab,
                     const float* sums, const float* wr, const float* wi,
                     const float* w2r, const float* w2i, const float* k2x,
                     const float* k2y, const float* k2z, float* o1r,
                     float* o1i, float* o2r, float* o2i, bf16_t* split,
                     float* c0, int nouter, int M, int ncols, int ipitch,
                     long long istride, int W, float scale, bool center,
                     cudaStream_t stream) {
  const long long nall = (long long)nouter * ncols;
  const long long tiles = (nall + TC_COLS - 1) / TC_COLS;
  const int nks = (M + TC_DR - 1) / TC_DR;
  const int T1 = (M + TC_MODES - 1) / TC_MODES;
  const bool dual = o2r != nullptr;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  SplitCols sp = {xr,    xi,      k2x,  k2y, k2z, split, center ? c0 : nullptr,
                  istride, nall, M, ncols, ipitch, W, nks};
  ++g_launches[K_SPLIT];
  split_cols<NP, float><<<dim3((unsigned)tiles, (nks + SPLIT_SG - 1) / SPLIT_SG),
                   128, 0, stream>>>(sp);
  PMESH_TRY_E(cudaGetLastError());
  TcGemm g = {};
  g.tab = (const bf16_t*)tab;
  g.dat = split;
  g.sums = sums;
  g.c0 = center ? c0 : nullptr;
  g.o1r = o1r;
  g.o1i = o1i;
  g.o2r = o2r;
  g.o2i = o2i;
  g.ostride = (long long)M * ncols;
  g.nall = nall;
  g.M = M;
  g.ncols = ncols;
  g.T = dual ? 2 * T1 : T1;
  g.T1 = T1;
  tg_one_chunk(g, nks);
  g.scale = scale;
  PMESH_TRY_E((launch_tc_gemm<NP, NP, TG_XY>(g, tiles, stream)));
  if (!center) return cudaSuccess;
  Butter one = {};
  one.r[0][0] = 1.f;
  PMESH_TRY_E(launch_col0(xr, xi, wr, wi, o1r, o1i, k2x, k2y, k2z, nouter,
                          g.ostride, M, 1, ncols, scale, one, stream,
                          istride, ipitch));
  if (!dual) return cudaSuccess;
  return launch_col0(xr, xi, w2r, w2i, o2r, o2i, k2x, k2y, k2z, nouter,
                     g.ostride, M, 1, ncols, scale, one, stream, istride,
                     ipitch);
}

// the dense z half-DFT of (rows, N2) real x into (sr, si) (rows, pitch)
// on the tensor cores: split_rows, then tc_gemm over the zm modes of the
// block table tz (NP parts; zsum its (Zh, 2) column sums); modes [0, QZ)
// (f32 form) and [zm, Zh) are chained by split_rows from (wzr, wzi).
// Scratch: split (the rows' tiles), c0 (rows).
template <int NP>
cudaError_t z_dense_tc(const float* x, const void* tz, const float* zsum,
                       const float* wzr, const float* wzi, float* sr,
                       float* si, bf16_t* split, float* c0, long long rows,
                       int N2, int Zh, int pitch, int zm,
                       cudaStream_t stream) {
  const long long tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  const int nks = (N2 + TC_BK - 1) / TC_BK;
  const int nlo = NP == 3 ? min(QZ, zm) : 0;
  if (tiles > INT32_MAX || zm < 1 || zm > Zh || nlo + Zh - zm > ZCH)
    return cudaErrorInvalidValue;
  float* cz = NP == 3 ? c0 : nullptr;
  SplitRows sp = {x,    wzr, wzi, split, cz,   sr,  si,
                  rows, N2,  Zh,  pitch, nlo, zm, nks,
                  N2 % 4 == 0 && aligned16(x)};
  ++g_launches[K_SPLIT];
  split_rows<NP><<<(unsigned)tiles, 128, 0, stream>>>(sp);
  PMESH_TRY_E(cudaGetLastError());
  TcGemm g = {};
  g.tab = (const bf16_t*)tz;
  g.dat = split;
  g.sums = zsum;
  g.c0 = cz;
  g.o1r = sr;
  g.o1i = si;
  g.nall = rows;
  g.M = zm;
  g.ncols = pitch;
  g.lo = nlo;
  g.T = g.T1 = (zm + TC_MODES - 1) / TC_MODES;
  tg_one_chunk(g, nks);
  g.scale = 1.f;
  return launch_tc_gemm<NP, NP, TG_Z>(g, tiles, stream);
}

// the R chunks' products of a CT stage on tc_gemm: NPT-part block table
// tab of one set, or two when o2r is set (T1 = M / 64 tiles each), over
// the NPD-part data tiles split (R M / 8 slices per column tile: chunk
// j's at j M / 8), output rows j M + q of (nall / ncols, R M, ncols)
// blocks; c0 (R, nall, 2) the chunks' taken-out first elements, added
// back through the row sums (sets, R, M, 2), or null
template <int NPT, int NPD, class TO>
cudaError_t ct_chunks_tc(const void* tab, const bf16_t* split, TO* o1r,
                         TO* o1i, TO* o2r, TO* o2i, long long nall, int R,
                         int M, int ncols, float scale,
                         cudaStream_t stream, const float* sums = nullptr,
                         const float* c0 = nullptr) {
  const int nks = M / TC_DR, T1 = M / TC_MODES;
  TcGemm g = {};
  g.tab = (const bf16_t*)tab;
  g.dat = split;
  g.sums = sums;
  g.c0 = c0;
  g.o1r = o1r;
  g.o1i = o1i;
  g.o2r = o2r;
  g.o2i = o2i;
  g.ostride = (long long)R * M * ncols;
  g.nall = nall;
  g.M = M;
  g.ncols = ncols;
  g.T1 = T1;
  g.T = o2r != nullptr ? 2 * T1 : T1;
  g.R = R;
  g.nkd = R * nks;
  g.jstep = M;
  for (int j = 0; j < R && j < kMaxR; ++j) {
    g.tslice[j] = j * g.T * nks;
    g.dslice[j] = j * nks;
    g.nk[j] = nks;
  }
  g.scale = scale;
  return launch_tc_gemm<NPT, NPD, TG_XY, TO>(
      g, (nall + TC_COLS - 1) / TC_COLS, stream);
}

// the forward CT stage on tc_gemm along the rows of (nouter, R M, ncols)
// blocks (x read at o istride + row ipitch, stored as TI) into (nouter,
// R M, ncols) outputs (TO, chunk-permuted) by the NP-part block table tab
// [two sets when o2r is set] times scale, with the 1/k^2 fold when k2x
// is set (W: the z width of a column n = y W + z): split_ct, then
// tc_gemm over the chunks.  NP = 1: the bf16 products; NP = 3: the f32
// products, each chunk's u_j[0] taken out into c0 (R nouter ncols 2 f32)
// and added back through the row sums (sets, R, M, 2); column 0 is then
// the caller's (launch_col0).  Scratch: split (R M / 8 slices of NP
// parts per 128-column tile).
template <int NP, class TI, class TO>
cudaError_t ct_fwd_tc(const TI* xr, const TI* xi, const void* tab,
                      const float* k2x, const float* k2y, const float* k2z,
                      TO* o1r, TO* o1i, TO* o2r, TO* o2i, bf16_t* split,
                      const float* sums, float* c0, int nouter, int R, int M,
                      int ncols, int ipitch, long long istride, int W,
                      float scale, const Butter& bt, cudaStream_t stream) {
  const long long nall = (long long)nouter * ncols;
  const long long tiles = (nall + TC_COLS - 1) / TC_COLS;
  const int nks = M / TC_DR;
  if (M % TC_MODES || tiles > INT32_MAX || !bt_check(bt, R) ||
      (NP == 3 && (sums == nullptr || c0 == nullptr)))
    return cudaErrorInvalidValue;
  const SplitCt sp = {xr,      xi,   k2x, k2y,   k2z,    split, c0,
                      istride, nall, M,   ncols, ipitch, W,     nks, bt};
  const dim3 grid((unsigned)tiles, (nks + SPLIT_SG - 1) / SPLIT_SG);
  switch (R) {
    case 2:
      split_ct<TI, 2, NP><<<grid, 128, 0, stream>>>(sp);
      break;
    case 4:
      split_ct<TI, 4, NP><<<grid, 128, 0, stream>>>(sp);
      break;
    case 8:
      split_ct<TI, 8, NP><<<grid, 128, 0, stream>>>(sp);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  ++g_launches[K_SPLIT];
  PMESH_TRY_E(cudaGetLastError());
  return ct_chunks_tc<NP, NP>(tab, split, o1r, o1i, o2r, o2i, nall, R, M,
                              ncols, scale, stream, NP == 3 ? sums : nullptr,
                              NP == 3 ? c0 : nullptr);
}

// the inverse CT stage's products on tc_gemm along the rows of (nouter,
// R M, ncols) blocks of the chunk-permuted spectrum (TI), folded by 1/k^2
// when k2x is set (W: the z width of a column n = y W + z): split_cols
// (NPD parts: three for f32 data, one for the bf16 products or for
// bf16-stored data, whose bf16 value is exact), then y_j at rows j M + m
// of the f32 (p1r, p1i) [and (p2r, p2i) by the second set when p2r is
// set] by the NPT-part block table tab (tc_gemm over the chunks).  The
// butterfly follows: a sweep (the x pass), or the z inverse's split pass.
// Scratch: split, ceil(nouter ncols / 128) R M / 8 slices of NPD parts.
template <int NPT, int NPD, class TI>
cudaError_t ct_inv_tc(const TI* xr, const TI* xi, const void* tab,
                      const float* k2x, const float* k2y, const float* k2z,
                      float* p1r, float* p1i, float* p2r, float* p2i,
                      bf16_t* split, int nouter, int R, int M, int ncols,
                      int W, cudaStream_t stream) {
  const long long nall = (long long)nouter * ncols;
  const long long tiles = (nall + TC_COLS - 1) / TC_COLS;
  const int nkt = R * (M / TC_DR);
  if (M % TC_MODES || tiles > INT32_MAX) return cudaErrorInvalidValue;
  const SplitCols sp = {xr,   xi,    k2x,   k2y,   k2z, split,
                        nullptr, (long long)R * M * ncols,
                        nall, R * M, ncols, ncols, W,   nkt};
  ++g_launches[K_SPLIT];
  split_cols<NPD, TI><<<dim3((unsigned)tiles,
                             (nkt + SPLIT_SG - 1) / SPLIT_SG),
                        128, 0, stream>>>(sp);
  PMESH_TRY_E(cudaGetLastError());
  return ct_chunks_tc<NPT, NPD, float>(tab, split, p1r, p1i, p2r, p2i, nall,
                                       R, M, ncols, 1.f, stream);
}

// the z-CT forward in the bf16 products form: (rows, N2) real x into the
// f32 (sr, si) (rows, N2 / 2), stored chunk p at columns [p Mq, (p + 1)
// Mq): split_zct (coefficients bt[r][d] = W_Rz^{-rd}), then tc_gemm over
// the Rz stored chunks, chunk p = order[p] (the _zct_order: {d, d + Rz/2}
// pairs) on its tiles of the block table tz (zct_block_table: the chunks
// in stored order, T = Mq / 64 tiles of K / 16 slices for a real u, K / 8
// for a complex one).  Scratch: split (N2 / 16 slices per 128-row tile).
cudaError_t zct_fwd_tc1(const float* x, const void* tz, float* sr, float* si,
                        bf16_t* split, long long rows, int N2, int Rz, int K,
                        int Mq, const Butter& bt, cudaStream_t stream) {
  const long long tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  const int H = Rz / 2, T = Mq / TC_MODES;
  if (Rz < 2 || Rz > kMaxR || Rz % 2 || K % 128 || Mq % TC_MODES ||
      tiles > INT32_MAX || !bt_check(bt, Rz))
    return cudaErrorInvalidValue;
  SplitZct sp = {};
  sp.x = x;
  sp.dst = split;
  sp.rows = rows;
  sp.N2 = N2;
  sp.K = K;
  sp.aligned = aligned16(x);
  sp.bt = bt;
  TcGemm g = {};
  int nkd = 0;
  for (int d = 0; d <= H; ++d) {
    sp.dslice[d] = nkd;
    nkd += (d == 0 || d == H) ? K / TC_BK : K / TC_DR;
  }
  sp.nkd = nkd;
  int ts = 0;
  for (int pc = 0; pc < Rz; ++pc) {
    const int j = pc % 2 ? pc / 2 + H : pc / 2;   // _zct_order
    const int d = j <= H ? j : Rz - j;
    g.tslice[pc] = ts;
    g.dslice[pc] = sp.dslice[d];
    g.nk[pc] = (d == 0 || d == H) ? K / TC_BK : K / TC_DR;
    ts += T * g.nk[pc];
  }
  const long long threads = rows * (K / 8);
  const long long blocks = (threads + SPLIT_ZT - 1) / SPLIT_ZT;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  switch (Rz) {
    case 2:
      split_zct<2><<<(unsigned)blocks, SPLIT_ZT, 0, stream>>>(sp);
      break;
    case 4:
      split_zct<4><<<(unsigned)blocks, SPLIT_ZT, 0, stream>>>(sp);
      break;
    case 8:
      split_zct<8><<<(unsigned)blocks, SPLIT_ZT, 0, stream>>>(sp);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  ++g_launches[K_SPLIT];
  PMESH_TRY_E(cudaGetLastError());
  g.tab = (const bf16_t*)tz;
  g.dat = split;
  g.o1r = sr;
  g.o1i = si;
  g.nall = rows;
  g.M = Mq;
  g.ncols = N2 / 2;
  g.T = g.T1 = T;
  g.R = Rz;
  g.nkd = nkd;
  g.jstep = Mq;
  g.scale = 1.f;
  return launch_tc_gemm<1, 1, TG_Z>(g, tiles, stream);
}

// the x CT of pmesh_xct_multi in the bf16 products form, the spectra
// stored as TS (the f32 products run on x_ct_tc): tab the one-part block
// table (both sets); the inverse writes its products to f32 (p1, p2: the
// output itself for f32 storage, the scratch (s1, s2) for bf16) and the
// sweep stores the output
template <class TS>
cudaError_t x_ct(const TS* xr, const TS* xi, const void* tab,
                 const float* k2x, const float* k2y, const float* k2z,
                 TS* o1r, TS* o1i, TS* o2r, TS* o2i, float* s1r, float* s1i,
                 float* s2r, float* s2i, bf16_t* split, int n1, int W, int R,
                 int M, bool inverse, float scale, const Butter& bt,
                 cudaStream_t stream) {
  const long long ncols = (long long)n1 * W;
  if (ncols > INT32_MAX) return cudaErrorInvalidValue;
  if (!inverse)
    return ct_fwd_tc<1, TS, TS>(xr, xi, tab, k2x, k2y, k2z, o1r, o1i, o2r,
                                o2i, split, nullptr, nullptr, 1, R, M,
                                (int)ncols, (int)ncols, 0, W, scale, bt,
                                stream);
  float *p1r, *p1i, *p2r, *p2i;
  if constexpr (std::is_same<TS, float>::value) {
    p1r = o1r;
    p1i = o1i;
    p2r = o2r;
    p2i = o2i;
  } else {
    p1r = s1r;
    p1i = s1i;
    p2r = o2r != nullptr ? s2r : nullptr;
    p2i = s2i;
  }
  PMESH_TRY_E((ct_inv_tc<1, 1, TS>(xr, xi, tab, k2x, k2y, k2z, p1r, p1i, p2r,
                                   p2i, split, 1, R, M, (int)ncols, W,
                                   stream)));
  PMESH_TRY_E(launch_butterfly(p1r, p1i, o1r, o1i, 1, 0, M, R, (int)ncols,
                               scale, bt, stream));
  if (o2r == nullptr) return cudaSuccess;
  return launch_butterfly(p2r, p2i, o2r, o2i, 1, 0, M, R, (int)ncols, scale,
                          bt, stream);
}

template <int NP, int R>
cudaError_t launch_split_zinv(const SplitZinv& sp, dim3 grid,
                              cudaStream_t stream) {
  constexpr int smem = zi_smem(R);
  static_assert(smem <= TC_SMEM_MAX, "the staged rows fit");
  if (smem > 48 * 1024)
    PMESH_TRY_E(cudaFuncSetAttribute(split_zinv<NP, R>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem));
  ++g_launches[K_SPLIT];
  split_zinv<NP, R><<<grid, 256, smem, stream>>>(sp);
  return cudaGetLastError();
}

// the z inverse on tc_gemm of the f32 y output (yr, yi) (nouter, R M,
// Zm), chunk j of an R-way y CT at rows j M + m (split_zinv forms the
// inverse butterfly, coefficients bt; R = 1: natural rows, nouter = 1,
// M = the rows), into real (nouter R M, n2): the dense (Zm, n2) pair
// (zct = 0), plus plane[m] (-1)^n when plane is set, or the Ri z-CT
// chunks (Kin, Kb) into (out, zq) and zct_combine (coefficients zcoef,
// the plane there).  tz: z_inv_block_table's NP-part tiles.  Scratch:
// split, ceil(rows / 128) ceil(Zm / 8) slices of NP parts.
// split_zinv's NP-part tiles of the f32 y output (yr, yi) (nouter, R M,
// Zm) into split (see z_inv_tc)
template <int NP>
cudaError_t split_zinv_tc(const float* yr, const float* yi, bf16_t* split,
                          long long nouter, int R, int M, int Zm,
                          const Butter& bt, cudaStream_t stream) {
  const long long rows = nouter * R * M;
  const long long tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  const long long blocks =
      nouter * (R == 1 ? (M + TC_ROWS - 1) / TC_ROWS * (TC_ROWS / ZI_ROWS)
                       : M / ZI_ROWS);
  if (tiles > INT32_MAX || blocks > INT32_MAX || (R > 1 && M % TC_ROWS))
    return cudaErrorInvalidValue;
  SplitZinv sp = {yr, yi, split, M, Zm, (Zm + TC_DR - 1) / TC_DR,
                  Zm % 4 == 0 && aligned16(yr) && aligned16(yi), bt};
  const dim3 grid((unsigned)blocks, (Zm + ZI_K - 1) / ZI_K);
  switch (R) {
    case 1:
      return launch_split_zinv<NP, 1>(sp, grid, stream);
    case 2:
      return launch_split_zinv<NP, 2>(sp, grid, stream);
    case 4:
      return launch_split_zinv<NP, 4>(sp, grid, stream);
    case 8:
      return launch_split_zinv<NP, 8>(sp, grid, stream);
  }
  return cudaErrorInvalidValue;
}

template <int NP>
cudaError_t z_inv_tc(const float* yr, const float* yi, const void* tz,
                     const float* plane, float* out, float* zq,
                     bf16_t* split, long long nouter, int R, int M, int Zm,
                     int n2, const Butter& bt, int zct, int Ri, int Kin,
                     int Kb, const float* zcoef, cudaStream_t stream) {
  const long long rows = nouter * R * M;
  const long long tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  const int nks = (Zm + TC_DR - 1) / TC_DR;
  if (zct && (Ri < 1 || Ri > kMaxR || Ri * Kin != Zm || Kin % TC_DR ||
              Kb % 2 || Ri * Kb != n2))
    return cudaErrorInvalidValue;
  PMESH_TRY_E(split_zinv_tc<NP>(yr, yi, split, nouter, R, M, Zm, bt, stream));
  TcGemm g = {};
  g.tab = (const bf16_t*)tz;
  g.dat = split;
  g.o1r = out;
  g.nall = rows;
  g.ncols = n2;
  g.scale = 1.f;
  if (!zct) {
    g.plane = plane;
    g.M = n2;
    g.T = g.T1 = (n2 + TC_COLS - 1) / TC_COLS;
    tg_one_chunk(g, nks);
    return launch_tc_gemm<NP, NP, TG_ZREAL>(g, tiles, stream);
  }
  g.o1i = zq;
  g.M = Kb;
  g.T = g.T1 = (2 * Kb + TC_COLS - 1) / TC_COLS;
  g.R = Ri;
  g.nkd = nks;
  g.jstep = Kb;
  for (int j = 0; j < Ri; ++j) {
    g.nk[j] = Kin / TC_DR;
    g.tslice[j] = j * g.T * g.nk[j];
    g.dslice[j] = j * g.nk[j];
  }
  PMESH_TRY_E((launch_tc_gemm<NP, NP, TG_ZREAL>(g, tiles, stream)));
  const long long n = rows * Kb;
  if ((n + 255) / 256 > INT32_MAX) return cudaErrorInvalidValue;
  zct_combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      out, zq, plane, rows, n2, Ri, Kb, make_butter(zcoef, Ri));
  return cudaGetLastError();
}

// the zy inverse of pmesh_zy_inv_ct2 for one table set, or two when outB
// is set (both y stages on one split of the spectrum), NPT-part tables
// on NPD-part data (see ct_inv_tc)
template <int NPT, int NPD, class TI>
cudaError_t zy_inv_ct(const TI* xr, const TI* xi, const void* ty,
                      const void* tzA, const void* tzB, int zct, int Ri,
                      int Kin, int Kb, const float* planeA, float* outA,
                      float* outB, float* sAr, float* sAi, float* sBr,
                      float* sBi, float* zq, bf16_t* split, int n0, int N1,
                      int Zm, int n2, int Ry, int My, const float* ycoef,
                      const float* zcoef, cudaStream_t stream) {
  const bool dual = outB != nullptr;
  if (Ry * My != N1) return cudaErrorInvalidValue;
  PMESH_TRY_E((ct_inv_tc<NPT, NPD, TI>(
      xr, xi, ty, nullptr, nullptr, nullptr, sAr, sAi, dual ? sBr : nullptr,
      sBi, split, n0, Ry, My, Zm, 1, stream)));
  const Butter bt = make_butter(ycoef, Ry);
  PMESH_TRY_E(z_inv_tc<NPT>(sAr, sAi, tzA, planeA, outA, zq, split, n0, Ry,
                            My, Zm, n2, bt, zct, Ri, Kin, Kb, zcoef,
                            stream));
  if (!dual) return cudaSuccess;
  return z_inv_tc<NPT>(sBr, sBi, tzB, nullptr, outB, zq, split, n0, Ry, My,
                       Zm, n2, bt, zct, Ri, Kin, Kb, zcoef, stream);
}

// the complex inverse z DFT of full rows on the tensor cores: (xr, xi)
// (rows, N2) times Wz into (zr, zi) (rows, N2), split_zinv (R = 1) then
// ONE real-output tc_gemm of [xr | xi] and the stacked table tz
// [[A, -B]; [B, A]] (A = Re Wz, B = -Im Wz; 2 N2 output columns, zr the
// first N2, zi the rest), NP parts.  Scratch: split, ceil(rows / 128)
// ceil(N2 / 8) slices of NP parts.
template <int NP>
cudaError_t z_full_tc(const float* xr, const float* xi, const void* tz,
                      float* zr, float* zi, bf16_t* split, long long rows,
                      int N2, cudaStream_t stream) {
  if (rows > INT32_MAX) return cudaErrorInvalidValue;
  Butter one = {};
  one.r[0][0] = 1.f;
  PMESH_TRY_E(split_zinv_tc<NP>(xr, xi, split, 1, 1, (int)rows, N2, one,
                                stream));
  TcGemm g = {};
  g.tab = (const bf16_t*)tz;
  g.dat = split;
  g.o1r = zr;
  g.o1i = zi;
  g.nall = rows;
  g.M = N2;
  g.ncols = N2;
  g.T = g.T1 = (2 * N2 + TC_COLS - 1) / TC_COLS;
  tg_one_chunk(g, (N2 + TC_DR - 1) / TC_DR);
  g.scale = 1.f;
  return launch_tc_gemm<NP, NP, TG_ZREAL>(g, (rows + TC_ROWS - 1) / TC_ROWS,
                                          stream);
}

// the real part of the dense complex DFT along the rows of (nouter, M,
// ncols) blocks (xr, xi) into out (nouter, M, ncols), on the tensor
// cores: split_cols, then one real-output tc_gemm (TG_YREAL) by tab, the
// rows [Wr | -Wi] of the (M, M) pair, 128 outputs per tile, NP parts.
// Scratch: split, ceil(nouter ncols / 128) ceil(M / 8) slices of NP parts.
template <int NP>
cudaError_t dense_real_tc(const float* xr, const float* xi, const void* tab,
                          float* out, bf16_t* split, int nouter, int M,
                          int ncols, cudaStream_t stream) {
  const long long nall = (long long)nouter * ncols;
  const long long tiles = (nall + TC_COLS - 1) / TC_COLS;
  const int nks = (M + TC_DR - 1) / TC_DR;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const long long ostride = (long long)M * ncols;
  const SplitCols sp = {xr,      xi,   nullptr, nullptr, nullptr, split,
                        nullptr, ostride, nall, M,       ncols,   ncols,
                        1,       nks};
  ++g_launches[K_SPLIT];
  split_cols<NP, float><<<dim3((unsigned)tiles,
                               (nks + SPLIT_SG - 1) / SPLIT_SG),
                          128, 0, stream>>>(sp);
  PMESH_TRY_E(cudaGetLastError());
  TcGemm g = {};
  g.tab = (const bf16_t*)tab;
  g.dat = split;
  g.o1r = out;
  g.ostride = ostride;
  g.nall = nall;
  g.M = M;
  g.ncols = ncols;
  g.T = g.T1 = (M + TC_COLS - 1) / TC_COLS;
  tg_one_chunk(g, nks);
  g.scale = 1.f;
  return launch_tc_gemm<NP, NP, TG_YREAL>(g, tiles, stream);
}

// the full-spectrum zy inverse of pmesh_zy_inv_full in NP parts: the
// complex z stage into (sr, si), then the real part of the y stage
template <int NP>
cudaError_t zy_inv_full_tc(const float* xr, const float* xi, const void* ty,
                           const void* tz, float* out, float* sr, float* si,
                           bf16_t* split, int n0, int N1, int N2,
                           cudaStream_t stream) {
  PMESH_TRY_E(z_full_tc<NP>(xr, xi, tz, sr, si, split, (long long)n0 * N1,
                            N2, stream));
  return dense_real_tc<NP>(sr, si, ty, out, split, n0, N1, N2, stream);
}

// the half-CT pass 1 of pmesh_zy_fwd_half_ct in NP parts: the dense z
// half-DFT into (sr, si) at pitch Zp (z_dense_tc), then the y CT from
// pitch Zp into (outr, outi) (n0, N1, Zh); the f32 products (NP = 3)
// chain column 0 after the products
template <int NP>
cudaError_t zy_fwd_half_ct_tc(const float* x, const float* wzr,
                              const float* wzi, const float* wyr,
                              const float* wyi, const void* tz,
                              const float* zsum, const void* ty,
                              const float* ysum, const Butter& bt,
                              float* outr, float* outi, float* sr, float* si,
                              bf16_t* split, float* c0, int n0, int N1,
                              int N2, int Zh, int Zp, int zm, int Ry, int My,
                              cudaStream_t stream) {
  const long long rows = (long long)n0 * N1;
  if (Ry * My != N1) return cudaErrorInvalidValue;
  PMESH_TRY_E(z_dense_tc<NP>(x, tz, zsum, wzr, wzi, sr, si, split, c0, rows,
                             N2, Zh, Zp, zm, stream));
  const long long istride = (long long)N1 * Zp;
  PMESH_TRY_E((ct_fwd_tc<NP, float, float>(
      sr, si, ty, nullptr, nullptr, nullptr, outr, outi, nullptr, nullptr,
      split, ysum, c0, n0, Ry, My, Zh, Zp, istride, 1, 1.f, bt, stream)));
  if (NP == 1) return cudaSuccess;
  return launch_col0(sr, si, wyr, wyi, outr, outi, (const float*)nullptr,
                     (const float*)nullptr, (const float*)nullptr, n0,
                     (long long)N1 * Zh, My, Ry, Zh, 1.f, bt, stream,
                     istride, Zp);
}

// the three forms: bf16 products (one-part tables and data), f32 products
// on a bf16-stored spectrum (three-part tables, the data one exact part),
// f32 products
int zy_inv_forms(const void* xr, const void* xi, const void* ty,
                 const void* tzA, const void* tzB, int zct, int Ri, int Kin,
                 int Kb, const float* planeA, float* outA, float* outB,
                 float* sAr, float* sAi, float* sBr, float* sBi, float* zq,
                 void* split, int n0, int N1, int Zm, int n2, int Ry, int My,
                 const float* ycoef, const float* zcoef, int bf16, int bf16s,
                 cudaStream_t stream) {
  bf16_t* sp = (bf16_t*)split;
  const bf16_t *br = (const bf16_t*)xr, *bi = (const bf16_t*)xi;
  const float *fr = (const float*)xr, *fi = (const float*)xi;
  if (bf16 && bf16s)
    return (int)zy_inv_ct<1, 1, bf16_t>(br, bi, ty, tzA, tzB, zct, Ri, Kin,
                                        Kb, planeA, outA, outB, sAr, sAi, sBr,
                                        sBi, zq, sp, n0, N1, Zm, n2, Ry, My,
                                        ycoef, zcoef, stream);
  if (bf16)
    return (int)zy_inv_ct<1, 1, float>(fr, fi, ty, tzA, tzB, zct, Ri, Kin,
                                       Kb, planeA, outA, outB, sAr, sAi, sBr,
                                       sBi, zq, sp, n0, N1, Zm, n2, Ry, My,
                                       ycoef, zcoef, stream);
  if (bf16s)
    return (int)zy_inv_ct<3, 1, bf16_t>(br, bi, ty, tzA, tzB, zct, Ri, Kin,
                                        Kb, planeA, outA, outB, sAr, sAi, sBr,
                                        sBi, zq, sp, n0, N1, Zm, n2, Ry, My,
                                        ycoef, zcoef, stream);
  return (int)zy_inv_ct<3, 3, float>(fr, fi, ty, tzA, tzB, zct, Ri, Kin, Kb,
                                     planeA, outA, outB, sAr, sAi, sBr, sBi,
                                     zq, sp, n0, N1, Zm, n2, Ry, My, ycoef,
                                     zcoef, stream);
}

}  // namespace

extern "C" {

const char* pmesh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the launch counts of the kernel kinds (tc_ct, tc_z, tc_gemm, split
// passes, ct_fwd_col0) into out[0 .. n), then zero them when reset is
// set; returns the number of kinds
int pmesh_kernel_launches(long long* out, int n, int reset) {
  for (int k = 0; k < K_KINDS && k < n; ++k) out[k] = g_launches[k];
  if (reset)
    for (int k = 0; k < K_KINDS; ++k) g_launches[k] = 0;
  return K_KINDS;
}

// Every entry point takes bf16 (1: the bf16 products, tc_gemm's one-part
// form); the ct2 entry points
// also bf16s (1: the spectra they read or write are stored in bf16, as
// the void pointers say).

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zm), nq (n0, N1).
// zct = 0: the dense (N2, Zm) half-DFT; zct = 1: the (Rz, Kz, Mq) z-CT;
// the y CT by (Ry, My, My) tables, ycoef (Ry, Ry, 2) = b[r][j]: the
// complex pairs (wzr, wzi) and (wyr, wyi), by which the f32 products sum
// the mean's outputs.  f32 products (bf16 = 0): tz and ty are the split
// block tables (bf16) of tc_z and tc_ct, zsum (Rz, Mq, 2) [(1, Zm, 2)] and
// ysum (1, Ry, My, 2) the f32 column and row sums of the z and y tables,
// zcoef the (Rz, Rz, 2) chunk coefficients c[r][p].  bf16 products: tz
// and ty are tc_gemm's one-part block tables (zct_block_table, or
// z_real_block_table over the first zm modes; ct_block_table), zcoef
// b[r][d] = W_Rz^{-rd}, split the data tiles' scratch.  (sr, si): (n0,
// N1, Zm) f32 scratch for the z stage.  bf16s: (outr, outi) are bf16.
int pmesh_zy_fwd_ct2(const float* x, const float* wzr, const float* wzi,
                     const void* tz, const float* zsum, int zct, int Rz,
                     int Kz, int Mq, const float* zcoef, const float* wyr,
                     const float* wyi, const void* ty, const float* ysum,
                     const float* ycoef,
                     void* outr, void* outi, float* nq, float* sr,
                     float* si, void* split, int n0, int N1, int N2, int Ry,
                     int My, int zm, int bf16, int bf16s, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long rows = (long long)n0 * N1;
  const int Zm = N2 / 2;
  {
    const long long blocks = (rows * 32 + 255) / 256;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    nyquist_rowsum<<<(unsigned)blocks, 256, 0, stream>>>(x, nq, rows, N2);
    PMESH_TRY(cudaGetLastError());
  }
  if (!bf16) {
    PMESH_TRY(z_forward_tc(tz, zsum, wzr, wzi, x, zct, Rz, Kz, Mq, zcoef,
                           sr, si, rows, N2, stream));
    if (bf16s)
      return (int)y_forward_tc(sr, si, ty, ysum, wyr, wyi, ycoef,
                               (bf16_t*)outr, (bf16_t*)outi, n0, N1, Zm, Ry,
                               My, stream);
    return (int)y_forward_tc(sr, si, ty, ysum, wyr, wyi, ycoef,
                             (float*)outr, (float*)outi, n0, N1, Zm, Ry, My,
                             stream);
  }
  bf16_t* sp = (bf16_t*)split;
  if (zct)
    PMESH_TRY(zct_fwd_tc1(x, tz, sr, si, sp, rows, N2, Rz, Kz, Mq,
                          make_butter(zcoef, Rz), stream));
  else
    PMESH_TRY(z_dense_tc<1>(x, tz, zsum, wzr, wzi, sr, si, sp, nullptr, rows,
                            N2, Zm, Zm, zm, stream));
  const Butter bt = make_butter(ycoef, Ry);
  const long long istride = (long long)N1 * Zm;
  if (bf16s)
    return (int)ct_fwd_tc<1, float, bf16_t>(
        sr, si, ty, nullptr, nullptr, nullptr, (bf16_t*)outr, (bf16_t*)outi,
        nullptr, nullptr, sp, nullptr, nullptr, n0, Ry, My, Zm, Zm, istride,
        1, 1.f, bt, stream);
  return (int)ct_fwd_tc<1, float, float>(
      sr, si, ty, nullptr, nullptr, nullptr, (float*)outr, (float*)outi,
      nullptr, nullptr, sp, nullptr, nullptr, n0, Ry, My, Zm, Zm, istride, 1,
      1.f, bt, stream);
}

// (xr, xi) (N0, n1, W) -> (o1r, o1i) [and (o2r, o2i) when o2r is set]:
// forward (coef = b[r][j] of W_R^{-rj}) times scale, or inverse (coef =
// b[r][j] of W_R^{+rj}); the 1/k^2 fold when k2x is set (k2x (N0,),
// k2y (n1,), k2z (W,), in stored order).  (wr, wi) [and (w2r, w2i)]: the
// (R, M, M) pairs, by which the f32 forward sums column 0.  tab: the
// block table of both sets (bf16), split three ways for the f32 products
// of tc_ct (bf16 = 0; rsum (sets, R, M, 2) the f32 row sums of each
// set's tables), one part for tc_gemm (bf16 = 1; split the data tiles'
// scratch).  bf16s: input and outputs are bf16, and the inverse needs
// the f32 scratch (s1r, s1i) [(s2r, s2i)] (N0, n1, W) for its products.
int pmesh_xct_multi(const void* xr, const void* xi, const float* wr,
                    const float* wi, const float* w2r, const float* w2i,
                    const void* tab, const float* rsum, const float* k2x,
                    const float* k2y, const float* k2z, void* o1r, void* o1i,
                    void* o2r, void* o2i, float* s1r, float* s1i, float* s2r,
                    float* s2i, void* split, int N0, int n1, int W, int R,
                    int M, int inverse, float scale, const float* coef,
                    int bf16, int bf16s, void* stream_) {
  (void)N0;
  const Butter bt = make_butter(coef, R);
  cudaStream_t stream = (cudaStream_t)stream_;
  if (!bf16 && bf16s)
    return (int)x_ct_tc<bf16_t>(
        (const bf16_t*)xr, (const bf16_t*)xi, tab, rsum, wr, wi, w2r, w2i,
        k2x, k2y, k2z,
        (bf16_t*)o1r, (bf16_t*)o1i, (bf16_t*)o2r, (bf16_t*)o2i, s1r, s1i,
        s2r, s2i, n1, W, R, M, inverse != 0, scale, bt, stream);
  if (!bf16)
    return (int)x_ct_tc<float>(
        (const float*)xr, (const float*)xi, tab, rsum, wr, wi, w2r, w2i,
        k2x, k2y, k2z,
        (float*)o1r, (float*)o1i, (float*)o2r, (float*)o2i, s1r, s1i, s2r,
        s2i, n1, W, R, M, inverse != 0, scale, bt, stream);
  if (bf16s)
    return (int)x_ct<bf16_t>(
        (const bf16_t*)xr, (const bf16_t*)xi, tab, k2x, k2y, k2z,
        (bf16_t*)o1r, (bf16_t*)o1i, (bf16_t*)o2r, (bf16_t*)o2i, s1r, s1i, s2r,
        s2i, (bf16_t*)split, n1, W, R, M, inverse != 0, scale, bt, stream);
  return (int)x_ct<float>(
      (const float*)xr, (const float*)xi, tab, k2x, k2y, k2z, (float*)o1r,
      (float*)o1i, (float*)o2r, (float*)o2i, s1r, s1i, s2r, s2i,
      (bf16_t*)split, n1, W, R, M, inverse != 0, scale, bt, stream);
}

// (xr, xi) (n0, N1, Zm) -> out (n0, N1, n2): the inverse y CT by (Ry, My,
// My) tables, ycoef b[r][j] of W_R^{+rj}, then the z inverse, zct = 0:
// dense (Zm, n2); zct = 1: (Ri, Kin, Kb) chunks with zcoef the (Ri, Ri,
// 2) combination cs[j][c]; plus plane (n0, N1) times (-1)^n when set.
// ty: ct_block_table's tiles of the y pair, tz: z_inv_block_table's of
// the z pair, both swizzled, three parts for the f32 products (bf16 =
// 0), one for the bf16 products.  Scratch: (sr, si) (n0, N1, Zm), split
// (the larger stage's data tiles) and, for zct, zq (n0, N1, n2).  bf16s:
// (xr, xi) are bf16.
int pmesh_zy_inv_ct2(const void* xr, const void* xi, const void* ty,
                     const void* tz, int zct, int Ri, int Kin, int Kb,
                     const float* plane, float* out, float* sr, float* si,
                     float* zq, void* split, int n0, int N1, int Zm, int n2,
                     int Ry, int My, const float* ycoef, const float* zcoef,
                     int bf16, int bf16s, void* stream_) {
  return zy_inv_forms(xr, xi, ty, tz, nullptr, zct, Ri, Kin, Kb, plane, out,
                      nullptr, sr, si, nullptr, nullptr, zq, split, n0, N1,
                      Zm, n2, Ry, My, ycoef, zcoef, bf16, bf16s,
                      (cudaStream_t)stream_);
}

// the dual form: set A (the y sets' tiles ty, both sets; tzA, planeA) ->
// outA, set B (tzB) -> outB, both y stages on one split of the spectrum.
// Scratch (sAr, sAi, sBr, sBi) (n0, N1, Zm), split and, for zct, zq (n0,
// N1, n2).  bf16s: (xr, xi) are bf16.
int pmesh_zy_inv_ct2_dual(const void* xr, const void* xi, const void* ty,
                          const void* tzA, const void* tzB, int zct, int Ri,
                          int Kin, int Kb, const float* planeA, float* outA,
                          float* outB, float* sAr, float* sAi, float* sBr,
                          float* sBi, float* zq, void* split, int n0, int N1,
                          int Zm, int n2, int Ry, int My, const float* ycoef,
                          const float* zcoef, int bf16, int bf16s,
                          void* stream_) {
  return zy_inv_forms(xr, xi, ty, tzA, tzB, zct, Ri, Kin, Kb, planeA, outA,
                      outB, sAr, sAi, sBr, sBi, zq, split, n0, N1, Zm, n2, Ry,
                      My, ycoef, zcoef, bf16, bf16s, (cudaStream_t)stream_);
}

// --- the dense pipeline ---------------------------------------------------

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zh): the dense z half-DFT
// by (wzr, wzi) (N2, Zh) into the scratch (sr, si) (n0 N1 rows of pitch
// Zp, a multiple of 4), then the dense y DFT by (wyr, wyi) (N1, N1),
// natural order throughout, on the tensor cores (bf16: the one-part
// form).  tz, ty: the block tables (bf16; tz over the first zm modes,
// the rest chained), zsum (Zh, 2) and ysum (N1, 2) their f32 sums.
// Scratch: split (the larger of the two stages' data tiles), c0
// (max(n0 N1, 2 n0 Zh) f32).
int pmesh_zy_fwd_half(const float* x, const float* wzr, const float* wzi,
                      const float* wyr, const float* wyi, const void* tz,
                      const float* zsum, const void* ty, const float* ysum,
                      float* outr, float* outi, float* sr, float* si,
                      void* split, float* c0, int n0, int N1, int N2, int Zh,
                      int Zp, int zm, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long rows = (long long)n0 * N1;
  bf16_t* sp = (bf16_t*)split;
  if (bf16) {
    PMESH_TRY(z_dense_tc<1>(x, tz, zsum, wzr, wzi, sr, si, sp, c0, rows, N2,
                            Zh, Zp, zm, stream));
    return (int)dense_tc<1>(sr, si, ty, ysum, wyr, wyi, nullptr, nullptr,
                            nullptr, nullptr, nullptr, outr, outi, nullptr,
                            nullptr, sp, c0, n0, N1, Zh, Zp,
                            (long long)N1 * Zp, 1, 1.f, false, stream);
  }
  PMESH_TRY(z_dense_tc<3>(x, tz, zsum, wzr, wzi, sr, si, sp, c0, rows, N2,
                          Zh, Zp, zm, stream));
  return (int)dense_tc<3>(sr, si, ty, ysum, wyr, wyi, nullptr, nullptr,
                          nullptr, nullptr, nullptr, outr, outi, nullptr,
                          nullptr, sp, c0, n0, N1, Zh, Zp, (long long)N1 * Zp,
                          1, 1.f, true, stream);
}

// (xr, xi) (N0, n1, W) -> (o1r, o1i) by the (N0, N0) table (wr, wi)
// times scale [and (o2r, o2i) by (w2r, w2i) when w2r is set], with the
// 1/k^2 fold when k2x is set (k2x (N0,), k2y (n1,), k2z (W,), natural
// order), on the tensor cores: tab the block table of both sets (bf16;
// one part for bf16 = 1), rsum (sets, N0, 2) their f32 row sums.  center
// (a forward pass, f32 products): each column's first element is taken
// out and column 0 formed in chains.  (Not for an inverse: a filtered
// spectrum's first row can exceed the rest by orders of magnitude, and
// taking it out of a column whose output it does not reach, through the
// i k_x-folded table's zero column, leaves a cancellation in its place.)
// Scratch: split (the data's tiles), c0 (2 n1 W f32).
int pmesh_x_dense(const float* xr, const float* xi, const float* wr,
                  const float* wi, const float* w2r, const float* w2i,
                  const void* tab, const float* rsum, const float* k2x,
                  const float* k2y, const float* k2z, float* o1r, float* o1i,
                  float* o2r, float* o2i, void* split, float* c0, int N0,
                  int n1, int W, float scale, int center, int bf16,
                  void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long ncols = (long long)n1 * W;
  if (ncols > INT32_MAX) return (int)cudaErrorInvalidValue;
  bf16_t* sp = (bf16_t*)split;
  if (bf16)
    return (int)dense_tc<1>(xr, xi, tab, rsum, wr, wi, w2r, w2i, k2x, k2y,
                            k2z, o1r, o1i, o2r, o2i, sp, c0, 1, N0,
                            (int)ncols, (int)ncols, 0, W, scale, false,
                            stream);
  return (int)dense_tc<3>(xr, xi, tab, rsum, wr, wi, w2r, w2i, k2x, k2y, k2z,
                          o1r, o1i, o2r, o2i, sp, c0, 1, N0, (int)ncols,
                          (int)ncols, 0, W, scale, center != 0, stream);
}

// (xr, xi) (n0, N1, Zh) -> out (n0, N1, n2): the dense inverse y DFT
// by ty, the block table of the (N1, N1) pair, into the scratch (sr, si)
// (n0, N1, Zh), then z half -> real by tz, z_inv_block_table's of the
// (Zh, n2) irfft pair, on the tensor cores (three-part tables, one-part
// for bf16).  Scratch: split (the larger stage's data tiles).
int pmesh_zy_inv_half(const float* xr, const float* xi, const void* ty,
                      const void* tz, float* out, float* sr, float* si,
                      void* split, int n0, int N1, int Zh, int n2, int bf16,
                      void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  bf16_t* sp = (bf16_t*)split;
  const long long rows = (long long)n0 * N1;
  if (rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Butter one = {};
  if (bf16) {
    PMESH_TRY(dense_tc<1>(xr, xi, ty, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, sr, si, nullptr,
                          nullptr, sp, nullptr, n0, N1, Zh, Zh,
                          (long long)N1 * Zh, 1, 1.f, false, stream));
    return (int)z_inv_tc<1>(sr, si, tz, nullptr, out, nullptr, sp, 1, 1,
                            (int)rows, Zh, n2, one, 0, 1, 0, 0, nullptr,
                            stream);
  }
  PMESH_TRY(dense_tc<3>(xr, xi, ty, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, sr, si, nullptr,
                        nullptr, sp, nullptr, n0, N1, Zh, Zh,
                        (long long)N1 * Zh, 1, 1.f, false, stream));
  return (int)z_inv_tc<3>(sr, si, tz, nullptr, out, nullptr, sp, 1, 1,
                          (int)rows, Zh, n2, one, 0, 1, 0, 0, nullptr,
                          stream);
}

// --- the older pipelines (fft_mxu_ref.py) ---------------------------------

// (xr, xi) (n0, N1, N2) full spectrum -> out (n0, N1, N2), the real part
// of the inverse z and y DFTs, on the tensor cores: the complex z
// product by tz, the stacked block table of the (N2, N2) pair (A, B) =
// (Re Wz, -Im Wz), into the scratch (sr, si) (n0, N1, N2), then the real
// part of the inverse y DFT by ty, the real-output block table of the
// (N1, N1) pair (rows [Wr | -Wi]); three-part tables, one-part for
// bf16.  Scratch: split (the larger stage's data tiles).
int pmesh_zy_inv_full(const float* xr, const float* xi, const void* ty,
                      const void* tz, float* out, float* sr, float* si,
                      void* split, int n0, int N1, int N2, int bf16,
                      void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  bf16_t* sp = (bf16_t*)split;
  if (bf16)
    return (int)zy_inv_full_tc<1>(xr, xi, ty, tz, out, sr, si, sp, n0, N1,
                                  N2, stream);
  return (int)zy_inv_full_tc<3>(xr, xi, ty, tz, out, sr, si, sp, n0, N1, N2,
                                stream);
}

// x (n0, N1, N2) real -> (outr, outi) (n0, N1, Zh): the dense z half-DFT
// by tz, the block table of the (N2, Zh) pair (wzr, wzi) over its first
// zm modes (zsum (Zh, 2) its f32 column sums), into the scratch (sr, si)
// (n0 N1 rows of pitch Zp, a multiple of 4), then the y CT by ty, the
// block table of the (Ry, My, My) pair (wyr, wyi) (ysum (1, Ry, My, 2)
// its f32 row sums), ycoef b[r][j] of W_R^{-rj}, on the tensor cores
// (three-part tables, one-part for bf16).  y leaves chunk-permuted; the
// z-Nyquist column stays at index Zh - 1.  Scratch: split (the larger of
// the two stages' data tiles), c0 (max(n0 N1, 2 Ry n0 Zh) f32).
int pmesh_zy_fwd_half_ct(const float* x, const float* wzr, const float* wzi,
                         const float* wyr, const float* wyi, const void* tz,
                         const float* zsum, const void* ty,
                         const float* ysum, const float* ycoef, float* outr,
                         float* outi, float* sr, float* si, void* split,
                         float* c0, int n0, int N1, int N2, int Zh, int Zp,
                         int zm, int Ry, int My, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  bf16_t* sp = (bf16_t*)split;
  const Butter bt = make_butter(ycoef, Ry);
  if (bf16)
    return (int)zy_fwd_half_ct_tc<1>(x, wzr, wzi, wyr, wyi, tz, zsum, ty,
                                     ysum, bt, outr, outi, sr, si, sp, c0,
                                     n0, N1, N2, Zh, Zp, zm, Ry, My, stream);
  return (int)zy_fwd_half_ct_tc<3>(x, wzr, wzi, wyr, wyi, tz, zsum, ty, ysum,
                                   bt, outr, outi, sr, si, sp, c0, n0, N1, N2,
                                   Zh, Zp, zm, Ry, My, stream);
}

}  // extern "C"
