// Scale-invariant inside-out mode indexing.
//
// Maps an integer mode vector to its position in an inside-out
// (Linf-shell ordered) enumeration of the mode cube, so that modes
// closer to zero always index lower — the ordering contract of the
// reference (pmesh/_invariant_imp.c, pmesh/invariant.py).
//
// Enumeration scheme (re-derived): the outermost Linf shell of
// half-width `s` is the boundary of a (2s+1)^d cube.  Expanding
// ((2s-1) + 2)^d binomially partitions the shell into "face sets":
// for every subset A of axes (those pinned at +-s) and every sign
// assignment on A, a face of size (2s-1)^(d-|A|).  Iterating sign
// assignments in the outer loop (all-positive first) and axis
// subsets in the inner loop gives a stable order in which the index
// of any mode is the sum of the sizes of all faces preceding the one
// that contains it, plus the (recursive) index of its projection
// into that face.  Compressed axes drop the faces pinned at the
// negative edge and halve the free range of that axis.
#include <cstdint>
#include <cstdlib>

namespace pmesh_rt {
namespace {

inline int popcount(uint32_t v) { return __builtin_popcount(v); }

inline int64_t ipow(int64_t base, int p) {
  int64_t r = 1;
  while (p-- > 0) r *= base;
  return r;
}

int64_t InvariantIndex(int ndim, const int64_t* x, uint32_t cmask,
                       int64_t max_length) {
  // shell = Linf norm
  int64_t shell = 0;
  for (int d = 0; d < ndim; ++d) {
    int64_t a = x[d] < 0 ? -x[d] : x[d];
    if (a > shell) shell = a;
  }
  if (shell == 0) return 0;

  for (int d = 0; d < ndim; ++d) {
    if ((cmask & (1u << d)) && x[d] < 0) return -1;  // not stored
  }

  const int64_t side = 2 * shell + 1;

  // which face hosts the query: axes pinned at the shell, and the
  // sign of each pinned axis
  uint32_t host_axes = 0, host_signs = 0;
  int64_t sub[32];
  uint32_t sub_cmask = 0;
  int sub_ndim = 0;
  for (int d = 0; d < ndim; ++d) {
    int64_t a = x[d] < 0 ? -x[d] : x[d];
    if (a == shell) {
      host_axes |= (1u << d);
      if (x[d] < 0) host_signs |= (1u << d);
    } else {
      sub[sub_ndim] = x[d];
      if ((cmask >> d) & 1) sub_cmask |= (1u << sub_ndim);
      ++sub_ndim;
    }
  }

  const uint32_t nsets = 1u << ndim;
  int64_t sizes[1u << 8];  // per-axis-subset face size cache (ndim <= 8)
  for (uint32_t a = 0; a < nsets; ++a) sizes[a] = 0;

  int64_t ind = 0;
  for (uint32_t signs = 0; signs < nsets; ++signs) {
    for (uint32_t axes = 0; axes < nsets; ++axes) {
      if (signs & ~axes) continue;       // sign bit without pinned axis
      if (signs & cmask) continue;       // negative edge of a
                                         // compressed axis: not stored
      if (signs == host_signs && axes == host_axes) {
        int64_t sub_max = max_length >= 0 ? max_length - ind : -1;
        int64_t s = InvariantIndex(sub_ndim, sub, sub_cmask, sub_max);
        if (s == -1) return -1;
        ind += s;
        if (max_length >= 0 && ind >= max_length) return -1;
        return ind;
      }
      if (sizes[axes] == 0) {
        int npinned = popcount(axes);
        int nhalved = popcount(cmask & ~axes);
        sizes[axes] =
            ipow(side - 2, ndim - npinned - nhalved) * ipow(shell, nhalved);
      }
      ind += sizes[axes];
      if (max_length >= 0 && ind >= max_length) return -1;
    }
  }
  return -1;  // unreachable for valid input
}

}  // namespace
}  // namespace pmesh_rt

extern "C" {

// Vectorized entry: npoints mode vectors of length ndim (row major),
// Nyquist folded positive and out-of-range marked -1 here (the
// reference does this in its cython bridge, _invariant.pyx:36-50).
void pmesh_rt_invariant_index(int ndim, int64_t npoints, const int64_t* x,
                              const int64_t* Nmesh, int compressed,
                              int64_t max_length, int64_t* out) {
  uint32_t cmask = compressed ? (1u << (ndim - 1)) : 0u;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < npoints; ++i) {
    int64_t xi[32];
    bool bad = false;
    for (int d = 0; d < ndim; ++d) {
      int64_t v = x[i * ndim + d];
      if (v == -Nmesh[d] / 2) v = Nmesh[d] / 2;  // fold Nyquist positive
      if (v > Nmesh[d] / 2 || v < -Nmesh[d] / 2) bad = true;
      xi[d] = v;
    }
    out[i] = bad ? -1
                 : pmesh_rt::InvariantIndex(ndim, xi, cmask, max_length);
  }
}

}  // extern "C"
