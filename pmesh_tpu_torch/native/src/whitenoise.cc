// Gadget/N-GenIC compatible hermitian white noise, host side.
//
// Behavioral contract (reference: pmesh/_whitenoise_generics.h,
// _whitenoise_imp.c): a 2-d seed table over (i, j) filled in an
// inside-out spiral from a master ranlxd1 stream — so that a larger
// mesh reproduces a smaller mesh's low-k modes — then an independent
// ranlxd1 stream per (i, j) column sampling (phase, amplitude) pairs
// down k, with conjugate-quadrant pulls on the k = 0 and k = Nyquist
// planes to enforce hermitianity, self-conjugate modes forced real,
// and the DC mode zeroed.
//
// Differences from the reference implementation (same output):
// - a single global master seed table replaces the four mirrored
//   quadrant copies; conjugate lookups mirror the index instead,
// - the per-column fills are OpenMP-parallel (they are independent
//   given the seed table); the reference is serial per rank.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "ranlxd.h"

#ifdef _OPENMP
#include <omp.h>
#endif

namespace pmesh_rt {
namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;

// One (phase, amplitude) pair; amplitude redraws until nonzero,
// matching the reference's rejection loop (_whitenoise_imp.c:20-26).
inline void SamplePair(Ranlxd& rng, double* ampl, double* phase) {
  *phase = rng.Uniform() * kTwoPi;
  double a = 0.0;
  do {
    a = rng.Uniform();
  } while (a == 0.0);
  *ampl = a;
}

// Master seed table: master[i * N + j] is the 31-bit seed of column
// (i, j), assigned in the inside-out spiral order that defines the
// resolution-invariance contract.
std::vector<uint32_t> BuildSeedTable(int64_t N, uint32_t seed) {
  std::vector<uint32_t> master(static_cast<size_t>(N) * N, 0u);
  Ranlxd rng(seed);
  auto put = [&](int64_t a, int64_t b) {
    uint32_t s = static_cast<uint32_t>(0x7fffffff * rng.Uniform());
    master[static_cast<size_t>(a) * N + b] = s;
  };
  for (int64_t i = 0; i < N / 2; ++i) {
    for (int64_t j = 0; j < i; ++j) put(i, j);
    for (int64_t j = 0; j < i + 1; ++j) put(j, i);
    for (int64_t j = 0; j < i; ++j) put(N - 1 - i, j);
    for (int64_t j = 0; j < i + 1; ++j) put(N - 1 - j, i);
    for (int64_t j = 0; j < i; ++j) put(i, N - 1 - j);
    for (int64_t j = 0; j < i + 1; ++j) put(j, N - 1 - i);
    for (int64_t j = 0; j < i; ++j) put(N - 1 - i, N - 1 - j);
    for (int64_t j = 0; j < i + 1; ++j) put(N - 1 - j, N - 1 - i);
  }
  return master;
}

template <typename FLOAT>
void Fill(const int64_t Nmesh[3], const int64_t start[3],
          const int64_t size[3], uint32_t seed, bool unitary, FLOAT* out) {
  const int64_t N0 = Nmesh[0], N1 = Nmesh[1], N2 = Nmesh[2];
  std::vector<uint32_t> master = BuildSeedTable(N0, seed);

  // When no negative-k2 columns are requested the field is the
  // compressed half spectrum and the negative pass can be skipped
  // (reference generics:44-70).  Ordering matters for the full
  // layout: the negative pass first so the positive pass overwrites
  // the shared Nyquist column.
  bool compressed = start[2] + size[2] <= N2 / 2 + 1;
  int signs[2];
  int nsigns;
  if (compressed) {
    signs[0] = 1;
    nsigns = 1;
  } else {
    signs[0] = -1;
    signs[1] = 1;
    nsigns = 2;
  }

  // the seed-table scheme assumes a square (i, j) plane, as in
  // Gadget itself; the spiral walks an N0 x N0 table.
  auto seed_at = [&](int64_t i, int64_t j) {
    return master[static_cast<size_t>(i) * N0 + j];
  };
  (void)N1;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int64_t i = start[0]; i < start[0] + size[0]; ++i) {
    Ranlxd lower_rng, this_rng;
    int64_t ci = (N0 - i) % N0;
    for (int64_t j = start[1]; j < start[1] + size[1]; ++j) {
      int64_t cj = (N1 - j) % N1;
      // does (i, j) live in the upper quadrant whose modes mirror a
      // lower-quadrant column? (reference generics:119-131)
      bool conjq = (ci == i && cj < j) || (ci < i && cj != j) ||
                   (ci < i && cj == j);

      for (int is = 0; is < nsigns; ++is) {
        int sign = signs[is];
        uint32_t seed_lower =
            conjq ? seed_at(ci, cj) : seed_at(i, j);
        uint32_t seed_this =
            (sign == 1) ? seed_at(i, j) : seed_at(ci, cj);
        lower_rng.Seed(seed_lower);
        this_rng.Seed(seed_this);

        for (int64_t k = 0; k <= N2 / 2; ++k) {
          bool use_conj = conjq && (k == 0 || k == N2 / 2);
          double ampl, phase;
          if (use_conj) {
            // the hermitian image of a lower-quadrant mode: advance
            // both streams, keep the lower one (generics:155-159)
            SamplePair(this_rng, &ampl, &phase);
            SamplePair(lower_rng, &ampl, &phase);
          } else {
            SamplePair(lower_rng, &ampl, &phase);
            SamplePair(this_rng, &ampl, &phase);
          }

          int64_t kabs = (sign == -1) ? N2 - k : k;
          int64_t rel2 = kabs - start[2];
          if (rel2 < 0 || rel2 >= size[2]) continue;

          if (unitary) {
            ampl = 1.0;
          } else {
            ampl = std::sqrt(-std::log(ampl));  // Rayleigh amplitude
          }
          double re = ampl * std::cos(phase);
          double im = ampl * std::sin(phase);
          if (sign == -1) im = -im;
          if (use_conj) im = -im;

          if ((N0 - i) % N0 == i && (N1 - j) % N1 == j &&
              (N2 - kabs) % N2 == kabs) {
            im = 0.0;  // self-conjugate modes are real
            if (unitary) re = 1.0;
          }
          if (i == 0 && j == 0 && kabs == 0) {
            re = 0.0;  // zero mean
            im = 0.0;
          }

          size_t ip = ((static_cast<size_t>(i - start[0]) * size[1] +
                        (j - start[1])) * size[2] + rel2) * 2;
          out[ip] = static_cast<FLOAT>(re);
          out[ip + 1] = static_cast<FLOAT>(im);
        }
      }
    }
  }
}

}  // namespace
}  // namespace pmesh_rt

extern "C" {

// out points to a (size0, size1, size2) complex array (interleaved
// re/im), float when is_f32 else double.
void pmesh_rt_whitenoise_fill(const int64_t* Nmesh, const int64_t* start,
                              const int64_t* size, uint32_t seed,
                              int unitary, int is_f32, void* out) {
  if (is_f32) {
    pmesh_rt::Fill<float>(Nmesh, start, size, seed, unitary != 0,
                          static_cast<float*>(out));
  } else {
    pmesh_rt::Fill<double>(Nmesh, start, size, seed, unitary != 0,
                           static_cast<double*>(out));
  }
}

// test hook: n doubles from a ranlxd1 stream
void pmesh_rt_ranlxd_fill(uint32_t seed, int64_t n, double* out) {
  pmesh_rt::Ranlxd rng(seed);
  for (int64_t i = 0; i < n; ++i) out[i] = rng.Uniform();
}

}  // extern "C"
