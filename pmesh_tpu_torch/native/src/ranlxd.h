// RANLUX double-precision generator (Luscher's second-generation
// 48-bit algorithm), implemented to be stream-compatible with
// gsl_rng_ranlxd1 so Gadget/N-GenIC initial conditions reproduce
// bit-for-bit (reference consumer: pmesh/_whitenoise_generics.h).
//
// All state values are non-negative multiples of 2^-48 below 1, so
// every subtraction below is exact in IEEE double arithmetic and the
// produced stream is deterministic across compilers/arches.
#pragma once
#include <cstdint>

namespace pmesh_rt {

class Ranlxd {
 public:
  // luxury = 202 reproduces ranlxd1; 397 reproduces ranlxd2.
  explicit Ranlxd(unsigned long seed = 1, int luxury = 202) {
    Seed(seed, luxury);
  }

  void Seed(unsigned long seed, int luxury = 202);

  // next double in [0, 1)
  double Next();

  // uniform in (0, 1]-ish matching gsl_rng_uniform semantics
  // (gsl_rng_uniform returns get_double which is [0,1)).
  double Uniform() { return Next(); }

 private:
  void Advance();

  double x_[12];
  double carry_;
  int ir_, jr_, ir_old_, lux_;
};

}  // namespace pmesh_rt
