#include "ranlxd.h"

namespace pmesh_rt {

namespace {
constexpr double kOneBit = 1.0 / 281474976710656.0;  // 2^-48
inline int nxt(int i) { return i == 11 ? 0 : i + 1; }
}  // namespace

void Ranlxd::Seed(unsigned long seed, int luxury) {
  if (seed == 0) seed = 1;  // default seed per GSL convention

  // Expand the 31 low bits of the seed through a lagged Fibonacci
  // bit sequence into 12 words of 48 bits each (Luscher's seeding).
  int bits[31];
  {
    long s = static_cast<long>(seed & 0xFFFFFFFFUL);
    for (int k = 0; k < 31; ++k) {
      bits[k] = s % 2;
      s /= 2;
    }
  }
  int ib = 0, jb = 18;
  for (int k = 0; k < 12; ++k) {
    double x = 0.0;
    for (int l = 0; l < 48; ++l) {
      double y = static_cast<double>((bits[ib] + 1) % 2);
      x += x + y;
      bits[ib] = (bits[ib] + bits[jb]) % 2;
      ib = (ib + 1) % 31;
      jb = (jb + 1) % 31;
    }
    x_[k] = kOneBit * x;
  }
  carry_ = 0.0;
  ir_ = 11;
  jr_ = 7;
  ir_old_ = 0;
  lux_ = luxury;
}

void Ranlxd::Advance() {
  // Run `lux_` subtract-with-borrow steps.  Every value is an exact
  // multiple of 2^-48, so the arithmetic below is exact.
  int ir = ir_, jr = jr_;
  double carry = carry_;
  for (int k = 0; k < lux_; ++k) {
    double y = x_[jr] - x_[ir] - carry;
    if (y < 0.0) {
      carry = kOneBit;
      y += 1.0;
    } else {
      carry = 0.0;
    }
    x_[ir] = y;
    ir = nxt(ir);
    jr = nxt(jr);
  }
  ir_ = ir;
  ir_old_ = ir;
  jr_ = jr;
  carry_ = carry;
}

double Ranlxd::Next() {
  ir_ = nxt(ir_);
  if (ir_ == ir_old_) Advance();
  return x_[ir_];
}

}  // namespace pmesh_rt
