// The f64 lattice kernels at widths 6..NV_MAX (gridpm64.cu says what
// they compute and how), a library of their own so that nvcc builds them
// in parallel with widths 1..5.
#define GRIDPM64_WIDE 1
#include "gridpm64.cu"
