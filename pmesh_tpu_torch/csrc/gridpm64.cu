// The f64 forms of the lattice paint and readout (gridpm.cu, which says
// what they compute and how), built as a library of their own so that
// nvcc compiles them in parallel with the f32 and bf16 forms: the entry
// points of this library take f64 storage alone.
#define GRIDPM_F64 1
#include "gridpm.cu"
