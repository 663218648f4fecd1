// Included by contracted.cu, so built with contraction on.
__device__ double axpy(double a, double x, double y) {
  return a * x + y;  // VIOLATION: the header inherits its includer's flags
}
