// Deliberate fma-hazard violations: built without --fmad=false.
#include "helpers.cuh"

__global__ void k(double* out, const float* f, int pc, int c) {
  double a = out[0], b = out[1], cc = out[2];
  out[3] = a * b + cc;  // VIOLATION: a double product feeding an add
  out[4] = __dadd_rn(__dmul_rn(a, b), cc);  // clean: rounded apart by hand
  out[5] = out[8 * pc + c];  // clean: integer index arithmetic
  const float g = f[0] * f[1] + f[2];  // clean: a float product
  // double-buffered tiles: the word in a comment declares nothing
  out[6] = g;
  out[7] = cc - a * b;  // tentlint: disable=fma-hazard
}
