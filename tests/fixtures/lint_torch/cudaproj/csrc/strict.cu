// Known-clean twin of contracted.cu: the same product, built with --fmad=false.
__global__ void k(double* out) {
  double a = out[0], b = out[1], cc = out[2];
  out[3] = a * b + cc;
}
