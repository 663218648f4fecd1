// VIOLATION: no load_library call builds this source.
__global__ void k(float* out) { out[0] = 1.0f; }
