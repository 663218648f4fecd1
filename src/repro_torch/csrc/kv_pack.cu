// KV-page gather (pack) and scatter (unpack) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels
// repro/kernels/kv_pack/kernel.py::kv_pack_pages   (out = pool[indices])
// repro/kernels/kv_pack/kernel.py::kv_unpack_pages (pool[indices] = buf, in place)
//
// Layout: pool (num_pages, page_size, kv_dim) and buf (n, page_size, kv_dim),
// both contiguous, so a page is one contiguous run of `page_bytes` bytes;
// indices (n,) int32 on the card. The copy does not look at the values, so
// one kernel serves every element type.
//
// Bound: pure data movement. Each moved page is read once and written once,
// 2 * n * page_bytes over 3.35 TB/s on an H100 SXM; there is no arithmetic.
//
// Where the TPU gets each page's address from a scalar-prefetch operand and
// runs one grid step per page in order, here blocks run in parallel and each
// block loads its own page index. The grid is (n, chunks of a page): block
// (i, c) copies chunk c of page slot i, which is THREADS * UNROLL vectors.
// Each thread first loads its UNROLL vectors into registers and then stores
// them, so every thread keeps UNROLL loads in flight. The vector is 16 bytes
// (uint4) when both base pointers and the page size are multiples of 16,
// else the widest of 4, 2 and 1 bytes that divides all three.
//
// An index outside [0, num_pages) is never dereferenced: pack writes zeros
// into that slot and unpack skips it. The Python wrapper rejects such
// indices (and duplicates) before it launches; this guard only keeps a
// caller of the raw entry point from writing outside the pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long MAX_CHUNKS = 65535;  // gridDim.y

template <typename V, bool SCATTER>
__global__ void __launch_bounds__(THREADS)
copy_pages(const char* __restrict__ src, char* __restrict__ dst, const int* __restrict__ idx,
           long long page_words, long long num_pages) {
  const long long slot = blockIdx.x;
  const long long page = idx[slot];
  const bool valid = page >= 0 && page < num_pages;
  const long long page_bytes = page_words * (long long)sizeof(V);
  // pack: pool page -> buffer slot; unpack: buffer slot -> pool page
  const long long src_page = SCATTER ? slot : page;
  const long long dst_page = SCATTER ? page : slot;
  const V* s = reinterpret_cast<const V*>(src + src_page * page_bytes);
  V* d = reinterpret_cast<V*>(dst + dst_page * page_bytes);
  const long long base = (long long)blockIdx.y * (THREADS * UNROLL) + threadIdx.x;
  if (!valid) {
    if (!SCATTER) {
      const V zero{};
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long w = base + (long long)u * THREADS;
        if (w < page_words) d[w] = zero;
      }
    }
    return;
  }
  V r[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long w = base + (long long)u * THREADS;
    if (w < page_words) r[u] = s[w];
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long w = base + (long long)u * THREADS;
    if (w < page_words) d[w] = r[u];
  }
}

template <typename V>
cudaError_t launch(const void* src, void* dst, const int* idx, long long n, long long page_bytes,
                   long long num_pages, bool scatter, cudaStream_t stream) {
  const long long page_words = page_bytes / (long long)sizeof(V);
  const long long chunks = (page_words + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (chunks > MAX_CHUNKS || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)n, (unsigned)chunks);
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (scatter)
    copy_pages<V, true><<<grid, THREADS, 0, stream>>>(s, d, idx, page_words, num_pages);
  else
    copy_pages<V, false><<<grid, THREADS, 0, stream>>>(s, d, idx, page_words, num_pages);
  return cudaGetLastError();
}

}  // namespace

// Copies n pages of page_bytes each. scatter == 0 (pack): src is the pool,
// dst the (n, ...) buffer, dst slot i <- src page idx[i]. scatter == 1
// (unpack): src is the buffer, dst the pool, dst page idx[i] <- src slot i.
// Returns the launch's cudaError_t (0 on success).
extern "C" int kv_pages_copy(const void* src, void* dst, const void* idx, long long n,
                             long long page_bytes, long long num_pages, int scatter,
                             void* stream) {
  if (n < 0 || page_bytes <= 0 || num_pages <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const bool sc = scatter != 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(page_bytes);
  if (align % 16 == 0) return (int)launch<uint4>(src, dst, ix, n, page_bytes, num_pages, sc, st);
  if (align % 4 == 0)
    return (int)launch<uint32_t>(src, dst, ix, n, page_bytes, num_pages, sc, st);
  if (align % 2 == 0)
    return (int)launch<uint16_t>(src, dst, ix, n, page_bytes, num_pages, sc, st);
  return (int)launch<uint8_t>(src, dst, ix, n, page_bytes, num_pages, sc, st);
}
