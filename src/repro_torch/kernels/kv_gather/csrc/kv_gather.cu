// Paged KV-cache gather for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_kernel`
// (src/repro/kernels/kv_gather/kv_gather.py:17, launched by
// `kv_gather_paged`):
//   out[b, p*page:(p+1)*page, :] = pages[table[b, p], :, :]
// On the TPU the page table is scalar-prefetched and the BlockSpec index map
// does the indirection, one grid step per page. Here each CTA loads its own
// id: one CTA per (b, p) slot reads table[b, p] once and copies the page's
// page*KVD*itemsize bytes.
//
// Bound: bytes. Nothing is computed; every byte is read once and written
// once. Design: the copy moves raw bytes in units of U (16 bytes when the
// page bytes and both base pointers are 16-byte aligned, else the widest
// unit that divides them), so one instantiation per unit serves float32,
// bfloat16 and int32 alike. Each thread keeps UNROLL loads in flight before
// it stores them, so a CTA has 512 x 4 x 16 = 32 KB outstanding. Offsets
// are 64-bit: a serving KV pool passes 2^31 bytes. An id outside
// [0, n_pages) reads nothing and leaves zeros (the Python entry point
// raises before launching on such a table).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 4;
constexpr int MAX_THREADS = 512;

template <typename U>
__global__ void __launch_bounds__(MAX_THREADS)
kv_gather_kernel(const U* __restrict__ pages, const void* __restrict__ table, int table64,
                 U* __restrict__ out, long long n_pages, long long units) {
  const long long slot = blockIdx.x;
  const long long id = table64 ? static_cast<const long long*>(table)[slot]
                               : (long long)static_cast<const int*>(table)[slot];
  U* dst = out + slot * units;
  const long long stride = blockDim.x;
  long long i = threadIdx.x;
  if (id < 0 || id >= n_pages) {
    for (; i < units; i += stride) dst[i] = U{};
    return;
  }
  const U* src = pages + id * units;
  for (; i + (UNROLL - 1) * stride < units; i += UNROLL * stride) {
    U v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < units; i += stride) dst[i] = src[i];
}

template <typename U>
int launch_t(const void* pages, const void* table, int table64, void* out, long long n_pages,
             long long row_bytes, long long n_rows, cudaStream_t stream) {
  const long long units = row_bytes / (long long)sizeof(U);
  long long threads = (units + 31) / 32 * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  kv_gather_kernel<U><<<(unsigned)n_rows, (unsigned)threads, 0, stream>>>(
      static_cast<const U*>(pages), table, table64, static_cast<U*>(out), n_pages, units);
  return (int)cudaGetLastError();
}

}  // namespace

// pages: [n_pages, row_bytes] bytes; table: [n_rows] int32 (table64 == 0) or
// int64 ids; out: [n_rows, row_bytes] bytes. `unit` (16, 8, 4, 2 or 1) must
// divide row_bytes and both base addresses. n_rows < 2^31. Returns the
// launch's CUDA error code (0 on success).
extern "C" int kv_gather_launch(const void* pages, const void* table, int table64, void* out,
                                long long n_pages, long long row_bytes, long long n_rows,
                                int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || row_bytes <= 0) return 0;
  switch (unit) {
    case 16: return launch_t<uint4>(pages, table, table64, out, n_pages, row_bytes, n_rows, s);
    case 8: return launch_t<uint2>(pages, table, table64, out, n_pages, row_bytes, n_rows, s);
    case 4: return launch_t<uint32_t>(pages, table, table64, out, n_pages, row_bytes, n_rows, s);
    case 2: return launch_t<uint16_t>(pages, table, table64, out, n_pages, row_bytes, n_rows, s);
    case 1: return launch_t<uint8_t>(pages, table, table64, out, n_pages, row_bytes, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
