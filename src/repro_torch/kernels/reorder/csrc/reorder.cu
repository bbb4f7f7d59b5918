// K2: the batched reorder-commit of the paper's non-blocking reorder buffer
// (section 3, fig. 4): K completed (serial, payload) pairs go into the ring,
// and the contiguous run of present slots from `next` is emitted in serial
// order.
//
// Replaces src/repro/kernels/reorder/reorder.py:27 (_commit_kernel;
// pallas_call at :110).  The TPU has no fast random access, so the Pallas
// kernel writes the scatter as an (S,K) one-hot matmul and the drain as an
// (S,S) rotation matmul on the MXU.  Here both are direct copies, in three
// launches on one stream:
//   1. scatter: every accepted serial's payload row into slot t % S, its
//      present flag set, and the accepted mask;
//   2. count:   one block takes the minimum ring distance from `next` over the
//      absent slots (the first gap, so the length of the present run), and
//      writes count and next + count;
//   3. emit:    emitted[i] = buf[(next + i) % S] for i < count and zero
//      beyond; the emitted slots' present flags are cleared.
// `next` and `count` stay on the device: nothing is read back to the host.
// The ring (buf, present) is updated in place; next + count goes to a new
// scalar, since every block of launches 1 and 3 reads the old one.
//
// Bound: device-memory bytes.  The contract returns the whole (S,W)
// `emitted`, so a commit writes S*W values however few rows are ready; the
// rest (K payload rows in, accepted rows into the ring, count rows out of it,
// the S present flags) is small beside it.  There is no arithmetic to speak
// of.  Rows are moved as raw bytes in the widest vector that divides the row
// and the pointers (csrc/rows.cuh).
//
// The arithmetic on serials is int32 with wraparound, as the reference's
// (jnp int32): sums go through unsigned ints, and the ring distance is a
// floor-mod ((d % S) + S) % S, since C's % of a negative number is negative.
// Two equal serials in one batch are outside the contract: the reference
// keeps one of them, the Pallas kernel sums them, and here one of the two
// racing copies lands.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCountThreads = 1024;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int floor_mod(int d, int s) { return ((d % s) + s) % s; }

template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ serials, int K, const V* __restrict__ payloads,
               V* __restrict__ buf, unsigned char* __restrict__ present,
               const int* __restrict__ next, int S, long long rv,
               unsigned char* __restrict__ accepted) {
  const int nxt = *next;
  const int hi = wrap_add(nxt, S);
  const long long total = (long long)K * rv;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += (long long)gridDim.x * blockDim.x) {
    const long long k = v / rv, c = v - k * rv;
    const int t = serials[k];
    const bool in = t >= 0 && t >= nxt && t < hi;
    if (in) {
      const long long slot = t % S;
      buf[slot * rv + c] = payloads[v];
      if (c == 0) present[slot] = 1;
    }
    if (c == 0) accepted[k] = in;
  }
}

__global__ void __launch_bounds__(kCountThreads)
count_kernel(const unsigned char* __restrict__ present, const int* __restrict__ next,
             int S, int* __restrict__ count_out, int* __restrict__ next_out) {
  __shared__ int warp_min[kCountThreads / 32];
  const int nxt = *next;
  int m = S;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    if (!present[i]) m = min(m, floor_mod((int)((unsigned)i - (unsigned)nxt), S));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? warp_min[threadIdx.x] : S;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) {
      *count_out = m;
      *next_out = wrap_add(nxt, m);
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const V* __restrict__ buf, unsigned char* __restrict__ present,
            const int* __restrict__ next, const int* __restrict__ count, int S,
            long long rv, V* __restrict__ emitted) {
  const int nxt = *next;
  const int cnt = *count;
  const long long total = (long long)S * rv;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += (long long)gridDim.x * blockDim.x) {
    const long long i = v / rv, c = v - i * rv;
    V out;
    if (i < cnt) {
      const long long slot = floor_mod(wrap_add(nxt, (int)i), S);
      out = buf[slot * rv + c];
      if (c == 0) present[slot] = 0;
    } else {
      out = V{};
    }
    emitted[v] = out;
  }
}

template <typename V>
int launch(const int* serials, int K, const void* payloads, void* buf,
           unsigned char* present, const int* next, int S, long long row_bytes,
           unsigned char* accepted, void* emitted, int* count_out, int* next_out,
           cudaStream_t stream) {
  const long long rv = row_bytes / (long long)sizeof(V);
  scatter_kernel<V><<<rows::grid_for((long long)K * rv, kThreads), kThreads, 0, stream>>>(
      serials, K, static_cast<const V*>(payloads), static_cast<V*>(buf), present, next,
      S, rv, accepted);
  int err = (int)cudaGetLastError();
  if (err) return err;
  count_kernel<<<1, kCountThreads, 0, stream>>>(present, next, S, count_out, next_out);
  err = (int)cudaGetLastError();
  if (err) return err;
  emit_kernel<V><<<rows::grid_for((long long)S * rv, kThreads), kThreads, 0, stream>>>(
      static_cast<const V*>(buf), present, next, count_out, S, rv, static_cast<V*>(emitted));
  return (int)cudaGetLastError();
}

}  // namespace

// Launch count per commit, for the wrapper's LAUNCHES counter.
extern "C" int commit_launches_per_call() { return 3; }

// One reorder-commit on `stream`: serials (K,) int32, payloads (K, row_bytes),
// the ring buf (S, row_bytes) and present (S,) uint8 (updated in place), next
// () int32; writes accepted (K,) uint8, emitted (S, row_bytes), count () and
// next_out () int32.  Returns a cudaError_t (cudaErrorInvalidValue for sizes
// the kernel does not take).  Does not synchronise.
extern "C" int commit_launch(const void* serials, int K, const void* payloads, void* buf,
                             void* present, const void* next, int S, long long row_bytes,
                             void* accepted, void* emitted, void* count_out,
                             void* next_out, void* stream) {
  if (K < 0 || S < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t align =
      (uintptr_t)payloads | (uintptr_t)buf | (uintptr_t)emitted | (uintptr_t)row_bytes;
  auto s = (cudaStream_t)stream;
  auto sr = static_cast<const int*>(serials);
  auto pr = static_cast<unsigned char*>(present);
  auto nx = static_cast<const int*>(next);
  auto ac = static_cast<unsigned char*>(accepted);
  auto co = static_cast<int*>(count_out);
  auto no = static_cast<int*>(next_out);
  return rows::with_vector(align, [&](auto v) {
    return launch<decltype(v)>(sr, K, payloads, buf, pr, nx, S, row_bytes, ac, emitted, co, no, s);
  });
}
