// K3: the hybrid-queue dispatch of paper section 4.3: tuples in arrival order
// go into bounded per-partition FIFO buffers, each at its stable rank within
// its partition (the master-queue property, Theorem 4.1(2)).
//
// Replaces src/repro/kernels/dispatch/dispatch.py:23 (_dispatch_kernel;
// pallas_call at :79).  The Pallas kernel ranks with a (T,T) triangular
// matmul and scatters with a (P*C,T) one-hot matmul, because the TPU has no
// fast random access.  Here, four launches on one stream:
//   1. rank:   one block per tile of 256 tuples.  Each warp groups its lanes
//      by partition with __match_any_sync; a lane's rank in its warp is the
//      popcount of its peers below it, and each group's leader writes the
//      group's size to a per-warp histogram in shared memory.  A scan over
//      the 8 warps gives each tuple its rank within the tile, and the tile's
//      histogram goes to device memory.
//   2. scan:   one thread per partition scans the tile histograms in tile
//      order (exclusive), which gives each tile's offset in each partition
//      and counts[p] (before the capacity clamp).
//   3. dest:   rank = tile offset + rank in tile; dest = p*C + rank if rank
//      < C, else -1; the inverse map inv[dest] = t.
//   4. fill:   every buffer row once: row (p, r) copies payload inv[p*C + r]
//      if r < min(counts[p], C), else zeros.  The buffers are never zeroed
//      in a separate pass.
// An id outside [0, P) is invalid: it ranks nowhere and gets dest -1, as in
// the plain version (dispatch/ref.py).
//
// Bound: device-memory bytes.  Each payload row is read at most once and
// each buffer row written once (T*W in, P*C*W out); the ids, dest and counts
// are small beside them, and the ranking's integer work is a few
// instructions per tuple.  Rows are moved as raw bytes in the widest vector
// that divides the row and the pointers (csrc/rows.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPartitions = 1024;  // kWarps * kMaxPartitions ints of shared memory

__device__ __forceinline__ bool valid_id(int id, int P) { return id >= 0 && id < P; }

__global__ void __launch_bounds__(kThreads)
rank_kernel(const int* __restrict__ ids, int T, int P, int* __restrict__ local_rank,
            int* __restrict__ tile_hist) {
  __shared__ int warp_hist[kWarps * kMaxPartitions];  // [warp][partition]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kWarps * P; i += kThreads) warp_hist[i] = 0;
  __syncthreads();

  const long long t = (long long)blockIdx.x * kThreads + tid;
  const int id = t < T ? ids[t] : -1;
  const bool valid = valid_id(id, P);
  const int key = valid ? id : -1;  // every invalid lane in one group
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const unsigned below = peers & ((1u << lane) - 1u);
  const int rank_in_warp = __popc(below);
  if (valid && below == 0) warp_hist[warp * P + id] = __popc(peers);
  __syncthreads();

  // exclusive scan over the warps for each partition; the tile's totals
  for (int p = tid; p < P; p += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_hist[w * P + p];
      warp_hist[w * P + p] = run;
      run += c;
    }
    tile_hist[(long long)blockIdx.x * P + p] = run;
  }
  __syncthreads();
  if (t < T) local_rank[t] = valid ? warp_hist[warp * P + id] + rank_in_warp : -1;
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ tile_hist, int tiles, int P, int* __restrict__ counts) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  int run = 0;
  for (int i = 0; i < tiles; ++i) {
    const long long at = (long long)i * P + p;
    const int c = tile_hist[at];
    tile_hist[at] = run;
    run += c;
  }
  counts[p] = run;
}

__global__ void __launch_bounds__(kThreads)
dest_kernel(const int* __restrict__ ids, int T, int P, int C,
            const int* __restrict__ local_rank, const int* __restrict__ tile_offset,
            int* __restrict__ dest, int* __restrict__ inv) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int id = ids[t];
  int d = -1;
  if (valid_id(id, P)) {
    const int rank = tile_offset[(t / kThreads) * P + id] + local_rank[t];
    if (rank < C) {
      d = id * C + rank;
      inv[d] = (int)t;
    }
  }
  dest[t] = d;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
fill_kernel(const V* __restrict__ payloads, const int* __restrict__ counts,
            const int* __restrict__ inv, int C, long long nrows, long long rv,
            V* __restrict__ buffers) {
  const long long total = nrows * rv;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += (long long)gridDim.x * blockDim.x) {
    const long long row = v / rv, c = v - row * rv;
    const int p = (int)(row / C), r = (int)(row - (long long)p * C);
    V out = V{};
    if (r < min(counts[p], C)) out = payloads[(long long)inv[row] * rv + c];
    buffers[v] = out;
  }
}

template <typename V>
int launch_fill(const void* payloads, const int* counts, const int* inv, int P, int C,
                long long row_bytes, void* buffers, cudaStream_t stream) {
  const long long rv = row_bytes / (long long)sizeof(V);
  const long long nrows = (long long)P * C;
  fill_kernel<V><<<rows::grid_for(nrows * rv, kThreads), kThreads, 0, stream>>>(
      static_cast<const V*>(payloads), counts, inv, C, nrows, rv, static_cast<V*>(buffers));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dispatch_launches_per_call() { return 4; }
extern "C" int dispatch_tile() { return kThreads; }
extern "C" int dispatch_max_partitions() { return kMaxPartitions; }

// One dispatch on `stream`: ids (T,) int32, payloads (T, row_bytes) ->
// buffers (P*C, row_bytes), counts (P,) int32, dest (T,) int32.  Scratch
// from the caller: local_rank (T,) int32, tile_hist (ceil(T/256) * P,) int32,
// inv (P*C,) int32.  Returns a cudaError_t (cudaErrorInvalidValue for sizes
// the kernel does not take).  Does not synchronise.
extern "C" int dispatch_launch(const void* ids, int T, const void* payloads,
                               long long row_bytes, int P, int C, void* buffers,
                               void* counts, void* dest, void* local_rank, void* tile_hist,
                               void* inv, void* stream) {
  if (T < 1 || P < 1 || P > kMaxPartitions || C < 1 || row_bytes < 1 ||
      (long long)P * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto id = static_cast<const int*>(ids);
  auto cn = static_cast<int*>(counts);
  auto lr = static_cast<int*>(local_rank);
  auto th = static_cast<int*>(tile_hist);
  auto iv = static_cast<int*>(inv);
  const int tiles = (T + kThreads - 1) / kThreads;

  rank_kernel<<<tiles, kThreads, 0, s>>>(id, T, P, lr, th);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(th, tiles, P, cn);
  err = (int)cudaGetLastError();
  if (err) return err;
  dest_kernel<<<tiles, kThreads, 0, s>>>(id, T, P, C, lr, th, static_cast<int*>(dest), iv);
  err = (int)cudaGetLastError();
  if (err) return err;

  const uintptr_t align = (uintptr_t)payloads | (uintptr_t)buffers | (uintptr_t)row_bytes;
  return rows::with_vector(align, [&](auto v) {
    return launch_fill<decltype(v)>(payloads, cn, iv, P, C, row_bytes, buffers, s);
  });
}
