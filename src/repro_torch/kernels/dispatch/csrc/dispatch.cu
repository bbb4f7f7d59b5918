// K3: the hybrid-queue dispatch of paper section 4.3: tuples in arrival order
// go into bounded per-partition FIFO buffers, each at its stable rank within
// its partition (the master-queue property, Theorem 4.1(2)).  Tuple t's
// payload is row t / group of `payloads` (group 1: row t), so the MoE layer
// hands over its token rows and K3 reads each (token, choice) assignment's
// row itself, with no gathered copy in between.
//
// Replaces src/repro/kernels/dispatch/dispatch.py:23 (_dispatch_kernel;
// pallas_call at :79).  The Pallas kernel ranks with a (T,T) triangular
// matmul and scatters with a (P*C,T) one-hot matmul, because the TPU has no
// fast random access.  Here one launch with no dependency between blocks
// (dispatch_one_kernel):
//   - block (p, s) owns rows [r0, r1) of partition p's buffer.  It reads
//     all T ids (from L2: 8 KiB at T = 2,048) in tiles of 2,048, the next
//     tile's loads in flight while it ranks the current one.  Each warp
//     ballots "id == p" for its 32 tuples of each of the tile's 8 rounds; a
//     scan of the 64 (round, warp) popcounts over the block gives each
//     matching tuple its rank in arrival order.  A tuple whose rank falls in
//     [r0, r1) goes into the block's inverse map in shared memory, and the
//     block writes its dest.  A block that needs no later tuple stops
//     early; the first split of p counts all of them (counts[p]), the last
//     writes dest -1 for the tuples past the capacity, and block 0 writes
//     dest -1 for the invalid ids.  Every dest is written once.
//   - the block then writes each of its rows once, the payload row or
//     zeros, a group of lanes to a row (a power of two: a warp when there
//     are many rows, the whole block when it owns one; a narrow row's lanes
//     keep four rows in flight), as the widest vector that divides the row
//     and the pointers (csrc/rows.cuh).  No divide per vector: one 32-bit
//     divide a row (t / group).
//   Up to 32 tuples (a decode step's batch) every warp ranks them alone
//   with one ballot, and finds the tuple at each of its ranks as the n-th
//   set bit: no shared memory and no barrier between the ids and the rows.
//   No scratch in device memory, no spin-wait, no atomics: safe in a CUDA
//   graph, and the wrapper allocates only the three outputs.
// The ranking is O(T) integer work in every block, so the launch grows with
// T times the number of blocks; the main path's calls hold at most 8,192
// tuples (phi3.5-moe's 4,096 tokens, top-2) and the keyed batches 16,384.
// An id outside [0, P) is invalid: it ranks nowhere and gets dest -1, as in
// the plain version (dispatch/ref.py).
//
// Bound: device-memory bytes.  Each payload row a kept tuple needs is read
// at least once and each buffer row written once (P*C*W out); the ids, dest
// and counts are small beside them, and the ranking's integer work is a few
// instructions per tuple and block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPartitions = 1024;
constexpr int kRounds = 8;  // ids a thread ranks per tile
constexpr int kTile = kRounds * kThreads;
constexpr int kMaxRowsPerBlock = 1024;  // the block's inverse map in shared memory
constexpr int kBlocksPerSm = 2;  // the grid aims at this many blocks an SM (1 and 4 measured)
constexpr int kUnroll = 4;  // vectors a lane has in flight in a row copy
static_assert(kRounds * kWarps == 64, "the tile scan holds two (round, warp) counts a lane");

__device__ __forceinline__ bool valid_id(int id, int P) { return id >= 0 && id < P; }

__device__ __forceinline__ int pow2_ceil(int x) {
  return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}

// Lanes that move one row: as many as the row has vectors (a power of two,
// at most the block), but no more than the block's rows leave each (at
// least a warp).
__device__ __forceinline__ int lanes_per_row(long long rv, long long nrows) {
  const int by_width = pow2_ceil((int)(rv < kThreads ? rv : kThreads));
  const int by_rows = kThreads / pow2_ceil((int)(nrows < kThreads ? nrows : kThreads));
  return min(by_width, max(32, by_rows));
}

// One row of rv vectors: payload row `src` (nullptr: zeros) into `dst`, by
// `lanes` lanes of which this thread is `lane`.
template <typename V>
__device__ __forceinline__ void move_row(const V* __restrict__ src, V* __restrict__ dst,
                                         long long rv, int lane, int lanes) {
  const long long step = (long long)lanes * kUnroll;
  if (src == nullptr) {
    const V zero{};
    for (long long c = lane; c < rv; c += lanes) dst[c] = zero;
    return;
  }
  for (long long c = lane; c < rv; c += step) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = c + (long long)u * lanes;
      if (k < rv) v[u] = src[k];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = c + (long long)u * lanes;
      if (k < rv) dst[k] = v[u];
    }
  }
}

// Rows first, first + stride, ... < nrows of `out` (rv vectors each), row i
// from payload row tuple_of(i) / group, or zeros where tuple_of(i) < 0.  A
// row of at most `lanes` vectors gives each lane one vector at most: then
// kUnroll rows are in flight at once, as kUnroll vectors of a wider row are.
template <typename V, typename TupleOf>
__device__ __forceinline__ void move_rows(const V* __restrict__ payloads, int group, long long rv,
                                          V* __restrict__ out, long long first, long long nrows,
                                          long long stride, int lane, int lanes,
                                          TupleOf tuple_of) {
  if (rv <= lanes) {
    for (long long i = first; i < nrows; i += stride * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = i + u * stride;
        v[u] = V{};
        if (row < nrows && lane < rv) {
          const int t = tuple_of(row);
          if (t >= 0) v[u] = payloads[(long long)(t / group) * rv + lane];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = i + u * stride;
        if (row < nrows && lane < rv) out[row * rv + lane] = v[u];
      }
    }
    return;
  }
  for (long long i = first; i < nrows; i += stride) {
    const int t = tuple_of(i);
    move_row<V>(t >= 0 ? payloads + (long long)(t / group) * rv : nullptr, out + i * rv, rv, lane,
                lanes);
  }
}

// ids[base + j*kThreads + tid] for the kRounds rounds j, -1 past T.
__device__ __forceinline__ void load_tile(const int* __restrict__ ids, int T, int base,
                                          int (&id)[kRounds]) {
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int t = base + j * kThreads + (int)threadIdx.x;
    id[j] = t < T ? ids[t] : -1;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
dispatch_one_kernel(const int* __restrict__ ids, int T, const V* __restrict__ payloads,
                    int group, long long rv, int P, int C, int splits, int rows_per_block,
                    V* __restrict__ buffers, int* __restrict__ counts, int* __restrict__ dest) {
  __shared__ int inv[kMaxRowsPerBlock];  // tuple at rank r0 + i, or -1
  __shared__ int warp_count[kRounds * kWarps];  // matches of each (round, warp)
  __shared__ int warp_offset[kRounds * kWarps];  // their rank offsets
  __shared__ int tile_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x / splits, s = blockIdx.x - p * splits;
  const int r0 = s * rows_per_block, r1 = min(C, r0 + rows_per_block);
  const int nrows = r1 - r0;
  const bool first = s == 0, last = s == splits - 1, writes_invalid = blockIdx.x == 0;
  const bool stops_early = !first && !last && !writes_invalid;
  const unsigned below = (1u << lane) - 1u;
  const int lanes = lanes_per_row(rv, nrows);
  V* out = buffers + (long long)(p * C + r0) * rv;
  if (T <= 32) {  // a decode step's batch: every warp ranks it alone, no barrier
    const int id = lane < T ? ids[lane] : -1;
    const unsigned match = __ballot_sync(0xffffffffu, id == p);
    const int total = __popc(match);
    if (first && tid == 0) counts[p] = total;
    if (warp == 0) {
      if ((match >> lane) & 1u) {
        const int rank = __popc(match & below);
        if (rank >= r0 && rank < r1) dest[lane] = p * C + rank;
        else if (last && rank >= C) dest[lane] = -1;
      } else if (writes_invalid && lane < T && !valid_id(id, P)) {
        dest[lane] = -1;
      }
    }
    move_rows<V>(payloads, group, rv, out, tid / lanes, nrows, kThreads / lanes, tid & (lanes - 1),
                 lanes, [&](long long i) {
                   const int rank = r0 + (int)i;  // its tuple: the rank-th set bit of match
                   if (rank >= total) return -1;
                   unsigned m = match;
                   for (int k = 0; k < rank; ++k) m &= m - 1;
                   return __ffs(m) - 1;
                 });
    return;
  }
  for (int i = tid; i < nrows; i += kThreads) inv[i] = -1;

  // rank the tuples of partition p; a rank >= T is never reached, so a block
  // whose rows start there owns only zero rows (and, being past the first,
  // neither counts[p] nor a dropped tuple: the rank would be >= C > r0 >= T)
  int run = 0;  // tuples of p before the current tile: the same in every thread
  if (r0 < T) {
    int id[kRounds];
    load_tile(ids, T, 0, id);
    for (int base = 0; base < T; base += kTile) {
      if (stops_early && run >= r1) break;  // block-uniform
      unsigned match[kRounds];
#pragma unroll
      for (int j = 0; j < kRounds; ++j) match[j] = __ballot_sync(0xffffffffu, id[j] == p);
      int next[kRounds];
      load_tile(ids, T, base + kTile, next);  // in flight while this tile ranks
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kRounds; ++j) warp_count[j * kWarps + warp] = __popc(match[j]);
      }
      __syncthreads();
      if (warp == 0) {  // exclusive scan of the 64 counts in (round, warp) order
        const int a = warp_count[2 * lane], b = warp_count[2 * lane + 1];
        int incl = a + b;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int x = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += x;
        }
        const int excl = run + incl - a - b;
        warp_offset[2 * lane] = excl;
        warp_offset[2 * lane + 1] = excl + a;
        if (lane == 31) tile_total = incl;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        const int t = base + j * kThreads + tid;
        if ((match[j] >> lane) & 1u) {
          const int rank = warp_offset[j * kWarps + warp] + __popc(match[j] & below);
          if (rank >= r0 && rank < r1) {
            inv[rank - r0] = t;
            dest[t] = p * C + rank;
          } else if (last && rank >= C) {
            dest[t] = -1;  // dropped past the capacity
          }
        } else if (writes_invalid && t < T && !valid_id(id[j], P)) {
          dest[t] = -1;
        }
      }
      // no third barrier: the next tile's warp 0 writes warp_offset and
      // tile_total only after its first barrier, which every thread reaches
      // after its reads here
      run += tile_total;
#pragma unroll
      for (int j = 0; j < kRounds; ++j) id[j] = next[j];
    }
  }
  if (first && tid == 0) counts[p] = run;
  __syncthreads();

  move_rows<V>(payloads, group, rv, out, tid / lanes, nrows, kThreads / lanes, tid & (lanes - 1),
               lanes, [&](long long i) { return inv[i]; });
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

struct Call {
  const int* ids;
  int T;
  const void* payloads;
  int group;
  long long row_bytes;
  int P, C;
  void* buffers;
  int* counts;
  int* dest;
  cudaStream_t stream;
};

template <typename V>
int launch_one(const Call& c) {
  // splits of each partition's rows: about kBlocksPerSm blocks an SM in all
  const int target = kBlocksPerSm * sm_count();
  int splits = (target + c.P - 1) / c.P;
  if (splits > c.C) splits = c.C;
  int per_block = (c.C + splits - 1) / splits;
  if (per_block > kMaxRowsPerBlock) per_block = kMaxRowsPerBlock;
  splits = (c.C + per_block - 1) / per_block;
  const long long rv = c.row_bytes / (long long)sizeof(V);
  dispatch_one_kernel<V><<<(unsigned)((long long)c.P * splits), kThreads, 0, c.stream>>>(
      c.ids, c.T, static_cast<const V*>(c.payloads), c.group, rv, c.P, c.C, splits, per_block,
      static_cast<V*>(c.buffers), c.counts, c.dest);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dispatch_launches_per_call() { return 1; }
extern "C" int dispatch_max_partitions() { return kMaxPartitions; }

// One dispatch on `stream` in one launch: ids (T,) int32, payloads
// (T / group, row_bytes) -> buffers (P*C, row_bytes), counts (P,) int32,
// dest (T,) int32.  Returns a cudaError_t (cudaErrorInvalidValue for what
// the kernel does not take).  Does not synchronise.
extern "C" int dispatch_launch(const void* ids, int T, const void* payloads, int group,
                               long long row_bytes, int P, int C, void* buffers, void* counts,
                               void* dest, void* stream) {
  if (T < 1 || P < 1 || P > kMaxPartitions || C < 1 || row_bytes < 1 || group < 1 ||
      T % group != 0 || (long long)P * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Call c{static_cast<const int*>(ids), T, payloads, group, row_bytes, P, C, buffers,
               static_cast<int*>(counts), static_cast<int*>(dest), (cudaStream_t)stream};
  const uintptr_t align = (uintptr_t)payloads | (uintptr_t)buffers | (uintptr_t)row_bytes;
  return rows::with_vector(align, [&](auto v) { return launch_one<decltype(v)>(c); });
}
