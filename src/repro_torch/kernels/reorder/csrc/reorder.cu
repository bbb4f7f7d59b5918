// K2: the batched reorder-commit of the paper's non-blocking reorder buffer
// (section 3, fig. 4): K completed (serial, payload) pairs go into the ring,
// and the contiguous run of present slots from `next` is emitted in serial
// order.
//
// Replaces src/repro/kernels/reorder/reorder.py:27 (_commit_kernel;
// pallas_call at :110).  The TPU has no fast random access, so the Pallas
// kernel writes the scatter as an (S,K) one-hot matmul and the drain as an
// (S,S) rotation matmul on the MXU.  Here one launch does the whole commit,
// with no grid-wide barrier.  It rests on one fact: the present run after
// the scatter is known without waiting for the scatter's row writes.  The
// slot at ring distance d from `next` is present after the scatter if and
// only if it was present before, or the batch holds serial next + d inside
// the window ("fresh").  So:
//   1. count: every block computes it itself.  It walks the distances in
//      tiles of kTile; for each tile it loads its old present flags, sets
//      the fresh distances in a bitmap in shared memory (the K serials come
//      from L2; both loads are in flight together), ORs the two, and takes
//      the first gap with a block reduction.  It stops at the first tile
//      with a gap: a typical commit reads one tile.  Block 0 writes count
//      and next + count.
//   2. scatter: the grid-stride threads own the accepted entries.  Entry k
//      writes its row into slot t % S, its accepted flag, the slot's final
//      present flag (d >= count), and, if d < count, emitted row d straight
//      from the payload.
//   3. emit: block b owns a contiguous range of emitted rows.  A row i <
//      count that is not fresh copies the ring's row (that slot was present
//      before, and no entry of this batch writes it); a row >= count is
//      zeroed (most of the bytes).  A fresh row is the scatter's.  The fresh
//      bits of the rows come from the count's bitmap where it holds them.
//   4. clear: the slots at distances below count must end absent, but every
//      block reads the old present flags for its count.  So each block takes
//      a ticket (atomicInc on a per-device counter that wraps back to 0) as
//      soon as it has read them, waits for it only at its end, and the
//      block that took the last ticket clears the slots.  Fresh slots below
//      count are written 0 by the scatter as well: the same value.
// Each step waits on loads from L2 or device memory, so the design keeps
// them few and in flight together: on the card the commit is bound by that
// chain of latencies as much as by its bytes.
// A serial sent again while its slot is present is fresh: the slot and the
// emitted row take the new payload, as in the reference.  `next` and `count`
// stay on the device: nothing is read back to the host, and the ring (buf,
// present) is updated in place.
//
// Bound: device-memory bytes.  The contract returns the whole (S,W)
// `emitted`, so a commit writes S*W values however few rows are ready; the
// rest (K payload rows in, accepted rows into the ring, count rows out of
// it, the present flags of the run) is small beside it.  Each block's count
// rereads the serials and one tile of flags from L2.  Rows are moved as raw
// bytes in the widest vector that divides the row and the pointers
// (csrc/rows.cuh).
//
// The arithmetic on serials is int32 with wraparound, as the reference's
// (jnp int32): sums go through unsigned ints, and the reference's ring
// distance of slot i is floor_mod(i - next, S), its emitted row i reads slot
// floor_mod(next + i, S), both wrapped.  Where neither wraps, the slot at
// distance d is (next + d) mod S in 64-bit arithmetic.  Where next + i
// wraps for an emitted row, next + S has wrapped too and the batch accepts
// nothing, so that row reads the wrapped slot as the reference does.  Where
// i - next wraps (next within S of INT_MIN; then, with S <= 2^30, nothing is
// accepted either), the count and the clear scan every slot with the
// reference's formula.  Two equal serials in one batch are outside the
// contract: the reference keeps one of them, the Pallas kernel sums them,
// and here one of the two racing copies lands.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "../../csrc/rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kThreads;  // ring distances per step of the count walk
constexpr int kVectorsPerThread = 8;  // emitted vectors per thread, for the grid size
constexpr int kMaxBlocks = 132 * 8;
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int floor_mod(int d, int s) { return ((d % s) + s) % s; }

// The reference's ring distance of slot i.
__device__ __forceinline__ int ref_pos(int i, int nxt, int S) {
  return floor_mod((int)((unsigned)i - (unsigned)nxt), S);
}

struct Commit {
  const int* serials;
  int K;
  const unsigned char* payloads;
  unsigned char* buf;
  unsigned char* present;
  const int* next;
  int S;
  long long rv;  // vectors per row
  unsigned char* accepted;
  unsigned char* emitted;
  int* count_out;
  int* next_out;
  unsigned* ticket;
  int rows_per_block;
};

// Ring distance of serial t from nxt if the entry condition (fig. 4 L16)
// accepts it, else -1.
__device__ __forceinline__ long long accepted_dist(int t, int nxt, int hi) {
  return (t >= 0 && t >= nxt && t < hi) ? (long long)t - nxt : -1;
}

// bits[j] = 1 for every accepted serial at distance d0 + j, j < kTile.
// The first serial of each thread is loaded before the barrier.
__device__ void fresh_bitmap(const Commit& c, int nxt, int hi, long long d0, unsigned* bits) {
  const int first = threadIdx.x < c.K ? c.serials[threadIdx.x] : -1;
  for (int j = threadIdx.x; j < kTile / 32; j += kThreads) bits[j] = 0;
  __syncthreads();
  auto mark = [&](int t) {
    const long long d = accepted_dist(t, nxt, hi) - d0;
    if (d >= 0 && d < kTile) atomicOr(&bits[d >> 5], 1u << (d & 31));
  };
  mark(first);
  for (int k = threadIdx.x + kThreads; k < c.K; k += kThreads) mark(c.serials[k]);
  __syncthreads();
}

__device__ __forceinline__ bool bit(const unsigned* bits, long long j) {
  return (bits[j >> 5] >> (j & 31)) & 1u;
}

__device__ int block_min(int m, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = m;
  __syncthreads();
  m = kNone;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = min(m, scratch[w]);
  __syncthreads();  // scratch is reused
  return m;
}

// Calls f(row, col) for every vector of `rows` rows of rv vectors, spread
// over the block's threads; 32-bit indices where they fit.
template <typename F>
__device__ __forceinline__ void for_vectors(long long rows, long long rv, F&& f) {
  const long long total = rows * rv;
  if (total < (1LL << 31)) {
    const unsigned r = (unsigned)rv;
    for (unsigned v = threadIdx.x; v < (unsigned)total; v += kThreads) f(v / r, v % r);
  } else {
    for (long long v = threadIdx.x; v < total; v += kThreads) f(v / rv, v % rv);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) commit_kernel(Commit c) {
  __shared__ unsigned bits[kTile / 32];
  __shared__ int scratch[kWarps];
  const int S = c.S;
  const int nxt = *c.next;
  const int hi = wrap_add(nxt, S);
  const long long n64 = nxt;
  // i - next does not wrap for any slot: distances map to slots one to one
  const bool regular = n64 >= (long long)S - 1 - 0x7fffffffLL;
  const int base = regular ? (int)(((n64 % S) + S) % S) : 0;  // slot of distance 0

  // ---- 1. count: the first gap of the present run from `next`
  int count = S;
  long long bits_d0 = -1;  // the distance of bits[0], while bits holds a tile
  if (regular) {
    for (long long d0 = 0; d0 < S; d0 += kTile) {
      // this thread's old flags of the tile, loaded while the bitmap is built
      bool old[kTile / kThreads];
      const int slot = (int)((base + d0) % S);
#pragma unroll
      for (int q = 0; q < kTile / kThreads; ++q) {
        const int j = threadIdx.x + q * kThreads;
        int s = slot + j;  // < 2S where d0 + j < S, since then j < S
        if (s >= S) s -= S;
        old[q] = d0 + j >= S || c.present[s];
      }
      fresh_bitmap(c, nxt, hi, d0, bits);
      int m = kNone;
#pragma unroll
      for (int q = 0; q < kTile / kThreads; ++q) {
        const int j = threadIdx.x + q * kThreads;
        if (!old[q] && !bit(bits, j)) m = min(m, j);
      }
      m = block_min(m, scratch);
      bits_d0 = d0;
      if (m != kNone) {
        count = (int)(d0 + m);
        break;
      }
    }
  } else {  // nothing is accepted (S <= 2^30); the reference's formula, slot by slot
    int m = S;
    for (int i = threadIdx.x; i < S; i += kThreads)
      if (!c.present[i]) m = min(m, ref_pos(i, nxt, S));
    count = block_min(m, scratch);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *c.count_out = count;
    *c.next_out = wrap_add(nxt, count);
  }
  // the block that reads the old flags last clears the run's slots (step
  // 4); thread 0 waits for its ticket only there
  unsigned ticket = 0;
  if (threadIdx.x == 0 && count > 0) ticket = atomicInc(c.ticket, gridDim.x - 1);

  const V* pay = reinterpret_cast<const V*>(c.payloads);
  V* buf = reinterpret_cast<V*>(c.buf);
  V* em = reinterpret_cast<V*>(c.emitted);
  const long long rv = c.rv;

  // ---- 2. scatter: the accepted entries, over the whole grid
  const long long total = (long long)c.K * rv;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < total;
       v += (long long)gridDim.x * kThreads) {
    const long long k = v / rv, col = v - k * rv;
    const long long d = accepted_dist(c.serials[k], nxt, hi);
    if (d >= 0) {
      int slot = base + (int)d;
      if (slot >= S) slot -= S;
      const V x = pay[v];
      buf[(long long)slot * rv + col] = x;
      if (d < count) em[d * rv + col] = x;
      if (col == 0) c.present[slot] = d >= count;
    }
    if (col == 0) c.accepted[k] = d >= 0;
  }

  // ---- 3. emit: this block's rows of `emitted`
  const long long r0 = (long long)blockIdx.x * c.rows_per_block;
  const long long r1 = min((long long)S, r0 + c.rows_per_block);
  for (long long t0 = r0; t0 < r1; t0 += kTile) {
    const long long rows = min((long long)kTile, r1 - t0);
    if (t0 < count) {
      // the fresh bits of rows t0.., from the count walk's last tile if it
      // holds them all
      const long long off = t0 - bits_d0;
      const bool held = bits_d0 >= 0 && off >= 0 && off + rows <= kTile;
      if (!held) fresh_bitmap(c, nxt, hi, t0, bits);
      const long long b0 = held ? off : 0;
      for_vectors(rows, rv, [&](long long j, long long col) {
        const long long i = t0 + j;
        if (i >= count) {
          em[i * rv + col] = V{};
        } else if (!bit(bits, b0 + j)) {
          const int src = floor_mod(wrap_add(nxt, (int)i), S);  // as the reference
          em[i * rv + col] = buf[(long long)src * rv + col];
        }
      });
      __syncthreads();  // bits is rebuilt for the next tile
      bits_d0 = -1;
    } else {
      V* out = em + t0 * rv;
      for_vectors(rows, rv, [&](long long j, long long col) { out[j * rv + col] = V{}; });
    }
  }

  // ---- 4. clear: the slots below count, once every block has read the old
  // flags (the ticket above)
  __shared__ bool last;
  if (threadIdx.x == 0) last = count > 0 && ticket == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  if (regular) {
    for (int d = threadIdx.x; d < count; d += kThreads) {
      int s = base + d;
      if (s >= S) s -= S;
      c.present[s] = 0;
    }
  } else {
    for (int i = threadIdx.x; i < S; i += kThreads)
      if (ref_pos(i, nxt, S) < count) c.present[i] = 0;
  }
}

template <typename V>
int launch(Commit c, long long row_bytes, cudaStream_t stream) {
  c.rv = row_bytes / (long long)sizeof(V);
  // rows per block: about kVectorsPerThread vectors a thread, at most
  // kMaxBlocks blocks
  long long rpb = ((long long)kThreads * kVectorsPerThread + c.rv - 1) / c.rv;
  rpb = std::max(rpb, ((long long)c.S + kMaxBlocks - 1) / kMaxBlocks);
  rpb = std::min(rpb, (long long)c.S);
  c.rows_per_block = (int)rpb;
  const unsigned grid = (unsigned)(((long long)c.S + rpb - 1) / rpb);
  commit_kernel<V><<<grid, kThreads, 0, stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch count per commit, for the wrapper's LAUNCHES counter.
extern "C" int commit_launches_per_call() { return 1; }

// Largest ring the kernel takes (the wrapped cases above rely on it).
extern "C" int commit_max_slots() { return 1 << 30; }

// One reorder-commit on `stream`: serials (K,) int32, payloads (K, row_bytes),
// the ring buf (S, row_bytes) and present (S,) uint8 (updated in place), next
// () int32; writes accepted (K,) uint8, emitted (S, row_bytes), count () and
// next_out () int32.  `ticket` is a device counter that is 0 between
// commits (the kernel leaves it so); launches that share it must not run at
// the same time.  Returns a cudaError_t (cudaErrorInvalidValue for sizes the
// kernel does not take).  Does not synchronise.
extern "C" int commit_launch(const void* serials, int K, const void* payloads, void* buf,
                             void* present, const void* next, int S, long long row_bytes,
                             void* accepted, void* emitted, void* count_out,
                             void* next_out, void* ticket, void* stream) {
  if (K < 0 || S < 1 || S > commit_max_slots() || row_bytes < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t align =
      (uintptr_t)payloads | (uintptr_t)buf | (uintptr_t)emitted | (uintptr_t)row_bytes;
  Commit c;
  c.serials = static_cast<const int*>(serials);
  c.K = K;
  c.payloads = static_cast<const unsigned char*>(payloads);
  c.buf = static_cast<unsigned char*>(buf);
  c.present = static_cast<unsigned char*>(present);
  c.next = static_cast<const int*>(next);
  c.S = S;
  c.accepted = static_cast<unsigned char*>(accepted);
  c.emitted = static_cast<unsigned char*>(emitted);
  c.count_out = static_cast<int*>(count_out);
  c.next_out = static_cast<int*>(next_out);
  c.ticket = static_cast<unsigned*>(ticket);
  auto s = static_cast<cudaStream_t>(stream);
  return rows::with_vector(align, [&](auto v) { return launch<decltype(v)>(c, row_bytes, s); });
}
