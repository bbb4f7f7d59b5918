// K5: the Mamba2 SSD chunked scan [arXiv:2405.21060], from a zero state.
//
// Replaces src/repro/kernels/ssd/ssd.py:24 (_ssd_kernel; pallas_call at :98).
// The TPU runs the grid (B, H, chunks) in order on one core and carries the
// (P,N) state from chunk to chunk in VMEM scratch.  Here one block per
// (b, h) runs the chunks in a loop and keeps the fp32 state in shared memory.
// For each chunk of cl rows:
//   cum   = cumsum(dt * A)                            (one warp scans it)
//   y     = (Lmask o (C B^T)) (dt x) + exp(cum) o (C state^T)
//           with Lmask[q,k] = exp(cum_q - cum_k) for k <= q, else 0
//   state = exp(total) state + (dt exp(total - cum) x)^T B
// A whole chunk does not fit: at cl = 256 and N = 128 one (cl,N) f32 tile of
// B or C is 128 KB, the (cl,cl) decay matrix 256 KB and the state 64 KB.  So
// y is computed one 64-row query tile at a time, flash-style: the query
// tile's C rows stay in shared memory while 64-row key tiles of B and dt*x
// stream through (key tiles past the query tile are skipped, as the mask
// zeroes them), the masked score tile goes through shared memory, and the
// y tile accumulates in registers; then C state^T is added.  The state is
// updated after every query tile of the chunk has read it, streaming the
// key tiles once more.  Each thread owns a 4 x (P/16) tile of y, a 4 x 4
// tile of scores and a (P/16) x (N/16) tile of the state; shared rows are
// padded by one float so that the 16 column threads hit 16 banks.
//
// Bound: operations, on the CUDA cores in f32.  The function needs C B^T
// once per (b, chunk) over the causal pairs, cl (cl+1)/2 of N each; per
// (b, h, chunk) the masked product with dt x over those pairs (P each), the
// state update (cl P N), and C state^T (cl P N) past the first chunk: about
// 4.7 GFLOP at mamba2-780m (H = 48, P = 64, N = 128, cl = 256, L = 2048),
// against 52 MB of inputs and outputs.  This kernel does more: like the TPU
// kernel it recomputes C B^T per head, and it computes whole 64 x 64
// diagonal tiles.
// The tensor cores are not used: TF32 keeps about three decimal digits and
// the scan is held to the f32 reference within 2e-4.  Only B*H blocks run
// (48 at mamba2-780m on 132 SMs); splitting the chunks across blocks (a
// chunk-state pass, a scan over chunks, then the outputs) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query and key rows per tile
constexpr int kMaxChunk = 512;
constexpr int kScoreStride = kTile + 1;

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int P, int N>
struct Smem {
  static constexpr int kState = P * (N + 1);
  static constexpr int kC = kTile * (N + 1);
  static constexpr int kB = kTile * (N + 1);
  static constexpr int kX = kTile * (P + 1);
  static constexpr int kS = kTile * kScoreStride;
  static constexpr int kFloats = kState + kC + kB + kX + kS + 2 * kMaxChunk;
  static constexpr int kBytes = kFloats * 4;
};

template <int P, int N, typename XT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const XT* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ Bm, const float* __restrict__ Cm, XT* __restrict__ y,
           float* __restrict__ hT, int L, int H, int cl) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  constexpr int PJ = P / 16, NJ = N / 16, PI = P / 16;
  using S = Smem<P, N>;
  extern __shared__ float smem[];
  float* sState = smem;               // [P][N+1]
  float* sC = sState + S::kState;     // [kTile][N+1]
  float* sB = sC + S::kC;             // [kTile][N+1]
  float* sX = sB + S::kB;             // [kTile][P+1]
  float* sS = sX + S::kX;             // [kTile][kTile+1]
  float* sCum = sS + S::kS;           // [kMaxChunk]
  float* sDt = sCum + kMaxChunk;      // [kMaxChunk]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const long long row0 = (long long)b * L;  // first (b, l) row

  for (int i = tid; i < S::kState; i += kThreads) sState[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += cl) {
    // ---- dt and the cumulative log-decay of this chunk
    for (int q = tid; q < cl; q += kThreads) {
      const float d = dt[(row0 + c0 + q) * H + h];
      sDt[q] = d;
      sCum[q] = d * a;
    }
    __syncthreads();
    if (warp == 0) {  // each lane scans a segment, then the lanes' totals
      const int seg = (cl + 31) / 32, lo = lane * seg, hi = min(lo + seg, cl);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += sCum[i];
        sCum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float off = incl - run;
      for (int i = lo; i < hi; ++i) sCum[i] += off;
    }
    __syncthreads();
    const float total = sCum[cl - 1];

    // ---- y, one query tile at a time
    for (int q0 = 0; q0 < cl; q0 += kTile) {
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        sC[r * (N + 1) + n] = q0 + r < cl ? Cm[(row0 + c0 + q0 + r) * N + n] : 0.f;
      }
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 <= q0; k0 += kTile) {
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          sB[r * (N + 1) + n] = k0 + r < cl ? Bm[(row0 + c0 + k0 + r) * N + n] : 0.f;
        }
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int r = i / P, p = i - r * P;
          const int k = k0 + r;
          sX[r * (P + 1) + p] =
              k < cl ? sDt[k] * load_x(x + ((row0 + c0 + k) * H + h) * P + p) : 0.f;
        }
        __syncthreads();
        // masked, decayed scores of this (query, key) tile
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cq[4], bk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cq[i] = sC[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bk[j] = sB[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cq[i], bk[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            const bool live = k <= q && q < cl;
            sS[(ty + 16 * i) * kScoreStride + tx + 16 * j] =
                live ? s[i][j] * expf(sCum[q] - sCum[k]) : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kTile; ++k) {
          float sv[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = sS[(ty + 16 * i) * kScoreStride + k];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = sX[k * (P + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
        __syncthreads();  // sB, sX and sS are refilled next
      }

      // inter-chunk term from the state before this chunk
      float t[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) t[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cq[4], st[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cq[i] = sC[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) st[j] = sState[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) t[i][j] = fmaf(cq[i], st[j], t[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q < cl) {
          const float e = expf(sCum[q]);
          XT* out = y + ((row0 + c0 + q) * H + h) * P;
#pragma unroll
          for (int j = 0; j < PJ; ++j) store_y(out + tx + 16 * j, acc[i][j] + e * t[i][j]);
        }
      }
      __syncthreads();  // sC is refilled next
    }

    // ---- state update: exp(total) state + (dt exp(total - cum) x)^T B
    float st[PI][NJ];
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) st[i][j] = decay * sState[(ty + 16 * i) * (N + 1) + tx + 16 * j];
    for (int k0 = 0; k0 < cl; k0 += kTile) {
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        sB[r * (N + 1) + n] = k0 + r < cl ? Bm[(row0 + c0 + k0 + r) * N + n] : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        const int k = k0 + r;
        sX[r * (P + 1) + p] =
            k < cl ? sDt[k] * expf(total - sCum[k]) *
                         load_x(x + ((row0 + c0 + k) * H + h) * P + p)
                   : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float xv[PI], bv[NJ];
#pragma unroll
        for (int i = 0; i < PI; ++i) xv[i] = sX[k * (P + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = sB[k * (N + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) st[i][j] = fmaf(xv[i], bv[j], st[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sState[(ty + 16 * i) * (N + 1) + tx + 16 * j] = st[i][j];
    __syncthreads();
  }

  float* out = hT + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    out[i] = sState[p * (N + 1) + n];
  }
}

template <int P, int N, typename XT>
int launch(const void* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           void* y, float* hT, int Bsz, int L, int H, int cl, cudaStream_t stream) {
  constexpr int bytes = Smem<P, N>::kBytes;
  static bool attr_set = false;  // set once, outside any graph capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<P, N, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)H, (unsigned)Bsz);
  ssd_kernel<P, N, XT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const XT*>(x), dt, A, Bm, Cm, static_cast<XT*>(y), hT, L, H, cl);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_xt(const void* x, const float* dt, const float* A, const float* Bm, const float* Cm,
              void* y, float* hT, int Bsz, int L, int H, int P, int N, int cl,
              cudaStream_t s) {
  if (P == 64 && N == 64) return launch<64, 64, XT>(x, dt, A, Bm, Cm, y, hT, Bsz, L, H, cl, s);
  if (P == 64 && N == 128) return launch<64, 128, XT>(x, dt, A, Bm, Cm, y, hT, Bsz, L, H, cl, s);
  if (P == 128 && N == 64) return launch<128, 64, XT>(x, dt, A, Bm, Cm, y, hT, Bsz, L, H, cl, s);
  if (P == 128 && N == 128)
    return launch<128, 128, XT>(x, dt, A, Bm, Cm, y, hT, Bsz, L, H, cl, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_max_chunk() { return kMaxChunk; }

// The SSD scan on `stream`: x (B,L,H,P) f32 (x_bf16 = 0) or bf16 (1), dt
// (B,L,H), A (H,), Bm and Cm (B,L,N) f32 -> y (B,L,H,P) in x's type and hT
// (B,H,P,N) f32.  Takes P and N in {64, 128}, 1 <= cl <= 512 dividing L.
// Returns a cudaError_t (cudaErrorInvalidValue for shapes it does not take).
// Does not synchronise.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, void* y, void* hT, int Bsz, int L, int H, int P,
                          int N, int cl, int x_bf16, void* stream) {
  if (Bsz < 1 || Bsz > 65535 || H < 1 || cl < 1 || cl > kMaxChunk || L < cl || L % cl != 0)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = (cudaStream_t)stream;
  float* h = static_cast<float*>(hT);
  if (x_bf16)
    return launch_xt<__nv_bfloat16>(x, f(dt), f(A), f(Bm), f(Cm), y, h, Bsz, L, H, P, N, cl, s);
  return launch_xt<float>(x, f(dt), f(A), f(Bm), f(Cm), y, h, Bsz, L, H, P, N, cl, s);
}
