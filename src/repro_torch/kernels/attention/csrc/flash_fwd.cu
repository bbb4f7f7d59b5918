// K4 on Hopper: causal / non-causal GQA flash-attention forward.
//
// Replaces: src/repro/kernels/attention/flash.py::_flash_kernel, the Pallas
// TPU kernel launched by flash_attention there.  Same function: q (B,S,H,Dh),
// k/v (B,S,Hkv,Dh), kv head h / (H/Hkv), scale 1/sqrt(Dh), online softmax
// with fp32 running max / denominator / accumulator, output in q's dtype.
// Unlike the TPU wrapper it takes any S >= 1: the tail tiles of q and of k/v
// are masked here.
//
// What bounds it on an H100: it must read q, k, v once and write o once,
// 4*B*S*H*Dh*itemsize bytes when Hkv == H, and it does about 2*B*H*S^2*Dh
// FLOPs when causal (QK^T and PV over the causal half; twice that when not).
// At the served olmo-1b shapes (B=1, H=16, Dh=128, S <= 512, bf16) that is at
// most 8.4 MB (2.5 us at 3.35 TB/s) against 1.1 GFLOP (1.1 us at 989 TFLOP/s
// on the bf16 tensor cores): the card bounds it by bytes.
//
// Two kernels behind one C entry, chosen by dtype:
//
// bf16, on the tensor cores (namespace tc).  One block per (64-row q tile,
// head, batch), the heaviest causal tiles first.  A producer warp loads the
// q tile once and streams the K/V tiles of its causal prefix (64 keys each)
// through a five-stage ring in shared memory with TMA, each stage guarded
// by mbarriers (full: the bytes landed; empty: its consumer is done).  Two
// consumer warpgroups share the 64 query rows and split the key tiles (even
// and odd), so the heaviest causal block walks half its prefix on each, and
// the two interleave on the SM's schedulers.  Each computes S = Q K^T with
// wgmma from shared memory, the online softmax in fp32 registers (scale
// folded into exp2 on the fp32 scores; row max over the 4 threads of a
// quad) while its previous tile's P V runs on the tensor cores, rounds P to
// bf16 in the A-operand register layout and accumulates O += P V with wgmma
// (V as the transposed, MN-major operand).  Warpgroup 1 hands its max,
// denominators and O to warpgroup 0 through shared memory, which merges
// them and stores o.  Only the last key tile is masked (the causal diagonal
// and the ragged end); tiles past the diagonal are never loaded.  q, k and
// v are described to TMA as 4-D (Dh, H, S, B) tensors, so a box past the
// end of S reads zeros, never the next batch; o is stored with row-masked
// stores.  Device memory is read about once (later q tiles of a head
// re-read K/V from L2) and the scores never leave registers.  One warp
// issuing both products and the softmax in turn was latency-bound (about
// 1.3 us per key tile against 0.28 us of tensor-core work); the split and
// the overlap are what brought S=512 below SDPA's time.
//
// f32, on the CUDA cores (namespace cores): the first version of K4, kept
// for float32, whose 2e-5 tolerance TF32 wgmma would miss.  One block per
// (32-row q tile, head, batch), 4 warps x 8 query rows; for each 32-key tile
// a lane owns one key and 1/32 of the head dim of each row's accumulator;
// the weights of key j reach the other lanes by shuffle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "../../csrc/sm90.cuh"

namespace {

// cudaFuncSetAttribute for `kern` once per device, not at every launch.
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// ================================================================ f32: CUDA cores
namespace cores {

constexpr int BQ = 32;  // query rows per block
constexpr int BK = 32;  // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int ROWS = BQ / NWARPS;  // query rows per warp
constexpr float NEG = -1e30f;      // masked score, as in the TPU kernel

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  // q tile [BQ][DH], k tile [BK][DH+1] (padded: lanes reading one column of
  // different keys hit different banks), v tile [BK][DH]
  return sizeof(float) * (BQ * DH + BK * (DH + 1) + BK * DH);
}

template <int DH>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, int H,
                     int Hkv, int causal, float scale) {
  constexpr int KS = DH + 1;
  constexpr int DPL = DH / 32;  // accumulator dims per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + BQ * DH;
  float* v_s = k_s + BK * KS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = h / (H / Hkv);
  const long q_stride = (long)H * DH;     // between positions of q and o
  const long kv_stride = (long)Hkv * DH;  // between positions of k and v
  const float* qb = q + (long)b * S * q_stride + (long)h * DH;
  const float* kb = k + (long)b * S * kv_stride + (long)hkv * DH;
  const float* vb = v + (long)b * S * kv_stride + (long)hkv * DH;

  // q tile, scaled in fp32; rows past S are zeros and are never stored
  for (int i = tid; i < BQ * DH; i += NWARPS * 32) {
    const int r = i / DH, d = i % DH, s = q0 + r;
    q_s[i] = s < S ? qb[s * q_stride + d] * scale : 0.f;
  }

  const int row0 = warp * ROWS;  // this warp's first row inside the tile
  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;  // per-lane partial denominator, reduced once at the end
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int i = tid; i < BK * DH; i += NWARPS * 32) {
      const int j = i / DH, d = i % DH, s = k0 + j;
      const bool in = s < S;
      k_s[j * KS + d] = in ? kb[s * kv_stride + d] : 0.f;
      v_s[j * DH + d] = in ? vb[s * kv_stride + d] : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float sc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r] = 0.f;
    const float* krow = k_s + lane * KS;
    const float4* q4 = reinterpret_cast<const float4*>(q_s + row0 * DH);
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float k_0 = krow[4 * d4], k_1 = krow[4 * d4 + 1];
      const float k_2 = krow[4 * d4 + 2], k_3 = krow[4 * d4 + 3];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = q4[r * (DH / 4) + d4];  // same address in all lanes
        sc[r] = fmaf(qq.x, k_0, sc[r]);
        sc[r] = fmaf(qq.y, k_1, sc[r]);
        sc[r] = fmaf(qq.z, k_2, sc[r]);
        sc[r] = fmaf(qq.w, k_3, sc[r]);
      }
    }

    // online softmax: m is warp-uniform, so every lane rescales alike
    const int key = k0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + row0 + r;
      const bool valid = key < S && (!causal || key <= qpos);
      const float s = valid ? sc[r] : NEG;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      p[r] = valid ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + p[r];
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }

    // acc += P V; the weight of key j lives in lane j
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vj[c] = v_s[j * DH + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-20f);
    const int qpos = q0 + row0 + r;
    if (qpos < S) {
      float* orow = o + ((long)b * S + qpos) * q_stride + (long)h * DH;
#pragma unroll
      for (int c = 0; c < DPL; ++c) orow[lane + 32 * c] = acc[r][c] / denom;
    }
  }
}


template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int Hkv, int causal, cudaStream_t stream) {
  constexpr int smem = (int)smem_bytes<DH>();
  static std::atomic<unsigned> ready{0};
  auto kern = flash_fwd_kernel<DH>;
  cudaError_t err = allow_smem(kern, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, Hkv, causal, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace cores

// ================================================================ bf16: tensor cores
namespace tc {

constexpr int BM = 64;      // query rows per block: the m64 of one consumer warpgroup
constexpr int BN = 64;      // keys per K/V tile
constexpr int STAGES = 5;   // depth of the K/V ring
constexpr int kWarpgroups = 2;  // consumer warpgroups; each takes every other key tile
constexpr int BOX = 64;     // bf16 columns per TMA box: 128 bytes, the swizzled row
constexpr int kConsumers = 128;                          // threads of one warpgroup
constexpr int kThreads = kWarpgroups * kConsumers + 32;  // and one producer warp
constexpr int kBoxBytes = 64 * BOX * 2;     // a box of 64 rows: 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// A tile of 64 rows x DH is DH/64 boxes of [64][64] bf16, each 1024-aligned.
template <int DH>
struct Smem {
  __nv_bfloat16 q[DH / BOX][BM * BOX];
  __nv_bfloat16 k[STAGES][DH / BOX][BN * BOX];
  __nv_bfloat16 v[STAGES][DH / BOX][BN * BOX];
  // warpgroup 1's accumulator, max and denominators, handed to warpgroup 0
  float xch[DH / 2 + 4][kConsumers];
  uint64_t full_q;
  uint64_t full_k[STAGES], full_v[STAGES], empty[STAGES];
};

// + 1024: the kernel aligns the start of dynamic shared memory to 1024
template <int DH>
constexpr int smem_bytes() { return (int)sizeof(Smem<DH>) + 1024; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layout of a wgmma m64nN f32 accumulator, per thread: warp w of
// the warpgroup owns rows 16w..16w+15; for each 8-column chunk j, d[4j] and
// d[4j+1] are row 16w + lane/4, columns 8j + 2(lane%4) + {0,1}, and
// d[4j+2], d[4j+3] the same columns of the row 8 below.  The bf16 A operand
// of an m64k16 wgmma in registers has the same layout for its 16 columns, so
// chunks 2kk and 2kk+1 of the scores are, packed in pairs, the A fragment of
// key step kk: no data moves between threads.

// S = Q K^T for the K tile in stage s: 64 x 64, K-major operands, DH/16
// steps of 16 (a step moves 32 bytes inside the swizzled row; four steps
// fill a 64-column box).  Issued and committed as one group, not waited for.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[32], Smem<DH>& sm, int s) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint64_t da = sm90::desc_sw128(&sm.q[kk / 4][(kk % 4) * 16], 16, 1024);
    const uint64_t db = sm90::desc_sw128(&sm.k[s][kk / 4][(kk % 4) * 16], 16, 1024);
    sm90::wgmma_m64n64k16_ss(sc, da, db, kk > 0);
  }
  sm90::wgmma_commit();
}

// O += P V for the V tile in stage s: V is [key][Dh], the MN-major operand
// (its 64-wide boxes 8 KB apart); a step of 16 keys moves 2048 bytes.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2], const uint32_t (&pa)[4][4],
                                         Smem<DH>& sm, int s) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = sm90::desc_sw128(&sm.v[s][0][kk * 16 * BOX], kBoxBytes, 1024);
    if constexpr (DH == 128)
      sm90::wgmma_m64n128k16_rs_tb(acc, pa[kk], db, 1);
    else
      sm90::wgmma_m64n64k16_rs_tb(acc, pa[kk], db, 1);
  }
  sm90::wgmma_commit();
}

// Online softmax of one score tile in fp32: masks keys past S and (causal)
// past each row when `mask`, updates the running max m (log2 units) and this
// thread's share of the denominators l, returns the rescale factor of the
// accumulator in alpha, and packs p = 2^(s log2(e)/sqrt(Dh) - m), rounded to
// bf16 as the plain version rounds the weights to q's dtype, into the A
// fragments of P V.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[4][4], bool mask,
                                             int k0, int row0, int col0, int S, int causal,
                                             float scale_log2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + col0 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (key >= S || (causal && key > row)) sc[4 * j + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    // every row may see key k0 (k0 <= its position, k0 < S), so the new max
    // is finite and alpha is 0 at the first tile
    const float m_new = fmaxf(m[r], quad_max(mx) * scale_log2);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
      sc[4 * j + e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                    int H, int Hkv, int causal, float scale_log2) {
  constexpr int NB = DH / BOX;  // boxes per tile row
  extern __shared__ uint8_t smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = h / (H / Hkv);
  const int kv_end = causal ? min(S, q0 + BM) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(&sm.full_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&sm.full_k[s], 1);
      sm90::mbar_init(&sm.full_v[s], 1);
      sm90::mbar_init(&sm.empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kWarpgroups * kConsumers) {
    // ---------------------------------------------------------- producer warp
    if (tid == kWarpgroups * kConsumers) {
      sm90::prefetch_tensor_map(&tq);
      sm90::prefetch_tensor_map(&tk);
      sm90::prefetch_tensor_map(&tv);
      sm90::mbar_arrive_expect_tx(&sm.full_q, NB * kBoxBytes);
#pragma unroll
      for (int c = 0; c < NB; ++c) sm90::tma_load_4d(sm.q[c], &tq, &sm.full_q, c * BOX, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        sm90::mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);  // round 0 passes at once
        sm90::mbar_arrive_expect_tx(&sm.full_k[s], NB * kBoxBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          sm90::tma_load_4d(sm.k[s][c], &tk, &sm.full_k[s], c * BOX, hkv, t * BN, b);
        sm90::mbar_arrive_expect_tx(&sm.full_v[s], NB * kBoxBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          sm90::tma_load_4d(sm.v[s][c], &tv, &sm.full_v[s], c * BOX, hkv, t * BN, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumer warpgroups
  // Warpgroup wg takes key tiles wg, wg + kWarpgroups, ... of the same 64
  // query rows; warpgroup 0 merges the others' partial softmax at the end.
  const int wg = tid / kConsumers;
  const int warp = (tid % kConsumers) / 32, lane = tid % 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane % 4);             // and, in each 8-column chunk, col0 and col0 + 1

  float acc[DH / 2];  // O, 64 x DH
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (log2 units)
  float l[2] = {0.f, 0.f};              // this thread's share of the running denominators
  float alpha[2];
  float sc[32];                         // scores, then weights, of one key tile
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  uint32_t pa[4][4], pb[4][4];          // P of the tile in P V, and of the next

  // The softmax of tile t runs while the tensor cores compute P V of the
  // warpgroup's previous tile tp: each step issues S_t = Q K_t^T and then
  // O += P_tp V_tp, waits for S_t only, and rescales O once P V is done.
  sm90::mbar_wait(&sm.full_q, 0);
  if (wg < n_tiles) {
    sm90::mbar_wait(&sm.full_k[wg % STAGES], (wg / STAGES) & 1);
    sm90::wgmma_fence();
    issue_qk(sc, sm, wg % STAGES);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);
    softmax_tile(sc, m, l, alpha, pa, wg == n_tiles - 1, wg * BN, row0, col0, S, causal,
                 scale_log2);
    int tp = wg;
    for (int t = wg + kWarpgroups; t < n_tiles; tp = t, t += kWarpgroups) {
      const int s = t % STAGES, sp = tp % STAGES;
      sm90::mbar_wait(&sm.full_k[s], (t / STAGES) & 1);
      sm90::mbar_wait(&sm.full_v[sp], (tp / STAGES) & 1);
      sm90::wgmma_fence();
      issue_qk(sc, sm, s);
      issue_pv(acc, pa, sm, sp);
      sm90::wgmma_wait<1>();  // S_t is done; P V of tp may still run
      sm90::fence_operands(sc);
      softmax_tile(sc, m, l, alpha, pb, t == n_tiles - 1, t * BN, row0, col0, S, causal,
                   scale_log2);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      sm90::fence_operands(pa);
      sm90::mbar_arrive(&sm.empty[sp]);  // this stage's K and V may be overwritten
      rescale(acc, alpha);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pb[kk][i];
    }
    const int sp = tp % STAGES;
    sm90::mbar_wait(&sm.full_v[sp], (tp / STAGES) & 1);
    sm90::wgmma_fence();
    issue_pv(acc, pa, sm, sp);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    sm90::mbar_arrive(&sm.empty[sp]);
  }

  // merge: (m, l, O) = (max, l0 a0 + l1 a1, O0 a0 + O1 a1), a_i = 2^(m_i - max).
  // A thread of warpgroup 1 holds the same rows and columns as the thread
  // 128 below it; a warpgroup without tiles has m = -inf, l = 0, O = 0.
  static_assert(kWarpgroups == 2, "the merge takes two warpgroups");
  const int c = tid % kConsumers;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) sm.xch[i][c] = acc[i];
    sm.xch[DH / 2][c] = m[0], sm.xch[DH / 2 + 1][c] = m[1];
    sm.xch[DH / 2 + 2][c] = l[0], sm.xch[DH / 2 + 3][c] = l[1];
    sm90::named_barrier_arrive(1, 2 * kConsumers);
    return;
  }
  sm90::named_barrier_sync(1, 2 * kConsumers);
  float a0[2], a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = sm.xch[DH / 2 + r][c];
    const float mc = fmaxf(m[r], m1);  // finite: warpgroup 0 always has key tile 0
    a0[r] = exp2f(m[r] - mc);
    a1[r] = exp2f(m1 - mc);
    l[r] = l[r] * a0[r] + sm.xch[DH / 2 + 2 + r][c] * a1[r];
  }
#pragma unroll
  for (int i = 0; i < DH / 2; ++i)
    acc[i] = acc[i] * a0[(i >> 1) & 1] + sm.xch[i][c] * a1[(i >> 1) & 1];

  // o = acc / l in bf16; rows past S are not stored
  const long q_stride = (long)H * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float inv = 1.f / quad_sum(l[r]);
    if (row < S) {
      __nv_bfloat16* orow = o + ((long)b * S + row) * q_stride + (long)h * DH + col0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// q, k, v as 4-D (Dh, heads, S, B) maps, boxes of (64, 1, 64, 1)
inline cudaError_t encode_qkv(CUtensorMap* map, const void* base, int B, int S, int heads, int DH) {
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2, (cuuint64_t)heads * DH * 2,
                                 (cuuint64_t)S * heads * DH * 2};
  const cuuint32_t box[4] = {BOX, 1, BN, 1};
  return sm90::encode_bf16_sw128(map, base, 4, dims, strides, box);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int Hkv, int causal, cudaStream_t stream) {
  static_assert(BM == BN, "q and K/V tiles share one box shape");
  static std::atomic<unsigned> ready{0};
  auto kern = flash_fwd_wgmma<DH>;
  cudaError_t err = allow_smem(kern, smem_bytes<DH>(), ready);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = encode_qkv(&tq, q, B, S, H, DH)) != cudaSuccess) return err;
  if ((err = encode_qkv(&tk, k, B, S, Hkv, DH)) != cudaSuccess) return err;
  if ((err = encode_qkv(&tv, v, B, S, Hkv, DH)) != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, H, B);
  kern<<<grid, kThreads, smem_bytes<DH>(), stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                                     S, H, Hkv, causal, kLog2e / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Launch plan of (S, Dh, dtype), which the binding's plan() mirrors: out =
// {path (1 tensor cores, 0 CUDA cores), query rows per block, keys per
// tile, threads per block, blocks along S, dynamic shared memory bytes}.
// The grid is (blocks along S, H, B).
extern "C" int flash_fwd_plan(int S, int Dh, int dtype, int* out) {
  if (S < 1 || (Dh != 64 && Dh != 128) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    out[0] = 1, out[1] = tc::BM, out[2] = tc::BN, out[3] = tc::kThreads;
    out[5] = Dh == 64 ? tc::smem_bytes<64>() : tc::smem_bytes<128>();
  } else {
    out[0] = 0, out[1] = cores::BQ, out[2] = cores::BK, out[3] = cores::NWARPS * 32;
    out[5] = (int)(Dh == 64 ? cores::smem_bytes<64>() : cores::smem_bytes<128>());
  }
  out[4] = (S + out[1] - 1) / out[1];
  return 0;
}

// C entry, bound with ctypes.  Launches on ``stream`` and does not
// synchronise; returns the cudaError_t of the launch (0 = success).
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  Dh must be
// 64 or 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int Hkv, int Dh, int dtype,
                         int causal, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  if (Dh == 64)
    return (int)(bf16 ? tc::launch<64>(q, k, v, o, B, S, H, Hkv, causal, st)
                      : cores::launch<64>(q, k, v, o, B, S, H, Hkv, causal, st));
  if (Dh == 128)
    return (int)(bf16 ? tc::launch<128>(q, k, v, o, B, S, H, Hkv, causal, st)
                      : cores::launch<128>(q, k, v, o, B, S, H, Hkv, causal, st));
  return (int)cudaErrorInvalidValue;
}
