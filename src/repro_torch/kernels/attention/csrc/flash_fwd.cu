// K4 on Hopper: causal / non-causal GQA flash-attention forward.
//
// Replaces: src/repro/kernels/attention/flash.py::_flash_kernel, the Pallas
// TPU kernel launched by flash_attention there.  Same function: q (B,S,H,Dh),
// k/v (B,S,Hkv,Dh), kv head h / (H/Hkv), scale 1/sqrt(Dh) applied to q in
// fp32, online softmax with fp32 running max / denominator / accumulator,
// output in q's dtype.  Unlike the TPU wrapper it takes any S >= 1: the tail
// tiles of q and of k/v are masked here.
//
// What bounds it on an H100: it must read q, k, v once and write o once,
// 4*B*S*H*Dh*itemsize bytes when Hkv == H, and it does about 2*B*H*S^2*Dh
// FLOPs when causal (QK^T and PV over the causal half; twice that when not).
// At the served olmo-1b shapes (B=1, H=16, Dh=128, S <= 512, bf16) that is at
// most 8.4 MB (2.5 us at 3.35 TB/s) against 1.1 GFLOP (1.1 us at 989 TFLOP/s
// on the bf16 tensor cores): the card bounds it by bytes.
//
// What the design does about it: one block per (q tile of 32 rows, head,
// batch) loads its q tile once and streams the K/V tiles of its causal prefix
// through shared memory, so device-memory traffic stays near the byte bound
// (the re-reads of K/V by later q tiles of the same head hit L2) and the
// scores, the softmax and the accumulator never leave registers.  GQA reads
// the shared kv head in place, without expanding it.  This first version
// does its arithmetic in fp32 on the CUDA cores, not the tensor cores, so it
// is limited by shared-memory loads and FMAs, far above the byte bound; a
// wgmma + TMA version is later work.
//
// Work split: 4 warps x 8 query rows.  For each 32-key tile a lane owns one
// key (its scores for the warp's 8 rows) and 1/32 of the head dim of each
// row's accumulator; the weights of key j reach the other lanes by shuffle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;  // query rows per block
constexpr int BK = 32;  // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int ROWS = BQ / NWARPS;  // query rows per warp
constexpr float NEG = -1e30f;      // masked score, as in the TPU kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int DH>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int H,
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
  const T* qb = q + (long)b * S * q_stride + (long)h * DH;
  const T* kb = k + (long)b * S * kv_stride + (long)hkv * DH;
  const T* vb = v + (long)b * S * kv_stride + (long)hkv * DH;

  // q tile, scaled in fp32; rows past S are zeros and are never stored
  for (int i = tid; i < BQ * DH; i += NWARPS * 32) {
    const int r = i / DH, d = i % DH, s = q0 + r;
    q_s[i] = s < S ? to_f(qb[s * q_stride + d]) * scale : 0.f;
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
      k_s[j * KS + d] = in ? to_f(kb[s * kv_stride + d]) : 0.f;
      v_s[j * DH + d] = in ? to_f(vb[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float sc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r] = 0.f;
    const float* krow = k_s + lane * KS;
    const float4* q4 = reinterpret_cast<const float4*>(q_s + row0 * DH);
#pragma unroll 2
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
      T* orow = o + ((long)b * S + qpos) * q_stride + (long)h * DH;
#pragma unroll
      for (int c = 0; c < DPL; ++c) orow[lane + 32 * c] = from_f<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int Hkv, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_fwd_kernel<T, DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, causal, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Launches on ``stream`` and does not
// synchronise; returns the cudaError_t of the launch (0 = success).
// dtype: 0 = float32, 1 = bfloat16.  Dh must be 64 or 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int Hkv, int Dh, int dtype,
                         int causal, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  if (Dh == 64)
    return (int)(bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, Hkv, causal, st)
                      : launch<float, 64>(q, k, v, o, B, S, H, Hkv, causal, st));
  if (Dh == 128)
    return (int)(bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, Hkv, causal, st)
                      : launch<float, 128>(q, k, v, o, B, S, H, Hkv, causal, st));
  return (int)cudaErrorInvalidValue;
}
