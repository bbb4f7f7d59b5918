// K5: the Mamba2 SSD chunked scan [arXiv:2405.21060], from a zero state.
//
// Replaces src/repro/kernels/ssd/ssd.py:24 (_ssd_kernel; pallas_call at :98).
// The TPU runs the grid (B, H, chunks) in order on one core and carries the
// (P,N) state from chunk to chunk in VMEM scratch.  On this card that order
// leaves B*H blocks (48 at mamba2-780m) on 132 SMs, so the scan is split
// across chunks as in the paper's own chunked algorithm (section 6), in three
// launches on one stream:
//   1. chunk states, one block per (chunk, two heads with P = 64 or one with
//      P = 128, b): cum = cumsum(dt A) in the chunk, summed and kept in f64
//      (to the `cum` scratch), and S_c = (dt exp(total - cum) x)^T B, a P x N
//      matrix per head, each B tile loaded once for the block's heads.
//   2. state passing, elementwise over (b, h, p, n), the chunks in order:
//        states[c] <- h (the state before chunk c);  h <- exp(total_c) h + S_c
//      overwriting S in place; the last h is hT.
//   3. chunk outputs, one block per (chunk, group of four heads, 64-row query
//      tile, b), the tiles with the most keys first: the tile's causal scores
//      C B^T once for the group, kept in shared memory, then for each head
//        y = exp(cum_q) (C h_before^T) + (Lmask o scores) (dt x),
//        Lmask[q,k] = exp(cum_q - cum_k) for k <= q (one exponential of the
//        difference: the log-decay reaches -400 in a chunk, so it must not
//        be factored), key steps past each warp's last row skipped.
//   The cumulative log-decay is an f64 sum, and cum_q - cum_k an f64
//   difference: in f32, cum near -500 carries an absolute error of 1e-4
//   (its summation and its rounding), which exp turns into a relative error
//   of 1e-4 in every Lmask entry, and y then misses the f64 scan by more
//   than 2e-4 of |y| at jamba-1.5-large-398b's activations.
// Every product runs on the tensor cores (mma.sync m16n8k8, TF32 operands,
// f32 sums).  TF32 keeps 10 mantissa bits, and plain TF32 operands put y off
// by about 1e-2 at mamba2-780m where the reference holds 2e-4; so each
// operand is split as hi = rna_tf32(a), lo = rna_tf32(a - hi), and a product is
// lo.hi + hi.lo + hi.hi: three tensor-core products per f32 product (a bf16
// x is exact in TF32, so its lo is 0 and that term is dropped).  Tiles come
// through cp.async, double-buffered where shared memory allows it.
//
// Bound: operations.  The function needs about 4.7 GFLOP of f32 products at
// mamba2-780m (H = 48, P = 64, N = 128, chunk 256, L = 2048) against 52 MB
// of inputs and outputs: 0.070 ms on the CUDA cores (67 TF/s), and with
// three TF32 products each 0.028 ms on the tensor cores (495 TF/s).  The
// state scratch (B, chunks, H, P, N) f32, 12.6 MB there, is written twice
// and read twice, mostly in L2.  What the design does: 192 blocks in step 1
// and 384 in step 3 where the one-launch kernel had 48, the scores once per four
// heads, the products on the tensor cores, and 16 warps a block in step 3.
// What is left: the kernel is bound by latency and instruction issue, not
// by the tensor cores (removing every mma saves under a tenth of step 3):
// each warp splits the operands it loads, B fragments that four warps share
// included, and step 3 holds one block an SM (180 KB of shared memory).  A
// wgmma form of step 3, with the shared operands split once into swizzled
// planes, was right but slower at one block an SM (its convert, wgmma and
// barrier phases do not overlap).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 512;
constexpr int kTile = 64;       // rows of a key or query tile
constexpr int kCols = 128;      // columns (head, p) of a block's x or state tile
constexpr int kThreads = 256;   // step 1: 8 warps
constexpr int kStateKeys = 32;  // keys of a tile in step 1
constexpr int kOutHeads = 4;    // heads per block in step 3
constexpr int kPassThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr int kXStride = kCols + 8;  // x tiles, [key][col]: stride = 8 mod 32 words (f32)

template <typename XT>
constexpr bool kBf16 = sizeof(XT) == 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- TF32 tensor-core products with the 3-term split
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  // cvt.rna.tf32.f32 on the integer pipe, not the conversion unit: add half
  // a TF32 ulp to the magnitude, clear the 13 bits TF32 drops
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b for split operands: lo.hi + hi.lo + hi.hi (the small terms first)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2], bool b_exact) {
  mma(d, al, bh[0], bh[1]);
  if (!b_exact) mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}
// the A fragment (16 x 8, row major) from four values: (g, t), (g+8, t),
// (g, t+4), (g+8, t+4) with g = lane / 4, t = lane % 4
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], hi[i], lo[i]);
}

// ---- cp.async: 16 bytes, zero-filled where `valid` is false
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// rows x row_elems of T from global (row stride gstride) to shared (stride
// sstride); rows >= nvalid are zero-filled
template <typename T>
__device__ __forceinline__ void load_rows(T* s, int sstride, const T* g, long long gstride,
                                          int rows, int row_elems, int nvalid) {
  constexpr int per = 16 / sizeof(T);
  const int cpr = row_elems / per;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * per;
    const bool v = r < nvalid;
    cp16(s + r * sstride + c, v ? g + r * gstride + c : g, v);
  }
}

// The x tile of keys [k0, k0 + ROWS) of chunk row `crow` for the COLS
// columns (head, p) that start at head h0, row stride STRIDE in shared
// memory.  Keys past the chunk and heads past H are zero-filled.
template <int P, int ROWS, int COLS, int STRIDE, typename XT>
__device__ __forceinline__ void load_x(XT* s, const XT* x, long long crow, int k0, int cl,
                                       int H, int h0) {
  constexpr int per = 16 / sizeof(XT), cpr = COLS / per;
  for (int i = threadIdx.x; i < ROWS * cpr; i += blockDim.x) {
    const int r = i / cpr, col = (i - r * cpr) * per;
    const int h = h0 + col / P, p = col % P;
    const bool v = k0 + r < cl && h < H;
    const XT* src = v ? x + ((crow + k0 + r) * H + h) * P + p : x;
    cp16(s + r * STRIDE + col, src, v);
  }
}

// Run `ntiles` tiles through a ring of `nst` (1 or 2) shared-memory slots:
// issue(i, slot) starts tile i's copies, consume(i, slot) uses them.
template <typename Issue, typename Consume>
__device__ __forceinline__ void pipeline(int ntiles, int nst, Issue issue, Consume consume) {
  if (ntiles == 0) return;
  issue(0, 0);
  cp_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (nst == 2 && i + 1 < ntiles) {
      issue(i + 1, (i + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    consume(i, nst == 2 ? i & 1 : 0);
    __syncthreads();
    if (nst == 1 && i + 1 < ntiles) {
      issue(i + 1, 0);
      cp_commit();
    }
  }
}

// =====================================================================
// Step 1: chunk states.  Block (chunk, group of kCols / P heads, b);
// warp w owns columns 32 (w % 4) .. +31 and half the state width.
template <int P, int N>
struct StateSmem {
  static constexpr int kBStride = N + 8;  // B tile [key][n]: 8 mod 32
  static constexpr int kBTile = kStateKeys * kBStride * 4;
  static constexpr int kXTileMax = kStateKeys * kXStride * 4;
  static constexpr int kStage = kBTile + kXTileMax;
  static constexpr int kW = (kCols / P) * kMaxChunk * 4;
  static constexpr int kBytes = 2 * kStage + kW;
};

template <int P, int N, typename XT>
__global__ void __launch_bounds__(kThreads, 2)  // 74 KB of shared memory a block
ssd_state_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ states, double* __restrict__ cum,
                 float* __restrict__ decay, int L, int H, int cl) {
  using S = StateSmem<P, N>;
  constexpr int HG = kCols / P, NT = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sW = reinterpret_cast<float*>(smem + 2 * S::kStage);  // [HG][cl]

  const int c = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int nc = L / cl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long crow = (long long)b * L + (long long)c * cl;  // the chunk's first row

  // cum = cumsum(dt a) over the chunk in f64, one warp per head (cum to
  // scratch); sW = dt exp(total - cum), the weight of each key in the state
  if (warp < HG && h0 + warp < H) {
    const int h = h0 + warp;
    const double a = A[h];
    float* w = sW + warp * kMaxChunk;
    constexpr int kSeg = kMaxChunk / 32;  // rows a lane scans, at most
    const int seg = (cl + 31) / 32, lo = min(lane * seg, cl), n = min(lo + seg, cl) - lo;
    double d[kSeg], part[kSeg], run = 0.0;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) d[j] = j < n ? dt[(crow + lo + j) * H + h] : 0.f;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      run += d[j] * a;
      part[j] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const double off = incl - run, total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (j < n) {
        const double cm = part[j] + off;
        cum[(crow + lo + j) * H + h] = cm;
        w[lo + j] = (float)(d[j] * exp(total - cm));
      }
    }
    if (lane == 0) decay[((long long)b * nc + c) * H + h] = (float)exp(total);
  }
  __syncthreads();

  const int m0 = 32 * (warp & 3);        // first column of the warp
  const int n0 = (warp >> 2) * (N / 2);  // first state column of the warp
  const float* wcol = sW + (m0 / P) * kMaxChunk;
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto sB = [&](int slot) { return reinterpret_cast<float*>(smem + slot * S::kStage); };
  auto sX = [&](int slot) { return reinterpret_cast<XT*>(smem + slot * S::kStage + S::kBTile); };
  const int nk = (cl + kStateKeys - 1) / kStateKeys;
  pipeline(
      nk, 2,
      [&](int kt, int slot) {
        const int k0 = kt * kStateKeys;
        load_rows(sB(slot), S::kBStride, Bm + (crow + k0) * N, N, kStateKeys, N, cl - k0);
        load_x<P, kStateKeys, kCols, kXStride>(sX(slot), x, crow, k0, cl, H, h0);
      },
      [&](int kt, int slot) {
        const float* Bs = sB(slot);
        const XT* Xs = sX(slot);
        const int k0 = kt * kStateKeys;
        const int ksteps = min(kStateKeys, cl - k0 + 7) / 8;
#pragma unroll 2
        for (int ks = 0; ks < ksteps; ++ks) {
          const int ka = 8 * ks + t, kb = ka + 4;
          const float wa = wcol[k0 + ka < cl ? k0 + ka : 0] * (k0 + ka < cl);
          const float wb = wcol[k0 + kb < cl ? k0 + kb : 0] * (k0 + kb < cl);
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int col = m0 + 16 * i + g;
            const float v[4] = {to_f(Xs[ka * kXStride + col]) * wa,
                                to_f(Xs[ka * kXStride + col + 8]) * wa,
                                to_f(Xs[kb * kXStride + col]) * wb,
                                to_f(Xs[kb * kXStride + col + 8]) * wb};
            split4(v, ah[i], al[i]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = n0 + 8 * j + g;
            uint32_t bh[2], bl[2];
            split(Bs[ka * S::kBStride + n], bh[0], bl[0]);
            split(Bs[kb * S::kBStride + n], bh[1], bl[1]);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl, false);
          }
        }
      });

  // S[col][n] for this chunk: rows (g, g + 8) of each m tile, columns (2t, 2t + 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = m0 + 16 * i + g + 8 * half;
      const int h = h0 + col / P, p = col % P;
      if (h >= H) continue;
      float* out = states + ((((long long)b * nc + c) * H + h) * P + p) * N + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
    }
  }
}

// =====================================================================
// Step 2: state passing over the chunks, four (p, n) elements a thread.
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                float* __restrict__ hT, int Bsz, int nc, int H, int PN) {
  const long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  const long long quads = (long long)Bsz * H * PN / 4;
  if (i >= quads) return;
  const long long e = i * 4;
  const int b = (int)(e / ((long long)H * PN));
  const long long r = e - (long long)b * H * PN;
  const int h = (int)(r / PN), off = (int)(r - (long long)h * PN);
  const long long cstride = (long long)H * PN;
  float4* base = reinterpret_cast<float4*>(states + (long long)b * nc * cstride + r);
  const float* dec = decay + (long long)b * nc * H + h;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = __ldcg(base);
  for (int c = 0; c < nc; ++c) {
    float4* at = reinterpret_cast<float4*>(reinterpret_cast<float*>(base) + c * cstride);
    const float4 next =
        c + 1 < nc ? __ldcg(reinterpret_cast<const float4*>(reinterpret_cast<const float*>(at) + cstride))
                   : s;
    const float d = dec[(long long)c * H];
    __stcg(at, st);  // the state before chunk c
    st = make_float4(fmaf(d, st.x, s.x), fmaf(d, st.y, s.y), fmaf(d, st.z, s.z),
                     fmaf(d, st.w, s.w));
    s = next;
  }
  *reinterpret_cast<float4*>(hT + ((long long)b * H + h) * PN + off) = st;
}

// =====================================================================
// Step 3: chunk outputs.  Block (chunk + chunks x group of kOutHeads heads,
// query tile counted from the last, b): the tiles with the most keys start
// first.  Warp w: rows 16 (w % 4) .. +15 of the query tile, and column block
// cb = w / 4 of kOutCB: keys cb 64 / kOutCB .. of each 64-key B tile in the
// scores, and 64 columns (head, p) of y, out of the kOutCols of a round.
constexpr int kOutCB = 4;                      // column blocks: 4 warps each
constexpr int kOutThreads = 128 * kOutCB;
constexpr int kOutCols = 64 * kOutCB;          // columns (head, p) of a round
constexpr int kOutKeys = kTile * kCols / kOutCols;  // keys of an x tile; n of a state piece
constexpr int kOutXStride = kOutCols + 8;      // x tile [key][col]: 8 mod 32 words (f32)
constexpr int kOutHStride = kOutKeys + 4;      // state piece [col][n]: 4 mod 32

struct OutLayout {
  int ss;      // scores row stride (floats): 64 * tiles + 4
  int stage;   // bytes of one pipeline slot
  int nst;     // slots (1 or 2)
  int sc, sums, ring, bytes;  // byte offsets (the scores first) and total
};

template <int P, int N, typename XT>
__host__ __device__ inline OutLayout out_layout(int cl) {
  OutLayout o;
  const int nq = (cl + kTile - 1) / kTile;
  o.ss = kTile * nq + 4;
  const int btile = kTile * (N + 4) * 4;
  const int xtile = kOutKeys * kOutXStride * (int)sizeof(XT);
  const int htile = kOutCols * kOutHStride * 4;
  o.stage = btile > xtile ? btile : xtile;
  if (htile > o.stage) o.stage = htile;
  o.sc = kTile * o.ss * 4;
  o.sums = o.sc + kTile * (N + 4) * 4;
  o.ring = o.sums + kOutHeads * kTile * nq * (8 + 4);  // f64 cum, f32 dt
  o.nst = o.ring + 2 * o.stage <= kMaxSmem ? 2 : 1;
  o.bytes = o.ring + o.nst * o.stage;
  return o;
}

template <int P, int N, typename XT>
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_out_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ states, const double* __restrict__ cum,
               XT* __restrict__ y, int L, int H, int cl) {
  constexpr int HPR = kOutCols / P;        // heads a round
  constexpr int NPIECE = N / kOutKeys;     // pieces of the state
  constexpr int SJ = 8 / kOutCB;           // 8-key n tiles of a warp in the scores
  constexpr bool kExactX = kBf16<XT>;      // bf16 x is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  const OutLayout lay = out_layout<P, N, XT>(cl);
  const int nq = (cl + kTile - 1) / kTile, nc = L / cl;
  const int qt = nq - 1 - (int)blockIdx.y;  // the longest query tiles start first
  const int c = blockIdx.x % nc, hbase = (blockIdx.x / nc) * kOutHeads, b = blockIdx.z;
  const int heads = min(kOutHeads, H - hbase);
  const int q0 = qt * kTile, kspan = min(cl, q0 + kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cb = warp >> 2;
  const long long crow = (long long)b * L + (long long)c * cl;

  float* sS = reinterpret_cast<float*>(smem);             // [64][ss] scores
  float* sC = reinterpret_cast<float*>(smem + lay.sc);    // [64][N + 4] C rows
  double* sCum = reinterpret_cast<double*>(smem + lay.sums);  // [kOutHeads][64 nq]
  float* sDt = reinterpret_cast<float*>(sCum + kOutHeads * kTile * nq);
  auto slot_ptr = [&](int slot) { return smem + lay.ring + slot * lay.stage; };

  // cum (from step 1) and dt of the keys this tile needs, for each head
#pragma unroll 4
  for (int i = threadIdx.x; i < kOutHeads * kspan; i += blockDim.x) {
    const int j = i / kspan, k = i - j * kspan;
    const bool v = j < heads;
    sCum[j * kTile * nq + k] = v ? cum[(crow + k) * H + hbase + j] : 0.0;
    sDt[j * kTile * nq + k] = v ? dt[(crow + k) * H + hbase + j] : 0.f;
  }
  load_rows(sC, N + 4, Cm + (crow + q0) * N, N, kTile, N, cl - q0);
  cp_commit();

  const int qa = q0 + 16 * rg + g, qb = qa + 8;  // the lane's rows in the chunk
  const int wlast = q0 + 16 * rg + 15;           // the warp's last row in the chunk

  // ---- scores C B^T for keys [0, kspan): 64-key tiles, this warp's keys
  pipeline(
      qt + 1, lay.nst,
      [&](int kt, int slot) {
        load_rows(reinterpret_cast<float*>(slot_ptr(slot)), N + 4, Bm + (crow + kt * kTile) * N,
                  N, kTile, N, cl - kt * kTile);
      },
      [&](int kt, int slot) {
        const float* Bs = reinterpret_cast<const float*>(slot_ptr(slot));
        const int kfirst = 8 * SJ * cb;
        if (kt * kTile + kfirst > wlast) return;  // above the diagonal
        float s[SJ][4];
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < N / 8; ++ks) {
          const int n = 8 * ks + t;
          const float v[4] = {sC[(16 * rg + g) * (N + 4) + n], sC[(16 * rg + g + 8) * (N + 4) + n],
                              sC[(16 * rg + g) * (N + 4) + n + 4],
                              sC[(16 * rg + g + 8) * (N + 4) + n + 4]};
          uint32_t ah[4], al[4];
          split4(v, ah, al);
#pragma unroll
          for (int j = 0; j < SJ; ++j) {
            const int key = kfirst + 8 * j + g;
            uint32_t bh[2], bl[2];
            split(Bs[key * (N + 4) + n], bh[0], bl[0]);
            split(Bs[key * (N + 4) + n + 4], bh[1], bl[1]);
            mma3(s[j], ah, al, bh, bl, false);
          }
        }
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int col = kt * kTile + kfirst + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(sS + (16 * rg + g) * lay.ss + col) = make_float2(s[j][0], s[j][1]);
          *reinterpret_cast<float2*>(sS + (16 * rg + g + 8) * lay.ss + col) =
              make_float2(s[j][2], s[j][3]);
        }
      });

  // ---- for each round of heads: y = exp(cum_q) C h^T + (Lmask o scores)(dt x)
  const int inter = c > 0 ? NPIECE : 0;  // the state before chunk 0 is zero
  const int nxt = (kspan + kOutKeys - 1) / kOutKeys;
  const int rounds = (heads + HPR - 1) / HPR;
  for (int r = 0; r < rounds; ++r) {
    const int h0 = hbase + r * HPR;                  // first head of the round
    const int hl = r * HPR + 64 * cb / P;            // this warp's head, in the group
    const int p0 = 64 * cb % P;                      // its first p
    const bool live = hl < heads;
    const double* cumh = sCum + hl * kTile * nq;
    const float* dth = sDt + hl * kTile * nq;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const double cqa = live && qa < kspan ? cumh[qa] : 0.0;
    const double cqb = live && qb < kspan ? cumh[qb] : 0.0;

    pipeline(
        inter + nxt, lay.nst,
        [&](int i, int slot) {
          if (i < inter) {  // a piece of the states of the round's heads
            float* hs = reinterpret_cast<float*>(slot_ptr(slot));
            constexpr int cpr = kOutKeys / 4;
            for (int e = threadIdx.x; e < kOutCols * cpr; e += blockDim.x) {
              const int col = e / cpr, n = (e - col * cpr) * 4;
              const int h = h0 + col / P, p = col % P;
              const bool v = h < H;
              const float* src =
                  v ? states + ((((long long)b * nc + c) * H + h) * P + p) * N + i * kOutKeys + n
                    : states;
              cp16(hs + col * kOutHStride + n, src, v);
            }
          } else {
            load_x<P, kOutKeys, kOutCols, kOutXStride>(reinterpret_cast<XT*>(slot_ptr(slot)), x,
                                                       crow, (i - inter) * kOutKeys, cl, H, h0);
          }
        },
        [&](int i, int slot) {
          if (!live) return;
          if (i < inter) {  // acc += C[:, piece] h[:, piece]^T
            const float* hs = reinterpret_cast<const float*>(slot_ptr(slot));
#pragma unroll 2
            for (int ks = 0; ks < kOutKeys / 8; ++ks) {
              const int n = i * kOutKeys + 8 * ks + t;
              const float v[4] = {sC[(16 * rg + g) * (N + 4) + n],
                                  sC[(16 * rg + g + 8) * (N + 4) + n],
                                  sC[(16 * rg + g) * (N + 4) + n + 4],
                                  sC[(16 * rg + g + 8) * (N + 4) + n + 4]};
              uint32_t ah[4], al[4];
              split4(v, ah, al);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = 64 * cb + 8 * j + g;
                uint32_t bh[2], bl[2];
                split(hs[col * kOutHStride + 8 * ks + t], bh[0], bl[0]);
                split(hs[col * kOutHStride + 8 * ks + t + 4], bh[1], bl[1]);
                mma3(acc[j], ah, al, bh, bl, false);
              }
            }
            if (i == inter - 1) {  // scale by exp(cum_q) before the intra-chunk sum
              const float ea = expf((float)cqa), eb = expf((float)cqb);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                acc[j][0] *= ea;
                acc[j][1] *= ea;
                acc[j][2] *= eb;
                acc[j][3] *= eb;
              }
            }
            return;
          }
          // acc += (Lmask o scores)[:, tile] (dt x)[tile]; dt folds into the mask;
          // 8-key steps past the warp's last row are zero and skipped
          const int k0 = (i - inter) * kOutKeys;
          if (k0 > wlast) return;
          const int ksteps = (min(min(kspan, wlast + 1), k0 + kOutKeys) - k0 + 7) / 8;
          const XT* xs = reinterpret_cast<const XT*>(slot_ptr(slot));
#pragma unroll 2
          for (int ks = 0; ks < ksteps; ++ks) {
            const int ka = k0 + 8 * ks + t, kb = ka + 4;
            const bool la = ka < kspan, lb = kb < kspan;
            const double cka = la ? cumh[ka] : 0.0, ckb = lb ? cumh[kb] : 0.0;
            const float dka = la ? dth[ka] : 0.f, dkb = lb ? dth[kb] : 0.f;
            const float* sa = sS + (16 * rg + g) * lay.ss;
            const float* sb = sa + 8 * lay.ss;
            // __expf: ex2.approx of diff * log2(e); relative error ~2e-6 where
            // |diff| < 20, and the terms past that are below 2e-9; the
            // difference is taken in f64, then rounded
            const float v[4] = {la && ka <= qa ? sa[ka] * __expf((float)(cqa - cka)) * dka : 0.f,
                                la && ka <= qb ? sb[ka] * __expf((float)(cqb - cka)) * dka : 0.f,
                                lb && kb <= qa ? sa[kb] * __expf((float)(cqa - ckb)) * dkb : 0.f,
                                lb && kb <= qb ? sb[kb] * __expf((float)(cqb - ckb)) * dkb : 0.f};
            uint32_t ah[4], al[4];
            split4(v, ah, al);
            const int ra = (8 * ks + t) * kOutXStride, rb = ra + 4 * kOutXStride;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = 64 * cb + 8 * j + g;
              uint32_t bh[2], bl[2];
              if constexpr (kExactX) {
                bh[0] = __float_as_uint(to_f(xs[ra + col]));
                bh[1] = __float_as_uint(to_f(xs[rb + col]));
                bl[0] = bl[1] = 0u;
              } else {
                split(to_f(xs[ra + col]), bh[0], bl[0]);
                split(to_f(xs[rb + col]), bh[1], bl[1]);
              }
              mma3(acc[j], ah, al, bh, bl, kExactX);
            }
          }
        });

    if (live) {
      const int h = hbase + hl;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = half ? qb : qa;
        if (q >= cl) continue;
        XT* out = y + ((crow + q) * H + h) * P + p0 + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
          if constexpr (kBf16<XT>)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(out + 8 * j) = make_float2(v0, v1);
        }
      }
    }
  }
}

// =====================================================================
template <typename K>
int allow_smem(K kernel, bool& done) {
  if (done) return 0;  // set once, outside any graph capture
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

struct Args {
  const void* x;
  const float *dt, *A, *Bm, *Cm;
  void* y;
  float *hT, *states;
  double* cum;
  float* decay;
  int Bsz, L, H, cl;
  cudaStream_t s;
};

template <int P, int N, typename XT>
int launch_step(int step, const Args& a) {
  const int nc = a.L / a.cl;
  const XT* x = static_cast<const XT*>(a.x);
  if (step == 0) {
    static bool done = false;
    if (int e = allow_smem(ssd_state_kernel<P, N, XT>, done)) return e;
    constexpr int HG = kCols / P;
    const dim3 grid((unsigned)nc, (unsigned)((a.H + HG - 1) / HG), (unsigned)a.Bsz);
    ssd_state_kernel<P, N, XT><<<grid, kThreads, StateSmem<P, N>::kBytes, a.s>>>(
        x, a.dt, a.A, a.Bm, a.states, a.cum, a.decay, a.L, a.H, a.cl);
  } else if (step == 1) {
    const long long quads = (long long)a.Bsz * a.H * P * N / 4;
    ssd_pass_kernel<<<(unsigned)((quads + kPassThreads - 1) / kPassThreads), kPassThreads, 0,
                      a.s>>>(a.states, a.decay, a.hT, a.Bsz, nc, a.H, P * N);
  } else {
    static bool done = false;
    if (int e = allow_smem(ssd_out_kernel<P, N, XT>, done)) return e;
    const int nq = (a.cl + kTile - 1) / kTile;
    const dim3 grid((unsigned)(nc * ((a.H + kOutHeads - 1) / kOutHeads)), (unsigned)nq,
                    (unsigned)a.Bsz);
    ssd_out_kernel<P, N, XT><<<grid, kOutThreads, out_layout<P, N, XT>(a.cl).bytes, a.s>>>(
        x, a.dt, a.Bm, a.Cm, a.states, a.cum, static_cast<XT*>(a.y), a.L, a.H, a.cl);
  }
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_xt(int step, const Args& a, int P, int N) {
  if (P == 64 && N == 64) return launch_step<64, 64, XT>(step, a);
  if (P == 64 && N == 128) return launch_step<64, 128, XT>(step, a);
  if (P == 128 && N == 64) return launch_step<128, 64, XT>(step, a);
  if (P == 128 && N == 128) return launch_step<128, 128, XT>(step, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_max_chunk() { return kMaxChunk; }
extern "C" int ssd_launches_per_call() { return 3; }

// One launch of the scan: step 0 the chunk states, 1 the state passing, 2
// the outputs (see the note at the top).  Scratch: states (B, L/cl, H, P, N)
// and decay (B, L/cl, H) f32, cum (B, L, H) f64.
extern "C" int ssd_launch_step(int step, const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y, void* hT, void* states,
                               void* cum, void* decay, int Bsz, int L, int H, int P, int N,
                               int cl, int x_bf16, void* stream) {
  if (Bsz < 1 || Bsz > 65535 || H < 1 || cl < 1 || cl > kMaxChunk || L < cl || L % cl != 0 ||
      step < 0 || step > 2)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const Args a{x, f(dt), f(A), f(Bm), f(Cm), y, w(hT), w(states), static_cast<double*>(cum),
               w(decay), Bsz, L, H, cl, (cudaStream_t)stream};
  if (x_bf16) return launch_xt<__nv_bfloat16>(step, a, P, N);
  return launch_xt<float>(step, a, P, N);
}

// The SSD scan on `stream`: x (B,L,H,P) f32 (x_bf16 = 0) or bf16 (1), dt
// (B,L,H), A (H,), Bm and Cm (B,L,N) f32 -> y (B,L,H,P) in x's type and hT
// (B,H,P,N) f32, in ssd_launches_per_call() launches.  Takes P and N in {64,
// 128}, 1 <= cl <= 512 dividing L, 16-byte aligned x, Bm and Cm.  Returns a
// cudaError_t (cudaErrorInvalidValue for shapes it does not take).  Does
// not synchronise.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, void* y, void* hT, void* states, void* cum,
                          void* decay, int Bsz, int L, int H, int P, int N, int cl, int x_bf16,
                          void* stream) {
  for (int step = 0; step < 3; ++step)
    if (int e = ssd_launch_step(step, x, dt, A, Bm, Cm, y, hT, states, cum, decay, Bsz, L, H, P,
                                N, cl, x_bf16, stream))
      return e;
  return 0;
}
