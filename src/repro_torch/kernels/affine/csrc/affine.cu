// K1: the device stage's elementwise affine map, o = x * a + b per column,
// for a whole device batch in one launch, read from and written to wherever
// the buffers lie: the card's memory, or pinned host memory.
//
// Replaces src/repro/columnar/device.py:127 (_pallas_affine_body; one
// pallas_call per column at :141).  The TPU version runs one call per column
// on arrays already on the chip.  Here the device stage stages every column
// of a batch into one pinned host buffer (each column at a 128-byte-aligned
// offset, one after another; kernels/affine/ref.py::Layout), the copy engine
// brings it to the card, and K1 reads it there and writes the result straight
// into the pinned output buffer: two stream operations a batch where there
// were three (copy in, kernel, copy out).  With unified addressing, memory
// from cudaHostAlloc is mapped into the card's address space at its host
// address, and the SMs' writes to it are posted over PCIe.
//
// Why the input still goes through the copy engine: on an H100 80GB HBM3 the
// SMs read mapped host memory at about 25 GB/s, whatever the loads (16-byte
// loads four deep, L2 256-byte prefetch hints, TMA bulk copies into shared
// memory), where the copy engine brings 41 GB/s; their writes to it reach
// about 52 GB/s, above the copy engine's 41 (PERF.md §6).  The kernel
// takes host pointers on both sides all the same, as measured there.
//
// Bound: on the device stage's route, the link: the bytes written over the
// per-direction PCIe rate (the reads come from HBM, far faster); on the
// card's memory alone, 2 x bytes over the HBM rate.  One multiply and one add
// per element are far below the card's operation rate.  The design:
//  - every thread issues kUnroll independent 16-byte loads before any
//    arithmetic, and the grid is sized to the SMs (at most kBlocksPerSm
//    blocks each), not to the rows: at the stream's batch (16,384 rows x 12
//    i8) the whole batch is in flight in the first wave;
//  - a warp's stores cover 512 contiguous bytes, and every column starts on a
//    128-byte line, so the writes over PCIe leave as whole lines;
//  - blockIdx.y picks the column, so the dtype switch sits outside the loop,
//    uniform across a block.
// The launch descriptor (Params) is built once per column layout and (a, b)
// by the caller; a call passes the row count and places the columns from it.
//
// The result must equal the NumPy reference (_np_affine, device.py:93-100)
// bit for bit, for every dtype.  So:
//  - integer overflow wraps: the products and sums are taken on unsigned
//    integers of the column's width and the bits reinterpreted (signed
//    overflow is undefined in C++);
//  - no fused multiply-add: NumPy rounds after the multiply and again after
//    the add, and nvcc contracts x*a+b into an FMA by default, so the float
//    paths use the __*_rn intrinsics, which are never contracted;
//  - the arithmetic type follows NumPy 2's promotion of Python scalars
//    (NEP 50), chosen by the wrapper: f4 columns compute in float32 with a
//    and b rounded to float32; f8 columns in float64; an i8/i4 column times
//    an int parameter stays in the column's integer type, and a float
//    parameter moves the computation to float64, truncated back at the end.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxCols = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // independent 16-byte loads in flight per thread
constexpr int kBlocksPerSm = 8;  // 2,048 threads an SM
constexpr int kAlign = 128;      // column alignment in a staging buffer (ref.ALIGN)
constexpr int kMaxDevices = 64;

// dtype codes, as the columnar wire bytes (repro_torch/columnar/block.py)
enum Code { kI8 = 0, kF8 = 1, kI4 = 2, kF4 = 3 };
constexpr int kItemSize[4] = {8, 8, 4, 4};

// The launch descriptor, mirrored by kernels/affine/affine.py::_Params
// (affine_params_bytes() checks the size).  offset[] is filled per call.
struct Params {
  long long offset[kMaxCols];  // bytes from the buffer start, multiples of kAlign
  int code[kMaxCols];
  long long rows;
  long long ai, bi;  // a, b as integers (used when the parameter is an int)
  double af, bf;     // a, b as float64
  float af32, bf32;  // a, b rounded to float32 (f4 columns)
  int ncols, a_float, b_float;
};

// The scalar operands ride in each functor by value (registers), not as a
// pointer into the kernel's parameter space.
struct OpI8 {
  long long ai, bi;
  double af, bf;
  int a_float, b_float;
  __device__ __forceinline__ long long operator()(long long x) const {
    if (!a_float) {
      const unsigned long long prod = (unsigned long long)x * (unsigned long long)ai;
      if (!b_float) return (long long)(prod + (unsigned long long)bi);
      return __double2ll_rz(__dadd_rn(__ll2double_rn((long long)prod), bf));
    }
    return __double2ll_rz(__dadd_rn(__dmul_rn(__ll2double_rn(x), af), bf));
  }
};

struct OpI4 {
  int ai, bi;
  double af, bf;
  int a_float, b_float;
  __device__ __forceinline__ int operator()(int x) const {
    if (!a_float) {
      const unsigned int prod = (unsigned int)x * (unsigned int)ai;
      if (!b_float) return (int)(prod + (unsigned int)bi);
      return __double2int_rz(__dadd_rn(__int2double_rn((int)prod), bf));
    }
    return __double2int_rz(__dadd_rn(__dmul_rn(__int2double_rn(x), af), bf));
  }
};

struct OpF8 {
  double af, bf;
  __device__ __forceinline__ double operator()(double x) const {
    return __dadd_rn(__dmul_rn(x, af), bf);
  }
};

struct OpF4 {
  float af, bf;
  __device__ __forceinline__ float operator()(float x) const {
    return __fadd_rn(__fmul_rn(x, af), bf);
  }
};

template <typename T, typename Op>
__device__ __forceinline__ void affine_column(const unsigned char* __restrict__ src,
                                              unsigned char* __restrict__ dst,
                                              long long rows, Op op) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kTile = (long long)kThreads * kUnroll;  // 16-byte vectors
  union Vec {
    uint4 raw;
    T v[kVec];
  };
  const long long nvec = rows / kVec;
  const uint4* in4 = reinterpret_cast<const uint4*>(src);
  uint4* out4 = reinterpret_cast<uint4*>(dst);
  for (long long base = (long long)blockIdx.x * kTile + threadIdx.x; base < nvec;
       base += (long long)gridDim.x * kTile) {
    Vec u[kUnroll];
    // every load of the tile is issued before the first result is needed
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + (long long)k * kThreads;
      if (i < nvec) u[k].raw = __ldcs(in4 + i);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + (long long)k * kThreads;
      if (i < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) u[k].v[e] = op(u[k].v[e]);
        __stcs(out4 + i, u[k].raw);
      }
    }
  }
  // ragged tail: fewer than kVec rows
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T* in = reinterpret_cast<const T*>(src);
  T* out = reinterpret_cast<T*>(dst);
  for (long long i = nvec * kVec + t0; i < rows; i += (long long)gridDim.x * blockDim.x)
    out[i] = op(in[i]);
}

__global__ void __launch_bounds__(kThreads)
affine_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
              const Params p) {
  const int j = blockIdx.y;
  const unsigned char* s = src + p.offset[j];
  unsigned char* d = dst + p.offset[j];
  switch (p.code[j]) {
    case kI8:
      affine_column<long long>(s, d, p.rows,
                               OpI8{p.ai, p.bi, p.af, p.bf, p.a_float, p.b_float});
      break;
    case kF8: affine_column<double>(s, d, p.rows, OpF8{p.af, p.bf}); break;
    case kI4:
      // an int parameter of an i4 column fits int32 (the wrapper checks)
      affine_column<int>(s, d, p.rows,
                         OpI4{(int)p.ai, (int)p.bi, p.af, p.bf, p.a_float, p.b_float});
      break;
    case kF4: affine_column<float>(s, d, p.rows, OpF4{p.af32, p.bf32}); break;
  }
}

// cudaSuccess when the current device `dev` can read and write `ptr` at that
// address: its own memory, or pinned host memory mapped at the host address.
cudaError_t reachable(const void* ptr, int dev) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch was refused, nothing is broken
    return err;
  }
  if (attr.type == cudaMemoryTypeDevice)
    return attr.device == dev ? cudaSuccess : cudaErrorInvalidDevicePointer;
  if (attr.type == cudaMemoryTypeHost)
    return attr.devicePointer == ptr ? cudaSuccess : cudaErrorInvalidHostPointer;
  return cudaErrorInvalidHostPointer;  // pageable (unregistered) or managed memory
}

int sm_count(int dev) {
  static int counts[kMaxDevices];  // 0 until asked
  if (dev < 0 || dev >= kMaxDevices) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
    counts[dev] = n;
  }
  return counts[dev];
}

}  // namespace

// Size of Params, so that the binding can check its ctypes mirror.
extern "C" int affine_params_bytes() { return (int)sizeof(Params); }

// Column alignment the launch assumes (kernels/affine/ref.py ALIGN).
extern "C" int affine_align() { return kAlign; }

// Launches K1 on `stream` over the columns that `desc` describes, `rows`
// rows each, from `src` into the same places of `dst`.  Each pointer must
// be 16-byte aligned and lie in the current device's memory or in pinned
// host memory mapped at its host address; `nbytes` is the caller's size of
// the layout, which must equal the one placed here.  `start` and `done`,
// where not null, are CUDA events recorded on `stream` right before and right
// after the launch, with no host work between them and it.  Returns a
// cudaError_t:
// cudaErrorInvalidHostPointer for pageable host memory (or a mapping at
// another address), cudaErrorInvalidDevicePointer for another device's
// memory, cudaErrorInvalidValue for a descriptor or size the kernel does not
// take, else cudaGetLastError() after the launch.  Does not synchronise.
extern "C" int affine_launch(const void* src, void* dst, long long rows, long long nbytes,
                             const void* desc, void* start, void* done, void* stream) {
  // desc is a Params; the C signature keeps the type (internal to this file)
  // out of the exported symbol
  Params p;
  memcpy(&p, desc, sizeof(Params));
  if (p.ncols < 1 || p.ncols > kMaxCols || rows < 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)src | (uintptr_t)dst) % 16 != 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = reachable(src, dev)) != cudaSuccess) return (int)err;
  if ((err = reachable(dst, dev)) != cudaSuccess) return (int)err;
  p.rows = rows;
  long long off = 0, max_vec = 1;
  for (int j = 0; j < p.ncols; ++j) {
    if (p.code[j] < 0 || p.code[j] > 3) return (int)cudaErrorInvalidValue;
    const long long bytes = rows * kItemSize[p.code[j]];
    p.offset[j] = off;
    off += (bytes + kAlign - 1) / kAlign * kAlign;
    if (bytes / 16 > max_vec) max_vec = bytes / 16;
  }
  if (off != nbytes) return (int)cudaErrorInvalidValue;
  const long long tiles = (max_vec + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
  long long bx = (long long)sm_count(dev) * kBlocksPerSm / p.ncols;
  if (bx < 1) bx = 1;
  if (bx > tiles) bx = tiles;
  const dim3 grid((unsigned)bx, (unsigned)p.ncols);
  if (start != nullptr && (err = cudaEventRecord((cudaEvent_t)start, (cudaStream_t)stream)))
    return (int)err;
  affine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (done != nullptr) err = cudaEventRecord((cudaEvent_t)done, (cudaStream_t)stream);
  return (int)err;
}
