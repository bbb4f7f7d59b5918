// K1: the device stage's elementwise affine map, o = x * a + b per column,
// for a whole device batch in one launch.
//
// Replaces src/repro/columnar/device.py:127 (_pallas_affine_body; one
// pallas_call per column at :141).  The TPU version runs one call per column;
// here the wrapper stages every column of the batch into one buffer (each at
// a 16-byte-aligned offset) and passes a small descriptor per column (byte
// offset, row count, dtype code), so one launch covers the batch.  The grid
// is (row tiles, columns): blockIdx.y picks the column, so the dtype switch
// is uniform across a block, and each thread moves 16 bytes at a time.
//
// Bound: device-memory bytes.  Each element is read once and written once
// (2 x rows x row_bytes) with one multiply and one add per element, far below
// the card's operation rate, so the floor is bytes / 3.35 TB/s.  Nothing
// fast is attempted yet: a grid-stride loop over 16-byte vectors.
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

namespace {

constexpr int kMaxCols = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 4096;

// dtype codes, as the columnar wire bytes (repro_torch/columnar/block.py)
enum Code { kI8 = 0, kF8 = 1, kI4 = 2, kF4 = 3 };

struct Col {
  long long offset;  // bytes from the buffer start, a multiple of 16
  long long rows;
  int code;
  int pad;
};

struct Params {
  Col cols[kMaxCols];
  long long ai, bi;   // a, b as integers (used when the parameter is an int)
  double af, bf;      // a, b as float64
  float af32, bf32;   // a, b rounded to float32 (f4 columns)
  int a_float, b_float;
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
  union Vec {
    uint4 raw;
    T v[kVec];
  };
  const long long nvec = rows / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* in4 = reinterpret_cast<const uint4*>(src);
  uint4* out4 = reinterpret_cast<uint4*>(dst);
  for (long long i = t0; i < nvec; i += stride) {
    Vec u;
    u.raw = in4[i];
#pragma unroll
    for (int k = 0; k < kVec; ++k) u.v[k] = op(u.v[k]);
    out4[i] = u.raw;
  }
  // ragged tail: fewer than kVec rows
  const T* in = reinterpret_cast<const T*>(src);
  T* out = reinterpret_cast<T*>(dst);
  for (long long i = nvec * kVec + t0; i < rows; i += stride) out[i] = op(in[i]);
}

__global__ void __launch_bounds__(kThreads)
affine_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
              const Params p) {
  const Col c = p.cols[blockIdx.y];
  const unsigned char* s = src + c.offset;
  unsigned char* d = dst + c.offset;
  switch (c.code) {
    case kI8:
      affine_column<long long>(s, d, c.rows,
                               OpI8{p.ai, p.bi, p.af, p.bf, p.a_float, p.b_float});
      break;
    case kF8: affine_column<double>(s, d, c.rows, OpF8{p.af, p.bf}); break;
    case kI4:
      // an int parameter of an i4 column fits int32 (the wrapper checks)
      affine_column<int>(s, d, c.rows,
                         OpI4{(int)p.ai, (int)p.bi, p.af, p.bf, p.a_float, p.b_float});
      break;
    case kF4: affine_column<float>(s, d, c.rows, OpF4{p.af32, p.bf32}); break;
  }
}

constexpr int kItemSize[4] = {8, 8, 4, 4};

}  // namespace

// Launches K1 on `stream` over `ncols` columns of the staged buffer `src`,
// writing each column at the same offset of `dst`.  Returns a cudaError_t:
// cudaErrorInvalidValue for a descriptor the kernel does not take, else
// cudaGetLastError() after the launch.  Does not synchronise.
extern "C" int affine_launch(const void* src, void* dst, int ncols,
                             const long long* offsets, const long long* rows,
                             const int* codes, long long ai, long long bi, double af,
                             double bf, float af32, float bf32, int a_float,
                             int b_float, void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)src | (uintptr_t)dst) % 16 != 0) return (int)cudaErrorInvalidValue;
  Params p;
  long long max_vec = 1;
  for (int j = 0; j < ncols; ++j) {
    if (codes[j] < 0 || codes[j] > 3 || offsets[j] % 16 != 0 || rows[j] < 0)
      return (int)cudaErrorInvalidValue;
    p.cols[j].offset = offsets[j];
    p.cols[j].rows = rows[j];
    p.cols[j].code = codes[j];
    p.cols[j].pad = 0;
    const long long vec = (rows[j] * kItemSize[codes[j]] + 15) / 16;
    if (vec > max_vec) max_vec = vec;
  }
  p.ai = ai;
  p.bi = bi;
  p.af = af;
  p.bf = bf;
  p.af32 = af32;
  p.bf32 = bf32;
  p.a_float = a_float;
  p.b_float = b_float;
  long long bx = (max_vec + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid((unsigned)bx, (unsigned)ncols);
  affine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), p);
  return (int)cudaGetLastError();
}
