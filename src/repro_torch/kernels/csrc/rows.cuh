// Row copies shared by the kernels that move payload rows as raw bytes (K2
// reorder.cu, K3 dispatch.cu): a grid-stride launch size, and the choice of
// the widest vector (16, 8, 4, 2 or 1 bytes) that divides the row and every
// pointer, so that rows are moved flat and narrow rows still fill the warps.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr long long kMaxBlocks = 65535LL * 16;

// Blocks of `threads` for a grid-stride loop over `total` items.
inline unsigned grid_for(long long total, int threads) {
  long long g = (total + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > kMaxBlocks) g = kMaxBlocks;
  return (unsigned)g;
}

// Calls f(V{}) with V the widest of uint4, uint2, unsigned, unsigned short
// and unsigned char whose size divides `align` (the OR of the row's bytes
// and the pointers); returns what f returns.
template <typename F>
int with_vector(uintptr_t align, F&& f) {
  if (align % 16 == 0) return f(uint4{});
  if (align % 8 == 0) return f(uint2{});
  if (align % 4 == 0) return f((unsigned)0);
  if (align % 2 == 0) return f((unsigned short)0);
  return f((unsigned char)0);
}

}  // namespace rows
