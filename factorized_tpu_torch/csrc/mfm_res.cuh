// The residual-layout table of the fused MFM encode: where the train
// forward writes, and the backward kernels read, each of the ten residual
// fields (the JAX package's _RES_NAMES: att, r1, kg1, r2, kg2, r3, kg3,
// chat, g1, g2). Column k of field f at step s and batch row b lives at
// ptr[(s * n + b) * stride + col + k].
//
// One (t, n, R) buffer in the _RES_NAMES layout is the special case of one
// pointer, stride R and each field's offset; ten (t, n, width) tensors are
// ten pointers, each with stride = width and offset 0. The table travels
// by value in the kernels' arguments (10 entries, 160 bytes).
#pragma once

#include <stddef.h>

namespace ftt {

enum ResField {
  kAtt, kR1, kKg1, kR2, kKg2, kR3, kKg3, kChat, kG1, kG2, kResFields
};

struct ResEntry {
  float* ptr;
  int stride;
  int col;
};

struct ResTable {
  ResEntry f[kResFields];
};

// The address of column 0 of row `at` (= s * n + b) of a field.
__host__ __device__ __forceinline__ float* res_row(const ResEntry& e,
                                                   size_t at) {
  return e.ptr + at * e.stride + e.col;
}

// Each field's width, in the _RES_NAMES order.
inline void res_widths(int H, int z_tot, int mem, int s1, int s2, int s3,
                       int s4, int (&w)[kResFields]) {
  const int m2 = 2 * (H - z_tot), s34 = s3 + s4;
  const int widths[kResFields] = {m2, s1, s1, s2, s2, s34, s34, mem, mem,
                                  mem};
  for (int k = 0; k < kResFields; ++k) w[k] = widths[k];
}

// Fills `out` from host arrays of ten pointers, row strides and column
// offsets; null `ptrs` leaves every entry null (no residuals). False if a
// pointer is null or a field does not fit its row stride.
inline bool make_res_table(void* const* ptrs, const int* strides,
                           const int* cols, const int (&widths)[kResFields],
                           ResTable* out) {
  for (int k = 0; k < kResFields; ++k) {
    out->f[k].ptr = ptrs ? static_cast<float*>(ptrs[k]) : nullptr;
    out->f[k].stride = ptrs ? strides[k] : 0;
    out->f[k].col = ptrs ? cols[k] : 0;
    if (ptrs && (ptrs[k] == nullptr || cols[k] < 0 ||
                 cols[k] + widths[k] > strides[k]))
      return false;
  }
  return true;
}

}  // namespace ftt
