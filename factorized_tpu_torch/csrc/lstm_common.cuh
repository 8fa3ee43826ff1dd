// Pieces shared by the recurrent kernels: the cell table of a fused,
// block-diagonal, gate-major recurrent weight, and the gate nonlinearity.
#pragma once

#include <cuda_runtime.h>

namespace ftt {

constexpr int kMaxCells = 8;

// Prefix sums of the fused cells' hidden widths: cell m owns hidden units
// [off[m], off[m + 1]). In a gate-major block-diagonal weight (H, 4H),
// column q * H + j is nonzero only on the rows of unit j's own cell, so a
// kernel reads those rows and skips the off-block zeros.
struct Cells {
  int count;
  int off[kMaxCells + 1];
};

// Fills `out` from `count` widths that must sum to H; false if they do not.
inline bool make_cells(int count, const int* dims, int H, Cells* out) {
  if (count < 1 || count > kMaxCells) return false;
  out->count = count;
  out->off[0] = 0;
  for (int m = 0; m < count; ++m) {
    if (dims[m] < 1) return false;
    out->off[m + 1] = out->off[m] + dims[m];
  }
  for (int m = count + 1; m <= kMaxCells; ++m) out->off[m] = out->off[count];
  return out->off[count] == H;
}

// Rows [k0, k1) of the recurrent weight that feed hidden unit j.
__device__ __forceinline__ void cell_range(const Cells& cells, int j, int& k0,
                                           int& k1) {
  k0 = 0;
  k1 = cells.off[1];
#pragma unroll
  for (int m = 1; m < kMaxCells; ++m) {
    if (m < cells.count && j >= cells.off[m]) {
      k0 = cells.off[m];
      k1 = cells.off[m + 1];
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

}  // namespace ftt
