// The forward chain of one LSTM cell of a fused, gate-major,
// block-diagonal recurrence (the encode forward's LSTM pass,
// mfm_encode_fwd.cu, and the recurrences' forward, lstm_fwd.cu), the
// counterpart of cell_bwd.cuh.
//
// One block owns one cell (hidden units [k0, k0 + h) of H) and R batch
// rows. It copies the cell's four h x h diagonal blocks of the recurrent
// weight into shared memory once (cell_bwd.cuh's layout) and walks the
// steps with two barriers each: (1) the gates of the block's columns,
// xp_t + h @ W_cell, from shared memory, kg groups of threads each
// summing a share of the depth; (2) the cell update for all units and
// rows, elementwise, adding each column's group sums in group order. The
// next step's xp is copied in with cp.async while the current step runs.
//
// A cell past one block's shared memory splits its gate columns over a
// thread-block cluster as the backward does (cell_cols): each block forms
// its columns' gates whole (a column's depth is never split across
// blocks) and, after one cluster barrier a step, reads the other blocks'
// columns through distributed shared memory for its redundant update;
// the gates are double-buffered by the step's parity.
//
// A cell past a cluster of 8 (L2 = true, C = 1) reads its weights in
// place from the packed (H, 4H) weight through L2, as cell_bwd.cuh's
// chains do: consecutive threads read consecutive columns of one row.
// Where even its per-row state passes a block (lstm_common.cuh's
// kStateScratch), that state lives in a slice of device memory instead,
// with the same layout and the same steps.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cell_bwd.cuh"
#include "lstm_common.cuh"

namespace ftt {

// One cell: units [k0, k0 + h), gate columns [c0, c0 + kc) of the cell's
// 4h; kg groups split the product's depth; wp the weight rows' pitch (a
// warp reads consecutive columns of one row). Weights read in place (L2):
// the pitch is 4H and gate q's columns lie gap = H - h further on.
struct FwdTile {
  int k0, h, c0, kc, kg, wp, gap;
};

template <int C = 1, bool L2 = false>
__host__ __device__ inline FwdTile fwd_tile(const Cells& cells, int m,
                                            int threads, int rank = 0,
                                            int H = 0) {
  FwdTile c;
  c.k0 = cells.off[m];
  c.h = cells.off[m + 1] - c.k0;
  c.kc = cell_cols(c.h, C);
  c.c0 = C == 1 ? 0 : rank * c.kc;
  c.kg = lanes_per_output(c.kc, threads);
  while (c.kg > 1 && c.kg > c.h) c.kg >>= 1;
  c.wp = L2 ? 4 * H : c.kc;
  c.gap = L2 ? H - c.h : 0;
  return c;
}

// Shared-memory floats of a block on cell c in a cluster of C: the
// weight, h and c (16-byte aligned), two [4h][R] buffers of xp, and the
// group sums of the gates (two for a cluster).
__host__ __device__ inline size_t fwd_chain_floats(const FwdTile& c, int R,
                                                   int C) {
  return (size_t)c.h * c.wp + 2 * pad4(c.h * R) + (size_t)2 * 4 * c.h * R +
         (size_t)(C > 1 ? 2 : 1) * c.kg * c.kc * R;
}

// The largest fwd_chain_floats over the cells at a cluster of C, in
// bytes; C = kWeightsL2: the per-row state alone.
inline size_t fwd_chain_bytes(const Cells& cells, int R, int threads,
                              int C) {
  const int CC = C == kWeightsL2 ? 1 : C;
  size_t most = 0;
  for (int m = 0; m < cells.count; ++m) {
    FwdTile c = fwd_tile(cells, m, threads);
    c.kc = cell_cols(c.h, CC);
    c.kg = lanes_per_output(c.kc, threads);
    while (c.kg > 1 && c.kg > c.h) c.kg >>= 1;
    c.wp = c.kc;
    size_t f = fwd_chain_floats(c, R, CC);
    if (C == kWeightsL2) f -= (size_t)c.h * c.wp;
    if (f > most) most = f;
  }
  return most * sizeof(float);
}

// The cell's four gates of step s of xp, rows [row0, row0 + R), into
// feature-major dst [4h][R] (column q h + j), asynchronously (S: by plain
// copies into the state's scratch); zeros past n. Step s, row r's 4H
// gates start at xp + s xs + r xr: (t, n, 4H) with xs = n 4H and xr = 4H,
// or one broadcast (4H) with both 0.
template <int R, bool S = false>
__device__ __forceinline__ void load_gates_async(float* dst, const float* xp,
                                                 int s, size_t xs, int xr,
                                                 int n, int H,
                                                 const FwdTile& c, int row0,
                                                 int tid, int nthr) {
  for (int q = 0; q < 4; ++q) {
    float* d = dst + q * c.h * R;
    for (int i = tid; i < c.h * R; i += nthr) {
      const int j = i / R, r = i - j * R, row = row0 + r;
      if (row < n)
        copy4<S>(d + i, xp + s * xs + (size_t)row * xr + q * H + c.k0 + j);
      else
        d[i] = 0.0f;
    }
  }
}

// (1) Group g's sum of gate column c0 + jj over the depth [h g / kg,
// h (g + 1) / kg): part[(g kc + jj) R + r], group 0 starting from xp (x,
// feature-major [4h][R]); every sum in order of k.
template <int R, bool L2 = false>
__device__ __forceinline__ void cell_gates_fwd(const float* w,
                                               const float* hs,
                                               const float* x, float* part,
                                               const FwdTile& c, int tid,
                                               int nthr) {
  const int items = c.kg * c.kc;
  for (int item = tid; item < items; item += nthr) {
    const int g = item / c.kc, jj = item - g * c.kc, col = c.c0 + jj;
    const int kb = c.h * g / c.kg, ke = c.h * (g + 1) / c.kg;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = g == 0 && col < 4 * c.h ? x[col * R + r] : 0.0f;
    const float* wj = w + jj + (L2 ? (jj / c.h) * c.gap : 0);
#pragma unroll 4
    for (int k = kb; k < ke; ++k) {
      const float wv = L2 ? __ldg(wj + k * c.wp) : wj[k * c.wp];
      float hv[R];
      load_row<R>(hv, hs + k * R);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(hv[r], wv, acc[r]);
    }
    float* p = part + (size_t)item * R;
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = acc[r];
  }
}

// (2) The cell update for all h units and R rows: each gate the group
// sums of its column (from the block of the cluster that holds it) added
// in group order; writes h and c, and where `store` (one block of a
// cluster) each of allc and allh (step s of (t, n, H)) and gates (step s
// of (t, n, 4H), the pre-activations) that is given.
template <int C, int R>
__device__ __forceinline__ void cell_update_fwd(const float* part, float* hs,
                                                float* cs, const FwdTile& c,
                                                float* allh, float* allc,
                                                float* gates, int s, int n,
                                                int H, int row0, bool store,
                                                int tid, int nthr) {
  for (int i = tid; i < c.h * R; i += nthr) {
    const int j = i / R, r = i - j * R;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = q * c.h + j;
      const int owner = C == 1 ? 0 : col / c.kc;
      const int local = col - owner * c.kc;
      const float* src = part;
      if (C > 1)
        src = cooperative_groups::this_cluster().map_shared_rank(
            const_cast<float*>(part), owner);
      float v = src[local * R + r];
      for (int k = 1; k < c.kg; ++k) v += src[(k * c.kc + local) * R + r];
      g[q] = v;
    }
    const float cn = sigmoid(g[1]) * cs[i] + sigmoid(g[0]) * tanhf(g[2]);
    const float hn = sigmoid(g[3]) * tanhf(cn);
    cs[i] = cn;
    hs[i] = hn;
    const int row = row0 + r;
    if (store && row < n) {
      const size_t at = ((size_t)s * n + row) * H + c.k0 + j;
      if (allc != nullptr) allc[at] = cn;
      if (allh != nullptr) allh[at] = hn;
      if (gates != nullptr) {
        float* gt = gates + ((size_t)s * n + row) * 4 * H + c.k0 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) gt[q * H] = g[q];
      }
    }
  }
}

}  // namespace ftt
