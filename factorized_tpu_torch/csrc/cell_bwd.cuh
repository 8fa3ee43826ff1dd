// The reverse chain of one LSTM cell of a fused, gate-major,
// block-diagonal recurrence, shared by the encode backward's LSTM pass
// (mfm_encode_bwd.cu) and the recurrences' backward (lstm_bwd.cu).
//
// One block owns one cell (hidden units [k0, k0 + h) of H) and R batch
// rows. It copies the cell's four h x h diagonal blocks of the recurrent
// weight into shared memory once, and walks the reverse steps
// with two block barriers each: (1) the gate math's backward for the
// cell's units and rows, elementwise; (2) dh = dgates @ W_cell^T from
// shared memory. The next step's operands are copied in with cp.async
// while the current step runs. Nothing is read from L2 on the chain but
// those operands, and the cells run side by side as independent blocks.
//
// A cell whose four blocks pass one block's shared memory (the 120-unit
// cell's 225 KiB) is split over a thread-block cluster of C blocks: block
// b holds a run of the cell's 4h gate columns (C = 2: gates [i, f] and [g,
// o]), does the gate math for all h units redundantly (it needs all four
// gates of a unit, and is cheap), and forms a partial dh from its own
// columns. The partials are traded through distributed shared memory and
// added in rank order, block 0 first, so every block and every rerun has
// the same bits: one cluster barrier a step, the partials double-buffered
// by the step's parity. C = 1 is the one-block chain.
//
// A cell past a cluster of 8 (L2 = true, C = 1) reads its weights in
// place from the packed (H, 4H) weight, through L2, with pitch 4H and the
// gate-major column map that load_cell_weights applies: shared memory
// holds only the per-row state. In place rather than a gate-major copy:
// no scratch buffer and no extra launch a call, and a copy would be read
// from L2 all the same. Where even its per-row state passes a block
// (lstm_common.cuh's kStateScratch), that state lives in a slice of
// device memory instead, with the same layout and the same steps.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "lstm_common.cuh"

namespace ftt {

// The gate columns a block of a cluster of C holds: all 4h for C = 1,
// else the 4h split in C runs of a multiple of 4 columns (the last ones
// past 4h are zeros).
__host__ __device__ inline int cell_cols(int h, int C) {
  return C == 1 ? 4 * h : ((4 * h + C - 1) / C + 3) & ~3;
}

// One cell: units [k0, k0 + h); the block holds gate columns [c0, c0 +
// kc) of the cell's 4h; ks lanes share one unit of the dh product and wp
// is the pitch of the weight's rows (kc floats) in shared memory. The
// product reads 16 bytes a lane: a quarter warp (8 lanes) reads 8 / ks
// rows at once, 4 ks floats from each, so the pitch puts those pieces on
// distinct banks (and keeps rows 16-byte aligned). Weights read in place
// (L2): the pitch is 4H and gate q's columns lie gap = H - h further on
// than in shared memory.
struct CellTile {
  int k0, h, ks, wp, c0, kc, gap;
};

template <int C = 1, bool L2 = false>
__host__ __device__ inline CellTile cell_tile(const Cells& cells, int m,
                                              int threads, int rank = 0,
                                              int H = 0) {
  CellTile c;
  c.k0 = cells.off[m];
  c.h = cells.off[m + 1] - c.k0;
  c.ks = lanes_per_output(c.h, threads);
  c.kc = cell_cols(c.h, C);
  c.c0 = C == 1 ? 0 : rank * c.kc;
  c.wp = L2 ? 4 * H : conflict_free_pitch(c.kc, 4 * c.ks < 32 ? 4 * c.ks
                                                               : 32);
  c.gap = L2 ? H - c.h : 0;
  return c;
}

// The cell's weights for a chain: in shared memory at `smem`, or in place
// in the packed W (H, 4H) from row and column k0.
template <bool L2>
__device__ __forceinline__ const float* cell_weights(float* smem,
                                                     const float* W, int H,
                                                     int k0) {
  return L2 ? W + (size_t)k0 * 4 * H + k0 : smem;
}

// A buffer's floats rounded up to 16 bytes, so the next starts aligned.
__host__ __device__ inline int pad4(int floats) { return (floats + 3) & ~3; }

// The layout of dg, the gate gradients of R rows: gate columns in groups
// of four, a group's four columns of R rows contiguous (column jj, row r
// at (jj / 4) dg_group(R) + (jj % 4) R + r), so cell_dh reads a group as R
// float4. From R = 4 on a group is padded by four floats: the ks lanes of
// a unit read ks groups at once, which 4 R floats apart would share their
// banks (a 2-way conflict at R = 4, 4-way at 8); 4 R + 4 apart they do
// not.
__host__ __device__ constexpr int dg_group(int R) {
  return R >= 4 ? 4 * R + 4 : 4 * R;
}

// Column col, row r of dg.
__host__ __device__ constexpr int dg_at(int col, int r, int R) {
  return (col >> 2) * dg_group(R) + (col & 3) * R + r;
}

// The floats of dg's first `cols` columns (a multiple of four).
__host__ __device__ constexpr int dg_floats(int cols, int R) {
  return cols / 4 * dg_group(R);
}

// Shared-memory floats of a block on cell c in a cluster of C: the
// weight, dh, dc and dg (dg over the C blocks' columns; each starting
// 16-byte aligned), two buffers of `op_width` operand floats a row and,
// for C > 1, two partial dh.
__host__ __device__ inline size_t cell_chain_floats(const CellTile& c, int R,
                                                    int op_width, int C) {
  return (size_t)c.h * c.wp + 2 * pad4(c.h * R) +
         (size_t)dg_floats(C * c.kc, R) + (size_t)2 * R * op_width +
         (C > 1 ? 2 * pad4(c.h * R) : 0);
}

// The largest cell_chain_floats over the cells at a cluster of C, in
// bytes: one launch gives every block the same dynamic shared memory.
// C = kWeightsL2: the per-row state alone, the weights read from L2.
inline size_t cell_chain_bytes(const Cells& cells, int R, int threads,
                               int op_width_per_unit, int C) {
  size_t most = 0;
  for (int m = 0; m < cells.count; ++m) {
    CellTile c = cell_tile(cells, m, threads);
    c.kc = cell_cols(c.h, C == kWeightsL2 ? 1 : C);
    c.wp = conflict_free_pitch(c.kc, 4 * c.ks < 32 ? 4 * c.ks : 32);
    size_t f = cell_chain_floats(c, R, op_width_per_unit * c.h,
                                 C == kWeightsL2 ? 1 : C);
    if (C == kWeightsL2) f -= (size_t)c.h * c.wp;
    if (f > most) most = f;
  }
  return most * sizeof(float);
}

// Rows [row0, row0 + R) of step s of a (t, n, width) tensor, columns
// [col0, col0 + count), into feature-major dst [count][R], asynchronously
// (S: by plain copies into the state's scratch); zeros where src is null
// or past n.
template <int R, bool S = false>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int s, int n, int width,
                                                int col0, int count, int row0,
                                                int tid, int nthr) {
  for (int i = tid; i < R * count; i += nthr) {
    const int r = i / count, k = i - r * count, row = row0 + r;
    float* d = dst + k * R + r;
    if (src != nullptr && row < n)
      copy4<S>(d, src + ((size_t)s * n + row) * width + col0 + k);
    else
      *d = 0.0f;
  }
}

// Gate columns [c0, c0 + kc) of the cell's four diagonal blocks of W
// (H, 4H), asynchronously: w[k wp + jj] = W[k0 + k][q H + k0 + j] for the
// cell's column c0 + jj = q h + j, each gate's part of a row copied as one
// run; columns past 4h are zeros. The forward chains (cell_fwd.cuh) take
// the same layout.
__device__ __forceinline__ void load_cell_weights(float* w, const float* W,
                                                  int H, int k0, int h,
                                                  int c0, int kc, int wp,
                                                  int tid, int nthr) {
  for (int q = 0; q < 4; ++q) {
    const int lo = q * h > c0 ? q * h : c0;
    const int hi = (q + 1) * h < c0 + kc ? (q + 1) * h : c0 + kc;
    if (lo < hi)
      copy_rows_async(w + lo - c0, wp,
                      W + (size_t)k0 * 4 * H + q * H + k0 + lo - q * h,
                      (size_t)4 * H, h, hi - lo, tid, nthr);
  }
  const int live = 4 * h - c0 < kc ? (4 * h > c0 ? 4 * h - c0 : 0) : kc;
  for (int i = tid; i < h * (kc - live); i += nthr) {
    const int k = i / (kc - live);
    w[k * wp + live + i - k * (kc - live)] = 0.0f;
  }
}

__device__ __forceinline__ void load_cell_weights(float* w, const float* W,
                                                  int H, const CellTile& c,
                                                  int tid, int nthr) {
  load_cell_weights(w, W, H, c.k0, c.h, c.c0, c.kc, c.wp, tid, nthr);
}

// One step's operands in shared memory, feature-major [feature][R].
struct CellStep {
  float* g;    // 4h: the pre-activation gates
  float* c;    // h: the cell state of the step
  float* cp;   // h: the cell state before it (zeros before step 0)
  float* dcs;  // 2h: cStar's gradient into cp, then into c; null: none
};

// The operands laid out from `base`: g, c, cp, then dcs where `with_dcs`.
// A kernel keeps two such buffers and picks one by the step's parity
// through `base`, so no array of them is indexed at run time (which would
// put it on the stack).
__device__ __forceinline__ CellStep cell_step(float* base, int h, int R,
                                              bool with_dcs) {
  CellStep op;
  op.g = base;
  op.c = base + 4 * h * R;
  op.cp = op.c + h * R;
  op.dcs = with_dcs ? op.cp + h * R : nullptr;
  return op;
}

// (1) The gate math's backward for the cell's units and R rows, from the
// carried dh and dc: writes dg (4h columns, dg_at) and the rows' dgates into
// out[slot] of a (*, n, 4H) tensor (in a cluster of C, block 0 writes
// them), and moves dc to the step before.
template <int R, int C = 1>
__device__ __forceinline__ void cell_gate_bwd(const CellStep& op,
                                              const float* dh, float* dc,
                                              float* dg, float* out,
                                              int slot, int n, int H,
                                              const CellTile& c, int row0,
                                              int tid, int nthr,
                                              int rank = 0) {
  const int h = c.h;
  const bool store = C == 1 || rank == 0;
  for (int i = tid; i < h * R; i += nthr) {
    const int j = i / R, r = i - j * R, row = row0 + r;
    const float si = sigmoid(op.g[j * R + r]);
    const float sf = sigmoid(op.g[(h + j) * R + r]);
    const float tg = tanhf(op.g[(2 * h + j) * R + r]);
    const float so = sigmoid(op.g[(3 * h + j) * R + r]);
    const float tc = tanhf(op.c[j * R + r]), cp = op.cp[j * R + r];
    const float dhv = dh[j * R + r];
    float dcv = dc[j * R + r];
    if (op.dcs != nullptr) dcv += op.dcs[(h + j) * R + r];
    dcv = dcv + dhv * so * (1.0f - tc * tc);
    const float di = dcv * tg * si * (1.0f - si);
    const float df = dcv * cp * sf * (1.0f - sf);
    const float dgg = dcv * si * (1.0f - tg * tg);
    const float dov = dhv * tc * so * (1.0f - so);
    dg[dg_at(j, r, R)] = di;
    dg[dg_at(h + j, r, R)] = df;
    dg[dg_at(2 * h + j, r, R)] = dgg;
    dg[dg_at(3 * h + j, r, R)] = dov;
    if (store && row < n) {
      float* d = out + ((size_t)slot * n + row) * 4 * H + c.k0 + j;
      d[0] = di;
      d[H] = df;
      d[2 * H] = dgg;
      d[3 * H] = dov;
    }
    float next = dcv * sf;
    if (op.dcs != nullptr) next += op.dcs[j * R + r];
    dc[j * R + r] = next;
  }
}

// The R values at src (feature-major, one feature's rows) in as few
// shared-memory loads as their alignment allows: the buffers holding them
// start on 16 bytes and put each feature's rows R floats apart.
template <int R>
__device__ __forceinline__ void load_row(float (&v)[R], const float* src) {
  if (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + r);
      v[r] = q.x;
      v[r + 1] = q.y;
      v[r + 2] = q.z;
      v[r + 3] = q.w;
    }
  } else if (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    v[0] = q.x;
    v[R - 1] = q.y;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[r];
  }
}

// (2) dh[k][r] = sum over the block's gate columns c0 + jj of
// dg[c0 + jj][r] * w[k][jj] (all 4h for C = 1), plus add[k][r] where add
// is given (for a cluster, this block's partial, added up by cluster_dh):
// ks neighbouring lanes share a unit, each reading four consecutive
// columns at a time (16 bytes of w and of dg) into four partial sums, and
// shuffles add the lanes' sums; every sum in a fixed order, so a rerun
// gives the same bits.
template <int R, int C = 1, bool L2 = false>
__device__ __forceinline__ void cell_dh(const float* w, const float* dg,
                                        const float* add, float* dh,
                                        const CellTile& c, int lane,
                                        int warp, int nwarp) {
  const int items = c.h * c.ks, K = C == 1 ? 4 * c.h : c.kc, ks = c.ks;
  if (C > 1) dg += dg_floats(c.c0, R);
  for (int base = warp * 32; base < items; base += nwarp * 32) {
    const int item = base + lane, k = item / ks, slice = item - k * ks;
    float p[4][R];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) p[u][r] = 0.0f;
    if (item < items) {
      const float* wk = w + k * c.wp;
      for (int jj = 4 * slice; jj < K; jj += 4 * ks) {
        float wu[4];
        if (L2) {
          // four columns of the cell, each through the gate-major map
          // (K = 4h is a multiple of 4, so all four are the cell's)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            wu[u] = __ldg(wk + jj + u + ((jj + u) / c.h) * c.gap);
        } else {
          const float4 wv = *reinterpret_cast<const float4*>(wk + jj);
          wu[0] = wv.x;
          wu[1] = wv.y;
          wu[2] = wv.z;
          wu[3] = wv.w;
        }
        float g[4 * R];
        load_row<4 * R>(g, dg + dg_floats(jj, R));
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < R; ++r)
            p[u][r] = fmaf(g[u * R + r], wu[u], p[u][r]);
      }
    }
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = (p[0][r] + p[1][r]) + (p[2][r] + p[3][r]);
    for (int o = 1; o < ks; o <<= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    }
    if (item < items && slice == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        dh[k * R + r] = add != nullptr ? acc[r] + add[k * R + r] : acc[r];
    }
  }
}

// dh = the cluster's partials (`part` in every block, [h][R]) added in
// rank order, block 0 first, plus add[k][r] where add is given; after a
// cluster barrier, so every peer's partial of the step is written.
template <int C, int R>
__device__ __forceinline__ void cluster_dh(float* dh, const float* part,
                                           const float* add, int h, int tid,
                                           int nthr) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const float* peer[C];
#pragma unroll
  for (int b = 0; b < C; ++b)
    peer[b] = cluster.map_shared_rank(const_cast<float*>(part), b);
  for (int i = tid; i < h * R; i += nthr) {
    float v = peer[0][i];
#pragma unroll
    for (int b = 1; b < C; ++b) v += peer[b][i];
    dh[i] = add != nullptr ? v + add[i] : v;
  }
}

}  // namespace ftt
