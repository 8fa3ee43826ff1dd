// Fused MFM encode, forward, eval and train: three passes along the
// step's independent chains.
//
// Replaces: factorized_tpu/ops/pallas_mfn.py::_fwd_kernel (reached through
// _fwd_call, mfm_encode_pallas and its custom_vjp forward _encode_fwd):
// the eval variant (train=False, with_res=False) and the train variants
// (dropout masks; with_res, the residuals the backward reads). With the
// residuals split into ten tensors it also replaces
// scripts/bwd_residual_probe.py::_fwd_res_kernel; with one buffer it is the
// same function as that script's _fwd_cat_kernel.
//
// What it computes, for each of the t steps of a (t, n, 4H) gate-major
// input projection xp (pallas_mfn.py::_step_fwd): the six fused LSTM cells
// [enc_l, enc_a, enc_v, mfn_l, mfn_a, mfn_v] (gates = xp_t + h @ wh, wh
// block-diagonal and gate-major); cStar = [c_prev, c_new][:, z_tot:]; the
// att1 relu-MLP with a softmax over cStar; attended = att * cStar; the att2
// tanh proposal chat; the gamma fc1 on [attended, mem] with two sigmoid
// heads; and mem = g1 * mem + g2 * chat. It returns h_last (n, H) and
// mem_last (n, mem). In train mode the relu outputs of the att1, att2 and
// gamma fc1s are multiplied by the scaled keep-masks (t, n, s1 + s2 + s3 +
// s4), and with residuals it also writes allh, allc (t, n, H), allmem (t,
// n, mem) and the ten fields of the JAX package's _RES_NAMES: att, r1,
// kg1, r2, kg2, r3, kg3, chat, g1, g2, with r* the post-dropout
// activations and kg* = mask * (u > 0), through the residual-layout table
// (mfm_res.cuh): one (t, n, R) buffer, as the training path keeps them, or
// ten (t, n, width) tensors.
//
// What bounds it on an H100: operations. At the serving batch (n = 256,
// t = 20, best_acc_mosi_config) the useful work is 3.9 GFLOP in float32
// against about 29 MB of traffic: about 59 us at 67 TFLOP/s. At the
// training batch (n = 32) 0.49 GFLOP, about 7 us; the residuals add 5.9 MB
// of writes, under 2 us. In practice the serial chains bound it.
//
// What the design does about it: the TPU kernel's one chain of seven
// dependent phases a step is three passes, and only two of them carry
// anything from step to step. The LSTM cells never read the memory; the
// attention branch needs only cStar; only the memory's half of the gamma
// product, the heads and the update are serial in the memory.
//
// (1) cell_chains_fwd_kernel, serial over t: one block per (cell, row
//     tile), the cell's diagonal blocks of wh in shared memory (the
//     88-unit cell's 124 KB), xp_t copied in with cp.async a step ahead
//     (cell_fwd.cuh). Writes allc (into scratch for the eval variant),
//     allh with residuals, and h_last. A cell past one block splits over
//     a thread-block cluster; past a cluster of 8 the chain reads its
//     weights in place from L2, and past a block's per-row state too
//     (more than about 518 units in the 8-row eval chains, 2,075 in the
//     2-row train chains) keeps that state in a slice of device memory a
//     block (lstm_common.cuh's kStateScratch).
// (2) The attention branch over every (step, row) pair at once (no
//     carry), as product_fwd_kernel in tiles and softmax_fwd_kernel:
//     cStar from allc; u1 = cStar @ a1w1 + b, r1 and kg1; the logits and
//     their softmax, att; attended; u2, r2 and kg2; pu3 = attended @
//     gw1[:M2] + gb1, the gamma product's first part, into scratch; chat =
//     tanh(r2 @ a2w2 + b). Fixed-order tiled products, as the backward's
//     attention pass; a depth past one block's staging (M2 past about
//     900) is summed in chunks.
// (3) mem_chain_fwd_kernel, serial over t: one block per row tile with
//     gw1[M2:], g1w2 and g2w2 in shared memory (128 KiB at the pinned
//     widths, transposed so that a few lanes share an output's depth and
//     shuffles add their sums in a fixed order): u3 = pu3_t + mem @
//     gw1[M2:], r3 and kg3; the two heads; mem = g1 * mem + g2 * chat_t,
//     the next step's pu3, chat and masks copied in with cp.async. Writes
//     r3, kg3, g1, g2, allmem and mem_last. Past one block's shared memory
//     its columns split over a cluster, the peers trading r3 and the
//     memory through distributed shared memory; past a cluster of 8 the
//     chain reads its weights in place from L2, and where its per-row
//     state passes a block too (R (4 mem + 5 (s3 + s4)) floats: mem past
//     about 7,000 at R = 2) keeps it in device memory (kStateScratch).
//
// Float32 on the CUDA cores, every sum in a fixed order: no atomics, the
// same bits on every run. Each chain's plan (a cluster, its weights from
// L2, or with them its state in device memory) is made from the widths
// before any pass starts; no width is refused.
//
// Lanes: K problems of one shape (K seeds' or configs' encodes) in one
// launch of each kernel, whatever K: lane 0's arguments and each array's
// floats from one lane's to the next (0 where the lanes share it), lane
// k's blocks those of blockIdx.z = k, which add k strides to each pointer
// (FwdLanes). A lane's blocks do the one-lane launch's arithmetic, so lane
// k's bits do not depend on K. The chains' batch rows a block are chosen
// on the host from K and n (cuda_mfn.fwd_plan) among the instantiated
// counts, and each row's sums keep their order at every count: a
// product's split over a block's threads (cell_fwd.cuh's kg, the memory
// chain's lanes an output) follows the columns and the threads, not the
// rows.

#include <cuda_runtime.h>
#include <math.h>

#include "cell_fwd.cuh"
#include "lstm_common.cuh"
#include "mfm_res.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;
// Batch rows a block of the LSTM chains and of the memory chain takes:
// one of these instantiated counts, chosen on the host (cuda_mfn.fwd_plan,
// which lists the same counts).
constexpr int kCellRowCounts[] = {2, 4, 8, 16};
constexpr int kMemRowCounts[] = {1, 2, 4, 8, 16};
// The counts one lane takes, at any batch: the fastest measured by
// perf_probe.py (PERF.md), without residuals at the serving batch (n =
// 256) and with them at the training batch (n = 32). perf_probe.py rows
// sweeps them by rebuilding with -D overrides of these macros.
#ifndef FTT_EVAL_CELL_ROWS
#define FTT_EVAL_CELL_ROWS 8
#endif
#ifndef FTT_EVAL_MEM_ROWS
#define FTT_EVAL_MEM_ROWS 2
#endif
#ifndef FTT_TRAIN_CELL_ROWS
#define FTT_TRAIN_CELL_ROWS 2
#endif
#ifndef FTT_TRAIN_MEM_ROWS
#define FTT_TRAIN_MEM_ROWS 1
#endif
constexpr int kEvalCellRows = FTT_EVAL_CELL_ROWS;
constexpr int kEvalMemRows = FTT_EVAL_MEM_ROWS;
constexpr int kTrainCellRows = FTT_TRAIN_CELL_ROWS;
constexpr int kTrainMemRows = FTT_TRAIN_MEM_ROWS;
static_assert(listed(kCellRowCounts, kEvalCellRows) &&
                  listed(kCellRowCounts, kTrainCellRows) &&
                  listed(kMemRowCounts, kEvalMemRows) &&
                  listed(kMemRowCounts, kTrainMemRows),
              "one lane's rows are instantiated counts");

struct EncodeArgs {
  const float* xp;     // (t, n, 4H)
  const float* masks;  // (t, n, S) or null: every site the identity
  const float* wh;     // (H, 4H)
  const float* a1w1;
  const float* a1b1;
  const float* a1w2;
  const float* a1b2;
  const float* a2w1;
  const float* a2b1;
  const float* a2w2;
  const float* a2b2;
  const float* gw1;
  const float* gb1;
  const float* g1w2;
  const float* g1b2;
  const float* g2w2;
  const float* g2b2;
  float* h_last;    // (n, H)
  float* mem_last;  // (n, mem)
  float* allh;      // (t, n, H), or null when no residuals are written
  float* allc;      // (t, n, H): the output, or scratch without residuals
  float* allmem;    // (t, n, mem), or null
  ResTable res;     // the ten residual fields (every entry null without)
  float* pu3;       // (t, n, s3 + s4) scratch: pass (2) to pass (3)
  float* work;      // (t, n, M2) scratch: the logits, then attended
  // r1, r2 and chat: the residual fields, or scratch without residuals
  ResEntry r1, r2, chat;
  long long* clocks;  // the per-phase probe's buffer, or null
  // kStateScratch: the LSTM chains' and the memory chain's state slices
  float* cell_state;
  size_t cell_slice;
  float* mem_state;
  size_t mem_slice;
  int t, n, H, z_tot, mem, s1, s2, s3, s4, m2;
  Cells cells;
};

// The lane strides of the forward's arrays: the launcher's lane_strides
// order (xp, masks, the 15 weights, h_last, mem_last, allh, allc, allmem,
// the ten residual pointers), then the scratch's carvings (pu3, work) and
// r1, r2 and chat (the residual fields' strides, or the scratch's).
enum FwdLane {
  kLaneXp,
  kLaneMasks,
  kLaneWeights,
  kLaneHLast = kLaneWeights + 15,
  kLaneMemLast,
  kLaneAllh,
  kLaneAllc,
  kLaneAllmem,
  kLaneRes,
  kLanePu3 = kLaneRes + kResFields,
  kLaneWork,
  kLaneR1,
  kLaneR2,
  kLaneChat,
  kFwdLanes
};

// Every kernel's argument: lane 0's arguments and the lane strides.
struct FwdLanes {
  EncodeArgs a;
  long long stride[kFwdLanes];
};

using Kernel = void (*)(FwdLanes);

// This block's lane's arguments (blockIdx.z = k): lane 0's with k strides
// added to each pointer (a null one has stride 0 and stays null). The cell
// table is read from `la.a.cells`, in place: a block indexes it by its
// cell.
__device__ __forceinline__ EncodeArgs lane_args(const FwdLanes& la) {
  EncodeArgs a = la.a;
  const long long z = blockIdx.z;
  const long long* s = la.stride;
  a.xp += z * s[kLaneXp];
  a.masks += z * s[kLaneMasks];
  a.wh += z * s[kLaneWeights];
  a.a1w1 += z * s[kLaneWeights + 1];
  a.a1b1 += z * s[kLaneWeights + 2];
  a.a1w2 += z * s[kLaneWeights + 3];
  a.a1b2 += z * s[kLaneWeights + 4];
  a.a2w1 += z * s[kLaneWeights + 5];
  a.a2b1 += z * s[kLaneWeights + 6];
  a.a2w2 += z * s[kLaneWeights + 7];
  a.a2b2 += z * s[kLaneWeights + 8];
  a.gw1 += z * s[kLaneWeights + 9];
  a.gb1 += z * s[kLaneWeights + 10];
  a.g1w2 += z * s[kLaneWeights + 11];
  a.g1b2 += z * s[kLaneWeights + 12];
  a.g2w2 += z * s[kLaneWeights + 13];
  a.g2b2 += z * s[kLaneWeights + 14];
  a.h_last += z * s[kLaneHLast];
  a.mem_last += z * s[kLaneMemLast];
  a.allh += z * s[kLaneAllh];
  a.allc += z * s[kLaneAllc];
  a.allmem += z * s[kLaneAllmem];
#pragma unroll
  for (int f = 0; f < kResFields; ++f) a.res.f[f].ptr += z * s[kLaneRes + f];
  a.pu3 += z * s[kLanePu3];
  a.work += z * s[kLaneWork];
  a.r1.ptr += z * s[kLaneR1];
  a.r2.ptr += z * s[kLaneR2];
  a.chat.ptr += z * s[kLaneChat];
  return a;
}

// ------------------------------------------------------ (1) LSTM chains

// blockIdx.y is the cell, blockIdx.x / C the row tile and the rank in the
// cluster of C its share of the cell's gate columns. L2: the weights read
// in place (C = 1); S: with them the state in the block's scratch slice
// (kStateScratch).
template <int R, int C, bool L2, bool S>
__device__ __forceinline__ void cell_chains_fwd(const EncodeArgs& a,
                                                const Cells& cells) {
  static_assert(!S || (L2 && C == 1), "the scratch plan reads from L2");
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const FwdTile c = fwd_tile<C, L2>(cells, blockIdx.y, blockDim.x, rank,
                                    a.H);
  const int h = c.h, H = a.H;
  const float* const w = cell_weights<L2>(smem, a.wh, H, c.k0);
  float* const hs = state_base<S>(smem, a.cell_state, a.cell_slice) +
                    (L2 ? 0 : h * c.wp);  // [h][R]
  float* const cs = hs + pad4(h * R);     // [h][R]
  float* const xb = cs + pad4(h * R);     // two [4h][R]: step s's at s & 1
  float* const part = xb + 8 * h * R;     // [kg kc][R], two for a cluster
  const int part_floats = c.kg * c.kc * R;
  const int row0 = (blockIdx.x / C) * R;
  const int tid = threadIdx.x, nthr = blockDim.x;

  if (!L2)
    load_cell_weights(smem, a.wh, H, c.k0, h, c.c0, c.kc, c.wp, tid, nthr);
  for (int i = tid; i < h * R; i += nthr) hs[i] = cs[i] = 0.0f;
  const size_t xs = (size_t)a.n * 4 * H;
  load_gates_async<R, S>(xb, a.xp, 0, xs, 4 * H, a.n, H, c, row0, tid,
                         nthr);
  cp_async_wait_all();
  __syncthreads();
  FTT_STAMP(a.clocks, kClockCellChainsFwd, 0, 0);

  for (int s = 0; s < a.t; ++s) {
    if (s + 1 < a.t)
      load_gates_async<R, S>(xb + ((s + 1) & 1) * 4 * h * R, a.xp, s + 1,
                             xs, 4 * H, a.n, H, c, row0, tid, nthr);
    float* const p = part + (C > 1 ? (s & 1) * part_floats : 0);
    cell_gates_fwd<R, L2>(w, hs, xb + (s & 1) * 4 * h * R, p, c, tid,
                          nthr);
    cluster_barrier<C>();
    FTT_STAMP(a.clocks, kClockCellChainsFwd, s + 1, 0);
    cell_update_fwd<C, R>(p, hs, cs, c, a.allh, a.allc, nullptr, s, a.n, H,
                          row0, C == 1 || rank == 0, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    FTT_STAMP(a.clocks, kClockCellChainsFwd, s + 1, 1);
  }

  if (rank == 0) {
    for (int i = tid; i < R * h; i += nthr) {
      const int r = i / h, j = i - r * h, row = row0 + r;
      if (row < a.n) a.h_last[(size_t)row * H + c.k0 + j] = hs[j * R + r];
    }
  }
  // no block leaves while a peer may still read its gates
  if (C > 1) cluster_barrier<C>();
}

// Each kernel of the forward is instantiated for lanes by stride (Z) and,
// at one lane's row counts, for one lane's arguments read in place (the
// launch as it was before lanes: no copy of the arguments, so the same
// code as a model without lanes).
template <int R, int C, bool L2, bool S = false, bool Z = true>
__global__ void __launch_bounds__(kMaxThreads)
    cell_chains_fwd_kernel(const __grid_constant__ FwdLanes la) {
  if (Z)
    cell_chains_fwd<R, C, L2, S>(lane_args(la), la.a.cells);
  else
    cell_chains_fwd<R, C, L2, S>(la.a, la.a.cells);
}

// --------------------------------------------------- (2) the attention
//
// Over all t n flat rows rr = s n + b at once (no carry), in five
// launches: u1 and its dropout site r1; the logits; the softmax, att and
// attended; u2 and its site r2 beside pu3; chat. Each product is A @ W in
// kTile x kTile output tiles: a block copies its tile's rows of A and
// columns of W, the whole depth, into shared memory at once with
// cp.async; kSplit groups of 64 threads each take a quarter of the
// depth, each thread summing a 4 x 4 tile of outputs in order of k, and
// the groups' partial tiles are added in a fixed order, then the bias.
// Over lanes, where a product's K t n rows make at least kWideBlocks wide
// tiles, a block takes kWideTile x kWideTile outputs where they fit at one
// lane's chunks: each thread sums an 8 x 8 tile, four times the
// multiply-adds of a 4 x 4 tile for twice the shared-memory reads (W's 8
// columns as two 16-byte reads); each output's sum is the same (its
// group's share of the depth in order of k, the groups added in order),
// so the same bits. Fewer wide tiles leave SMs idle (perf_probe.py lanes,
// PERF.md).

constexpr int kTile = 32;      // output tile: kTile x kTile
constexpr int kWideTile = 64;  // over lanes: kWideTile x kWideTile
constexpr int kWideBlocks = 264;  // two an SM of an H100's 132
constexpr int kSplit = 4;  // groups of 8 x 8 threads, a T / 8 square each
constexpr int kProductThreads = 64 * kSplit;

enum Product { kProdU1, kProdLogits, kProdU2Pu3, kProdChat, kProducts };

// A product's A operand (rows of row stride lda; cStar is built from
// allc) and its weights: W (K, N0) for the first N0 output columns and W1
// (K, N - N0) for the rest, row-major with row strides ld0 and ld1.
struct ProductSpec {
  const float* a;
  int lda, K;
  const float* w0;
  const float* w1;
  int ld0, ld1, N0, N;
};

__host__ __device__ inline ProductSpec product_spec(const EncodeArgs& a,
                                                   int id) {
  const int s34 = a.s3 + a.s4;
  switch (id) {
    case kProdU1:  // cStar @ a1w1
      return {nullptr, 0, a.m2, a.a1w1, nullptr, a.s1, 0, a.s1, a.s1};
    case kProdLogits:  // r1 @ a1w2
      return {res_row(a.r1, 0), a.r1.stride, a.s1, a.a1w2, nullptr, a.m2,
              0, a.m2, a.m2};
    case kProdU2Pu3:  // attended @ [a2w1 | gw1[:M2]]
      return {a.work, a.m2, a.m2, a.a2w1, a.gw1, a.s2, s34, a.s2,
              a.s2 + s34};
    default:  // r2 @ a2w2
      return {res_row(a.r2, 0), a.r2.stride, a.s2, a.a2w2, nullptr, a.mem,
              0, a.mem, a.mem};
  }
}

// Rows of the staged A in shared memory: a warp reads 8 rows at once, 4
// consecutive floats from each (conflict_free_pitch); W's staged rows are
// kTile wide.
__host__ __device__ inline int product_pitch(int K) {
  return conflict_free_pitch(K, 4);
}

__host__ __device__ inline size_t product_floats(int K, int T = kTile) {
  const size_t f = (size_t)T * product_pitch(K) + (size_t)K * T;
  const size_t parts = (size_t)kSplit * T * T;
  return f > parts ? f : parts;
}

// The fewest equal depth chunks [K i / nc, K (i + 1) / nc) whose staged
// operands fit a block of kTile outputs: one up to a depth of about 900
// floats, more for the attention's products at the widest widths (M2
// past 900). The depth's split between the groups follows the chunks, so
// a wide tile takes the same chunks.
__host__ __device__ inline int product_chunks(int K) {
  int nc = 1;
  while (product_floats((K + nc - 1) / nc) * sizeof(float) >
         (size_t)kMaxSmemBytes)
    ++nc;
  return nc;
}

// cStar of flat row rr: c of the step before past z_tot (zeros before
// step 0), then c of the step past z_tot.
__device__ __forceinline__ float cstar_at(const EncodeArgs& a, int rr,
                                          int k) {
  const int M = a.H - a.z_tot;
  if (k >= M) return a.allc[(size_t)rr * a.H + a.z_tot + k - M];
  return rr >= a.n ? a.allc[(size_t)(rr - a.n) * a.H + a.z_tot + k] : 0.0f;
}

// A dropout site's relu for output (m, n): writes r = relu(u) * mask into
// `r` and, with residuals, m * (u > 0) into kg.
__device__ __forceinline__ void site(const EncodeArgs& a, int m, int n,
                                     float u, int mask_col,
                                     const ResEntry& r, int kg_field) {
  const int S = a.s1 + a.s2 + a.s3 + a.s4;
  const float mk =
      a.masks != nullptr ? a.masks[(size_t)m * S + mask_col + n] : 1.0f;
  res_row(r, m)[n] = fmaxf(u, 0.0f) * mk;
  if (a.res.f[kg_field].ptr != nullptr)
    res_row(a.res.f[kg_field], m)[n] = u > 0.0f ? mk : 0.0f;
}

// Where output (m, n) of product P goes, v its sum without the bias.
template <int P>
__device__ __forceinline__ void product_out(const EncodeArgs& a, int m,
                                            int n, float v) {
  if (P == kProdU1) {
    site(a, m, n, v + __ldg(a.a1b1 + n), 0, a.r1, kKg1);
  } else if (P == kProdLogits) {
    a.work[(size_t)m * a.m2 + n] = v + __ldg(a.a1b2 + n);
  } else if (P == kProdU2Pu3) {
    if (n < a.s2) {
      site(a, m, n, v + __ldg(a.a2b1 + n), a.s1, a.r2, kKg2);
    } else {
      const int j = n - a.s2;
      a.pu3[(size_t)m * (a.s3 + a.s4) + j] = v + __ldg(a.gb1 + j);
    }
  } else {
    res_row(a.chat, m)[n] = tanhf(v + __ldg(a.a2b2 + n));
  }
}

// Block: one T x T tile of product P's (t n, N) output (T kTile or
// kWideTile). Chunked: the depth in product_chunks pieces (else whole, at
// every width but the widest: a separate instantiation, so the common one
// carries no chunk arithmetic).
template <int P, bool Chunked, int T>
__device__ __forceinline__ void product_fwd(const EncodeArgs& a) {
  constexpr int M = T / 8;  // a thread's outputs: M x M
  extern __shared__ float smem[];
  const ProductSpec p = product_spec(a, P);
  const int rows = a.t * a.n, tiles_n = (p.N + T - 1) / T;
  const int m0 = (blockIdx.x / tiles_n) * T;
  const int n0 = (blockIdx.x % tiles_n) * T;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // this thread's group (a quarter of the depth) and its M x M outputs:
  // rows ty + 8 i of the tile, and columns tx + 8 j (kTile) or tx M + j
  // (kWideTile: W's as two 16-byte reads)
  const int g = tid / 64, tx = tid % 8, ty = (tid % 64) / 8;
  const int live_m = rows - m0 < T ? rows - m0 : T;
  const int live_n = p.N - n0 < T ? p.N - n0 : T;
  // the tile's columns of W: from w0 up to N0, then from w1
  const int c0 = p.N0 - n0 > 0 ? (p.N0 - n0 < live_n ? p.N0 - n0 : live_n)
                               : 0;
  const int nc = Chunked ? product_chunks(p.K) : 1;
  float acc[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) acc[i][j] = 0.0f;
  // the depth in chunks (one but at the widest widths), each staged
  // whole: rows [kb, kb + K) of A's columns and of W
  for (int ch = 0; ch < nc; ++ch) {
    const int kb = p.K * ch / nc, K = p.K * (ch + 1) / nc - kb;
    const int pa = product_pitch(K);
    float* const As = smem;          // [T][pa]: A's rows
    float* const Ws = As + T * pa;   // [K][T]: W's columns
    if (ch > 0) __syncthreads();  // the last chunk is read
    if (P == kProdU1) {
      for (int e = tid; e < T * K; e += nthr) {
        const int i = e / K, k = e - i * K;
        As[i * pa + k] = i < live_m ? cstar_at(a, m0 + i, kb + k) : 0.0f;
      }
    } else {
      copy_rows_async(As, pa, p.a + (size_t)m0 * p.lda + kb, p.lda, live_m,
                      K, tid, nthr);
      for (int e = tid; e < (T - live_m) * K; e += nthr) {
        const int i = e / K;
        As[(live_m + i) * pa + e - i * K] = 0.0f;
      }
    }
    if (c0 > 0)
      copy_rows_async(Ws, T, p.w0 + (size_t)kb * p.ld0 + n0, p.ld0, K, c0,
                      tid, nthr);
    if (live_n > c0)
      copy_rows_async(Ws + c0, T, p.w1 + (size_t)kb * p.ld1 + n0 + c0 - p.N0,
                      p.ld1, K, live_n - c0, tid, nthr);
    for (int e = tid; e < (T - live_n) * K; e += nthr) {
      const int k = e / (T - live_n);
      Ws[k * T + live_n + e - k * (T - live_n)] = 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();

    const float* A = As + ty * pa;
    const float* W = Ws + (T == kTile ? tx : tx * M);
    for (int k = K * g / kSplit; k < K * (g + 1) / kSplit; ++k) {
      float av[M], wv[M];
#pragma unroll
      for (int i = 0; i < M; ++i) av[i] = A[8 * i * pa + k];
      if (T == kTile) {
#pragma unroll
        for (int j = 0; j < M; ++j) wv[j] = W[k * T + 8 * j];
      } else {
#pragma unroll
        for (int j = 0; j < M; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(W + k * T + j);
          wv[j] = q.x;
          wv[j + 1] = q.y;
          wv[j + 2] = q.z;
          wv[j + 3] = q.w;
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the staged operands are read: reuse the space
  float* const part = smem + g * T * T;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
      part[(ty + 8 * i) * T + (T == kTile ? tx + 8 * j : tx * M + j)] =
          acc[i][j];
  __syncthreads();
  for (int e = tid; e < T * T; e += nthr) {
    float v = smem[e];
#pragma unroll
    for (int q = 1; q < kSplit; ++q) v += smem[q * T * T + e];
    const int m = m0 + e / T, n = n0 + e % T;
    if (m < rows && n < p.N) product_out<P>(a, m, n, v);
  }
}

// Z: lanes by stride; T: the tile (kWideTile only with Z).
template <int P, bool Chunked, bool Z, int T = kTile>
__global__ void __launch_bounds__(kProductThreads)
    product_fwd_kernel(const __grid_constant__ FwdLanes la) {
  if (Z)
    product_fwd<P, Chunked, T>(lane_args(la));
  else
    product_fwd<P, Chunked, T>(la.a);
}

// The softmax over each flat row's logits (a.work), max subtracted
// first: att (with residuals, into its field) and attended = att * cStar
// over the logits; a warp per row.
__device__ __forceinline__ void softmax_fwd(const EncodeArgs& a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= a.t * a.n) return;  // the whole warp
  const int M2 = a.m2;
  float* const x = a.work + (size_t)m * M2;
  float mx = -INFINITY;
  for (int k = lane; k < M2; k += 32) mx = fmaxf(mx, x[k]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.0f;
  for (int k = lane; k < M2; k += 32) {
    const float e = expf(x[k] - mx);
    x[k] = e;
    sum += e;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float* const att =
      a.res.f[kAtt].ptr != nullptr ? res_row(a.res.f[kAtt], m) : nullptr;
  for (int k = lane; k < M2; k += 32) {
    const float p = x[k] / sum;
    if (att != nullptr) att[k] = p;
    x[k] = p * cstar_at(a, m, k);
  }
}

template <bool Z>
__global__ void __launch_bounds__(kMaxThreads)
    softmax_fwd_kernel(const __grid_constant__ FwdLanes la) {
  if (Z)
    softmax_fwd(lane_args(la));
  else
    softmax_fwd(la.a);
}

// ----------------------------------------------- (3) the memory chain

// A block's share of the memory chain's columns in a cluster of C (all of
// them for C = 1): u3 columns [u0, u1) and memory columns [m0, m1); ks
// lanes share an output and p is the (transposed) weight rows' pitch in
// shared memory. Sized by the largest share, cu and cm columns.
struct MemFwdTile {
  int u0, u1, m0, m1, cu, cm, ksu, pu, ksm, p1, p2;
};

__host__ __device__ inline MemFwdTile mem_fwd_tile(int s3, int s4, int mem,
                                                   int C, int rank,
                                                   int threads) {
  const int s34 = s3 + s4;
  MemFwdTile m;
  m.u0 = s34 * rank / C;
  m.u1 = s34 * (rank + 1) / C;
  m.m0 = mem * rank / C;
  m.m1 = mem * (rank + 1) / C;
  m.cu = (s34 + C - 1) / C;
  m.cm = (mem + C - 1) / C;
  m.ksu = lanes_per_output(m.cu, threads);
  m.pu = conflict_free_pitch(mem, m.ksu);
  m.ksm = lanes_per_output(m.cm, threads);
  m.p1 = conflict_free_pitch(s3, m.ksm);
  m.p2 = conflict_free_pitch(s4, m.ksm);
  return m;
}

// Operand floats a row and step: pu3 (s3 + s4), chat (mem), and the
// gamma sites' masks (s3 + s4).
__host__ __device__ inline int mem_fwd_op_width(int mem, int s34) {
  return 2 * s34 + mem;
}

// The weights' shares, transposed (each starting 16-byte aligned), the
// memory before and after the step, r3, and two steps' operands; for
// C = kWeightsL2 the per-row state alone.
__host__ __device__ inline size_t mem_fwd_floats(int mem, int s3, int s4,
                                                 int C, int R, int threads) {
  const int s34 = s3 + s4;
  const size_t state =
      (size_t)R * (2 * mem + s34 + 2 * mem_fwd_op_width(mem, s34));
  if (C == kWeightsL2) return state;
  const MemFwdTile m = mem_fwd_tile(s3, s4, mem, C, 0, threads);
  return (size_t)pad4(m.cu * m.pu) + pad4(m.cm * m.p1) + pad4(m.cm * m.p2) +
         state;
}

// Step s's operands, row-major [R][pu3 | chat | masks], asynchronously
// (S: by plain copies into the state's scratch); ones for the masks
// without them, zeros past n.
template <int R, bool S>
__device__ __forceinline__ void load_mem_fwd_ops(const EncodeArgs& a, int s,
                                                 float* o, int row0, int tid,
                                                 int nthr) {
  const int s34 = a.s3 + a.s4, W = mem_fwd_op_width(a.mem, s34);
  const int sites = a.s1 + a.s2 + s34;
  for (int i = tid; i < W * R; i += nthr) {
    const int r = i / W, f = i - r * W, row = row0 + r;
    const size_t at = (size_t)s * a.n + row;
    if (row >= a.n)
      o[i] = 0.0f;
    else if (f < s34)
      copy4<S>(o + i, a.pu3 + at * s34 + f);
    else if (f < s34 + a.mem)
      copy4<S>(o + i, res_row(a.chat, at) + f - s34);
    else if (a.masks != nullptr)
      copy4<S>(o + i, a.masks + at * sites + a.s1 + a.s2 + f - s34 - a.mem);
    else
      o[i] = 1.0f;
  }
}

// Block: rank `rank` of a cluster of C over R batch rows. L2: the weights
// read in place (C = 1), a column of each (an output's depth) with its
// elements a row apart; S: with them the state in the block's scratch
// slice (kStateScratch).
template <int R, int C, bool L2, bool S>
__device__ __forceinline__ void mem_chain_fwd(const EncodeArgs& a) {
  static_assert(!S || (L2 && C == 1), "the scratch plan reads from L2");
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const int mem = a.mem, s3 = a.s3, s4 = a.s4, s34 = s3 + s4;
  const int W = mem_fwd_op_width(mem, s34);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const MemFwdTile m = mem_fwd_tile(s3, s4, mem, C, rank, nthr);
  const int nu = m.u1 - m.u0, nm = m.m1 - m.m0;
  const int row0 = (blockIdx.x / C) * R;
  // the weights transposed: row jl of wu holds gw1[M2 + k][u0 + jl] over
  // k, row cl of w1 and w2 g1w2[k][m0 + cl] and g2w2[k][m0 + cl]; read in
  // place, row jl starts at column jl and its elements lie a row apart
  const float* gu = a.gw1 + (size_t)a.m2 * s34;
  float* const wu = smem;                    // [cu][pu]
  float* const w1 = wu + pad4(m.cu * m.pu);  // [cm][p1]
  float* const w2 = w1 + pad4(m.cm * m.p1);  // [cm][p2]
  const float* const ru = L2 ? gu : wu;
  const float* const r1w = L2 ? a.g1w2 : w1;
  const float* const r2w = L2 ? a.g2w2 : w2;
  const int pu = L2 ? 1 : m.pu, p1 = L2 ? 1 : m.p1, p2 = L2 ? 1 : m.p2;
  const int su = L2 ? s34 : 1, sm = L2 ? mem : 1;
  float* memp = L2 ? state_base<S>(smem, a.mem_state, a.mem_slice)
                  : w2 + pad4(m.cm * m.p2);  // [R][mem]: before
  float* memn = memp + R * mem;              // [R][mem]: after the step
  float* const r3 = memn + R * mem;          // [R][s34]
  float* const ops = r3 + R * s34;           // two [R][W]: step s's at s & 1

  // coalesced reads of the weights' rows, written transposed
  if (!L2) {
    for (int i = tid; i < mem * nu; i += nthr) {
      const int k = i / nu, jl = i - k * nu;
      wu[jl * m.pu + k] = gu[(size_t)k * s34 + m.u0 + jl];
    }
    for (int i = tid; i < s3 * nm; i += nthr) {
      const int k = i / nm, cl = i - k * nm;
      w1[cl * m.p1 + k] = a.g1w2[(size_t)k * mem + m.m0 + cl];
    }
    for (int i = tid; i < s4 * nm; i += nthr) {
      const int k = i / nm, cl = i - k * nm;
      w2[cl * m.p2 + k] = a.g2w2[(size_t)k * mem + m.m0 + cl];
    }
  }
  for (int i = tid; i < R * mem; i += nthr) memp[i] = 0.0f;
  load_mem_fwd_ops<R, S>(a, 0, ops, row0, tid, nthr);
  cp_async_wait_all();
  __syncthreads();
  FTT_STAMP(a.clocks, kClockMemChainFwd, 0, 0);

  for (int s = 0; s < a.t; ++s) {
    if (s + 1 < a.t)
      load_mem_fwd_ops<R, S>(a, s + 1, ops + ((s + 1) & 1) * R * W, row0,
                             tid, nthr);
    const float* const op = ops + (s & 1) * R * W;
    const size_t base = (size_t)s * a.n;

    // (a) u3 = pu3 + mem @ gw1[M2:] for the block's columns, and its
    //     relu site: r3 and kg3
    for (int b0 = warp * 32; b0 < nu * m.ksu; b0 += nwarp * 32) {
      const int item = b0 + lane, jl = item / m.ksu;
      const int slice = item - jl * m.ksu, j = m.u0 + jl;
      const bool ok = item < nu * m.ksu;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      if (ok)
        smem_dot<R>(memp, mem, mem, ru + jl * pu, slice, m.ksu, acc, su);
      lanes_sum<R>(acc, m.ksu);
      if (ok && slice == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + r;
          const float u = op[r * W + j] + acc[r];
          const float mk = op[r * W + s34 + mem + j];
          const float v = fmaxf(u, 0.0f) * mk;
          r3[r * s34 + j] = v;
          if (a.allmem != nullptr && row < a.n) {
            res_row(a.res.f[kR3], base + row)[j] = v;
            res_row(a.res.f[kKg3], base + row)[j] = u > 0.0f ? mk : 0.0f;
          }
        }
      }
    }
    if (C > 1) gather_peers<C, R>(r3, s34, rank, tid, nthr);
    __syncthreads();
    FTT_STAMP(a.clocks, kClockMemChainFwd, s + 1, 0);

    // (b) the heads for the block's memory columns, g1 = sigmoid(r3[:s3]
    //     @ g1w2 + b) and g2 likewise, and mem = g1 * mem + g2 * chat
    for (int b0 = warp * 32; b0 < nm * m.ksm; b0 += nwarp * 32) {
      const int item = b0 + lane, cl = item / m.ksm;
      const int slice = item - cl * m.ksm, col = m.m0 + cl;
      const bool ok = item < nm * m.ksm;
      float acc1[R], acc2[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc1[r] = acc2[r] = 0.0f;
      if (ok) {
        smem_dot<R>(r3, s34, s3, r1w + cl * p1, slice, m.ksm, acc1, sm);
        smem_dot<R>(r3 + s3, s34, s4, r2w + cl * p2, slice, m.ksm, acc2, sm);
      }
      lanes_sum<R>(acc1, m.ksm);
      lanes_sum<R>(acc2, m.ksm);
      if (ok && slice == 0) {
        const float b1 = __ldg(a.g1b2 + col), b2 = __ldg(a.g2b2 + col);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + r;
          const float g1 = sigmoid(acc1[r] + b1), g2 = sigmoid(acc2[r] + b2);
          const float chat = op[r * W + s34 + col];
          const float mn = g1 * memp[r * mem + col] + g2 * chat;
          memn[r * mem + col] = mn;
          if (a.allmem != nullptr && row < a.n) {
            res_row(a.res.f[kG1], base + row)[col] = g1;
            res_row(a.res.f[kG2], base + row)[col] = g2;
            a.allmem[(base + row) * mem + col] = mn;
          }
        }
      }
    }
    if (C > 1) gather_peers<C, R>(memn, mem, rank, tid, nthr);
    float* const spent = memp;
    memp = memn;
    memn = spent;
    cp_async_wait_all();
    __syncthreads();
    FTT_STAMP(a.clocks, kClockMemChainFwd, s + 1, 1);
  }

  if (rank == 0) {
    for (int i = tid; i < R * mem; i += nthr) {
      const int r = i / mem, row = row0 + r;
      if (row < a.n) a.mem_last[(size_t)row * mem + i - r * mem] = memp[i];
    }
  }
  // no block leaves while a peer may still read its shared memory
  if (C > 1) cluster_barrier<C>();
}

template <int R, int C, bool L2, bool S = false, bool Z = true>
__global__ void __launch_bounds__(kMaxThreads)
    mem_chain_fwd_kernel(const __grid_constant__ FwdLanes la) {
  if (Z)
    mem_chain_fwd<R, C, L2, S>(lane_args(la));
  else
    mem_chain_fwd<R, C, L2, S>(la.a);
}

// ------------------------------------------------------------ launches

// The chains' kernels for a plan (lstm_common.cuh's chain_kernel); Z:
// lanes by stride.
template <int R, bool Z = true>
Kernel cells_for(int plan) {
  const Kernel k[6] = {cell_chains_fwd_kernel<R, 1, true, false, Z>,
                       cell_chains_fwd_kernel<R, 1, false, false, Z>,
                       cell_chains_fwd_kernel<R, 2, false, false, Z>,
                       cell_chains_fwd_kernel<R, 4, false, false, Z>,
                       cell_chains_fwd_kernel<R, 8, false, false, Z>,
                       cell_chains_fwd_kernel<R, 1, true, true, Z>};
  return chain_kernel(k, plan);
}

template <int R, bool Z = true>
Kernel mem_for(int plan) {
  const Kernel k[6] = {mem_chain_fwd_kernel<R, 1, true, false, Z>,
                       mem_chain_fwd_kernel<R, 1, false, false, Z>,
                       mem_chain_fwd_kernel<R, 2, false, false, Z>,
                       mem_chain_fwd_kernel<R, 4, false, false, Z>,
                       mem_chain_fwd_kernel<R, 8, false, false, Z>,
                       mem_chain_fwd_kernel<R, 1, true, true, Z>};
  return chain_kernel(k, plan);
}

// The LSTM chains' kernel at R rows a block and a plan: null for a count
// with no instantiation (kCellRowCounts; for one lane's arguments in
// place, `one`, only one lane's counts).
Kernel cells_kernel(int R, int plan, bool one = false) {
  static_assert(sizeof(kCellRowCounts) == 4 * sizeof(int), "the switch");
  if (one)
    return R == kTrainCellRows  ? cells_for<kTrainCellRows, false>(plan)
           : R == kEvalCellRows ? cells_for<kEvalCellRows, false>(plan)
                                : nullptr;
  switch (R) {
    case kCellRowCounts[0]: return cells_for<kCellRowCounts[0]>(plan);
    case kCellRowCounts[1]: return cells_for<kCellRowCounts[1]>(plan);
    case kCellRowCounts[2]: return cells_for<kCellRowCounts[2]>(plan);
    case kCellRowCounts[3]: return cells_for<kCellRowCounts[3]>(plan);
    default: return nullptr;
  }
}

// The memory chain's likewise (kMemRowCounts).
Kernel mem_kernel(int R, int plan, bool one = false) {
  static_assert(sizeof(kMemRowCounts) == 5 * sizeof(int), "the switch");
  if (one)
    return R == kTrainMemRows  ? mem_for<kTrainMemRows, false>(plan)
           : R == kEvalMemRows ? mem_for<kEvalMemRows, false>(plan)
                               : nullptr;
  switch (R) {
    case kMemRowCounts[0]: return mem_for<kMemRowCounts[0]>(plan);
    case kMemRowCounts[1]: return mem_for<kMemRowCounts[1]>(plan);
    case kMemRowCounts[2]: return mem_for<kMemRowCounts[2]>(plan);
    case kMemRowCounts[3]: return mem_for<kMemRowCounts[3]>(plan);
    case kMemRowCounts[4]: return mem_for<kMemRowCounts[4]>(plan);
    default: return nullptr;
  }
}

// [one lane's in place, lanes by stride, lanes by stride in wide tiles]
// [chunked][product]
template <bool Z, int T>
struct ProductTable {
  Kernel k[2][kProducts] = {
      {product_fwd_kernel<kProdU1, false, Z, T>,
       product_fwd_kernel<kProdLogits, false, Z, T>,
       product_fwd_kernel<kProdU2Pu3, false, Z, T>,
       product_fwd_kernel<kProdChat, false, Z, T>},
      {product_fwd_kernel<kProdU1, true, Z, T>,
       product_fwd_kernel<kProdLogits, true, Z, T>,
       product_fwd_kernel<kProdU2Pu3, true, Z, T>,
       product_fwd_kernel<kProdChat, true, Z, T>}};
};
const ProductTable<false, kTile> kOneLaneProducts{};
const ProductTable<true, kTile> kLaneProducts{};
const ProductTable<true, kWideTile> kWideProducts{};
const Kernel kSoftmaxKernels[2] = {softmax_fwd_kernel<false>,
                                   softmax_fwd_kernel<true>};

// One pass's launch: its kernel, grid (z: the lanes), block and shared
// memory, and the cluster its blocks run in (1: none).
struct Pass {
  Kernel kernel;
  dim3 grid;
  int threads;
  size_t bytes;
  int cluster;
};

// The LSTM chains' and the memory chain's shared memory a block at CR and
// MR rows on a cluster of C (kWeightsL2: the per-row state alone).
size_t cells_bytes(const EncodeArgs& a, int CR, int threads, int C) {
  return fwd_chain_bytes(a.cells, CR, threads, C);
}

size_t mem_bytes_at(const EncodeArgs& a, int MR, int threads, int C) {
  return mem_fwd_floats(a.mem, a.s3, a.s4, C, MR, threads) * sizeof(float);
}

// Pass (1) to (3) over every lane, each one launch: an LSTM chain block on
// CR batch rows and a memory chain block on MR, each chain on the smallest
// cluster whose blocks fit, else with its weights read from L2, else with
// them its state in the scratch; kNeedScratch, launching nothing, while
// the scratch is short of what those plans take (every lane's blocks their
// own slices). One lane at one lane's counts (`one`) takes the kernels
// that read its arguments in place.
int run(FwdLanes la, int CR, int MR, int lanes, bool one,
        const Scratch& scratch, int threads, int* fit, cudaStream_t stream) {
  EncodeArgs& a = la.a;
  const int flat = a.t * a.n;
  size_t cell_bytes = 0, mem_bytes = 0;
  auto cells_at = [&](int C) { return cells_bytes(a, CR, threads, C); };
  const int Pc = chain_plan(cells_at, [&] { return cells_at(kWeightsL2); },
                            &cell_bytes);
  auto mem_at = [&](int C) { return mem_bytes_at(a, MR, threads, C); };
  const int Pm = chain_plan(mem_at, [&] { return mem_at(kWeightsL2); },
                            &mem_bytes);
  fit[kFitChainA] = Pc;
  fit[kFitChainB] = Pm;
  const int Cc = plan_blocks(Pc), Cm = plan_blocks(Pm);
  const dim3 cell_grid(((a.n + CR - 1) / CR) * Cc, a.cells.count, lanes);
  const dim3 mem_grid(((a.n + MR - 1) / MR) * Cm, 1, lanes);
  if (Pc == kStateScratch)
    a.cell_state = reserve(scratch,
                           (long long)cell_grid.x * cell_grid.y * lanes,
                           cell_bytes, &a.cell_slice);
  if (Pm == kStateScratch)
    a.mem_state = reserve(scratch, (long long)mem_grid.x * lanes, mem_bytes,
                          &a.mem_slice);
  if ((Pc == kStateScratch && a.cell_state == nullptr) ||
      (Pm == kStateScratch && a.mem_state == nullptr))
    return kNeedScratch;
  // the passes in order, each with its pass (1 to 3)
  Pass p[8];
  int pass_of[8], count = 0;
  auto add = [&](int pass, const Pass& launch) {
    pass_of[count] = pass;
    p[count++] = launch;
  };
  add(1, {cells_kernel(CR, Pc, one), cell_grid, threads,
          plan_smem(Pc, cell_bytes), Cc});
  for (int id = kProdU1; id < kProducts; ++id) {
    const ProductSpec spec = product_spec(a, id);
    const int nc = product_chunks(spec.K), K = (spec.K + nc - 1) / nc;
    auto tiles = [&](int T) {
      return ((flat + T - 1) / T) * ((spec.N + T - 1) / T);
    };
    // over lanes wide tiles where they are many and fit at one lane's
    // chunks
    const bool wide = !one && (long long)tiles(kWideTile) * lanes >=
                                  kWideBlocks &&
                      product_floats(K, kWideTile) * sizeof(float) <=
                          (size_t)kMaxSmemBytes;
    const int T = wide ? kWideTile : kTile;
    const auto& products = one    ? kOneLaneProducts.k
                           : wide ? kWideProducts.k
                                  : kLaneProducts.k;
    add(2, {products[nc > 1][id], dim3(tiles(T), 1, lanes), kProductThreads,
            product_floats(K, T) * sizeof(float), 1});
    if (id == kProdLogits)  // the softmax between the logits and u2
      add(2, {kSoftmaxKernels[!one],
              dim3((flat + threads / 32 - 1) / (threads / 32), 1, lanes),
              threads, 0, 1});
  }
  add(3, {mem_kernel(MR, Pm, one), mem_grid, threads,
          plan_smem(Pm, mem_bytes), Cm});
  // No width reaches this refusal: each chain's bytes fit by its plan
  // (none on kStateScratch); a product stages product_floats of its depth
  // in product_chunks pieces, each fitting by construction (at one float
  // of depth a chunk, kTile (product_pitch(1) + 1) = 160 floats, and the
  // kSplit partial tiles 4,096 floats: 16 KiB); the softmax takes none.
  for (int k = 0; k < count; ++k) {
    if (p[k].bytes > (size_t)kMaxSmemBytes)
      return (int)refuse(fit, pass_of[k], p[k].bytes, p[k].cluster);
    cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(p[k].kernel), p[k].bytes);
    if (err != cudaSuccess) return (int)err;
  }
  for (int k = 0; k < count; ++k) {
    cudaError_t err = launch_clusters(p[k].kernel, p[k].grid, p[k].threads,
                                      p[k].bytes, p[k].cluster, stream, la);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace
}  // namespace ftt

// Biases are (1, d) or (d,), all arrays float32 and contiguous. masks is
// (t, n, s1 + s2 + s3 + s4) or null (eval). allh, allc, allmem and
// res_ptrs are all given (residuals written) or all null; res_ptrs,
// res_strides and res_cols (host memory) are the residual-layout table's
// ten pointers, row strides and column offsets (mfm_res.cuh), in the
// _RES_NAMES order. scratch holds t n (s3 + s4 + M2) floats (pu3, then
// the logits and attended) and, without residuals, t n (H + mem + s1 + s2)
// more (the cell states, chat, r1 and r2). cell_dims (host memory) lists
// the n_cells fused hidden widths, summing to H; the first cells up to
// z_tot are the encoders. threads is a multiple of 32 up to 512, the
// block size of the chains and the softmax (the products run 256-thread
// tiles). cell_rows and mem_rows: the batch rows a block of the LSTM
// chains and of the memory chain takes, one of kCellRowCounts and of
// kMemRowCounts; 0 takes one lane's count of the variant (kEvalCellRows
// and kEvalMemRows without residuals, kTrainCellRows and kTrainMemRows
// with them); another count is refused. state (state_floats floats of
// device memory, or null) is the scratch of the chains on kStateScratch;
// state_need (host memory, one value) gets the floats they take, and the
// launcher returns kNeedScratch (-1) without launching while state_floats
// is short of it. fit (host memory, six ints, lstm_common.cuh's Fit) gets
// the plans the LSTM chains and the memory chain ran on (a cluster,
// kWeightsL2 or kStateScratch). Every array is lane 0's of `lanes`, each
// pass one launch for them all: lane k's lies lane_strides[i] k floats on
// (host memory, 33 strides: xp, masks, wh, the 14 other weights in the
// signature's order, h_last, mem_last, allh, allc, allmem, the ten
// residual pointers and scratch; 0 where the lanes share the array).
extern "C" int mfm_encode_fwd(
    const float* xp, const float* masks, const float* wh, const float* a1w1,
    const float* a1b1, const float* a1w2, const float* a1b2,
    const float* a2w1, const float* a2b1, const float* a2w2, const float* a2b2,
    const float* gw1, const float* gb1, const float* g1w2, const float* g1b2,
    const float* g2w2, const float* g2b2, float* h_last, float* mem_last,
    float* allh, float* allc, float* allmem, void* const* res_ptrs,
    const int* res_strides, const int* res_cols, float* scratch,
    float* state, long long state_floats, long long* state_need, int t,
    int n, int H, int z_tot, int mem, int s1, int s2, int s3, int s4,
    int n_cells, const int* cell_dims, int threads, int cell_rows,
    int mem_rows, int lanes, const long long* lane_strides, int* fit,
    void* stream) {
  using namespace ftt;
  clear_fit(fit);
  const Scratch chains = {state, state_floats, state_need};
  const long long* ls = lane_strides;
  int widths[kResFields];
  res_widths(H, z_tot, mem, s1, s2, s3, s4, widths);
  const bool with_res = allh && allc && allmem && res_ptrs;
  const int CR =
      cell_rows != 0 ? cell_rows : with_res ? kTrainCellRows : kEvalCellRows;
  const int MR =
      mem_rows != 0 ? mem_rows : with_res ? kTrainMemRows : kEvalMemRows;
  if (lanes < 1 || lanes > 65535 || ls == nullptr || t < 1 || n < 1 ||
      z_tot < 0 || z_tot >= H || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || scratch == nullptr || state_need == nullptr ||
      !(with_res || !(allh || allc || allmem || res_ptrs)) ||
      cells_kernel(CR, 1) == nullptr || mem_kernel(MR, 1) == nullptr)
    return (int)cudaErrorInvalidValue;
  // lane 0's arguments and the lanes' strides
  FwdLanes la;
  EncodeArgs& a = la.a;
  const float* const w[15] = {wh,   a1w1, a1b1, a1w2, a1b2, a2w1, a2b1, a2w2,
                              a2b2, gw1,  gb1,  g1w2, g1b2, g2w2, g2b2};
  const float** const to[15] = {&a.wh,   &a.a1w1, &a.a1b1, &a.a1w2,
                                &a.a1b2, &a.a2w1, &a.a2b1, &a.a2w2,
                                &a.a2b2, &a.gw1,  &a.gb1,  &a.g1w2,
                                &a.g1b2, &a.g2w2, &a.g2b2};
  for (int i = 0; i < 15; ++i) *to[i] = w[i];
  a.xp = xp;
  a.masks = masks;
  a.h_last = h_last;
  a.mem_last = mem_last;
  a.allh = allh;
  a.allmem = allmem;
  a.clocks = phase_clocks();
  a.cell_state = a.mem_state = nullptr;
  a.cell_slice = a.mem_slice = 0;
  a.t = t;
  a.n = n;
  a.H = H;
  a.z_tot = z_tot;
  a.mem = mem;
  a.s1 = s1;
  a.s2 = s2;
  a.s3 = s3;
  a.s4 = s4;
  a.m2 = 2 * (H - z_tot);
  if (!make_cells(n_cells, cell_dims, H, &a.cells) ||
      !make_res_table(res_ptrs, res_strides, res_cols, widths, &a.res))
    return (int)cudaErrorInvalidValue;
  const size_t flat = (size_t)t * n;
  a.pu3 = scratch;
  a.work = a.pu3 + flat * (s3 + s4);
  const long long scratch_stride = ls[kLaneRes + kResFields];
  for (int i = 0; i < kLanePu3; ++i) la.stride[i] = ls[i];
  la.stride[kLanePu3] = la.stride[kLaneWork] = scratch_stride;
  if (with_res) {
    a.allc = allc;
    a.r1 = a.res.f[kR1];
    a.r2 = a.res.f[kR2];
    a.chat = a.res.f[kChat];
    la.stride[kLaneR1] = ls[kLaneRes + kR1];
    la.stride[kLaneR2] = ls[kLaneRes + kR2];
    la.stride[kLaneChat] = ls[kLaneRes + kChat];
  } else {
    a.allc = a.work + flat * a.m2;
    a.chat = ResEntry{a.allc + flat * H, mem, 0};
    a.r1 = ResEntry{a.chat.ptr + flat * mem, s1, 0};
    a.r2 = ResEntry{a.r1.ptr + flat * s1, s2, 0};
    la.stride[kLaneAllc] = la.stride[kLaneR1] = la.stride[kLaneR2] =
        la.stride[kLaneChat] = scratch_stride;
  }
  *state_need = 0;
  const bool one = lanes == 1 && cells_kernel(CR, 1, true) != nullptr &&
                   mem_kernel(MR, 1, true) != nullptr;
  return run(la, CR, MR, lanes, one, chains, threads, fit,
             static_cast<cudaStream_t>(stream));
}

// The blocks of the forward's LSTM chains (chain 0) or memory chain (chain
// 1) at `rows` rows a block on chain plan `plan` (a cluster of 1, 2, 4 or
// 8, kWeightsL2 or kStateScratch), `threads` threads and `smem` bytes of
// dynamic shared memory, that the current card holds at once (*wave): its
// SMs times the blocks the occupancy calculator gives an SM for that
// instantiation, its registers counted. The lane plan's waves
// (cuda_mfn.fwd_plan). Refuses a count or plan with no instantiation.
extern "C" int mfm_encode_fwd_wave(int chain, int rows, int plan,
                                   int threads, long long smem, int* wave) {
  using namespace ftt;
  if (wave == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || smem < 0 || smem > kMaxSmemBytes ||
      !known_plan(plan))
    return (int)cudaErrorInvalidValue;
  const Kernel k = chain == 0   ? cells_kernel(rows, plan)
                   : chain == 1 ? mem_kernel(rows, plan)
                                : nullptr;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)blocks_at_once(reinterpret_cast<const void*>(k), threads,
                             (size_t)smem, wave);
}
