// The recurrences' forward chains: the fused autoregressive decoders and
// the fused encoder cells (multi_lstm), one kernel for both; the forward
// counterpart of lstm_bwd.cu.
//
// Replaces: factorized_tpu/ops/pallas_lstm.py::_dec_fwd_kernel (reached
// through _dec_fwd_call and decoder_lstm) and ::_enc_fwd_kernel (through
// _enc_fwd_call and multi_lstm).
//
// What it computes: an LSTM recurrence over k independent cells fused
// into one state of H units, gate-major and block-diagonal: for each step
// s, gates = x_s + h @ W through the LSTM gate math. The decoders (W =
// wsum = wx + wh) start from the state (h0, c0) that the latent-driven
// step 0 left (computed outside, as in the JAX package) and run t - 1
// steps with x_s the broadcast bias b; they write allh and allc (t, n, H)
// with slot 0 = (h0, c0) and the pre-activation gates (t, n, 4H) with
// slot 0 zero. The encoder cells (W = wh) start from zeros and run t
// steps with x_s = xp[s], the hoisted input projections (t, n, 4H); the
// eval variant writes h_last (n, H) only, the train variant also allh,
// allc and gates, the residuals the backward (lstm_bwd.cu) reads.
//
// What bounds it on an H100: neither resource, narrowly. At the training
// batch (n = 32, t = 20, best_acc_mosi_config) the decoders (cells 104,
// 24 and 24) do 0.058 GFLOP over the diagonal blocks (0.9 us at 67
// TFLOP/s) against 2.5 MB of traffic (0.8 us at 3.35 TB/s); at n = 256,
// 0.47 GFLOP (7 us) against 19 MB. kl_ef's encoder cells (32, 8, 80 and
// 120) at n = 256 do 0.90 GFLOP (13 us) against 21 MB. In practice the
// serial chain of dependent steps bounds it.
//
// What the design does about it: the cells are independent chains, so
// one block (or cluster) owns one cell and R batch rows and walks the
// steps (cell_fwd.cuh, the encode forward's LSTM pass). It copies the
// cell's four diagonal blocks of W into shared memory once (the 104-unit
// decoder cell's 169 KiB), so the chain reads no weight from L2; each
// step is two barriers: the gates of the block's columns from shared
// memory, then the cell update, while the next step's x is copied in with
// cp.async. A cell whose blocks pass one SM (kl_ef's 120-unit cell, 225
// KiB) splits its gate columns over a thread-block cluster of 2, 4 or 8
// blocks, the smallest that fits, the peers' gates read through
// distributed shared memory. Past a cluster of 8 (a 336-unit decoder cell
// or a 400-unit encoder cell of a search draw) the chain reads the
// weights in place from L2, one block a row tile, chosen from the widths
// before the launch; past a block's state too (more than about 518 units
// in the 8-row eval chains, 2,075 in the 2-row ones) the same chain keeps
// h, c, the two steps' x and the gates' group sums in a slice of device
// memory a block (lstm_common.cuh's kStateScratch). x has a step stride and a row stride, so the
// decoders read their bias with both 0 and no (t, n, 4H) buffer is made
// for it. Float32 on the CUDA cores, every sum in a fixed order: the same
// bits on every run.
//
// Lanes: K problems of one shape (K seeds' or configs' recurrences) in one
// launch, whatever K: lane 0's arguments and each array's floats from one
// lane's to the next (0 where the lanes share it), lane k's blocks those
// of blockIdx.z = k, which add k strides to each pointer
// (ChainFwdLanes), as lstm_bwd.cu's chains. A lane's blocks do the
// one-lane launch's arithmetic, so lane k's bits do not depend on K. The
// batch rows a block are chosen on the host from K and n
// (cuda_lstm.chain_fwd_plan) among the instantiated counts; the gates
// product's split of a column's depth over kg groups follows the cell's
// columns and the threads, not the rows (cell_fwd.cuh's fwd_tile), so
// each row's sums keep their order at every count.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cell_fwd.cuh"
#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kThreads = 512;
// Batch rows a block of the decoders' and of the encoder cells' chains
// takes: one of these instantiated counts, chosen on the host
// (cuda_lstm.chain_fwd_plan, which lists the same counts). A decoder block
// of 16 rows does not fit beside the 104-unit cell's weights, nor an
// encoder-cell block of 32 beside an 80-unit cell's.
constexpr int kDecoderFwdRowCounts[] = {1, 2, 4, 8};
constexpr int kMultiFwdRowCounts[] = {1, 2, 4, 8, 16};
// The counts one lane takes, at any batch, the fastest measured by
// perf_probe.py rows (PERF.md): the decoders' at the training batch (n =
// 32, most of their launches), the encoder cells' eval variant at the
// serving batch (n = 256) and their train variant at the training batch.
// perf_probe.py rows sweeps them by rebuilding with -D overrides of these
// macros.
#ifndef FTT_DECODER_FWD_ROWS
#define FTT_DECODER_FWD_ROWS 2
#endif
#ifndef FTT_MULTI_EVAL_ROWS
#define FTT_MULTI_EVAL_ROWS 8
#endif
#ifndef FTT_MULTI_TRAIN_ROWS
#define FTT_MULTI_TRAIN_ROWS 2
#endif
constexpr int kDecoderFwdRows = FTT_DECODER_FWD_ROWS;
constexpr int kMultiEvalRows = FTT_MULTI_EVAL_ROWS;
constexpr int kMultiTrainRows = FTT_MULTI_TRAIN_ROWS;
static_assert(listed(kDecoderFwdRowCounts, kDecoderFwdRows) &&
                  listed(kMultiFwdRowCounts, kMultiEvalRows) &&
                  listed(kMultiFwdRowCounts, kMultiTrainRows),
              "one lane's rows are an instantiated count");

struct ChainFwdArgs {
  const float* x;     // encoder cells: xp (t, n, 4H); decoders: b (4H)
  size_t xs;          // floats from one step's x to the next: n 4H, or 0
  int xr;             // floats from one row's x to the next: 4H, or 0
  const float* h0;    // decoders: (n, H); encoder cells: null (zeros)
  const float* c0;    // decoders: (n, H)
  const float* w;     // (H, 4H): wsum or wh
  float* h_last;      // encoder cells: (n, H); decoders: null
  float* allh;        // (t, n, H), or null (encoder cells' eval variant)
  float* allc;        // (t, n, H), or null
  float* gates;       // (t, n, 4H), or null
  long long* clocks;  // the per-phase probe's buffer, or null
  float* state;       // kStateScratch: the blocks' state slices
  size_t slice;       // floats a slice
  int t, n, H;
  Cells cells;
};

// The lane strides of the chain's arrays (ChainFwdArgs' pointers).
enum ChainFwdLane {
  kLaneX,
  kLaneH0,
  kLaneC0,
  kLaneW,
  kLaneHLast,
  kLaneAllh,
  kLaneAllc,
  kLaneGates,
  kChainFwdLanes
};

// The kernel's argument: lane 0's arguments and the lane strides.
struct ChainFwdLanes {
  ChainFwdArgs a;
  long long stride[kChainFwdLanes];
};

using Kernel = void (*)(ChainFwdLanes);

// This block's lane's arguments (blockIdx.z = k): lane 0's with k strides
// added to each pointer (a null one has stride 0 and stays null). The cell
// table is read from `la.a.cells`, in place: a block indexes it by its
// cell.
__device__ __forceinline__ ChainFwdArgs lane_args(const ChainFwdLanes& la) {
  ChainFwdArgs a = la.a;
  const long long z = blockIdx.z;
  const long long* s = la.stride;
  a.x += z * s[kLaneX];
  a.h0 += z * s[kLaneH0];
  a.c0 += z * s[kLaneC0];
  a.w += z * s[kLaneW];
  a.h_last += z * s[kLaneHLast];
  a.allh += z * s[kLaneAllh];
  a.allc += z * s[kLaneAllc];
  a.gates += z * s[kLaneGates];
  return a;
}

// blockIdx.z is the lane, blockIdx.y the cell, blockIdx.x / C the row
// tile and the rank in the cluster of C its share of the cell's gate
// columns. D: the decoders (state (h0, c0) in slot 0, steps 1 to t - 1);
// else a zero state and steps 0 to t - 1. L2: the weights read in place
// (C = 1); S: with them the state in the block's scratch slice
// (kStateScratch).
template <int R, int C, bool D, bool L2, bool S>
__device__ __forceinline__ void lstm_chain_fwd(const ChainFwdArgs& a,
                                               const Cells& cells) {
  static_assert(!S || (L2 && C == 1), "the scratch plan reads from L2");
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const FwdTile c = fwd_tile<C, L2>(cells, blockIdx.y, blockDim.x, rank,
                                    a.H);
  const int h = c.h, H = a.H;
  const float* const w = cell_weights<L2>(smem, a.w, H, c.k0);
  float* const base = state_base<S>(smem, a.state, a.slice);
  float* const hs = base + (L2 ? 0 : h * c.wp);  // [h][R]
  float* const cs = hs + pad4(h * R);            // [h][R]
  float* const xb = cs + pad4(h * R);  // two [4h][R]: step s's at s & 1
  float* const part = xb + 8 * h * R;  // [kg kc][R], two for a cluster
  const int part_floats = c.kg * c.kc * R;
  const int row0 = (blockIdx.x / C) * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const bool store = C == 1 || rank == 0;
  const int first = D ? 1 : 0;

  if (!L2)
    load_cell_weights(smem, a.w, H, c.k0, h, c.c0, c.kc, c.wp, tid, nthr);
  // the state before the first step; the decoders' slot 0
  for (int i = tid; i < h * R; i += nthr) {
    const int j = i / R, r = i - j * R, row = row0 + r;
    float hv = 0.0f, cv = 0.0f;
    if (D && row < a.n) {
      const size_t at = (size_t)row * H + c.k0 + j;
      hv = a.h0[at];
      cv = a.c0[at];
      if (store) {
        a.allh[at] = hv;
        a.allc[at] = cv;
        float* gt = a.gates + (size_t)row * 4 * H + c.k0 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) gt[q * H] = 0.0f;
      }
    }
    hs[i] = hv;
    cs[i] = cv;
  }
  load_gates_async<R, S>(xb + (first & 1) * 4 * h * R, a.x, first, a.xs,
                         a.xr, a.n, H, c, row0, tid, nthr);
  cp_async_wait_all();
  __syncthreads();
  FTT_STAMP(a.clocks, kClockLstmFwd, 0, 0);

  for (int s = first; s < a.t; ++s) {
    if (s + 1 < a.t)
      load_gates_async<R, S>(xb + ((s + 1) & 1) * 4 * h * R, a.x, s + 1,
                             a.xs, a.xr, a.n, H, c, row0, tid, nthr);
    float* const p = part + (C > 1 ? (s & 1) * part_floats : 0);
    cell_gates_fwd<R, L2>(w, hs, xb + (s & 1) * 4 * h * R, p, c, tid, nthr);
    cluster_barrier<C>();
    FTT_STAMP(a.clocks, kClockLstmFwd, s + 1 - first, 0);
    cell_update_fwd<C, R>(p, hs, cs, c, a.allh, a.allc, a.gates, s, a.n, H,
                          row0, store, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    FTT_STAMP(a.clocks, kClockLstmFwd, s + 1 - first, 1);
  }

  if (a.h_last != nullptr && store) {
    for (int i = tid; i < R * h; i += nthr) {
      const int r = i / h, j = i - r * h, row = row0 + r;
      if (row < a.n) a.h_last[(size_t)row * H + c.k0 + j] = hs[j * R + r];
    }
  }
  // no block leaves while a peer may still read its gates
  if (C > 1) cluster_barrier<C>();
}

// Instantiated for lanes by stride (Z) and, at one lane's row counts, for
// one lane's arguments read in place (the launch as it was before lanes:
// no copy of the arguments, so the same code as a model without lanes).
// __grid_constant__: the cell table is indexed by blockIdx.y (see
// lstm_bwd.cu).
template <int R, int C, bool D, bool L2, bool S = false, bool Z = true>
__global__ void __launch_bounds__(kThreads)
    lstm_chain_fwd_kernel(const __grid_constant__ ChainFwdLanes la) {
  if (Z)
    lstm_chain_fwd<R, C, D, L2, S>(lane_args(la), la.a.cells);
  else
    lstm_chain_fwd<R, C, D, L2, S>(la.a, la.a.cells);
}

// The kernel of a chain at R rows a block for a plan (lstm_common.cuh's
// chain_kernel); Z: lanes by stride.
template <int R, bool D, bool Z = true>
Kernel chain_for(int plan) {
  const Kernel k[6] = {lstm_chain_fwd_kernel<R, 1, D, true, false, Z>,
                       lstm_chain_fwd_kernel<R, 1, D, false, false, Z>,
                       lstm_chain_fwd_kernel<R, 2, D, false, false, Z>,
                       lstm_chain_fwd_kernel<R, 4, D, false, false, Z>,
                       lstm_chain_fwd_kernel<R, 8, D, false, false, Z>,
                       lstm_chain_fwd_kernel<R, 1, D, true, true, Z>};
  return chain_kernel(k, plan);
}

// The decoders' (D) or the encoder cells' kernel at R rows a block and a
// plan: null for a count with no instantiation (kDecoderFwdRowCounts,
// kMultiFwdRowCounts; for one lane's arguments in place, `one`, only one
// lane's counts).
Kernel chain_rows(bool D, int R, int plan, bool one = false) {
  static_assert(sizeof(kDecoderFwdRowCounts) == 4 * sizeof(int) &&
                    sizeof(kMultiFwdRowCounts) == 5 * sizeof(int),
                "the switches");
  if (one) {
    if (D)
      return R == kDecoderFwdRows
                 ? chain_for<kDecoderFwdRows, true, false>(plan)
                 : nullptr;
    if (R == kMultiTrainRows)
      return chain_for<kMultiTrainRows, false, false>(plan);
    return R == kMultiEvalRows ? chain_for<kMultiEvalRows, false, false>(plan)
                               : nullptr;
  }
  if (D) {
    switch (R) {
      case kDecoderFwdRowCounts[0]:
        return chain_for<kDecoderFwdRowCounts[0], true>(plan);
      case kDecoderFwdRowCounts[1]:
        return chain_for<kDecoderFwdRowCounts[1], true>(plan);
      case kDecoderFwdRowCounts[2]:
        return chain_for<kDecoderFwdRowCounts[2], true>(plan);
      case kDecoderFwdRowCounts[3]:
        return chain_for<kDecoderFwdRowCounts[3], true>(plan);
      default: return nullptr;
    }
  }
  switch (R) {
    case kMultiFwdRowCounts[0]:
      return chain_for<kMultiFwdRowCounts[0], false>(plan);
    case kMultiFwdRowCounts[1]:
      return chain_for<kMultiFwdRowCounts[1], false>(plan);
    case kMultiFwdRowCounts[2]:
      return chain_for<kMultiFwdRowCounts[2], false>(plan);
    case kMultiFwdRowCounts[3]:
      return chain_for<kMultiFwdRowCounts[3], false>(plan);
    case kMultiFwdRowCounts[4]:
      return chain_for<kMultiFwdRowCounts[4], false>(plan);
    default: return nullptr;
  }
}

// The plan and the launch of every lane's chains at R rows a block: the
// smallest cluster whose blocks fit, else the weights read from L2, else
// with them the state in the scratch (lstm_common.cuh's chain_plan);
// kNeedScratch, launching nothing, while the scratch is short of what that
// plan takes (every lane's blocks their own slices). One lane at one
// lane's count takes the kernel that reads its arguments in place.
int launch(ChainFwdLanes la, bool D, int R, int lanes,
           const Scratch& scratch, int* fit, cudaStream_t stream) {
  ChainFwdArgs& a = la.a;
  size_t bytes = 0;
  auto at = [&](int C) { return fwd_chain_bytes(a.cells, R, kThreads, C); };
  const int plan = chain_plan(at, [&] { return at(kWeightsL2); }, &bytes);
  fit[kFitChainA] = plan;
  const int C = plan_blocks(plan);
  const dim3 grid(((a.n + R - 1) / R) * C, a.cells.count, lanes);
  if (plan == kStateScratch) {
    a.state = reserve(scratch, (long long)grid.x * grid.y * lanes, bytes,
                      &a.slice);
    if (a.state == nullptr) return kNeedScratch;
  }
  const bool one = lanes == 1 && chain_rows(D, R, plan, true) != nullptr;
  const Kernel kernel = chain_rows(D, R, plan, one);
  bytes = plan_smem(plan, bytes);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(kernel, grid, kThreads, bytes, C, stream, la);
}

// Lane 0's arguments and the strides of the arrays given, in the entry
// points' lane_strides order (`at`: each array's ChainFwdLane), checked;
// false where a width, the rows or the lanes are refused.
template <int N>
bool make_lanes(const ChainFwdArgs& a, const int (&at)[N], bool D, int rows,
                int n_cells, const int* cell_dims, int lanes,
                const long long* lane_strides, const Scratch& scratch,
                ChainFwdLanes* out) {
  out->a = a;
  for (int i = 0; i < kChainFwdLanes; ++i) out->stride[i] = 0;
  if (scratch.need == nullptr || lanes < 1 || lanes > 65535 ||
      lane_strides == nullptr || chain_rows(D, rows, 1) == nullptr)
    return false;
  for (int i = 0; i < N; ++i) out->stride[at[i]] = lane_strides[i];
  *scratch.need = 0;
  return make_cells(n_cells, cell_dims, a.H, &out->a.cells) && a.t >= 1 &&
         a.n >= 1;
}

}  // namespace
}  // namespace ftt

// All arrays float32 and contiguous, shaped as in ChainFwdArgs; b is (1,
// 4H) or (4H,). cell_dims (host memory) lists the n_cells fused hidden
// widths, summing to H. rows: the batch rows a block takes, one of
// kDecoderFwdRowCounts; 0 takes one lane's, kDecoderFwdRows; another
// count is refused. state (state_floats floats of device memory, or null)
// is the scratch of the kStateScratch plan; state_need (host memory, one
// value) gets the floats the plan takes, and the launcher returns
// kNeedScratch (-1) without launching while state_floats is short of it.
// fit (host memory, six ints, lstm_common.cuh's Fit) gets the plan the
// chain ran on (a cluster, kWeightsL2 or kStateScratch), the same for
// every lane. Each array is the lane-0 one of `lanes`, one launch for them
// all; lane_strides (host memory) the floats from one lane's array to the
// next, one for each array argument in order (0: shared).
extern "C" int decoder_lstm_fwd(const float* h0, const float* c0,
                                const float* wsum, const float* b,
                                float* allh, float* allc, float* gates,
                                float* state, long long state_floats,
                                long long* state_need, int t, int n, int H,
                                int n_cells, const int* cell_dims, int rows,
                                int lanes, const long long* lane_strides,
                                int* fit, void* stream) {
  using namespace ftt;
  clear_fit(fit);
  const Scratch scratch = {state, state_floats, state_need};
  const ChainFwdArgs a = {b,    0,    0,     h0,    c0,
                          wsum, nullptr, allh, allc, gates,
                          phase_clocks(), nullptr, 0, t, n, H, {}};
  const int at[] = {kLaneH0,   kLaneC0,   kLaneW,    kLaneX,
                    kLaneAllh, kLaneAllc, kLaneGates};
  const int R = rows != 0 ? rows : kDecoderFwdRows;
  ChainFwdLanes la;
  if (!make_lanes(a, at, true, R, n_cells, cell_dims, lanes, lane_strides,
                  scratch, &la) ||
      !allh || !allc || !gates)
    return (int)cudaErrorInvalidValue;
  return launch(la, true, R, lanes, scratch, fit,
                static_cast<cudaStream_t>(stream));
}

// The same for the encoder cells: with_res 0 is the eval variant (allh,
// allc and gates may be null), 1 the train variant; rows one of
// kMultiFwdRowCounts, 0 one lane's (kMultiTrainRows with residuals,
// kMultiEvalRows without); lane_strides for xp, wh, h_last, allh, allc and
// gates.
extern "C" int multi_lstm_fwd(const float* xp, const float* wh,
                              float* h_last, float* allh, float* allc,
                              float* gates, float* state,
                              long long state_floats, long long* state_need,
                              int t, int n, int H, int n_cells,
                              const int* cell_dims, int with_res, int rows,
                              int lanes, const long long* lane_strides,
                              int* fit, void* stream) {
  using namespace ftt;
  clear_fit(fit);
  const Scratch scratch = {state, state_floats, state_need};
  if (!with_res) allh = allc = gates = nullptr;
  const ChainFwdArgs a = {xp,     (size_t)n * 4 * H, 4 * H, nullptr,
                          nullptr, wh, h_last, allh, allc, gates,
                          phase_clocks(), nullptr, 0, t, n, H, {}};
  const int at[] = {kLaneX,    kLaneW,    kLaneHLast,
                    kLaneAllh, kLaneAllc, kLaneGates};
  const int R = rows != 0 ? rows : with_res ? kMultiTrainRows
                                            : kMultiEvalRows;
  ChainFwdLanes la;
  if (!make_lanes(a, at, false, R, n_cells, cell_dims, lanes, lane_strides,
                  scratch, &la) ||
      h_last == nullptr || (with_res && (!allh || !allc || !gates)))
    return (int)cudaErrorInvalidValue;
  return launch(la, false, R, lanes, scratch, fit,
                static_cast<cudaStream_t>(stream));
}

// The blocks of the decoders' (decoder 1) or the encoder cells' (0) chain
// at `rows` rows a block on chain plan `plan` (a cluster of 1, 2, 4 or 8,
// kWeightsL2 or kStateScratch), `threads` threads and `smem` bytes of
// dynamic shared memory that the current card holds at once (*wave), as
// lstm_chain_bwd_wave: the lane plan's waves (cuda_lstm.chain_fwd_plan).
// The encoder cells' eval and train variants are one instantiation.
// Refuses a count or plan with no instantiation.
extern "C" int lstm_chain_fwd_wave(int decoder, int rows, int plan,
                                   int threads, long long smem, int* wave) {
  using namespace ftt;
  if (wave == nullptr || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || smem < 0 || smem > kMaxSmemBytes ||
      !known_plan(plan) || (decoder != 0 && decoder != 1))
    return (int)cudaErrorInvalidValue;
  const Kernel k = chain_rows(decoder == 1, rows, plan);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)blocks_at_once(reinterpret_cast<const void*>(k), threads,
                             (size_t)smem, wave);
}
