// The recurrences' backward chains: the fused autoregressive decoders and
// the fused encoder cells (multi_lstm), one kernel for both.
//
// Replaces: factorized_tpu/ops/pallas_lstm.py::_dec_bwd_kernel (reached
// through _dec_bwd_call and the custom_vjp backward _decoder_bwd of
// decoder_lstm) and ::_enc_bwd_kernel (through _enc_bwd_call and the
// custom_vjp backward _multi_lstm_bwd of multi_lstm).
//
// What it computes: BPTT through an LSTM recurrence from the forward's
// pre-activation gates and cell states. Walking the steps backwards it
// carries
//   dc += dh * so * (1 - tanh(c_i)^2);  dgates_i from the gate math;
//   dh = dgates_i @ W^T (+ dallh[i - 1]);  dc = dc * sf.
// The decoders (gates = h @ wsum + b over t - 1 transitions) start from
// dh = dallh[t - 1], add the cotangent dallh of every hidden state, stop
// at transition 1 and write dgates (t - 1, n, 4H), transition i in slot
// i - 1, and the final carries dh0 and dc0 (n, H). The encoder cells
// (gates = xp + h @ wh over t steps from a zero state) start from the
// cotangent dhlast of the last hidden state, walk down to step 0, whose
// previous cell state is zero, and write dxp = dgates (t, n, 4H). The
// weight gradients (dwsum = allh[:-1]^T dgates, db, dWh) stay outside,
// one GEMM and a sum, as in the JAX package.
//
// What bounds it on an H100: bytes, narrowly. At the training batch
// (n = 32, t = 20, best_acc_mosi_config) the decoders (H = 152) move 4.2
// MB (1.3 us at 3.35 TB/s) against 0.06 GFLOP (0.9 us at 67 TFLOP/s);
// the kl_ef encoders (H = 240) 6.4 MB against 0.11 GFLOP, most of it the
// gates read and dgates written. In practice the serial chain of
// dependent steps bounds it: what is left is each step's two barriers
// and the dh product's latency from shared memory.
//
// What the design does about it: the cells are independent chains, so one
// block (or cluster) owns one cell and R batch rows (cell_bwd.cuh). It
// keeps the cell's four diagonal blocks of W in shared memory (the
// 104-unit decoder cell's 169 KiB fits one SM), so the chain reads no
// weight from L2; the next step's operands are copied in with cp.async
// while the current step runs. A cell that does not fit one SM, such as
// kl_ef's 120-unit cell (225 KiB), splits its gate columns over a cluster
// of 2, 4 or 8 blocks, the smallest that fits; past 8 (a 336-unit decoder
// cell of a search draw) the chain reads the weights in place from L2,
// one block a row tile, chosen from the widths before the launch; past a
// block's state too (more than about 1,614 units in multi_lstm's 2-row
// chains, 2,905 in the decoders' 1-row ones) the same chain keeps dh, dc,
// dg and the two steps' operands in a slice of device memory a block
// (lstm_common.cuh's kStateScratch). A few lanes share each unit of the dh product
// and shuffles add their partial sums in a fixed order, a cluster's
// partials add in rank order: no atomics, the same bits on every run.
// Float32 on the CUDA cores: a TF32 product keeps about three digits, too
// few for the gradient tolerances, and a tile of R batch rows is far
// below wgmma's 64.
//
// Lanes: K problems of one shape (K seeds' or configs' recurrences) in one
// launch, whatever K: lane 0's arguments and each array's floats from one
// lane's to the next (0 where the lanes share it), lane k's blocks those
// of blockIdx.z = k, which add k strides to each pointer
// (ChainBwdLanes). A lane's blocks do the one-lane launch's arithmetic,
// so lane k's bits do not depend on K. The batch rows a block are chosen
// on the host from K and n (cuda_lstm.chain_bwd_plan) among the
// instantiated counts; the dh product's split over a block's lanes (ks)
// follows the cell's width and the threads, not the rows, so each row's
// sums keep their order at every count.

#include <cuda_runtime.h>
#include <math.h>

#include "cell_bwd.cuh"
#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;
// Batch rows a block of the decoders' and of the encoder cells' chains
// takes: one of these instantiated counts, chosen on the host
// (cuda_lstm.chain_bwd_plan, which lists the same counts). A decoder block
// of 8 rows or more does not fit beside the 104-unit cell's weights.
constexpr int kDecoderRowCounts[] = {1, 2, 4};
constexpr int kMultiRowCounts[] = {1, 2, 4, 8};
// The counts one lane takes, at any batch: the decoders' one row was the
// fastest at the training batch (perf_probe.py train, PERF.md), the
// encoder cells' two at kl_ef's and missing's widths; perf_probe.py rows
// sweeps the latter by rebuilding with -DFTT_MULTI_ROWS=<rows>.
#ifndef FTT_MULTI_ROWS
#define FTT_MULTI_ROWS 2
#endif
constexpr int kDecoderRows = kDecoderRowCounts[0];
constexpr int kMultiRows = FTT_MULTI_ROWS;
static_assert(listed(kMultiRowCounts, kMultiRows),
              "one lane's rows are an instantiated count");

struct ChainBwdArgs {
  const float* gates;   // (t, n, 4H); the decoders' slot 0 unused
  const float* allc;    // (t, n, H)
  const float* dallh;   // decoders: (t, n, H); else null
  const float* dhlast;  // encoder cells: (n, H); else null
  const float* w;       // (H, 4H): wsum or wh
  float* dgates;        // decoders: (t - 1, n, 4H); encoder cells (t, n, 4H)
  float* dh0;           // decoders: (n, H)
  float* dc0;           // decoders: (n, H)
  long long* clocks;    // the per-phase probe's buffer, or null
  float* state;         // kStateScratch: the blocks' state slices
  size_t slice;         // floats a slice
  int t, n, H;
  Cells cells;
};

// The lane strides of the chain's arrays (ChainBwdArgs' pointers).
enum ChainBwdLane {
  kLaneGates,
  kLaneAllc,
  kLaneDallh,
  kLaneDhlast,
  kLaneW,
  kLaneDgates,
  kLaneDh0,
  kLaneDc0,
  kChainBwdLanes
};

// The kernel's argument: lane 0's arguments and the lane strides.
struct ChainBwdLanes {
  ChainBwdArgs a;
  long long stride[kChainBwdLanes];
};

using Kernel = void (*)(ChainBwdLanes);

// This block's lane's arguments (blockIdx.z = k): lane 0's with k strides
// added to each pointer (a null one has stride 0 and stays null). The cell
// table is read from `la.a.cells`, in place: a block indexes it by its
// cell.
__device__ __forceinline__ ChainBwdArgs lane_args(const ChainBwdLanes& la) {
  ChainBwdArgs a = la.a;
  const long long z = blockIdx.z;
  const long long* s = la.stride;
  a.gates += z * s[kLaneGates];
  a.allc += z * s[kLaneAllc];
  a.dallh += z * s[kLaneDallh];
  a.dhlast += z * s[kLaneDhlast];
  a.w += z * s[kLaneW];
  a.dgates += z * s[kLaneDgates];
  a.dh0 += z * s[kLaneDh0];
  a.dc0 += z * s[kLaneDc0];
  return a;
}

// Operand floats a row and unit: gates 4, c, c_prev, and for the decoders
// dallh of the step before.
__host__ __device__ constexpr int op_width(bool D) { return D ? 7 : 6; }

// The operands of step s into the buffer at `base`: the cell step's (a
// zero c_prev before step 0), then for the decoders dallh[s - 1];
// asynchronously.
template <int R, bool D, bool S>
__device__ __forceinline__ void load_step(const ChainBwdArgs& a, int s,
                                          float* base, const CellTile& c,
                                          int row0, int tid, int nthr) {
  const int H = a.H;
  const CellStep op = cell_step(base, c.h, R, false);
  for (int q = 0; q < 4; ++q)
    load_rows_async<R, S>(op.g + q * c.h * R, a.gates, s, a.n, 4 * H,
                          q * H + c.k0, c.h, row0, tid, nthr);
  load_rows_async<R, S>(op.c, a.allc, s, a.n, H, c.k0, c.h, row0, tid, nthr);
  load_rows_async<R, S>(op.cp, s > 0 ? a.allc : nullptr, s - 1, a.n, H,
                        c.k0, c.h, row0, tid, nthr);
  if (D)
    load_rows_async<R, S>(op.cp + c.h * R, a.dallh, s - 1, a.n, H, c.k0,
                          c.h, row0, tid, nthr);
}

// blockIdx.y is the cell, blockIdx.x / C the row tile and the rank in the
// cluster of C its share of the cell's gate columns, blockIdx.z the lane.
// D: the decoders. L2: the weights read in place (C = 1); S: with them the
// state in the block's scratch slice (kStateScratch).
// __grid_constant__: the cell table is indexed by blockIdx.y, which
// otherwise makes every thread copy the argument struct to local memory
// (a stack frame in ptxas's report, about 1% of the decoder chain:
// PERF.md).
template <int R, int C, bool D, bool L2, bool S>
__device__ __forceinline__ void lstm_chain_bwd(const ChainBwdArgs& a,
                                               const Cells& cells) {
  static_assert(!S || (L2 && C == 1), "the scratch plan reads from L2");
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const CellTile c =
      cell_tile<C, L2>(cells, blockIdx.y, blockDim.x, rank, a.H);
  const int h = c.h, H = a.H;
  // the chain's last step: the decoders' transition 1, the cells' step 0
  const int last = D ? 1 : 0;
  const float* const w = cell_weights<L2>(smem, a.w, H, c.k0);
  float* const dh =
      state_base<S>(smem, a.state, a.slice) + (L2 ? 0 : h * c.wp);
  float* const dc = dh + pad4(h * R);
  // 4h columns (dg_at); for a cluster C kc, the columns past 4h zero
  float* const dg = dc + pad4(h * R);
  // two operand buffers: gates, c, c_prev (and dallh of the step before);
  // step s uses buffer s & 1; then, for a cluster, two partial dh
  float* const buf = dg + dg_floats(C == 1 ? 4 * h : C * c.kc, R);
  const int step_floats = op_width(D) * h * R;
  float* const part = buf + 2 * step_floats;
  const int row0 = (blockIdx.x / C) * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

  if (!L2) load_cell_weights(smem, a.w, H, c, tid, nthr);
  load_rows_async<R, S>(dh, D ? a.dallh : a.dhlast, D ? a.t - 1 : 0, a.n,
                        H, c.k0, h, row0, tid, nthr);
  for (int i = tid; i < h * R; i += nthr) dc[i] = 0.0f;
  if (C > 1)
    for (int i = dg_floats(4 * h, R) + tid; i < dg_floats(C * c.kc, R);
         i += nthr)
      dg[i] = 0.0f;
  load_step<R, D, S>(a, a.t - 1, buf + ((a.t - 1) & 1) * step_floats, c,
                     row0, tid, nthr);
  cp_async_wait_all();
  __syncthreads();
  FTT_STAMP(a.clocks, D ? kClockDecoderBwd : kClockMultiBwd, 0, 0);

  for (int s = a.t - 1; s >= last; --s) {
    if (s > last)
      load_step<R, D, S>(a, s - 1, buf + ((s - 1) & 1) * step_floats, c,
                         row0, tid, nthr);
    const CellStep op = cell_step(buf + (s & 1) * step_floats, h, R, false);
    cell_gate_bwd<R, C>(op, dh, dc, dg, a.dgates, s - last, a.n, H, c,
                        row0, tid, nthr, rank);
    __syncthreads();
    FTT_STAMP(a.clocks, D ? kClockDecoderBwd : kClockMultiBwd, a.t - s, 0);
    if (!D && s == 0) break;  // no dh into the zero state before step 0
    const float* add = D ? op.cp + h * R : nullptr;
    if (C == 1) {
      cell_dh<R, 1, L2>(w, dg, add, dh, c, lane, warp, nwarp);
    } else {
      float* const mine = part + (s & 1) * pad4(h * R);
      cell_dh<R, C>(w, dg, nullptr, mine, c, lane, warp, nwarp);
      cluster_dh<C, R>(dh, mine, add, h, tid, nthr);
    }
    FTT_STAMP(a.clocks, D ? kClockDecoderBwd : kClockMultiBwd, a.t - s, 1);
    cp_async_wait_all();
    __syncthreads();
    FTT_STAMP(a.clocks, D ? kClockDecoderBwd : kClockMultiBwd, a.t - s, 2);
  }

  if (D && rank == 0) {
    for (int i = tid; i < R * h; i += nthr) {
      const int r = i / h, j = i - r * h, row = row0 + r;
      if (row < a.n) {
        a.dh0[(size_t)row * H + c.k0 + j] = dh[j * R + r];
        a.dc0[(size_t)row * H + c.k0 + j] = dc[j * R + r];
      }
    }
  }
  // no block leaves while a peer may still read its partials
  if (C > 1) cluster_barrier<C>();
}

// Instantiated for lanes by stride (Z) and, at one lane's row count, for
// one lane's arguments read in place (the launch as it was before lanes:
// no copy of the arguments, so the same code as a model without lanes).
template <int R, int C, bool D, bool L2, bool S = false, bool Z = true>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_chain_bwd_kernel(const __grid_constant__ ChainBwdLanes la) {
  if (Z)
    lstm_chain_bwd<R, C, D, L2, S>(lane_args(la), la.a.cells);
  else
    lstm_chain_bwd<R, C, D, L2, S>(la.a, la.a.cells);
}

// The kernel of a chain at R rows a block for a plan (lstm_common.cuh's
// chain_kernel); Z: lanes by stride.
template <int R, bool D, bool Z = true>
Kernel chain_for(int plan) {
  const Kernel k[6] = {lstm_chain_bwd_kernel<R, 1, D, true, false, Z>,
                       lstm_chain_bwd_kernel<R, 1, D, false, false, Z>,
                       lstm_chain_bwd_kernel<R, 2, D, false, false, Z>,
                       lstm_chain_bwd_kernel<R, 4, D, false, false, Z>,
                       lstm_chain_bwd_kernel<R, 8, D, false, false, Z>,
                       lstm_chain_bwd_kernel<R, 1, D, true, true, Z>};
  return chain_kernel(k, plan);
}

// The decoders' (D) or the encoder cells' kernel at R rows a block and a
// plan: null for a count with no instantiation (kDecoderRowCounts,
// kMultiRowCounts; for one lane's arguments in place, `one`, only one
// lane's count).
Kernel chain_rows(bool D, int R, int plan, bool one = false) {
  static_assert(sizeof(kDecoderRowCounts) == 3 * sizeof(int) &&
                    sizeof(kMultiRowCounts) == 4 * sizeof(int),
                "the switches");
  if (one) {
    if (D) return R == kDecoderRows ? chain_for<kDecoderRows, true, false>(plan)
                                    : nullptr;
    return R == kMultiRows ? chain_for<kMultiRows, false, false>(plan)
                           : nullptr;
  }
  if (D) {
    switch (R) {
      case kDecoderRowCounts[0]:
        return chain_for<kDecoderRowCounts[0], true>(plan);
      case kDecoderRowCounts[1]:
        return chain_for<kDecoderRowCounts[1], true>(plan);
      case kDecoderRowCounts[2]:
        return chain_for<kDecoderRowCounts[2], true>(plan);
      default: return nullptr;
    }
  }
  switch (R) {
    case kMultiRowCounts[0]: return chain_for<kMultiRowCounts[0], false>(plan);
    case kMultiRowCounts[1]: return chain_for<kMultiRowCounts[1], false>(plan);
    case kMultiRowCounts[2]: return chain_for<kMultiRowCounts[2], false>(plan);
    case kMultiRowCounts[3]: return chain_for<kMultiRowCounts[3], false>(plan);
    default: return nullptr;
  }
}

// The plan and the launch of every lane's chains at R rows a block: the
// smallest cluster whose blocks fit, else the weights read from L2, else
// with them the state in the scratch (lstm_common.cuh's chain_plan);
// kNeedScratch, launching nothing, while the scratch is short of what that
// plan takes (every lane's blocks their own slices). One lane at one
// lane's count takes the kernel that reads its arguments in place.
int launch(ChainBwdLanes la, bool D, int R, int lanes,
           const Scratch& scratch, int threads, int* fit,
           cudaStream_t stream) {
  ChainBwdArgs& a = la.a;
  size_t bytes = 0;
  auto at = [&](int c) {
    return cell_chain_bytes(a.cells, R, threads, op_width(D), c);
  };
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
  return (int)launch_clusters(kernel, grid, threads, bytes, C, stream, la);
}

// Lane 0's arguments and the strides of the arrays given, in the entry
// points' lane_strides order (`at`: each array's ChainBwdLane), checked;
// false where a width, the threads, the rows or the lanes are refused.
template <int N>
bool make_lanes(const ChainBwdArgs& a, const int (&at)[N], bool D, int rows,
                int n_cells, const int* cell_dims, int threads, int lanes,
                const long long* lane_strides, const Scratch& scratch,
                ChainBwdLanes* out) {
  out->a = a;
  for (int i = 0; i < kChainBwdLanes; ++i) out->stride[i] = 0;
  if (scratch.need == nullptr || lanes < 1 || lanes > 65535 ||
      lane_strides == nullptr || chain_rows(D, rows, 1) == nullptr)
    return false;
  for (int i = 0; i < N; ++i) out->stride[at[i]] = lane_strides[i];
  *scratch.need = 0;
  return make_cells(n_cells, cell_dims, a.H, &out->a.cells) && a.n >= 1 &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace
}  // namespace ftt

// All arrays float32 and contiguous, shaped as in ChainBwdArgs; t >= 2.
// cell_dims (host memory) lists the n_cells fused hidden widths, summing
// to H. threads is a multiple of 32 up to 512. rows: the batch rows a
// block takes, one of kDecoderRowCounts; 0 takes one lane's, kDecoderRows;
// another count is refused. state (state_floats floats of device memory,
// or null) is the scratch of the kStateScratch plan; state_need (host
// memory, one value) gets the floats the plan takes, and the launcher
// returns kNeedScratch (-1) without launching while state_floats is short
// of it. fit (host memory, six ints, lstm_common.cuh's Fit) gets the plan
// the chain ran on (a cluster, kWeightsL2 or kStateScratch), the same for
// every lane. Each array is the lane-0 one of `lanes`, one launch for them
// all; lane_strides (host memory) the floats from one lane's array to the
// next, one for each array argument in order (0: shared).
extern "C" int decoder_lstm_bwd(const float* gates, const float* allc,
                                const float* dallh, const float* wsum,
                                float* dgates, float* dh0, float* dc0,
                                float* state, long long state_floats,
                                long long* state_need, int t, int n, int H,
                                int n_cells, const int* cell_dims,
                                int threads, int rows, int lanes,
                                const long long* lane_strides, int* fit,
                                void* stream) {
  using namespace ftt;
  clear_fit(fit);
  const Scratch scratch = {state, state_floats, state_need};
  const ChainBwdArgs a = {gates, allc, dallh, nullptr, wsum, dgates, dh0,
                          dc0, phase_clocks(), nullptr, 0, t, n, H, {}};
  const int at[] = {kLaneGates, kLaneAllc,   kLaneDallh, kLaneW,
                    kLaneDgates, kLaneDh0, kLaneDc0};
  const int R = rows != 0 ? rows : kDecoderRows;
  ChainBwdLanes la;
  if (!make_lanes(a, at, true, R, n_cells, cell_dims, threads, lanes,
                  lane_strides, scratch, &la) ||
      t < 2)
    return (int)cudaErrorInvalidValue;
  return launch(la, true, R, lanes, scratch, threads, fit,
                static_cast<cudaStream_t>(stream));
}

// The same for the encoder cells, t >= 1; rows one of kMultiRowCounts, 0
// one lane's, kMultiRows.
extern "C" int multi_lstm_bwd(const float* gates, const float* allc,
                              const float* dhlast, const float* wh,
                              float* dxp, float* state,
                              long long state_floats, long long* state_need,
                              int t, int n, int H, int n_cells,
                              const int* cell_dims, int threads, int rows,
                              int lanes, const long long* lane_strides,
                              int* fit, void* stream) {
  using namespace ftt;
  clear_fit(fit);
  const Scratch scratch = {state, state_floats, state_need};
  const ChainBwdArgs a = {gates, allc, nullptr, dhlast, wh, dxp, nullptr,
                          nullptr, phase_clocks(), nullptr, 0, t, n, H, {}};
  const int at[] = {kLaneGates, kLaneAllc, kLaneDhlast, kLaneW, kLaneDgates};
  const int R = rows != 0 ? rows : kMultiRows;
  ChainBwdLanes la;
  if (!make_lanes(a, at, false, R, n_cells, cell_dims, threads, lanes,
                  lane_strides, scratch, &la) ||
      t < 1)
    return (int)cudaErrorInvalidValue;
  return launch(la, false, R, lanes, scratch, threads, fit,
                static_cast<cudaStream_t>(stream));
}

// The blocks of the decoders' (decoder 1) or the encoder cells' (0) chain
// at `rows` rows a block on chain plan `plan` (a cluster of 1, 2, 4 or 8,
// kWeightsL2 or kStateScratch), `threads` threads and `smem` bytes of
// dynamic shared memory that the current card holds at once (*wave), as
// mfm_encode_bwd_wave: the lane plan's waves (cuda_lstm.chain_bwd_plan).
// Refuses a count or plan with no instantiation.
extern "C" int lstm_chain_bwd_wave(int decoder, int rows, int plan,
                                   int threads, long long smem, int* wave) {
  using namespace ftt;
  if (wave == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || smem < 0 || smem > kMaxSmemBytes ||
      !known_plan(plan) || (decoder != 0 && decoder != 1))
    return (int)cudaErrorInvalidValue;
  const Kernel k = chain_rows(decoder == 1, rows, plan);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)blocks_at_once(reinterpret_cast<const void*>(k), threads,
                             (size_t)smem, wave);
}
