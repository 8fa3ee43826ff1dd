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

#include <cuda_runtime.h>
#include <math.h>

#include "cell_bwd.cuh"
#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;
// Batch rows a decoder block takes: one was the fastest at the training
// batch (perf_probe.py train, PERF.md), and a block of 8 rows or more does
// not fit beside the 104-unit cell's weights.
constexpr int kDecoderRows = 1;
// Batch rows an encoder-cell block takes: two was the fastest at the
// training batch at kl_ef's and missing's widths (PERF.md). perf_probe.py
// rows sweeps it by rebuilding with -DFTT_MULTI_ROWS=<rows>.
#ifndef FTT_MULTI_ROWS
#define FTT_MULTI_ROWS 2
#endif
constexpr int kMultiRows = FTT_MULTI_ROWS;

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

// Operand floats a row and unit: gates 4, c, c_prev, and for the decoders
// dallh of the step before.
template <bool D>
__host__ __device__ constexpr int op_width() {
  return D ? 7 : 6;
}

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
// cluster of C its share of the cell's gate columns. D: the decoders. L2:
// the weights read in place (C = 1); S: with them the state in the
// block's scratch slice (kStateScratch).
// __grid_constant__: the cell table is indexed by blockIdx.y, which
// otherwise makes every thread copy the argument struct to local memory
// (a stack frame in ptxas's report, about 1% of the decoder chain:
// PERF.md).
template <typename In, int R, int C, bool D, bool L2, bool S = false>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_chain_bwd_kernel(const __grid_constant__ In la) {
  static_assert(!S || (L2 && C == 1), "the scratch plan reads from L2");
  const ChainBwdArgs& a = lane_of(la);
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const CellTile c =
      cell_tile<C, L2>(a.cells, blockIdx.y, blockDim.x, rank, a.H);
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
  const int step_floats = op_width<D>() * h * R;
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

template <int R, bool D>
size_t chain_bytes(const ChainBwdArgs& a, int threads, int C) {
  return cell_chain_bytes(a.cells, R, threads, op_width<D>(), C);
}

// The plan and the launch: the smallest cluster whose blocks fit, else
// the weights read from L2, else with them the state in the scratch
// (lstm_common.cuh's chain_plan); kNeedScratch, launching nothing, while
// the scratch is short of what that plan takes.
// a is lane 0's arguments, lane(k) lane k's (its pointers; the rest is
// a's).
template <int R, bool D, typename F>
int launch(ChainBwdArgs a, F lane, int lanes, const Scratch& scratch,
           int threads, int* fit, cudaStream_t stream) {
  size_t bytes = 0;
  auto at = [&](int c) { return chain_bytes<R, D>(a, threads, c); };
  const int plan = chain_plan(at, [&] { return at(kWeightsL2); }, &bytes);
  fit[kFitChainA] = plan;
  const int C = plan_blocks(plan);
  const dim3 grid(((a.n + R - 1) / R) * C, a.cells.count);
  if (plan == kStateScratch) {
    a.state = reserve(scratch,
                      (long long)grid.x * grid.y * lanes_at_once(lanes),
                      bytes, &a.slice);
    if (a.state == nullptr) return kNeedScratch;
  }
  using A = ChainBwdArgs;
  const LaneKernel<A> kernels[6] = {
      FTT_LANE_KERNEL(A, lstm_chain_bwd_kernel, R, 1, D, true),
      FTT_LANE_KERNEL(A, lstm_chain_bwd_kernel, R, 1, D, false),
      FTT_LANE_KERNEL(A, lstm_chain_bwd_kernel, R, 2, D, false),
      FTT_LANE_KERNEL(A, lstm_chain_bwd_kernel, R, 4, D, false),
      FTT_LANE_KERNEL(A, lstm_chain_bwd_kernel, R, 8, D, false),
      FTT_LANE_KERNEL(A, lstm_chain_bwd_kernel, R, 1, D, true, true)};
  const LaneKernel<A> kernel = chain_kernel(kernels, plan);
  bytes = plan_smem(plan, bytes);
  cudaError_t err = allow_lane_smem(kernel, lanes, bytes);
  if (err != cudaSuccess) return (int)err;
  auto args = [&](int k) {
    ChainBwdArgs b = a;
    const ChainBwdArgs l = lane(k);
    b.gates = l.gates;
    b.allc = l.allc;
    b.dallh = l.dallh;
    b.dhlast = l.dhlast;
    b.w = l.w;
    b.dgates = l.dgates;
    b.dh0 = l.dh0;
    b.dc0 = l.dc0;
    return b;
  };
  return (int)launch_lane_kernel(kernel, grid, threads, bytes, C, stream,
                                 lanes, args);
}

bool valid(const ChainBwdArgs& a, int n_cells, const int* cell_dims,
           int threads, int lanes, const long long* lane_strides,
           const Scratch& scratch, ChainBwdArgs* out) {
  *out = a;
  if (scratch.need == nullptr || lanes < 1 || lane_strides == nullptr)
    return false;
  *scratch.need = 0;
  return make_cells(n_cells, cell_dims, a.H, &out->cells) && a.n >= 1 &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace
}  // namespace ftt

// All arrays float32 and contiguous, shaped as in ChainBwdArgs; t >= 2.
// cell_dims (host memory) lists the n_cells fused hidden widths, summing
// to H. threads is a multiple of 32 up to 512. state (state_floats
// floats of device memory, or null) is the scratch of the kStateScratch
// plan; state_need (host memory, one value) gets the floats the plan
// takes, and the launcher returns kNeedScratch (-1) without launching
// while state_floats is short of it. fit (host memory, six ints,
// lstm_common.cuh's Fit) gets the plan the chain ran on (a cluster,
// kWeightsL2 or kStateScratch), the same for every lane. Each array is
// the lane-0 one of `lanes`; lane_strides (host memory) the floats from
// one lane's array to the next, one for each array argument in order (0:
// shared), as lstm_fwd.cu's launchers take them.
extern "C" int decoder_lstm_bwd(const float* gates, const float* allc,
                                const float* dallh, const float* wsum,
                                float* dgates, float* dh0, float* dc0,
                                float* state, long long state_floats,
                                long long* state_need, int t, int n, int H,
                                int n_cells, const int* cell_dims,
                                int threads, int lanes,
                                const long long* lane_strides, int* fit,
                                void* stream) {
  using namespace ftt;
  clear_fit(fit);
  const Scratch scratch = {state, state_floats, state_need};
  const long long* ls = lane_strides;
  auto lane = [=](int k) {
    return ChainBwdArgs{at_lane(gates, ls, 0, k), at_lane(allc, ls, 1, k),
                        at_lane(dallh, ls, 2, k), nullptr,
                        at_lane(wsum, ls, 3, k),  at_lane(dgates, ls, 4, k),
                        at_lane(dh0, ls, 5, k),   at_lane(dc0, ls, 6, k),
                        phase_clocks(),           nullptr,
                        0,                        t,
                        n,                        H,
                        {}};
  };
  ChainBwdArgs a;
  if (lane_strides == nullptr ||
      !valid(lane(0), n_cells, cell_dims, threads, lanes, ls, scratch, &a) ||
      t < 2)
    return (int)cudaErrorInvalidValue;
  return launch<kDecoderRows, true>(a, lane, lanes, scratch, threads, fit,
                                    static_cast<cudaStream_t>(stream));
}

// The same for the encoder cells, t >= 1.
extern "C" int multi_lstm_bwd(const float* gates, const float* allc,
                              const float* dhlast, const float* wh,
                              float* dxp, float* state,
                              long long state_floats, long long* state_need,
                              int t, int n, int H, int n_cells,
                              const int* cell_dims, int threads, int lanes,
                              const long long* lane_strides, int* fit,
                              void* stream) {
  using namespace ftt;
  clear_fit(fit);
  const Scratch scratch = {state, state_floats, state_need};
  const long long* ls = lane_strides;
  auto lane = [=](int k) {
    return ChainBwdArgs{at_lane(gates, ls, 0, k), at_lane(allc, ls, 1, k),
                        nullptr,                  at_lane(dhlast, ls, 2, k),
                        at_lane(wh, ls, 3, k),    at_lane(dxp, ls, 4, k),
                        nullptr,                  nullptr,
                        phase_clocks(),           nullptr,
                        0,                        t,
                        n,                        H,
                        {}};
  };
  ChainBwdArgs a;
  if (lane_strides == nullptr ||
      !valid(lane(0), n_cells, cell_dims, threads, lanes, ls, scratch, &a) ||
      t < 1)
    return (int)cudaErrorInvalidValue;
  return launch<kMultiRows, false>(a, lane, lanes, scratch, threads, fit,
                                   static_cast<cudaStream_t>(stream));
}
