// Fused autoregressive decoders, backward.
//
// Replaces: factorized_tpu/ops/pallas_lstm.py::_dec_bwd_kernel (reached
// through _dec_bwd_call and the custom_vjp backward _decoder_bwd of
// decoder_lstm).
//
// What it computes: BPTT through the t - 1 transitions of the decoder
// recurrence gates = h @ wsum + b, from the forward's pre-activation gates
// and cell states and the cotangent dallh (t, n, H) of every hidden state.
// Walking i from t - 1 down to 1 it carries
//   dc += dh * so * (1 - tanh(c_i)^2);  dgates_i from the gate math;
//   dh = dgates_i @ wsum^T + dallh[i - 1];  dc = dc * sf,
// starting from dh = dallh[t - 1], dc = 0. It writes dgates (t - 1, n, 4H),
// transition i in slot i - 1, and the final carries dh0 and dc0 (n, H).
// dwsum = allh[:-1]^T dgates and db stay outside, a GEMM and a sum, as in
// the JAX package.
//
// What bounds it on an H100: bytes, narrowly. At the training batch
// (n = 32, t = 20, best_acc_mosi_config, H = 152) the traffic is 4.2 MB
// (1.3 us at 3.35 TB/s), most of it the gates read and dgates written,
// against 0.06 GFLOP of float32 work (the dh product over the diagonal
// blocks of wsum, 0.9 us at 67 TFLOP/s). In practice the serial chain of
// t - 1 dependent steps bounds it: what is left is each step's two block
// barriers and the dh product's latency from shared memory.
//
// What the design does about it: the cells are independent chains, so one
// block owns one cell and kRows batch rows (cell_bwd.cuh). It keeps the
// cell's four diagonal blocks of wsum in shared memory, transposed (the
// 104-unit cell's 169 KiB fits one SM), so the chain reads no weight from
// L2; the next step's gates, cell states and dallh are copied in with
// cp.async while the current step runs. A few lanes share each unit of
// the dh product and shuffles add their partial sums in a fixed order: no
// atomics, the same bits on every run. Float32 on the CUDA cores: a TF32
// product keeps about three digits, too few for the gradient tolerances,
// and a tile of kRows batch rows is far below wgmma's 64. A launch whose
// shared memory would pass the card's 227 KB is refused before it starts.

#include <cuda_runtime.h>
#include <math.h>

#include "cell_bwd.cuh"
#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;
constexpr int kOpWidth = 7;  // gates 4h, c, c_prev, dallh_prev: 7h a row
// Batch rows a block takes: one was the fastest at the training batch
// (perf_probe.py train, PERF.md), and a block of 8 rows or more does not
// fit beside the 104-unit cell's weights.
constexpr int kRows = 1;

struct DecoderBwdArgs {
  const float* gates;  // (t, n, 4H), slot 0 unused
  const float* allc;   // (t, n, H)
  const float* dallh;  // (t, n, H)
  const float* wsum;   // (H, 4H)
  float* dgates;       // (t - 1, n, 4H)
  float* dh0;          // (n, H)
  float* dc0;          // (n, H)
  int t, n, H;
  Cells cells;
};

// The operands of transition s (s >= 1) into the buffer at `base`: the
// cell step's, then dallh[s - 1]; asynchronously.
template <int R>
__device__ __forceinline__ void load_step(const DecoderBwdArgs& a, int s,
                                          float* base, const CellTile& c,
                                          int row0, int tid, int nthr) {
  const int H = a.H;
  const CellStep op = cell_step(base, c.h, R, false);
  float* const up = op.cp + c.h * R;
  for (int q = 0; q < 4; ++q)
    load_rows_async<R>(op.g + q * c.h * R, a.gates, s, a.n, 4 * H,
                       q * H + c.k0, c.h, row0, tid, nthr);
  load_rows_async<R>(op.c, a.allc, s, a.n, H, c.k0, c.h, row0, tid, nthr);
  load_rows_async<R>(op.cp, a.allc, s - 1, a.n, H, c.k0, c.h, row0, tid,
                     nthr);
  load_rows_async<R>(up, a.dallh, s - 1, a.n, H, c.k0, c.h, row0, tid, nthr);
}

// blockIdx.y is the cell, blockIdx.x the row tile.
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    decoder_lstm_bwd_kernel(const DecoderBwdArgs a) {
  extern __shared__ float smem[];
  const CellTile c = cell_tile(a.cells, blockIdx.y, blockDim.x);
  const int h = c.h, H = a.H;
  float* const w = smem;
  float* const dh = w + h * c.wp;
  float* const dc = dh + pad4(h * R);
  float* const dg = dc + pad4(h * R);
  // two operand buffers of kOpWidth h R floats: gates, c, c_prev, then
  // dallh of the step before; step s uses buffer s & 1
  float* const buf = dg + 4 * h * R;
  const int step_floats = kOpWidth * h * R;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

  load_cell_weights(w, a.wsum, H, c, tid, nthr);
  load_rows_async<R>(dh, a.dallh, a.t - 1, a.n, H, c.k0, h, row0, tid, nthr);
  for (int i = tid; i < h * R; i += nthr) dc[i] = 0.0f;
  load_step<R>(a, a.t - 1, buf + ((a.t - 1) & 1) * step_floats, c, row0,
               tid, nthr);
  cp_async_wait_all();
  __syncthreads();

  for (int s = a.t - 1; s >= 1; --s) {
    if (s > 1)
      load_step<R>(a, s - 1, buf + ((s - 1) & 1) * step_floats, c, row0, tid,
                   nthr);
    const CellStep op = cell_step(buf + (s & 1) * step_floats, h, R, false);
    cell_gate_bwd<R>(op, dh, dc, dg, a.dgates, s - 1, a.n, H, c, row0, tid,
                     nthr);
    __syncthreads();
    cell_dh<R>(w, dg, op.cp + h * R, dh, c, lane, warp, nwarp);
    cp_async_wait_all();
    __syncthreads();
  }

  for (int i = tid; i < R * h; i += nthr) {
    const int r = i / h, j = i - r * h, row = row0 + r;
    if (row < a.n) {
      a.dh0[(size_t)row * H + c.k0 + j] = dh[j * R + r];
      a.dc0[(size_t)row * H + c.k0 + j] = dc[j * R + r];
    }
  }
}

cudaError_t launch(const DecoderBwdArgs& a, int threads, int* need,
                   cudaStream_t stream) {
  const size_t bytes = cell_chain_bytes(a.cells, kRows, threads, kOpWidth);
  if (bytes > (size_t)kMaxSmemBytes) {
    need[0] = 1;
    need[1] = (int)bytes;
    need[2] = kMaxSmemBytes;
    return cudaErrorInvalidValue;
  }
  const auto kernel = decoder_lstm_bwd_kernel<kRows>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kRows - 1) / kRows, a.cells.count);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ftt

// All arrays float32 and contiguous, shaped as in DecoderBwdArgs; t >= 2.
// cell_dims (host memory) lists the n_cells fused hidden widths, summing
// to H. threads is a multiple of 32 up to 512. need (host memory, three
// ints) is left zero, or, when the shared memory a block needs passes the
// card's, set to {1, bytes, the card's limit} before the launch is
// refused.
extern "C" int decoder_lstm_bwd(const float* gates, const float* allc,
                                const float* dallh, const float* wsum,
                                float* dgates, float* dh0, float* dc0, int t,
                                int n, int H, int n_cells,
                                const int* cell_dims, int threads, int* need,
                                void* stream) {
  using namespace ftt;
  DecoderBwdArgs a;
  a.gates = gates;
  a.allc = allc;
  a.dallh = dallh;
  a.wsum = wsum;
  a.dgates = dgates;
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.t = t;
  a.n = n;
  a.H = H;
  need[0] = need[1] = need[2] = 0;
  if (!make_cells(n_cells, cell_dims, H, &a.cells) || t < 2 || n < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch(a, threads, need, static_cast<cudaStream_t>(stream));
}
