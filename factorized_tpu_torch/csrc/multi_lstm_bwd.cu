// Fused encoder cells (multi_lstm), backward.
//
// Replaces: factorized_tpu/ops/pallas_lstm.py::_enc_bwd_kernel (reached
// through _enc_bwd_call and the custom_vjp backward _multi_lstm_bwd of
// multi_lstm).
//
// What it computes: BPTT through the t steps of the fused encoder cells,
// from the forward's pre-activation gates and cell states and the cotangent
// dhlast of the last hidden state. Walking i from t - 1 down to 0 it
// carries
//   dc += dh * so * (1 - tanh(c_i)^2);  dgates_i from the gate math, with
//   the previous cell state c_{i-1} (zero at step 0);
//   dh = dgates_i @ wh^T;  dc = dc * sf,
// starting from dh = dhlast, dc = 0. It writes dxp (t, n, 4H), which is
// dgates, in every slot. dWh = allh[:-1]^T dxp[1:] stays outside, one GEMM,
// as in the JAX package.
//
// What bounds it on an H100: bytes, narrowly. At the training batch
// (n = 32, t = 20, best_acc_mosi_config) the kl_ef encoders (H = 240) move
// 6.4 MB (1.9 us at 3.35 TB/s), most of it the gates read and dxp written,
// against 0.11 GFLOP of float32 work (the dh product over the diagonal
// blocks of wh, 1.6 us at 67 TFLOP/s). In practice the serial chain of t
// dependent steps bounds it.
//
// What the design does about it: as decoder_lstm_bwd.cu, one block owns
// ROWS batch rows and loops over the steps itself; dh, dc and the step's
// dgates stay in shared memory, feature-major. Each thread computes one
// hidden unit's gate gradients for all its rows; the dh product is against
// wh transposed, so a warp computes one unit, its lanes reading the weight
// row coalesced over the unit's own cell and shuffles adding them in a
// fixed order: no atomics, the same bits on every run. Nothing else yet.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;

struct MultiBwdArgs {
  const float* gates;   // (t, n, 4H)
  const float* allc;    // (t, n, H)
  const float* dhlast;  // (n, H)
  const float* wh;      // (H, 4H)
  float* dxp;           // (t, n, 4H)
  int t, n, H;
  Cells cells;
};

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    multi_lstm_bwd_kernel(const MultiBwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, H4 = 4 * H;
  // feature-major [unit][R]: dh, dc, then the step's dgates
  float* const dh = smem;
  float* const dc = smem + H * R;
  float* const dg = smem + 2 * H * R;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

  for (int i = tid; i < R * H; i += nthr) {
    const int r = i / H, j = i - r * H, row = row0 + r;
    dh[j * R + r] = row < a.n ? a.dhlast[(size_t)row * H + j] : 0.0f;
    dc[j * R + r] = 0.0f;
  }
  __syncthreads();

  for (int s = a.t - 1; s >= 0; --s) {
    const size_t base = (size_t)s * a.n;
    // (1) each thread one hidden unit: the gate math's backward
    for (int j = tid; j < H; j += nthr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f, cp = 0.0f,
              ci = 0.0f;
        if (row < a.n) {
          const float* g = a.gates + (base + row) * H4 + j;
          gi = g[0];
          gf = g[H];
          gg = g[2 * H];
          go = g[3 * H];
          ci = a.allc[(base + row) * H + j];
          if (s > 0) cp = a.allc[(base - a.n + row) * H + j];
        }
        const float si = sigmoid(gi), sf = sigmoid(gf), so = sigmoid(go);
        const float tg = tanhf(gg), tc = tanhf(ci);
        const float dhv = dh[j * R + r];
        const float dcv = dc[j * R + r] + dhv * so * (1.0f - tc * tc);
        const float di = dcv * tg * si * (1.0f - si);
        const float df = dcv * cp * sf * (1.0f - sf);
        const float dgg = dcv * si * (1.0f - tg * tg);
        const float dov = dhv * tc * so * (1.0f - so);
        dg[j * R + r] = di;
        dg[(H + j) * R + r] = df;
        dg[(2 * H + j) * R + r] = dgg;
        dg[(3 * H + j) * R + r] = dov;
        if (row < a.n) {
          float* d = a.dxp + (base + row) * H4 + j;
          d[0] = di;
          d[H] = df;
          d[2 * H] = dgg;
          d[3 * H] = dov;
        }
        dc[j * R + r] = dcv * sf;
      }
    }
    __syncthreads();
    if (s == 0) break;  // dh of the zero initial state is not wanted

    // (2) dh = dgates @ wh^T over the unit's own cell block: a warp per
    //     unit, its lanes reading the weight row coalesced
    for (int k = warp; k < H; k += nwarp) {
      int j0, j1;
      cell_range(a.cells, k, j0, j1);
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const float* w = a.wh + (size_t)k * H4;
      for (int q = 0; q < 4; ++q) {
        for (int j = j0 + lane; j < j1; j += 32) {
          const float wv = __ldg(w + q * H + j);
          const float* g = dg + (q * H + j) * R;
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(g[r], wv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        for (int o = 16; o > 0; o >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane == r) dh[k * R + r] = acc[r];
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch(const MultiBwdArgs& a, int threads, cudaStream_t stream) {
  const size_t bytes = (size_t)R * 6 * a.H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      multi_lstm_bwd_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + R - 1) / R);
  multi_lstm_bwd_kernel<R><<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ftt

// All arrays float32 and contiguous, shaped as in MultiBwdArgs; t >= 1.
// cell_dims (host memory) lists the n_cells fused hidden widths, summing to
// H. rows is the batch rows per block (1, 2, 4, 8 or 16), threads a
// multiple of 32 up to 512.
extern "C" int multi_lstm_bwd(const float* gates, const float* allc,
                              const float* dhlast, const float* wh,
                              float* dxp, int t, int n, int H, int n_cells,
                              const int* cell_dims, int rows, int threads,
                              void* stream) {
  using namespace ftt;
  MultiBwdArgs a;
  a.gates = gates;
  a.allc = allc;
  a.dhlast = dhlast;
  a.wh = wh;
  a.dxp = dxp;
  a.t = t;
  a.n = n;
  a.H = H;
  if (!make_cells(n_cells, cell_dims, H, &a.cells) || t < 1 || n < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return (int)launch<1>(a, threads, st);
    case 2: return (int)launch<2>(a, threads, st);
    case 4: return (int)launch<4>(a, threads, st);
    case 8: return (int)launch<8>(a, threads, st);
    case 16: return (int)launch<16>(a, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
