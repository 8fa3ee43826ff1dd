// Fused autoregressive decoders, forward.
//
// Replaces: factorized_tpu/ops/pallas_lstm.py::_dec_fwd_kernel (reached
// through _dec_fwd_call and decoder_lstm).
//
// What it computes: from the state (h0, c0) that the latent-driven step 0
// left (computed outside, as in the JAX package), t - 1 steps of
// gates = h @ wsum + b through the LSTM gate math, with wsum = wx + wh
// block-diagonal and gate-major over the fused decoder cells. It writes
// allh and allc (t, n, H) with slot 0 = (h0, c0), and the pre-activation
// gates (t, n, 4H) with slot 0 zero, the residuals a backward pass reads.
//
// What bounds it on an H100: operations, narrowly. At the serving batch
// (n = 256, t = 20, best_acc_mosi_config, H = 152) the useful work is
// 0.47 GFLOP in float32 (about 7 us at 67 TFLOP/s) against about 19 MB
// of traffic (about 6 us at 3.35 TB/s), most of it the gates. In practice
// the serial chain of t - 1 dependent steps bounds it.
//
// What the design does about it: one block owns ROWS batch rows and loops
// over the steps itself; h and c stay in shared memory, feature-major, so
// each thread computes one hidden unit's four gates for all its rows from
// one load of each weight. Only the diagonal blocks of wsum are read;
// wsum (370 KB) stays in L2. Nothing else yet.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;

struct DecoderArgs {
  const float* h0;    // (n, H)
  const float* c0;    // (n, H)
  const float* wsum;  // (H, 4H)
  const float* b;     // (4H)
  float* allh;        // (t, n, H)
  float* allc;        // (t, n, H)
  float* gates;       // (t, n, 4H)
  int t, n, H;
  Cells cells;
};

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    decoder_lstm_fwd_kernel(const DecoderArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, H4 = 4 * H;
  // feature-major [unit][R]: h twice (this step's and the last), then c,
  // which only the thread owning a unit reads and writes
  float* const hbuf = smem;
  float* const c = smem + 2 * H * R;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // slot 0: the state after the latent-driven step, gates zero
  for (int i = tid; i < R * H; i += nthr) {
    const int r = i / H, j = i - r * H, row = row0 + r;
    float hv = 0.0f, cv = 0.0f;
    if (row < a.n) {
      hv = a.h0[(size_t)row * H + j];
      cv = a.c0[(size_t)row * H + j];
      a.allh[(size_t)row * H + j] = hv;
      a.allc[(size_t)row * H + j] = cv;
    }
    hbuf[j * R + r] = hv;
    c[j * R + r] = cv;
  }
  for (int i = tid; i < R * H4; i += nthr) {
    const int r = i / H4, q = i - r * H4, row = row0 + r;
    if (row < a.n) a.gates[(size_t)row * H4 + q] = 0.0f;
  }
  __syncthreads();

  int cur = 0;
  for (int s = 1; s < a.t; ++s) {
    const float* h_old = hbuf + cur * H * R;
    float* h_new = hbuf + (cur ^ 1) * H * R;
    const size_t base = (size_t)s * a.n;
    for (int j = tid; j < H; j += nthr) {
      int k0, k1;
      cell_range(a.cells, j, k0, k1);
      const float bi = __ldg(a.b + j), bf = __ldg(a.b + H + j);
      const float bg = __ldg(a.b + 2 * H + j), bo = __ldg(a.b + 3 * H + j);
      float gi[R], gf[R], gg[R], go[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gi[r] = bi;
        gf[r] = bf;
        gg[r] = bg;
        go[r] = bo;
      }
      for (int k = k0; k < k1; ++k) {
        const float* w = a.wsum + (size_t)k * H4 + j;
        const float wi = __ldg(w), wf = __ldg(w + H);
        const float wg = __ldg(w + 2 * H), wo = __ldg(w + 3 * H);
        const float* hk = h_old + k * R;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hk[r];
          gi[r] = fmaf(hv, wi, gi[r]);
          gf[r] = fmaf(hv, wf, gf[r]);
          gg[r] = fmaf(hv, wg, gg[r]);
          go[r] = fmaf(hv, wo, go[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float cv = sigmoid(gf[r]) * c[j * R + r] +
                         sigmoid(gi[r]) * tanhf(gg[r]);
        const float hv = sigmoid(go[r]) * tanhf(cv);
        c[j * R + r] = cv;
        h_new[j * R + r] = hv;
        const int row = row0 + r;
        if (row < a.n) {
          float* g = a.gates + (base + row) * H4 + j;
          g[0] = gi[r];
          g[H] = gf[r];
          g[2 * H] = gg[r];
          g[3 * H] = go[r];
          a.allh[(base + row) * H + j] = hv;
          a.allc[(base + row) * H + j] = cv;
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <int R>
cudaError_t launch(const DecoderArgs& a, int threads, cudaStream_t stream) {
  const size_t bytes = (size_t)R * 3 * a.H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_lstm_fwd_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + R - 1) / R);
  decoder_lstm_fwd_kernel<R><<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ftt

// All arrays float32 and contiguous; b is (1, 4H) or (4H,). cell_dims
// (host memory) lists the n_cells fused hidden widths, summing to H. rows
// is the batch rows per block (1, 2, 4, 8 or 16), threads a multiple of
// 32 up to 512.
extern "C" int decoder_lstm_fwd(const float* h0, const float* c0,
                                const float* wsum, const float* b,
                                float* allh, float* allc, float* gates, int t,
                                int n, int H, int n_cells,
                                const int* cell_dims, int rows, int threads,
                                void* stream) {
  using namespace ftt;
  DecoderArgs a;
  a.h0 = h0;
  a.c0 = c0;
  a.wsum = wsum;
  a.b = b;
  a.allh = allh;
  a.allc = allc;
  a.gates = gates;
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
