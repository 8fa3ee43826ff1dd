// Fused encoder cells (multi_lstm), forward.
//
// Replaces: factorized_tpu/ops/pallas_lstm.py::_enc_fwd_kernel (reached
// through _enc_fwd_call and multi_lstm).
//
// What it computes: k independent LSTM cells fused over one state of H
// units, gate-major and block-diagonal, from a zero state: for each step s,
// gates = xp[s] + h @ wh through the LSTM gate math, with xp (t, n, 4H) the
// hoisted input projections (bias included, computed outside) and wh
// (H, 4H). The eval variant writes h_last (n, H) only; the train variant
// also writes allh and allc (t, n, H) and the pre-activation gates
// (t, n, 4H), the residuals the backward reads.
//
// What bounds it on an H100: operations, narrowly, in the eval variant. At
// the serving batch (n = 256, t = 20, best_acc_mosi_config) the kl_ef
// encoders (H = 240) do 0.90 GFLOP of float32 work over the diagonal blocks
// (13 us at 67 TFLOP/s) against 21 MB of traffic, nearly all of it xp
// (6 us at 3.35 TB/s); the missing surrogates (H = 216) 0.43 GFLOP against
// 18 MB. In practice the serial chain of t dependent steps bounds it.
//
// What the design does about it: as decoder_lstm_fwd.cu, one block owns
// ROWS batch rows and loops over the steps itself; h (double-buffered) and
// c stay in shared memory, feature-major, so each thread computes one
// hidden unit's four gates for all its rows from one load of each weight.
// Only the diagonal blocks of wh are read; they (342 KB for kl_ef) stay in
// L2. Nothing else yet.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;

struct MultiArgs {
  const float* xp;  // (t, n, 4H)
  const float* wh;  // (H, 4H)
  float* h_last;    // (n, H)
  float* allh;      // (t, n, H), train variant only
  float* allc;      // (t, n, H), train variant only
  float* gates;     // (t, n, 4H), train variant only
  int t, n, H;
  Cells cells;
};

template <int R, bool kRes>
__global__ void __launch_bounds__(kMaxThreads)
    multi_lstm_fwd_kernel(const MultiArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, H4 = 4 * H;
  // feature-major [unit][R]: h twice (this step's and the last), then c,
  // which only the thread owning a unit reads and writes
  float* const hbuf = smem;
  float* const c = smem + 2 * H * R;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // the state starts at zero
  for (int i = tid; i < 3 * H * R; i += nthr) smem[i] = 0.0f;
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < a.t; ++s) {
    const float* h_old = hbuf + cur * H * R;
    float* h_new = hbuf + (cur ^ 1) * H * R;
    const size_t base = (size_t)s * a.n;
    for (int j = tid; j < H; j += nthr) {
      int k0, k1;
      cell_range(a.cells, j, k0, k1);
      float gi[R], gf[R], gg[R], go[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        gi[r] = gf[r] = gg[r] = go[r] = 0.0f;
        if (row < a.n) {
          const float* x = a.xp + (base + row) * H4 + j;
          gi[r] = x[0];
          gf[r] = x[H];
          gg[r] = x[2 * H];
          go[r] = x[3 * H];
        }
      }
      for (int k = k0; k < k1; ++k) {
        const float* w = a.wh + (size_t)k * H4 + j;
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
        if (row >= a.n) continue;
        if (kRes) {
          float* g = a.gates + (base + row) * H4 + j;
          g[0] = gi[r];
          g[H] = gf[r];
          g[2 * H] = gg[r];
          g[3 * H] = go[r];
          a.allh[(base + row) * H + j] = hv;
          a.allc[(base + row) * H + j] = cv;
        }
        if (s == a.t - 1) a.h_last[(size_t)row * H + j] = hv;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <int R, bool kRes>
cudaError_t launch(const MultiArgs& a, int threads, cudaStream_t stream) {
  const size_t bytes = (size_t)R * 3 * a.H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      multi_lstm_fwd_kernel<R, kRes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + R - 1) / R);
  multi_lstm_fwd_kernel<R, kRes><<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool kRes>
cudaError_t launch_rows(const MultiArgs& a, int rows, int threads,
                        cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<1, kRes>(a, threads, stream);
    case 2: return launch<2, kRes>(a, threads, stream);
    case 4: return launch<4, kRes>(a, threads, stream);
    case 8: return launch<8, kRes>(a, threads, stream);
    case 16: return launch<16, kRes>(a, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ftt

// All arrays float32 and contiguous, shaped as in MultiArgs. with_res 0 is
// the eval variant (allh, allc and gates may be null), 1 the train variant.
// cell_dims (host memory) lists the n_cells fused hidden widths, summing to
// H. rows is the batch rows per block (1, 2, 4, 8 or 16), threads a
// multiple of 32 up to 512.
extern "C" int multi_lstm_fwd(const float* xp, const float* wh,
                              float* h_last, float* allh, float* allc,
                              float* gates, int t, int n, int H, int n_cells,
                              const int* cell_dims, int with_res, int rows,
                              int threads, void* stream) {
  using namespace ftt;
  MultiArgs a;
  a.xp = xp;
  a.wh = wh;
  a.h_last = h_last;
  a.allh = allh;
  a.allc = allc;
  a.gates = gates;
  a.t = t;
  a.n = n;
  a.H = H;
  if (!make_cells(n_cells, cell_dims, H, &a.cells) || t < 1 || n < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (with_res && (!allh || !allc || !gates)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_res ? (int)launch_rows<true>(a, rows, threads, st)
                  : (int)launch_rows<false>(a, rows, threads, st);
}
