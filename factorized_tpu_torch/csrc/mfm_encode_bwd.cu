// Fused MFM encode, backward: a reverse-time kernel and a deterministic
// reduction kernel for the weight gradients.
//
// Replaces: factorized_tpu/ops/pallas_mfn.py::_bwd_kernel (reached through
// _bwd_call and the custom_vjp backward _encode_bwd of mfm_encode_pallas).
//
// What it computes: from the forward's residuals (allh, allc, allmem and
// the (t, n, R) buffer in the _RES_NAMES layout) and the cotangents of
// h_last and mem_last, BPTT through the memory update, the gamma gates,
// the att2 proposal, the softmax attention, att1 and the six fused LSTM
// cells: dxp = dgates (t, n, 4H), and the 14 non-wh weight and bias
// gradients. The TPU kernel sums those 14 in VMEM across its sequential
// grid. Here:
//
// (a) mfm_encode_bwd_kernel: one block owns ROWS batch rows and loops from
//     step t - 1 down to 0, the carries dh, dc and dmem in shared memory.
//     It writes dxp and, per step, the deltas whose products with forward
//     activations are the weight gradients (dq1, dq2, du3, dch, du2,
//     dlogits, du1: a (t, n, D) buffer).
// (b) mfm_encode_dw_kernel: each block computes one 32 x 32 tile of one
//     gradient, A^T delta summed over the t * n rows in a fixed order, A
//     taken from the residuals (r1, r2, the two halves of r3) or rebuilt
//     from them (cStar from allc, attended = att * cStar, memp from
//     allmem). No atomics: a rerun gives the same bits.
//
// dWh = allh[:-1]^T dxp[1:] is one GEMM outside, as in the JAX package.
//
// What bounds it on an H100: operations. At the training batch (n = 32,
// t = 20, best_acc_mosi_config) kernel (a) does 0.60 GFLOP of useful
// float32 work (the gate recompute and the transposed products, only the
// diagonal blocks of wh) against about 17 MB of traffic: 9 us at
// 67 TFLOP/s against 5 us at 3.35 TB/s. Kernel (b) does 0.38 GFLOP
// against 9 MB: about 6 us. In practice (a) is bounded by its serial
// chain: t steps of nine dependent phases, each a small product with a
// block barrier, over only n / ROWS blocks.
//
// What the design does about it: (a) keeps every step intermediate in
// shared memory, feature-major ([feature][row]), so one weight load feeds
// ROWS FMAs; the gates are recomputed from hp @ wh + xp as the TPU kernel
// does (the residual buffer stays the forward's). The backward's products
// are against transposed weights (A @ W^T), so a warp computes one output
// column: its lanes read the weight row coalesced and shuffles add them.
// (b) runs 335 blocks in parallel, tiles staged through shared memory.
// Nothing else yet: no tensor cores, TMA or clusters.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_common.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;

struct BwdArgs {
  const float* xp;        // (t, n, 4H)
  const float* allh;      // (t, n, H)
  const float* allc;      // (t, n, H)
  const float* allmem;    // (t, n, mem)
  const float* res;       // (t, n, R)
  const float* dhlast;    // (n, H)
  const float* dmemlast;  // (n, mem)
  const float* wh;        // (H, 4H)
  const float* a1w1;      // (M2, s1)
  const float* a1w2;      // (s1, M2)
  const float* a2w1;      // (M2, s2)
  const float* a2w2;      // (s2, mem)
  const float* gw1;       // (M2 + mem, s3 + s4)
  const float* g1w2;      // (s3, mem)
  const float* g2w2;      // (s4, mem)
  float* dxp;             // (t, n, 4H)
  float* delta;           // (t, n, D)
  int t, n, H, z_tot, mem, s1, s2, s3, s4;
  Cells cells;
};

// Column offsets of the residual buffer (the _RES_NAMES layout) and of
// the delta buffer (dq1, dq2, du3, dch, du2, dlogits, du1).
struct Layouts {
  int att, r1, kg1, r2, kg2, r3, kg3, chat, g1, g2, res_width;
  int dq1, dq2, du3, dch, du2, dlogits, du1, delta_width;
};

__host__ __device__ inline Layouts layouts(int H, int z_tot, int mem, int s1,
                                           int s2, int s3, int s4) {
  const int m2 = 2 * (H - z_tot), s34 = s3 + s4;
  Layouts l;
  l.att = 0;
  l.r1 = m2;
  l.kg1 = l.r1 + s1;
  l.r2 = l.kg1 + s1;
  l.kg2 = l.r2 + s2;
  l.r3 = l.kg2 + s2;
  l.kg3 = l.r3 + s34;
  l.chat = l.kg3 + s34;
  l.g1 = l.chat + mem;
  l.g2 = l.g1 + mem;
  l.res_width = l.g2 + mem;
  l.dq1 = 0;
  l.dq2 = mem;
  l.du3 = 2 * mem;
  l.dch = l.du3 + s34;
  l.du2 = l.dch + mem;
  l.dlogits = l.du2 + s2;
  l.du1 = l.dlogits + m2;
  l.delta_width = l.du1 + s1;
  return l;
}

// acc[r] += sum_k A[k][r] * w_row[k] over a warp: a row of W against the
// feature-major A, i.e. one column of A @ W^T. Lane l takes k = l, l + 32,
// ..., so the warp reads the row coalesced; warp_sum then adds the lanes.
template <int R>
__device__ __forceinline__ void warp_dot_row(const float* a, int K,
                                             const float* __restrict__ w_row,
                                             int lane, float (&acc)[R]) {
  for (int k = lane; k < K; k += 32) {
    const float wv = __ldg(w_row + k);
    const float* ak = a + k * R;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(ak[r], wv, acc[r]);
  }
}

// The sum over the warp's lanes, left in every lane. Each butterfly level
// adds the same two values on both partner lanes, so every lane holds the
// same bits, and a rerun gives them again.
template <int R>
__device__ __forceinline__ void warp_sum(float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    for (int o = 16; o > 0; o >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
}

// Row-major (n, width) rows [row0, row0 + R) of step s into feature-major
// shared memory, columns [col0, col0 + count); zeros past n or when src
// is null.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int s, int n, int width, int col0,
                                          int count, int row0, int tid,
                                          int nthr) {
  for (int i = tid; i < R * count; i += nthr) {
    const int r = i / count, k = i - r * count, row = row0 + r;
    float v = 0.0f;
    if (src != nullptr && row < n)
      v = src[((size_t)s * n + row) * width + col0 + k];
    dst[k * R + r] = v;
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    mfm_encode_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, H4 = 4 * H, z = a.z_tot;
  const int M = H - z, M2 = 2 * M, mem = a.mem;
  const int s3 = a.s3, s34 = a.s3 + a.s4;
  const Layouts lay = layouts(H, z, mem, a.s1, a.s2, a.s3, a.s4);
  // feature-major [feature][R] buffers
  float* dh = smem;                 // H: the carry into step i
  float* dc = dh + H * R;           // H
  float* hp = dc + H * R;           // H: h of step i - 1
  float* dmem = hp + H * R;         // mem: the carry
  float* dmem_new = dmem + mem * R; // mem: the carry out of step i
  float* cstar = dmem_new + mem * R;  // M2
  float* att = cstar + M2 * R;      // M2
  float* dq = att + M2 * R;         // 3 mem: dq1 | dq2 | dch
  float* du3 = dq + 3 * mem * R;    // s34
  float* du2 = du3 + s34 * R;       // s2
  float* datt = du2 + a.s2 * R;     // M2
  float* dcstar = datt + M2 * R;    // M2
  float* dlogits = dcstar + M2 * R; // M2
  float* du1 = dlogits + M2 * R;    // s1
  float* dg = du1 + a.s1 * R;       // 4H: this step's dgates
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

  // the carries: dh = dh_last, dc = 0, dmem = dmem_last
  load_rows<R>(dh, a.dhlast, 0, a.n, H, 0, H, row0, tid, nthr);
  load_rows<R>(dmem, a.dmemlast, 0, a.n, mem, 0, mem, row0, tid, nthr);
  for (int i = tid; i < H * R; i += nthr) dc[i] = 0.0f;
  __syncthreads();

  for (int s = a.t - 1; s >= 0; --s) {
    const bool first = s == 0;
    const size_t base = (size_t)s * a.n;
    // (0) what the step reads: hp, cStar = [c_prev, c_i][:, z:], att
    load_rows<R>(hp, first ? nullptr : a.allh, s - 1, a.n, H, 0, H, row0,
                 tid, nthr);
    load_rows<R>(cstar, first ? nullptr : a.allc, s - 1, a.n, H, z, M, row0,
                 tid, nthr);
    load_rows<R>(cstar + M * R, a.allc, s, a.n, H, z, M, row0, tid, nthr);
    load_rows<R>(att, a.res, s, a.n, lay.res_width, lay.att, M2, row0, tid,
                 nthr);

    // (1) the memory update: dq1, dq2, dch and dmem * g1
    for (int i = tid; i < R * mem; i += nthr) {
      const int r = i / mem, k = i - r * mem, row = row0 + r;
      float q1 = 0.0f, q2 = 0.0f, ch = 0.0f, carry = 0.0f;
      if (row < a.n) {
        const float* res = a.res + (base + row) * lay.res_width;
        const float chat = res[lay.chat + k], g1 = res[lay.g1 + k];
        const float g2 = res[lay.g2 + k];
        const float memp =
            first ? 0.0f : a.allmem[((size_t)(s - 1) * a.n + row) * mem + k];
        const float dm = dmem[k * R + r];
        q1 = dm * memp * g1 * (1.0f - g1);
        q2 = dm * chat * g2 * (1.0f - g2);
        ch = dm * g2 * (1.0f - chat * chat);
        carry = dm * g1;
        float* d = a.delta + (base + row) * lay.delta_width;
        d[lay.dq1 + k] = q1;
        d[lay.dq2 + k] = q2;
        d[lay.dch + k] = ch;
      }
      dq[k * R + r] = q1;
      dq[(mem + k) * R + r] = q2;
      dq[(2 * mem + k) * R + r] = ch;
      dmem_new[k * R + r] = carry;
    }
    __syncthreads();

    // (2) du3 = [dq1 @ g1w2^T, dq2 @ g2w2^T] * kg3; du2 = dch @ a2w2^T * kg2;
    //     a warp per output column, lane r writing row r
    for (int j = warp; j < s34 + a.s2; j += nwarp) {
      float acc[R];
      zero(acc);
      int col, kg, dcol;
      float* out;
      if (j < s34) {
        col = j;
        kg = lay.kg3;
        dcol = lay.du3;
        out = du3;
        if (j < s3)
          warp_dot_row<R>(dq, mem, a.g1w2 + (size_t)j * mem, lane, acc);
        else
          warp_dot_row<R>(dq + mem * R, mem, a.g2w2 + (size_t)(j - s3) * mem,
                          lane, acc);
      } else {
        col = j - s34;
        kg = lay.kg2;
        dcol = lay.du2;
        out = du2;
        warp_dot_row<R>(dq + 2 * mem * R, mem, a.a2w2 + (size_t)col * mem,
                        lane, acc);
      }
      warp_sum(acc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        if (lane != r) continue;
        float v = 0.0f;
        if (row < a.n) {
          v = acc[r] * a.res[(base + row) * lay.res_width + kg + col];
          a.delta[(base + row) * lay.delta_width + dcol + col] = v;
        }
        out[col * R + r] = v;
      }
    }
    __syncthreads();

    // (3) dboth = du3 @ gw1^T: its first M2 columns plus du2 @ a2w1^T are
    //     dattended, the rest adds to the memory carry
    for (int j = warp; j < M2 + mem; j += nwarp) {
      float acc[R];
      zero(acc);
      warp_dot_row<R>(du3, s34, a.gw1 + (size_t)j * s34, lane, acc);
      if (j < M2) warp_dot_row<R>(du2, a.s2, a.a2w1 + (size_t)j * a.s2, lane,
                                  acc);
      warp_sum(acc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane != r) continue;
        if (j < M2) {
          datt[j * R + r] = acc[r] * cstar[j * R + r];
          dcstar[j * R + r] = acc[r] * att[j * R + r];
        } else {
          dmem_new[(j - M2) * R + r] += acc[r];
        }
      }
    }
    __syncthreads();

    // (4) the softmax: dlogits = att * (datt - sum(datt * att)), a warp
    //     per row
    for (int r = warp; r < R; r += nwarp) {
      float sum = 0.0f;
      for (int k = lane; k < M2; k += 32)
        sum += datt[k * R + r] * att[k * R + r];
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const int row = row0 + r;
      for (int k = lane; k < M2; k += 32) {
        float v = 0.0f;
        if (row < a.n) {
          v = att[k * R + r] * (datt[k * R + r] - sum);
          a.delta[(base + row) * lay.delta_width + lay.dlogits + k] = v;
        }
        dlogits[k * R + r] = v;
      }
    }
    __syncthreads();

    // (5) du1 = dlogits @ a1w2^T * kg1
    for (int j = warp; j < a.s1; j += nwarp) {
      float acc[R];
      zero(acc);
      warp_dot_row<R>(dlogits, M2, a.a1w2 + (size_t)j * M2, lane, acc);
      warp_sum(acc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        if (lane != r) continue;
        float v = 0.0f;
        if (row < a.n) {
          v = acc[r] * a.res[(base + row) * lay.res_width + lay.kg1 + j];
          a.delta[(base + row) * lay.delta_width + lay.du1 + j] = v;
        }
        du1[j * R + r] = v;
      }
    }
    __syncthreads();

    // (6) dcstar += du1 @ a1w1^T
    for (int j = warp; j < M2; j += nwarp) {
      float acc[R];
      zero(acc);
      warp_dot_row<R>(du1, a.s1, a.a1w1 + (size_t)j * a.s1, lane, acc);
      warp_sum(acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane == r) dcstar[j * R + r] += acc[r];
    }
    __syncthreads();

    // (7) the LSTM cells, each thread one hidden unit: the gates
    //     recomputed from hp @ wh + xp, cStar's gradient into this step's
    //     cell state ([:, z:] of c_i) and the previous one (of c_prev)
    for (int j = tid; j < H; j += nthr) {
      int k0, k1;
      cell_range(a.cells, j, k0, k1);
      float gi[R], gf[R], gg[R], go[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        if (row < a.n) {
          const float* x = a.xp + (base + row) * H4 + j;
          gi[r] = x[0];
          gf[r] = x[H];
          gg[r] = x[2 * H];
          go[r] = x[3 * H];
        } else {
          gi[r] = gf[r] = gg[r] = go[r] = 0.0f;
        }
      }
      for (int k = k0; k < k1; ++k) {
        const float* w = a.wh + (size_t)k * H4 + j;
        const float wi = __ldg(w), wf = __ldg(w + H);
        const float wg = __ldg(w + 2 * H), wo = __ldg(w + 3 * H);
        const float* hk = hp + k * R;
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
        const int row = row0 + r;
        const float si = sigmoid(gi[r]), sf = sigmoid(gf[r]);
        const float so = sigmoid(go[r]), tg = tanhf(gg[r]);
        float ci = 0.0f, cp = 0.0f;
        if (row < a.n) {
          ci = a.allc[(base + row) * H + j];
          if (!first) cp = a.allc[((size_t)(s - 1) * a.n + row) * H + j];
        }
        const float tc = tanhf(ci);
        const float dcs_i = j >= z ? dcstar[(M + j - z) * R + r] : 0.0f;
        const float dcs_p = j >= z ? dcstar[(j - z) * R + r] : 0.0f;
        const float dhv = dh[j * R + r];
        const float dc_i = dc[j * R + r] + dcs_i;
        const float dc_full = dc_i + dhv * so * (1.0f - tc * tc);
        const float di = dc_full * tg * si * (1.0f - si);
        const float df = dc_full * cp * sf * (1.0f - sf);
        const float dgg = dc_full * si * (1.0f - tg * tg);
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
        dc[j * R + r] = dc_full * sf + dcs_p;
      }
    }
    __syncthreads();

    // (8) dh = dgates @ wh^T over the unit's own cell block, a warp per
    //     unit; the memory carry moves on
    for (int k = warp; k < H; k += nwarp) {
      int j0, j1;
      cell_range(a.cells, k, j0, j1);
      float acc[R];
      zero(acc);
      const float* w = a.wh + (size_t)k * H4;
      for (int q = 0; q < 4; ++q) {
        for (int j = j0 + lane; j < j1; j += 32) {
          const float wv = __ldg(w + q * H + j);
          const float* g = dg + (q * H + j) * R;
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(g[r], wv, acc[r]);
        }
      }
      warp_sum(acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane == r) dh[k * R + r] = acc[r];
    }
    for (int i = tid; i < mem * R; i += nthr) dmem[i] = dmem_new[i];
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_bwd(const BwdArgs& a, int threads, cudaStream_t stream) {
  const int M2 = 2 * (a.H - a.z_tot);
  const size_t floats = (size_t)R * (7 * a.H + 5 * a.mem + 5 * M2 + a.s1 +
                                     a.s2 + a.s3 + a.s4);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mfm_encode_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + R - 1) / R);
  mfm_encode_bwd_kernel<R><<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------- kernel (b)

constexpr int kTile = 32;        // output tile: kTile x kTile
constexpr int kDwThreads = 256;  // each thread kTile * kTile / 256 outputs
constexpr int kProducts = 14;

// The A operand of a product: a residual column range, ones (a bias),
// cStar, attended = att * cStar, or [attended, memp].
enum Operand { kRes, kOnes, kCstar, kAttended, kBoth };

struct Product {
  int operand;
  int a_col;  // residual column of kRes
  int P;      // rows of the gradient (columns of A)
  int d_col;  // delta column
  int Q;      // columns of the gradient
  int tiles_q;
  float* out;  // (P, Q) row-major
};

struct DwArgs {
  const float* allc;    // (t, n, H)
  const float* allmem;  // (t, n, mem)
  const float* res;     // (t, n, R)
  const float* delta;   // (t, n, D)
  Product prod[kProducts];
  int first_tile[kProducts + 1];
  int t, n, H, z_tot, mem, res_width, delta_width;
};

__device__ __forceinline__ float cstar_at(const DwArgs& a, int i, int b,
                                          int p) {
  const int M = a.H - a.z_tot;
  if (p < M) {
    return i == 0 ? 0.0f
                  : a.allc[((size_t)(i - 1) * a.n + b) * a.H + a.z_tot + p];
  }
  return a.allc[((size_t)i * a.n + b) * a.H + a.z_tot + p - M];
}

// A[rr][p] of the product, rr = i * n + b a (step, batch row) pair.
__device__ __forceinline__ float operand_at(const DwArgs& a,
                                            const Product& pr, int rr,
                                            int p) {
  const int i = rr / a.n, b = rr - i * a.n;
  const float* res = a.res + (size_t)rr * a.res_width;
  const int M2 = 2 * (a.H - a.z_tot);
  switch (pr.operand) {
    case kRes:
      return res[pr.a_col + p];
    case kOnes:
      return 1.0f;
    case kCstar:
      return cstar_at(a, i, b, p);
    case kAttended:
      return res[p] * cstar_at(a, i, b, p);  // att is at column 0
    default:  // kBoth
      if (p < M2) return res[p] * cstar_at(a, i, b, p);
      return i == 0 ? 0.0f
                    : a.allmem[((size_t)(i - 1) * a.n + b) * a.mem + p - M2];
  }
}

__global__ void __launch_bounds__(kDwThreads)
    mfm_encode_dw_kernel(const DwArgs a) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Ds[kTile][kTile + 1];
  const int block = blockIdx.x;
  int which = 0;
  while (which + 1 < kProducts && block >= a.first_tile[which + 1]) ++which;
  const Product pr = a.prod[which];
  const int local = block - a.first_tile[which];
  const int p0 = (local / pr.tiles_q) * kTile;
  const int q0 = (local % pr.tiles_q) * kTile;
  const int tid = threadIdx.x, tx = tid % kTile, ty = tid / kTile;
  constexpr int kPer = kTile * kTile / kDwThreads;
  constexpr int kStride = kDwThreads / kTile;
  const int rows = a.t * a.n;

  float acc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc[u] = 0.0f;

  for (int rr0 = 0; rr0 < rows; rr0 += kTile) {
    for (int e = tid; e < kTile * kTile; e += kDwThreads) {
      const int rr = e / kTile, c = e - rr * kTile, row = rr0 + rr;
      float av = 0.0f, dv = 0.0f;
      if (row < rows) {
        if (p0 + c < pr.P) av = operand_at(a, pr, row, p0 + c);
        if (q0 + c < pr.Q)
          dv = a.delta[(size_t)row * a.delta_width + pr.d_col + q0 + c];
      }
      As[rr][c] = av;
      Ds[rr][c] = dv;
    }
    __syncthreads();
    for (int rr = 0; rr < kTile; ++rr) {
      const float d = Ds[rr][tx];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        acc[u] = fmaf(As[rr][ty + kStride * u], d, acc[u]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int p = p0 + ty + kStride * u, q = q0 + tx;
    if (p < pr.P && q < pr.Q) pr.out[(size_t)p * pr.Q + q] = acc[u];
  }
}

}  // namespace
}  // namespace ftt

// Kernel (a). All arrays float32 and contiguous, shaped as in BwdArgs;
// cell_dims (host memory) lists the n_cells fused hidden widths, summing
// to H. rows is the batch rows per block (1, 2, 4 or 8), threads a
// multiple of 32 up to 512.
extern "C" int mfm_encode_bwd(
    const float* xp, const float* allh, const float* allc,
    const float* allmem, const float* res, const float* dhlast,
    const float* dmemlast, const float* wh, const float* a1w1,
    const float* a1w2, const float* a2w1, const float* a2w2,
    const float* gw1, const float* g1w2, const float* g2w2, float* dxp,
    float* delta, int t, int n, int H, int z_tot, int mem, int s1, int s2,
    int s3, int s4, int n_cells, const int* cell_dims, int rows, int threads,
    void* stream) {
  using namespace ftt;
  BwdArgs a;
  a.xp = xp;
  a.allh = allh;
  a.allc = allc;
  a.allmem = allmem;
  a.res = res;
  a.dhlast = dhlast;
  a.dmemlast = dmemlast;
  a.wh = wh;
  a.a1w1 = a1w1;
  a.a1w2 = a1w2;
  a.a2w1 = a2w1;
  a.a2w2 = a2w2;
  a.gw1 = gw1;
  a.g1w2 = g1w2;
  a.g2w2 = g2w2;
  a.dxp = dxp;
  a.delta = delta;
  a.t = t;
  a.n = n;
  a.H = H;
  a.z_tot = z_tot;
  a.mem = mem;
  a.s1 = s1;
  a.s2 = s2;
  a.s3 = s3;
  a.s4 = s4;
  if (!make_cells(n_cells, cell_dims, H, &a.cells) || t < 1 || n < 1 ||
      z_tot < 0 || z_tot >= H || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return (int)launch_bwd<1>(a, threads, st);
    case 2: return (int)launch_bwd<2>(a, threads, st);
    case 4: return (int)launch_bwd<4>(a, threads, st);
    case 8: return (int)launch_bwd<8>(a, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel (b). The gradients, each (P, Q) row-major, in the order of the
// JAX package's _W_NAMES without wh: a1w1, a1b1, a1w2, a1b2, a2w1, a2b1,
// a2w2, a2b2, gw1, gb1, g1w2, g1b2, g2w2, g2b2.
extern "C" int mfm_encode_dw(
    const float* allc, const float* allmem, const float* res,
    const float* delta, float* d_a1w1, float* d_a1b1, float* d_a1w2,
    float* d_a1b2, float* d_a2w1, float* d_a2b1, float* d_a2w2,
    float* d_a2b2, float* d_gw1, float* d_gb1, float* d_g1w2, float* d_g1b2,
    float* d_g2w2, float* d_g2b2, int t, int n, int H, int z_tot, int mem,
    int s1, int s2, int s3, int s4, void* stream) {
  using namespace ftt;
  if (t < 1 || n < 1 || z_tot < 0 || z_tot >= H)
    return (int)cudaErrorInvalidValue;
  const Layouts l = layouts(H, z_tot, mem, s1, s2, s3, s4);
  const int m2 = 2 * (H - z_tot), s34 = s3 + s4;
  DwArgs a;
  a.allc = allc;
  a.allmem = allmem;
  a.res = res;
  a.delta = delta;
  a.t = t;
  a.n = n;
  a.H = H;
  a.z_tot = z_tot;
  a.mem = mem;
  a.res_width = l.res_width;
  a.delta_width = l.delta_width;
  const Product table[kProducts] = {
      {kCstar, 0, m2, l.du1, s1, 0, d_a1w1},
      {kOnes, 0, 1, l.du1, s1, 0, d_a1b1},
      {kRes, l.r1, s1, l.dlogits, m2, 0, d_a1w2},
      {kOnes, 0, 1, l.dlogits, m2, 0, d_a1b2},
      {kAttended, 0, m2, l.du2, s2, 0, d_a2w1},
      {kOnes, 0, 1, l.du2, s2, 0, d_a2b1},
      {kRes, l.r2, s2, l.dch, mem, 0, d_a2w2},
      {kOnes, 0, 1, l.dch, mem, 0, d_a2b2},
      {kBoth, 0, m2 + mem, l.du3, s34, 0, d_gw1},
      {kOnes, 0, 1, l.du3, s34, 0, d_gb1},
      {kRes, l.r3, s3, l.dq1, mem, 0, d_g1w2},
      {kOnes, 0, 1, l.dq1, mem, 0, d_g1b2},
      {kRes, l.r3 + s3, s4, l.dq2, mem, 0, d_g2w2},
      {kOnes, 0, 1, l.dq2, mem, 0, d_g2b2},
  };
  int tiles = 0;
  for (int k = 0; k < kProducts; ++k) {
    a.prod[k] = table[k];
    a.prod[k].tiles_q = (table[k].Q + kTile - 1) / kTile;
    a.first_tile[k] = tiles;
    tiles += ((table[k].P + kTile - 1) / kTile) * a.prod[k].tiles_q;
  }
  a.first_tile[kProducts] = tiles;
  mfm_encode_dw_kernel<<<tiles, kDwThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
