// Fused MFM encode, backward: a reverse-time kernel and a deterministic
// reduction kernel for the weight gradients.
//
// Replaces: factorized_tpu/ops/pallas_mfn.py::_bwd_kernel (reached through
// _bwd_call and the custom_vjp backward _encode_bwd of mfm_encode_pallas).
// Its variants replace the probe kernels of scripts/: the stream variant
// reading ten separate residual tensors is bwd_residual_probe.py's
// _bwd_res_kernel with store_att (variant C); the recompute-att variant is
// the same kernel without it (variant B); the two-step variant is
// twostep_bwd_probe.py's _bwd2_kernel. The stream variant on one residual
// buffer is the same function and design as bwd_residual_probe.py's
// _bwd_stream_kernel (the production kernel's shape).
//
// What it computes: from the forward's residuals (allh, allc, allmem and
// the ten _RES_NAMES fields, read through the residual-layout table of
// mfm_res.cuh) and the cotangents of h_last and mem_last, BPTT through the
// memory update, the gamma gates, the att2 proposal, the softmax attention,
// att1 and the six fused LSTM cells: dxp = dgates (t, n, 4H), and the 14
// non-wh weight and bias gradients. The TPU kernel sums those 14 in VMEM
// across its sequential grid. Here:
//
// (a) mfm_encode_bwd_kernel: one block owns ROWS batch rows and loops from
//     step t - 1 down to 0, the carries dh, dc and dmem in shared memory.
//     It writes dxp and, per step, the deltas whose products with forward
//     activations are the weight gradients (dq1, dq2, du3, dch, du2,
//     dlogits, du1: a (t, n, D) buffer). Variants (a template argument):
//     - stream: one step per iteration, att loaded from the residuals;
//     - recompute-att: att = softmax(r1 @ a1w2 + a1b2) recomputed on the
//       chain from the stored r1, in the forward's order of operations;
//     - two-step: steps s and s - 1 as a pair (t even), both steps'
//       loaded operands fetched at the pair's head into two buffer sets
//       (the TPU kernel's two steps per grid iteration; on a block that
//       loops over time, the pair's head is the only difference left).
//       dxp is one (t, n, 4H) tensor: the TPU kernel's two interleaved
//       dxp buffers exist only so its grid can stream them.
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
// block barrier, over only n / ROWS blocks. The recompute-att variant adds
// two phases and 2 t n s1 M2 FLOPs to that chain; its softmax takes a warp
// per row, so at ROWS = 1 one warp of the block works and the rest wait.
//
// What the design does about it: (a) keeps every step intermediate in
// shared memory, feature-major ([feature][row]), so one weight load feeds
// ROWS FMAs; the gates are recomputed from hp @ wh + xp as the TPU kernel
// does (the residuals stay the forward's). The backward's products are
// against transposed weights (A @ W^T), so a warp computes one output
// column: its lanes read the weight row coalesced and shuffles add them.
// (b) runs 335 blocks in parallel, tiles staged through shared memory.
// Nothing else yet: no tensor cores, TMA or clusters.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_common.cuh"
#include "mfm_res.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;

// The variants of kernel (a).
enum Variant { kStream = 0, kRecomputeAtt = 1, kTwoStep = 2 };

struct BwdArgs {
  const float* xp;        // (t, n, 4H)
  const float* allh;      // (t, n, H)
  const float* allc;      // (t, n, H)
  const float* allmem;    // (t, n, mem)
  ResTable res;           // the ten residual fields
  const float* dhlast;    // (n, H)
  const float* dmemlast;  // (n, mem)
  const float* wh;        // (H, 4H)
  const float* a1w1;      // (M2, s1)
  const float* a1w2;      // (s1, M2)
  const float* a1b2;      // (M2): read by the recompute-att variant only
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

// Column offsets of the delta buffer (dq1, dq2, du3, dch, du2, dlogits,
// du1) and its width D.
struct DeltaLayout {
  int dq1, dq2, du3, dch, du2, dlogits, du1, width;
};

__host__ __device__ inline DeltaLayout delta_layout(int H, int z_tot,
                                                    int mem, int s1, int s2,
                                                    int s3, int s4) {
  const int m2 = 2 * (H - z_tot), s34 = s3 + s4;
  DeltaLayout l;
  l.dq1 = 0;
  l.dq2 = mem;
  l.du3 = 2 * mem;
  l.dch = l.du3 + s34;
  l.du2 = l.dch + mem;
  l.dlogits = l.du2 + s2;
  l.du1 = l.dlogits + m2;
  l.width = l.du1 + s1;
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

// Row-major rows [row0, row0 + R) of step s (row stride `width`) into
// feature-major shared memory, columns [col0, col0 + count); zeros past n
// or when src is null.
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

// The shared-memory buffers that every step reuses, feature-major
// [feature][R].
struct Smem {
  float* dh;        // H: the carry into the step
  float* dc;        // H
  float* dmem;      // mem: the carry
  float* dmem_new;  // mem: the carry out of the step
  float* dq;        // 3 mem: dq1 | dq2 | dch
  float* du3;       // s34
  float* du2;       // s2
  float* datt;      // M2
  float* dcstar;    // M2
  float* dlogits;   // M2
  float* du1;       // s1
  float* dg;        // 4H: the step's dgates
};

// What a step reads from shared memory, loaded at its head (phase (0)).
struct Operands {
  float* hp;     // H: h of step s - 1
  float* cstar;  // M2: [c_prev, c_s][:, z:]
  float* att;    // M2
};

// (0) the operands of step s: hp, cStar and, but where `r1` is given (the
//     recompute-att variant, which loads r1 there instead), att; zeros for
//     the state before step 0. No barrier: the caller's orders them.
template <int R>
__device__ __forceinline__ void load_operands(const BwdArgs& a, int s,
                                              const Operands& op, float* r1,
                                              int row0, int tid, int nthr) {
  const int H = a.H, z = a.z_tot, M = H - z;
  const bool first = s == 0;
  load_rows<R>(op.hp, first ? nullptr : a.allh, s - 1, a.n, H, 0, H, row0,
               tid, nthr);
  load_rows<R>(op.cstar, first ? nullptr : a.allc, s - 1, a.n, H, z, M, row0,
               tid, nthr);
  load_rows<R>(op.cstar + M * R, a.allc, s, a.n, H, z, M, row0, tid, nthr);
  const ResEntry& e = a.res.f[r1 != nullptr ? kR1 : kAtt];
  load_rows<R>(r1 != nullptr ? r1 : op.att, e.ptr, s, a.n, e.stride, e.col,
               r1 != nullptr ? a.s1 : 2 * M, row0, tid, nthr);
}

// (0b) the recompute-att variant: att = softmax(r1 @ a1w2 + a1b2) from
//      the r1 just loaded, with the forward's order of operations (a
//      thread per logit column over the block's rows, then a warp per row),
//      so att has the bits the forward stored. Phase (1) reads no att; its
//      barrier orders the softmax's writes before phase (3).
template <int R>
__device__ __forceinline__ void recompute_att(const BwdArgs& a,
                                              const Operands& op,
                                              const float* r1, int tid,
                                              int nthr, int lane, int warp,
                                              int nwarp) {
  const int M2 = 2 * (a.H - a.z_tot);
  float* att = op.att;
  __syncthreads();
  for (int j = tid; j < M2; j += nthr) {
    float acc[R];
    const float b = __ldg(a.a1b2 + j);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = b;
    const float* wj = a.a1w2 + j;
    for (int k = 0; k < a.s1; ++k) {
      const float wv = __ldg(wj + (size_t)k * M2);
      const float* rk = r1 + k * R;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(rk[r], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) att[j * R + r] = acc[r];
  }
  __syncthreads();
  for (int r = warp; r < R; r += nwarp) {
    float mx = -INFINITY;
    for (int k = lane; k < M2; k += 32) mx = fmaxf(mx, att[k * R + r]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int k = lane; k < M2; k += 32) {
      const float e = expf(att[k * R + r] - mx);
      att[k * R + r] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int k = lane; k < M2; k += 32) att[k * R + r] = att[k * R + r] / sum;
  }
}

// Phases (1)-(8) of reverse step s on its loaded operands: the deltas and
// dxp written, the carries in `sm` moved to step s - 1.
template <int R>
__device__ __forceinline__ void reverse_step(const BwdArgs& a, int s,
                                             const Operands& op,
                                             const Smem& sm, int row0,
                                             int tid, int nthr, int lane,
                                             int warp, int nwarp) {
  const int H = a.H, H4 = 4 * H, z = a.z_tot;
  const int M = H - z, M2 = 2 * M, mem = a.mem;
  const int s3 = a.s3, s34 = a.s3 + a.s4;
  const DeltaLayout dl = delta_layout(H, z, mem, a.s1, a.s2, a.s3, a.s4);
  const bool first = s == 0;
  const size_t base = (size_t)s * a.n;
  float* const dq = sm.dq;

  // (1) the memory update: dq1, dq2, dch and dmem * g1
  for (int i = tid; i < R * mem; i += nthr) {
    const int r = i / mem, k = i - r * mem, row = row0 + r;
    float q1 = 0.0f, q2 = 0.0f, ch = 0.0f, carry = 0.0f;
    if (row < a.n) {
      const size_t at = base + row;
      const float chat = res_row(a.res.f[kChat], at)[k];
      const float g1 = res_row(a.res.f[kG1], at)[k];
      const float g2 = res_row(a.res.f[kG2], at)[k];
      const float memp =
          first ? 0.0f : a.allmem[((size_t)(s - 1) * a.n + row) * mem + k];
      const float dm = sm.dmem[k * R + r];
      q1 = dm * memp * g1 * (1.0f - g1);
      q2 = dm * chat * g2 * (1.0f - g2);
      ch = dm * g2 * (1.0f - chat * chat);
      carry = dm * g1;
      float* d = a.delta + at * dl.width;
      d[dl.dq1 + k] = q1;
      d[dl.dq2 + k] = q2;
      d[dl.dch + k] = ch;
    }
    dq[k * R + r] = q1;
    dq[(mem + k) * R + r] = q2;
    dq[(2 * mem + k) * R + r] = ch;
    sm.dmem_new[k * R + r] = carry;
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
      kg = kKg3;
      dcol = dl.du3;
      out = sm.du3;
      if (j < s3)
        warp_dot_row<R>(dq, mem, a.g1w2 + (size_t)j * mem, lane, acc);
      else
        warp_dot_row<R>(dq + mem * R, mem, a.g2w2 + (size_t)(j - s3) * mem,
                        lane, acc);
    } else {
      col = j - s34;
      kg = kKg2;
      dcol = dl.du2;
      out = sm.du2;
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
        v = acc[r] * res_row(a.res.f[kg], base + row)[col];
        a.delta[(base + row) * dl.width + dcol + col] = v;
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
    warp_dot_row<R>(sm.du3, s34, a.gw1 + (size_t)j * s34, lane, acc);
    if (j < M2)
      warp_dot_row<R>(sm.du2, a.s2, a.a2w1 + (size_t)j * a.s2, lane, acc);
    warp_sum(acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane != r) continue;
      if (j < M2) {
        sm.datt[j * R + r] = acc[r] * op.cstar[j * R + r];
        sm.dcstar[j * R + r] = acc[r] * op.att[j * R + r];
      } else {
        sm.dmem_new[(j - M2) * R + r] += acc[r];
      }
    }
  }
  __syncthreads();

  // (4) the softmax: dlogits = att * (datt - sum(datt * att)), a warp
  //     per row
  for (int r = warp; r < R; r += nwarp) {
    float sum = 0.0f;
    for (int k = lane; k < M2; k += 32)
      sum += sm.datt[k * R + r] * op.att[k * R + r];
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int row = row0 + r;
    for (int k = lane; k < M2; k += 32) {
      float v = 0.0f;
      if (row < a.n) {
        v = op.att[k * R + r] * (sm.datt[k * R + r] - sum);
        a.delta[(base + row) * dl.width + dl.dlogits + k] = v;
      }
      sm.dlogits[k * R + r] = v;
    }
  }
  __syncthreads();

  // (5) du1 = dlogits @ a1w2^T * kg1
  for (int j = warp; j < a.s1; j += nwarp) {
    float acc[R];
    zero(acc);
    warp_dot_row<R>(sm.dlogits, M2, a.a1w2 + (size_t)j * M2, lane, acc);
    warp_sum(acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      if (lane != r) continue;
      float v = 0.0f;
      if (row < a.n) {
        v = acc[r] * res_row(a.res.f[kKg1], base + row)[j];
        a.delta[(base + row) * dl.width + dl.du1 + j] = v;
      }
      sm.du1[j * R + r] = v;
    }
  }
  __syncthreads();

  // (6) dcstar += du1 @ a1w1^T
  for (int j = warp; j < M2; j += nwarp) {
    float acc[R];
    zero(acc);
    warp_dot_row<R>(sm.du1, a.s1, a.a1w1 + (size_t)j * a.s1, lane, acc);
    warp_sum(acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane == r) sm.dcstar[j * R + r] += acc[r];
  }
  __syncthreads();

  // (7) the LSTM cells, each thread one hidden unit: the gates
  //     recomputed from hp @ wh + xp, cStar's gradient into this step's
  //     cell state ([:, z:] of c_s) and the previous one (of c_prev)
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
      const float* hk = op.hp + k * R;
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
      const float dcs_i = j >= z ? sm.dcstar[(M + j - z) * R + r] : 0.0f;
      const float dcs_p = j >= z ? sm.dcstar[(j - z) * R + r] : 0.0f;
      const float dhv = sm.dh[j * R + r];
      const float dc_i = sm.dc[j * R + r] + dcs_i;
      const float dc_full = dc_i + dhv * so * (1.0f - tc * tc);
      const float di = dc_full * tg * si * (1.0f - si);
      const float df = dc_full * cp * sf * (1.0f - sf);
      const float dgg = dc_full * si * (1.0f - tg * tg);
      const float dov = dhv * tc * so * (1.0f - so);
      sm.dg[j * R + r] = di;
      sm.dg[(H + j) * R + r] = df;
      sm.dg[(2 * H + j) * R + r] = dgg;
      sm.dg[(3 * H + j) * R + r] = dov;
      if (row < a.n) {
        float* d = a.dxp + (base + row) * H4 + j;
        d[0] = di;
        d[H] = df;
        d[2 * H] = dgg;
        d[3 * H] = dov;
      }
      sm.dc[j * R + r] = dc_full * sf + dcs_p;
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
        const float* g = sm.dg + (q * H + j) * R;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(g[r], wv, acc[r]);
      }
    }
    warp_sum(acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane == r) sm.dh[k * R + r] = acc[r];
  }
  for (int i = tid; i < mem * R; i += nthr) sm.dmem[i] = sm.dmem_new[i];
  __syncthreads();
}

template <int R, int V>
__global__ void __launch_bounds__(kMaxThreads)
    mfm_encode_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, M2 = 2 * (H - a.z_tot), mem = a.mem;
  const int s34 = a.s3 + a.s4;
  // feature-major [feature][R] buffers; each variant's own last
  Smem sm;
  Operands op;
  sm.dh = smem;
  sm.dc = sm.dh + H * R;
  op.hp = sm.dc + H * R;
  sm.dmem = op.hp + H * R;
  sm.dmem_new = sm.dmem + mem * R;
  op.cstar = sm.dmem_new + mem * R;
  op.att = op.cstar + M2 * R;
  sm.dq = op.att + M2 * R;
  sm.du3 = sm.dq + 3 * mem * R;
  sm.du2 = sm.du3 + s34 * R;
  sm.datt = sm.du2 + a.s2 * R;
  sm.dcstar = sm.datt + M2 * R;
  sm.dlogits = sm.dcstar + M2 * R;
  sm.du1 = sm.dlogits + M2 * R;
  sm.dg = sm.du1 + a.s1 * R;
  float* const extra = sm.dg + 4 * H * R;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

  // the carries: dh = dh_last, dc = 0, dmem = dmem_last
  load_rows<R>(sm.dh, a.dhlast, 0, a.n, H, 0, H, row0, tid, nthr);
  load_rows<R>(sm.dmem, a.dmemlast, 0, a.n, mem, 0, mem, row0, tid, nthr);
  for (int i = tid; i < H * R; i += nthr) sm.dc[i] = 0.0f;
  __syncthreads();

  // two-step: steps pair up as (s, s - 1) from t - 1 down (t even); at
  // the pair's head both steps' operands are loaded, the second set into
  // `extra`, and the barrier after phase (1) orders both before any read.
  // One copy of the step body serves both steps of the pair.
  // recompute-att: r1 is staged in `extra`.
  Operands op2;
  op2.hp = extra;
  op2.cstar = op2.hp + H * R;
  op2.att = op2.cstar + M2 * R;
  float* const r1 = V == kRecomputeAtt ? extra : nullptr;
  for (int s = a.t - 1; s >= 0; --s) {
    const bool second = V == kTwoStep && ((a.t - 1 - s) & 1);
    if (!second) {
      load_operands<R>(a, s, op, r1, row0, tid, nthr);
      if (V == kTwoStep)
        load_operands<R>(a, s - 1, op2, nullptr, row0, tid, nthr);
    }
    if (V == kRecomputeAtt)
      recompute_att<R>(a, op, r1, tid, nthr, lane, warp, nwarp);
    // the set picked pointer by pointer: a struct picked whole would be
    // addressed through the stack
    Operands cur;
    cur.hp = second ? op2.hp : op.hp;
    cur.cstar = second ? op2.cstar : op.cstar;
    cur.att = second ? op2.att : op.att;
    reverse_step<R>(a, s, cur, sm, row0, tid, nthr, lane, warp, nwarp);
  }
}

template <int R, int V>
cudaError_t launch_bwd(const BwdArgs& a, int threads, cudaStream_t stream) {
  const int M2 = 2 * (a.H - a.z_tot);
  size_t floats = (size_t)R * (7 * a.H + 5 * a.mem + 5 * M2 + a.s1 + a.s2 +
                               a.s3 + a.s4);
  if (V == kRecomputeAtt) floats += (size_t)R * a.s1;
  if (V == kTwoStep) floats += (size_t)R * (a.H + 2 * M2);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mfm_encode_bwd_kernel<R, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + R - 1) / R);
  mfm_encode_bwd_kernel<R, V><<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_bwd_rows(const BwdArgs& a, int rows, int threads,
                            cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_bwd<1, V>(a, threads, stream);
    case 2: return launch_bwd<2, V>(a, threads, stream);
    case 4: return launch_bwd<4, V>(a, threads, stream);
    case 8: return launch_bwd<8, V>(a, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- kernel (b)

constexpr int kTile = 32;        // output tile: kTile x kTile
constexpr int kDwThreads = 256;  // each thread kTile * kTile / 256 outputs
constexpr int kProducts = 14;

// The A operand of a product: a residual field (or a column range of
// one), ones (a bias), cStar, attended = att * cStar, or
// [attended, memp].
enum Operand { kRes, kOnes, kCstar, kAttended, kBoth };

struct Product {
  int operand;
  ResEntry a;  // the residual columns of kRes
  int P;       // rows of the gradient (columns of A)
  int d_col;   // delta column
  int Q;       // columns of the gradient
  int tiles_q;
  float* out;  // (P, Q) row-major
};

struct DwArgs {
  const float* allc;    // (t, n, H)
  const float* allmem;  // (t, n, mem)
  const float* delta;   // (t, n, D)
  ResEntry att;         // the residual field att
  Product prod[kProducts];
  int first_tile[kProducts + 1];
  int t, n, H, z_tot, mem, delta_width;
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
  const int M2 = 2 * (a.H - a.z_tot);
  switch (pr.operand) {
    case kRes:
      return res_row(pr.a, rr)[p];
    case kOnes:
      return 1.0f;
    case kCstar:
      return cstar_at(a, i, b, p);
    case kAttended:
      return res_row(a.att, rr)[p] * cstar_at(a, i, b, p);
    default:  // kBoth
      if (p < M2) return res_row(a.att, rr)[p] * cstar_at(a, i, b, p);
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
// res_ptrs, res_strides and res_cols (host memory) are the
// residual-layout table's ten pointers, row strides and column offsets
// (mfm_res.cuh), in the _RES_NAMES order. cell_dims (host memory) lists
// the n_cells fused hidden widths, summing to H. variant is 0 (stream),
// 1 (recompute-att) or 2 (two-step, t even); rows is the batch rows per
// block (1, 2, 4 or 8), threads a multiple of 32 up to 512.
extern "C" int mfm_encode_bwd(
    const float* xp, const float* allh, const float* allc,
    const float* allmem, void* const* res_ptrs, const int* res_strides,
    const int* res_cols, const float* dhlast, const float* dmemlast,
    const float* wh, const float* a1w1, const float* a1w2,
    const float* a1b2, const float* a2w1, const float* a2w2,
    const float* gw1, const float* g1w2, const float* g2w2, float* dxp,
    float* delta, int t, int n, int H, int z_tot, int mem, int s1, int s2,
    int s3, int s4, int n_cells, const int* cell_dims, int variant,
    int rows, int threads, void* stream) {
  using namespace ftt;
  BwdArgs a;
  a.xp = xp;
  a.allh = allh;
  a.allc = allc;
  a.allmem = allmem;
  a.dhlast = dhlast;
  a.dmemlast = dmemlast;
  a.wh = wh;
  a.a1w1 = a1w1;
  a.a1w2 = a1w2;
  a.a1b2 = a1b2;
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
  int widths[kResFields];
  res_widths(H, z_tot, mem, s1, s2, s3, s4, widths);
  if (!make_cells(n_cells, cell_dims, H, &a.cells) || t < 1 || n < 1 ||
      z_tot < 0 || z_tot >= H || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || res_ptrs == nullptr ||
      !make_res_table(res_ptrs, res_strides, res_cols, widths, &a.res) ||
      (variant == kTwoStep && t % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kStream: return (int)launch_bwd_rows<kStream>(a, rows, threads, st);
    case kRecomputeAtt:
      return (int)launch_bwd_rows<kRecomputeAtt>(a, rows, threads, st);
    case kTwoStep:
      return (int)launch_bwd_rows<kTwoStep>(a, rows, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel (b). The residuals through the layout table, as for kernel (a).
// The gradients, each (P, Q) row-major, in the order of the JAX package's
// _W_NAMES without wh: a1w1, a1b1, a1w2, a1b2, a2w1, a2b1, a2w2, a2b2,
// gw1, gb1, g1w2, g1b2, g2w2, g2b2.
extern "C" int mfm_encode_dw(
    const float* allc, const float* allmem, void* const* res_ptrs,
    const int* res_strides, const int* res_cols, const float* delta,
    float* d_a1w1, float* d_a1b1, float* d_a1w2, float* d_a1b2,
    float* d_a2w1, float* d_a2b1, float* d_a2w2, float* d_a2b2,
    float* d_gw1, float* d_gb1, float* d_g1w2, float* d_g1b2, float* d_g2w2,
    float* d_g2b2, int t, int n, int H, int z_tot, int mem, int s1, int s2,
    int s3, int s4, void* stream) {
  using namespace ftt;
  int widths[kResFields];
  res_widths(H, z_tot, mem, s1, s2, s3, s4, widths);
  ResTable res;
  if (t < 1 || n < 1 || z_tot < 0 || z_tot >= H || res_ptrs == nullptr ||
      !make_res_table(res_ptrs, res_strides, res_cols, widths, &res))
    return (int)cudaErrorInvalidValue;
  const DeltaLayout l = delta_layout(H, z_tot, mem, s1, s2, s3, s4);
  const int m2 = 2 * (H - z_tot), s34 = s3 + s4;
  DwArgs a;
  a.allc = allc;
  a.allmem = allmem;
  a.delta = delta;
  a.att = res.f[kAtt];
  a.t = t;
  a.n = n;
  a.H = H;
  a.z_tot = z_tot;
  a.mem = mem;
  a.delta_width = l.width;
  const ResEntry none = {nullptr, 0, 0};
  ResEntry r3b = res.f[kR3];  // r3's second half feeds g2w2
  r3b.col += s3;
  const Product table[kProducts] = {
      {kCstar, none, m2, l.du1, s1, 0, d_a1w1},
      {kOnes, none, 1, l.du1, s1, 0, d_a1b1},
      {kRes, res.f[kR1], s1, l.dlogits, m2, 0, d_a1w2},
      {kOnes, none, 1, l.dlogits, m2, 0, d_a1b2},
      {kAttended, none, m2, l.du2, s2, 0, d_a2w1},
      {kOnes, none, 1, l.du2, s2, 0, d_a2b1},
      {kRes, res.f[kR2], s2, l.dch, mem, 0, d_a2w2},
      {kOnes, none, 1, l.dch, mem, 0, d_a2b2},
      {kBoth, none, m2 + mem, l.du3, s34, 0, d_gw1},
      {kOnes, none, 1, l.du3, s34, 0, d_gb1},
      {kRes, res.f[kR3], s3, l.dq1, mem, 0, d_g1w2},
      {kOnes, none, 1, l.dq1, mem, 0, d_g1b2},
      {kRes, r3b, s4, l.dq2, mem, 0, d_g2w2},
      {kOnes, none, 1, l.dq2, mem, 0, d_g2b2},
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
