// Fused MFM encode, backward: four passes for the reverse pass and a
// deterministic reduction kernel for the weight gradients.
//
// Replaces: factorized_tpu/ops/pallas_mfn.py::_bwd_kernel (reached through
// _bwd_call and the custom_vjp backward _encode_bwd of mfm_encode_pallas).
// Its variants replace the probe kernels of scripts/: the stream variant
// reading ten separate residual tensors is bwd_residual_probe.py's
// _bwd_res_kernel with store_att (variant C); the recompute-att variant is
// the same kernel without it (variant B); the two-step variant is
// twostep_bwd_probe.py's _bwd2_kernel. The stream variant on one residual
// buffer is the same function as bwd_residual_probe.py's
// _bwd_stream_kernel (the production kernel's shape).
//
// What it computes: from the forward's residuals (allh, allc, allmem and
// the ten _RES_NAMES fields, read through the residual-layout table of
// mfm_res.cuh) and the cotangents of h_last and mem_last, BPTT through the
// memory update, the gamma gates, the att2 proposal, the softmax attention,
// att1 and the six fused LSTM cells: dxp = dgates (t, n, 4H), and, per
// step, the deltas whose products with forward activations are the 14
// non-wh weight and bias gradients (dq1, dq2, du3, dch, du2, dlogits, du1:
// a (t, n, D) buffer). The TPU kernel sums those 14 in VMEM across its
// sequential grid; here kernel (b) reduces them.
//
// The TPU kernel's one chain of nine dependent phases a step is three
// chains, and only two of them carry anything from step to step:
//
// (1) gates_kernel: gates = xp + h_{s-1} @ wh over the diagonal blocks of
//     wh, for all t * n rows at once (no carry), into scratch.
// (2) mem_chain_kernel, serial over t: the memory carry
//     dmem_prev = dmem * g1 + du3 @ gw1[M2:]^T, where du3 = [dq1 @ g1w2^T,
//     dq2 @ g2w2^T] * kg3 and dq1, dq2 are elementwise in dmem. Nothing of
//     the attention branch or the LSTM cells enters it. One block per tile
//     of batch rows keeps g1w2, g2w2 and gw1[M2:] (128 KiB) in shared
//     memory, copied in once with cp.async. A step: dq1, dq2, dch
//     elementwise; du3; a block barrier; the carry; a block barrier.
//     Writes the dq1, dq2, dch and du3 deltas. Where those weights pass
//     one block's shared memory (2 mem (s3 + s4) floats: 256 KiB at mem
//     128 and both gamma MLPs 128 wide), a thread-block cluster of the
//     smallest size that fits splits du3's and the carry's columns, the
//     peers trading du3 and the carry through distributed shared memory
//     after a cluster barrier each (at the pinned widths one block fits,
//     and every cluster was slower: PERF.md). Past a cluster of 8 the
//     chain reads the weights' rows in place from L2.
// (3) The attention branch, all t * n rows at once (no carry), as
//     product_kernel in tiles and softmax_bwd_kernel: du2 = dch @ a2w2^T
//     * kg2; dattended = du3 @ gw1[:M2]^T + du2 @ a2w1^T, with datt =
//     dattended * cStar and dcstar = dattended * att; the softmax
//     backward to dlogits; du1 = dlogits @ a1w2^T * kg1; dcstar += du1 @
//     a1w1^T, into scratch. Writes the du2, dlogits and du1 deltas. The
//     recompute-att variant first recomputes att = softmax(r1 @ a1w2 +
//     a1b2) (recompute_att_kernel) in the forward's order of operations,
//     so it has the bits the forward stored.
// (4) lstm_chains_kernel, serial over t: one block per (cell, row tile),
//     the cell's diagonal blocks of wh in shared memory (cell_bwd.cuh):
//     the gate backward from the precomputed gates, dcstar split between
//     this step's c and the previous one's (units past z_tot), and dh =
//     dgates @ W_cell^T. Writes dxp. A cell past one block's shared
//     memory splits its gate columns over a cluster (cell_bwd.cuh), and
//     past a cluster of 8 reads its weights in place from L2.
//
// Variants (the same bits as the stream variant): stream, one step per
// iteration of the chains, the next step's operands copied in with
// cp.async during the current one; recompute-att, att recomputed in (3);
// two-step, the chains taking steps in pairs, both steps' operands loaded
// at the pair's head (t even). dWh = allh[:-1]^T dxp[1:] is one GEMM
// outside, as in the JAX package.
//
// What bounds it on an H100: operations. At the training batch (n = 32,
// t = 20, best_acc_mosi_config) the reverse pass does 0.60 GFLOP of useful
// float32 work (the gate recompute and the transposed products, only the
// diagonal blocks of wh) against about 17 MB of traffic: 9 us at
// 67 TFLOP/s against 5 us at 3.35 TB/s. What is left above the bound is
// the two serial chains: t steps of three barriers (the memory chain) and of two
// (the LSTM chains), each around a product that streams the chain's
// weights from shared memory (the 88-unit cell's 124 KB every step), and
// the wait for the next step's operands. Float32 on the CUDA cores
// throughout: a TF32 product keeps about
// three digits, too few for the gradient tolerances, and a tile of a few
// batch rows is far below wgmma's 64. Every product of the TPU kernel's
// body is computed in these kernels, each in a fixed order: no atomics,
// the same bits on every run. A chain whose weights pass one block's 227
// KB splits them over a cluster, and past a cluster of 8 reads them from
// L2, planned from the widths before any pass starts; a launch is refused
// only where a chain's per-row state alone passes a block. An attention
// product whose staged depth passes a block sums it in chunks.
//
// (b) mfm_encode_dw_kernel replaces the 14 weight-gradient sums that
//     _bwd_kernel keeps in VMEM across its grid (pallas_mfn.py:342-372).
//     They are 7 products A^T delta over the K = t n rows, each bias the
//     column sum of its weight's delta, A taken from the residuals (r1,
//     r2, the two halves of r3) or rebuilt from them (cStar from allc,
//     attended = att * cStar, memp from allmem). Operations bound it: at
//     the training batch 0.38 GFLOP against 9 MB, 5.7 us at 67 TFLOP/s
//     against 2.7 us at 3.35 TB/s. So the design keeps the CUDA cores fed
//     and all SMs busy: 64 x 64 output tiles, each of 256 threads summing
//     a 4 x 4 micro-tile from float4 reads of chunks of 32 rows that
//     cp.async stages in shared memory, double-buffered (16-byte copies
//     where the widths and offsets allow, else a 4-byte instantiation);
//     operands built per chunk, the previous step a row offset of n and
//     attended formed once per staged element; the main path's 80 tiles
//     fill the 132 SMs by splitting K over a thread-block cluster of S
//     blocks (1, 2, 4 or 8, chosen on the host from the tile count),
//     whose partial tiles are added in slice order through distributed
//     shared memory. No atomics, no global scratch, one launch: the same
//     bits on every run. TF32 tensor cores would keep about three digits,
//     too few for the gradient tolerances (3xTF32 is the next step).

#include <cuda_runtime.h>
#include <math.h>

#include "cell_bwd.cuh"
#include "lstm_common.cuh"
#include "mfm_res.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;
// Rows a block takes, the fastest measured at the training batch
// (perf_probe.py train, PERF.md): flat (step, batch row) rows of the gates
// pass and of att's recompute, and batch rows of the memory chain and of
// the LSTM chains.
constexpr int kTileRows = 4;
constexpr int kMemRows = 1;
constexpr int kCellRows = 2;

// The variants of the reverse pass.
enum Variant { kStream = 0, kRecomputeAtt = 1, kTwoStep = 2 };

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
  float* gates;           // (t, n, 4H) scratch: pass (1) to pass (4)
  float* dcstar;          // (t, n, M2) scratch: pass (3) to pass (4)
  float* datt;            // (t, n, M2) scratch within pass (3)
  ResEntry att;           // att: the residual field, or recomputed scratch
  long long* clocks;      // the per-phase probe's buffer, or null
  int t, n, H, z_tot, mem, s1, s2, s3, s4, m2;
  Cells cells;
  DeltaLayout dl;
};

using Kernel = void (*)(const BwdArgs);

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
}

// Flat rows [rr0, rr0 + R) (rr = s n + b) of a (t n, width) tensor,
// shifted back by `back` rows (n: the step before), columns [col0, col0 +
// count), into feature-major dst [count][R]; zeros outside [back, rows).
template <int R>
__device__ __forceinline__ void load_flat(float* dst, const float* src,
                                          int rows, int back, int width,
                                          int col0, int count, int rr0,
                                          int tid, int nthr) {
  for (int i = tid; i < R * count; i += nthr) {
    const int r = i / count, k = i - r * count, rr = rr0 + r;
    float v = 0.0f;
    if (rr < rows && rr >= back)
      v = src[(size_t)(rr - back) * width + col0 + k];
    dst[k * R + r] = v;
  }
}

// ------------------------------------------------------ pass (1): gates

// Block: R flat rows; a thread per gate column, the hidden state before
// each row's step staged in shared memory; the forward's order of
// operations (xp, then the cell's rows of wh in order).
template <int R>
__global__ void __launch_bounds__(kMaxThreads) gates_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* const hp = smem;  // [H][R]
  const int H = a.H, H4 = 4 * H, rows = a.t * a.n, rr0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  load_flat<R>(hp, a.allh, rows, a.n, H, 0, H, rr0, tid, nthr);
  __syncthreads();
  for (int j = tid; j < H4; j += nthr) {
    int k0, k1;
    cell_range(a.cells, j % H, k0, k1);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = rr0 + r < rows ? a.xp[(size_t)(rr0 + r) * H4 + j] : 0.0f;
    for (int k = k0; k < k1; ++k) {
      const float wv = __ldg(a.wh + (size_t)k * H4 + j);
      const float* hk = hp + k * R;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(hk[r], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (rr0 + r < rows) a.gates[(size_t)(rr0 + r) * H4 + j] = acc[r];
  }
}

// ----------------------------------------------- pass (2): memory chain

// A block's share of the memory chain's columns in a cluster of C (all
// of them for C = 1): du3 columns [u0, u1) and carry columns [m0, m1); ks
// lanes share an output and p is the weight rows' pitch in shared memory.
// Sized by the largest share, cu and cm columns.
struct MemTile {
  int u0, u1, m0, m1, cu, cm, ks3, p3, ksm, pm;
};

__host__ __device__ inline MemTile mem_tile(int s34, int mem, int C,
                                            int rank, int threads) {
  MemTile m;
  m.u0 = s34 * rank / C;
  m.u1 = s34 * (rank + 1) / C;
  m.m0 = mem * rank / C;
  m.m1 = mem * (rank + 1) / C;
  m.cu = (s34 + C - 1) / C;
  m.cm = (mem + C - 1) / C;
  m.ks3 = lanes_per_output(m.cu, threads);
  m.p3 = conflict_free_pitch(mem, m.ks3);
  m.ksm = lanes_per_output(m.cm, threads);
  m.pm = conflict_free_pitch(s34, m.ksm);
  return m;
}

// Operand floats a row and step: chat, g1, g2, memp (mem each), kg3.
__host__ __device__ inline int mem_op_width(int mem, int s34) {
  return 4 * mem + s34;
}

// The weights' shares, two steps' operands and the per-row state; for
// C = kWeightsL2 the operands and the state alone.
__host__ __device__ inline size_t mem_chain_floats(int mem, int s34, int C,
                                                   int R, int threads) {
  const size_t state = (size_t)2 * R * mem_op_width(mem, s34) +
                       (size_t)R * (2 * mem + mem + 2 * mem + s34);
  if (C == kWeightsL2) return state;
  const MemTile m = mem_tile(s34, mem, C, 0, threads);
  return (size_t)m.cu * m.p3 + (size_t)m.cm * m.pm + state;
}

// The operands of step s, row-major [R][chat | g1 | g2 | memp | kg3],
// asynchronously; zeros past n and for memp before step 0.
template <int R>
__device__ __forceinline__ void load_mem_ops(const BwdArgs& a, int s,
                                             float* o, int row0, int tid,
                                             int nthr) {
  const int mem = a.mem, W = mem_op_width(mem, a.s3 + a.s4);
  for (int i = tid; i < R * W; i += nthr) {
    const int r = i / W, f = i - r * W, row = row0 + r;
    const float* src = nullptr;
    if (row < a.n) {
      const size_t at = (size_t)s * a.n + row;
      if (f < mem)
        src = res_row(a.res.f[kChat], at) + f;
      else if (f < 2 * mem)
        src = res_row(a.res.f[kG1], at) + f - mem;
      else if (f < 3 * mem)
        src = res_row(a.res.f[kG2], at) + f - 2 * mem;
      else if (f < 4 * mem)
        src = s > 0 ? a.allmem + (at - a.n) * mem + f - 3 * mem : nullptr;
      else
        src = res_row(a.res.f[kKg3], at) + f - 4 * mem;
    }
    if (src != nullptr)
      cp_async4(o + i, src);
    else
      o[i] = 0.0f;
  }
}

// Block: rank `rank` of a cluster of C over R batch rows. P: two-step.
// L2: the weights' rows read in place (C = 1).
template <int R, bool P, int C, bool L2>
__global__ void __launch_bounds__(kMaxThreads)
    mem_chain_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const int mem = a.mem, s3 = a.s3, s34 = a.s3 + a.s4;
  const int W = mem_op_width(mem, s34);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const int row0 = (blockIdx.x / C) * R;
  const MemTile m = mem_tile(s34, mem, C, rank, nthr);
  const DeltaLayout& dl = a.dl;

  float* const w3 = smem;              // [cu][p3]: g1w2 | g2w2 rows
  float* const wm = w3 + m.cu * m.p3;  // [cm][pm]: gw1 rows M2 + c
  // two [R][W]: step s's at s & 1
  float* const ops = L2 ? smem : wm + m.cm * m.pm;
  float* dmem = ops + 2 * R * W;       // [R][mem]: the carry into the step
  float* dnext = dmem + R * mem;       // [R][mem]: the carry out of it
  float* const carry = dnext + R * mem;  // [R][mem]: dmem * g1
  float* const dq = carry + R * mem;     // [R][2 mem]: dq1 | dq2
  float* const du3 = dq + R * 2 * mem;   // [R][s34]

  const int nu = m.u1 - m.u0, nm = m.m1 - m.m0;
  // the first `split` of the block's du3 rows come from g1w2, the rest
  // from g2w2
  const int split = s3 <= m.u0 ? 0 : (s3 - m.u0 < nu ? s3 - m.u0 : nu);
  if (!L2) {
    copy_rows_async(w3, m.p3, a.g1w2 + (size_t)m.u0 * mem, mem, split, mem,
                    tid, nthr);
    copy_rows_async(w3 + split * m.p3, m.p3,
                    a.g2w2 + (size_t)(m.u0 + split - s3) * mem, mem,
                    nu - split, mem, tid, nthr);
    copy_rows_async(wm, m.pm, a.gw1 + (size_t)(a.m2 + m.m0) * s34, s34, nm,
                    s34, tid, nthr);
  }
  for (int i = tid; i < R * mem; i += nthr) {
    const int r = i / mem, row = row0 + r;
    dmem[i] = row < a.n ? a.dmemlast[(size_t)row * mem + i - r * mem] : 0.0f;
  }
  if (!P) load_mem_ops<R>(a, a.t - 1, ops + ((a.t - 1) & 1) * R * W, row0,
                         tid, nthr);
  cp_async_wait_all();
  __syncthreads();
  FTT_STAMP(a.clocks, kClockMemChainBwd, 0, 0);

  for (int s = a.t - 1; s >= 0; --s) {
    float* const op = ops + (s & 1) * R * W;
    float* const prev = ops + ((s + 1) & 1) * R * W;
    if (P) {
      if (((a.t - 1 - s) & 1) == 0) {
        load_mem_ops<R>(a, s, op, row0, tid, nthr);
        if (s > 0) load_mem_ops<R>(a, s - 1, prev, row0, tid, nthr);
        cp_async_wait_all();
        __syncthreads();
      }
    } else if (s > 0) {
      load_mem_ops<R>(a, s - 1, prev, row0, tid, nthr);
    }
    const size_t base = (size_t)s * a.n;

    // (a) the memory update and the gamma heads, elementwise: dq1, dq2,
    //     dch and dmem * g1; the block writes its columns' deltas
    for (int i = tid; i < R * mem; i += nthr) {
      const int r = i / mem, k = i - r * mem, row = row0 + r;
      const float* o = op + r * W;
      const float chat = o[k], g1 = o[mem + k], g2 = o[2 * mem + k];
      const float memp = o[3 * mem + k], dm = dmem[i];
      const float q1 = dm * memp * g1 * (1.0f - g1);
      const float q2 = dm * chat * g2 * (1.0f - g2);
      const float ch = dm * g2 * (1.0f - chat * chat);
      dq[r * 2 * mem + k] = q1;
      dq[r * 2 * mem + mem + k] = q2;
      carry[i] = dm * g1;
      if (row < a.n && (C == 1 || (k >= m.m0 && k < m.m1))) {
        float* d = a.delta + (base + row) * dl.width;
        d[dl.dq1 + k] = q1;
        d[dl.dq2 + k] = q2;
        d[dl.dch + k] = ch;
      }
    }
    __syncthreads();
    FTT_STAMP(a.clocks, kClockMemChainBwd, a.t - s, 0);

    // (b) du3 = [dq1 @ g1w2^T, dq2 @ g2w2^T] * kg3 for the block's columns
    for (int b0 = warp * 32; b0 < nu * m.ks3; b0 += nwarp * 32) {
      const int item = b0 + lane, jl = item / m.ks3;
      const int slice = item - jl * m.ks3, j = m.u0 + jl;
      const bool ok = item < nu * m.ks3;
      float acc[R];
      zero(acc);
      if (ok) {
        const float* row =
            !L2 ? w3 + jl * m.p3
            : j < s3 ? a.g1w2 + (size_t)j * mem
                     : a.g2w2 + (size_t)(j - s3) * mem;
        smem_dot<R>(dq + (j < s3 ? 0 : mem), 2 * mem, mem, row, slice,
                    m.ks3, acc);
      }
      lanes_sum<R>(acc, m.ks3);
      if (ok && slice == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float v = acc[r] * op[r * W + 4 * mem + j];
          du3[r * s34 + j] = v;
          if (row0 + r < a.n)
            a.delta[(base + row0 + r) * dl.width + dl.du3 + j] = v;
        }
      }
    }
    if (s == 0) break;  // the carry out of step 0 is not needed
    if (C > 1) gather_peers<C, R>(du3, s34, rank, tid, nthr);
    __syncthreads();
    FTT_STAMP(a.clocks, kClockMemChainBwd, a.t - s, 1);

    // (c) the carry's columns: dmem * g1 + du3 @ gw1[M2:]^T
    for (int b0 = warp * 32; b0 < nm * m.ksm; b0 += nwarp * 32) {
      const int item = b0 + lane, cl = item / m.ksm;
      const int slice = item - cl * m.ksm, c = m.m0 + cl;
      const bool ok = item < nm * m.ksm;
      float acc[R];
      zero(acc);
      if (ok)
        smem_dot<R>(du3, s34, s34,
                    L2 ? a.gw1 + (size_t)(a.m2 + c) * s34 : wm + cl * m.pm,
                    slice, m.ksm, acc);
      lanes_sum<R>(acc, m.ksm);
      if (ok && slice == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          dnext[r * mem + c] = carry[r * mem + c] + acc[r];
      }
    }
    if (C > 1) gather_peers<C, R>(dnext, mem, rank, tid, nthr);
    float* const spent = dmem;
    dmem = dnext;
    dnext = spent;
    cp_async_wait_all();
    __syncthreads();
    FTT_STAMP(a.clocks, kClockMemChainBwd, a.t - s, 2);
  }
  // no block leaves while a peer may still read its shared memory
  if (C > 1) cluster_barrier<C>();
}

// ----------------------------------------- pass (3): attention branch
//
// Over all t n flat rows at once (no carry), in five launches: du2;
// dattended, whose epilogue writes datt and dcstar's first part; the
// softmax backward to dlogits; du1; dcstar's second part. Each product is
// A @ W^T in kTile x kTile output tiles: a block copies its tile's rows of
// A and of W, the whole depth, into shared memory at once with cp.async;
// kSplit groups of 64 threads each take a quarter of the depth, each
// thread summing a 4 x 4 tile of outputs in order of k, and the groups'
// partial tiles are added in a fixed order. The recompute-att variant
// first writes att into scratch.

constexpr int kTile = 32;  // output tile: kTile x kTile
constexpr int kSplit = 4;  // groups of 8 x 8 threads, a 4 x 4 tile each
constexpr int kProductThreads = 64 * kSplit;

// att = softmax(r1 @ a1w2 + a1b2) for R rows, with the forward's order of
// operations (its tiled product, mfm_encode_fwd.cu, sums each logit in
// kSplit quarters of the depth, each from zero in order of k, adds the
// quarters in order and then the bias; then a warp per row), so att has
// the bits the forward stored.
template <int R>
__device__ __forceinline__ void recompute_att(const BwdArgs& a, float* att,
                                              const float* r1, int tid,
                                              int nthr, int lane, int warp,
                                              int nwarp) {
  const int M2 = a.m2, K = a.s1;
  for (int j = tid; j < M2; j += nthr) {
    float acc[R];
    const float* wj = a.a1w2 + j;
    for (int g = 0; g < kSplit; ++g) {
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.0f;
      for (int k = K * g / kSplit; k < K * (g + 1) / kSplit; ++k) {
        const float wv = __ldg(wj + (size_t)k * M2);
        const float* rk = r1 + k * R;
#pragma unroll
        for (int r = 0; r < R; ++r) part[r] = fmaf(rk[r], wv, part[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = g == 0 ? part[r] : acc[r] + part[r];
    }
    const float b = __ldg(a.a1b2 + j);
#pragma unroll
    for (int r = 0; r < R; ++r) att[j * R + r] = acc[r] + b;
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

// The recompute-att variant's att, R flat rows a block, into the scratch
// that a.att points at.
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    recompute_att_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* const r1 = smem;              // [s1][R]
  float* const att = r1 + a.s1 * R;    // [M2][R]
  const int rows = a.t * a.n, rr0 = blockIdx.x * R, M2 = a.m2;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const ResEntry& e = a.res.f[kR1];
  load_flat<R>(r1, e.ptr, rows, 0, e.stride, e.col, a.s1, rr0, tid, nthr);
  __syncthreads();
  recompute_att<R>(a, att, r1, tid, nthr, tid & 31, tid >> 5, nthr >> 5);
  __syncthreads();
  for (int i = tid; i < R * M2; i += nthr) {
    const int r = i / M2, k = i - r * M2, rr = rr0 + r;
    if (rr < rows) res_row(a.att, rr)[k] = att[k * R + r];
  }
}

enum ProductId { kDu2 = 0, kDattended = 1, kDu1 = 2, kDcstarAdd = 3 };

// One A @ W^T term: A's rows from `a` (row stride lda), W (N, K) row-major.
struct Term {
  const float* a;
  int lda;
  const float* w;
  int K;
};

struct ProductSpec {
  Term term[2];
  int terms, N;
};

__host__ __device__ inline ProductSpec product_spec(const BwdArgs& a,
                                                    int id) {
  const DeltaLayout& l = a.dl;
  const int D = l.width, s34 = a.s3 + a.s4;
  ProductSpec p;
  p.terms = 1;
  switch (id) {
    case kDu2:  // dch @ a2w2^T
      p.term[0] = {a.delta + l.dch, D, a.a2w2, a.mem};
      p.N = a.s2;
      break;
    case kDattended:  // du3 @ gw1[:M2]^T + du2 @ a2w1^T
      p.term[0] = {a.delta + l.du3, D, a.gw1, s34};
      p.term[1] = {a.delta + l.du2, D, a.a2w1, a.s2};
      p.terms = 2;
      p.N = a.m2;
      break;
    case kDu1:  // dlogits @ a1w2^T
      p.term[0] = {a.delta + l.dlogits, D, a.a1w2, a.m2};
      p.N = a.s1;
      break;
    default:  // du1 @ a1w1^T
      p.term[0] = {a.delta + l.du1, D, a.a1w1, a.s1};
      p.N = a.m2;
      break;
  }
  return p;
}

// Rows of a staged operand in shared memory: a warp reads 8 rows at once,
// 4 consecutive floats from each (conflict_free_pitch). The groups'
// partial tiles reuse the space afterwards.
__host__ __device__ inline int product_pitch(int K) {
  return conflict_free_pitch(K, 4);
}

__host__ __device__ inline size_t product_floats(const ProductSpec& p) {
  size_t f = 0;
  for (int o = 0; o < p.terms; ++o)
    f += (size_t)2 * kTile * product_pitch(p.term[o].K);
  const size_t parts = (size_t)kSplit * kTile * kTile;
  return f > parts ? f : parts;
}

// A product whose terms' staged operands pass one block (M2 past about
// 900 at the widest widths) stages each term in the fewest equal depth
// chunks [K i / nc, K (i + 1) / nc) that fit, one after another.
__host__ __device__ inline bool product_whole(const ProductSpec& p) {
  return product_floats(p) * sizeof(float) <= (size_t)kMaxSmemBytes;
}

__host__ __device__ inline int term_chunks(int K) {
  int nc = 1;
  while ((size_t)2 * kTile * product_pitch((K + nc - 1) / nc) *
             sizeof(float) >
         (size_t)kMaxSmemBytes)
    ++nc;
  return nc;
}

// The shared memory a product's block takes, chunked or whole.
__host__ __device__ inline size_t product_bytes(const ProductSpec& p) {
  if (product_whole(p)) return product_floats(p) * sizeof(float);
  size_t most = (size_t)kSplit * kTile * kTile;
  for (int o = 0; o < p.terms; ++o) {
    const int K = p.term[o].K, nc = term_chunks(K);
    const size_t f = (size_t)2 * kTile * product_pitch((K + nc - 1) / nc);
    if (f > most) most = f;
  }
  return most * sizeof(float);
}

// Columns [kb, kb + K) of the tile's rows of A and of W, asynchronously,
// into s ([kTile][pitch] each, A's first); rows past the ends zeros.
__device__ __forceinline__ void stage_term(float* s, const Term& q, int kb,
                                           int K, int m0, int n0,
                                           int live_m, int live_n, int tid,
                                           int nthr) {
  const int pitch = product_pitch(K);
  copy_rows_async(s, pitch, q.a + (size_t)m0 * q.lda + kb, q.lda, live_m, K,
                  tid, nthr);
  copy_rows_async(s + kTile * pitch, pitch, q.w + (size_t)n0 * q.K + kb,
                  q.K, live_n, K, tid, nthr);
  for (int e = tid; e < (2 * kTile - live_m - live_n) * K; e += nthr) {
    const int i = e / K, k = e - i * K;
    const int row = i < kTile - live_m
                        ? live_m + i
                        : kTile + live_n + i - (kTile - live_m);
    s[row * pitch + k] = 0.0f;
  }
}

// Group g's quarter of a staged depth K into this thread's 4 x 4 tile.
__device__ __forceinline__ void accumulate_term(const float* s, int K, int g,
                                                int tx, int ty,
                                                float (&acc)[4][4]) {
  const int pitch = product_pitch(K);
  const float* A = s + ty * pitch;
  const float* W = s + (kTile + tx) * pitch;
  for (int k = K * g / kSplit; k < K * (g + 1) / kSplit; ++k) {
    float av[4], wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = A[8 * i * pitch + k];
      wv[i] = W[8 * i * pitch + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
  }
}

// Where output (m, n) of product P goes: a delta (times its mask-and-relu
// field), or datt and dcstar's first part, or added to dcstar.
template <int P>
__device__ __forceinline__ void product_out(const BwdArgs& a, int m, int n,
                                            float v) {
  const DeltaLayout& l = a.dl;
  float* const d = a.delta + (size_t)m * l.width;
  if (P == kDu2) {
    d[l.du2 + n] = v * res_row(a.res.f[kKg2], m)[n];
  } else if (P == kDattended) {
    // cStar: c of the step before (zeros before step 0), then c of the
    // step, past z_tot
    const int M = a.m2 / 2;
    float cs;
    if (n < M)
      cs = m >= a.n ? a.allc[(size_t)(m - a.n) * a.H + a.z_tot + n] : 0.0f;
    else
      cs = a.allc[(size_t)m * a.H + a.z_tot + n - M];
    a.datt[(size_t)m * a.m2 + n] = v * cs;
    a.dcstar[(size_t)m * a.m2 + n] = v * res_row(a.att, m)[n];
  } else if (P == kDu1) {
    d[l.du1 + n] = v * res_row(a.res.f[kKg1], m)[n];
  } else {
    a.dcstar[(size_t)m * a.m2 + n] += v;
  }
}

// Block: one kTile x kTile tile of product P's (t n, N) output. Chunked:
// each term's depth in term_chunks pieces (else every term's whole depth
// at once, product_whole, at every width but the widest: a separate
// instantiation, so the common one carries no chunk arithmetic).
template <int P, bool Chunked>
__global__ void __launch_bounds__(kProductThreads)
    product_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const ProductSpec p = product_spec(a, P);
  const int rows = a.t * a.n, tiles_n = (p.N + kTile - 1) / kTile;
  const int m0 = (blockIdx.x / tiles_n) * kTile;
  const int n0 = (blockIdx.x % tiles_n) * kTile;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // this thread's group (a quarter of the depth) and its 4 x 4 outputs,
  // rows ty + 8 i and columns tx + 8 j of the tile
  const int g = tid / 64, tx = tid % 8, ty = (tid % 64) / 8;
  const int live_m = rows - m0 < kTile ? rows - m0 : kTile;
  const int live_n = p.N - n0 < kTile ? p.N - n0 : kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  if (!Chunked) {
    // every term's whole depth staged at once
    float* s = smem;
    for (int o = 0; o < p.terms; ++o) {
      stage_term(s, p.term[o], 0, p.term[o].K, m0, n0, live_m, live_n, tid,
                 nthr);
      s += 2 * kTile * product_pitch(p.term[o].K);
    }
    cp_async_wait_all();
    __syncthreads();
    s = smem;
    for (int o = 0; o < p.terms; ++o) {
      accumulate_term(s, p.term[o].K, g, tx, ty, acc);
      s += 2 * kTile * product_pitch(p.term[o].K);
    }
  } else {
    // each term in depth chunks, one staged at a time
    for (int o = 0; o < p.terms; ++o) {
      const int KT = p.term[o].K, nc = term_chunks(KT);
      for (int ch = 0; ch < nc; ++ch) {
        const int kb = KT * ch / nc, K = KT * (ch + 1) / nc - kb;
        if (o > 0 || ch > 0) __syncthreads();  // the last chunk is read
        stage_term(smem, p.term[o], kb, K, m0, n0, live_m, live_n, tid,
                   nthr);
        cp_async_wait_all();
        __syncthreads();
        accumulate_term(smem, K, g, tx, ty, acc);
      }
    }
  }
  __syncthreads();  // the staged operands are read: reuse the space
  float* const part = smem + g * kTile * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(ty + 8 * i) * kTile + tx + 8 * j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < kTile * kTile; e += nthr) {
    float v = smem[e];
#pragma unroll
    for (int q = 1; q < kSplit; ++q) v += smem[q * kTile * kTile + e];
    const int m = m0 + e / kTile, n = n0 + e % kTile;
    if (m < rows && n < p.N) product_out<P>(a, m, n, v);
  }
}

// dlogits = att * (datt - sum(datt * att)), a warp per flat row.
__global__ void __launch_bounds__(kMaxThreads)
    softmax_bwd_kernel(const BwdArgs a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= a.t * a.n) return;  // the whole warp
  const int M2 = a.m2;
  const float* datt = a.datt + (size_t)m * M2;
  const float* att = res_row(a.att, m);
  float sum = 0.0f;
  for (int k = lane; k < M2; k += 32) sum += datt[k] * att[k];
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float* d = a.delta + (size_t)m * a.dl.width + a.dl.dlogits;
  for (int k = lane; k < M2; k += 32) d[k] = att[k] * (datt[k] - sum);
}

// ------------------------------------------------ pass (4): LSTM chains

// Operand floats a row and unit: gates 4, c, c_prev, and dcstar's 2.
constexpr int kCellOpWidth = 8;

template <int R>
__device__ __forceinline__ void load_cell_step(const BwdArgs& a, int s,
                                               const CellStep& op,
                                               const CellTile& c, int row0,
                                               int tid, int nthr) {
  const int H = a.H, M = a.H - a.z_tot;
  for (int q = 0; q < 4; ++q)
    load_rows_async<R>(op.g + q * c.h * R, a.gates, s, a.n, 4 * H,
                       q * H + c.k0, c.h, row0, tid, nthr);
  load_rows_async<R>(op.c, a.allc, s, a.n, H, c.k0, c.h, row0, tid, nthr);
  load_rows_async<R>(op.cp, s > 0 ? a.allc : nullptr, s - 1, a.n, H, c.k0,
                     c.h, row0, tid, nthr);
  if (op.dcs != nullptr) {
    load_rows_async<R>(op.dcs, a.dcstar, s, a.n, a.m2, c.k0 - a.z_tot, c.h,
                       row0, tid, nthr);
    load_rows_async<R>(op.dcs + c.h * R, a.dcstar, s, a.n, a.m2,
                       M + c.k0 - a.z_tot, c.h, row0, tid, nthr);
  }
}

// blockIdx.y is the cell, blockIdx.x / C the row tile and the rank in
// the cluster of C its share of the cell's gate columns. P: two-step.
// L2: the weights read in place (C = 1).
template <int R, bool P, int C, bool L2>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_chains_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const CellTile c =
      cell_tile<C, L2>(a.cells, blockIdx.y, blockDim.x, rank, a.H);
  const int h = c.h;
  const int row0 = (blockIdx.x / C) * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const float* const w = cell_weights<L2>(smem, a.wh, a.H, c.k0);
  float* const dh = smem + (L2 ? 0 : h * c.wp);
  float* const dc = dh + pad4(h * R);
  // [4h][R]; for a cluster [C kc][R], the rows past 4h zero
  float* const dg = dc + pad4(h * R);
  // two operand buffers; step s uses buffer s & 1. cStar covers the cells
  // past z_tot (a cell boundary). Then, for a cluster, two partial dh
  float* const buf = dg + (C == 1 ? 4 * h : C * c.kc) * R;
  const int step_floats = kCellOpWidth * h * R;
  float* const part = buf + 2 * step_floats;
  const bool with_dcs = c.k0 >= a.z_tot;

  if (!L2) load_cell_weights(smem, a.wh, a.H, c, tid, nthr);
  load_rows_async<R>(dh, a.dhlast, 0, a.n, a.H, c.k0, h, row0, tid, nthr);
  for (int i = tid; i < h * R; i += nthr) dc[i] = 0.0f;
  if (C > 1)
    for (int i = 4 * h * R + tid; i < C * c.kc * R; i += nthr) dg[i] = 0.0f;
  if (!P)
    load_cell_step<R>(a, a.t - 1,
                      cell_step(buf + ((a.t - 1) & 1) * step_floats, h, R,
                                with_dcs), c, row0, tid, nthr);
  cp_async_wait_all();
  __syncthreads();
  FTT_STAMP(a.clocks, kClockCellChainsBwd, 0, 0);

  for (int s = a.t - 1; s >= 0; --s) {
    const CellStep op = cell_step(buf + (s & 1) * step_floats, h, R,
                                  with_dcs);
    const CellStep prev = cell_step(buf + ((s + 1) & 1) * step_floats, h, R,
                                    with_dcs);
    if (P) {
      if (((a.t - 1 - s) & 1) == 0) {
        load_cell_step<R>(a, s, op, c, row0, tid, nthr);
        if (s > 0) load_cell_step<R>(a, s - 1, prev, c, row0, tid, nthr);
        cp_async_wait_all();
        __syncthreads();
      }
    } else if (s > 0) {
      load_cell_step<R>(a, s - 1, prev, c, row0, tid, nthr);
    }
    cell_gate_bwd<R, C>(op, dh, dc, dg, a.dxp, s, a.n, a.H, c, row0, tid,
                        nthr, rank);
    if (s == 0) break;  // no dh into the zero state before step 0
    __syncthreads();
    FTT_STAMP(a.clocks, kClockCellChainsBwd, a.t - s, 0);
    if (C == 1) {
      cell_dh<R, 1, L2>(w, dg, nullptr, dh, c, lane, warp, nwarp);
    } else {
      float* const mine = part + (s & 1) * pad4(h * R);
      cell_dh<R, C>(w, dg, nullptr, mine, c, lane, warp, nwarp);
      cluster_dh<C, R>(dh, mine, nullptr, h, tid, nthr);
    }
    FTT_STAMP(a.clocks, kClockCellChainsBwd, a.t - s, 1);
    cp_async_wait_all();
    __syncthreads();
    FTT_STAMP(a.clocks, kClockCellChainsBwd, a.t - s, 2);
  }
  // no block leaves while a peer may still read its partials
  if (C > 1) cluster_barrier<C>();
}

// ------------------------------------------------------------ launches

// [chunked][product]
const Kernel kProductKernels[2][4] = {
    {product_kernel<kDu2, false>, product_kernel<kDattended, false>,
     product_kernel<kDu1, false>, product_kernel<kDcstarAdd, false>},
    {product_kernel<kDu2, true>, product_kernel<kDattended, true>,
     product_kernel<kDu1, true>, product_kernel<kDcstarAdd, true>}};

// The chains' kernels for a plan (lstm_common.cuh's chain_kernel).
template <int R, bool P>
Kernel mem_chain_for(int plan) {
  const Kernel k[5] = {
      mem_chain_kernel<R, P, 1, true>, mem_chain_kernel<R, P, 1, false>,
      mem_chain_kernel<R, P, 2, false>, mem_chain_kernel<R, P, 4, false>,
      mem_chain_kernel<R, P, 8, false>};
  return chain_kernel(k, plan);
}

template <int R, bool P>
Kernel lstm_chains_for(int plan) {
  const Kernel k[5] = {
      lstm_chains_kernel<R, P, 1, true>, lstm_chains_kernel<R, P, 1, false>,
      lstm_chains_kernel<R, P, 2, false>, lstm_chains_kernel<R, P, 4, false>,
      lstm_chains_kernel<R, P, 8, false>};
  return chain_kernel(k, plan);
}

// One pass's launch: its kernel, grid, block and shared memory, and the
// cluster its blocks run in (1: none).
struct Pass {
  Kernel kernel;
  dim3 grid;
  int threads;
  size_t bytes;
  int cluster;
};

// The fit gate: the pass's shared memory against the card's, and the
// kernel allowed that much. Records a refusal in `fit` and fails if it
// does not fit.
cudaError_t prepare(const Pass& p, int index, int* fit) {
  if (p.bytes > (size_t)kMaxSmemBytes)
    return refuse(fit, index, p.bytes, p.cluster);
  return allow_smem(reinterpret_cast<const void*>(p.kernel), p.bytes);
}

cudaError_t launch(const Pass& p, const BwdArgs& a, cudaStream_t stream) {
  return launch_clusters(p.kernel, p.grid, p.threads, p.bytes, p.cluster,
                         stream, a);
}

// ------------------------------------------------------------- kernel (b)
//
// The 14 weight and bias gradients as 7 grouped products G = A^T delta
// over the K = t n flat rows (step i, batch row b at k = i n + b), each
// bias the column sum of its weight's delta. A block computes one
// kDwTile x kDwTile tile of one G over a contiguous slice of K; the S
// blocks of a thread-block cluster take the S slices of one tile and add
// their partial tiles in slice order through distributed shared memory.
// Chunks of kDwChunk rows of A, of delta and (for attended columns) of
// att are staged with cp.async, double-buffered; each of the 256 threads
// sums a 4 x 4 micro-tile from float4 reads of the staged chunk.

constexpr int kDwProducts = 7;
constexpr int kDwTile = 64;     // output tile: kDwTile (P) x kDwTile (Q)
constexpr int kDwChunk = 32;    // rows a stage holds
constexpr int kDwThreads = 256;  // 16 x 16 threads, a 4 x 4 tile each
constexpr int kDwMicro = 4;
constexpr int kDwBiasGroups = kDwThreads / kDwTile;  // row groups of a sum
// one stage: A, delta and att chunks, each kDwChunk x kDwTile
constexpr int kDwStageFloats = 3 * kDwChunk * kDwTile;
static_assert(kDwTile / kDwMicro * (kDwTile / kDwMicro) == kDwThreads,
              "one micro-tile a thread");
static_assert(kDwTile * kDwTile + kDwThreads <= 2 * kDwStageFloats,
              "the partial tiles fit the stages");

// A run of an A operand's columns, [previous run's end, end): column p of
// flat row k is ptr[(k - shift) * stride + col + p], zero where k < shift
// (shift = n: the previous step's row, zero before step 0).
struct DwSeg {
  const float* ptr;
  int stride, col, shift, end;
};

struct DwProduct {
  DwSeg seg[3];
  int att_end;  // A's columns below it are multiplied by att (attended)
  int P, Q, tiles_q, d_col;
  float* out;   // (P, Q) row-major
  float* bias;  // (Q)
};

struct DwArgs {
  const float* delta;  // (K, D)
  int delta_width;
  ResEntry att;  // the residual field att
  DwProduct prod[kDwProducts];
  int first_tile[kDwProducts + 1];
  int rows;   // K
  int slice;  // rows a block of a cluster sums: ceil(K / S)
  long long* clocks;
};

// One copy of W floats into shared memory: asynchronous from src, or
// zeros where src is null.
template <int W>
__device__ __forceinline__ void dw_copy(float* dst, const float* src) {
  if (src != nullptr) {
    if (W == 4)
      cp_async16(dst, src);
    else
      cp_async4(dst, src);
  } else if (W == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    *dst = 0.0f;
  }
}

// Stages rows [k, k + kDwChunk) of the tile's A columns, of its delta
// columns and, for its attended columns, of att; rows at or past k1 and
// columns past P or Q as zeros. V: 16-byte copies, four columns at a time
// (every run, offset and row stride a multiple of four floats), else
// 4-byte ones.
template <bool V>
__device__ __forceinline__ void dw_stage(const DwArgs& a,
                                         const DwProduct& pr, float* st,
                                         int k, int k1, int p0, int q0,
                                         bool att, int tid) {
  constexpr int W = V ? 4 : 1;
  constexpr int kPerRow = kDwTile / W;
  float* const As = st;
  float* const Ds = As + kDwChunk * kDwTile;
  float* const Ts = Ds + kDwChunk * kDwTile;
  for (int e = tid; e < kDwChunk * kPerRow; e += kDwThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * W;
    const int row = k + r, p = p0 + c, q = q0 + c, at = r * kDwTile + c;
    const bool in = row < k1;
    const float* src = nullptr;
    if (in && p < pr.P) {
      const DwSeg& s = p < pr.seg[0].end   ? pr.seg[0]
                       : p < pr.seg[1].end ? pr.seg[1]
                                           : pr.seg[2];
      if (row >= s.shift)
        src = s.ptr + (size_t)(row - s.shift) * s.stride + s.col + p;
    }
    dw_copy<W>(As + at, src);
    dw_copy<W>(Ds + at, in && q < pr.Q ? a.delta +
                                             (size_t)row * a.delta_width +
                                             pr.d_col + q
                                       : nullptr);
    if (att && p < pr.att_end)
      dw_copy<W>(Ts + at, in ? res_row(a.att, row) + p : nullptr);
  }
}

// A partial tile of a peer of the cluster (this block's own for S = 1).
template <int S>
__device__ __forceinline__ const float* dw_peer(float* buf, int s) {
  if (S == 1) return buf;
  return cooperative_groups::this_cluster().map_shared_rank(buf, s);
}

// grid.x: the products' tiles in order, S blocks (a cluster) each; the
// rank in the cluster is the block's K slice. __grid_constant__: the
// product table is indexed by block.
template <int S, bool V>
__global__ void __launch_bounds__(kDwThreads)
    mfm_encode_dw_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x / S, rank = cluster_rank<S>();
  int which = 0;
#pragma unroll
  for (int j = 1; j < kDwProducts; ++j)
    if (tile >= a.first_tile[j]) which = j;
  const DwProduct& pr = a.prod[which];
  const int local = tile - a.first_tile[which];
  const int p0 = (local / pr.tiles_q) * kDwTile;
  const int q0 = (local % pr.tiles_q) * kDwTile;
  const int k0 = rank * a.slice, k1 = min(a.rows, k0 + a.slice);
  const int chunks = k1 > k0 ? (k1 - k0 + kDwChunk - 1) / kDwChunk : 0;
  const bool att = p0 < pr.att_end, bias = p0 == 0;
  const int tid = threadIdx.x;
  const int tx = tid % (kDwTile / kDwMicro), ty = tid / (kDwTile / kDwMicro);
  // the bias sums: column tid % kDwTile over every kDwBiasGroups-th row
  const int bc = tid % kDwTile, bg = tid / kDwTile;
  const bool attended = att && p0 + bc < pr.att_end;

  // each chunk summed from zero, then added to the slice's sums: rounding
  // grows with kDwChunk + chunks terms, not with the slice's rows
  float acc[kDwMicro][kDwMicro];
#pragma unroll
  for (int i = 0; i < kDwMicro; ++i)
#pragma unroll
    for (int j = 0; j < kDwMicro; ++j) acc[i][j] = 0.0f;
  float bsum = 0.0f;

  FTT_STAMP(a.clocks, kClockEncodeDw, 0, 0);
  if (chunks > 0) dw_stage<V>(a, pr, smem, k0, k1, p0, q0, att, tid);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    float* const As = smem + (c & 1) * kDwStageFloats;
    float* const Ds = As + kDwChunk * kDwTile;
    const float* const Ts = Ds + kDwChunk * kDwTile;
    // the next chunk in flight while this one is summed
    if (c + 1 < chunks)
      dw_stage<V>(a, pr, smem + ((c + 1) & 1) * kDwStageFloats,
                  k0 + (c + 1) * kDwChunk, k1, p0, q0, att, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    FTT_STAMP(a.clocks, kClockEncodeDw, c + 1, 0);
    if (att) {  // attended = att * cStar, once per staged element
      if (attended)
        for (int e = tid; e < kDwChunk * kDwTile; e += kDwThreads)
          As[e] *= Ts[e];
      __syncthreads();
    }
    if (bias) {
      float part = 0.0f;
      for (int r = bg; r < kDwChunk; r += kDwBiasGroups)
        part += Ds[r * kDwTile + bc];
      bsum += part;
    }
    float part[kDwMicro][kDwMicro];
#pragma unroll
    for (int i = 0; i < kDwMicro; ++i)
#pragma unroll
      for (int j = 0; j < kDwMicro; ++j) part[i][j] = 0.0f;
#pragma unroll 8
    for (int r = 0; r < kDwChunk; ++r) {
      const float4 av = reinterpret_cast<const float4*>(As + r * kDwTile)[ty];
      const float4 dv = reinterpret_cast<const float4*>(Ds + r * kDwTile)[tx];
      const float ar[kDwMicro] = {av.x, av.y, av.z, av.w};
      const float dr[kDwMicro] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < kDwMicro; ++i)
#pragma unroll
        for (int j = 0; j < kDwMicro; ++j)
          part[i][j] = fmaf(ar[i], dr[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kDwMicro; ++i)
#pragma unroll
      for (int j = 0; j < kDwMicro; ++j) acc[i][j] += part[i][j];
    __syncthreads();
    FTT_STAMP(a.clocks, kClockEncodeDw, c + 1, 1);
  }

  // the partial tile and bias sums over the stages, then the cluster's
  // partials added in slice order, each block writing a share of the rows
  float* const red = smem;                        // [kDwTile][kDwTile]
  float* const bred = smem + kDwTile * kDwTile;  // [kDwBiasGroups][kDwTile]
#pragma unroll
  for (int i = 0; i < kDwMicro; ++i)
    reinterpret_cast<float4*>(red + (ty * kDwMicro + i) * kDwTile)[tx] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (bias) bred[tid] = bsum;
  cluster_barrier<S>();
  const float* peers[S];
#pragma unroll
  for (int s = 0; s < S; ++s) peers[s] = dw_peer<S>(red, s);
  constexpr int kShare = kDwTile / S;
  for (int e = tid; e < kShare * kDwTile; e += kDwThreads) {
    const int r = rank * kShare + e / kDwTile, c = e % kDwTile;
    float v = peers[0][r * kDwTile + c];
#pragma unroll
    for (int s = 1; s < S; ++s) v += peers[s][r * kDwTile + c];
    if (p0 + r < pr.P && q0 + c < pr.Q)
      pr.out[(size_t)(p0 + r) * pr.Q + q0 + c] = v;
  }
  if (bias && rank == 0 && tid < kDwTile && q0 + tid < pr.Q) {
    float v = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      for (int g = 0; g < kDwBiasGroups; ++g)
        v += peers[s][kDwTile * kDwTile + g * kDwTile + tid];
    pr.bias[q0 + tid] = v;
  }
  // no block leaves while a peer may still read its shared memory
  if (S > 1) cluster_barrier<S>();
}

using DwKernel = void (*)(DwArgs);

template <bool V>
DwKernel dw_kernel_for(int S) {
  return S == 1   ? mfm_encode_dw_kernel<1, V>
         : S == 2 ? mfm_encode_dw_kernel<2, V>
         : S == 4 ? mfm_encode_dw_kernel<4, V>
                  : mfm_encode_dw_kernel<8, V>;
}

}  // namespace
}  // namespace ftt

// The reverse pass. All arrays float32 and contiguous, shaped as in
// BwdArgs; res_ptrs, res_strides and res_cols (host memory) are the
// residual-layout table's ten pointers, row strides and column offsets
// (mfm_res.cuh), in the _RES_NAMES order. cell_dims (host memory) lists
// the n_cells fused hidden widths, summing to H, z_tot one of their
// boundaries. gates (t, n, 4H), dcstar and datt (t, n, M2) are scratch,
// and att_scratch (t, n, M2) too for the recompute-att variant (else
// unused). variant is 0 (stream), 1 (recompute-att) or 2 (two-step, t
// even); threads a multiple of 32 up to 512, the block size of the gates
// pass, the chains and the softmax. fit (host memory, six ints,
// lstm_common.cuh's Fit) gets the plans the memory chain and the LSTM
// chains ran on (each the smallest cluster whose blocks fit, else
// kWeightsL2), or, when a chain's per-row state alone does not fit a
// block, the refusal before anything is launched.
extern "C" int mfm_encode_bwd(
    const float* xp, const float* allh, const float* allc,
    const float* allmem, void* const* res_ptrs, const int* res_strides,
    const int* res_cols, const float* dhlast, const float* dmemlast,
    const float* wh, const float* a1w1, const float* a1w2,
    const float* a1b2, const float* a2w1, const float* a2w2,
    const float* gw1, const float* g1w2, const float* g2w2, float* dxp,
    float* delta, float* gates, float* dcstar, float* datt,
    float* att_scratch, int t, int n, int H, int z_tot, int mem, int s1,
    int s2, int s3, int s4, int n_cells, const int* cell_dims, int variant,
    int threads, int* fit, void* stream) {
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
  a.gates = gates;
  a.dcstar = dcstar;
  a.clocks = phase_clocks();
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
  a.dl = delta_layout(H, z_tot, mem, s1, s2, s3, s4);
  clear_fit(fit);
  int widths[kResFields];
  res_widths(H, z_tot, mem, s1, s2, s3, s4, widths);
  bool boundary = false;
  if (make_cells(n_cells, cell_dims, H, &a.cells))
    for (int m = 1; m < a.cells.count; ++m)
      boundary = boundary || a.cells.off[m] == z_tot;
  if (!boundary || t < 1 || n < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || res_ptrs == nullptr ||
      !make_res_table(res_ptrs, res_strides, res_cols, widths, &a.res) ||
      variant < kStream || variant > kTwoStep ||
      (variant == kTwoStep && t % 2 != 0) ||
      (variant == kRecomputeAtt && att_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool pairs = variant == kTwoStep;
  const bool recompute = variant == kRecomputeAtt;
  a.datt = datt;
  a.att = a.res.f[kAtt];
  if (recompute) a.att = ResEntry{att_scratch, a.m2, 0};
  const int s34 = s3 + s4, flat = t * n;
  const int tiles_m = (flat + kTile - 1) / kTile;
  // the two chains on the smallest clusters whose blocks fit, else with
  // their weights read from L2
  size_t mem_bytes = 0, cell_bytes = 0;
  auto mem_at = [&](int C) {
    return mem_chain_floats(mem, s34, C, kMemRows, threads) * sizeof(float);
  };
  const int Pm = chain_plan(mem_at, [&] { return mem_at(kWeightsL2); },
                            &mem_bytes);
  if (Pm == kRefused) return (int)refuse(fit, 2, mem_bytes, kWeightsL2);
  auto cells_at = [&](int C) {
    return cell_chain_bytes(a.cells, kCellRows, threads, kCellOpWidth, C);
  };
  const int Pc = chain_plan(cells_at, [&] { return cells_at(kWeightsL2); },
                            &cell_bytes);
  if (Pc == kRefused) return (int)refuse(fit, 4, cell_bytes, kWeightsL2);
  fit[kFitChainA] = Pm;
  fit[kFitChainB] = Pc;
  const int Cm = plan_blocks(Pm), Cc = plan_blocks(Pc);
  // the launches in order, each with its pass (1 to 4)
  Pass p[10];
  int pass_of[10], count = 0;
  auto add = [&](int pass, const Pass& launch) {
    pass_of[count] = pass;
    p[count++] = launch;
  };
  add(1, {gates_kernel<kTileRows>,
          dim3((flat + kTileRows - 1) / kTileRows), threads,
          (size_t)kTileRows * H * sizeof(float), 1});
  add(2, {pairs ? mem_chain_for<kMemRows, true>(Pm)
                : mem_chain_for<kMemRows, false>(Pm),
          dim3(((n + kMemRows - 1) / kMemRows) * Cm), threads, mem_bytes,
          Cm});
  if (recompute)
    add(3, {recompute_att_kernel<kTileRows>,
            dim3((flat + kTileRows - 1) / kTileRows), threads,
            (size_t)kTileRows * (s1 + a.m2) * sizeof(float), 1});
  for (int id = kDu2; id <= kDcstarAdd; ++id) {
    const ProductSpec spec = product_spec(a, id);
    add(3, {kProductKernels[!product_whole(spec)][id],
            dim3(tiles_m * ((spec.N + kTile - 1) / kTile)), kProductThreads,
            product_bytes(spec), 1});
    if (id == kDattended)  // the softmax between dattended and du1
      add(3, {softmax_bwd_kernel, dim3((flat + threads / 32 - 1) /
                                       (threads / 32)), threads, 0, 1});
  }
  add(4, {pairs ? lstm_chains_for<kCellRows, true>(Pc)
                : lstm_chains_for<kCellRows, false>(Pc),
          dim3(((n + kCellRows - 1) / kCellRows) * Cc, a.cells.count),
          threads, cell_bytes, Cc});
  for (int k = 0; k < count; ++k) {
    cudaError_t err = prepare(p[k], pass_of[k], fit);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < count; ++k) {
    cudaError_t err = launch(p[k], a, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Kernel (b). The residuals through the layout table, as for the reverse
// pass; delta the reverse pass's (t, n, D) buffer. out: the 14 gradients
// one after another in the order of the JAX package's _W_NAMES without
// wh (a1w1, a1b1, a1w2, a1b2, a2w1, a2b1, a2w2, a2b2, gw1, gb1, g1w2,
// g1b2, g2w2, g2b2), each (P, Q) row-major. cluster: the blocks S (1, 2,
// 4 or 8) that split K for each output tile. copy (host memory, one int)
// gets the bytes of the staging copies: 16 where every column offset, row
// stride and pointer allows, else 4.
extern "C" int mfm_encode_dw(
    const float* allc, const float* allmem, void* const* res_ptrs,
    const int* res_strides, const int* res_cols, const float* delta,
    float* out, int t, int n, int H, int z_tot, int mem, int s1, int s2,
    int s3, int s4, int cluster, int* copy, void* stream) {
  using namespace ftt;
  int widths[kResFields];
  res_widths(H, z_tot, mem, s1, s2, s3, s4, widths);
  ResTable res;
  const int S = cluster;
  if (t < 1 || n < 1 || z_tot < 0 || z_tot >= H || res_ptrs == nullptr ||
      !(S == 1 || S == 2 || S == 4 || S == 8) ||
      !make_res_table(res_ptrs, res_strides, res_cols, widths, &res))
    return (int)cudaErrorInvalidValue;
  const DeltaLayout l = delta_layout(H, z_tot, mem, s1, s2, s3, s4);
  const int M = H - z_tot, m2 = 2 * M, s34 = s3 + s4;
  DwArgs a;
  a.delta = delta;
  a.delta_width = l.width;
  a.att = res.f[kAtt];
  a.rows = t * n;
  a.slice = (a.rows + S - 1) / S;
  a.clocks = phase_clocks();
  // the A operands' column runs: cStar is the previous step's c past
  // z_tot, then this step's; memp the previous step's memory
  const DwSeg c_prev = {allc, H, z_tot, n, M};
  const DwSeg c_now = {allc, H, z_tot - M, 0, m2};
  const DwSeg memp = {allmem, mem, -m2, n, m2 + mem};
  const DwSeg none = {nullptr, 0, 0, 0, 0};
  auto field = [](const ResEntry& e, int col, int end) {
    return DwSeg{e.ptr, e.stride, e.col + col, 0, end};
  };
  struct Spec {
    DwSeg seg[3];
    int att_end, P, Q, d_col;
  };
  const Spec specs[kDwProducts] = {
      {{c_prev, c_now, none}, 0, m2, s1, l.du1},                // a1w1
      {{field(res.f[kR1], 0, s1), none, none}, 0, s1, m2, l.dlogits},
      {{c_prev, c_now, none}, m2, m2, s2, l.du2},               // a2w1
      {{field(res.f[kR2], 0, s2), none, none}, 0, s2, mem, l.dch},
      {{c_prev, c_now, memp}, m2, m2 + mem, s34, l.du3},        // gw1
      {{field(res.f[kR3], 0, s3), none, none}, 0, s3, mem, l.dq1},
      {{field(res.f[kR3], s3, s4), none, none}, 0, s4, mem, l.dq2},
  };
  size_t at = 0;
  int tiles = 0;
  for (int k = 0; k < kDwProducts; ++k) {
    const Spec& sp = specs[k];
    DwProduct& pr = a.prod[k];
    for (int j = 0; j < 3; ++j) pr.seg[j] = sp.seg[j];
    pr.att_end = sp.att_end;
    pr.P = sp.P;
    pr.Q = sp.Q;
    pr.d_col = sp.d_col;
    pr.tiles_q = (sp.Q + kDwTile - 1) / kDwTile;
    pr.out = out + at;
    at += (size_t)sp.P * sp.Q;
    pr.bias = out + at;
    at += sp.Q;
    a.first_tile[k] = tiles;
    tiles += ((sp.P + kDwTile - 1) / kDwTile) * pr.tiles_q;
  }
  a.first_tile[kDwProducts] = tiles;
  // 16-byte copies where no run, offset or row stride splits four floats
  auto aligned = [](const void* p, int stride, int col) {
    return reinterpret_cast<size_t>(p) % 16 == 0 && stride % 4 == 0 &&
           col % 4 == 0;
  };
  bool v4 = M % 4 == 0 && z_tot % 4 == 0 && mem % 4 == 0 && s1 % 4 == 0 &&
            s2 % 4 == 0 && s3 % 4 == 0 && s4 % 4 == 0 &&
            aligned(allc, H, 0) && aligned(allmem, mem, 0) &&
            aligned(delta, l.width, 0);
  for (int f : {kAtt, kR1, kR2, kR3})
    v4 = v4 && aligned(res.f[f].ptr, res.f[f].stride, res.f[f].col);
  *copy = v4 ? 16 : 4;
  const DwKernel kernel = v4 ? dw_kernel_for<true>(S) : dw_kernel_for<false>(S);
  const size_t bytes = 2 * kDwStageFloats * sizeof(float);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(kernel, dim3(tiles * S), kDwThreads, bytes, S,
                              static_cast<cudaStream_t>(stream), a);
}
