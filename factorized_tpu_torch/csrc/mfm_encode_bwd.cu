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
//     chain reads the weights' rows in place from L2, and where its
//     per-row state passes a block too (13 mem + 3 (s3 + s4) floats a
//     row: mem past about 4,400) it keeps that state in a slice of device
//     memory a block (lstm_common.cuh's kStateScratch).
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
//     memory splits its gate columns over a cluster (cell_bwd.cuh), past
//     a cluster of 8 reads its weights in place from L2, and past a
//     block's per-row state too (more than about 1,320 units) keeps that
//     state in device memory (kStateScratch).
// Where H passes the gates pass's staging (kTileRows H floats: H past
// 14,528) or s1 + M2 the recompute-att pass's, that pass runs one flat
// row a block, reading its operands in place.
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
// KB splits them over a cluster, past a cluster of 8 reads them from L2,
// and past a block's per-row state too keeps that state in device memory,
// planned from the widths before any pass starts: no width is refused. An
// attention product whose staged depth passes a block sums it in chunks.
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
//     attended formed once per staged element. K is cut into S slices
//     (1, 2, 4 or 8, chosen on the host from one lane's tile count, so
//     the same at every lane count), each slice's chunks summed from zero
//     and the slices' partial tiles added in slice order by a
//     thread-block cluster of S blocks, one slice each, through
//     distributed shared memory. No atomics, no global scratch, one
//     launch for any lane count: the same bits on every run and at every
//     lane count. TF32 tensor cores would keep about three digits, too
//     few for the gradient tolerances (3xTF32 is the next step).
//
// Lanes: K problems of one shape (K seeds' or configs' encodes) in one
// launch of each kernel, whatever K: lane 0's arguments and each array's
// floats from one lane's to the next (0 where the lanes share it), lane
// k's blocks those of blockIdx.z = k, which add k strides to each pointer
// (BwdLanes; DwArgs' lane fields). A lane's blocks do the one-lane
// launch's arithmetic, so lane k's bits do not depend on K. The chains'
// batch rows a block are chosen on the host from K and n
// (cuda_mfn.bwd_plan) among the instantiated counts, and each row's sums
// keep their order at every count: a product's split over a block's
// threads follows the columns and the threads, not the rows.

#include <cuda_runtime.h>
#include <math.h>

#include "cell_bwd.cuh"
#include "lstm_common.cuh"
#include "mfm_res.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;
// Flat (step, batch row) rows a block of the gates pass and of att's
// recompute takes, the fastest measured at the training batch
// (perf_probe.py train, PERF.md).
constexpr int kTileRows = 4;
// Batch rows a block of the memory chain and of the LSTM chains takes:
// one of these instantiated counts, chosen on the host (cuda_mfn.bwd_plan,
// which lists the same counts); one lane at the training batch takes the
// first of each, the fastest measured there, and the two-step variant
// takes only those.
constexpr int kMemRowCounts[] = {1, 2, 4, 8, 16};
constexpr int kCellRowCounts[] = {2, 4, 8, 16};
constexpr int kMemRows = kMemRowCounts[0];
constexpr int kCellRows = kCellRowCounts[0];

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
  // kStateScratch: the memory chain's and the LSTM chains' state slices
  float* mem_state;
  size_t mem_slice;
  float* cell_state;
  size_t cell_slice;
  int t, n, H, z_tot, mem, s1, s2, s3, s4, m2;
  Cells cells;
  DeltaLayout dl;
};

// The lane strides of the reverse pass's arrays, in the launcher's
// lane_strides order: xp, allh, allc, allmem, the ten residual fields,
// dhlast, dmemlast, the nine weights, dxp, delta, gates, dcstar, datt and
// att (the residual field's stride, or the recomputed scratch's).
enum BwdLane {
  kLaneXp,
  kLaneAllh,
  kLaneAllc,
  kLaneAllmem,
  kLaneRes,
  kLaneDhlast = kLaneRes + kResFields,
  kLaneDmemlast,
  kLaneWh,
  kLaneA1w1,
  kLaneA1w2,
  kLaneA1b2,
  kLaneA2w1,
  kLaneA2w2,
  kLaneGw1,
  kLaneG1w2,
  kLaneG2w2,
  kLaneDxp,
  kLaneDelta,
  kLaneGates,
  kLaneDcstar,
  kLaneDatt,
  kLaneAtt,
  kBwdLanes
};

// Every kernel's argument: lane 0's arguments and the lane strides.
struct BwdLanes {
  BwdArgs a;
  long long stride[kBwdLanes];
};

using Kernel = void (*)(BwdLanes);

// This block's lane's arguments (blockIdx.z = k): lane 0's with k strides
// added to each pointer. The cell table is read from `la.a.cells`, in
// place: a block indexes it by its cell.
__device__ __forceinline__ BwdArgs lane_args(const BwdLanes& la) {
  BwdArgs a = la.a;
  const long long z = blockIdx.z;
  const long long* s = la.stride;
  a.xp += z * s[kLaneXp];
  a.allh += z * s[kLaneAllh];
  a.allc += z * s[kLaneAllc];
  a.allmem += z * s[kLaneAllmem];
#pragma unroll
  for (int f = 0; f < kResFields; ++f) a.res.f[f].ptr += z * s[kLaneRes + f];
  a.dhlast += z * s[kLaneDhlast];
  a.dmemlast += z * s[kLaneDmemlast];
  a.wh += z * s[kLaneWh];
  a.a1w1 += z * s[kLaneA1w1];
  a.a1w2 += z * s[kLaneA1w2];
  a.a1b2 += z * s[kLaneA1b2];
  a.a2w1 += z * s[kLaneA2w1];
  a.a2w2 += z * s[kLaneA2w2];
  a.gw1 += z * s[kLaneGw1];
  a.g1w2 += z * s[kLaneG1w2];
  a.g2w2 += z * s[kLaneG2w2];
  a.dxp += z * s[kLaneDxp];
  a.delta += z * s[kLaneDelta];
  a.gates += z * s[kLaneGates];
  a.dcstar += z * s[kLaneDcstar];
  a.datt += z * s[kLaneDatt];
  a.att.ptr += z * s[kLaneAtt];
  return a;
}

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
// operations (xp, then the cell's rows of wh in order). G: one flat row
// (R = 1) whose hidden state is read in place from allh, where H passes
// the staging (no row before step 0 has one: xp alone).
template <int R, bool G = false>
__global__ void __launch_bounds__(kMaxThreads)
    gates_kernel(const __grid_constant__ BwdLanes la) {
  const BwdArgs a = lane_args(la);
  static_assert(!G || R == 1, "in place: one row a block");
  extern __shared__ float smem[];
  const int H = a.H, H4 = 4 * H, rows = a.t * a.n, rr0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const float* hp = smem;  // [H][R]
  if (G) {
    hp = rr0 >= a.n ? a.allh + (size_t)(rr0 - a.n) * H : nullptr;
  } else {
    load_flat<R>(smem, a.allh, rows, a.n, H, 0, H, rr0, tid, nthr);
    __syncthreads();
  }
  for (int j = tid; j < H4; j += nthr) {
    int k0, k1;
    cell_range(la.a.cells, j % H, k0, k1);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = rr0 + r < rows ? a.xp[(size_t)(rr0 + r) * H4 + j] : 0.0f;
    for (int k = k0; k < (hp != nullptr ? k1 : k0); ++k) {
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
// asynchronously (S: by plain copies into the state's scratch); zeros
// past n and for memp before step 0.
template <int R, bool S>
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
      copy4<S>(o + i, src);
    else
      o[i] = 0.0f;
  }
}

// Block: rank `rank` of a cluster of C over R batch rows. P: two-step.
// L2: the weights' rows read in place (C = 1); S: with them the state in
// the block's scratch slice (kStateScratch).
template <int R, bool P, int C, bool L2, bool S = false>
__global__ void __launch_bounds__(kMaxThreads)
    mem_chain_kernel(const __grid_constant__ BwdLanes la) {
  const BwdArgs a = lane_args(la);
  static_assert(!S || (L2 && C == 1), "the scratch plan reads from L2");
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
  float* const ops =
      L2 ? state_base<S>(smem, a.mem_state, a.mem_slice) : wm + m.cm * m.pm;
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
  if (!P)
    load_mem_ops<R, S>(a, a.t - 1, ops + ((a.t - 1) & 1) * R * W, row0, tid,
                       nthr);
  cp_async_wait_all();
  __syncthreads();
  FTT_STAMP(a.clocks, kClockMemChainBwd, 0, 0);

  for (int s = a.t - 1; s >= 0; --s) {
    float* const op = ops + (s & 1) * R * W;
    float* const prev = ops + ((s + 1) & 1) * R * W;
    if (P) {
      if (((a.t - 1 - s) & 1) == 0) {
        load_mem_ops<R, S>(a, s, op, row0, tid, nthr);
        if (s > 0) load_mem_ops<R, S>(a, s - 1, prev, row0, tid, nthr);
        cp_async_wait_all();
        __syncthreads();
      }
    } else if (s > 0) {
      load_mem_ops<R, S>(a, s - 1, prev, row0, tid, nthr);
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
// that a.att points at. G: one flat row (R = 1) whose r1 is read in place
// and att computed in place, where s1 + M2 passes the staging.
template <int R, bool G = false>
__global__ void __launch_bounds__(kMaxThreads)
    recompute_att_kernel(const __grid_constant__ BwdLanes la) {
  const BwdArgs a = lane_args(la);
  static_assert(!G || R == 1, "in place: one row a block");
  extern __shared__ float smem[];
  const int rows = a.t * a.n, rr0 = blockIdx.x * R, M2 = a.m2;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const ResEntry& e = a.res.f[kR1];
  if (G) {  // one row: the feature-major [k][1] layout is the row's own
    recompute_att<1>(a, res_row(a.att, rr0), res_row(e, rr0), tid, nthr,
                     tid & 31, tid >> 5, nthr >> 5);
    return;
  }
  float* const r1 = smem;              // [s1][R]
  float* const att = r1 + a.s1 * R;    // [M2][R]
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
    product_kernel(const __grid_constant__ BwdLanes la) {
  const BwdArgs a = lane_args(la);
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
    softmax_bwd_kernel(const __grid_constant__ BwdLanes la) {
  const BwdArgs a = lane_args(la);
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

template <int R, bool S>
__device__ __forceinline__ void load_cell_step(const BwdArgs& a, int s,
                                               const CellStep& op,
                                               const CellTile& c, int row0,
                                               int tid, int nthr) {
  const int H = a.H, M = a.H - a.z_tot;
  for (int q = 0; q < 4; ++q)
    load_rows_async<R, S>(op.g + q * c.h * R, a.gates, s, a.n, 4 * H,
                          q * H + c.k0, c.h, row0, tid, nthr);
  load_rows_async<R, S>(op.c, a.allc, s, a.n, H, c.k0, c.h, row0, tid, nthr);
  load_rows_async<R, S>(op.cp, s > 0 ? a.allc : nullptr, s - 1, a.n, H,
                        c.k0, c.h, row0, tid, nthr);
  if (op.dcs != nullptr) {
    load_rows_async<R, S>(op.dcs, a.dcstar, s, a.n, a.m2, c.k0 - a.z_tot,
                          c.h, row0, tid, nthr);
    load_rows_async<R, S>(op.dcs + c.h * R, a.dcstar, s, a.n, a.m2,
                          M + c.k0 - a.z_tot, c.h, row0, tid, nthr);
  }
}

// blockIdx.y is the cell, blockIdx.x / C the row tile and the rank in
// the cluster of C its share of the cell's gate columns. P: two-step.
// L2: the weights read in place (C = 1); S: with them the state in the
// block's scratch slice (kStateScratch).
template <int R, bool P, int C, bool L2, bool S = false>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_chains_kernel(const __grid_constant__ BwdLanes la) {
  const BwdArgs a = lane_args(la);
  static_assert(!S || (L2 && C == 1), "the scratch plan reads from L2");
  extern __shared__ float smem[];
  const int rank = cluster_rank<C>();
  const CellTile c =
      cell_tile<C, L2>(la.a.cells, blockIdx.y, blockDim.x, rank, a.H);
  const int h = c.h;
  const int row0 = (blockIdx.x / C) * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const float* const w = cell_weights<L2>(smem, a.wh, a.H, c.k0);
  float* const dh = state_base<S>(smem, a.cell_state, a.cell_slice) +
                    (L2 ? 0 : h * c.wp);
  float* const dc = dh + pad4(h * R);
  // 4h columns (dg_at); for a cluster C kc, the columns past 4h zero
  float* const dg = dc + pad4(h * R);
  // two operand buffers; step s uses buffer s & 1. cStar covers the cells
  // past z_tot (a cell boundary). Then, for a cluster, two partial dh
  float* const buf = dg + dg_floats(C == 1 ? 4 * h : C * c.kc, R);
  const int step_floats = kCellOpWidth * h * R;
  float* const part = buf + 2 * step_floats;
  const bool with_dcs = c.k0 >= a.z_tot;

  if (!L2) load_cell_weights(smem, a.wh, a.H, c, tid, nthr);
  load_rows_async<R, S>(dh, a.dhlast, 0, a.n, a.H, c.k0, h, row0, tid,
                        nthr);
  for (int i = tid; i < h * R; i += nthr) dc[i] = 0.0f;
  if (C > 1)
    for (int i = dg_floats(4 * h, R) + tid; i < dg_floats(C * c.kc, R);
         i += nthr)
      dg[i] = 0.0f;
  if (!P)
    load_cell_step<R, S>(a, a.t - 1,
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
        load_cell_step<R, S>(a, s, op, c, row0, tid, nthr);
        if (s > 0) load_cell_step<R, S>(a, s - 1, prev, c, row0, tid, nthr);
        cp_async_wait_all();
        __syncthreads();
      }
    } else if (s > 0) {
      load_cell_step<R, S>(a, s - 1, prev, c, row0, tid, nthr);
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
  const Kernel k[6] = {mem_chain_kernel<R, P, 1, true>,
                       mem_chain_kernel<R, P, 1, false>,
                       mem_chain_kernel<R, P, 2, false>,
                       mem_chain_kernel<R, P, 4, false>,
                       mem_chain_kernel<R, P, 8, false>,
                       mem_chain_kernel<R, P, 1, true, true>};
  return chain_kernel(k, plan);
}

template <int R, bool P>
Kernel lstm_chains_for(int plan) {
  const Kernel k[6] = {lstm_chains_kernel<R, P, 1, true>,
                       lstm_chains_kernel<R, P, 1, false>,
                       lstm_chains_kernel<R, P, 2, false>,
                       lstm_chains_kernel<R, P, 4, false>,
                       lstm_chains_kernel<R, P, 8, false>,
                       lstm_chains_kernel<R, P, 1, true, true>};
  return chain_kernel(k, plan);
}

// The memory chain's kernel at R rows a block and a plan: null for a
// count with no instantiation (kMemRowCounts; the two-step variant,
// `pairs`, kMemRows only).
Kernel mem_chain_rows(int R, bool pairs, int plan) {
  if (pairs) return R == kMemRows ? mem_chain_for<kMemRows, true>(plan)
                                  : nullptr;
  static_assert(sizeof(kMemRowCounts) == 5 * sizeof(int), "the switch");
  switch (R) {
    case kMemRowCounts[0]: return mem_chain_for<kMemRowCounts[0], false>(plan);
    case kMemRowCounts[1]: return mem_chain_for<kMemRowCounts[1], false>(plan);
    case kMemRowCounts[2]: return mem_chain_for<kMemRowCounts[2], false>(plan);
    case kMemRowCounts[3]: return mem_chain_for<kMemRowCounts[3], false>(plan);
    case kMemRowCounts[4]: return mem_chain_for<kMemRowCounts[4], false>(plan);
    default: return nullptr;
  }
}

// The LSTM chains' likewise (kCellRowCounts; two-step: kCellRows).
Kernel lstm_chains_rows(int R, bool pairs, int plan) {
  if (pairs) return R == kCellRows ? lstm_chains_for<kCellRows, true>(plan)
                                   : nullptr;
  static_assert(sizeof(kCellRowCounts) == 4 * sizeof(int), "the switch");
  switch (R) {
    case kCellRowCounts[0]:
      return lstm_chains_for<kCellRowCounts[0], false>(plan);
    case kCellRowCounts[1]:
      return lstm_chains_for<kCellRowCounts[1], false>(plan);
    case kCellRowCounts[2]:
      return lstm_chains_for<kCellRowCounts[2], false>(plan);
    case kCellRowCounts[3]:
      return lstm_chains_for<kCellRowCounts[3], false>(plan);
    default: return nullptr;
  }
}

// One pass's launch: its kernel, grid (z: the lanes), block and shared
// memory, and the cluster its blocks run in (1: none).
struct Pass {
  Kernel kernel;
  dim3 grid;
  int threads;
  size_t bytes;
  int cluster;
};

// The fit gate: the pass's shared memory against the card's, and the
// kernel allowed that much. Records a refusal in `fit` and fails if it
// does not fit. No width reaches the refusal: the chains' bytes fit by
// their plans (none on kStateScratch); the gates and recompute-att passes
// stage a row tile only where it fits, else run in place with none; a
// product is whole where it fits, else staged in term_chunks pieces, each
// fitting by construction (at one float of depth a chunk, 2 kTile
// product_pitch(1) = 256 floats, and the kSplit partial tiles 4,096
// floats: 16 KiB); the softmax takes none.
cudaError_t prepare(const Pass& p, int index, int* fit) {
  if (p.bytes > (size_t)kMaxSmemBytes)
    return refuse(fit, index, p.bytes, p.cluster);
  return allow_smem(reinterpret_cast<const void*>(p.kernel), p.bytes);
}

// ------------------------------------------------------------- kernel (b)
//
// The 14 weight and bias gradients as 7 grouped products G = A^T delta
// over the K = t n flat rows (step i, batch row b at k = i n + b), each
// bias the column sum of its weight's delta. A block computes one
// kDwTile x kDwTile tile of one G. K is cut into S contiguous slices,
// one for each block of a thread-block cluster of S; each slice's chunks
// of kDwChunk rows are summed from zero and added in order, and the
// slices' partial tiles are then added in slice order through
// distributed shared memory. Chunks of A, of delta and (for attended
// columns) of att are staged with cp.async, double-buffered; each of the
// 256 threads sums a 4 x 4 micro-tile from float4 reads of the staged
// chunk.

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
// (shift = n: the previous step's row, zero before step 0); lane k's
// array lies k lane floats on.
struct DwSeg {
  const float* ptr;
  long long lane;
  int stride, col, shift, end;
};

struct DwProduct {
  DwSeg seg[3];
  int att_end;  // A's columns below it are multiplied by att (attended)
  int P, Q, tiles_q, d_col;
  float* out;   // (P, Q) row-major
  float* bias;  // (Q)
};

// The kernel's argument, read in place (__grid_constant__: the product
// table is indexed by block). Lane k's arrays lie k lane strides on:
// delta_lane, att_lane and out_lane (the 14 gradients' buffer), each
// run's own.
struct DwArgs {
  const float* delta;  // (K, D)
  long long delta_lane;
  int delta_width;
  ResEntry att;  // the residual field att
  long long att_lane;
  long long out_lane;
  DwProduct prod[kDwProducts];
  int first_tile[kDwProducts + 1];
  int rows;   // K
  int slice;  // rows a slice: ceil(K / S)
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

// A block's lane's arrays: each A run's, delta's and att's first float,
// k lane strides on (formed once a block).
struct DwLane {
  const float* seg0;
  const float* seg1;
  const float* seg2;
  const float* delta;
  const float* att;
};

// Stages rows [k, k + kDwChunk) capped at k1 of the tile's A columns, of
// its delta columns and, for its attended columns, of att; rows at or
// past k1 and columns past P or Q as zeros. V: 16-byte copies, four
// columns at a time (every run, offset, row stride and lane stride a
// multiple of four floats), else 4-byte ones.
template <bool V>
__device__ __forceinline__ void dw_stage(const DwArgs& a,
                                         const DwProduct& pr,
                                         const DwLane& L, float* st, int k,
                                         int k1, int p0, int q0, bool att,
                                         int tid) {
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
      const bool first = p < pr.seg[0].end, second = p < pr.seg[1].end;
      const DwSeg& g = first ? pr.seg[0] : second ? pr.seg[1] : pr.seg[2];
      const float* base = first ? L.seg0 : second ? L.seg1 : L.seg2;
      if (row >= g.shift)
        src = base + (size_t)(row - g.shift) * g.stride + g.col + p;
    }
    dw_copy<W>(As + at, src);
    dw_copy<W>(Ds + at, in && q < pr.Q ? L.delta +
                                             (size_t)row * a.delta_width +
                                             pr.d_col + q
                                       : nullptr);
    if (att && p < pr.att_end)
      dw_copy<W>(Ts + at, in ? L.att + (size_t)row * a.att.stride +
                                   a.att.col + p
                             : nullptr);
  }
}

// A partial tile of a peer of the cluster (this block's own for S = 1).
template <int S>
__device__ __forceinline__ const float* dw_peer(float* buf, int s) {
  if (S == 1) return buf;
  return cooperative_groups::this_cluster().map_shared_rank(buf, s);
}

// grid.x: the products' tiles in order, S blocks (a cluster) each, the
// rank in the cluster the block's slice; grid.z the lanes. Registers are
// capped for kDwBlocksPerSm blocks an SM (63 registers).
constexpr int kDwBlocksPerSm = 4;

template <int S, bool V>
__global__ void __launch_bounds__(kDwThreads, kDwBlocksPerSm)
    mfm_encode_dw_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x / S, rank = cluster_rank<S>();
  const long long z = blockIdx.z;
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

  const DwLane L = {pr.seg[0].ptr + z * pr.seg[0].lane,
                    pr.seg[1].ptr + z * pr.seg[1].lane,
                    pr.seg[2].ptr + z * pr.seg[2].lane,
                    a.delta + z * a.delta_lane, a.att.ptr + z * a.att_lane};

  // each chunk summed from zero, then added to the slice's sums: rounding
  // grows with kDwChunk + chunks terms, not with the slice's rows
  float acc[kDwMicro][kDwMicro];
#pragma unroll
  for (int i = 0; i < kDwMicro; ++i)
#pragma unroll
    for (int j = 0; j < kDwMicro; ++j) acc[i][j] = 0.0f;
  float bsum = 0.0f;

  FTT_STAMP(a.clocks, kClockEncodeDw, 0, 0);
  if (chunks > 0) dw_stage<V>(a, pr, L, smem, k0, k1, p0, q0, att, tid);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    float* const As = smem + (c & 1) * kDwStageFloats;
    float* const Ds = As + kDwChunk * kDwTile;
    const float* const Ts = Ds + kDwChunk * kDwTile;
    // the next chunk in flight while this one is summed
    if (c + 1 < chunks)
      dw_stage<V>(a, pr, L, smem + ((c + 1) & 1) * kDwStageFloats,
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
      pr.out[z * a.out_lane + (size_t)(p0 + r) * pr.Q + q0 + c] = v;
  }
  if (bias && rank == 0 && tid < kDwTile && q0 + tid < pr.Q) {
    float v = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      for (int g = 0; g < kDwBiasGroups; ++g)
        v += peers[s][kDwTile * kDwTile + g * kDwTile + tid];
    pr.bias[z * a.out_lane + q0 + tid] = v;
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
// boundaries (0 where no encoder cell precedes the MFN's). gates (t, n,
// 4H), dcstar and datt (t, n, M2) are scratch,
// and att_scratch (t, n, M2) too for the recompute-att variant (else
// unused). state (state_floats floats of device memory, or null) is the
// scratch of the chains on kStateScratch; state_need (host memory, one
// value) gets the floats they take, and the launcher returns kNeedScratch
// (-1) without launching while state_floats is short of it. variant is 0
// (stream), 1 (recompute-att) or 2 (two-step, t even); threads a multiple
// of 32 up to 512, the block size of the gates pass, the chains and the
// softmax. mem_rows and cell_rows: the batch rows a block of the memory
// chain and of the LSTM chains takes, one of kMemRowCounts and of
// kCellRowCounts (the two-step variant: kMemRows and kCellRows); another
// count is refused. fit (host memory, six ints, lstm_common.cuh's Fit)
// gets the plans the memory chain and the LSTM chains ran on (each the
// smallest cluster whose blocks fit, else kWeightsL2, else
// kStateScratch). Every array is lane 0's of `lanes`, each pass one
// launch for them all: lane k's lies lane_strides[i] k floats on (host
// memory, 31 strides: xp, allh, allc, allmem, the ten residual pointers,
// dhlast, dmemlast, the nine weights, dxp, delta, gates, dcstar, datt and
// att_scratch; 0 where the lanes share the array).
extern "C" int mfm_encode_bwd(
    const float* xp, const float* allh, const float* allc,
    const float* allmem, void* const* res_ptrs, const int* res_strides,
    const int* res_cols, const float* dhlast, const float* dmemlast,
    const float* wh, const float* a1w1, const float* a1w2,
    const float* a1b2, const float* a2w1, const float* a2w2,
    const float* gw1, const float* g1w2, const float* g2w2, float* dxp,
    float* delta, float* gates, float* dcstar, float* datt,
    float* att_scratch, float* state, long long state_floats,
    long long* state_need, int t, int n, int H, int z_tot, int mem, int s1,
    int s2, int s3, int s4, int n_cells, const int* cell_dims, int variant,
    int threads, int mem_rows, int cell_rows, int lanes,
    const long long* lane_strides, int* fit, void* stream) {
  using namespace ftt;
  const Scratch chains = {state, state_floats, state_need};
  const long long* ls = lane_strides;
  clear_fit(fit);
  int widths[kResFields];
  res_widths(H, z_tot, mem, s1, s2, s3, s4, widths);
  const bool recompute = variant == kRecomputeAtt;
  const bool pairs = variant == kTwoStep;
  if (lanes < 1 || lanes > 65535 || ls == nullptr || res_ptrs == nullptr ||
      state_need == nullptr)
    return (int)cudaErrorInvalidValue;
  // lane 0's arguments and the lanes' strides
  BwdLanes la;
  BwdArgs& a = la.a;
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
  a.datt = datt;
  a.clocks = phase_clocks();
  a.mem_state = a.cell_state = nullptr;
  a.mem_slice = a.cell_slice = 0;
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
  for (int i = 0; i < kLaneAtt; ++i) la.stride[i] = ls[i];
  la.stride[kLaneAtt] = recompute ? ls[kLaneAtt] : ls[kLaneRes + kAtt];
  bool boundary = false;
  if (make_cells(n_cells, cell_dims, H, &a.cells) &&
      make_res_table(res_ptrs, res_strides, res_cols, widths, &a.res))
    for (int m = 0; m < a.cells.count; ++m)
      boundary = boundary || a.cells.off[m] == z_tot;
  a.att = recompute ? ResEntry{att_scratch, a.m2, 0} : a.res.f[kAtt];
  if (!boundary || t < 1 || n < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      variant < kStream || variant > kTwoStep || (pairs && t % 2 != 0) ||
      (recompute && att_scratch == nullptr) ||
      mem_chain_rows(mem_rows, pairs, 1) == nullptr ||
      lstm_chains_rows(cell_rows, pairs, 1) == nullptr)
    return (int)cudaErrorInvalidValue;
  *state_need = 0;
  const int s34 = s3 + s4, flat = t * n;
  const int tiles_m = (flat + kTile - 1) / kTile;
  // the two chains on the smallest clusters whose blocks fit, else with
  // their weights read from L2, else with them their state in the scratch
  size_t mem_bytes = 0, cell_bytes = 0;
  auto mem_at = [&](int C) {
    return mem_chain_floats(mem, s34, C, mem_rows, threads) * sizeof(float);
  };
  const int Pm = chain_plan(mem_at, [&] { return mem_at(kWeightsL2); },
                            &mem_bytes);
  auto cells_at = [&](int C) {
    return cell_chain_bytes(a.cells, cell_rows, threads, kCellOpWidth, C);
  };
  const int Pc = chain_plan(cells_at, [&] { return cells_at(kWeightsL2); },
                            &cell_bytes);
  fit[kFitChainA] = Pm;
  fit[kFitChainB] = Pc;
  const int Cm = plan_blocks(Pm), Cc = plan_blocks(Pc);
  const dim3 mem_grid(((n + mem_rows - 1) / mem_rows) * Cm, 1, lanes);
  const dim3 cell_grid(((n + cell_rows - 1) / cell_rows) * Cc,
                       a.cells.count, lanes);
  if (Pm == kStateScratch)
    a.mem_state = reserve(chains, (long long)mem_grid.x * lanes, mem_bytes,
                          &a.mem_slice);
  if (Pc == kStateScratch)
    a.cell_state =
        reserve(chains, (long long)cell_grid.x * cell_grid.y * lanes,
                cell_bytes, &a.cell_slice);
  if ((Pm == kStateScratch && a.mem_state == nullptr) ||
      (Pc == kStateScratch && a.cell_state == nullptr))
    return kNeedScratch;
  // the gates and recompute-att passes stage a row tile where it fits,
  // else run one row a block in place
  const size_t gates_bytes = (size_t)kTileRows * H * sizeof(float);
  const size_t att_bytes = (size_t)kTileRows * (s1 + a.m2) * sizeof(float);
  const bool gates_staged = gates_bytes <= (size_t)kMaxSmemBytes;
  const bool att_staged = att_bytes <= (size_t)kMaxSmemBytes;
  const unsigned rows_tiles = (flat + kTileRows - 1) / kTileRows;
  // the launches in order, each with its pass (1 to 4)
  Pass p[10];
  int pass_of[10], count = 0;
  auto add = [&](int pass, const Pass& launch) {
    pass_of[count] = pass;
    p[count++] = launch;
  };
  if (gates_staged)
    add(1, {gates_kernel<kTileRows>, dim3(rows_tiles, 1, lanes), threads,
            gates_bytes, 1});
  else
    add(1, {gates_kernel<1, true>, dim3(flat, 1, lanes), threads, 0, 1});
  add(2, {mem_chain_rows(mem_rows, pairs, Pm), mem_grid, threads,
          plan_smem(Pm, mem_bytes), Cm});
  if (recompute && att_staged)
    add(3, {recompute_att_kernel<kTileRows>, dim3(rows_tiles, 1, lanes),
            threads, att_bytes, 1});
  else if (recompute)
    add(3, {recompute_att_kernel<1, true>, dim3(flat, 1, lanes), threads, 0,
            1});
  for (int id = kDu2; id <= kDcstarAdd; ++id) {
    const ProductSpec spec = product_spec(a, id);
    add(3, {kProductKernels[!product_whole(spec)][id],
            dim3(tiles_m * ((spec.N + kTile - 1) / kTile), 1, lanes),
            kProductThreads, product_bytes(spec), 1});
    if (id == kDattended)  // the softmax between dattended and du1
      add(3, {softmax_bwd_kernel,
              dim3((flat + threads / 32 - 1) / (threads / 32), 1, lanes),
              threads, 0, 1});
  }
  add(4, {lstm_chains_rows(cell_rows, pairs, Pc), cell_grid, threads,
          plan_smem(Pc, cell_bytes), Cc});
  for (int k = 0; k < count; ++k) {
    cudaError_t err = prepare(p[k], pass_of[k], fit);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < count; ++k) {
    cudaError_t err = launch_clusters(p[k].kernel, p[k].grid, p[k].threads,
                                      p[k].bytes, p[k].cluster, st, la);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The blocks of the reverse pass's memory chain (chain 0) or LSTM chains
// (chain 1) at `rows` rows a block on chain plan `plan` (a cluster of 1,
// 2, 4 or 8, kWeightsL2 or kStateScratch), `threads` threads and `smem`
// bytes of dynamic shared memory, that the current card holds at once
// (*wave): its SMs times the blocks the occupancy calculator gives an SM
// for that instantiation, its registers counted. The lane plan's waves
// (cuda_mfn.bwd_plan). Refuses a count or plan with no instantiation.
extern "C" int mfm_encode_bwd_wave(int chain, int rows, int plan,
                                   int threads, long long smem, int* wave) {
  using namespace ftt;
  if (wave == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || smem < 0 || smem > kMaxSmemBytes ||
      !known_plan(plan))
    return (int)cudaErrorInvalidValue;
  const Kernel k = chain == 0   ? mem_chain_rows(rows, false, plan)
                   : chain == 1 ? lstm_chains_rows(rows, false, plan)
                                : nullptr;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)blocks_at_once(reinterpret_cast<const void*>(k), threads,
                             (size_t)smem, wave);
}

// Kernel (b). The residuals through the layout table, as for the reverse
// pass; delta the reverse pass's (t, n, D) buffer. out: the 14 gradients
// one after another in the order of the JAX package's _W_NAMES without
// wh (a1w1, a1b1, a1w2, a1b2, a2w1, a2b1, a2w2, a2b2, gw1, gb1, g1w2,
// g1b2, g2w2, g2b2), each (P, Q) row-major. cluster: the blocks S (1, 2,
// 4 or 8, else refused) of the thread-block cluster that splits each
// tile's K, one slice each, their partial tiles added in slice order.
// copy (host memory, one int) gets the bytes of the staging copies: 16
// where every column offset, row stride, pointer and lane stride allows,
// else 4. Every array is lane 0's of `lanes`, in one launch: lane k's
// lies lane_strides[i] k floats on (host memory, 14 strides: allc,
// allmem, the ten residual pointers, delta and out).
extern "C" int mfm_encode_dw(
    const float* allc, const float* allmem, void* const* res_ptrs,
    const int* res_strides, const int* res_cols, const float* delta,
    float* out, int t, int n, int H, int z_tot, int mem, int s1, int s2,
    int s3, int s4, int cluster, int lanes, const long long* lane_strides,
    int* copy, void* stream) {
  using namespace ftt;
  int widths[kResFields];
  res_widths(H, z_tot, mem, s1, s2, s3, s4, widths);
  const int S = cluster;
  const long long* ls = lane_strides;
  if (t < 1 || n < 1 || z_tot < 0 || z_tot >= H || res_ptrs == nullptr ||
      lanes < 1 || lanes > 65535 || ls == nullptr ||
      !(S == 1 || S == 2 || S == 4 || S == 8))
    return (int)cudaErrorInvalidValue;
  ResTable res;
  if (!make_res_table(res_ptrs, res_strides, res_cols, widths, &res))
    return (int)cudaErrorInvalidValue;
  const DeltaLayout l = delta_layout(H, z_tot, mem, s1, s2, s3, s4);
  const int M = H - z_tot, m2 = 2 * M, s34 = s3 + s4;
  const long long lc = ls[0], lm = ls[1], ld = ls[12], lo = ls[13];
  DwArgs a;
  a.delta = delta;
  a.delta_lane = ld;
  a.delta_width = l.width;
  a.att = res.f[kAtt];
  a.att_lane = ls[2 + kAtt];
  a.out_lane = lo;
  a.rows = t * n;
  a.slice = (a.rows + S - 1) / S;
  a.clocks = phase_clocks();
  // the A operands' column runs: cStar is the previous step's c past
  // z_tot, then this step's; memp the previous step's memory
  const DwSeg c_prev = {allc, lc, H, z_tot, n, M};
  const DwSeg c_now = {allc, lc, H, z_tot - M, 0, m2};
  const DwSeg memp = {allmem, lm, mem, -m2, n, m2 + mem};
  const DwSeg none = {nullptr, 0, 0, 0, 0, 0};
  auto field = [&](int f, int col, int end) {
    const ResEntry& e = res.f[f];
    return DwSeg{e.ptr, ls[2 + f], e.stride, e.col + col, 0, end};
  };
  struct Spec {
    DwSeg seg[3];
    int att_end, P, Q, d_col;
  };
  const Spec specs[kDwProducts] = {
      {{c_prev, c_now, none}, 0, m2, s1, l.du1},                // a1w1
      {{field(kR1, 0, s1), none, none}, 0, s1, m2, l.dlogits},  // a1w2
      {{c_prev, c_now, none}, m2, m2, s2, l.du2},               // a2w1
      {{field(kR2, 0, s2), none, none}, 0, s2, mem, l.dch},     // a2w2
      {{c_prev, c_now, memp}, m2, m2 + mem, s34, l.du3},        // gw1
      {{field(kR3, 0, s3), none, none}, 0, s3, mem, l.dq1},     // g1w2
      {{field(kR3, s3, s4), none, none}, 0, s4, mem, l.dq2},    // g2w2
  };
  size_t at = 0;
  int tiles = 0;
  for (int q = 0; q < kDwProducts; ++q) {
    const Spec& sp = specs[q];
    DwProduct& pr = a.prod[q];
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
    a.first_tile[q] = tiles;
    tiles += ((sp.P + kDwTile - 1) / kDwTile) * pr.tiles_q;
  }
  a.first_tile[kDwProducts] = tiles;
  // 16-byte copies where no run, offset, row stride or lane stride splits
  // four floats
  auto aligned = [&](const void* p, int stride, int col, long long lane) {
    return reinterpret_cast<size_t>(p) % 16 == 0 && stride % 4 == 0 &&
           col % 4 == 0 && (lanes == 1 || lane % 4 == 0);
  };
  bool v4 = M % 4 == 0 && z_tot % 4 == 0 && mem % 4 == 0 && s1 % 4 == 0 &&
            s2 % 4 == 0 && s3 % 4 == 0 && s4 % 4 == 0 &&
            aligned(allc, H, 0, lc) && aligned(allmem, mem, 0, lm) &&
            aligned(delta, l.width, 0, ld);
  for (int f : {kAtt, kR1, kR2, kR3})
    v4 = v4 && aligned(res.f[f].ptr, res.f[f].stride, res.f[f].col,
                       ls[2 + f]);
  *copy = v4 ? 16 : 4;
  const DwKernel kernel = v4 ? dw_kernel_for<true>(S) : dw_kernel_for<false>(S);
  const size_t bytes = 2 * kDwStageFloats * sizeof(float);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(kernel, dim3(tiles * S, 1, lanes), kDwThreads,
                              bytes, S, static_cast<cudaStream_t>(stream),
                              a);
}
