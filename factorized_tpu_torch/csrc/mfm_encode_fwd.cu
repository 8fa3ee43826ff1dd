// Fused MFM encode, forward, eval and train.
//
// Replaces: factorized_tpu/ops/pallas_mfn.py::_fwd_kernel (reached through
// _fwd_call, mfm_encode_pallas and its custom_vjp forward _encode_fwd):
// the eval variant (train=False, with_res=False) and the train variants
// (dropout masks; with_res, the residuals the backward reads). With the
// residuals split into ten tensors it also replaces
// scripts/bwd_residual_probe.py::_fwd_res_kernel; with one buffer it is the
// same function and design as that script's _fwd_cat_kernel (one launch
// looping over time).
//
// What it computes, for each of the t steps of a (t, n, 4H) gate-major
// input projection xp: the six fused LSTM cells [enc_l, enc_a, enc_v,
// mfn_l, mfn_a, mfn_v] (gates = xp_t + h @ wh, wh block-diagonal and
// gate-major); cStar = [c_prev, c_new][:, z_tot:]; the att1 relu-MLP with a
// softmax over cStar; attended = att * cStar; the att2 tanh proposal chat;
// the merged gamma fc1 on [attended, mem] with two sigmoid heads; and
// mem = g1 * mem + g2 * chat. It returns h_last (n, H) and mem_last (n, mem).
// In train mode the relu outputs of the att1, att2 and gamma fc1s are
// multiplied by the scaled keep-masks (t, n, s1 + s2 + s3 + s4), and with
// residuals it also writes allh, allc (t, n, H), allmem (t, n, mem) and the
// ten fields of the JAX package's _RES_NAMES: att, r1, kg1, r2, kg2, r3,
// kg3, chat, g1, g2, with r* the post-dropout activations and kg* = mask *
// (u > 0). It writes them through a residual-layout table (mfm_res.cuh):
// one (t, n, R) buffer, as the training path keeps them, or ten
// (t, n, width) tensors.
//
// What bounds it on an H100: operations. At the serving batch (n = 256,
// t = 20, best_acc_mosi_config) the useful work is 3.9 GFLOP in float32
// (the per-cell recurrent products plus the attention and gate products)
// against about 29 MB of traffic, most of it xp; at 67 TFLOP/s of float32
// outside the tensor cores that is about 59 us. In practice the bound is
// the serial chain: every step is seven dependent small products, and
// only n / ROWS blocks have work. At the training batch (n = 32) the
// residuals add t * n * (2H + mem + R) floats of writes, 5.9 MB, under
// 2 us of bandwidth; the bound stays the operations (0.49 GFLOP, about
// 7 us) and the practice the serial chain, now over 32 / ROWS blocks.
//
// What the design does about it: one block owns ROWS batch rows and loops
// over the t steps itself (blocks run in no order, so the TPU kernel's
// sequential grid over time becomes this loop). The h/c carries, mem and
// every step intermediate stay in shared memory, stored feature-major
// ([feature][row]) so each thread computes one output column for all its
// rows from one weight load. Weights (2.8 MB) are read from global memory
// and stay in L2; none of them fits one block's shared memory. The
// recurrent product reads only the diagonal blocks of wh. Nothing else yet:
// no tensor cores, TMA or clusters.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_common.cuh"
#include "mfm_res.cuh"

namespace ftt {
namespace {

constexpr int kMaxThreads = 512;

struct EncodeArgs {
  const float* xp;     // (t, n, 4H)
  const float* masks;  // (t, n, S) or null: every site the identity
  const float* wh;  // (H, 4H)
  const float* a1w1;
  const float* a1b1;
  const float* a1w2;
  const float* a1b2;
  const float* a2w1;
  const float* a2b1;
  const float* a2w2;
  const float* a2b2;
  const float* gw1;
  const float* gb1;
  const float* g1w2;
  const float* g1b2;
  const float* g2w2;
  const float* g2b2;
  float* h_last;    // (n, H)
  float* mem_last;  // (n, mem)
  float* allh;      // (t, n, H), or null when no residuals are written
  float* allc;      // (t, n, H)
  float* allmem;    // (t, n, mem)
  ResTable res;     // the ten residual fields (every entry null without)
  int t, n, H, z_tot, mem, s1, s2, s3, s4;
  Cells cells;
};

enum Act { kIdentity, kTanh };

// Where the residuals go, a template argument: nowhere (the eval variant
// carries none of their code), one buffer shared by the ten fields, or ten
// tensors.
enum ResKind { kNoRes, kOneBuffer, kTenTensors };

// Column 0 of field f in row `at` (= s * n + b). In one buffer every field
// shares the pointer and row stride of field 0 (att, at column 0), so the
// row's address is the same for all fields and only the offsets differ.
template <int K>
__device__ __forceinline__ float* field_row(const ResTable& t, int f,
                                            size_t at) {
  const ResEntry& e = t.f[K == kOneBuffer ? 0 : f];
  return e.ptr + at * e.stride + t.f[f].col;
}

// acc[r] += sum_k A[k][r] * W[k][j], with A the feature-major stack of a0
// (k0 features) over a1 (k1 features) and W row-major with ldw columns.
template <int R>
__device__ __forceinline__ void dot_col(const float* a0, int k0,
                                        const float* a1, int k1,
                                        const float* __restrict__ w, int ldw,
                                        int j, float (&acc)[R]) {
  const float* wj = w + j;
  for (int k = 0; k < k0; ++k) {
    const float wv = __ldg(wj + (size_t)k * ldw);
    const float* a = a0 + k * R;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(a[r], wv, acc[r]);
  }
  wj += (size_t)k0 * ldw;
  for (int k = 0; k < k1; ++k) {
    const float wv = __ldg(wj + (size_t)k * ldw);
    const float* a = a1 + k * R;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(a[r], wv, acc[r]);
  }
}

template <int R>
__device__ __forceinline__ void fill(float (&acc)[R], float v) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = v;
}

template <int R>
__device__ __forceinline__ void store_col(float* out, int j,
                                          const float (&acc)[R], Act act) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v = acc[r];
    if (act == kTanh) v = tanhf(v);
    out[j * R + r] = v;
  }
}

// The relu of a dropout site: out[j] = relu(u) * m for each of the R rows,
// m the row's mask at column mask_col (1 without masks); with residuals
// (K != kNoRes) also column j of field r_field = that and of kg_field =
// m * (u > 0).
template <int R, int K>
__device__ __forceinline__ void store_site(float* out, int j,
                                           const float (&acc)[R],
                                           const EncodeArgs& a, int s,
                                           int row0, int mask_col,
                                           int r_field, int kg_field) {
  const int S = a.s1 + a.s2 + a.s3 + a.s4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const size_t at = (size_t)s * a.n + row;
    const float u = acc[r];
    float m = 1.0f;
    if (a.masks != nullptr && row < a.n) m = a.masks[at * S + mask_col + j];
    const float v = fmaxf(u, 0.0f) * m;
    out[j * R + r] = v;
    if (K != kNoRes && row < a.n) {
      field_row<K>(a.res, r_field, at)[j] = v;
      field_row<K>(a.res, kg_field, at)[j] = u > 0.0f ? m : 0.0f;
    }
  }
}

template <int R, int K>
__global__ void __launch_bounds__(kMaxThreads)
    mfm_encode_fwd_kernel(const EncodeArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, H4 = 4 * H;
  const int M = H - a.z_tot, M2 = 2 * M;
  const int s34 = a.s3 + a.s4;
  // feature-major [feature][R] buffers: h and c twice (this step's and
  // the last), then mem and the step intermediates
  float* const hc = smem;
  float* mem = smem + 4 * H * R;
  float* att = mem + a.mem * R;    // logits -> attention -> attended
  float* r1 = att + M2 * R;
  float* r2 = r1 + a.s1 * R;
  float* r3 = r2 + a.s2 * R;
  float* heads = r3 + s34 * R;     // chat | g1 logits | g2 logits
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

  for (int i = tid; i < (4 * H + a.mem) * R; i += nthr) smem[i] = 0.0f;
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < a.t; ++s) {
    const float* xp_s = a.xp + (size_t)s * a.n * H4;
    const float* h_old = hc + cur * H * R;
    float* h_new = hc + (cur ^ 1) * H * R;
    const float* c_old = hc + (2 + cur) * H * R;
    float* c_new = hc + (2 + (cur ^ 1)) * H * R;

    // (1) the six LSTM cells: each thread owns hidden unit j, all 4 gates
    for (int j = tid; j < H; j += nthr) {
      int k0, k1;
      cell_range(a.cells, j, k0, k1);
      float gi[R], gf[R], gg[R], go[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        if (row < a.n) {
          const float* x = xp_s + (size_t)row * H4 + j;
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
        const float c = sigmoid(gf[r]) * c_old[j * R + r] +
                        sigmoid(gi[r]) * tanhf(gg[r]);
        const float h = sigmoid(go[r]) * tanhf(c);
        c_new[j * R + r] = c;
        h_new[j * R + r] = h;
        const int row = row0 + r;
        if (K != kNoRes && row < a.n) {
          const size_t at = ((size_t)s * a.n + row) * H + j;
          a.allh[at] = h;
          a.allc[at] = c;
        }
      }
    }
    __syncthreads();

    // (2) att1 fc1 on cStar = [c_prev, c_new][:, z_tot:]
    const float* cs_prev = c_old + a.z_tot * R;
    const float* cs_new = c_new + a.z_tot * R;
    for (int j = tid; j < a.s1; j += nthr) {
      float acc[R];
      fill(acc, __ldg(a.a1b1 + j));
      dot_col<R>(cs_prev, M, cs_new, M, a.a1w1, a.s1, j, acc);
      store_site<R, K>(r1, j, acc, a, s, row0, 0, kR1, kKg1);
    }
    __syncthreads();

    // (3) att1 fc2 -> attention logits
    for (int j = tid; j < M2; j += nthr) {
      float acc[R];
      fill(acc, __ldg(a.a1b2 + j));
      dot_col<R>(r1, a.s1, nullptr, 0, a.a1w2, M2, j, acc);
      store_col<R>(att, j, acc, kIdentity);
    }
    __syncthreads();

    // (4) softmax over each row's logits, max subtracted first, then
    //     attended = att * cStar; one warp per row
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
      const int row = row0 + r;
      float* res = (K != kNoRes && row < a.n)
                       ? field_row<K>(a.res, kAtt, (size_t)s * a.n + row)
                       : nullptr;
      for (int k = lane; k < M2; k += 32) {
        const float cs = k < M ? cs_prev[k * R + r] : cs_new[(k - M) * R + r];
        const float p = att[k * R + r] / sum;
        if (res != nullptr) res[k] = p;
        att[k * R + r] = p * cs;
      }
    }
    __syncthreads();

    // (5) att2 fc1 on attended, and the merged gamma fc1 on [attended, mem]
    for (int j = tid; j < a.s2 + s34; j += nthr) {
      float acc[R];
      if (j < a.s2) {
        fill(acc, __ldg(a.a2b1 + j));
        dot_col<R>(att, M2, nullptr, 0, a.a2w1, a.s2, j, acc);
        store_site<R, K>(r2, j, acc, a, s, row0, a.s1, kR2, kKg2);
      } else {
        const int jj = j - a.s2;
        fill(acc, __ldg(a.gb1 + jj));
        dot_col<R>(att, M2, mem, a.mem, a.gw1, s34, jj, acc);
        store_site<R, K>(r3, jj, acc, a, s, row0, a.s1 + a.s2, kR3, kKg3);
      }
    }
    __syncthreads();

    // (6) heads: chat = tanh(r2 @ a2w2 + b); the gamma logits from r3's
    //     two halves
    for (int j = tid; j < 3 * a.mem; j += nthr) {
      const int which = j / a.mem, jj = j - which * a.mem;
      float acc[R];
      if (which == 0) {
        fill(acc, __ldg(a.a2b2 + jj));
        dot_col<R>(r2, a.s2, nullptr, 0, a.a2w2, a.mem, jj, acc);
        store_col<R>(heads, j, acc, kTanh);
      } else if (which == 1) {
        fill(acc, __ldg(a.g1b2 + jj));
        dot_col<R>(r3, a.s3, nullptr, 0, a.g1w2, a.mem, jj, acc);
        store_col<R>(heads, j, acc, kIdentity);
      } else {
        fill(acc, __ldg(a.g2b2 + jj));
        dot_col<R>(r3 + a.s3 * R, a.s4, nullptr, 0, a.g2w2, a.mem, jj, acc);
        store_col<R>(heads, j, acc, kIdentity);
      }
    }
    __syncthreads();

    // (7) mem = sigmoid(g1 logits) * mem + sigmoid(g2 logits) * chat
    for (int i = tid; i < a.mem * R; i += nthr) {
      const float chat = heads[i];
      const float g1 = sigmoid(heads[a.mem * R + i]);
      const float g2 = sigmoid(heads[2 * a.mem * R + i]);
      const float m = g1 * mem[i] + g2 * chat;
      mem[i] = m;
      const int j = i / R, row = row0 + (i - j * R);
      if (K != kNoRes && row < a.n) {
        const size_t at = (size_t)s * a.n + row;
        field_row<K>(a.res, kChat, at)[j] = chat;
        field_row<K>(a.res, kG1, at)[j] = g1;
        field_row<K>(a.res, kG2, at)[j] = g2;
        a.allmem[at * a.mem + j] = m;
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* h_fin = hc + cur * H * R;
  for (int i = tid; i < R * H; i += nthr) {
    const int r = i / H, j = i - r * H, row = row0 + r;
    if (row < a.n) a.h_last[(size_t)row * H + j] = h_fin[j * R + r];
  }
  for (int i = tid; i < R * a.mem; i += nthr) {
    const int r = i / a.mem, j = i - r * a.mem, row = row0 + r;
    if (row < a.n) a.mem_last[(size_t)row * a.mem + j] = mem[j * R + r];
  }
}

template <int R, int K>
cudaError_t launch(const EncodeArgs& a, int threads, cudaStream_t stream) {
  const int M2 = 2 * (a.H - a.z_tot);
  const size_t floats = (size_t)R * (4 * a.H + a.mem + M2 + a.s1 + a.s2 +
                                     a.s3 + a.s4 + 3 * a.mem);
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mfm_encode_fwd_kernel<R, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + R - 1) / R);
  mfm_encode_fwd_kernel<R, K><<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The residuals' kind, read off the table: one buffer when every field
// has field 0's pointer and row stride.
template <int R>
cudaError_t launch_rows(const EncodeArgs& a, int threads,
                        cudaStream_t stream) {
  if (a.allh == nullptr) return launch<R, kNoRes>(a, threads, stream);
  bool one = a.res.f[0].col == 0;
  for (int k = 1; k < kResFields; ++k)
    one = one && a.res.f[k].ptr == a.res.f[0].ptr &&
          a.res.f[k].stride == a.res.f[0].stride;
  return one ? launch<R, kOneBuffer>(a, threads, stream)
             : launch<R, kTenTensors>(a, threads, stream);
}

}  // namespace
}  // namespace ftt

// Biases are (1, d) or (d,), all arrays float32 and contiguous. masks is
// (t, n, s1 + s2 + s3 + s4) or null (eval). allh, allc, allmem and
// res_ptrs are all given (residuals written) or all null; res_ptrs,
// res_strides and res_cols (host memory) are the residual-layout table's
// ten pointers, row strides and column offsets (mfm_res.cuh), in the
// _RES_NAMES order. cell_dims (host memory) lists
// the n_cells fused hidden widths, summing to H; the first cells up to
// z_tot are the encoders. rows is the batch rows per block (1, 2, 4, 8 or
// 16), threads a multiple of 32 up to 512.
extern "C" int mfm_encode_fwd(
    const float* xp, const float* masks, const float* wh, const float* a1w1,
    const float* a1b1, const float* a1w2, const float* a1b2,
    const float* a2w1, const float* a2b1, const float* a2w2, const float* a2b2,
    const float* gw1, const float* gb1, const float* g1w2, const float* g1b2,
    const float* g2w2, const float* g2b2, float* h_last, float* mem_last,
    float* allh, float* allc, float* allmem, void* const* res_ptrs,
    const int* res_strides, const int* res_cols, int t, int n, int H,
    int z_tot, int mem, int s1, int s2, int s3, int s4, int n_cells,
    const int* cell_dims, int rows, int threads, void* stream) {
  using namespace ftt;
  EncodeArgs a;
  a.xp = xp;
  a.masks = masks;
  a.wh = wh;
  a.a1w1 = a1w1;
  a.a1b1 = a1b1;
  a.a1w2 = a1w2;
  a.a1b2 = a1b2;
  a.a2w1 = a2w1;
  a.a2b1 = a2b1;
  a.a2w2 = a2w2;
  a.a2b2 = a2b2;
  a.gw1 = gw1;
  a.gb1 = gb1;
  a.g1w2 = g1w2;
  a.g1b2 = g1b2;
  a.g2w2 = g2w2;
  a.g2b2 = g2b2;
  a.h_last = h_last;
  a.mem_last = mem_last;
  a.allh = allh;
  a.allc = allc;
  a.allmem = allmem;
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
      threads % 32 != 0 ||
      !make_res_table(res_ptrs, res_strides, res_cols, widths, &a.res) ||
      !((allh && allc && allmem && res_ptrs) ||
        !(allh || allc || allmem || res_ptrs)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return (int)launch_rows<1>(a, threads, st);
    case 2: return (int)launch_rows<2>(a, threads, st);
    case 4: return (int)launch_rows<4>(a, threads, st);
    case 8: return (int)launch_rows<8>(a, threads, st);
    case 16: return (int)launch_rows<16>(a, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
