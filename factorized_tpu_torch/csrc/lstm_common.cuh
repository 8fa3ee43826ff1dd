// Pieces shared by the recurrent kernels: the cell table of a fused,
// block-diagonal, gate-major recurrent weight, and the gate nonlinearity.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace ftt {

constexpr int kMaxCells = 8;

// Prefix sums of the fused cells' hidden widths: cell m owns hidden units
// [off[m], off[m + 1]). In a gate-major block-diagonal weight (H, 4H),
// column q * H + j is nonzero only on the rows of unit j's own cell, so a
// kernel reads those rows and skips the off-block zeros.
struct Cells {
  int count;
  int off[kMaxCells + 1];
};

// Fills `out` from `count` widths that must sum to H; false if they do not.
inline bool make_cells(int count, const int* dims, int H, Cells* out) {
  if (count < 1 || count > kMaxCells) return false;
  out->count = count;
  out->off[0] = 0;
  for (int m = 0; m < count; ++m) {
    if (dims[m] < 1) return false;
    out->off[m + 1] = out->off[m] + dims[m];
  }
  for (int m = count + 1; m <= kMaxCells; ++m) out->off[m] = out->off[count];
  return out->off[count] == H;
}

// Rows [k0, k1) of the recurrent weight that feed hidden unit j.
__device__ __forceinline__ void cell_range(const Cells& cells, int j, int& k0,
                                           int& k1) {
  k0 = 0;
  k1 = cells.off[1];
#pragma unroll
  for (int m = 1; m < kMaxCells; ++m) {
    if (m < cells.count && j >= cells.off[m]) {
      k0 = cells.off[m];
      k1 = cells.off[m + 1];
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The shared memory a block may use on an H100 (227 KB), the chain
// kernels' fit gate.
constexpr int kMaxSmemBytes = 232448;

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device. The attribute is set only when it must grow, once per (device,
// kernel) and size, so a wrapper called every step does not pay for it on
// every call.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> allowed;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{device, kernel}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// Thread-block clusters: a chain whose weights pass one block's shared
// memory splits them over C blocks of a cluster (C in 1, 2, 4, 8; 8 is the
// largest portable size), the peers trading through distributed shared
// memory.
constexpr int kMaxCluster = 8;

// What a launcher reports through its `fit` array (host memory, six
// ints): a pass refused before any launch ({1-based pass, the bytes a
// block needs, the card's limit, the plan: for a chain kWeightsL2, its
// per-row state alone passing a block}), and the plans of its (up to
// two) chains: the cluster, or kWeightsL2.
enum Fit { kFitPass, kFitBytes, kFitLimit, kFitCluster, kFitChainA,
           kFitChainB, kFitInts };

inline void clear_fit(int* fit) {
  for (int k = 0; k < kFitInts; ++k) fit[k] = 0;
}

// Records a refusal in `fit` and returns the error the launcher gives.
inline cudaError_t refuse(int* fit, int pass, size_t bytes, int cluster) {
  fit[kFitPass] = pass;
  fit[kFitBytes] = (int)bytes;
  fit[kFitLimit] = kMaxSmemBytes;
  fit[kFitCluster] = cluster;
  return cudaErrorInvalidValue;
}

// The smallest cluster C in 1, 2, 4, 8 whose blocks' shared memory,
// bytes_at(C), fits one SM; 0 if none does, with the bytes at 8 in *bytes.
template <typename F>
inline int smallest_cluster(F bytes_at, size_t* bytes) {
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    *bytes = bytes_at(C);
    if (*bytes <= (size_t)kMaxSmemBytes) return C;
  }
  return 0;
}

// A chain's plan, reported in `fit` as its cluster: kWeightsL2 where no
// cluster of 8 holds its weights, and the chain runs one block per row
// tile that reads them in place from device memory (through L2) and
// keeps only the per-row state in shared memory.
constexpr int kWeightsL2 = 0;
constexpr int kRefused = -1;

// The smallest cluster whose blocks fit (bytes_at(C)), else kWeightsL2
// if the per-row state alone (state_bytes()) fits a block, else
// kRefused; the chosen launch's bytes in *bytes (the state's when
// refused). Decided from the widths, before any launch.
template <typename F, typename G>
inline int chain_plan(F bytes_at, G state_bytes, size_t* bytes) {
  const int C = smallest_cluster(bytes_at, bytes);
  if (C != 0) return C;
  *bytes = state_bytes();
  return *bytes <= (size_t)kMaxSmemBytes ? kWeightsL2 : kRefused;
}

// The blocks a cluster of the plan holds (1 for kWeightsL2).
inline int plan_blocks(int plan) { return plan == kWeightsL2 ? 1 : plan; }

// The kernel of a chain for its plan: kernels[0] reads its weights from
// L2, kernels[1 + log2 C] holds them in shared memory on clusters of C.
template <typename K>
inline K chain_kernel(const K (&kernels)[5], int plan) {
  return plan == kWeightsL2 ? kernels[0]
         : plan == 1        ? kernels[1]
         : plan == 2        ? kernels[2]
         : plan == 4        ? kernels[3]
                            : kernels[4];
}

// Launches `kernel` on clusters of C blocks along x (a plain launch for
// C = 1); grid.x must be a multiple of C.
template <typename Args>
inline cudaError_t launch_clusters(void (*kernel)(Args), dim3 grid,
                                   int threads, size_t bytes, int C,
                                   cudaStream_t stream, const Args& a) {
  if (C == 1) {
    kernel<<<grid, threads, bytes, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// This block's rank in its cluster of C (0 without one).
template <int C>
__device__ __forceinline__ int cluster_rank() {
  if (C == 1) return 0;
  return (int)cooperative_groups::this_cluster().block_rank();
}

// Every block of the cluster has reached this point, its shared memory
// writes before it visible to the peers (a block barrier for C = 1).
template <int C>
__device__ __forceinline__ void cluster_barrier() {
  if (C == 1)
    __syncthreads();
  else
    cooperative_groups::this_cluster().sync();
}

// acc[r] = sum_k A[r][k] w_row[k ws], k = slice, slice + ks, ...: one
// lane's share of an output, A row-major in shared memory, w_row's
// elements ws floats apart (1 in shared memory; a column of a weight read
// in place from L2); four partial sums (so consecutive loads overlap)
// added in a fixed order.
template <int R>
__device__ __forceinline__ void smem_dot(const float* A, int lda, int K,
                                         const float* w_row, int slice,
                                         int ks, float (&acc)[R],
                                         int ws = 1) {
  float p[4][R];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r) p[u][r] = 0.0f;
  int k = slice;
  for (; k + 3 * ks < K; k += 4 * ks) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float wv = w_row[(k + u * ks) * ws];
#pragma unroll
      for (int r = 0; r < R; ++r)
        p[u][r] = fmaf(A[r * lda + k + u * ks], wv, p[u][r]);
    }
  }
  for (; k < K; k += ks) {
    const float wv = w_row[k * ws];
#pragma unroll
    for (int r = 0; r < R; ++r) p[0][r] = fmaf(A[r * lda + k], wv, p[0][r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc[r] = (p[0][r] + p[1][r]) + (p[2][r] + p[3][r]);
}

template <int R>
__device__ __forceinline__ void lanes_sum(float (&acc)[R], int ks) {
  for (int o = 1; o < ks; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  }
}

// Columns [width p / C, width (p + 1) / C) of every peer p's row-major
// [R][width] buffer into this block's, after a cluster barrier: the
// gather of a chain whose columns a cluster of C splits.
template <int C, int R>
__device__ __forceinline__ void gather_peers(float* buf, int width,
                                             int rank, int tid, int nthr) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
#pragma unroll
  for (int p = 0; p < C; ++p) {
    if (p == rank) continue;
    const int lo = width * p / C, cols = width * (p + 1) / C - lo;
    const float* peer = cluster.map_shared_rank(buf, p);
    for (int i = tid; i < R * cols; i += nthr) {
      const int r = i / cols, j = lo + i - r * cols;
      buf[r * width + j] = peer[r * width + j];
    }
  }
}

// An asynchronous 4-byte copy from device memory into shared memory
// (cp.async): the copy runs while the thread goes on, until
// cp_async_wait_all; a barrier after the wait shows it to the block.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Closes the group of the copies issued since the last one; with
// cp_async_wait<N>, which waits until at most N groups are in flight, a
// pipeline keeps the next stage's copies running.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of `len` floats, row r from src + r * ld into dst + r *
// pitch, asynchronously, in the widest copies (16, 8 or 4 bytes) that
// every row's start and length allow.
__device__ __forceinline__ void copy_rows_async(float* dst, int pitch,
                                                const float* src, size_t ld,
                                                int rows, int len, int tid,
                                                int nthr) {
  const size_t d = reinterpret_cast<size_t>(dst);
  const size_t s = reinterpret_cast<size_t>(src);
  int v = 4;
  while (v > 1 && (pitch % v != 0 || ld % v != 0 || len % v != 0 ||
                   d % (4 * v) != 0 || s % (4 * v) != 0))
    v >>= 1;
  const int per = len / v;
  for (int e = tid; e < rows * per; e += nthr) {
    const int r = e / per, c = (e - r * per) * v;
    float* to = dst + (size_t)r * pitch + c;
    const float* from = src + r * ld + c;
    if (v == 4)
      cp_async16(to, from);
    else if (v == 2)
      cp_async8(to, from);
    else
      cp_async4(to, from);
  }
}

// A row pitch of at least `len` floats for a shared-memory matrix that a
// warp reads as 32 / unit rows at once, `unit` consecutive floats from
// each: the pitch modulo 32 banks is an odd multiple of `unit`, so the
// rows' pieces fall on disjoint banks and no read conflicts. unit = 32
// needs no padding.
__host__ __device__ inline int conflict_free_pitch(int len, int unit) {
  if (unit >= 32) return len;
  int p = len;
  while (p % unit != 0 || ((p / unit) & 1) == 0) ++p;
  return p;
}

// The largest power of two up to 32 such that `items` outputs, each
// split over that many lanes, fit in `threads`; at least 1.
__host__ __device__ inline int lanes_per_output(int items, int threads) {
  int ks = 32;
  while (ks > 1 && items * ks > threads) ks >>= 1;
  return ks;
}

// The per-phase probe (perf_probe.py phases). Built with
// FTT_PHASE_CLOCKS, thread 0 of block x = 0 of each grid row y (a chain
// kernel's cell) stamps clock64() at the end of each phase of each step
// into the buffer that ftt_set_phase_clocks registered: slot [kernel][y]
// [step][phase], the step counted from the chain's first (row 0 holds the
// stamp before it). Without the define the stamps compile to nothing.
enum ClockKernel {
  kClockMultiBwd,
  kClockDecoderBwd,
  kClockMemChainBwd,
  kClockCellChainsBwd,
  kClockCellChainsFwd,
  kClockMemChainFwd,
  kClockLstmFwd,
  kClockEncodeDw,
  kClockKernels
};
constexpr int kClockSteps = 64;
constexpr int kClockPhases = 8;

// The registered buffer (device memory), or null (errors.cu).
long long* phase_clocks();

#ifdef FTT_PHASE_CLOCKS
#define FTT_STAMP(buf, kernel, step, phase)                                \
  do {                                                                     \
    if ((buf) != nullptr && blockIdx.x == 0 && blockIdx.y < kMaxCells &&   \
        threadIdx.x == 0 && (step) < kClockSteps)                          \
      (buf)[(((kernel) * kMaxCells + blockIdx.y) * kClockSteps + (step)) * \
                kClockPhases +                                             \
            (phase)] = clock64();                                          \
  } while (0)
#else
#define FTT_STAMP(buf, kernel, step, phase) \
  do {                                      \
  } while (0)
#endif

}  // namespace ftt
