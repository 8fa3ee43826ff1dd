// Pieces shared by the recurrent kernels: the cell table of a fused,
// block-diagonal, gate-major recurrent weight, and the gate nonlinearity.
#pragma once

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

// The shared memory a block may use on an H100 (227 KB), the backward
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

}  // namespace ftt
