// The text of a CUDA error code, for the launch errors the wrappers
// raise; and the per-phase probe's buffer (lstm_common.cuh).
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace ftt {
namespace {
long long* clocks = nullptr;
}  // namespace

long long* phase_clocks() { return clocks; }
}  // namespace ftt

extern "C" const char* ftt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Registers the probe's device buffer of kClockKernels * kMaxCells *
// kClockSteps * kClockPhases int64 (null: none), read by the launches
// that follow.
extern "C" int ftt_set_phase_clocks(void* buffer) {
  ftt::clocks = static_cast<long long*>(buffer);
  return 0;
}
