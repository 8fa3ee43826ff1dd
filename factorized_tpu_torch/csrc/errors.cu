// The text of a CUDA error code, for the launch errors the wrappers raise.
#include <cuda_runtime.h>

extern "C" const char* ftt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
