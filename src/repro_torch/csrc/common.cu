// Host-side helpers shared by the kernels' Python wrappers.
#include "common.cuh"

// Text of a cudaError_t returned by a launcher.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
