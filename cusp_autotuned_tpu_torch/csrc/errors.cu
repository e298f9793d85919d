// The message of a CUDA error code, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* cusp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
