// Error text for the C launchers' return codes (cudaError_t values).
#include <cuda_runtime.h>

extern "C" const char* clip_dplm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
