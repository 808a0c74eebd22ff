// Error reporting shared by the kernels' C entry points.
//
// Every entry point returns the cudaError_t of its launch as an int; the
// Python wrapper turns a non-zero code into an exception carrying this text.
#include <cuda_runtime.h>

extern "C" const char* maunet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
