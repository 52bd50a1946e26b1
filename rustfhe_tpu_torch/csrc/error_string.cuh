// The one entry every kernel library exports besides its own: the text of a
// cudaError_t that one of its entries returned, so that its wrapper
// (engine/launch.py) decodes the library's errors without loading another.
// Each library is one .cu, the only translation unit that includes this.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* rustfhe_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
