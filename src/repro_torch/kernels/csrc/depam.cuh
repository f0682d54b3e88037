// Shared helpers for the DEPAM kernels (plain C interface, no PyTorch
// headers: each source compiles in seconds with nvcc).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace depam {

// One decoded sample.  The float32 path loads the host-decoded value;
// the int16 path converts (exact) and multiplies by the decode scale
// with an explicitly rounded multiply, so the compiler cannot contract
// it into a later FMA: the same single rounding the host decode does,
// which keeps the int16 and float32 payloads bitwise identical.
__device__ __forceinline__ float sample(const float* x, long long i,
                                        float /*scale*/) {
  return x[i];
}

__device__ __forceinline__ float sample(const int16_t* x, long long i,
                                        float scale) {
  return __fmul_rn(static_cast<float>(x[i]), scale);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per
// kernel; a block can use at most 227 KB on Hopper.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= 49152) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace depam
