// How the tiled kernels (K6, K7 in tiled_diffusion.cu; K8 in
// tiled_system.cu) read and write a state in device memory that is
// stored in float32 or bfloat16, converting to float32 for the
// arithmetic and rounding to nearest even on the way back.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace state_io {

__device__ __forceinline__ float round_to_bfloat16(float value) {
  return __bfloat162float(__float2bfloat16_rn(value));
}

// How a state buffer in device memory is read: float32, bfloat16, or
// float32 rounded to bfloat16 (an initial state whose carried copy is
// stored in bfloat16).
enum SourceKind {
  kSourceFloat = 0,
  kSourceBfloat16 = 1,
  kSourceFloatRounded = 2,
};

__device__ __forceinline__ float load_state(const void* source, int kind,
                                            size_t index) {
  if (kind == kSourceBfloat16) {
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(source)[index]);
  }
  const float value = static_cast<const float*>(source)[index];
  return kind == kSourceFloatRounded ? round_to_bfloat16(value) : value;
}

__device__ __forceinline__ void store_state(void* target, int is_bfloat16,
                                            size_t index, float value) {
  if (is_bfloat16) {
    static_cast<__nv_bfloat16*>(target)[index] = __float2bfloat16_rn(value);
  } else {
    static_cast<float*>(target)[index] = value;
  }
}

}  // namespace state_io
