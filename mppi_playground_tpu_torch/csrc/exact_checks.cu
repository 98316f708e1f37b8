// Exhaustive checks that a rewrite in device_math.cuh keeps every bit of the
// function it replaces, run by the card tests and chip_smoke.py.
//
// angle_normalize_sweep: devmath::angle_normalize, which skips fmodf where
// x + pi lies within two periods of 0, against the fmodf form it replaced,
// for every one of the 2^32 float32 inputs (NaN and infinities included),
// compared bit for bit.  counts[0] gets the inputs whose outputs differ,
// counts[1] those whose x + pi lies in (-4 pi, 4 pi), where the shortcut
// takes over from fmodf.  The caller zeroes counts first.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_math.cuh"

namespace {

// torch.remainder(x + pi, 2 pi) - pi through fmodf: the form before the shortcut.
__device__ __forceinline__ float angle_normalize_fmodf(float x) {
  const float pi = static_cast<float>(devmath::kPi);
  const float two_pi = static_cast<float>(2.0 * devmath::kPi);
  float r = fmodf(x + pi, two_pi);
  if (r != 0.0f && r < 0.0f) r = r + two_pi;
  return r - pi;
}

__global__ void angle_sweep_kernel(unsigned long long* counts) {
  const float pi = static_cast<float>(devmath::kPi);
  const float two_periods = 2.0f * static_cast<float>(2.0 * devmath::kPi);
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  unsigned long long differ = 0, inside = 0;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (uint64_t{1} << 32); i += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(i));
    differ += __float_as_uint(devmath::angle_normalize(x)) !=
              __float_as_uint(angle_normalize_fmodf(x));
    inside += fabsf(x + pi) < two_periods;
  }
  atomicAdd(&counts[0], differ);
  atomicAdd(&counts[1], inside);
}

}  // namespace

extern "C" int angle_normalize_sweep(unsigned long long* counts, void* stream) {
  angle_sweep_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(counts);
  return static_cast<int>(cudaGetLastError());
}
