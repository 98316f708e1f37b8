// Exhaustive checks that a rewrite in device_math.cuh keeps every bit of the
// function it replaces, run by the card tests and chip_smoke.py.  The caller
// zeroes counts first.
//
// angle_normalize_sweep: devmath::angle_normalize, which skips fmodf where
// x + pi lies within two periods of 0, against the fmodf form it replaced,
// for every one of the 2^32 float32 inputs (NaN and infinities included),
// compared bit for bit.  counts[0] gets the inputs whose outputs differ,
// counts[1] those whose x + pi lies in (-4 pi, 4 pi), where the shortcut
// takes over from fmodf.
//
// radius_sweep: the Box–Muller radius sqrt_fast(-2 log_normal(u1)) against
// sqrtf(-2.0f * logf(u1)) for each of the 2^24 values u1 takes, bit for bit:
// counts[0] the radii that differ, counts[1] the logarithms, counts[2] the
// inputs checked.
//
// cell_sweep: one dimension of devmath::cell_index (the quotient from the
// reciprocal, __float2int_rn, the unsigned bound) against the form it
// replaced (the IEEE division, rintf, the float compares and the clamp) at a
// cell size, origin and width, for every one of the 2^32 float32 positions:
// counts[0] the positions whose off-grid flag or (on the grid) cell differ,
// counts[1] those of magnitude 2^-100 or more whose quotient differs from the
// IEEE one where that is below 2^100, counts[2] the positions on the grid.
//
// key_sweep: devmath::advance_key (and so devmath::tick_seed) on n device
// keys [n, 3], written to out [n, 3], for the caller to hold against the
// host's tick_seed (core/config.py) word for word.
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

__global__ void radius_sweep_kernel(unsigned long long* counts) {
  unsigned long long radius = 0, log = 0, checked = 0;
  for (uint32_t n = blockIdx.x * blockDim.x + threadIdx.x; n < (1u << 24);
       n += gridDim.x * blockDim.x) {
    // u1 as normal_pair_from_bits forms it from 24 bits
    const float u1 = static_cast<float>(n) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
    const float want_log = logf(u1);
    const float got_log = devmath::log_normal(u1);
    log += __float_as_uint(got_log) != __float_as_uint(want_log);
    radius += __float_as_uint(devmath::sqrt_fast(-2.0f * got_log)) !=
              __float_as_uint(sqrtf(-2.0f * want_log));
    ++checked;
  }
  atomicAdd(&counts[0], radius);
  atomicAdd(&counts[1], log);
  atomicAdd(&counts[2], checked);
}

__global__ void cell_sweep_kernel(devmath::Geometry g, unsigned long long* counts) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  unsigned long long differ = 0, quotient = 0, on_grid = 0;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (uint64_t{1} << 32); i += stride) {
    const float p = __uint_as_float(static_cast<uint32_t>(i));
    // the form before: IEEE division, rintf, float compares, clamp
    const float want_q = p / g.cell_size;
    const float ix = rintf(want_q + g.origin_x);
    const bool want_oob = (ix < 0.0f) || (ix >= static_cast<float>(g.width));
    const int want = static_cast<int>(devmath::clampf(ix, 0.0f, static_cast<float>(g.width - 1)));
    // cell_index's
    const float got_q = devmath::div_cell(p, g);
    const int got = __float2int_rn(got_q + g.origin_x);
    const bool got_oob = static_cast<unsigned>(got) >= static_cast<unsigned>(g.width);
    differ += got_oob != want_oob || (!want_oob && got != want);
    quotient += fabsf(p) >= 0x1p-100f && fabsf(want_q) < 0x1p100f &&
                __float_as_uint(got_q) != __float_as_uint(want_q);
    on_grid += !want_oob;
  }
  atomicAdd(&counts[0], differ);
  atomicAdd(&counts[1], quotient);
  atomicAdd(&counts[2], on_grid);
}

__global__ void key_sweep_kernel(const uint32_t* keys, int n, uint32_t* out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    devmath::advance_key(keys + 3 * static_cast<size_t>(i), out + 3 * static_cast<size_t>(i));
  }
}

}  // namespace

extern "C" int key_sweep(const uint32_t* keys, int n, uint32_t* out, void* stream) {
  key_sweep_kernel<<<132, 256, 0, static_cast<cudaStream_t>(stream)>>>(keys, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int angle_normalize_sweep(unsigned long long* counts, void* stream) {
  angle_sweep_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int radius_sweep(unsigned long long* counts, void* stream) {
  radius_sweep_kernel<<<132 * 4, 256, 0, static_cast<cudaStream_t>(stream)>>>(counts);
  return static_cast<int>(cudaGetLastError());
}

// geometry: x_lo, x_hi, y_lo, y_hi, origin_x, origin_y, cell_size; ints: width, height
extern "C" int cell_sweep(const float* geometry, const int* ints, unsigned long long* counts,
                          void* stream) {
  cell_sweep_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      devmath::make_geometry(geometry, ints), counts);
  return static_cast<int>(cudaGetLastError());
}
