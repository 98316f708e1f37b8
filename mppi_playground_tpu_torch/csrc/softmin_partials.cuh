// Softmin partials of one block of 256 samples: the body of the fused solve
// of every model (csrc/fused_solve.cuh) and of auto-lambda phase 2
// (csrc/fused_solve.cu); the streaming weighted update of the unfused solver
// (csrc/weighted_update.cu) shares its statistics, block_stats.
//
// Per block: the max of s = -c/lambda, sum e and sum e^2 with e = exp(s - max),
// and the numerator sum e * u for each of the sample's D action slots.
// combine_partials (ops/weighted_update.py) merges the blocks in torch.  The
// plain twin is ops/weighted_update.py block_partials_plain.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace softmin {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// Numerator slots staged in shared memory at a time (kWarps x kChunk floats,
// 8 KB), so that any D runs.
constexpr int kChunk = 256;

// The chunk of a source of `width` slots a next(): the most whole widths in
// kChunk (256 at widths 1, 2 and 4; 255 at 3), so that no next() writes past
// the chunk.
__host__ __device__ constexpr int chunk_for(int width) { return kChunk / width * width; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xFFFFFFFFu, v, o));
  return v;
}

// Block-wide reduction; the result is valid in every thread.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// Shared memory block_partials needs for D = slots from a source of `width`
// slots a next(): the reduction scratch and one chunk of the numerator.
inline size_t shared_bytes(int slots, int width = 1) {
  const int chunk = slots < chunk_for(width) ? slots : chunk_for(width);
  return sizeof(float) * (kWarps + static_cast<size_t>(kWarps) * chunk);
}

// The block's softmin statistics, stats[blockIdx.x] = (max of s, sum e, sum
// e^2) with s = -cost / lambda, one sample a thread; returns this thread's e.
__device__ __forceinline__ float block_stats(float cost, float lam, float* s_red, float* stats) {
  const float s = -cost / lam;
  const float mx = block_reduce<true>(s, s_red);
  const float e = expf(s - mx);
  const float z_sum = block_reduce<false>(e, s_red);
  const float sq_sum = block_reduce<false>(e * e, s_red);
  if (threadIdx.x == 0) {
    stats[blockIdx.x * 3 + 0] = mx;
    stats[blockIdx.x * 3 + 1] = z_sum;
    stats[blockIdx.x * 3 + 2] = sq_sum;
  }
  return e;
}

// Softmin partials of one block: block_stats, and numer[blockIdx.x, f] =
// sum e * u_f.  Every thread of the block calls it; invalid threads carry
// cost 1e30 and weigh 0.  src.next(v) gives a valid sample's next
// Source::kWidth slots, in ascending order (slots is a multiple of kWidth).
// Each slot is reduced within each warp, then across the warps in warp
// order, one chunk of chunk_for(kWidth) slots at a time (the chunks do not
// change any slot's order of summation): the sources here (the fused solve's
// regenerated perturbations, phase 2's slot-major dump) give each thread its
// own sample.
template <class Source>
__device__ __forceinline__ void block_partials(float cost, float lam, bool valid, Source& src,
                                               int slots, float* s_red, float* s_numer,
                                               float* stats, float* numer) {
  const float e = block_stats(cost, lam, s_red, stats);
  constexpr int kSourceChunk = chunk_for(Source::kWidth);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = slots < kSourceChunk ? slots : kSourceChunk;  // a warp's row of s_numer
  for (int c0 = 0; c0 < slots; c0 += kSourceChunk) {
    const int n = slots - c0 < kSourceChunk ? slots - c0 : kSourceChunk;
    for (int f = 0; f < n; f += Source::kWidth) {
      float v[Source::kWidth];
#pragma unroll
      for (int j = 0; j < Source::kWidth; ++j) v[j] = 0.0f;
      if (valid) src.next(v);
#pragma unroll
      for (int j = 0; j < Source::kWidth; ++j) {
        const float w = warp_sum(e * v[j]);
        if (lane == 0) s_numer[warp * stride + f + j] = w;
      }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < n; f += kBlock) {
      float acc = s_numer[f];
      for (int w = 1; w < kWarps; ++w) acc += s_numer[w * stride + f];
      numer[static_cast<size_t>(blockIdx.x) * slots + c0 + f] = acc;
    }
    __syncthreads();  // the next chunk overwrites s_numer
  }
}

}  // namespace softmin
