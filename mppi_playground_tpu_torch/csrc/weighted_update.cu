// Streaming softmin weighted update of the unfused solver: block partials.
//
// Replaces: mppi_playground_tpu/ops/pallas_kernels.py, weighted_update and
// _weighted_update_kernel, a Pallas TPU kernel that sweeps the [K, D]
// samples once in 1024-row tiles on the sequential TPU grid, carrying an
// online-softmax max, sum e, sum e^2 and numerator from tile to tile, the
// numerator of a tile one MXU product.
//
// What it computes.  From costs [K], samples [K, D] (D = T*m, row-major:
// the unfused solver's clamped perturbed action sequences) and lambda (a
// device pointer: the ESSPS/LBPS lambda of the unfused route never visits
// the host), per block of 256 samples: max of -c/lambda, sum e, sum e^2 and
// the numerator sum e * sample per slot.  combine_partials
// (ops/weighted_update.py) merges the blocks into (update [T, m], weights
// [K], ess) in torch, as the JAX wrapper does around its pallas_call.  An
// unfused fleet's launch (weighted_update_batch) puts scenario b on
// blockIdx.y: costs [B, K], samples [B, K, D], lambda [B], stats [B, blocks,
// 3] and numer [B, blocks, D], each at b of its own size, so that scenario
// b's partials are bit for bit its own launch's.
//
// What bounds it on the H100.  The function reads each sample once and the
// costs once, 4 K (D + 1) bytes, and writes the partials, 4 B (D + 3) bytes
// for B = ceil(K / 256) blocks: at K=100,000 12 us at D=100 (40 MB), 0.184 ms
// at D=1,536 and 0.240 ms at D=2,000 (800 MB) at 3.35 TB/s.  Its float work
// is 2 operations a slot and a few a sample, far below the byte time: bytes
// bound it, and the numerator is a streaming GEMV (e^T times the block's
// [256, D] tile), not a matrix product.
//
// What the design does about it.  A CUDA grid has no sequential order, so
// nothing is carried between blocks: each block writes its own partials (the
// online rescale of the TPU kernel becomes one merge in torch).  A block owns
// 256 sample rows.  It computes their statistics with block_stats, the code
// the fused solve and phase 2 share (softmin_partials.cuh), and keeps e of
// each row in shared memory.  It then streams its [rows, D] tile with
// neighbouring threads on neighbouring columns, so every warp's loads are
// coalesced: 16-byte loads (four columns a thread) where D is a multiple of 4
// and the samples are 16-byte aligned, 4-byte loads otherwise.  Each thread
// accumulates e[r] * x[r, f] for its columns in registers, row after row,
// with no shuffle per slot.  Wide rows (D / 4 >= 256 columns of loads): each
// thread owns columns and walks all the rows.  Narrow rows (the unfused
// racing widths, D = 50 and 100): the threads are laid out as G row groups
// of C = D / 4 column lanes, group g taking rows g, g + G, ..., so that one
// step of all groups reads G consecutive rows, a contiguous stretch of
// memory, and the block stays busy; the G group partials are added in group
// order through shared memory.  The loads are plain __ldg with the row loop
// unrolled to keep several in flight per thread: no cp.async or TMA staging,
// since no value is read twice and registers hold the sums, so staging
// through shared memory would add a copy without removing a byte.  Padded
// rows past K cost 1e30 in the statistics and are never read.  Built with
// -fmad=false and IEEE division: the statistics are phase 2's bit for bit;
// the numerator sums rows in another order than the twin, so the two agree
// to rounding (chip_smoke.PARTIALS_BAR).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "softmin_partials.cuh"

namespace {

using softmin::kBlock;  // threads a block, and sample rows a block

// kW consecutive floats of a row: one 16-byte load, or one float.
template <int kW>
__device__ __forceinline__ void load(const float* p, float (&x)[kW]) {
  if constexpr (kW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

// sum over rows r = first, first + step, ... < rows of e[r] * tile[r, col .. col + kW).
template <int kW>
__device__ __forceinline__ void column_sums(const float* tile, const float* s_e, int slots,
                                            int first, int step, int rows, float (&acc)[kW]) {
#pragma unroll
  for (int j = 0; j < kW; ++j) acc[j] = 0.0f;
#pragma unroll 8
  for (int r = first; r < rows; r += step) {
    float x[kW];
    load<kW>(tile + static_cast<size_t>(r) * slots, x);
    const float w = s_e[r];
#pragma unroll
    for (int j = 0; j < kW; ++j) acc[j] = acc[j] + w * x[j];
  }
}

template <int kW>
__global__ void __launch_bounds__(kBlock) weighted_update_kernel(
    const float* costs, const float* samples, const float* lam, int slots, int num_samples,
    float* stats, float* numer) {
  {  // scenario blockIdx.y of a batched launch
    const size_t b = blockIdx.y, n = static_cast<size_t>(num_samples), blocks = gridDim.x;
    costs += b * n;
    samples += b * n * slots;
    lam += b;
    stats += b * blocks * 3;
    numer += b * blocks * slots;
  }
  __shared__ float s_red[softmin::kWarps];
  __shared__ float s_e[kBlock];
  __shared__ float s_part[kBlock * kW];  // the row groups' partials, [G, D] with G * D <= this
  const int row0 = blockIdx.x * kBlock;
  const int k = row0 + threadIdx.x;
  const float cost = k < num_samples ? costs[k] : 1e30f;  // padding never wins the softmin
  s_e[threadIdx.x] = softmin::block_stats(cost, *lam, s_red, stats);
  __syncthreads();

  const int rows = min(kBlock, num_samples - row0);
  const int units = slots / kW;  // loads a row
  const float* tile = samples + static_cast<size_t>(row0) * slots;
  float* out = numer + static_cast<size_t>(blockIdx.x) * slots;
  float acc[kW];
  if (units >= kBlock) {  // wide rows: a thread's columns over every row
    for (int u = threadIdx.x; u < units; u += kBlock) {
      column_sums<kW>(tile + u * kW, s_e, slots, 0, 1, rows, acc);
#pragma unroll
      for (int j = 0; j < kW; ++j) out[u * kW + j] = acc[j];
    }
    return;
  }
  // narrow rows: G groups of `units` column lanes, group g on rows g, g + G, ...
  const int groups = kBlock / units;
  const int g = threadIdx.x / units, c = threadIdx.x - g * units;
  if (g < groups) {
    column_sums<kW>(tile + c * kW, s_e, slots, g, groups, rows, acc);
#pragma unroll
    for (int j = 0; j < kW; ++j) s_part[g * slots + c * kW + j] = acc[j];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < slots; f += kBlock) {
    float t = s_part[f];
    for (int h = 1; h < groups; ++h) t = t + s_part[h * slots + f];
    out[f] = t;
  }
}

}  // namespace

// batch scenarios: costs [B, K], samples [B, K, D], lam [B], stats [B, blocks, 3],
// numer [B, blocks, D].  Every scenario's rows start 16-byte aligned where the
// first's do and D is a multiple of 4 (K * D floats apart).
extern "C" int weighted_update_batch(const float* costs, const float* samples, const float* lam,
                                     int slots, int num_samples, int batch, float* stats,
                                     float* numer, void* stream) {
  const dim3 grid((num_samples + kBlock - 1) / kBlock, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots % 4 == 0 && reinterpret_cast<uintptr_t>(samples) % 16 == 0) {
    weighted_update_kernel<4><<<grid, kBlock, 0, s>>>(costs, samples, lam, slots, num_samples,
                                                      stats, numer);
  } else {
    weighted_update_kernel<1><<<grid, kBlock, 0, s>>>(costs, samples, lam, slots, num_samples,
                                                      stats, numer);
  }
  return static_cast<int>(cudaGetLastError());
}
