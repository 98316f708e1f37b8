// Streaming softmin weighted update of the unfused solver: block partials.
//
// Replaces: mppi_playground_tpu/ops/pallas_kernels.py, weighted_update and
// _weighted_update_kernel, a Pallas TPU kernel that sweeps the [K, D]
// samples once in 1024-row tiles on the sequential TPU grid, carrying an
// online-softmax max, sum e, sum e^2 and numerator from tile to tile.
//
// What it computes.  From costs [K], samples [K, D] (D = T*m, row-major:
// the unfused solver's clamped perturbed action sequences) and lambda (a
// device pointer: the ESSPS/LBPS lambda of the unfused route never visits
// the host), per block of 256 samples: max of -c/lambda, sum e, sum e^2 and
// the numerator sum e * sample per slot.  combine_partials
// (ops/weighted_update.py) merges the blocks into (update [T, m], weights
// [K], ess) in torch, as the JAX wrapper does around its pallas_call.
//
// What bounds it on the H100.  The function reads each sample once and the
// costs once: 4 K (D + 1) bytes, 40.4 MB at the flagship's K=100,000, D=100,
// 12 us at 3.35 TB/s; it writes the partials (391 x 412 B).  Its float work
// is 2 operations a slot and a few a sample, far below the byte time: bytes
// bound it.
//
// What this simple design does about it.  A CUDA grid has no sequential
// order, so nothing is carried between blocks: each block writes its own
// partials (the online rescale of the TPU kernel becomes one merge in
// torch), through block_partials, the body the fused solve and auto-lambda
// phase 2 share (softmin_partials.cuh).  One thread per sample reads its own
// row: consecutive threads read addresses D floats apart, so the loads are
// not coalesced and lean on L1; any D runs, the numerator staged in shared
// memory 256 slots at a time.  Making the reads coalesced (a block staging
// its [256, chunk] tile) is work for a later change.  Padded threads past K
// cost 1e30 and weigh 0.  Built with -fmad=false and IEEE division, so the
// per-block sums follow the twin's operations; the twin sums in another
// order, so the two agree to rounding.
#include <cuda_runtime.h>

#include <cstddef>

#include "softmin_partials.cuh"

namespace {

using softmin::kBlock;

// Sample k's row of the [K, D] samples, a slot at a time.
struct RowSource {
  static constexpr int kWidth = 1;
  const float* row;
  int f;

  __device__ __forceinline__ void next(float* v) { v[0] = __ldg(row + f++); }
};

__global__ void __launch_bounds__(kBlock) weighted_update_kernel(
    const float* costs, const float* samples, const float* lam, int slots, int num_samples,
    float* stats, float* numer) {
  extern __shared__ float smem[];
  float* s_red = smem;                       // kWarps
  float* s_numer = s_red + softmin::kWarps;  // kWarps * min(D, kChunk)
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < num_samples;
  const float cost = valid ? costs[k] : 1e30f;  // padding never wins the softmin
  RowSource src{samples + static_cast<size_t>(valid ? k : 0) * slots, 0};
  softmin::block_partials(cost, *lam, valid, src, slots, s_red, s_numer, stats, numer);
}

}  // namespace

extern "C" int weighted_update(const float* costs, const float* samples, const float* lam,
                               int slots, int num_samples, float* stats, float* numer,
                               void* stream) {
  const int blocks = (num_samples + kBlock - 1) / kBlock;
  weighted_update_kernel<<<blocks, kBlock, softmin::shared_bytes(slots),
                           static_cast<cudaStream_t>(stream)>>>(costs, samples, lam, slots,
                                                                num_samples, stats, numer);
  return static_cast<int>(cudaGetLastError());
}
