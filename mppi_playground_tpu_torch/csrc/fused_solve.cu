// The model-independent kernels of the fused solve (fused_solve.cuh):
// auto-lambda phase 2 (fused_weighted_batch) and seed regeneration alone for
// one and two action dimensions (fused_regen_m1_batch, fused_regen_m2_batch:
// regen_rollout_kernel on its actions-only plug; reroll.cu rolls the rows out
// as well), each over a batch of scenarios on gridDim.y (a single solve is a
// batch of one).  The unfused fleet draws every scenario's rows in one launch,
// each scenario with its warm start, noise, seed word and key; the rows shared.
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py make_fused_solve.kernel
// in its weighted_only + pert_in mode (run_weighted) and its regen_dump_only
// mode (run_regen).  Phase 2 reads the costs [K] and phase 1's dump [D, K]
// (D = T*m) and reduces the block partials at the lambda a device pointer
// holds: bytes bound it (4K(1 + D) read).  Regeneration writes 4 T m bytes a
// requested row; at get_top_samples' 300 rows a launch costs more than the
// work.  The model's rollout kernels are in fused_<model>.cu.
//
// Phase 2 over a batch (fused_weighted_batch): the scenarios on gridDim.y,
// scenario b's costs, dump, lambda and partials at b of their own sizes, so
// that each scenario's partials are bit for bit its own launch's.  On a shard
// of a sample-sharded solve it masks by the global index as the rollout
// kernels do (fused_solve.cuh Sampling): local sample k is valid where k <
// num_samples and sample_offset + k < total_samples.
#include "fused_solve.cuh"

namespace {

using fused::kBlock;

// Phase 2: the block partials of the costs and the dumped perturbations, of
// scenario blockIdx.y.
__global__ void __launch_bounds__(kBlock) weighted_kernel(const float* costs, const float* dump,
                                                          const float* lam, int slots,
                                                          int num_samples, int sample_offset,
                                                          int total_samples, float* stats,
                                                          float* numer) {
  const size_t b = blockIdx.y, n = static_cast<size_t>(num_samples);
  costs += b * n;
  dump += b * slots * n;
  lam += b;
  stats += b * gridDim.x * 3;
  numer += b * gridDim.x * slots;
  extern __shared__ float smem[];
  float* s_red = smem;                       // kWarps
  float* s_numer = s_red + softmin::kWarps;  // kWarps * min(slots, kChunk)
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < num_samples && sample_offset + k < total_samples;
  const float cost = valid ? costs[k] : 1e30f;  // padding never wins the softmin
  fused::DumpedPerturbation src{dump, num_samples, valid ? k : 0, 0};
  fused::block_partials(cost, *lam, valid, src, slots, s_red, s_numer, stats, numer);
}

template <int kM>
int launch_regen(const float* prev, const float* noise, const int64_t* rows,
                 const float* bounds, const uint32_t* seed, int horizon, int num_samples,
                 int threshold, int num_rows, int batch, int seed_stride, float* out,
                 const uint32_t* key, uint32_t* key_out, void* stream) {
  return fused::launch_regen_rollout<fused::ActionsOnly<kM>>(
      fused::make_sampling<kM>(prev, noise, bounds, seed, horizon, num_samples, threshold,
                               seed_stride),
      rows, num_rows, nullptr, {}, out, nullptr, key, key_out, static_cast<cudaStream_t>(stream),
      batch);
}

}  // namespace

// batch scenarios: costs [B, K], dump [B, slots, K], lam [B], stats [B, blocks, 3],
// numer [B, blocks, slots]; a shard's sample_offset and the solve's total_samples
// (0 and num_samples for the whole launch), shared by every scenario.
extern "C" int fused_weighted_batch(const float* costs, const float* dump, const float* lam,
                                    int slots, int num_samples, int batch, int sample_offset,
                                    int total_samples, float* stats, float* numer,
                                    void* stream) {
  const size_t shmem = softmin::shared_bytes(slots);
  cudaError_t err = fused::allow_shared(weighted_kernel, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  weighted_kernel<<<dim3(fused::blocks_for(num_samples), batch), kBlock, shmem,
                    static_cast<cudaStream_t>(stream)>>>(costs, dump, lam, slots, num_samples,
                                                         sample_offset, total_samples, stats,
                                                         numer);
  return static_cast<int>(cudaGetLastError());
}

// fused_regen_m<m>_batch: batch scenarios, prev [B, T, m], noise [B, T*m, K] or
// null, the seed words seed_stride words apart (3 for a batch of keys [B, 3]),
// out [B, n, T, m], key and key_out [B, 3] or null; rows [n] shared.
#define FUSED_REGEN_ENTRY_POINT(m)                                                            \
  extern "C" int fused_regen_m##m##_batch(                                                    \
      const float* prev, const float* noise, const int64_t* rows, const float* bounds,        \
      const uint32_t* seed, int horizon, int num_samples, int threshold, int num_rows,        \
      int batch, int seed_stride, float* out, const uint32_t* key, uint32_t* key_out,         \
      void* stream) {                                                                         \
    return launch_regen<m>(prev, noise, rows, bounds, seed, horizon, num_samples, threshold,  \
                           num_rows, batch, seed_stride, out, key, key_out, stream);          \
  }

FUSED_REGEN_ENTRY_POINT(1)
FUSED_REGEN_ENTRY_POINT(2)
