// ESSPS and LBPS temperature searches over a resident cost vector.
//
// Replaces: mppi_playground_tpu/ops/lambda_search.py, essps_lambda_fused
// (_essps_kernel, essps_bisect) and lbps_lambda_fused (_lbps_kernel,
// lbps_golden): Pallas TPU kernels that load the padded cost vector into VMEM
// once and run every iteration of the search on it.
//
// * essps_search_batch: 2 + iters evaluations of ESS(lambda) = (sum e)^2 / sum e^2
//   with e = exp(d * (1 / lambda)), d = min(c) - c hoisted out of the loop;
//   bisection towards the target ESS, then the reference's bracket clamps.
// * lbps_search_batch: 2 + iters evaluations of the LBPS objective
//   (sum e*c + range_pen * sqrt(sum e^2)) / sum e with a = -1/lambda and
//   e = exp(c * a - min(c) * a), the exact hoist (a 1-ulp different shift
//   moves golden section to another plateau); range_pen = (max - min) *
//   sqrt(ratio) over the costs.  Golden section carries the surviving value.
//
// The search itself is lambda_search.cuh's cluster_search, which the lambda
// epilogue of auto-lambda phase 1 (fused_solve.cuh) runs too.  Each launch
// searches a batch of scenarios (a single solve's is a batch of one), one
// cluster a scenario on gridDim.y (__cluster_dims__ keeps a cluster inside one
// scenario): scenario b searches costs [b, 0:K) into out[b], bit for bit its
// own launch.
//
// Each evaluation is a reduction over all K costs on which the next step
// depends.  What bounds it on the H100: the function reads 4K bytes once
// (0.12 us at K=100,000) and does about 5 (ESSPS) or 7 (LBPS) float
// operations per cost and evaluation, 2e7-2.4e7 at the flagship, 0.3-0.4 us
// at 67 TFLOP/s; in practice the chain of ~40 dependent grid-wide
// reductions, each a barrier across SMs, bounds it.
//
// What this simple design does about it.  One thread-block cluster of 8 CTAs
// (the portable maximum) of 1024 threads.  CTA r holds the r-th eighth of
// the costs in its shared memory (50 KB at K=100,000; past 200 KB a CTA reads
// the rest of its slice from global memory, where it stays in L2), so no
// evaluation touches device memory.  An evaluation reduces per thread, per
// warp (shuffles) and per CTA, then exchanges the CTA partials through
// distributed shared memory with one cluster barrier; every CTA sums the 8
// partials in rank order, so all threads hold the same bits and take the
// same branch.  The partials are double-buffered, so one cluster barrier an
// evaluation is enough.  Compiled with -fmad=false and no fast math: each
// element's arithmetic is the plain twin's; the sums are taken in another
// order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "lambda_search.cuh"
#include "shared_memory.cuh"

namespace cg = cooperative_groups;

namespace {

using lsearch::kCluster;
using lsearch::kMaxResident;
using lsearch::kThreads;

template <bool kLbps>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    search_kernel(const float* costs, int num_samples, float lam_min, float lam_max, float param,
                  int iters, float* out) {
  costs += static_cast<size_t>(blockIdx.y) * num_samples;
  out += blockIdx.y;
  extern __shared__ float smem[];
  __shared__ lsearch::Exchange ex;
  cg::cluster_group cluster = cg::this_cluster();
  const float lam = lsearch::cluster_search<kLbps, 1>(costs, num_samples, smem, kMaxResident,
                                                      lam_min, lam_max, param, iters, ex,
                                                      cluster);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) *out = lam;
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

template <bool kLbps>
int launch_search(const float* costs, int num_samples, int batch, float lam_min, float lam_max,
                  float param, int iters, float* out, void* stream) {
  const int chunk = (num_samples + kCluster - 1) / kCluster;
  const size_t shmem = sizeof(float) * static_cast<size_t>(std::min(chunk, kMaxResident));
  const cudaError_t err = fused::allow_shared(search_kernel<kLbps>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  search_kernel<kLbps><<<dim3(kCluster, batch), kThreads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(costs, num_samples, lam_min,
                                                              lam_max, param, iters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// batch scenarios: costs [B, K] -> out [B].
extern "C" int essps_search_batch(const float* costs, int num_samples, int batch, float lam_min,
                                  float lam_max, float target, int iters, float* out,
                                  void* stream) {
  return launch_search<false>(costs, num_samples, batch, lam_min, lam_max, target, iters, out,
                              stream);
}

extern "C" int lbps_search_batch(const float* costs, int num_samples, int batch, float lam_min,
                                 float lam_max, float ratio, int iters, float* out,
                                 void* stream) {
  return launch_search<true>(costs, num_samples, batch, lam_min, lam_max, ratio, iters, out,
                             stream);
}
