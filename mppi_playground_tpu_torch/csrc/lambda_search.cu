// ESSPS and LBPS temperature searches over a resident cost vector.
//
// Replaces: mppi_playground_tpu/ops/lambda_search.py, essps_lambda_fused
// (_essps_kernel, essps_bisect) and lbps_lambda_fused (_lbps_kernel,
// lbps_golden): Pallas TPU kernels that load the padded cost vector into VMEM
// once and run every iteration of the search on it.
//
// * essps_search: 2 + iters evaluations of ESS(lambda) = (sum e)^2 / sum e^2
//   with e = exp(d * (1 / lambda)), d = min(c) - c hoisted out of the loop;
//   bisection towards the target ESS, then the reference's bracket clamps.
// * lbps_search: 2 + iters evaluations of the LBPS objective
//   (sum e*c + range_pen * sqrt(sum e^2)) / sum e with a = -1/lambda and
//   e = exp(c * a - min(c) * a), the exact hoist (a 1-ulp different shift
//   moves golden section to another plateau); range_pen = (max - min) *
//   sqrt(ratio) over the costs.  Golden section carries the surviving value.
//
// The element bodies, hoists and search loops are lambda_search.cuh's, which
// the lambda epilogue of auto-lambda phase 1 (fused_solve.cuh) shares.
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

namespace cg = cooperative_groups;

namespace {

using lsearch::kCluster;
using lsearch::kFull;
using lsearch::kThreads;
using lsearch::kWarps;
constexpr int kMaxResident = 50 * 1024;  // floats of a slice held in shared memory (200 KB)

struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
  __device__ static float identity() { return __int_as_float(0x7f800000); }  // +inf
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
  __device__ static float identity() { return -__int_as_float(0x7f800000); }  // -inf
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
  __device__ static float identity() { return 0.0f; }
};

// Shared state of one CTA for the cluster-wide reductions.
struct Exchange {
  float warp[3][kWarps];  // per-warp partials
  float part[2][3];       // this CTA's partials, double-buffered, read by the cluster
  float total[3];         // the cluster totals
};

// Reduce up to three per-thread values over the whole cluster with Op0..Op2.
// Returns the totals in v, identical in every thread of every CTA.
template <int N, class Op0, class Op1 = Sum, class Op2 = Sum>
__device__ void cluster_reduce(float (&v)[N], Exchange& ex, int& parity,
                               cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto op = [](int j, float a, float b) {
    return j == 0 ? Op0()(a, b) : (j == 1 ? Op1()(a, b) : Op2()(a, b));
  };
  auto identity = [](int j) {
    return j == 0 ? Op0::identity() : (j == 1 ? Op1::identity() : Op2::identity());
  };
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float x = v[j];
    for (int o = 16; o > 0; o >>= 1) x = op(j, x, __shfl_xor_sync(kFull, x, o));
    if (lane == 0) ex.warp[j][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float x = ex.warp[j][lane];  // kWarps == 32: one warp partial a lane
      for (int o = 16; o > 0; o >>= 1) x = op(j, x, __shfl_xor_sync(kFull, x, o));
      if (lane == 0) ex.part[parity][j] = x;
    }
  }
  cluster.sync();  // every CTA's partials are written and visible
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float x = identity(j);
      if (lane < kCluster) x = cluster.map_shared_rank(&ex.part[parity][j], lane)[0];
      float acc = __shfl_sync(kFull, x, 0);
      for (int r = 1; r < kCluster; ++r) acc = op(j, acc, __shfl_sync(kFull, x, r));
      if (lane == 0) ex.total[j] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = ex.total[j];
  parity ^= 1;
}

// This CTA's slice of the costs: [begin, begin + n), the first n_res in shared memory.
struct Slice {
  const float* costs;
  const float* resident;
  int begin, n, n_res;
};

__device__ Slice make_slice(const float* costs, int num_samples, float* smem,
                            cg::cluster_group& cluster) {
  const int chunk = (num_samples + kCluster - 1) / kCluster;
  const int begin = static_cast<int>(cluster.block_rank()) * chunk;
  const int end = min(num_samples, begin + chunk);
  const int n = max(0, end - begin);
  return Slice{costs, smem, begin, n, min(n, kMaxResident)};
}

// Global min (and max) of the costs, exact in any order.
__device__ void min_max(const Slice& sl, Exchange& ex, int& parity, cg::cluster_group& cluster,
                        float* cmin, float* cmax) {
  float v[2] = {Min::identity(), Max::identity()};
  for (int i = threadIdx.x; i < sl.n; i += kThreads) {
    const float c = sl.costs[sl.begin + i];
    v[0] = fminf(v[0], c);
    v[1] = fmaxf(v[1], c);
  }
  cluster_reduce<2, Min, Max>(v, ex, parity, cluster);
  *cmin = v[0];
  *cmax = v[1];
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    essps_kernel(const float* costs, int num_samples, float lam_min, float lam_max,
                 float target, int iters, float* out) {
  extern __shared__ float smem[];
  __shared__ Exchange ex;
  cg::cluster_group cluster = cg::this_cluster();
  int parity = 0;
  const Slice sl = make_slice(costs, num_samples, smem, cluster);
  float cmin, cmax;
  min_max(sl, ex, parity, cluster, &cmin, &cmax);
  // d = min(c) - c, hoisted out of the search
  for (int i = threadIdx.x; i < sl.n_res; i += kThreads) {
    smem[i] = lsearch::essps_shift(cmin, costs[sl.begin + i]);
  }
  __syncthreads();

  auto ess = [&](float lam) {
    const float inv = lsearch::essps_inv(lam);
    float v[2] = {0.0f, 0.0f};
    for (int i = threadIdx.x; i < sl.n; i += kThreads) {
      const float d =
          i < sl.n_res ? sl.resident[i] : lsearch::essps_shift(cmin, costs[sl.begin + i]);
      lsearch::essps_add(d, inv, v);
    }
    cluster_reduce<2, Sum, Sum>(v, ex, parity, cluster);
    return lsearch::essps_value(v);
  };
  const float lam = lsearch::essps_bisect(ess, lam_min, lam_max, target, iters);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) *out = lam;
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    lbps_kernel(const float* costs, int num_samples, float lam_min, float lam_max,
                float ratio, int iters, float* out) {
  extern __shared__ float smem[];
  __shared__ Exchange ex;
  cg::cluster_group cluster = cg::this_cluster();
  int parity = 0;
  const Slice sl = make_slice(costs, num_samples, smem, cluster);
  float cmin, cmax;
  min_max(sl, ex, parity, cluster, &cmin, &cmax);
  const float range_pen = lsearch::lbps_range_penalty(cmin, cmax, ratio);
  for (int i = threadIdx.x; i < sl.n_res; i += kThreads) smem[i] = costs[sl.begin + i];
  __syncthreads();

  auto objective = [&](float lam) {
    const float a = lsearch::lbps_coeff(lam);
    const float shift = cmin * a;
    float v[3] = {0.0f, 0.0f, 0.0f};
    for (int i = threadIdx.x; i < sl.n; i += kThreads) {
      const float c = i < sl.n_res ? sl.resident[i] : costs[sl.begin + i];
      lsearch::lbps_add(c, a, shift, v);
    }
    cluster_reduce<3, Sum, Sum, Sum>(v, ex, parity, cluster);
    return lsearch::lbps_value(v, range_pen);
  };
  const float lam = lsearch::lbps_golden(objective, lam_min, lam_max, iters);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) *out = lam;
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

size_t resident_bytes(int num_samples) {
  const int chunk = (num_samples + kCluster - 1) / kCluster;
  return sizeof(float) * static_cast<size_t>(std::min(chunk, kMaxResident));
}

template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int essps_search(const float* costs, int num_samples, float lam_min, float lam_max,
                            float target, int iters, float* out, void* stream) {
  const size_t shmem = resident_bytes(num_samples);
  cudaError_t err = allow_shared(essps_kernel, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  essps_kernel<<<kCluster, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      costs, num_samples, lam_min, lam_max, target, iters, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lbps_search(const float* costs, int num_samples, float lam_min, float lam_max,
                           float ratio, int iters, float* out, void* stream) {
  const size_t shmem = resident_bytes(num_samples);
  cudaError_t err = allow_shared(lbps_kernel, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbps_kernel<<<kCluster, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      costs, num_samples, lam_min, lam_max, ratio, iters, out);
  return static_cast<int>(cudaGetLastError());
}
