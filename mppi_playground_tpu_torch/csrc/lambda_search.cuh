// The ESSPS and LBPS searches, shared by their two routes so that the two
// cannot drift:
//
// * the standalone search kernels (lambda_search.cu), one cluster of 8 CTAs
//   of 1024 threads over a resident cost vector;
// * the lambda epilogue of auto-lambda phase 1 (fused_solve.cuh), where the
//   last block of the rollout grid runs the search.
//
// Both evaluate each cost with the same element bodies, the same hoists
// (ESSPS: d = min(c) - c, e = exp(d * (1 / lambda)); LBPS: a = -1 / lambda,
// e = exp(c * a - min(c) * a), range_pen = (max - min) * sqrt(ratio)) and
// sum in the same order: 8 slices of ceil(K / 8) costs; in each slice 1,024
// per-thread strided sums (thread v adds costs v, v + 1024, ...); an
// xor-shuffle tree in each warp, then one over the 32 warp partials; the 8
// slice partials added in rank order.  block_cluster_sum reproduces that
// order in one block of any whole number of warps (at least 8): each warp
// takes virtual warps of 32 virtual threads in turn and runs the same trees.
// So lambda* is bitwise the same on both routes, as in the JAX package,
// whose two routes share essps_bisect and lbps_golden.  Golden section
// needs this: a 1-ulp different hoist or summation order moves it to
// another plateau of the flat LBPS objective.
#pragma once

#include <cuda_runtime.h>

namespace lsearch {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ESSPS: the lambda-independent shift, the coefficient, one cost's terms and
// ESS = (sum e)^2 / sum e^2.
__device__ __forceinline__ float essps_shift(float cmin, float c) { return cmin - c; }
__device__ __forceinline__ float essps_inv(float lam) { return 1.0f / lam; }
__device__ __forceinline__ void essps_add(float d, float inv, float (&v)[2]) {
  const float e = expf(d * inv);
  v[0] += e;
  v[1] += e * e;
}
__device__ __forceinline__ float essps_value(const float (&v)[2]) { return v[0] * v[0] / v[1]; }

// LBPS: a = -1/lambda and the exact shift min(c) * a, one cost's terms, and
// the objective (sum e*c + range_pen * sqrt(sum e^2)) / sum e.
__device__ __forceinline__ float lbps_coeff(float lam) { return -1.0f / lam; }
__device__ __forceinline__ void lbps_add(float c, float a, float shift, float (&v)[3]) {
  const float e = expf(c * a - shift);
  v[0] += e;
  v[1] += e * e;
  v[2] += e * c;
}
__device__ __forceinline__ float lbps_value(const float (&v)[3], float range_pen) {
  return (v[2] + range_pen * sqrtf(v[1])) / v[0];
}
__device__ __forceinline__ float lbps_range_penalty(float cmin, float cmax, float ratio) {
  return (cmax - cmin) * sqrtf(ratio);
}

// Bisection on ESS(lambda) = target over [lam_min, lam_max], then the
// reference's bracket clamps.  ess(lam) must give every thread the same bits.
template <class Ess>
__device__ float essps_bisect(Ess ess, float lam_min, float lam_max, float target, int iters) {
  const float ess_at_min = ess(lam_min);
  const float ess_at_max = ess(lam_max);
  float a = lam_min, b = lam_max;
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (a + b);
    const bool below = ess(mid) < target;  // the root lies above mid
    a = below ? mid : a;
    b = below ? b : mid;
  }
  const float root = 0.5f * (a + b);
  return target <= ess_at_min ? lam_min : (target >= ess_at_max ? lam_max : root);
}

// Golden section on the LBPS objective, carrying the surviving value.
template <class Objective>
__device__ float lbps_golden(Objective objective, float lam_min, float lam_max, int iters) {
  const float invphi = static_cast<float>(0.6180339887498949);  // (sqrt(5) - 1) / 2
  float a = lam_min, b = lam_max;
  float c = b - (b - a) * invphi;
  float d = a + (b - a) * invphi;
  float fc = objective(c);
  float fd = objective(d);
  for (int it = 0; it < iters; ++it) {
    const bool shrink_right = fc < fd;  // the minimum lies in [a, d]
    const float new_a = shrink_right ? a : c;
    const float new_b = shrink_right ? d : b;
    const float fresh_lo = new_b - (new_b - new_a) * invphi;
    const float fresh_hi = new_a + (new_b - new_a) * invphi;
    const float x = shrink_right ? fresh_lo : fresh_hi;
    const float fx = objective(x);
    // the surviving interior point keeps its value
    const float new_c = shrink_right ? x : d;
    const float new_fc = shrink_right ? fx : fd;
    const float new_d = shrink_right ? c : x;
    const float new_fd = shrink_right ? fc : fx;
    a = new_a;
    b = new_b;
    c = new_c;
    fc = new_fc;
    d = new_d;
    fd = new_fd;
  }
  return 0.5f * (a + b);
}

// The warp's sum of x by the xor-shuffle butterfly; every lane gets the same
// bits (a + b == b + a).
__device__ __forceinline__ float warp_tree_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One block's sums of N per-cost terms over costs[0, K), in the cluster
// kernels' order (see the top of this file).  elem(c, acc) adds one cost's
// terms to acc.  The costs are read past L1 (__ldcg): other blocks of the
// same grid wrote them.  Every thread of the block calls it and gets the
// same totals.
template <int N, class Elem>
__device__ void block_cluster_sum(const float* costs, int num_samples, Elem elem,
                                  float (&out)[N]) {
  __shared__ float s_part[N][kCluster * kWarps];  // [slice * 32 + virtual warp]
  __shared__ float s_slice[N][kCluster];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int chunk = (num_samples + kCluster - 1) / kCluster;
  for (int idx = warp; idx < kCluster * kWarps; idx += warps) {
    const int begin = (idx / kWarps) * chunk;
    const int n = max(0, min(num_samples, begin + chunk) - begin);
    float acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.0f;
    for (int i = (idx % kWarps) * 32 + lane; i < n; i += kThreads) {
      elem(__ldcg(costs + begin + i), acc);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x = warp_tree_sum(acc[j]);
      if (lane == 0) s_part[j][idx] = x;
    }
  }
  __syncthreads();
  if (warp < kCluster) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x = warp_tree_sum(s_part[j][warp * kWarps + lane]);
      if (lane == 0) s_slice[j][warp] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float total = s_slice[j][0];
    for (int r = 1; r < kCluster; ++r) total = total + s_slice[j][r];
    out[j] = total;
  }
  __syncthreads();  // the next call overwrites s_part and s_slice
}

// One block's min and max of costs[0, K) (exact in any order), read past L1.
__device__ inline void block_min_max(const float* costs, int num_samples, float* cmin,
                                     float* cmax) {
  __shared__ float s_min[32], s_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float lo = __int_as_float(0x7f800000), hi = -__int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < num_samples; i += blockDim.x) {
    const float c = __ldcg(costs + i);
    lo = fminf(lo, c);
    hi = fmaxf(hi, c);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if (lane == 0) {
    s_min[warp] = lo;
    s_max[warp] = hi;
  }
  __syncthreads();
  lo = s_min[0];
  hi = s_max[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
    lo = fminf(lo, s_min[w]);
    hi = fmaxf(hi, s_max[w]);
  }
  *cmin = lo;
  *cmax = hi;
  __syncthreads();
}

// lambda* of ESSPS (kLbps false) or LBPS over costs[0, K) by one block.
// param is the ESSPS target ESS or the LBPS ratio (1 - delta) / delta.
template <bool kLbps>
__device__ float block_search(const float* costs, int num_samples, float lam_min, float lam_max,
                              float param, int iters) {
  float cmin, cmax;
  block_min_max(costs, num_samples, &cmin, &cmax);
  if (!kLbps) {
    auto ess = [&](float lam) {
      const float inv = essps_inv(lam);
      float v[2];
      block_cluster_sum<2>(
          costs, num_samples,
          [&](float c, float (&acc)[2]) { essps_add(essps_shift(cmin, c), inv, acc); }, v);
      return essps_value(v);
    };
    return essps_bisect(ess, lam_min, lam_max, param, iters);
  }
  const float range_pen = lbps_range_penalty(cmin, cmax, param);
  auto objective = [&](float lam) {
    const float a = lbps_coeff(lam);
    const float shift = cmin * a;
    float v[3];
    block_cluster_sum<3>(
        costs, num_samples, [&](float c, float (&acc)[3]) { lbps_add(c, a, shift, acc); }, v);
    return lbps_value(v, range_pen);
  };
  return lbps_golden(objective, lam_min, lam_max, iters);
}

}  // namespace lsearch
