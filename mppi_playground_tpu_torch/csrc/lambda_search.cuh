// The ESSPS and LBPS searches of one thread-block cluster, shared by their two
// routes so that the two cannot drift:
//
// * the standalone search kernels (lambda_search.cu), one cluster of 8 CTAs
//   of 1024 threads over a resident cost vector;
// * the lambda epilogue of auto-lambda phase 1 (fused_solve.cuh), where the
//   last cluster of 8 CTAs of 256 threads to finish its rollouts runs the
//   search.
//
// Both run cluster_search: the same element bodies, the same hoists (ESSPS:
// d = min(c) - c, e = exp(d * (1 / lambda)); LBPS: a = -1 / lambda,
// e = exp(c * a - min(c) * a), range_pen = (max - min) * sqrt(ratio)) and the
// same summation order: CTA r of the cluster takes slice r of ceil(K / 8)
// costs; in each slice 1,024 virtual threads take per-thread strided sums
// (virtual thread u adds costs u, u + 1024, ... in turn); an xor-shuffle tree
// in each virtual warp, then one over the 32 virtual-warp partials; the 8
// slice partials, exchanged over distributed shared memory, added in rank
// order.  A CTA of 1024 threads runs one virtual thread a thread; a CTA of
// 256 runs four (thread t carries virtual threads t, t + 256, t + 512 and
// t + 768, which keeps each virtual warp inside one real warp).  So lambda*
// is bitwise the same on both routes, as in the JAX package, whose two
// routes share essps_bisect and lbps_golden.  Golden section needs this: a
// 1-ulp different hoist or summation order moves it to another plateau of
// the flat LBPS objective.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lsearch {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kThreads = 1024;  // virtual threads of a CTA in the summation order
constexpr int kMaxResident = 50 * 1024;  // floats of a slice held in shared memory (200 KB)
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
  float warp[3][kWarps];       // per-virtual-warp partials
  float part[2][3][kCluster];  // every CTA's partials by rank, double-buffered
  float total[3];              // the cluster totals, for a CTA of 32 warps
};

// Reduce up to three values of each of the CTA's kThreads virtual threads
// over the whole cluster with Op0..Op2.  A CTA of kThreads / kV threads
// passes v[q] for its virtual thread threadIdx.x + q * blockDim.x.  The
// totals land in out, identical in every thread of every CTA.  Each CTA
// stores its partials into every CTA's exchange (distributed shared memory)
// before the one cluster barrier; after it, the 8 partials are added in rank
// order from the CTA's own shared memory.  The double buffer keeps a fast
// CTA's next stores off partials a slow CTA is still reading.
template <int kV, int N, class Op0, class Op1 = Sum, class Op2 = Sum>
__device__ void cluster_reduce(float (&v)[kV][N], float (&out)[N], Exchange& ex,
                               int& parity, cg::cluster_group& cluster) {
  constexpr int kRealWarps = kWarps / kV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto op = [](int j, float a, float b) {
    return j == 0 ? Op0()(a, b) : (j == 1 ? Op1()(a, b) : Op2()(a, b));
  };
  auto identity = [](int j) {
    return j == 0 ? Op0::identity() : (j == 1 ? Op1::identity() : Op2::identity());
  };
#pragma unroll
  for (int q = 0; q < kV; ++q) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float x = v[q][j];
      for (int o = 16; o > 0; o >>= 1) x = op(j, x, __shfl_xor_sync(kFull, x, o));
      if (lane == 0) ex.warp[j][q * kRealWarps + warp] = x;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned rank = cluster.block_rank();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float x = ex.warp[j][lane];  // kWarps == 32: one virtual-warp partial a lane
      for (int o = 16; o > 0; o >>= 1) x = op(j, x, __shfl_xor_sync(kFull, x, o));
      // every lane holds the CTA's partial; lane r stores it into CTA r
      if (lane < kCluster) cluster.map_shared_rank(&ex.part[parity][j][0], lane)[rank] = x;
    }
  }
  cluster.sync();  // every CTA's partials are in every CTA's exchange
  // The 8 partials in rank order: a CTA of 8 warps has each warp add them
  // (no second CTA barrier); one of 32 warps has warp 0 add them and hand the
  // totals on, which measured faster at that size (PERF.md).
  if (kV > 1 || warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x = lane < kCluster ? ex.part[parity][j][lane] : identity(j);
      float acc = __shfl_sync(kFull, x, 0);
      for (int r = 1; r < kCluster; ++r) acc = op(j, acc, __shfl_sync(kFull, x, r));
      out[j] = acc;
      if (kV == 1 && lane == 0) ex.total[j] = acc;
    }
  }
  if (kV == 1) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = ex.total[j];
  }
  parity ^= 1;
}

// This CTA's slice of the costs, [begin, begin + n), the first n_res of it
// also in shared memory.  In the epilogue other CTAs of the same grid wrote
// the costs; the searching threads read them only after their ticket and a
// fence (an acquire at device scope), so plain loads see them, and every
// evaluation after the first finds the slice in this SM's L1.
struct Slice {
  const float* costs;
  float* resident;
  int begin, n, n_res;

  __device__ __forceinline__ float cost(int i) const { return costs[begin + i]; }
};

__device__ inline Slice make_slice(const float* costs, int num_samples, float* smem,
                                   int max_resident, cg::cluster_group& cluster) {
  const int chunk = (num_samples + kCluster - 1) / kCluster;
  const int begin = static_cast<int>(cluster.block_rank()) * chunk;
  const int n = max(0, min(num_samples, begin + chunk) - begin);
  return Slice{costs, smem, begin, n, min(n, max_resident)};
}

// Calls f(q, i) for each element i of a slice of n, in the order above:
// virtual thread q * (kThreads / kV) + threadIdx.x takes its elements in
// turn.  Whole rounds of kThreads (every virtual thread has an element) are
// unrolled, so that the loads and exps of several rounds are in flight.
template <int kV, class F>
__device__ __forceinline__ void for_each_element(int n, F f) {
  constexpr int kReal = kThreads / kV;
  const int t = static_cast<int>(threadIdx.x);
  int base = 0;
#pragma unroll 4
  for (; base + kThreads <= n; base += kThreads) {
#pragma unroll
    for (int q = 0; q < kV; ++q) f(q, base + q * kReal + t);
  }
#pragma unroll
  for (int q = 0; q < kV; ++q) {  // the last, partial round
    const int i = base + q * kReal + t;
    if (i < n) f(q, i);
  }
}

// Each virtual thread's sums over the slice: elem(i, acc) adds the terms of
// slice element i.
template <int kV, int N, class Elem>
__device__ __forceinline__ void slice_sums(const Slice& sl, Elem elem, float (&v)[kV][N]) {
#pragma unroll
  for (int q = 0; q < kV; ++q) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[q][j] = 0.0f;
  }
  for_each_element<kV>(sl.n, [&](int q, int i) { elem(i, v[q]); });
}

// lambda* of ESSPS (kLbps false) or LBPS over costs[0, K) by one cluster of
// kCluster CTAs of kThreads / kV threads; every thread of the cluster calls
// it and gets the same bits.  param is the ESSPS target ESS or the LBPS ratio
// (1 - delta) / delta.  smem holds up to max_resident floats of the CTA's
// slice (ESSPS: the shifted costs; LBPS: the costs); the rest is read from
// global memory at every evaluation.
template <bool kLbps, int kV>
__device__ float cluster_search(const float* costs, int num_samples, float* smem,
                                int max_resident, float lam_min, float lam_max, float param,
                                int iters, Exchange& ex, cg::cluster_group& cluster) {
  constexpr int kReal = kThreads / kV;
  int parity = 0;
  const Slice sl = make_slice(costs, num_samples, smem, max_resident, cluster);
  float cmin, cmax;
  {  // global min and max of the costs (exact in any order); the resident
     // part of the slice is copied to shared memory on the way
    float v[kV][2];
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      v[q][0] = Min::identity();
      v[q][1] = Max::identity();
    }
    for_each_element<kV>(sl.n, [&](int q, int i) {
      const float c = sl.cost(i);
      if (i < sl.n_res) sl.resident[i] = c;
      v[q][0] = fminf(v[q][0], c);
      v[q][1] = fmaxf(v[q][1], c);
    });
    float t[2];
    cluster_reduce<kV, 2, Min, Max>(v, t, ex, parity, cluster);
    cmin = t[0];
    cmax = t[1];
  }
  if (!kLbps) {
    // d = min(c) - c, hoisted out of the search
    for (int i = threadIdx.x; i < sl.n_res; i += kReal) {
      sl.resident[i] = essps_shift(cmin, sl.resident[i]);
    }
    __syncthreads();
    auto ess = [&](float lam) {
      const float inv = essps_inv(lam);
      float v[kV][2], t[2];
      slice_sums<kV>(
          sl,
          [&](int i, float (&acc)[2]) {
            const float d = i < sl.n_res ? sl.resident[i] : essps_shift(cmin, sl.cost(i));
            essps_add(d, inv, acc);
          },
          v);
      cluster_reduce<kV, 2, Sum, Sum>(v, t, ex, parity, cluster);
      return essps_value(t);
    };
    return essps_bisect(ess, lam_min, lam_max, param, iters);
  }
  const float range_pen = lbps_range_penalty(cmin, cmax, param);
  auto objective = [&](float lam) {
    const float a = lbps_coeff(lam);
    const float shift = cmin * a;
    float v[kV][3], t[3];
    slice_sums<kV>(
        sl,
        [&](int i, float (&acc)[3]) {
          lbps_add(i < sl.n_res ? sl.resident[i] : sl.cost(i), a, shift, acc);
        },
        v);
    cluster_reduce<kV, 3, Sum, Sum, Sum>(v, t, ex, parity, cluster);
    return lbps_value(t, range_pen);
  };
  return lbps_golden(objective, lam_min, lam_max, iters);
}

}  // namespace lsearch
