// Fused racing MPPI solve, the two phases of the auto-lambda solve, and seed
// regeneration.
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py, make_fused_solve.kernel,
// a Pallas TPU kernel over 1024-sample (8, 128) tiles, in four of its modes:
//
// * racing_fused_solve (run_kernel, single-pass fixed-lambda mode).  Per
//   sample it perturbs and clamps the warm start with Gaussian noise, rolls
//   out T bicycle steps with the MPCC stage cost and the terminal cost, and
//   reduces the softmin partials of its block: max of -c/lambda, sum e, sum
//   e^2 and the numerator sum e * pert over the T*m action slots.
// * racing_costs_dump (run_kernel with costs_only and dump_pert, auto-lambda
//   phase 1).  The same rollout and costs; each sample also writes its
//   clamped perturbations to a dump [2T, K] (slot-major, k fastest, the
//   layout of the noise input), and no partials are reduced.
// * racing_weighted (run_weighted with pert, auto-lambda phase 2).  No
//   rollout: per sample the cost and the dumped perturbations are read back
//   and the block partials are reduced at the searched lambda (a device
//   pointer).
// * racing_regen (run_regen, regen_dump_only mode).  No rollout: the clamped
//   perturbations [n, T, 2] of a list of n sample indices, from the solve's
//   seed and warm start (or its injected noise), for get_top_samples.  The
//   TPU kernel replays all K tiles; Philox keyed on the sample index lets
//   this one regenerate only the rows asked for.
//
// The fixed kernel and phase 2 share block_partials (softmin_partials.cuh,
// also the body of csrc/weighted_update.cu), as the TPU kernel's modes share
// one body; combine_partials (ops/weighted_update.py) merges the blocks in
// torch.  All four modes draw through one Perturbation, so the regenerated
// rows equal phase 1's dump bit for bit.
//
// What bounds them on the H100.  At the flagship (T=50, m=2, K=100,000) the
// fixed solve must move about 1.84 MB: the two 800x800 uint8 grids (1.28 MB),
// the reference and warm start (1.4 KB), and its outputs, costs (400 KB),
// stats (391 x 12 B) and numer (391 x 400 B).  That is 0.55 us at 3.35 TB/s.
// The float work is about 7.3e3 operations a sample (50 steps of dynamics,
// stage cost with its map index, 100 normals, and 100 weighted slots), 7.3e8
// a tick, about 11 us at the 67 TFLOP/s float32 peak (chip_smoke.py counts
// it): operations bound it.  Phase 1 writes the 40 MB dump besides, 12 us of
// bytes, about as long as its operations take.  Phase 2 reads the dump and
// the costs (40.4 MB) and does 4 operations a slot: bytes bound it, 12 us.
// Regeneration writes 8T bytes a row (40 MB for all K, 12 us; 300 rows are
// 120 KB, far below the cost of a launch).
//
// What this simple design does about it.  One thread per sample, blocks of
// 256.  The rollout lives in registers; in the fixed solve the
// perturbations are never stored: the seeded mode draws them from a
// counter-based Philox4x32-10 keyed on (seed, global sample index) with
// counter (pair index / 2), so the numerator pass regenerates the very same
// values after the softmin max is known (noise mode re-reads them,
// slot-major, coalesced).  The dump's writes and reads are coalesced the same
// way.  The two grids are read directly (__ldg) and stay resident in the
// 50 MB L2.  The reference rows and warm start sit in shared memory.  Padded
// threads past K cost 1e30 and weigh 0.  Compiled with -fmad=false and no
// fast math so that it computes the plain twins' arithmetic operation for
// operation.  Regeneration runs one thread a requested row, which walks its
// horizon in order (odd steps reuse the even step's second Philox pair) and
// writes the row's 2T floats.
#include <cuda_runtime.h>

#include <cstdint>

#include "racing_model.cuh"
#include "softmin_partials.cuh"

namespace {

using softmin::block_partials;
using softmin::kBlock;

struct Params {
  const float* x0;     // [4]
  const float* prev;   // [T, 2] warm start
  const float* lam;    // [1]
  const float* xref;   // [T+1, 5] (x, y, sin, cos, v)
  const uint8_t* grid_a;  // obstacle grid [W, H]
  const uint8_t* grid_b;  // lane grid [W, H]
  const float* noise;  // [2T, K] slot-major, already scaled by sigma; null = seeded
  racing::Geometry geo;
  float sigma0, sigma1, u_min0, u_min1, u_max0, u_max1;
  uint32_t seed;
  int horizon, num_samples, threshold;
  float* costs;  // [K]
  float* stats;  // [blocks, 3]: max(-c/lam), sum e, sum e^2 (fixed solve)
  float* numer;  // [blocks, 2T] (fixed solve)
  float* dump;   // [2T, K] clamped perturbations, slot-major (phase 1)
};

// The clamped perturbed actions of one sample, step by step (t ascending);
// next() walks them for block_partials, two slots a step.
struct Perturbation {
  static constexpr int kWidth = 2;
  const Params& p;
  const float* prev;  // shared copy of the warm start
  int k;
  bool inherit;
  float z2a, z2b;  // the second pair of the last Philox draw
  int step;        // next() position

  __device__ Perturbation(const Params& p_, const float* prev_, int k_)
      : p(p_), prev(prev_), k(k_), inherit(k_ < p_.threshold), z2a(0.0f), z2b(0.0f),
        step(0) {}

  __device__ __forceinline__ void next(float* v) { at(step++, &v[0], &v[1]); }

  __device__ __forceinline__ void at(int t, float* u0, float* u1) {
    float z0, z1;
    if (p.noise != nullptr) {
      z0 = p.noise[static_cast<size_t>(2 * t) * p.num_samples + k];
      z1 = p.noise[static_cast<size_t>(2 * t + 1) * p.num_samples + k];
    } else {
      if ((t & 1) == 0) {
        uint4 w = racing::philox4x32_10(make_uint4(static_cast<uint32_t>(t >> 1), 0u, 0u, 0u),
                                        p.seed, static_cast<uint32_t>(k));
        float n0, n1;
        racing::normal_pair_from_bits(w.x, w.y, &n0, &n1);
        racing::normal_pair_from_bits(w.z, w.w, &z2a, &z2b);
        z0 = n0;
        z1 = n1;
      } else {
        z0 = z2a;
        z1 = z2b;
      }
      z0 = z0 * p.sigma0;
      z1 = z1 * p.sigma1;
    }
    float v0 = inherit ? prev[2 * t] + z0 : z0;
    float v1 = inherit ? prev[2 * t + 1] + z1 : z1;
    *u0 = racing::clampf(v0, p.u_min0, p.u_max0);
    *u1 = racing::clampf(v1, p.u_min1, p.u_max1);
  }
};

// The perturbations dumped by phase 1, read back by phase 2, a step at a time.
struct DumpedPerturbation {
  static constexpr int kWidth = 2;
  const float* dump;  // [2T, K]
  int num_samples, k;
  int step;

  __device__ __forceinline__ void next(float* v) {
    v[0] = dump[static_cast<size_t>(2 * step) * num_samples + k];
    v[1] = dump[static_cast<size_t>(2 * step + 1) * num_samples + k];
    ++step;
  }
};

// The reference rows and the warm start, copied to shared memory.
__device__ __forceinline__ void load_reference(const Params& p, float* s_xref, float* s_prev) {
  const int T = p.horizon;
  for (int i = threadIdx.x; i < (T + 1) * 5; i += kBlock) s_xref[i] = p.xref[i];
  for (int i = threadIdx.x; i < 2 * T; i += kBlock) s_prev[i] = p.prev[i];
  __syncthreads();
}

// Rollout of sample k with its stage and terminal costs; with kDump, each
// clamped perturbation is also written to p.dump.
template <bool kDump>
__device__ __forceinline__ float rollout_cost(const Params& p, const float* s_xref,
                                              const float* s_prev, int k) {
  const int T = p.horizon;
  Perturbation pert(p, s_prev, k);
  float x = p.x0[0], y = p.x0[1], th = p.x0[2], v = p.x0[3];
  float acc = 0.0f;
  float u0 = 0.0f, u1 = 0.0f, pu0 = 0.0f, pu1 = 0.0f;
  for (int t = 0; t < T; ++t) {
    float pv0 = u0, pv1 = u1;
    pert.at(t, &u0, &u1);
    if (kDump) {
      p.dump[static_cast<size_t>(2 * t) * p.num_samples + k] = u0;
      p.dump[static_cast<size_t>(2 * t + 1) * p.num_samples + k] = u1;
    }
    // prev_action at t is the action at max(t - 1, 0)
    pu0 = t == 0 ? u0 : pv0;
    pu1 = t == 0 ? u1 : pv1;
    acc = acc + racing::mpcc_stage_cost(x, y, v, u0, u1, pu0, pu1, s_xref + 5 * t,
                                        p.grid_a, p.grid_b, p.geo);
    racing::bicycle_step(x, y, th, v, u0, u1, p.geo);
  }
  // terminal cost: zero action; t and prev_action keep their last values
  return acc + racing::mpcc_stage_cost(x, y, v, 0.0f, 0.0f, pu0, pu1, s_xref + 5 * (T - 1),
                                       p.grid_a, p.grid_b, p.geo);
}

__global__ void __launch_bounds__(kBlock) racing_solve_kernel(Params p) {
  extern __shared__ float smem[];
  const int T = p.horizon;
  float* s_xref = smem;                   // (T+1) * 5
  float* s_prev = s_xref + (T + 1) * 5;   // 2T
  float* s_red = s_prev + 2 * T;          // kWarps
  float* s_numer = s_red + softmin::kWarps;  // kWarps * min(2T, kChunk)
  load_reference(p, s_xref, s_prev);

  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < p.num_samples;
  float cost = 1e30f;  // padding never wins the softmin
  if (valid) {
    cost = rollout_cost<false>(p, s_xref, s_prev, k);
    p.costs[k] = cost;
  }
  // the numerator pass regenerates (or re-reads) each perturbation
  Perturbation pert(p, s_prev, valid ? k : 0);
  block_partials(cost, *p.lam, valid, pert, 2 * T, s_red, s_numer, p.stats, p.numer);
}

__global__ void __launch_bounds__(kBlock) racing_costs_dump_kernel(Params p) {
  extern __shared__ float smem[];
  float* s_xref = smem;                           // (T+1) * 5
  float* s_prev = s_xref + (p.horizon + 1) * 5;   // 2T
  load_reference(p, s_xref, s_prev);
  const int k = blockIdx.x * kBlock + threadIdx.x;
  if (k < p.num_samples) p.costs[k] = rollout_cost<true>(p, s_xref, s_prev, k);
}

__global__ void __launch_bounds__(kBlock) racing_weighted_kernel(
    const float* costs, const float* dump, const float* lam, int horizon, int num_samples,
    float* stats, float* numer) {
  extern __shared__ float smem[];
  float* s_red = smem;                       // kWarps
  float* s_numer = s_red + softmin::kWarps;  // kWarps * min(2T, kChunk)
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < num_samples;
  const float cost = valid ? costs[k] : 1e30f;  // padding never wins the softmin
  DumpedPerturbation src{dump, num_samples, valid ? k : 0, 0};
  block_partials(cost, *lam, valid, src, 2 * horizon, s_red, s_numer, stats, numer);
}

__global__ void __launch_bounds__(kBlock) racing_regen_kernel(Params p, const int64_t* rows,
                                                              int num_rows, float* out) {
  extern __shared__ float smem[];
  float* s_prev = smem;  // 2T
  const int T = p.horizon;
  for (int i = threadIdx.x; i < 2 * T; i += kBlock) s_prev[i] = p.prev[i];
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= num_rows) return;
  const int64_t k = rows[i];
  float* dst = out + static_cast<size_t>(i) * 2 * T;
  if (k < 0 || k >= p.num_samples) {  // no such sample: a row of NaN, never a stray read
    for (int f = 0; f < 2 * T; ++f) dst[f] = __int_as_float(0x7fc00000);
    return;
  }
  Perturbation pert(p, s_prev, static_cast<int>(k));
  for (int t = 0; t < T; ++t) pert.at(t, &dst[2 * t], &dst[2 * t + 1]);
}

// Raise a kernel's dynamic shared-memory limit where it needs more than 48 KB.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The arguments the three entry points share, in the order the wrappers pass them.
#define RACING_PARAMS_ARGS                                                                  \
  const float *x0, const float *prev, const float *lam, const float *xref,                  \
      const uint8_t *grid_a, const uint8_t *grid_b, const float *noise, int width,          \
      int height, float origin_x, float origin_y, float cell_size, float x_lo, float x_hi,  \
      float y_lo, float y_hi, float sigma0, float sigma1, float u_min0, float u_min1,       \
      float u_max0, float u_max1, uint32_t seed, int horizon, int num_samples, int threshold
#define RACING_PARAMS_NAMES                                                                 \
  x0, prev, lam, xref, grid_a, grid_b, noise, width, height, origin_x, origin_y, cell_size, \
      x_lo, x_hi, y_lo, y_hi, sigma0, sigma1, u_min0, u_min1, u_max0, u_max1, seed, horizon, \
      num_samples, threshold

Params make_params(RACING_PARAMS_ARGS) {
  Params p{};
  p.x0 = x0;
  p.prev = prev;
  p.lam = lam;
  p.xref = xref;
  p.grid_a = grid_a;
  p.grid_b = grid_b;
  p.noise = noise;
  p.geo = racing::Geometry{x_lo, x_hi, y_lo, y_hi, origin_x, origin_y, cell_size, width, height};
  p.sigma0 = sigma0;
  p.sigma1 = sigma1;
  p.u_min0 = u_min0;
  p.u_min1 = u_min1;
  p.u_max0 = u_max0;
  p.u_max1 = u_max1;
  p.seed = seed;
  p.horizon = horizon;
  p.num_samples = num_samples;
  p.threshold = threshold;
  return p;
}

int blocks_for(int num_samples) { return (num_samples + kBlock - 1) / kBlock; }

size_t partials_shared_bytes(int horizon) { return softmin::shared_bytes(2 * horizon); }

size_t reference_shared_bytes(int horizon) {
  return sizeof(float) * (static_cast<size_t>(horizon + 1) * 5 + 2 * horizon);
}

}  // namespace

extern "C" int racing_fused_solve(RACING_PARAMS_ARGS, float* costs, float* stats, float* numer,
                                  void* stream) {
  Params p = make_params(RACING_PARAMS_NAMES);
  p.costs = costs;
  p.stats = stats;
  p.numer = numer;
  const size_t shmem = reference_shared_bytes(horizon) + partials_shared_bytes(horizon);
  cudaError_t err = allow_shared(racing_solve_kernel, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  racing_solve_kernel<<<blocks_for(num_samples), kBlock, shmem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int racing_costs_dump(RACING_PARAMS_ARGS, float* costs, float* dump, void* stream) {
  Params p = make_params(RACING_PARAMS_NAMES);
  p.costs = costs;
  p.dump = dump;
  const size_t shmem = reference_shared_bytes(horizon);
  cudaError_t err = allow_shared(racing_costs_dump_kernel, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  racing_costs_dump_kernel<<<blocks_for(num_samples), kBlock, shmem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int racing_weighted(const float* costs, const float* dump, const float* lam,
                               int horizon, int num_samples, float* stats, float* numer,
                               void* stream) {
  const size_t shmem = partials_shared_bytes(horizon);
  cudaError_t err = allow_shared(racing_weighted_kernel, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  racing_weighted_kernel<<<blocks_for(num_samples), kBlock, shmem,
                           static_cast<cudaStream_t>(stream)>>>(costs, dump, lam, horizon,
                                                                 num_samples, stats, numer);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int racing_regen(const float* prev, const float* noise, const int64_t* rows,
                            float sigma0, float sigma1, float u_min0, float u_min1, float u_max0,
                            float u_max1, uint32_t seed, int horizon, int num_samples,
                            int threshold, int num_rows, float* out, void* stream) {
  Params p{};
  p.prev = prev;
  p.noise = noise;
  p.sigma0 = sigma0;
  p.sigma1 = sigma1;
  p.u_min0 = u_min0;
  p.u_min1 = u_min1;
  p.u_max0 = u_max0;
  p.u_max1 = u_max1;
  p.seed = seed;
  p.horizon = horizon;
  p.num_samples = num_samples;
  p.threshold = threshold;
  const size_t shmem = sizeof(float) * 2 * static_cast<size_t>(horizon);
  racing_regen_kernel<<<blocks_for(num_rows), kBlock, shmem, static_cast<cudaStream_t>(stream)>>>(
      p, rows, num_rows, out);
  return static_cast<int>(cudaGetLastError());
}
