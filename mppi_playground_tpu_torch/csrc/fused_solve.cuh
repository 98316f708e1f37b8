// Fused MPPI solve, the two phases of the auto-lambda solve, the lambda
// epilogue of phase 1, seed regeneration and the nominal re-roll, templated
// on a model plug.
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py, make_fused_solve.kernel,
// a Pallas TPU kernel over 1024-sample (8, 128) tiles that every model
// enters through a FusedTask, in its modes:
//
// * fused_solve_kernel (run_kernel, single-pass fixed-lambda mode).  Per
//   sample it perturbs and clamps the warm start with Gaussian noise, rolls
//   out T model steps with the stage and terminal cost, and reduces the
//   softmin partials of its block: max of -c/lambda, sum e, sum e^2 and the
//   numerator sum e * pert over the T*m action slots.
// * costs_dump_kernel (run_kernel with costs_only and dump_pert, auto-lambda
//   phase 1).  The same rollout and costs; each sample also writes its
//   clamped perturbations to a dump [T*m, K] (slot-major, k fastest, the
//   layout of the noise input), and no partials are reduced.
// * costs_dump_lambda_kernel (run_kernel with lambda_mode, row 4 of
//   PERF.md's table, and _block_min_max_valid).  Phase 1 plus the ESSPS or
//   LBPS search in the same launch, in clusters of 8 CTAs: the cluster that
//   finishes last runs the search of lambda_search.cuh over the K costs and
//   writes lambda*.
// * weighted_kernel (fused_solve.cu; run_weighted with pert, phase 2).  No
//   rollout: per sample the cost and the dumped perturbations are read back
//   and the block partials are reduced at the searched lambda (a device
//   pointer).  It depends on the model only through T*m.
// * regen_rollout_kernel (run_regen, regen_dump_only mode, and the re-roll
//   of its rows that get_top_samples runs after it).  The clamped
//   perturbations of a list of n sample indices, from the solve's seed and
//   warm start (or its injected noise), rolled out through the model: the
//   states [n, T+1, n_x] of get_top_samples in one launch, or, on the
//   actions-only plug, the perturbations [n, T, m] alone.
//
// The re-roll (make_fused_reroll) and the tick's tail after these kernels are
// in tick_tail.cuh.
// A model plug is one struct with static members:
//   kN, kM, kRefWidth, kPre   state and action widths, the floats of its
//                             per-tick reference row (0: none), and the
//                             action-only terms a step prepares;
//   Args, make_args(floats, ints, grid0, grid1)
//                             its per-launch arguments, built on the host
//                             from the model floats and ints and the two
//                             uint8 grids (or null) the wrapper passes;
//   prepare(u, p, args), step_prepared(x, p, args)
//                             a step (model_step below): the action-only
//                             terms p[kPre] of u[kM], then x[kN] in place;
//   stage_cost(x, u, pu, ref, args)
//                             the stage cost at state x, action u, previous
//                             action pu, ref the step's reference row in
//                             shared memory (kRefWidth floats).
// The bundled plugs are in racing_model.cuh, unicycle_model.cuh,
// danger_zone_model.cuh and classic_models.cuh; each model's source
// (fused_<model>.cu) instantiates the rollout kernels with
// FUSED_MODEL_ENTRY_POINTS; fused_solve.cu holds phase 2 and regeneration
// alone; reroll.cu the re-roll and the top rows' roll-out of every model
// (tail_entry_points.cuh).  A user's plug (ops/fused_solve.py ModelPlug) is
// a generated unit that includes this header and tail_entry_points.cuh, then
// the plug's source, then both macros on it (ops/cuda_build.py).  Any kM
// runs, within T*kM <= 1024.
//
// The noise.  With injected noise ([T*m, K], already scaled by sigma) every
// mode reads it.  Seeded, action slot f = t*m + j of sample k takes normal
// f mod 4 of Philox4x32-10 with counter (f div 4, 0, 0, 0) and key (seed, k),
// Box–Muller on 24 bits of words (x, y) for normals 0 and 1 and (z, w) for 2
// and 3, so the draws depend neither on the launch geometry nor on the mode:
// the regenerated rows equal phase 1's dump bit for bit.  Where kM divides 4
// a step's slots lie in one Philox block; otherwise (m = 3, or m > 4) a step
// may straddle two, and the slot that opens a block draws it (Perturbation).
//
// What bounds them on the H100, at the flagship (racing, T=50, m=2,
// K=100,000): the fixed solve must move about 1.84 MB (the two 800x800 uint8
// grids, the reference and warm start, costs and partials), 0.55 us at
// 3.35 TB/s, and does about 7.3e3 float operations a sample, 11 us at the
// 67 TFLOP/s float32 peak: operations bound it.  Phase 1 writes the 40 MB
// dump besides, 12 us of bytes.  Phase 2 reads the dump and the costs and
// does 4 operations a slot: bytes bound it.  The lighter models (navigation
// at T=30, K=3,000; the classic models) are far below a launch's cost at
// their users' sizes; chip_smoke.py computes each bound from the shapes.
//
// What this design does about it.  One thread per sample, blocks of 256.
// The state lives in registers (kN floats; danger zone's 7 included).  The
// time goes to issued instructions (on an H100 twice the samples take 1.8x
// the time):
// at the flagship the draws take over a third of phase 1 (Box–Muller most),
// the map query a fifth (PERF.md, the splits of rows 1 and 3).  So each
// instruction the rollout can drop without changing a bit goes: the
// Box–Muller radius skips logf's and sqrtf's special-input paths, the cell
// index takes the quotient from the reciprocal and rounds and converts in
// one instruction (device_math.cuh; exact_checks.cu sweeps each on every
// input), and the loop takes two steps a trip, so that a step's Philox parity
// is known at compile time.  In the fixed solve each sample's clamped
// actions are drawn once where shared memory allows: the rollout stores them
// in a tile [slots, 256] that the numerator pass reads back after the
// softmin max is known, as many slots as keep the CTAs an SM the grid needs
// resident (about two thirds of racing's 100 at K=100,000, three CTAs an SM;
// all of them where the grid gives an SM one CTA); the pass regenerates the
// rest, the very same values (noise mode re-reads them, slot-major,
// coalesced).  The dump's writes and reads are
// coalesced the same way.  The grids are read directly (__ldg) and stay
// resident in L2.  The reference rows and warm start sit in shared memory.
// Padded threads past K cost 1e30 and weigh 0 (on a shard of a sample-sharded
// solve, its samples past the solve's K write cost 1e30 and zero actions, the
// JAX package's padding).  Compiled with -fmad=false and
// no fast math so that it computes the plain twins' arithmetic operation for
// operation.  The lambda epilogue is a last-cluster-done pattern: phase 1
// launches as clusters of 8 CTAs, as many as the card holds at once, each CTA
// rolling out an equal share of the samples (CTAs past K write nothing); each
// CTA writes its costs and dump and fences; after a cluster barrier one
// thread of rank 0 takes a ticket for the whole cluster (one atomicAdd on an
// int the solver allocates once) and tells every CTA of its cluster through
// distributed shared memory whether it was last.  The last cluster runs the
// standalone search kernels' own body (lambda_search.cuh cluster_search, four
// virtual threads a thread), each CTA on its slice of the costs, copied into
// the shared memory every CTA of the launch reserves for it (up to 200 KB),
// then resets the ticket for the next launch or graph replay.  A fleet's
// launch holds a ticket a scenario (int [B], scenario b on blockIdx.y): the
// last cluster of scenario b searches b's costs alone.  So the search
// costs one cluster's evaluations, as on the standalone route, and saves that
// route's launch and cost reload; but a cluster launch slows the rollouts
// themselves by a quarter to a third at K=100,000 (PERF.md), so the
// solver takes this route only up to the K where it is faster.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "device_math.cuh"
#include "lambda_search.cuh"
#include "shared_memory.cuh"
#include "softmin_partials.cuh"

namespace fused {

using softmin::block_partials;
using softmin::kBlock;

// What the sampling of perturbations reads: warm start, noise, bounds, seed.
// The seed word lives in device memory (a solver's key, core/config.py), so
// that a CUDA graph of the tick draws the stream of the tick it replays; each
// CTA loads it once (load_seed).  A batched launch (a fleet of scenarios on
// gridDim.y) reads scenario b's seed word seed_stride words after scenario
// b - 1's (3 for a batch of keys [B, 3]).
//
// A shard of a sample-sharded solve (parallel/sharded.py) rolls out the
// num_samples samples from global index sample_offset (a multiple of kBlock)
// of a solve of total_samples.  Two indices are kept apart: the local k
// addresses memory (the costs, the dump, the noise [T*kM, num_samples], the
// block's partial row), and the global sample_offset + k keys Philox, decides
// inheritance (< threshold) and validity (< total_samples).  A sample whose
// global index is past total_samples is absent from every partial, as in the
// ragged last block of the whole launch.  The whole launch is offset 0 and
// total_samples = num_samples.
template <int kM>
struct Sampling {
  const float* prev;      // [T, kM] warm start
  const float* noise;     // [T*kM, K] slot-major, already scaled by sigma; null = seeded
  const uint32_t* seed;   // [1] the tick's seed word (null: noise mode, where none is read)
  float sigma[kM], u_min[kM], u_max[kM];
  int horizon, num_samples, threshold;
  int seed_stride;
  int sample_offset, total_samples;

  // Whether local sample k is one of the solve's samples.
  __device__ __forceinline__ bool valid(int k) const {
    return k < num_samples && sample_offset + k < total_samples;
  }

  // Scenario b of a batched launch (gridDim.y scenarios): the warm start
  // [B, T, kM], the noise [B, T*kM, K] and the seed words moved on by b of
  // their own sizes; the bounds and the counts are shared.
  __device__ __forceinline__ Sampling scenario(int b) const {
    Sampling q = *this;
    if (b == 0) return q;
    const size_t n = static_cast<size_t>(b), slots = static_cast<size_t>(kM) * horizon;
    q.prev += n * slots;
    if (noise != nullptr) q.noise += n * slots * num_samples;
    if (seed != nullptr) q.seed += n * seed_stride;
    return q;
  }
};

// Sampling from the wrapper's bounds array (sigma, u_min, u_max; kM each);
// total_samples < 0 means num_samples (the whole launch).
template <int kM>
Sampling<kM> make_sampling(const float* prev, const float* noise, const float* bounds,
                           const uint32_t* seed, int horizon, int num_samples,
                           int threshold, int seed_stride = 0, int sample_offset = 0,
                           int total_samples = -1) {
  Sampling<kM> s{};
  s.seed_stride = seed_stride;
  s.sample_offset = sample_offset;
  s.total_samples = total_samples < 0 ? num_samples : total_samples;
  s.prev = prev;
  s.noise = noise;
  for (int j = 0; j < kM; ++j) {
    s.sigma[j] = bounds[j];
    s.u_min[j] = bounds[kM + j];
    s.u_max[j] = bounds[2 * kM + j];
  }
  s.seed = seed;
  s.horizon = horizon;
  s.num_samples = num_samples;
  s.threshold = threshold;
  return s;
}

// One model step: its action-only terms, then the step from them.
template <class Model>
__device__ __forceinline__ void model_step(float (&x)[Model::kN], const float (&u)[Model::kM],
                                           const typename Model::Args& a) {
  float p[Model::kPre];
  Model::prepare(u, p, a);
  Model::step_prepared(x, p, a);
}

template <class Model>
struct Params {
  Sampling<Model::kM> s;
  const float* x0;   // [kN]
  const float* lam;  // [1]
  const float* ref;  // [T+1, kRefWidth], or null
  typename Model::Args args;
  float* costs;  // [K]
  float* stats;  // [blocks, 3]: max(-c/lam), sum e, sum e^2 (fixed solve)
  float* numer;  // [blocks, T*m] (fixed solve)
  float* dump;   // [T*m, K] clamped perturbations, slot-major (phase 1)

  // Scenario b of a batched launch (gridDim.y scenarios, each array above
  // [B, ...]): every per-scenario array moved on by b of its own size; the
  // bounds, the model's constants and its grids are shared.  Scenario 0 is
  // the launch of one scenario, unchanged, so scenario b's outputs are bit
  // for bit a single launch's on its inputs.
  __device__ __forceinline__ Params scenario(int b) const {
    Params q = *this;
    if (b == 0) return q;
    const size_t n = static_cast<size_t>(b), T = s.horizon, K = s.num_samples;
    const size_t slots = Model::kM * T, blocks = (K + softmin::kBlock - 1) / softmin::kBlock;
    q.s = s.scenario(b);
    q.x0 += n * Model::kN;
    if (lam != nullptr) q.lam += n;
    if (ref != nullptr) q.ref += n * (T + 1) * Model::kRefWidth;
    if (costs != nullptr) q.costs += n * K;
    if (stats != nullptr) q.stats += n * blocks * 3;
    if (numer != nullptr) q.numer += n * blocks * slots;
    if (dump != nullptr) q.dump += n * slots * K;
    return q;
  }
};

__device__ __forceinline__ float pick(float z0, float z1, float z2, float z3, int r) {
  return r == 0 ? z0 : (r == 1 ? z1 : (r == 2 ? z2 : z3));
}

// The clamped perturbed actions of one sample, step by step: every caller
// walks t = 0, 1, 2, ... in order (or starts on a step that opens a Philox
// block: TiledPerturbation), so the slot that opens a block draws it and the
// later slots of that block, in this step or the next, reuse its normals.
// next() walks them for block_partials, kM slots a step.
template <int kM>
struct Perturbation {
  static constexpr int kWidth = kM;
  const Sampling<kM>& s;
  const float* prev;  // shared copy of the warm start
  int k;              // the local index: the noise's column
  uint32_t gk;        // the global index sample_offset + k: Philox's key
  uint32_t seed;      // the CTA's copy of the seed word (load_seed)
  bool inherit;
  float z0, z1, z2, z3;    // the normals of the current Philox block
  int step;                // next() position

  __device__ Perturbation(const Sampling<kM>& s_, const float* prev_, int k_, uint32_t seed_)
      : s(s_), prev(prev_), k(k_), gk(static_cast<uint32_t>(s_.sample_offset + k_)), seed(seed_),
        inherit(s_.sample_offset + k_ < s_.threshold), z0(0.0f), z1(0.0f), z2(0.0f), z3(0.0f),
        step(0) {}

  __device__ __forceinline__ void next(float* v) { at(step++, v); }

  // The four normals of Philox block q into z0..z3.
  __device__ __forceinline__ void draw(int q) {
    const uint4 w =
        devmath::philox4x32_10(make_uint4(static_cast<uint32_t>(q), 0u, 0u, 0u), seed, gk);
    devmath::normal_pair_from_bits(w.x, w.y, &z0, &z1);
    devmath::normal_pair_from_bits(w.z, w.w, &z2, &z3);
  }

  // One branch on the noise mode a step, so that the compiler does not
  // predicate the noise loads into the seeded path; then the draw on a bit
  // test of the step's first slot (no stored counter, so z0 and z1 of m=2
  // live only in the even step that draws them).  Where kM does not divide
  // 4, the test is on each slot: slot f draws block f / 4 where f mod 4 == 0,
  // and z0..z3 carry into the next step.
  __device__ __forceinline__ void at(int t, float* u) {
    const int f0 = t * kM;  // this step's first slot
    float z[kM];
    if (s.noise != nullptr) {
#pragma unroll
      for (int j = 0; j < kM; ++j) z[j] = s.noise[static_cast<size_t>(f0 + j) * s.num_samples + k];
    } else {
      float n[kM];
      if constexpr (4 % kM == 0) {  // all kM slots lie in block f0 / 4
        if ((f0 & 3) == 0) {
          draw(f0 >> 2);
          if constexpr (kM == 2) {  // an even step: the first pair
            n[0] = z0;
            n[1] = z1;
          }
        } else if constexpr (kM == 2) {  // an odd step: the pair drawn before
          n[0] = z2;
          n[1] = z3;
        }
        if constexpr (kM != 2) {
#pragma unroll
          for (int j = 0; j < kM; ++j) n[j] = pick(z0, z1, z2, z3, (f0 + j) & 3);
        }
      } else {  // a step may straddle two blocks
#pragma unroll
        for (int j = 0; j < kM; ++j) {
          const int f = f0 + j;
          if ((f & 3) == 0) draw(f >> 2);
          n[j] = pick(z0, z1, z2, z3, f & 3);
        }
      }
#pragma unroll
      for (int j = 0; j < kM; ++j) z[j] = n[j] * s.sigma[j];
    }
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      const float v = inherit ? prev[f0 + j] + z[j] : z[j];
      u[j] = devmath::clampf(v, s.u_min[j], s.u_max[j]);
    }
  }
};

// The perturbations dumped by phase 1, read back by phase 2, a slot at a time.
struct DumpedPerturbation {
  static constexpr int kWidth = 1;
  const float* dump;  // [slots, K]
  int num_samples, k;
  int slot;

  __device__ __forceinline__ void next(float* v) {
    v[0] = dump[static_cast<size_t>(slot) * num_samples + k];
    ++slot;
  }
};

// The seed word, read from device memory by one thread of the CTA into
// s_seed; the CTA's threads read it after the caller's __syncthreads.
template <int kM>
__device__ __forceinline__ void load_seed(const Sampling<kM>& s, uint32_t* s_seed) {
  if (threadIdx.x == 0) *s_seed = s.seed == nullptr ? 0u : *s.seed;
}

// The reference rows, the warm start and the seed word, copied to shared
// memory; returns the seed word.
template <class Model>
__device__ __forceinline__ uint32_t load_reference(const Params<Model>& p, float* s_ref,
                                                   float* s_prev) {
  __shared__ uint32_t s_seed;
  const int T = p.s.horizon;
  load_seed(p.s, &s_seed);
  if (Model::kRefWidth > 0) {
    for (int i = threadIdx.x; i < (T + 1) * Model::kRefWidth; i += kBlock) s_ref[i] = p.ref[i];
  }
  for (int i = threadIdx.x; i < Model::kM * T; i += kBlock) s_prev[i] = p.s.prev[i];
  __syncthreads();
  return s_seed;
}

template <class Model>
size_t reference_shared_bytes(int horizon) {
  return sizeof(float) * (static_cast<size_t>(horizon + 1) * Model::kRefWidth +
                          static_cast<size_t>(Model::kM) * horizon);
}

// Slots the fused solve's numerator tile holds a multiple of: lcm(4, kM),
// so that each step lies wholly in the tile or wholly past it, and
// regeneration past the tile starts on a Philox block.
constexpr int tile_unit(int m) { return m % 4 == 0 ? m : (m % 2 == 0 ? 2 * m : 4 * m); }

// The clamped perturbations of one sample for the fixed solve's numerator
// pass, kM slots a step: slots below tile_slots from the tile the rollout
// stored them in ([tile_slots, kBlock] in shared memory, this thread's
// column), the rest regenerated.  tile_slots is all the slots or a multiple
// of tile_unit(kM).
template <int kM>
struct TiledPerturbation {
  static constexpr int kWidth = kM;
  const float* tile;
  int tile_slots;
  Perturbation<kM> pert;
  int step;

  __device__ TiledPerturbation(const Sampling<kM>& s, const float* prev, int k, uint32_t seed,
                               const float* tile_, int tile_slots_)
      : tile(tile_ + threadIdx.x), tile_slots(tile_slots_), pert(s, prev, k, seed), step(0) {}

  __device__ __forceinline__ void next(float* v) {
    const int f0 = step * kM;
    if (f0 < tile_slots) {
#pragma unroll
      for (int j = 0; j < kM; ++j) v[j] = tile[(f0 + j) * kBlock];
    } else {
      pert.at(step, v);
    }
    ++step;
  }
};

// Rollout of sample k with its stage and terminal costs; with kDump, each
// clamped perturbation is also written to p.dump; with a tile, slots below
// tile_slots to this thread's column of it.
template <class Model, bool kDump>
__device__ __forceinline__ float rollout_cost(const Params<Model>& p, const float* s_ref,
                                              const float* s_prev, int k, uint32_t seed,
                                              float* tile = nullptr, int tile_slots = 0) {
  constexpr int kN = Model::kN, kM = Model::kM;
  const int T = p.s.horizon;
  Perturbation<kM> pert(p.s, s_prev, k, seed);
  float x[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) x[c] = p.x0[c];
  float acc = 0.0f;
  float u[kM], pu[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) u[j] = pu[j] = 0.0f;
  // two steps a trip: a step's parity, and so whether it opens a Philox block
  // (m = 2), is then known at compile time
#pragma unroll 2
  for (int t = 0; t < T; ++t) {
    float pv[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) pv[j] = u[j];
    pert.at(t, u);
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      if (kDump) p.dump[static_cast<size_t>(t * kM + j) * p.s.num_samples + k] = u[j];
      if (t * kM + j < tile_slots) tile[(t * kM + j) * kBlock + threadIdx.x] = u[j];
      // prev_action at t is the action at max(t - 1, 0)
      pu[j] = t == 0 ? u[j] : pv[j];
    }
    acc = acc + Model::stage_cost(x, u, pu, s_ref + Model::kRefWidth * t, p.args);
    model_step<Model>(x, u, p.args);
  }
  // terminal cost: zero action; t and prev_action keep their last values
  float zero[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) zero[j] = 0.0f;
  return acc + Model::stage_cost(x, zero, pu, s_ref + Model::kRefWidth * (T - 1), p.args);
}

template <class Model>
__global__ void __launch_bounds__(kBlock) fused_solve_kernel(Params<Model> batch, int tile_slots) {
  const Params<Model> p = batch.scenario(blockIdx.y);
  extern __shared__ float smem[];
  const int T = p.s.horizon;
  const int slots = Model::kM * T;
  float* s_ref = smem;                                 // (T+1) * kRefWidth
  float* s_prev = s_ref + (T + 1) * Model::kRefWidth;  // T * m
  float* s_red = s_prev + slots;                       // kWarps
  constexpr int kChunk = softmin::chunk_for(Model::kM);
  float* s_numer = s_red + softmin::kWarps;            // kWarps * min(T*m, kChunk)
  float* s_tile = s_numer + softmin::kWarps * min(slots, kChunk);  // tile_slots * kBlock
  const uint32_t seed = load_reference(p, s_ref, s_prev);

  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = p.s.valid(k);
  float cost = 1e30f;  // padding never wins the softmin
  if (valid) cost = rollout_cost<Model, false>(p, s_ref, s_prev, k, seed, s_tile, tile_slots);
  if (k < p.s.num_samples) p.costs[k] = cost;  // a shard's samples past the solve: 1e30
  // the numerator pass reads each perturbation back from the tile, or
  // regenerates (noise mode: re-reads) the slots the tile does not hold
  TiledPerturbation<Model::kM> pert(p.s, s_prev, valid ? k : 0, seed, s_tile, tile_slots);
  block_partials(cost, *p.lam, valid, pert, slots, s_red, s_numer, p.stats, p.numer);
}

template <class Model>
__global__ void __launch_bounds__(kBlock) costs_dump_kernel(Params<Model> batch) {
  const Params<Model> p = batch.scenario(blockIdx.y);
  extern __shared__ float smem[];
  float* s_ref = smem;
  float* s_prev = s_ref + (p.s.horizon + 1) * Model::kRefWidth;
  const uint32_t seed = load_reference(p, s_ref, s_prev);
  const int k = blockIdx.x * kBlock + threadIdx.x;
  if (p.s.valid(k)) {
    p.costs[k] = rollout_cost<Model, true>(p, s_ref, s_prev, k, seed);
  } else if (k < p.s.num_samples) {  // a shard's samples past the solve: cost 1e30, zero actions
    p.costs[k] = 1e30f;
    for (int f = 0; f < Model::kM * p.s.horizon; ++f)
      p.dump[static_cast<size_t>(f) * p.s.num_samples + k] = 0.0f;
  }
}

// What the lambda epilogue searches with: ESSPS (param = target ESS) or
// LBPS (param = (1 - delta) / delta).
struct Search {
  float lam_min, lam_max, param;
  int iters;
};

// Scenario blockIdx.y of a batched launch (one scenario: blockIdx.y = 0) takes
// its own ticket, ticket[blockIdx.y], and writes its lambda* to
// lam_out[blockIdx.y]: the last of its clusters searches its costs alone.
template <class Model, bool kLbps>
__global__ void __cluster_dims__(lsearch::kCluster, 1, 1) __launch_bounds__(kBlock)
    costs_dump_lambda_kernel(Params<Model> batch, Search q, int* tickets, float* lams_out) {
  const Params<Model> p = batch.scenario(blockIdx.y);
  int* ticket = tickets + blockIdx.y;
  float* lam_out = lams_out + blockIdx.y;
  extern __shared__ float smem[];
  __shared__ lsearch::Exchange ex;
  __shared__ int s_last;
  lsearch::cg::cluster_group cluster = lsearch::cg::this_cluster();
  float* s_ref = smem;
  float* s_prev = s_ref + (p.s.horizon + 1) * Model::kRefWidth;
  float* s_costs = s_prev + Model::kM * p.s.horizon;  // epilogue_resident floats
  const uint32_t seed = load_reference(p, s_ref, s_prev);
  // CTA b rolls out samples [b * per, (b + 1) * per), a thread every kBlock
  const int per = (p.s.num_samples + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  const int end = min(p.s.num_samples, (static_cast<int>(blockIdx.x) + 1) * per);
  for (int k = static_cast<int>(blockIdx.x) * per + static_cast<int>(threadIdx.x); k < end;
       k += kBlock) {
    p.costs[k] = rollout_cost<Model, true>(p, s_ref, s_prev, k, seed);
  }

  // last cluster of the scenario done: the cluster's costs are visible
  // (device scope) before its ticket is
  __threadfence();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const int clusters = static_cast<int>(gridDim.x) / lsearch::kCluster;
    const int last = atomicAdd(ticket, 1) == clusters - 1;
    for (int r = 0; r < lsearch::kCluster; ++r) *cluster.map_shared_rank(&s_last, r) = last;
  }
  cluster.sync();  // after it, each CTA reads only its own shared memory
  if (!s_last) return;
  __threadfence();
  const float lam = lsearch::cluster_search<kLbps, lsearch::kThreads / kBlock>(
      p.costs, p.s.num_samples, s_costs, lsearch::kMaxResident, q.lam_min, q.lam_max, q.param,
      q.iters, ex, cluster);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    *lam_out = lam;
    atomicExch(ticket, 0);  // the scenario's ticket ready for the next launch (or graph replay)
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// The model plug of regeneration alone (fused_regen_m1_batch, _m2_batch): no
// state, no step; the actions are all it writes.
template <int kM_>
struct ActionsOnly {
  static constexpr int kN = 1, kM = kM_, kPre = 1;
  struct Args {};
  __device__ static __forceinline__ void prepare(const float (&)[kM], float (&)[kPre],
                                                 const Args&) {}
  __device__ static __forceinline__ void step_prepared(float (&)[kN], const float (&)[kPre],
                                                       const Args&) {}
};

// Requested rows a CTA of regen_rollout_kernel: each row is one thread's chain
// of T dependent steps, so small CTAs spread get_top_samples' 100-300 rows over
// several SMs (PERF.md times 32 to 256).
constexpr int kTopBlock = 32;

// Regeneration and roll-out of requested samples, one thread a row i: sample
// rows[i]'s clamped perturbed actions, replayed from the solve's seed and warm
// start (or its noise) with the draws of every other kernel, written to
// actions [n, T, m] where that is not null; and rolled from x0 through
// model_step, every state written to states [n, T+1, kN] where that is not
// null.  A row past [0, K) is all NaN.  Where key_out is not null, CTA 0
// also moves the solver's key on by one tick into it (the unfused solver's
// draw of all K rows is the tick's one drawing launch).  A batched launch
// (an unfused fleet's draw) puts scenario b on blockIdx.y: its warm start,
// noise and seed word (Sampling::scenario), x0 [B, kN], actions [B, n, T, m],
// states [B, n, T+1, kN] and keys [B, 3] at b of their own sizes; the rows
// are shared, and CTA 0 of each scenario moves that scenario's key on.
template <class Model>
__global__ void __launch_bounds__(kTopBlock)
    regen_rollout_kernel(Sampling<Model::kM> batch, const int64_t* rows, int num_rows,
                         const float* x0, typename Model::Args args, float* actions,
                         float* states, const uint32_t* key, uint32_t* key_out) {
  constexpr int kN = Model::kN, kM = Model::kM;
  extern __shared__ float smem[];
  __shared__ uint32_t s_seed;
  float* s_prev = smem;  // T * m
  const Sampling<kM> s = batch.scenario(blockIdx.y);
  const int T = s.horizon;
  const int slots = kM * T;
  if (blockIdx.y > 0) {
    const size_t b = blockIdx.y, n = static_cast<size_t>(num_rows);
    if (x0 != nullptr) x0 += b * kN;
    if (actions != nullptr) actions += b * n * slots;
    if (states != nullptr) states += b * n * (T + 1) * kN;
    if (key != nullptr) key += 3 * b;
    if (key_out != nullptr) key_out += 3 * b;
  }
  load_seed(s, &s_seed);
  for (int i = threadIdx.x; i < slots; i += kTopBlock) s_prev[i] = s.prev[i];
  if (key_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) devmath::advance_key(key, key_out);
  __syncthreads();
  const uint32_t seed = s_seed;
  const int i = blockIdx.x * kTopBlock + threadIdx.x;
  if (i >= num_rows) return;
  const int64_t k = rows[i];
  float* act = actions == nullptr ? nullptr : actions + static_cast<size_t>(i) * slots;
  float* st = states == nullptr ? nullptr : states + static_cast<size_t>(i) * (T + 1) * kN;
  if (k < 0 || k >= s.num_samples) {  // no such sample: a row of NaN, never a stray read
    const float nan = __int_as_float(0x7fc00000);
    for (int f = 0; act != nullptr && f < slots; ++f) act[f] = nan;
    for (int f = 0; st != nullptr && f < (T + 1) * kN; ++f) st[f] = nan;
    return;
  }
  Perturbation<kM> pert(s, s_prev, static_cast<int>(k), seed);
  float x[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    x[c] = st == nullptr ? 0.0f : x0[c];
    if (st != nullptr) st[c] = x[c];
  }
  for (int t = 0; t < T; ++t) {
    float u[kM];
    pert.at(t, u);
    if (act != nullptr) {
#pragma unroll
      for (int j = 0; j < kM; ++j) act[kM * t + j] = u[j];
    }
    if (st != nullptr) {
      model_step<Model>(x, u, args);
#pragma unroll
      for (int c = 0; c < kN; ++c) st[kN * (t + 1) + c] = x[c];
    }
  }
}

inline int blocks_for(int num_samples) { return (num_samples + kBlock - 1) / kBlock; }

// batch scenarios on gridDim.y (1: one scenario); at least one CTA a
// scenario, so that a draw of no rows still moves the key on.
template <class Model>
int launch_regen_rollout(const Sampling<Model::kM>& s, const int64_t* rows, int num_rows,
                         const float* x0, typename Model::Args args, float* actions,
                         float* states, const uint32_t* key, uint32_t* key_out,
                         cudaStream_t stream, int batch = 1) {
  const size_t shmem = sizeof(float) * Model::kM * static_cast<size_t>(s.horizon);
  const int blocks = num_rows > 0 ? (num_rows + kTopBlock - 1) / kTopBlock : 1;
  cudaError_t err = allow_shared(regen_rollout_kernel<Model>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  regen_rollout_kernel<Model><<<dim3(blocks, batch), kTopBlock, shmem, stream>>>(
      s, rows, num_rows, x0, args, actions, states, key, key_out);
  return static_cast<int>(cudaGetLastError());
}

// Params of a rollout launch from the wrappers' flat arguments.
template <class Model>
Params<Model> make_params(const float* x0, const float* prev, const float* lam, const float* ref,
                          const uint8_t* grid_a, const uint8_t* grid_b, const float* noise,
                          const float* bounds, const float* model_f, const int* model_i,
                          const uint32_t* seed, int horizon, int num_samples, int threshold,
                          int seed_stride = 0, int sample_offset = 0, int total_samples = -1) {
  Params<Model> p{};
  p.s = make_sampling<Model::kM>(prev, noise, bounds, seed, horizon, num_samples, threshold,
                                 seed_stride, sample_offset, total_samples);
  p.x0 = x0;
  p.lam = lam;
  p.ref = ref;
  p.args = Model::make_args(model_f, model_i, grid_a, grid_b);
  return p;
}

// Slots of the fused solve's numerator tile for a launch of `grid` CTAs (all
// scenarios' of a batched launch) whose shared memory is `base` bytes without it: as many of a sample's `slots`
// clamped actions as fit while an SM still holds as many CTAs at once as the
// launch gives it (no more than the registers allow, no more than
// ceil(grid / SMs)); all of them, or a multiple of `unit` (tile_unit: whole
// steps and whole Philox blocks).  Asked of the occupancy calculator once per
// (base, slots, grid).
template <class Kernel>
cudaError_t tile_slots_for(Kernel kernel, size_t base, int slots, int grid, int unit,
                           int* tile_slots) {
  static size_t cached_base = 0;
  static int cached_slots = -1, cached_grid = -1, cached_tile = 0;
  if (base == cached_base && slots == cached_slots && grid == cached_grid) {
    *tile_slots = cached_tile;
    return cudaSuccess;
  }
  int device = 0, sms = 0, per_sm = 0, per_block = 0, reserved = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kBlock, base);
  if (err != cudaSuccess) return err;
  const int per_sm_grid = (grid + sms - 1) / sms;
  const int wanted = resident < per_sm_grid ? resident : per_sm_grid;
  const long room = static_cast<long>(per_sm) / (wanted > 0 ? wanted : 1) - reserved;
  const long budget = (room < per_block ? room : per_block) - static_cast<long>(base);
  const int column = static_cast<int>(sizeof(float)) * kBlock;
  int tile = budget > 0 ? static_cast<int>(budget / column) : 0;
  tile = tile >= slots ? slots : tile / unit * unit;
  // the calculator has the last word: shrink until `wanted` CTAs fit
  for (; tile > 0; tile = (tile == slots ? (slots - 1) / unit * unit : tile - unit)) {
    const size_t bytes = base + static_cast<size_t>(column) * tile;
    int fit = 0;
    err = allow_shared(kernel, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kBlock, bytes);
    if (err != cudaSuccess) return err;
    if (fit >= wanted) break;
  }
  cached_base = base;
  cached_slots = slots;
  cached_grid = grid;
  cached_tile = tile;
  *tile_slots = tile;
  return cudaSuccess;
}

// batch scenarios on gridDim.y (1: one scenario), each [B, ...] array of
// Params holding scenario b at b of its own size (Params::scenario).
template <class Model>
int launch_solve(Params<Model> p, int batch, float* costs, float* stats, float* numer,
                 cudaStream_t stream) {
  p.costs = costs;
  p.stats = stats;
  p.numer = numer;
  const int horizon = p.s.horizon;
  const int slots = Model::kM * horizon;
  const int blocks = blocks_for(p.s.num_samples);
  const size_t base =
      reference_shared_bytes<Model>(horizon) + softmin::shared_bytes(slots, Model::kM);
  int tile_slots = 0;
  cudaError_t err = tile_slots_for(fused_solve_kernel<Model>, base, slots, blocks * batch,
                                   tile_unit(Model::kM), &tile_slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shmem = base + sizeof(float) * kBlock * static_cast<size_t>(tile_slots);
  err = allow_shared(fused_solve_kernel<Model>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_solve_kernel<Model><<<dim3(blocks, batch), kBlock, shmem, stream>>>(p, tile_slots);
  return static_cast<int>(cudaGetLastError());
}

template <class Model>
int launch_costs_dump(Params<Model> p, int batch, float* costs, float* dump,
                      cudaStream_t stream) {
  p.costs = costs;
  p.dump = dump;
  const size_t shmem = reference_shared_bytes<Model>(p.s.horizon);
  cudaError_t err = allow_shared(costs_dump_kernel<Model>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  costs_dump_kernel<Model><<<dim3(blocks_for(p.s.num_samples), batch), kBlock, shmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Floats of its slice of the costs each CTA of the epilogue keeps in shared
// memory while the last cluster searches: the whole slice up to 200 KB.  Every
// CTA of the launch reserves them; held there, the search measured faster at
// every K from 3,000 to 524,288 than with the slice read from memory at each
// evaluation, the reservation's cost to phase 1 included (PERF.md).
inline int epilogue_resident(int num_samples) {
  const int chunk = (num_samples + lsearch::kCluster - 1) / lsearch::kCluster;
  return chunk < lsearch::kMaxResident ? chunk : lsearch::kMaxResident;
}

template <class Model, bool kLbps>
int launch_costs_dump_lambda_as(Params<Model> p, int batch, Search q, int* ticket,
                                float* lam_out, cudaStream_t stream) {
  const size_t shmem = reference_shared_bytes<Model>(p.s.horizon) +
                       sizeof(float) * static_cast<size_t>(epilogue_resident(p.s.num_samples));
  const auto kernel = costs_dump_lambda_kernel<Model, kLbps>;
  cudaError_t err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kBlock);
  config.dynamicSmemBytes = shmem;
  config.stream = stream;
  // As many clusters as the card holds at once (asked once per shared-memory
  // size), and at least a warp's samples a CTA: every CTA is resident in one
  // wave and takes an equal share of the samples, so that no SM carries more
  // CTAs than another (a grid of ceil(K / 256) CTAs in clusters of 8 cannot
  // be spread evenly over the GPCs).  A batch of scenarios (gridDim.y) shares
  // them: each scenario takes 1 / B of the resident clusters, at least one,
  // so that a fleet's CTAs hold as many samples as a single launch's CTAs
  // hold at B times K.  Which CTA rolls a sample out changes no bit.
  static size_t cached_shmem = 0;
  static int resident_clusters = 0;
  if (resident_clusters == 0 || cached_shmem != shmem) {
    config.gridDim = dim3(lsearch::kCluster);
    err = cudaOccupancyMaxActiveClusters(&resident_clusters, kernel, &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident_clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached_shmem = shmem;
  }
  constexpr int kPerCluster = lsearch::kCluster * 32;
  const int wanted = (p.s.num_samples + kPerCluster - 1) / kPerCluster;
  const int share = resident_clusters / batch > 1 ? resident_clusters / batch : 1;
  config.gridDim = dim3(lsearch::kCluster * (wanted < share ? wanted : share), batch);
  err = cudaLaunchKernelEx(&config, kernel, p, q, ticket, lam_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// batch scenarios on gridDim.y (1: one scenario), each with its ticket
// ticket[b] (int [B], zero between launches) and its lambda* lam_out[b].
template <class Model>
int launch_costs_dump_lambda(Params<Model> p, int batch, int lbps, Search q, int* ticket,
                             float* costs, float* dump, float* lam_out, cudaStream_t stream) {
  p.costs = costs;
  p.dump = dump;
  return lbps ? launch_costs_dump_lambda_as<Model, true>(p, batch, q, ticket, lam_out, stream)
              : launch_costs_dump_lambda_as<Model, false>(p, batch, q, ticket, lam_out, stream);
}

}  // namespace fused

// The flat C arguments the rollout entry points share, in the order the
// wrappers (ops/fused_solve.py) pass them.  bounds: sigma, u_min, u_max (m
// each); model_f / model_i: the model's floats and ints (its header says
// which); ref: the per-tick reference rows (racing) or null; seed: the
// tick's seed word in device memory.
#define FUSED_ROLLOUT_ARGS                                                                    \
  const float *x0, const float *prev, const float *lam, const float *ref,                    \
      const uint8_t *grid_a, const uint8_t *grid_b, const float *noise, const float *bounds, \
      const float *model_f, const int *model_i, const uint32_t *seed, int horizon,            \
      int num_samples, int threshold
#define FUSED_ROLLOUT_NAMES                                                                  \
  x0, prev, lam, ref, grid_a, grid_b, noise, bounds, model_f, model_i, seed, horizon,       \
      num_samples, threshold

// The rollout entry points of one model, each over a batch of scenarios:
// <prefix>_fused_solve_batch, <prefix>_costs_dump_batch and
// <prefix>_costs_dump_lambda_batch (every array of FUSED_ROLLOUT_ARGS but the
// bounds, the model's constants and grids [B, ...]; seed_stride words between
// the scenarios' seed words; the epilogue's tickets and lambda* [B]).  The
// first two also take a shard's sample_offset and the solve's total_samples
// (Sampling; 0 and num_samples for the whole launch), shared by every
// scenario; the epilogue searches one launch's costs and takes none.
#define FUSED_MODEL_ENTRY_POINTS(prefix, Model)                                               \
  extern "C" int prefix##_fused_solve_batch(FUSED_ROLLOUT_ARGS, int batch, int seed_stride,   \
                                            int sample_offset, int total_samples,             \
                                            float* costs, float* stats, float* numer,         \
                                            void* stream) {                                   \
    return fused::launch_solve(fused::make_params<Model>(FUSED_ROLLOUT_NAMES, seed_stride,    \
                                                         sample_offset, total_samples),       \
                               batch, costs, stats, numer, static_cast<cudaStream_t>(stream)); \
  }                                                                                           \
  extern "C" int prefix##_costs_dump_batch(FUSED_ROLLOUT_ARGS, int batch, int seed_stride,    \
                                           int sample_offset, int total_samples,              \
                                           float* costs, float* dump, void* stream) {         \
    return fused::launch_costs_dump(                                                          \
        fused::make_params<Model>(FUSED_ROLLOUT_NAMES, seed_stride, sample_offset,            \
                                  total_samples),                                             \
        batch, costs, dump, static_cast<cudaStream_t>(stream));                               \
  }                                                                                           \
  extern "C" int prefix##_costs_dump_lambda_batch(                                            \
      FUSED_ROLLOUT_ARGS, int batch, int seed_stride, int lbps, float lam_min, float lam_max,   \
      float param, int iters, int* ticket, float* costs, float* dump, float* lam_out,          \
      void* stream) {                                                                         \
    return fused::launch_costs_dump_lambda(                                                   \
        fused::make_params<Model>(FUSED_ROLLOUT_NAMES, seed_stride), batch, lbps,             \
        fused::Search{lam_min, lam_max, param, iters}, ticket, costs, dump, lam_out,          \
        static_cast<cudaStream_t>(stream));                                                   \
  }
