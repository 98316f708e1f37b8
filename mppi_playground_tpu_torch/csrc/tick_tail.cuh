// The nominal re-roll and the fused tick's tail, templated on a model plug.
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py make_fused_reroll.kernel
// (a Pallas TPU kernel that rolls the sequence on broadcast vregs), and with
// it what the JAX fused solver runs around it in XLA: combine_partials
// (ops/fused_solve.py, the merge of the block partials), the SG filter and
// the shift of its history (core/solver.py smooth_predict_advance).
//
// * reroll_kernel (<model>_reroll): x0 [n], actions [T, m] -> [T+1, n].
// * tick_tail_kernel (<model>_tick_tail_batch): one launch after the fused solve or
//   phase 2.  CTA 0 merges the block partials [B, 3] and [B, T*m] into the
//   update and the ESS, applies the SG filter where the config has it,
//   shifts the filter's history, and re-rolls the nominal sequence; every
//   other CTA repeats the merge of the max and z (the same operations in the
//   same order, so the same bits) and writes its share of the weights [K] =
//   exp(-c / lambda - max) / z.  lambda is read by pointer, as phase 2 reads
//   it, so that lambda* never leaves the device.
//
// What bounds them on the H100.  The re-roll reads 4(n + Tm) bytes and writes
// 4n(T+1) (1.2 KB for racing at T=50), and does a few tens of float
// operations a step: no bound on bytes or operations matters, since the T
// steps are one chain of dependent operations on one thread.  Its floor is
// that chain's latency: the dependent instructions of a step times their
// latency, T times (PERF.md gives it beside the byte bound).  The tail adds
// the merge: B(3 + Tm) floats read (156 KB at the flagship), 4K written.
//
// What this design does about it.  The chain reads nothing from global
// memory: one CTA stages the work of the actions first, each thread a step's
// action-only terms (Model::prepare: racing's clamped acceleration times dt
// and tan of the clamped steer), in parallel for all T steps, into shared
// memory; then one thread runs the dependent chain (Model::step_prepared) out
// of shared memory and registers, writing each state as it goes.  prepare
// then step_prepared is fused_solve.cuh's model_step, the same operations in
// the same order, so the states are bit for bit those of every other
// kernel's step.  The
// merge runs on CTAs of 1024 threads: the sums of the block statistics are
// each thread a strided slice of the blocks, folded by halves within a warp
// and across the warps in warp order; each action slot's numerator is the
// sum of T*m-thread groups' partial sums (group g takes blocks g, g + groups,
// ... in turn, its loads eight in flight), added in group order: one thread
// a slot summing all blocks in turn waited on L2 at every block (0.037 ms at
// the flagship on an H100, PERF.md).  ops/fused_solve.py fused_tick_tail_plain does
// each sum in this order, so the kernel is bit for bit its twin.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device_math.cuh"
#include "shared_memory.cuh"
#include "softmin_partials.cuh"

namespace fused {

// Threads of the re-roll's one CTA: each prepares the terms of some steps.
constexpr int kRerollBlock = 128;
// Threads of the tail's CTAs (T*m <= 1024, the envelope: a slot a thread at
// least), their warps, and the numerator loads a thread keeps in flight.
constexpr int kTailBlock = 1024;
constexpr int kTailWarps = kTailBlock / 32;
constexpr int kTailUnroll = 8;
// Weights a thread of a weights CTA writes, and the most weights CTAs.
constexpr int kTailWeights = 4;
constexpr int kTailMaxWeightCtas = 264;

// Each step's action-only terms, Model::prepare of actions [T, m], into
// s_pre [T, kPre]; every thread of the CTA takes a share of the steps.
template <class Model>
__device__ __forceinline__ void prepare_steps(const float* actions, int horizon,
                                              const typename Model::Args& args, float* s_pre) {
  for (int t = threadIdx.x; t < horizon; t += blockDim.x) {
    float u[Model::kM], p[Model::kPre];
#pragma unroll
    for (int j = 0; j < Model::kM; ++j) u[j] = actions[Model::kM * t + j];
    Model::prepare(u, p, args);
#pragma unroll
    for (int j = 0; j < Model::kPre; ++j) s_pre[Model::kPre * t + j] = p[j];
  }
}

// One thread rolls x0 through the prepared steps, writing states [T+1, kN].
template <class Model>
__device__ __forceinline__ void roll_chain(const float* x0, const float* s_pre, int horizon,
                                           const typename Model::Args& args, float* out) {
  constexpr int kN = Model::kN, kPre = Model::kPre;
  float x[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    x[c] = x0[c];
    out[c] = x[c];
  }
  for (int t = 0; t < horizon; ++t) {
    float p[kPre];
#pragma unroll
    for (int j = 0; j < kPre; ++j) p[j] = s_pre[kPre * t + j];
    Model::step_prepared(x, p, args);
#pragma unroll
    for (int c = 0; c < kN; ++c) out[kN * (t + 1) + c] = x[c];
  }
}

template <class Model>
__global__ void __launch_bounds__(kRerollBlock)
    reroll_kernel(const float* x0, const float* seq, int horizon, typename Model::Args args,
                  float* out) {
  extern __shared__ float s_pre[];  // [T, kPre]
  prepare_steps<Model>(seq, horizon, args, s_pre);
  __syncthreads();
  if (threadIdx.x == 0) roll_chain<Model>(x0, s_pre, horizon, args, out);
}

// What the tail reads and writes.  history and history_out are [T-1, m],
// coeffs [window] (null: no SG filter), weights [K] (null: not written);
// key and key_out the solver's device key before and after the tick (null:
// not moved on), which the tail, the last launch of a fused tick, advances.
struct Tail {
  const float *x0, *costs, *stats, *numer, *lam, *history, *coeffs;
  int blocks, horizon, num_samples, window;
  float *actions, *states, *ess, *weights, *history_out;
  const uint32_t* key;
  uint32_t* key_out;

  // Scenario b of a batched launch (gridDim.y scenarios, each array [B, ...]
  // but the shared SG window): every array moved on by b of its own size, the
  // keys by 3 words.  So the first CTA of each scenario moves that scenario's
  // key on, and scenario b's outputs are bit for bit its own launch's.
  template <int kN, int kM>
  __device__ __forceinline__ Tail scenario(int b) const {
    Tail q = *this;
    if (b == 0) return q;
    const size_t n = static_cast<size_t>(b), T = horizon, K = num_samples;
    const size_t slots = kM * T, hist = kM * (T - 1);
    q.x0 += n * kN;
    q.costs += n * K;
    q.stats += n * blocks * 3;
    q.numer += n * blocks * slots;
    q.lam += n;
    q.history += n * hist;
    q.actions += n * slots;
    q.states += n * (T + 1) * kN;
    q.ess += n;
    if (weights != nullptr) q.weights += n * K;
    q.history_out += n * hist;
    if (key != nullptr) q.key += 3 * n;
    if (key_out != nullptr) q.key_out += 3 * n;
    return q;
  }
};

// Block-wide max or sum, valid in every thread: each warp folds its lanes by
// halves (lane 0 of softmin's shuffle-down tree), then the warp results are
// folded in warp order.
template <bool kMax>
__device__ __forceinline__ float tail_reduce(float v, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? softmin::warp_max(v) : softmin::warp_sum(v);
  __syncthreads();  // s_red may still be read by a previous reduction
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < kTailWarps; ++w) r = kMax ? fmaxf(r, s_red[w]) : r + s_red[w];
  return r;
}

// The max of the block maxima, valid in every thread.
__device__ __forceinline__ float merged_max(const Tail& q, float* s_red) {
  float m = __int_as_float(0xff800000);  // -inf
  for (int b = threadIdx.x; b < q.blocks; b += kTailBlock) m = fmaxf(m, q.stats[3 * b]);
  return tail_reduce<true>(m, s_red);
}

// z = sum alpha_b s1_b and sumsq = sum alpha_b^2 s2_b, alpha_b = exp(max_b -
// mx): thread t sums blocks t, t + kTailBlock, ... in turn, then
// tail_reduce.  With kNumer, the numerators too, a chunk of kTailBlock
// alphas at a time through s_alpha: the threads form kTailBlock / slots
// groups of a thread a slot, and group g sums alpha_b numer[b, slot] over the
// blocks b = g, g + groups, ... in turn into *acc, kTailUnroll loads in
// flight, so that the numerators' latency is hidden by many threads at once.
template <bool kNumer>
__device__ __forceinline__ void merged_sums(const Tail& q, int slots, float mx, float* s_alpha,
                                            float* s_red, float* z, float* sumsq, float* acc) {
  const int groups = kTailBlock / slots;
  const int g = threadIdx.x / slots, j = threadIdx.x % slots;
  float pz = 0.0f, psq = 0.0f;
  for (int base = 0; base < q.blocks; base += kTailBlock) {
    const int b = base + threadIdx.x;
    float a = 0.0f;
    if (b < q.blocks) {
      a = expf(q.stats[3 * b] - mx);
      pz = pz + a * q.stats[3 * b + 1];
      psq = psq + a * a * q.stats[3 * b + 2];
    }
    if (kNumer) {
      s_alpha[threadIdx.x] = a;
      __syncthreads();
      if (g < groups) {
        const int n = q.blocks - base < kTailBlock ? q.blocks - base : kTailBlock;
        const float* col = q.numer + static_cast<size_t>(base) * slots + j;
        float sum = *acc;
#pragma unroll kTailUnroll
        for (int i = (g - base % groups + groups) % groups; i < n; i += groups) {
          sum = sum + s_alpha[i] * col[static_cast<size_t>(i) * slots];
        }
        *acc = sum;
      }
      __syncthreads();  // the next chunk overwrites s_alpha
    }
  }
  *z = tail_reduce<false>(pz, s_red);
  *sumsq = tail_reduce<false>(psq, s_red);
}

template <class Model>
__global__ void __launch_bounds__(kTailBlock)
    tick_tail_kernel(Tail batch, typename Model::Args args) {
  constexpr int kM = Model::kM;
  const Tail q = batch.scenario<Model::kN, kM>(blockIdx.y);
  __shared__ float s_red[kTailWarps];
  __shared__ float s_alpha[kTailBlock];
  extern __shared__ float smem[];
  const int T = q.horizon, slots = kM * T, hist = kM * (T - 1);
  float acc = 0.0f, z, sumsq;
  if (q.key_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    devmath::advance_key(q.key, q.key_out);
  }
  const float mx = merged_max(q, s_red);
  if (blockIdx.x > 0) {  // the weights, a grid-stride share of them a CTA
    merged_sums<false>(q, slots, mx, s_alpha, s_red, &z, &sumsq, &acc);
    const float lam = *q.lam;
    const int step = (gridDim.x - 1) * kTailBlock;
    for (int k = (blockIdx.x - 1) * kTailBlock + threadIdx.x; k < q.num_samples; k += step) {
      q.weights[k] = expf(-q.costs[k] / lam - mx) / z;
    }
    return;
  }
  merged_sums<true>(q, slots, mx, s_alpha, s_red, &z, &sumsq, &acc);
  float* s_prolonged = smem;                       // [2T-1, m]: the history, then the update
  float* s_filtered = s_prolonged + hist + slots;  // [T, m]
  float* s_pre = s_filtered + slots;               // [T, kPre]
  float* s_groups = s_pre + Model::kPre * T;       // [groups, T*m]: the groups' sums
  const int groups = kTailBlock / slots, tid = static_cast<int>(threadIdx.x);
  if (tid < groups * slots) s_groups[tid] = acc;
  if (tid == 0) *q.ess = z * z / sumsq;
  for (int i = tid; i < hist; i += kTailBlock) s_prolonged[i] = q.history[i];
  __syncthreads();
  if (tid < slots) {  // the groups' sums added in group order
    float numer = s_groups[tid];
    for (int g = 1; g < groups; ++g) numer = numer + s_groups[g * slots + tid];
    s_prolonged[hist + tid] = numer / z;
  }
  __syncthreads();
  const float* act = s_prolonged + hist;
  if (q.coeffs != nullptr) {
    // SG filter: the prolonged sequence [L = 2T-1, m] mirrored by pad rows at
    // each end (edge rows repeated), cross-correlated with the window, its
    // last T rows kept; each output sums its taps in order from 0
    const int pad = q.window / 2, rows = 2 * T - 1;
    for (int o = threadIdx.x; o < slots; o += kTailBlock) {
      const int l = T - 1 + o / kM, d = o % kM;
      float s = 0.0f;
      for (int j = 0; j < q.window; ++j) {
        const int i = l + j - pad;  // row of the prolonged sequence before mirroring
        const int row = i < 0 ? -1 - i : (i < rows ? i : 2 * rows - 1 - i);
        s = s + s_prolonged[kM * row + d] * q.coeffs[j];
      }
      s_filtered[o] = s;
    }
    __syncthreads();
    act = s_filtered;
  }
  for (int j = threadIdx.x; j < slots; j += kTailBlock) q.actions[j] = act[j];
  // the SG history shifts by one applied action: rows 1.. of the old, then act's row 0
  for (int i = threadIdx.x; i < hist; i += kTailBlock) {
    q.history_out[i] = i < hist - kM ? s_prolonged[i + kM] : act[i - (hist - kM)];
  }
  prepare_steps<Model>(act, T, args, s_pre);
  __syncthreads();
  if (threadIdx.x == 0) roll_chain<Model>(q.x0, s_pre, T, args, q.states);
}

template <class Model>
int launch_reroll(const float* x0, const float* seq, int horizon, typename Model::Args args,
                  float* out, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * Model::kPre * static_cast<size_t>(horizon);
  const cudaError_t err = allow_shared(reroll_kernel<Model>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  reroll_kernel<Model><<<1, kRerollBlock, shmem, stream>>>(x0, seq, horizon, args, out);
  return static_cast<int>(cudaGetLastError());
}

// batch scenarios on gridDim.y (1: one scenario; Tail::scenario).
template <class Model>
int launch_tick_tail(const Tail& q, int batch, typename Model::Args args, cudaStream_t stream) {
  const int slots = Model::kM * q.horizon;
  const size_t shmem = sizeof(float) * (static_cast<size_t>(Model::kM) * (2 * q.horizon - 1) +
                                        slots + static_cast<size_t>(Model::kPre) * q.horizon +
                                        kTailBlock);
  int weight_ctas = 0;
  if (q.weights != nullptr) {
    const int per = kTailBlock * kTailWeights;
    weight_ctas = (q.num_samples + per - 1) / per;
    if (weight_ctas > kTailMaxWeightCtas) weight_ctas = kTailMaxWeightCtas;
  }
  const cudaError_t err = allow_shared(tick_tail_kernel<Model>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tick_tail_kernel<Model><<<dim3(1 + weight_ctas, batch), kTailBlock, shmem, stream>>>(q, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fused
