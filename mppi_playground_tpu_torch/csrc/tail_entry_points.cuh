// The tick tail, re-roll and top-rows entry points of one model plug:
// TAIL_ENTRY_POINTS(prefix, Model) defines <prefix>_reroll,
// <prefix>_tick_tail_batch and <prefix>_top_rollouts
// (their arguments: reroll.cu).  reroll.cu instantiates it for every bundled
// model; a user's model plug, in the unit ops/cuda_build.py generates for it.
#pragma once

#include <cstdint>

#include "fused_solve.cuh"
#include "tick_tail.cuh"

#define TAIL_ENTRY_POINTS(prefix, Model)                                                       \
  extern "C" int prefix##_reroll(const float* x0, const float* seq, const float* model_f,     \
                                 const int* model_i, int horizon, float* out, void* stream) {   \
    return fused::launch_reroll<Model>(x0, seq, horizon,                                       \
                                       Model::make_args(model_f, model_i, nullptr, nullptr),   \
                                       out, static_cast<cudaStream_t>(stream));                \
  }                                                                                            \
  extern "C" int prefix##_tick_tail_batch(                                                     \
      const float* x0, const float* costs, const float* stats, const float* numer,             \
      const float* lam, const float* history, const float* coeffs, const float* model_f,       \
      const int* model_i, int blocks, int horizon, int num_samples, int window, int batch,     \
      float* actions, float* states, float* ess, float* weights, float* history_out,           \
      const uint32_t* key, uint32_t* key_out, void* stream) {                                  \
    const fused::Tail q{x0,      costs,       stats,   numer,   lam,     history,    coeffs,   \
                        blocks,  horizon,     num_samples, window, actions, states, ess,       \
                        weights, history_out, key,  key_out};                                  \
    return fused::launch_tick_tail<Model>(q, batch,                                            \
                                          Model::make_args(model_f, model_i, nullptr, nullptr), \
                                          static_cast<cudaStream_t>(stream));                  \
  }                                                                                            \
  extern "C" int prefix##_top_rollouts(const float* x0, const float* prev, const float* noise, \
                                       const int64_t* rows, const float* bounds,              \
                                       const float* model_f, const int* model_i,              \
                                       const uint32_t* seed, int horizon, int num_samples,    \
                                       int threshold, int num_rows, float* out,               \
                                       void* stream) {                                        \
    return fused::launch_regen_rollout<Model>(                                                 \
        fused::make_sampling<Model::kM>(prev, noise, bounds, seed, horizon, num_samples,       \
                                        threshold),                                            \
        rows, num_rows, x0, Model::make_args(model_f, model_i, nullptr, nullptr), nullptr,     \
        out, nullptr, nullptr, static_cast<cudaStream_t>(stream));                             \
  }
