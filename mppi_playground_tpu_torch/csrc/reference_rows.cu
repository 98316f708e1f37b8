// The racing reference rows of one state or of a fleet's B states, in one launch.
//
// Replaces: models/racing_mpcc.calc_ref_trajectory(_batch)'s torch ops (17
// kernels a call: the distances to the path, torch.argmin, the maximum with
// the progress index, the lookahead rows, their clamp and gather, the
// all-rows-valid test, the velocity column and the concatenation).  The JAX
// package computes the same in XLA (mppi_playground_tpu/models/racing_mpcc.py,
// calc_ref_trajectory); no Pallas kernel stands behind it.
//
// What it computes.  For scenario b, from states [B, 4] (x, y, yaw, v), the
// path [N, 3] (x, y, yaw), the progress indices cinds [B] and the lookahead
// table dinds [R] (R = T+1 row offsets, accumulated in float64 on the host by
// _lookahead_offsets and read here by pointer): the nearest path point by the
// first minimum of sqrtf(dx*dx + dy*dy), ind = max(cinds[b], nearest), rows
// ind + dinds[t] clamped to N-1, xrefs[b, t] = (path[row], v) with v = v_max
// when every row ind + dinds[t] < N and 0 otherwise, and inds[b] = ind.
//
// What bounds it on the H100.  Nothing but latency: a block reads the path
// once (N = 1,622 points, 19 KB) and writes R rows of 16 bytes; at B = 32 all
// of it is under a microsecond of HBM time.  What the torch ops cost was 17
// launches in a row, each mostly its own latency (26-35 us a call on the card).
//
// What the design does about it.  One block a scenario (gridDim.x = B), its
// kThreads threads striding over the path points, kPerThread points a thread
// loaded at once, each thread keeping the first minimum of its points as one
// 64-bit key (order_key: torch's argmin order, LessOrNan, a NaN distance
// before any number, the lower index among NaNs and among equal distances);
// two redux.sync minima a warp (the high word, then the index among the
// lanes holding it), then every thread takes the least of the warps' keys from
// shared memory.  Any reduction tree so picks torch's point.  The distances
// round as torch's separate kernels do: built with -fmad=false and without
// fast math, dx*dx + dy*dy is two multiplications and an addition, and sqrtf
// is correctly rounded; the minimum is taken over the root, as torch takes it
// (two squares can round to one root, and the tie then goes to the lower
// index).  Latency is what counts, so the scan waits on global memory once:
// the state, the progress index and the lookahead offsets are loaded with
// the path's points.  The gather after the reduction reads its rows from
// global memory, which the scan has just read, so they come from the caches;
// one gather serves a path of any length.  The velocity column is a block-wide AND
// (__syncthreads_and) over the rows' validity.  Nothing here reads the host
// or synchronises with it, so a CUDA graph captures it.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;  // points a thread loads at once: N <= 2,048 in one round trip
constexpr unsigned kFull = 0xffffffffu;

// A point's place in torch's argmin order as one integer, the smaller first: a NaN distance
// (0 in the high word) before any number, numbers by their value (a non-negative float's bits
// order as it does, + 1), and equal distances by the index in the low word.
__device__ __forceinline__ unsigned long long order_key(float d, int i) {
  const unsigned hi = isnan(d) ? 0u : __float_as_uint(d) + 1u;
  return (static_cast<unsigned long long>(hi) << 32) | static_cast<unsigned>(i);
}

__global__ void __launch_bounds__(kThreads) reference_rows_kernel(
    const float* __restrict__ states, const float* __restrict__ path,
    const int64_t* __restrict__ cinds, const int64_t* __restrict__ dinds, float v_max, int n,
    int rows, float* __restrict__ xrefs, int64_t* __restrict__ inds) {
  __shared__ unsigned long long s_key[kWarps];
  const int b = blockIdx.x;
  // every load that does not wait on the nearest point is issued before any is used
  const float sx = states[4 * b], sy = states[4 * b + 1];
  const int64_t cind = cinds[b];
  const int64_t first_offset = threadIdx.x < rows ? dinds[threadIdx.x] : 0;

  unsigned long long key = ~0ull;  // after every point
  for (int base = 0; base < n; base += kThreads * kPerThread) {
    float px[kPerThread], py[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i < n) {
        px[j] = path[3 * i];
        py[j] = path[3 * i + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i < n) {
        const float dx = px[j] - sx;
        const float dy = py[j] - sy;
        const unsigned long long k = order_key(sqrtf(dx * dx + dy * dy), i);
        key = k < key ? k : key;
      }
    }
  }
  // the warp's first minimum: the least high word, then the least index holding it
  const unsigned hi = __reduce_min_sync(kFull, static_cast<unsigned>(key >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, static_cast<unsigned>(key >> 32) == hi ? static_cast<unsigned>(key) : ~0u);
  if ((threadIdx.x & 31) == 0) {
    s_key[threadIdx.x >> 5] = (static_cast<unsigned long long>(hi) << 32) | lo;
  }
  __syncthreads();
  key = s_key[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) key = s_key[w] < key ? s_key[w] : key;
  const int64_t nearest = static_cast<int64_t>(static_cast<unsigned>(key));
  const int64_t ind = cind > nearest ? cind : nearest;
  if (threadIdx.x == 0) inds[b] = ind;

  int valid = 1;
  for (int t = threadIdx.x; t < rows; t += kThreads) {
    valid &= (ind + (t < kThreads ? first_offset : dinds[t]) < n);
  }
  const float v = __syncthreads_and(valid) ? v_max : 0.0f;

  float4* out = reinterpret_cast<float4*>(xrefs) + static_cast<int64_t>(b) * rows;
  for (int t = threadIdx.x; t < rows; t += kThreads) {
    int64_t row = ind + (t < kThreads ? first_offset : dinds[t]);
    if (row > n - 1) row = n - 1;
    if (row < 0) row += n;  // torch's index from the end
    if (row < 0) row = 0;   // where torch's index would be out of range
    const float* p = path + 3 * row;
    out[t] = make_float4(p[0], p[1], p[2], v);
  }
}

}  // namespace

// states [B, 4], path [N, 3], cinds [B], dinds [R] -> xrefs [B, R, 4] (16-byte aligned),
// inds [B]; one block a scenario.
extern "C" int reference_rows(const float* states, const float* path, const int64_t* cinds,
                              const int64_t* dinds, float v_max, int n, int rows, int batch,
                              float* xrefs, int64_t* inds, void* stream) {
  reference_rows_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      states, path, cinds, dinds, v_max, n, rows, xrefs, inds);
  return static_cast<int>(cudaGetLastError());
}
