// K6 chunk_replay: waves [first, end) of one chunk over all S scenarios in ONE
// cooperative launch — the per-slot K1 -> K2 -> K3 chain and each gang wave's
// rollback, with grid-wide barriers between the phases, so the host enqueues
// one launch a chunk instead of three a pod slot.
//
// Replaces: kubernetes_simulator_tpu/sim/jax_runtime.py:742 make_chunk_fn3_src
// (one lax.scan over a chunk's waves, "one dispatch per chunk and only the
// index array as per-chunk input") with its in-program slot gathers
// (ops/tpu.py:285 gather_slots_device, ops/tpu3.py:633 gather_extra_device),
// and the wave loop of sim/whatif.py:1285 _build_chunk_fn (the what-if's
// chunk program, which vmaps the same scan over S).
//
// The only per-chunk inputs are the device copies of the plan's slot index
// idx [num_waves * W] (the pod of each slot, PAD for an empty one) and its
// gang flags gang [num_waves]; the launch reads the pod of each slot there.
// For each non-PAD slot s = w * W + k (the same pod in every scenario, so
// every block skips a PAD slot alike):
//   phase 1  K1's body (ksim_filter_score_body) over every (scenario, node
//            tile) item, grid-strided: the mask, the raw Score rows and,
//            under tier preemption, the candidate row;
//   barrier  (cooperative_groups grid sync)
//   phase 2  one block per scenario, grid-strided: K2's body
//            (ksim_normalize_select_body) writes the choice to column s of the
//            scenario's row of the choice buffer, then K3's bind
//            (ksim_apply_body, K = 1, with the eviction step at `boundary`
//            under tier preemption and the failure append under the retry
//            buffer); after the last non-PAD slot of a gang wave the same
//            block runs K3's rollback over the wave's W columns;
//   barrier.
// The bodies are the ones K1, K2 and K3 launch (ksim.cuh), so a chunk on this
// route equals the same chunk on the per-slot route bit for bit: every
// reduction is a max, a min or a (value, index) pair with the lowest index on
// ties, and every state cell is updated by one thread in pair order.
//
// What stays with the host, between launches (sim/torch_runtime.py
// run_waves): the boundary's K3 release, the retry sequence (K1 -> K2 -> K3
// with one pod per scenario, K4) and, at telemetry series, the whole per-slot
// route (K5 after each slot's K2).
//
// Grid: as many blocks of 1024 threads as fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count), capped at
// the phase-1 items; a launch that does not fit raises (no fallback).
//
// Bound on an H100: bytes, as K1 + K2 + K3 per slot (PERF.md, chip_smoke.py
// Work): at S = 1 the work of a slot is a few hundred kilobytes, so the
// chunk is latency-bound — the two barriers and K2's one-block reductions a
// slot set its pace; at S = 128 phase 1 spreads over every SM.
//
// Exactness: compiled with --fmad=false and IEEE division, as K1–K3.
#include <cooperative_groups.h>

#include "ksim.cuh"

namespace cg = cooperative_groups;

#define K6_THREADS 1024

__global__ void __launch_bounds__(K6_THREADS, 1)
    ksim_chunk_replay_kernel(KsimArgs a, const int32_t* idx, const uint8_t* gang,
                             int32_t* choices, int64_t choice_ss, int W, int first, int end,
                             int boundary, int append) {
  __shared__ KsimTerms terms;
  cg::grid_group grid = cg::this_grid();
  const int S = a.S;
  const int tiles = (a.N + blockDim.x - 1) / blockDim.x;
  const int64_t items = (int64_t)S * tiles;
  for (int w = first; w < end; ++w) {
    const int base = w * W;
    int last = -1;  // the wave's last non-PAD slot, where a gang wave rolls back
    if (gang[w])
      for (int k = 0; k < W; ++k)
        if (idx[base + k] >= 0) last = k;
    for (int k = 0; k < W; ++k) {
      const int s = base + k;
      const int p = idx[s];
      if (p < 0) continue;  // uniform over the grid
      for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
        ksim_filter_score_body(a, p, it / tiles, (int)(it % tiles) * blockDim.x + threadIdx.x,
                               &terms);
        __syncthreads();  // the next item rewrites the term tables
      }
      grid.sync();
      for (int64_t scen = blockIdx.x; scen < S; scen += gridDim.x) {
        ksim_normalize_select_body(a, p, scen, choices + scen * choice_ss + s, w);
        __syncthreads();
        ksim_apply_body(a, scen, idx + s, 0, nullptr, s, choices, 1, choice_ss, 1.f, 0,
                        boundary, nullptr, 0, append);
        if (k == last) {
          __syncthreads();
          ksim_apply_body(a, scen, idx + base, 0, nullptr, base, choices, W, choice_ss, -1.f, 1,
                          -1, nullptr, 0, 0);
        }
        __syncthreads();
      }
      grid.sync();
    }
  }
}

// Blocks a cooperative launch may hold on the current device (cached per
// device), or a negative CUDA error.
static int k6_max_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ksim_chunk_replay_kernel,
                                                         K6_THREADS, 0)) != cudaSuccess)
    return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

KSIM_EXPORT int ksim_chunk_replay(const KsimArgs* args, const int32_t* idx, const uint8_t* gang,
                                  int32_t* choices, long long choice_ss, int W, int first,
                                  int end, int boundary, int append, void* stream) {
  if (args->S < 1 || W < 1 || W > KSIM_MAX_WAVE || first < 0 || end < first)
    return (int)cudaErrorInvalidValue;
  if ((long long)end * W > choice_ss) return (int)cudaErrorInvalidValue;
  if (boundary >= 0 && !args->preempt) return (int)cudaErrorInvalidValue;
  if (append && !args->retry) return (int)cudaErrorInvalidValue;
  if (end == first) return 0;
  const int cap = k6_max_blocks();
  if (cap < 0) return -cap;
  const long long tiles = (args->N + K6_THREADS - 1) / K6_THREADS;
  const long long items = (long long)args->S * tiles;
  const int grid = (int)(items < cap ? items : cap);
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&idx,   (void*)&gang,     (void*)&choices,
                    (void*)&css, (void*)&W,     (void*)&first,    (void*)&end,
                    (void*)&boundary, (void*)&append};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ksim_chunk_replay_kernel, grid,
                                              K6_THREADS, params, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
