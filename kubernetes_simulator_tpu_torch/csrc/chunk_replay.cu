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
//   phase 2  one thread-block cluster of C blocks per scenario, strided over
//            the clusters: K2's body (ksim_normalize_select_body), each block
//            over its rank's part of the node axis, exchanging the cluster's
//            extrema and argmax through DSMEM, writes the choice to column s
//            of the scenario's row of the choice buffer; then the cluster's
//            rank-0 block alone runs K3's bind (ksim_apply_body, K = 1, with
//            the eviction step at `boundary` under tier preemption and the
//            failure append under the retry buffer) and, after the last
//            non-PAD slot of a gang wave, K3's rollback over the wave's W
//            columns; the other ranks go on to the barrier;
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
// Launch (ops/kernels.py cluster_plan): cooperative AND clustered — one
// cudaLaunchKernelEx with cudaLaunchAttributeCooperative and
// cudaLaunchAttributeClusterDimension C, which the H100 accepts, with
// cooperative_groups' grid barrier inside. C > 1 where the scenarios leave
// SMs idle (S = 1: C = min(8, ceil(N / 1024)), a rank owning `span` nodes), C
// = 1 where S fills the card (the headline's 128), the one-block phase 2 of
// before. The grid is `grid` blocks (a multiple of C), every cluster resident
// at once (cudaOccupancyMaxActiveClusters); a launch that does not fit
// raises (no fallback).
//
// Bound on an H100: bytes, as K1 + K2 + K3 per slot (PERF.md, chip_smoke.py
// Work): at S = 1 the work of a slot is a few hundred kilobytes, so the
// chunk is latency-bound — the two grid barriers a slot (and, C > 1, phase
// 2's two cluster barriers) and the phases that run one after the other set
// its pace; at S = 128 phase 1 spreads over every SM.
//
// Exactness: compiled with --fmad=false and IEEE division, as K1–K3.
#include "ksim.cuh"

#define K6_THREADS 1024

__global__ void __launch_bounds__(K6_THREADS, 1)
    ksim_chunk_replay_kernel(KsimArgs a, const int32_t* idx, const uint8_t* gang,
                             int32_t* choices, int64_t choice_ss, int W, int first, int end,
                             int boundary, int append, int span) {
  __shared__ KsimTerms terms;
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  const int S = a.S;
  const int tiles = (a.N + blockDim.x - 1) / blockDim.x;
  const int64_t items = (int64_t)S * tiles;
  const int C = (int)cl.num_blocks();
  const int clusters = gridDim.x / C;
  const bool lead = cl.block_rank() == 0;
  const int lo = min(a.N, (int)cl.block_rank() * span), hi = min(a.N, lo + span);
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
      for (int64_t scen = blockIdx.x / C; scen < S; scen += clusters) {
        ksim_normalize_select_body(a, p, scen, choices + scen * choice_ss + s, w, lo, hi);
        if (lead) {  // uniform over the block
          __syncthreads();
          ksim_apply_body(a, scen, idx + s, 0, nullptr, s, choices, 1, choice_ss, 1.f, 0,
                          boundary, nullptr, 0, append);
          if (k == last) {
            __syncthreads();
            ksim_apply_body(a, scen, idx + base, 0, nullptr, base, choices, W, choice_ss, -1.f,
                            1, -1, nullptr, 0, 0);
          }
          __syncthreads();
        }
      }
      grid.sync();
    }
  }
}

// Clusters of C blocks the card holds at once (the most a launch may take).
KSIM_EXPORT int ksim_chunk_replay_resident(int C) {
  return ksim_resident((const void*)ksim_chunk_replay_kernel, C, K6_THREADS);
}

KSIM_EXPORT int ksim_chunk_replay(const KsimArgs* args, const int32_t* idx, const uint8_t* gang,
                                  int32_t* choices, long long choice_ss, int W, int first,
                                  int end, int boundary, int append, int C, int grid, int span,
                                  void* stream) {
  if (args->S < 1 || W < 1 || W > KSIM_MAX_WAVE || first < 0 || end < first)
    return (int)cudaErrorInvalidValue;
  if ((long long)end * W > choice_ss) return (int)cudaErrorInvalidValue;
  if (boundary >= 0 && !args->preempt) return (int)cudaErrorInvalidValue;
  if (append && !args->retry) return (int)cudaErrorInvalidValue;
  if (C < 1 || C > KSIM_MAX_CLUSTER || grid < C || grid % C || span < 1 ||
      (long long)C * span < args->N)
    return (int)cudaErrorInvalidValue;
  if (end == first) return 0;
  const int cap = ksim_resident((const void*)ksim_chunk_replay_kernel, C, K6_THREADS);
  if (cap < 0) return -cap;
  if (grid / C > cap) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&idx,      (void*)&gang,   (void*)&choices,
                    (void*)&css, (void*)&W,        (void*)&first,  (void*)&end,
                    (void*)&boundary, (void*)&append, (void*)&span};
  return ksim_launch_clusters((const void*)ksim_chunk_replay_kernel, grid, K6_THREADS, C, true,
                              params, (cudaStream_t)stream);
}
