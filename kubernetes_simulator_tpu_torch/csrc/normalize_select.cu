// K2 normalize_select: per-plugin NormalizeScore, the weighted total and
// the node choice of ONE pod slot in each of S scenarios, one thread-block
// cluster of C blocks per scenario (the scenario axis of sim/whatif.py:1285
// _build_chunk_fn).
//
// Replaces: kubernetes_simulator_tpu/ops/tpu.py:739 select_node (and the
// packed variant :840 the TPU build takes under its f32 gate) plus the
// normalize step of ops/tpu3.py:944 make_wave_step3 — ops/tpu.py
// _normalize_row (:699) and spread_norm_from_extrema (:565), including the
// int32 floor-division form when the static sp_norm_f32 gate is off.
//
//   pass 1  masked extrema over the feasible nodes: max of the taint and
//           node-affinity raws (0-filled), min/max of the inter-pod raw,
//           min/max of the spread raw over feasible & ~ignored;
//   pass 2  normalized rows, total = Σ w·row in the reference's plugin
//           order, and the argmax with lowest-index ties; placed iff the
//           best masked total is > -inf.
// Scenario s's choice (or -1) is written to the device int32
// choice_out[s * choice_ss] — nothing returns to the host per slot.
// Under tier preemption a scenario with no feasible node may instead take
// the masked argmin of K1's candidate row (ops/tpu.py:788 masked_argmin),
// once per wave, and writes the eviction record (ev_node, ev_tier) that
// K3 applies before the bind; every other scenario writes ev_node = -1.
//
// Per-scenario policies (row B1w: ops/tpu.py:62 policy_weight_fns, the
// wvec fold of ops/tpu3.py:947-985 and ops/tpu.py:1074 eval_pod_fused):
// with policy rows (a.wrow) the five weights are scenario s's row, read once
// per block; each w·row product is rounded to f32 and added in the plugin
// order (--fmad=false: no contraction), as the reference's traced fold and
// the greedy anchor's `total += w * normalize(...)` compute it. The
// reference turns its packed select off under wvec; this kernel never
// packs: its (value, index) reduction gives the lowest index on ties of
// non-integer totals too.
//
// The retry pass (sim/whatif.py:1444-1455) selects for one pod per
// scenario: given pod_of_s, scenario s's blocks take pod pod_of_s[s *
// pod_ss] and an empty buffer slot (-1) writes -1.
//
// Cluster layout (ops/kernels.py cluster_plan): scenario s is the cluster of
// blocks [s*C, (s+1)*C); block rank r owns the nodes [r*span, (r+1)*span) of
// the node axis. Each pass ends in a block reduction; then (C > 1) each
// block pushes its result into every peer's shared memory through DSMEM, and
// after a cluster barrier folds the C results (ksim.cuh, ksim_cluster_push_*
// / ksim_cluster_fold_*), so the C blocks hold the same extrema and the same
// choice as one block over all N nodes, bit for bit; rank 0 writes. C = 1
// (S alone fills the card) is the one-block body.
//
// Bound on an H100: bytes — one read of the [5,N] f32 rows and the [N]
// masks per scenario (~0.11 MB at S=1, N=5000; ~5.6 MB at S=128, N=2000:
// 1.7 µs at 3.35 TB/s). The work is a few dependent loads and two
// reductions a pass, so it is bound by latency: one block of 1024 threads
// walked 5 nodes a thread a pass at S=1, N=5000 on one SM; a cluster of 5
// walks one, on 5 SMs, for two cluster barriers and two DSMEM folds.
#include "ksim.cuh"

#define K2_THREADS 1024

// The body is ksim.cuh's ksim_normalize_select_body, which K6
// (chunk_replay.cu) runs too.
__global__ void __launch_bounds__(K2_THREADS)
    ksim_normalize_select_kernel(KsimArgs a, int p_shared, int* choice_out, int64_t choice_ss,
                                 int wave, const int32_t* pod_of_s, int64_t pod_ss, int span) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int64_t scen = blockIdx.x / C;
  const int lo = min(a.N, (int)cl.block_rank() * span), hi = min(a.N, lo + span);
  const int p = pod_of_s ? pod_of_s[scen * pod_ss] : p_shared;
  ksim_normalize_select_body(a, p, scen, choice_out + scen * choice_ss, wave, lo, hi);
}

KSIM_EXPORT int ksim_normalize_select(const KsimArgs* args, int pod, int* choice_out,
                                      long long choice_ss, int wave, const int32_t* pod_of_s,
                                      long long pod_ss, int C, int threads, int span,
                                      void* stream) {
  if (args->S < 1 || C < 1 || C > KSIM_MAX_CLUSTER || threads < 32 ||
      threads > K2_THREADS || threads % 32 || span < 1 || (long long)C * span < args->N)
    return (int)cudaErrorInvalidValue;
  if (pod_of_s && args->preempt) return (int)cudaErrorInvalidValue;
  int64_t css = (int64_t)choice_ss, pss = (int64_t)pod_ss;
  void* params[] = {(void*)args, (void*)&pod, (void*)&choice_out, (void*)&css,
                    (void*)&wave, (void*)&pod_of_s, (void*)&pss, (void*)&span};
  return ksim_launch_clusters((const void*)ksim_normalize_select_kernel, args->S * C, threads,
                              C, params, (cudaStream_t)stream);
}
