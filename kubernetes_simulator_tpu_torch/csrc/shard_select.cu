// K7 shard_select: the two-stage node choice of ONE pod slot over NP node
// shards of each of S scenarios, one thread-block cluster of C = min(NP, 8)
// blocks per scenario (block rank r owns shards r, r + C, ...; C = 1 where S
// alone fills the card), launched with cudaLaunchKernelEx and a cluster
// dimension, not cooperatively: scenarios are independent.
//
// Replaces: kubernetes_simulator_tpu/ops/tpu.py:1316 select_node_sharded
// (the two-phase program: an all_gather of each shard's (score, global id)
// pair, a static fold, and the owner-masked psum of the winner's domain
// row), together with the sharded normalize of eval_pod_fused (:1200-1225:
// the one packed pmax of the normalization extrema and the any-feasible
// bit) that feeds it.
//
// Inputs: K1 (filter_score.cu, over the padded node axis, pad rows masked)
// left the mask and raw Score rows in the scratch rows; shard q's are its
// node block's. Phases:
//   (0) each block reduces each of its shards' packed normalization extrema
//       and any-feasible bit over the shard's own node block (K2's pass 1,
//       ksim_extrema_node) into the shard's row of ext [S, NP, 7] — each
//       shard's half of the reference's packed pmax (:1211-1223) — folds
//       them and pushes the fold into every peer's shared memory (DSMEM);
//   cluster barrier;
//   (a) every block folds the C blocks' extrema (the pmax exchange; max and
//       min are exact in any order, and an empty shard's identities are
//       neutral) into the global extrema, and derives the row constants
//       exactly as K2 does (ksim_norm);
//   (b) the block normalizes each of its shards' rows against them, takes
//       the weighted total in K2's order (ksim_total) and reduces the
//       shard's (max total, lowest global id) pair; a shard with no feasible
//       node gives (-inf, INT32_MAX), which loses every fold
//       (ops/tpu.py:1366-1367, with an i32 max in place of the f32 2^31);
//       the pair goes to best_v / best_i [S, NP] (the all_gather); the
//       block folds its shards' pairs in shard order and pushes the fold
//       into every peer's shared memory;
//   cluster barrier;
//   (c) every block folds the C pairs: the larger total wins, the lower
//       global id on equal totals — a total order, so this is the
//       replicated fold in shard order;
//   (d) the block owning the winner's shard (winner / n_local) writes the
//       choice into column `slot` of the scenario's row of the choice buffer
//       and the winner's domain ids under every group's key, read from its
//       own node -> domain block (gdom), into cdom[s, slot, :] (the
//       counterpart of gdom_at / has_dom and the owner-masked psum);
//       unplaced, rank 0 writes PAD into both. K8 (shard_apply.cu) reads
//       them.
// The choice equals K2's on the unsharded tables bit for bit: the extrema
// are the same values, ksim_norm / ksim_total are K2's own code, and the
// (max, lowest id) fold over contiguous blocks is the lowest-index argmax.
//
// Every shard reads node-axis data only from its own block. On one card the
// exchange between shards travels in DSMEM; the global buffers ext, best_v /
// best_i and cdom are still written — they are the cross-card contract
// (shards on separate cards would move only those) and what the checks hold
// against the twin.
//
// Bound on an H100: bytes — one read of the [5, N] f32 rows and the [N]
// masks (~0.28 MB at config13's N = 10,000: 0.08 us at 3.35 TB/s); at one
// scenario the launch is latency-bound (two block reductions a shard and
// two cluster barriers a slot).
//
// Exactness: compiled with --fmad=false and IEEE division, as K2.
#include "ksim.cuh"

#define K7_THREADS 1024

// The phases are ksim.cuh's ksim_shard_select_body, which K9
// (shard_chunk_replay.cu) runs for every slot of a chunk.
__global__ void __launch_bounds__(K7_THREADS)
    ksim_shard_select_kernel(KsimArgs a, int p, int32_t* choices, int64_t choice_ss,
                             int slot) {
  const int64_t scen = blockIdx.x / cg::this_cluster().num_blocks();
  ksim_shard_select_body(a, p, scen, choices, choice_ss, slot);
}

KSIM_EXPORT int ksim_shard_select(const KsimArgs* args, int pod, int32_t* choices,
                                  long long choice_ss, int slot, int C, int threads,
                                  void* stream) {
  if (!args->ext || !args->best_v || !args->best_i || !args->cdom || args->S < 1 ||
      args->NP < 1 || pod < 0 || slot < 0 || slot >= choice_ss || args->preempt ||
      (long long)args->NP * args->n_local != args->N)
    return (int)cudaErrorInvalidValue;
  if (C < 1 || C > KSIM_MAX_CLUSTER || C > args->NP || threads < 32 || threads > K7_THREADS ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&pod, (void*)&choices, (void*)&css, (void*)&slot};
  return ksim_launch_clusters((const void*)ksim_shard_select_kernel, args->S * C, threads, C,
                              params, (cudaStream_t)stream);
}
