// K8 shard_apply: add sign x the state contribution of K (pod, node) pairs to
// one scenario's node-sharded state, in pair order, one cooperative launch of
// NP * S blocks (block b: shard b % NP of scenario b / NP).
//
// Replaces: kubernetes_simulator_tpu/ops/tpu.py:1406 apply_binding_sharded
// (the owner-masked bind), :1435 apply_unbind_wave_sharded (the gang
// rollback from the wave's stacked domain rows) and the sharded release
// (the node-space delta of sim/jax_runtime.py:1224-1240 _to_dev_state_v2,
// subtracted from each shard's block).
//
// Pair k is pod pods[k] at the node of choice-buffer column pos[k] of the
// scenario's row (PAD pods and nodes are skipped). Three uses, as K3's:
//   bind      sign +1, K = 1, the slot K7 (shard_select.cu) just chose;
//   rollback  sign -1 over one wave's W slots: a pair is undone iff its pod
//             placed and a slot of the same gang in the wave went unplaced;
//             its choice is then overwritten with PAD;
//   release   sign -1 over one boundary's static bucket (pod order).
// Who writes what (one writer a cell, no float atomics):
//   - shard q's block owns the used rows of its node block [q * n_local,
//     (q + 1) * n_local): within it thread 1 + c owns column c and applies
//     the pairs whose node it owns in pair order; a release sums each
//     node's requests from zero in pair order and subtracts them once (the
//     reference's release delta; K3's order, the rel accumulator);
//   - the count planes [G, D] are replicated state, kept once on the card:
//     shard 0's block is their writer (thread 0 the anti-affinity and
//     preferred-affinity terms, whose group ids may repeat within a pod;
//     thread 1 + R + g the match_count row of group g) and applies every
//     pair at the domain ids of its column, cdom[s, pos[k], :], which K7's
//     owner wrote — never another shard's node tables (the stacked
//     gdom_at / has_dom rows of the reference's rollback);
//   - a rollback's PAD writes wait for a grid barrier, so every block has
//     read the wave's choices first; shard 0 writes them.
// Each shard reads the pod tables and the choice buffer, which every shard
// holds, and its own node block: on separate cards only cdom would cross.
//
// Bound on an H100: bytes — per pair R * 4 + G + a few words; launch-bound
// at K = 1, latency-bound by the in-order walk at release sizes.
#include "ksim.cuh"

#define K8_THREADS 256

// The pairs' walk is ksim.cuh's ksim_shard_apply_body (block b: shard b % NP
// of scenario b / NP, owning its own block of nodes; shard 0's block the count
// planes; a rollback's barrier the grid's), which K9 (shard_chunk_replay.cu)
// runs for every bind and gang rollback of a chunk.
__global__ void __launch_bounds__(K8_THREADS)
    ksim_shard_apply_kernel(KsimArgs a, const int32_t* pods, const int32_t* pos,
                            int32_t* choices, int K, int64_t choice_ss, float sign,
                            int rollback) {
  cg::grid_group grid = cg::this_grid();
  const int shard = blockIdx.x % a.NP;
  const int64_t scen = blockIdx.x / a.NP;
  ksim_shard_apply_body(a, scen, pods, pos, 0, choices, K, choice_ss, sign, rollback, a.NP,
                        shard, shard == 0, [&] { grid.sync(); });
}

KSIM_EXPORT int ksim_shard_apply(const KsimArgs* args, const int32_t* pods, const int32_t* pos,
                                 int32_t* choices, int K, long long choice_ss, float sign,
                                 int rollback, void* stream) {
  if (K <= 0) return 0;
  if (!args->cdom || args->S < 1 || args->NP < 1 || args->preempt || args->retry ||
      (long long)args->NP * args->n_local != args->N || (rollback && K > KSIM_MAX_WAVE))
    return (int)cudaErrorInvalidValue;
  const int cap = ksim_resident((const void*)ksim_shard_apply_kernel, K8_THREADS);
  if (cap < 0) return -cap;
  const long long blocks = (long long)args->NP * args->S;
  if (blocks > cap) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&pods,  (void*)&pos,  (void*)&choices,
                    (void*)&K,   (void*)&css,   (void*)&sign, (void*)&rollback};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ksim_shard_apply_kernel,
                                              (int)blocks, K8_THREADS, params, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
