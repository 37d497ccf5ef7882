// K9 shard_chunk_replay: waves [first, end) of one chunk on node-sharded
// tables in ONE launch — the per-slot K1 -> K7 -> K8 bind chain of the shard
// route and each gang wave's K8 rollback — as one thread-block cluster a
// scenario that walks the whole chunk, so the host enqueues one launch a
// chunk instead of three a pod slot. It stands to K1 + K7 + K8 as K6
// (chunk_replay.cu) stands to K1 + K2 + K3.
//
// Replaces: kubernetes_simulator_tpu/sim/jax_runtime.py:548
// make_chunk_fn_sharded (one jit'd shard_map over a lax.scan of :494
// make_wave_step_sharded, dispatched once a chunk), whose slot runs
// ops/tpu.py:1059 eval_pod_fused(shard_ctx) -> :1316 select_node_sharded ->
// :1406 apply_binding_sharded, and a gang wave ends with :1435
// apply_unbind_wave_sharded.
//
// The only per-chunk inputs are the device copies of the plan's slot index
// idx [num_waves * W] (the pod of each slot, PAD for an empty one) and its
// gang flags gang [num_waves].
//
// Scenario s is the cluster of blocks [s*C, (s+1)*C) for the whole chunk
// (ops/kernels.py cluster_plan, K7's geometry, blocks of 1,024 threads),
// block rank r owning shards r, r + C, ... of the NP shard blocks of n_local
// nodes in every phase. For each non-PAD slot s = w * W + k (the same pod in
// every scenario, so every block skips a PAD slot alike):
//   phase 1  the pod's term tables (ksim_filter_prologue, from the replicated
//            count planes), then K1's per-node body (ksim_filter_score_node)
//            over the rank's own shards' nodes, a node a thread, n_local
//            tiled by 1,024 (pad rows, n >= n_real, stay infeasible);
//   barrier  the block's (the select reads the rows its threads wrote);
//   phase 2  K7's body (ksim_shard_select_body): each own shard's packed
//            extrema into ext, the cluster fold, each own shard's (max total,
//            lowest global id) pair into best_v / best_i, the cluster fold;
//            the owner of the winner's shard writes the choice into column s
//            and the winner's domain row, from its own gdom block, into
//            cdom[s, slot, :] (unplaced: rank 0 writes PAD into both);
//   barrier  the cluster's: the owner's cdom row and choice reach rank 0;
//   phase 3  K8's bind (ksim_shard_apply_body, K = 1): the owner adds the
//            pod's requests to its used rows, rank 0 (holding shard 0) the
//            count planes at the domain ids of cdom[s, slot, :] — it never
//            reads another shard's gdom block; after the last non-PAD slot of
//            a gang wave, K8's rollback over the wave's W columns, whose
//            grid barrier is a cluster barrier here, before rank 0 writes PAD
//            over the undone choices;
//   barrier  the cluster's (C = 1: the block's), before the next slot's phase
//            1: every rank's prologue reads the count planes rank 0 just
//            wrote, and its nodes the used rows their owner just wrote.
// PAD and the gang wave's `last` are uniform over the cluster, and so is the
// choice after phase 2's fold, so every thread reaches every cluster barrier:
// two in phase 2 at C > 1, one after it, one a slot after phase 3 and one
// more in a rollback.
//
// The bodies are the ones K1, K7 and K8 launch (ksim.cuh), so a chunk on this
// route equals the same chunk on the per-slot shard route bit for bit: every
// reduction is a max, a min or a (value, index) pair with the lowest index on
// ties, and every state cell is updated by one thread in pair order. What
// crosses shards is what the per-slot route exchanges: ext, best_v / best_i
// and cdom in global memory, the extrema and pairs through DSMEM.
//
// What stays with the host, between launches (sim/torch_runtime.py
// run_waves): the boundary's K8 release.
//
// Launch: a plain clustered launch of S * C blocks of 1,024 threads, no
// cooperative attribute and no grid barrier: clusters that the card cannot
// hold at once wait for free SMs, sound because no cluster waits on another.
//
// Bound on an H100: bytes, as K1 + K7 a slot (chip_smoke.py Work): a slot of
// one scenario moves a few hundred kilobytes, so the chunk is latency-bound —
// one scenario's K1 body over a rank's shards, K7's two exchanges and the
// bind in sequence, then the cluster barriers, set its pace.
//
// Exactness: compiled with --fmad=false and IEEE division, as K1, K7 and K8.
#include "ksim.cuh"

#define K9_THREADS 1024

__global__ void __launch_bounds__(K9_THREADS, 1)
    ksim_shard_chunk_replay_kernel(KsimArgs a, const int32_t* idx, const uint8_t* gang,
                                   int32_t* choices, int64_t choice_ss, int W, int first,
                                   int end) {
  __shared__ KsimTerms terms;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int64_t scen = blockIdx.x / C;
  const float* match_count = a.match_count + scen * a.plane_ss;
  const KsimLabels lab = ksim_label_rows(a, scen);
  const auto sync = [&] { ksim_cluster_barrier(C); };
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
      ksim_filter_prologue(a, p, match_count, lab, &terms);
      __syncthreads();
      for (int q = rank; q < a.NP; q += C)
        for (int i = threadIdx.x; i < a.n_local; i += blockDim.x)
          ksim_filter_score_node(a, p, scen, q * a.n_local + i, &terms);
      __syncthreads();  // the select reads the rows the block's threads wrote
      ksim_shard_select_body(a, p, scen, choices, choice_ss, s);
      sync();  // the owner's choice and cdom row, for rank 0's count planes
      ksim_shard_apply_body(a, scen, idx + s, nullptr, s, choices, 1, choice_ss, 1.f, 0, C,
                            rank, rank == 0, sync);
      if (k == last) {
        __syncthreads();
        ksim_shard_apply_body(a, scen, idx + base, nullptr, base, choices, W, choice_ss, -1.f,
                              1, C, rank, rank == 0, sync);
      }
      sync();
    }
  }
}

KSIM_EXPORT int ksim_shard_chunk_replay(const KsimArgs* args, const int32_t* idx,
                                        const uint8_t* gang, int32_t* choices,
                                        long long choice_ss, int W, int first, int end, int C,
                                        int threads, void* stream) {
  // everything K7 and K8 refuse
  if (!args->ext || !args->best_v || !args->best_i || !args->cdom || args->S < 1 ||
      args->NP < 1 || args->preempt || args->retry ||
      (long long)args->NP * args->n_local != args->N)
    return (int)cudaErrorInvalidValue;
  if (W < 1 || W > KSIM_MAX_WAVE || first < 0 || end < first ||
      (long long)end * W > choice_ss)
    return (int)cudaErrorInvalidValue;
  // rank r owns shards r, r + C, ...: any 1 <= C <= min(KSIM_MAX_CLUSTER, NP)
  // (ops/kernels.py shard_chunk_plan picks it)
  if (threads != K9_THREADS || C < 1 || C > KSIM_MAX_CLUSTER || C > args->NP)
    return (int)cudaErrorInvalidValue;
  if (end == first) return 0;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&idx,   (void*)&gang,  (void*)&choices,
                    (void*)&css, (void*)&W,     (void*)&first, (void*)&end};
  return ksim_launch_clusters((const void*)ksim_shard_chunk_replay_kernel, args->S * C,
                              K9_THREADS, C, params, (cudaStream_t)stream);
}

// The kernel's registers a thread, static shared bytes and largest block
// (cudaFuncGetAttributes), for the build's report.
KSIM_EXPORT int ksim_shard_chunk_replay_attrs(int* regs, int* shared_bytes, int* max_threads) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, (const void*)ksim_shard_chunk_replay_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = at.numRegs;
  *shared_bytes = (int)at.sharedSizeBytes;
  *max_threads = at.maxThreadsPerBlock;
  return 0;
}
