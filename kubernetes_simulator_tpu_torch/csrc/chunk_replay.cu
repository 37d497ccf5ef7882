// K6 chunk_replay: waves [first, end) of one chunk over all S scenarios in ONE
// launch — the per-slot K1 -> K2 -> K3 chain and each gang wave's rollback —
// as one thread-block cluster a scenario that walks the whole chunk, so the
// host enqueues one launch a chunk instead of three a pod slot.
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
//
// Nothing in a slot crosses scenarios: every state plane and scratch row is
// [S, ...], the pod tables, idx and gang are read-only, and each scenario owns
// its row of the choice buffer. So scenario s is the cluster of blocks
// [s*C, (s+1)*C) for the whole chunk, block rank r owning the nodes
// [r*span, min(N, (r+1)*span)) in both phases, and for each non-PAD slot
// s = w * W + k (the same pod in every scenario, so every block skips a PAD
// slot alike):
//   phase 1  the pod's term tables (ksim_filter_prologue), then K1's per-node
//            body (ksim_filter_score_node) over the block's own nodes, a node
//            a thread, tiled by the block width where span > 1,024: the mask,
//            the raw Score rows and, under tier preemption, the candidate row;
//   barrier  the block's (phase 2 reads only the nodes its block just wrote);
//   phase 2  K2's body (ksim_normalize_select_body) with its cluster exchange
//            of extrema and argmax through DSMEM; the choice goes to column s
//            of the scenario's row of the choice buffer; then the rank-0 block
//            alone runs K3's bind (ksim_apply_body, K = 1, with the eviction
//            step at `boundary` under tier preemption and the failure append
//            under the retry buffer) and, after the last non-PAD slot of a
//            gang wave, K3's rollback over the wave's W columns;
//   barrier  the cluster's (C = 1: the block's), the only one between the
//            bind and the next slot's phase 1: its release/acquire at cluster
//            scope makes rank 0's writes to used, the count and tier planes,
//            the retry buffer and the choice row visible to every rank, and
//            every peer has folded the exchange slots before they are
//            rewritten.
// PAD, `fire` and the gang wave's `last` are uniform over the cluster, so
// every thread reaches every cluster barrier.
//
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
// Launch (ops/kernels.py cluster_plan, with blocks of 1,024 threads): a plain
// clustered launch of S * C blocks, no cooperative attribute and no grid
// barrier, so any S runs — clusters that the card cannot hold at once wait for
// free SMs, which is sound only because no cluster ever waits on another. C >
// 1 where the scenarios leave SMs idle (S = 1: C = min(8, ceil(N / 1024))), C
// = 1 where S fills the card (the headline's 128).
//
// Bound on an H100: bytes, as K1 + K2 + K3 per slot (PERF.md, chip_smoke.py
// Work): a slot of one scenario is a few hundred kilobytes, so the chunk is
// latency-bound — one scenario's K1 body, K2 body (two cluster exchanges at
// C > 1) and bind in sequence, then the cluster barrier, set its pace.
//
// Exactness: compiled with --fmad=false and IEEE division, as K1–K3.
#include "ksim.cuh"

#define K6_THREADS 1024

// Phase stamps, for scripts/cluster_sweep.py --split alone: that script builds
// this file with -DKSIM_K6_STAMPS into a library of its own; the kernels'
// build defines nothing and carries no stamp. Thread 0 of block 0 (scenario
// 0's rank 0) records clock64() at K6_POINTS points of each of the launch's
// first K6_STAMP_SLOTS non-PAD slots — the slot's start, the prologue's end,
// phase 1's end, phase 2's K2 body's end, the bind's end, the cluster
// barrier's end — and (%globaltimer, clock64()) at the launch's start and end,
// which give the clock's rate.
#ifdef KSIM_K6_STAMPS
#define K6_STAMP_SLOTS 4096
#define K6_POINTS 6
__device__ long long ksim_k6_stamps[4 + K6_STAMP_SLOTS * K6_POINTS];
__device__ __forceinline__ long long ksim_globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K6_STAMP(i, j)                                                     \
  do {                                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (i) < K6_STAMP_SLOTS)       \
      ksim_k6_stamps[4 + (i) * K6_POINTS + (j)] = clock64();               \
  } while (0)
#define K6_STAMP_EDGE(j)                                                   \
  do {                                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                             \
      ksim_k6_stamps[2 * (j)] = ksim_globaltimer();                        \
      ksim_k6_stamps[2 * (j) + 1] = clock64();                             \
    }                                                                      \
  } while (0)
// Copy the first n stamps to the host buffer `out`.
KSIM_EXPORT int ksim_chunk_replay_stamps(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ksim_k6_stamps, n * sizeof(long long));
}
#else
#define K6_STAMP(i, j)
#define K6_STAMP_EDGE(j)
#endif

__global__ void __launch_bounds__(K6_THREADS, 1)
    ksim_chunk_replay_kernel(KsimArgs a, const int32_t* idx, const uint8_t* gang,
                             int32_t* choices, int64_t choice_ss, int W, int first, int end,
                             int boundary, int append, int span) {
  __shared__ KsimTerms terms;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int64_t scen = blockIdx.x / C;
  const bool lead = cl.block_rank() == 0;
  const int lo = min(a.N, (int)cl.block_rank() * span), hi = min(a.N, lo + span);
  const float* match_count = a.match_count + scen * a.plane_ss;
  const KsimLabels lab = ksim_label_rows(a, scen);
  int ns = 0;  // non-PAD slots so far (the stamps' index)
  K6_STAMP_EDGE(0);
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
      K6_STAMP(ns, 0);
      ksim_filter_prologue(a, p, match_count, lab, &terms);
      __syncthreads();
      K6_STAMP(ns, 1);
      for (int n = lo + threadIdx.x; n < hi; n += blockDim.x)
        ksim_filter_score_node(a, p, scen, n, &terms);
      __syncthreads();  // phase 2 reads the rows the block's threads wrote
      K6_STAMP(ns, 2);
      ksim_normalize_select_body(a, p, scen, choices + scen * choice_ss + s, w, lo, hi);
      K6_STAMP(ns, 3);
      if (lead) {  // uniform over the block
        __syncthreads();
        ksim_apply_body(a, scen, idx + s, 0, nullptr, s, choices, 1, choice_ss, 1.f, 0,
                        boundary, append);
        if (k == last) {
          __syncthreads();
          ksim_apply_body(a, scen, idx + base, 0, nullptr, base, choices, W, choice_ss, -1.f,
                          1, -1, 0);
        }
      }
      K6_STAMP(ns, 4);
      if (C > 1)
        cl.sync();
      else
        __syncthreads();
      K6_STAMP(ns, 5);
      ++ns;
    }
  }
  K6_STAMP_EDGE(1);
}

KSIM_EXPORT int ksim_chunk_replay(const KsimArgs* args, const int32_t* idx, const uint8_t* gang,
                                  int32_t* choices, long long choice_ss, int W, int first,
                                  int end, int boundary, int append, int C, int threads,
                                  int span, void* stream) {
  if (args->S < 1 || W < 1 || W > KSIM_MAX_WAVE || first < 0 || end < first)
    return (int)cudaErrorInvalidValue;
  if ((long long)end * W > choice_ss) return (int)cudaErrorInvalidValue;
  if (boundary >= 0 && !args->preempt) return (int)cudaErrorInvalidValue;
  if (append && !args->retry) return (int)cudaErrorInvalidValue;
  if (threads != K6_THREADS) return (int)cudaErrorInvalidValue;  // ops/kernels.py chunk_plan
  if (C < 1 || C > KSIM_MAX_CLUSTER || span < 1 || (long long)C * span < args->N ||
      (long long)(C - 1) * span >= args->N)
    return (int)cudaErrorInvalidValue;
  if (end == first) return 0;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&idx,      (void*)&gang,   (void*)&choices,
                    (void*)&css, (void*)&W,        (void*)&first,  (void*)&end,
                    (void*)&boundary, (void*)&append, (void*)&span};
  return ksim_launch_clusters((const void*)ksim_chunk_replay_kernel, args->S * C, K6_THREADS, C,
                              params, (cudaStream_t)stream);
}
