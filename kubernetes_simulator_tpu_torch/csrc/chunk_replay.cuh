// K6 chunk_replay's kernel: waves [first, end) of one chunk over all S scenarios in ONE
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
// The attributed mode (a second instantiation, ATTR; telemetry series and
// timeline on the plain path) also replaces sim/jax_runtime.py:443
// make_chunk_fn_rej with :405 make_wave_step_rej, the reference's
// instrumented chunk program that carries the [K] first-reject counts through
// its scan (ops/tpu.py:816 first_reject_counts over :270
// eval_pod(want_masks=True)): a non-PAD slot whose phase-2 choice over the
// feasible nodes is PAD — the gate before a gang wave's rollback, as :421-423
// take it — runs K5's count body (ksim_reject_count_body) over the block's
// nodes at the pod's own in-scan state (phase 1's term tables still hold),
// the ranks' counts fold into rank 0 through DSMEM (integer sums), and rank 0
// alone charges the scenario (ksim_reject_charge: K5's episode mark,
// attempts and reasons), all before the bind. PAD is uniform over the
// cluster, so the fold's cluster barrier is reached by every thread. The
// summary instantiation compiles none of it, and each instantiation is
// compiled in a translation unit of its own (chunk_replay.cu,
// chunk_replay_attributed.cu, linked into one library): compiled side by
// side, the two changed each other's register allocation and shared-memory
// layout, and the summary build's code with it.
//
// What stays with the host, between launches (sim/torch_runtime.py
// run_waves): the boundary's K3 release, the retry sequence (K1 -> K2 -> K3
// with one pod per scenario, K4) and, at telemetry series on the retry path,
// K5's chunk fold and the retry pass's K5 a slot.
//
// Launch (ops/kernels.py cluster_plan, with blocks of 1,024 threads): a plain
// clustered launch of S * C blocks, no cooperative attribute and no grid
// barrier, so any S runs — clusters that the card cannot hold at once wait for
// free SMs, which is sound only because no cluster ever waits on another. C >
// 1 where the scenarios leave SMs idle (S = 1: C = min(8, ceil(N / 1024))), C
// = 1 where S fills the card (the headline's 128).
//
// Bound on an H100: bytes, as K1 + K2 + K3 per slot (PERF.md, chip_smoke.py
// Work; the attributed mode adds K5's reads for each failed slot): a slot of
// one scenario is a few hundred kilobytes, so the chunk is latency-bound —
// one scenario's K1 body, K2 body (two cluster exchanges at C > 1), a failed
// slot's count body and fold, and the bind in sequence, then the cluster
// barrier, set its pace.
//
// Exactness: compiled with --fmad=false and IEEE division, as K1–K3.
#pragma once
#include "ksim.cuh"

#define K6_THREADS 1024

// The phase stamps (chunk_replay.cu, its stamped build alone); none by default.
#ifndef K6_STAMP
#define K6_STAMP(i, j)
#define K6_STAMP_EDGE(j)
#endif

// The first-reject counters of the attributed mode (K5's: [S, K] i32
// reasons and attempts, [S, P] u8 episode marks, attr_ss = P). They reach the
// attributed kernel through constant memory, written on the launch's stream
// before each launch, so both instantiations take the same parameters.
struct KsimReject {
  int32_t* reasons;
  int32_t* attempts;
  uint8_t* attributed;
  int K;
  int64_t attr_ss;
};
static __constant__ KsimReject ksim_k6_reject;

template <bool ATTR>
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
      [[maybe_unused]] const int got =
          ksim_normalize_select_body(a, p, scen, choices + scen * choice_ss + s, w, lo, hi);
      if constexpr (ATTR) {
        if (got == KSIM_PAD) {  // uniform over the cluster
          int tot[KSIM_PLUGINS + 1];  // thread 0's
          ksim_reject_count_body(a, p, scen, lo, hi, lab, a.used + scen * a.used_ss,
                                 match_count, a.anti_active + scen * a.plane_ss,
                                 a.pref_wsum + scen * a.plane_ss, &terms, tot);
          if (C > 1) ksim_cluster_fold_counts(tot);
          if (lead && threadIdx.x == 0) {
            const KsimReject& rj = ksim_k6_reject;
            ksim_reject_charge(a, tot, scen, p, rj.reasons, rj.attempts, rj.attributed, rj.K,
                               rj.attr_ss);
          }
        }
      }
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

// The attributed instantiation's launch and attributes (chunk_replay_attributed.cu).
int ksim_chunk_replay_attributed_launch(void** params, int grid, int C, const KsimReject& rj,
                                        cudaStream_t stream);
cudaError_t ksim_chunk_replay_attributed_attrs(cudaFuncAttributes* at);
