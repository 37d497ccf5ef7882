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
// chunk_replay_attributed.cu and chunk_replay_retry.cu, linked into one
// library): compiled side by side, the summary and attributed builds changed
// each other's register allocation and shared-memory layout, and the summary
// build's code with it.
//
// The retry mode (a third instantiation, RETRY; compiled in
// chunk_replay_retry.cu) also replaces the boundary sequence of
// sim/whatif.py:1413 per_scenario_retry (:1433-1494), the retry variant of
// _build_chunk_fn's chunk program: a launch that starts a chunk at boundary
// b > 0 (or at b = 0, where a chaos node_down evicted pre-bound pods) first
// runs, in each scenario's cluster and in the reference's order,
//   (i)   the pending release of the list's due entries (relb <= b) on rank
//         0 (ksim_pending_release: each node summed from zero in pair order,
//         subtracted once), unless the host's K3 took them with the static
//         bucket (the single replay's joint order); then a cluster barrier;
//   (ii)  the retry pass, for k < rcount[s] (read once, uniform over the
//         cluster: the buffer is dense from 0): the pod rbuf[s, k] through
//         phase 1 and K2's body (the choice to rchoice[s, k]), at series a
//         failed slot charged as K5 charges it (the counters in
//         ksim_k6_reject), rank 0's K3 bind (no append: the buffer holds no
//         gang pod, so no rollback) and, with the event log (a chaos
//         timeline), its bind record, the cluster barrier; rchoice[s, k] for
//         k >= rcount[s] is written PAD, as the per-slot route's K2 writes an
//         empty slot's (its columns past its host bound were never written);
//   (iii) K4's bookkeeping on rank 0 (ksim_retry_bookkeeping), then a
//         cluster barrier;
// and, given sample buffers (telemetry series), copies the scenario's used
// plane (each rank its nodes), buffer count and pending list, and on the
// fold path the chunk-start planes, then a cluster barrier; then the chunk's
// waves (iv), as above, with failure appends. Every decision before a
// barrier — the pass's count, the due pairs, PAD — is uniform over the
// cluster.
//
// Under kube preemption (KsimRetryPhase.kube; the reference's boundary_retry
// with kube=True, sim/boundary.py:547-678, which runs on the host there) (ii)
// and (iii) are the kube pass (chunk_replay_retry.cu ksim_k6_kube_pass): rank
// 0 drops the pending list's due entries and moves the buffer into a ring of
// RB slots (kq); then, until the ring is empty (its count read by every rank
// after a cluster barrier), its head pod through phase 1 and K2's body, and
// where no node admits it the PostFilter (ksim.cuh ksim_post_filter, every
// rank over its nodes, folded through DSMEM), at series after K5's count
// body over the ranks' nodes at the same planes (ksim_k6_kube_counts, out of
// line: folded into rank 0's shared slots, which hold the counts through the
// PostFilter); then rank 0 pops the pod
// and, with a node, commits the victims in order — used minus each one's
// requests and its count planes rewound (ksim_release_cells), its pending
// entry cancelled, its retried node or its choice-buffer column cleared (no
// release fires for it), first_b marked, counted, and pushed onto the ring
// while the unwalked and kept entries number fewer than RB, else counted
// dropped — binds the pod (K3's body), records its node, boundary and first
// bind and appends its pending release while the list holds fewer than RB
// (the reference checks that cap at each bind); without one it keeps the pod
// at the buffer's front and, at series, charges the held counts
// (ksim_reject_charge: a pod the PostFilter rescues carries no reasons); a
// cluster barrier. At series each victim's and each bound pod's episode mark
// is cleared, and at timeline (the event log) a commit appends its victims'
// preempt records and then the pod's bind record. After the pass the samples
// are copied as after (iii). The ring and the compaction keep the storage at
// RB: the rule bounds unwalked plus kept entries by RB, not the entries a
// pass walks. A launch with no waves (first == end) runs the trailing
// boundary at t = inf.
//
// What stays with the host, between launches (sim/torch_runtime.py
// run_waves): the boundary's static K3 release (the reference's separate
// _release_fn, sim/whatif.py:1742) and, at telemetry series on the retry
// path, K5's chunk fold.
//
// Launch (ops/kernels.py cluster_plan, with blocks of 1,024 threads): a plain
// clustered launch of S * C blocks, no cooperative attribute and no grid
// barrier, so any S runs — clusters that the card cannot hold at once wait for
// free SMs, which is sound only because no cluster ever waits on another. C >
// 1 where the scenarios leave SMs idle (S = 1: C = min(8, ceil(N / 1024))), C
// = 1 where S fills the card (the headline's 128).
//
// Bound on an H100: bytes, as K1 + K2 + K3 per slot (PERF.md, chip_smoke.py
// Work; the attributed mode adds K5's reads for each failed slot, the retry
// mode the pass's K1 + K2 + K3 a buffered pod and K4's bytes): a slot of
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

// The retry mode's boundary (RETRY; chunk_replay_retry.cu writes it, and a
// copy of the kernel's KsimArgs, to constant memory on the launch's stream
// before each launch, as the counters are): the boundary b and its f32 start
// time, whether the pending list's due entries are released here, and the
// series samples (null: none) — used [S,N,R], the buffer count [S] and
// pending ids [S,RB] of the boundary, and on the fold path the chunk-start
// planes (used [S,N,R], match_count / anti_active / pref_wsum [S,G,D]). The
// retry pass charges its failed slots when ksim_k6_reject.reasons is set.
// kube = 1 runs the kube pass over the tables in `k` (ksim.cuh KsimKube;
// they travel here, not in KsimArgs, whose size sets the offsets of the
// kernel's other parameters in every build). Under a chaos timeline (evict_t
// set; ksim.cuh KsimRebind) a retried bind also clears a NoExecute victim's
// eviction time and counts its re-bind and latency from the boundary's f64
// start time t_bd, and without kube `k` carries rrel and first_b, which the
// bookkeeping keeps for K10 (evict_node.cu). At telemetry timeline under kube
// or a chaos timeline (log.rec set) the pass appends its preempt and bind
// records to the event log (ksim.cuh KsimLog).
struct KsimRetryPhase {
  int b;
  float t_b;
  int pending;
  int kube;
  float* used_out;
  int32_t* rcount_out;
  int32_t* pend_out;
  float* snap_used;
  float* snap_mc;
  float* snap_aa;
  float* snap_pw;
  KsimKube k;
  double t_bd;
  double* evict_t;
  int32_t* resched;
  double* evict_lat;
  KsimLog log;
};

// The retry mode's boundary sequence (i)-(iii) and samples in scenario scen's
// cluster (the header above), before the chunk's first wave: defined in
// chunk_replay_retry.cu, the only translation unit that calls it.
__device__ __noinline__ void ksim_k6_boundary(int64_t scen, int C, bool lead, int lo, int hi,
                                              KsimTerms* terms);

template <bool ATTR, bool RETRY>
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
  if constexpr (RETRY) ksim_k6_boundary(scen, C, lead, lo, hi, &terms);
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
// The retry instantiation's launch and attributes (chunk_replay_retry.cu).
int ksim_chunk_replay_retry_launch(void** params, int grid, int C, const KsimArgs& args,
                                   const KsimReject& rj, const KsimRetryPhase& ph,
                                   cudaStream_t stream);
cudaError_t ksim_chunk_replay_retry_attrs(cudaFuncAttributes* at);
