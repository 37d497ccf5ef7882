// K3 apply_placements: add sign × (state contribution) of K (pod, node)
// pairs to the carried state of each of S scenarios — used [S,N,R] and the
// match_count / anti_active / pref_wsum [S,G,D] planes — in pair order, one
// block per scenario.
//
// Replaces: kubernetes_simulator_tpu/sim/jax_runtime.py:1414 _apply_release
// and :1475 _donated_subtract (the single-scenario completion release),
// kubernetes_simulator_tpu/sim/whatif.py:1620 _release_core / :1742
// _release_fn (the per-scenario device releases from static buckets) and
// the commit / gang rollback of ops/tpu3.py:944 make_wave_step3.
//
// The pods are shared by the scenarios; each scenario's node for pair k
// is read on the device from its row of the choice buffer,
// choices[s * choice_ss + pos[k]] (PAD = not placed). Three uses:
//   bind      sign +1, K = 1, the node K2 wrote for the slot — no host
//             sync per pod;
//   rollback  sign -1 over one wave's slots: a pair is undone iff its pod
//             placed and some slot of the same gang (group_id) in the wave
//             went unplaced in that scenario; its choice is then
//             overwritten with PAD (all-or-nothing gang commit,
//             models/state.unbind order);
//   release   sign -1 over one boundary's static bucket of pods (pod
//             order); unplaced and rolled-back pods read PAD and are
//             skipped, pre-bound pods read their bound node from the
//             buffer's static tail.
// Pairs with a pod or node of -1 are skipped, so padded slots and PAD
// domains never touch column 0 of a plane.
//
// Retry buffer (sim/whatif.py:1406-1557; the host FIFO of sim/boundary.py):
// the pod list may be per scenario (pod_ss > 0: scenario s reads pods +
// s * pod_ss), as in two more uses:
//   retry bind    sign +1, K = 1, the pod in scenario s's buffer slot and
//                 the node K2 wrote for it in rchoice;
//   pending       sign -1 over a scenario's pending list (pend_id, nodes
//   release       pend_node), only the pairs whose due_relb <= due_b
//                 (sim/whatif.py:1437-1443), in list order.
// And a main-path bind with append = 1 also appends a failed non-gang pod
// (node -1) to its scenario's FIFO at rbuf[s, rcount[s]], or counts it in
// rdrop[s] when the buffer is full (sim/whatif.py:1502-1528): thread 0 of
// the scenario's block, in pair order.
//
// Relabelled scenarios (set_label; the dyn release of sim/whatif.py
// :1760-1817 and the dyn commit of make_wave_step3): each block reads the
// node domains gdom of its scenario's label row lrow[s], in every use.
//
// Tier preemption (ops/tpu3.py:1629-1730, 1796; sim/whatif.py:2145
// _tier_rel_fn / :2161 _npods_rel_fn): every pair of a non-gang pod also
// moves its tier's cells used_tier[tier, n, :] and npods_tier[tier, n] (a
// bind adds, a release subtracts; a rollback only undoes gang pods, which
// the tier planes never hold), and a bind given a boundary >= 0 first
// applies the slot's eviction record (ksim_evict).
//
// No float atomics: within a scenario's block every state cell belongs to
// one thread for the whole launch (thread 0 the anti/pref terms, whose
// group ids may repeat within a pod; the others a used column or a
// match_count row), and that thread applies the pairs in order —
// deterministic sums equal to models/state._apply applied pod after pod.
// Scenarios touch disjoint state.
//
// Bound on an H100: bytes — per pair and scenario R·4 + G + a few words;
// launch-bound at K = 1, latency-bound by the in-order walk at release
// sizes (the S blocks walk in parallel).
#include "ksim.cuh"

#define K3_THREADS 256

// The body, with the eviction step, is ksim.cuh's ksim_apply_body (and
// ksim_evict), which K6 (chunk_replay.cu) runs too.
__global__ void __launch_bounds__(K3_THREADS)
    ksim_apply_kernel(KsimArgs a, const int32_t* pods_all, int64_t pod_ss, const int32_t* pos,
                      int32_t* choices, int K, int64_t choice_ss, float sign, int rollback,
                      int boundary, const int32_t* due_relb, int due_b, int append) {
  ksim_apply_body(a, blockIdx.x, pods_all, pod_ss, pos, 0, choices, K, choice_ss, sign,
                  rollback, boundary, due_relb, due_b, append);
}

KSIM_EXPORT int ksim_apply_placements(const KsimArgs* args, const int32_t* pods,
                                      long long pod_ss, const int32_t* pos, int32_t* choices,
                                      int K, long long choice_ss, float sign, int rollback,
                                      int boundary, const int32_t* due_relb, int due_b,
                                      int append, void* stream) {
  if (K <= 0) return 0;
  if (args->S < 1) return (int)cudaErrorInvalidValue;
  if (rollback && (K > KSIM_MAX_WAVE || pod_ss)) return (int)cudaErrorInvalidValue;
  if (boundary >= 0 && (K != 1 || rollback)) return (int)cudaErrorInvalidValue;
  if ((append || due_relb || pod_ss) && !args->retry) return (int)cudaErrorInvalidValue;
  ksim_apply_kernel<<<args->S, K3_THREADS, 0, (cudaStream_t)stream>>>(
      *args, pods, (int64_t)pod_ss, pos, choices, K, (int64_t)choice_ss, sign, rollback,
      boundary, due_relb, due_b, append);
  return (int)cudaGetLastError();
}
