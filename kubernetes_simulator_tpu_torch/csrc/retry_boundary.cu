// K4 retry_boundary: the bookkeeping of one chunk boundary's retry pass in
// each of S scenarios, one block of 1024 threads per scenario.
//
// Replaces: kubernetes_simulator_tpu/sim/whatif.py:1456-1497, the pend
// append and the buffer compaction of per_scenario_retry (the retry
// variant of _build_chunk_fn :1285), whose semantics are the host pass of
// sim/boundary.py:547-678 (boundary_retry) and sim/greedy.py:110
// greedy_replay(retry_buffer=...).
//
// Runs after the pass: K3 released the pending list's due entries and
// K1 -> K2 -> K3 ran every buffer slot, K2 writing its choice to
// rchoice[s, k]. Then, in scenario s (boundary b, start time t_b as f32):
//   1. each buffered pod the pass placed records its node in rnode[s, pod]
//      and b in rbind_b[s, pod];
//   2. the pending list drops its due entries (relb <= b) and appends, in
//      buffer order, each placed pod whose release boundary exists:
//      rbn = #{i : tbt[i] < t_b + dur[pod]} (np.searchsorted side="left"
//      over the f32 finite boundary times, the f32 sum as the reference
//      forms it); if rbn < B the entry (pod, node, max(rbn, b + 1)) goes
//      on the list. The first RB entries are kept (a release that does not
//      fit is lost: the pod keeps its node to the end, whatif.py:1481);
//   3. the buffer keeps its unplaced pods in FIFO order and rcount[s]
//      becomes their number.
// Entries past a list's end become -1 in every field.
//
// The body is ksim.cuh's ksim_retry_bookkeeping, which K6's retry mode
// (chunk_replay.cuh) runs too: each thread owns a contiguous run of at most
// KSIM_MAX_RB / 1024 buffer slots and pending entries, reads all of them
// before the block writes (the compactions are in place), and block-wide
// exclusive scans of the per-thread counts give every kept entry its
// position: stable, integer-only, no atomics. This launch serves the
// per-slot route (sim/torch_runtime.py run_retry_boundary).
//
// Bound on an H100: bytes — per scenario the buffer, its choices and the
// pending list (RB * 20 B read, RB * 16 B written), the durations and
// tbt entries the searches touch and 8 B per retried bind; launch-bound.
#include "ksim.cuh"

__global__ void __launch_bounds__(KSIM_RB_THREADS) ksim_retry_boundary_kernel(KsimArgs a, int b,
                                                                               float t_b) {
  ksim_retry_bookkeeping(a, blockIdx.x, b, t_b);
}

KSIM_EXPORT int ksim_retry_boundary(const KsimArgs* args, int b, float t_b, void* stream) {
  if (args->S < 1 || !args->retry || args->RB < 1 || args->RB > KSIM_MAX_RB || args->B < 1)
    return (int)cudaErrorInvalidValue;
  ksim_retry_boundary_kernel<<<args->S, KSIM_RB_THREADS, 0, (cudaStream_t)stream>>>(*args, b,
                                                                                     t_b);
  return (int)cudaGetLastError();
}
