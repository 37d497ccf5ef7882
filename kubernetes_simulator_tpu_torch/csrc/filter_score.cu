// K1 filter_score: the fused Filter + raw Score of ONE pod slot over all N
// nodes of all S scenarios, one thread per (scenario, node): grid
// (ceil(N/256), S), blockIdx.y selects the scenario.
//
// Replaces: kubernetes_simulator_tpu/ops/tpu3.py:944 make_wave_step3 (its
// per-slot Filter+Score), with build_wave_pre3 (:712), class_masks (:923)
// and _fit_score_r (:869) folded in. Semantics are ops/cpu.py's per-plugin
// chain (the greedy anchor's) and ops/tpu.py:eval_pod's, bit for bit:
//   mask  = fit & taints(NoSchedule/NoExecute) & required node affinity
//           & inter-pod (anti-)affinity incl. the symmetric existing-pod
//           anti term & DoNotSchedule topology spread
//   rows  = fit strategy score (floored int chain), untolerated
//           PreferNoSchedule count, preferred node-affinity weight sum,
//           preferred inter-pod weight sum, ScheduleAnyway spread raw
//           (+ its ignored mask).
// The state is read where it lives: used [N,R] by row, the [G,D] count
// planes through gdom [G,N] by direct indexing (no one-hot contractions),
// each at its scenario's offset (KsimArgs *_ss strides; the what-if batch
// of sim/whatif.py:1285 _build_chunk_fn vmaps the same step over S). A
// prologue per block reduces the pod's few term rows of its scenario over
// D (bootstrap totals of required-affinity groups, min counts of
// DoNotSchedule spread groups) into shared memory. The Filter chain and the
// raw rows are ksim.cuh's ksim_filter_prologue / ksim_eval_node, shared with
// K5 (first_reject.cu), so the two kernels judge every node alike.
//
// Per-scenario policies (row B1w: ops/tpu3.py:1316-1329, the v2 form
// ops/tpu.py:1160-1175): with policy rows (a.wrow), scenario s scores
// NodeResourcesFit with LeastAllocated where its row's selector is > 0.5 and
// MostAllocated elsewhere, unless the static strategy is
// RequestedToCapacityRatio (ksim_fit_strategy). One 4-byte load a thread;
// null wrow keeps the static strategy.
//
// Relabelled scenarios (set_label; the dyn sections of make_wave_step3,
// ops/tpu3.py:798-846, 1054-1059, 1222-1285, and build_wave_pre3(dyn)
// :712): each block loads its scenario's label row lrow[s] once and reads
// expr_match, gdom, gnd and sp_w there. Domain ids are dense per row, so
// the spread minimum over [0, gnd) needs no existence mask.
//
// Bound on an H100: bytes. Each slot reads used + alloc (S·N·R·8 B), the
// taint/label/domain rows it touches and writes 7 B + 20 B per
// scenario-node; the arithmetic is a few dozen flops per node. At S=1,
// N=5000 that is ~0.4 MB (~0.1 µs at 3.35 TB/s, launch-bound); at S=128,
// N=2000 the grid of 1,024 blocks fills the card (see PERF.md).
//
// Under tier preemption (ops/tpu3.py:1062-1088, 1510-1560) a pod that may
// preempt also gets its candidate row (sim/tiers.py), read by K2 when no
// node is feasible.
//
// The retry pass of the retry buffer (sim/whatif.py:1444-1455) runs one pod
// per scenario: given pod_of_s, scenario s's blocks take pod
// pod_of_s[s * pod_ss] (a column of its buffer); an empty slot (-1) writes
// an all-zero mask, rows and ignored mask, so K2 selects nothing there.
//
// Node shards (row B13: eval_pod_fused(shard_ctx), ops/tpu.py:1059): the
// launch is the unsharded one over the padded node axis. Filter and Score
// are per node and the count planes are replicated, so each node's mask and
// rows are the unsharded ones; a node of global id >= n_real is a pad row
// and never feasible (ops/tpu.py:1096-1100, ksim_filter_score_body). Each
// shard's packed extrema are reduced by K7 (shard_select.cu) over its own
// block. The reference's spread pmin (:1134-1137) has no work here: the
// domain-space counts every shard reads are the global ones.
//
// Exactness: compiled with --fmad=false and IEEE division; every
// expression keeps the reference's operation order.
#include "ksim.cuh"

// The body is ksim.cuh's ksim_filter_score_body, which K6 (chunk_replay.cu)
// runs too: one block of 256 threads per (node tile, scenario).
__global__ void __launch_bounds__(256) ksim_filter_score_kernel(KsimArgs a, int p_shared,
                                                                const int32_t* pod_of_s,
                                                                int64_t pod_ss) {
  __shared__ KsimTerms terms;
  const int64_t scen = blockIdx.y;
  const int p = pod_of_s ? pod_of_s[scen * pod_ss] : p_shared;
  ksim_filter_score_body(a, p, scen, blockIdx.x * blockDim.x + threadIdx.x, &terms);
}

KSIM_EXPORT int ksim_filter_score(const KsimArgs* args, int pod, const int32_t* pod_of_s,
                                  long long pod_ss, void* stream) {
  const int threads = 256;
  if (args->S < 1 || args->S > 65535) return (int)cudaErrorInvalidValue;
  if (pod_of_s && args->preempt) return (int)cudaErrorInvalidValue;
  const dim3 grid((args->N + threads - 1) / threads, args->S);
  ksim_filter_score_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*args, pod, pod_of_s,
                                                                       (int64_t)pod_ss);
  return (int)cudaGetLastError();
}
