// K5 first_reject: the kube "0/N nodes available" attribution of M pod slots
// in each of S scenarios: for every slot whose pod failed (its gate choice is
// PAD) and that no node admits, each node is charged to the FIRST Filter
// plugin, in the reference's order, that rejects it, and the [K] per-plugin
// counts are added to the scenario's rejection_attempts and, on the pod's
// first attributed failure, to its reasons. One block per (slot, scenario):
// grid (M, S), threads stride over the N nodes.
//
// Replaces: kubernetes_simulator_tpu/ops/tpu.py:816 first_reject_counts over
// the per-plugin masks of sim/jax_runtime.py:270 eval_pod(want_masks=True),
// inside make_wave_step_rej (:405, the plain path's instrumented scan), and
// the host attribution of the retry path (sim/boundary.py:360-398
// fold_chunk, :563-582 the retry pass's schedule_one(want_reasons=True)),
// with the episode semantics of sim/telemetry.py:338-404
// (TelemetryCollector.rejection).
//
// Three callers (sim/torch_runtime.py run_waves):
//   plain path   M = 1 per slot, right after K2: gate = the slot's K2 choice
//                (before the wave's gang rollback), state = the pod's own
//                in-scan state;
//   retry pass   M = 1 per buffer slot, right after K2: pods = a column of
//                the buffer (one pod per scenario), gate = rchoice;
//   chunk fold   M = the chunk's C·W slots in one launch, after its last
//                wave: gate = the final choices (after rollbacks), state = a
//                snapshot of the planes at the chunk's start.
// A slot is charged only when no node is feasible, so on the first two
// callers (whose gate already says so) the rule is K2's, and on the fold it
// is the reference's empty pre-chunk mask. The episode mark is never
// cleared: without kube preemption or chaos an episode ends only with a
// bind, after which the pod is not attempted again.
//
// The Filter chain is ksim.cuh's ksim_eval_node (without the score rows),
// K1's own code, with K1's block prologue (bootstrap totals and spread
// minima in shared memory): K1 and K5 cannot disagree on a node.
//
// Bound on an H100: bytes — the same reads as K1's mask (used + alloc and
// the taint / label / domain rows of the pod, per node) and [K] i32 counts
// out; a slot that placed reads two ints and stops. Counts are reduced in
// registers, warp shuffles and shared memory; the cross-block adds are
// integer atomics, so the result does not depend on block order.
#include "ksim.cuh"

#define KSIM_REJECT_THREADS 256

__global__ void __launch_bounds__(KSIM_REJECT_THREADS) ksim_first_reject_kernel(
    KsimArgs a, const int32_t* pods, int64_t pod_ss, const int32_t* gate, int64_t gate_ss,
    int32_t* reasons, int32_t* attempts, uint8_t* attributed, int K, int64_t attr_ss) {
  __shared__ KsimTerms terms;
  __shared__ int s_cnt[KSIM_REJECT_THREADS / 32][KSIM_PLUGINS + 1];

  const int m = blockIdx.x;
  const int64_t scen = blockIdx.y;
  const int p = pods[scen * pod_ss + m];
  if (p < 0 || gate[scen * gate_ss + m] >= 0) return;  // uniform over the block

  const float* match_count = a.match_count + scen * a.plane_ss;
  const float* anti_active = a.anti_active + scen * a.plane_ss;
  const float* pref_wsum = a.pref_wsum + scen * a.plane_ss;
  const float* used_s = a.used + scen * a.used_ss;
  const KsimLabels lab = ksim_label_rows(a, scen);
  ksim_filter_prologue(a, p, match_count, lab, &terms);
  __syncthreads();

  // cnt[k]: nodes plugin k rejects first; cnt[KSIM_PLUGINS]: nodes none rejects
  int cnt[KSIM_PLUGINS + 1];
#pragma unroll
  for (int k = 0; k <= KSIM_PLUGINS; ++k) cnt[k] = 0;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const KsimNodeEval e = ksim_eval_node<false>(a, p, scen, n, lab, used_s, match_count,
                                                 anti_active, pref_wsum, &terms);
    const int first = e.pass == KSIM_PASS_ALL ? KSIM_PLUGINS : __ffs(~e.pass) - 1;
#pragma unroll
    for (int k = 0; k <= KSIM_PLUGINS; ++k) cnt[k] += first == k ? 1 : 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k <= KSIM_PLUGINS; ++k) {
    int v = cnt[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) s_cnt[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int tot[KSIM_PLUGINS + 1];
#pragma unroll
  for (int k = 0; k <= KSIM_PLUGINS; ++k) {
    tot[k] = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot[k] += s_cnt[w][k];
  }
  if (tot[KSIM_PLUGINS] > 0) return;  // a node admits the pod: nothing is charged
  uint8_t* attr = attributed + scen * attr_ss + p;
  const bool first_episode = *attr == 0;
  if (first_episode) *attr = 1;  // one block per (slot, scenario) holds pod p
  int idx = 0;  // the plugin's position among the plugins that are on
  for (int k = 0; k < KSIM_PLUGINS; ++k) {
    if (!ksim_plugin_on(a, k)) continue;
    if (idx < K && tot[k]) {
      atomicAdd(attempts + scen * K + idx, tot[k]);
      if (first_episode) atomicAdd(reasons + scen * K + idx, tot[k]);
    }
    ++idx;
  }
}

KSIM_EXPORT int ksim_first_reject(const KsimArgs* args, const int32_t* pods, long long pod_ss,
                                  int M, const int32_t* gate, long long gate_ss, int32_t* reasons,
                                  int32_t* attempts, uint8_t* attributed, int K,
                                  long long attr_ss, void* stream) {
  if (args->S < 1 || args->S > 65535) return (int)cudaErrorInvalidValue;
  if (M < 1 || K < 1 || K > KSIM_PLUGINS) return (int)cudaErrorInvalidValue;
  const dim3 grid(M, args->S);
  ksim_first_reject_kernel<<<grid, KSIM_REJECT_THREADS, 0, (cudaStream_t)stream>>>(
      *args, pods, (int64_t)pod_ss, gate, (int64_t)gate_ss, reasons, attempts, attributed, K,
      (int64_t)attr_ss);
  return (int)cudaGetLastError();
}
