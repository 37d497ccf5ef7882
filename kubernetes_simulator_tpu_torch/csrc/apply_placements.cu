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

__global__ void __launch_bounds__(K3_THREADS)
    ksim_apply_kernel(KsimArgs a, const int32_t* pods, const int32_t* pos, int32_t* choices,
                      int K, int64_t choice_ss, float sign, int rollback) {
  __shared__ uint8_t active[KSIM_MAX_WAVE];
  const int N = a.N, R = a.R, G = a.G, D = a.D;
  const int64_t scen = blockIdx.x;
  int32_t* ch = choices + scen * choice_ss;
  float* used = a.used + scen * a.used_ss;
  float* match_count = a.match_count + scen * a.plane_ss;
  float* anti_active = a.anti_active + scen * a.plane_ss;
  float* pref_wsum = a.pref_wsum + scen * a.plane_ss;
  if (rollback) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      int p = pods[k], n = ch[pos[k]];
      uint8_t act = 0;
      if (p >= 0 && n >= 0) {
        int g = a.group_id[p];
        if (g >= 0)
          for (int j = 0; j < K; ++j) {
            int pj = pods[j];
            if (pj >= 0 && a.group_id[pj] == g && ch[pos[j]] < 0) act = 1;
          }
      }
      active[k] = act;
    }
    __syncthreads();
  }
  const int tid = threadIdx.x;
  for (int k = 0; k < K; ++k) {
    int p = pods[k];
    if (p < 0) continue;
    int n = ch[pos[k]];
    if (n < 0) continue;
    if (rollback && !active[k]) continue;
    if (tid == 0) {
      for (int t = 0; t < a.AA; ++t) {
        int g = a.anti_req[p * a.AA + t];
        if (g < 0) continue;
        int dom = a.gdom[g * N + n];
        if (dom >= 0) anti_active[g * D + dom] += sign;
      }
      for (int t = 0; t < a.PA; ++t) {
        int g = a.pref_aff[p * a.PA + t];
        if (g < 0) continue;
        int dom = a.gdom[g * N + n];
        if (dom >= 0) pref_wsum[g * D + dom] += sign * a.pref_aff_w[p * a.PA + t];
      }
    } else {
      for (int c = tid - 1; c < R + G; c += blockDim.x - 1) {
        if (c < R) {
          used[(size_t)n * R + c] += sign * a.requests[(size_t)p * R + c];
        } else {
          int g = c - R;
          if (!a.pmg[(size_t)p * G + g]) continue;
          int dom = a.gdom[g * N + n];
          if (dom >= 0) match_count[g * D + dom] += sign;
        }
      }
    }
  }
  if (rollback) {
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      if (active[k]) ch[pos[k]] = KSIM_PAD;
  }
}

KSIM_EXPORT int ksim_apply_placements(const KsimArgs* args, const int32_t* pods,
                                      const int32_t* pos, int32_t* choices, int K,
                                      long long choice_ss, float sign, int rollback,
                                      void* stream) {
  if (K <= 0) return 0;
  if (args->S < 1) return (int)cudaErrorInvalidValue;
  if (rollback && K > KSIM_MAX_WAVE) return (int)cudaErrorInvalidValue;
  ksim_apply_kernel<<<args->S, K3_THREADS, 0, (cudaStream_t)stream>>>(
      *args, pods, pos, choices, K, (int64_t)choice_ss, sign, rollback);
  return (int)cudaGetLastError();
}
