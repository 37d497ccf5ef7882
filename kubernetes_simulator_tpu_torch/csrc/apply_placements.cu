// K3 apply_placements: add sign × (state contribution) of K (pod, node)
// pairs to the carried state — used [N,R] and the match_count /
// anti_active / pref_wsum [G,D] planes — in pair order, one block.
//
// Replaces: kubernetes_simulator_tpu/sim/jax_runtime.py:1414 _apply_release
// and :1475 _donated_subtract (the single-scenario completion release) and
// the commit / gang rollback of ops/tpu3.py:944 make_wave_step3. Three uses:
//   bind      sign +1, K = 1, the node read from K2's device output — no
//             host sync per pod;
//   rollback  sign -1 over one wave's slots: a pair is undone iff its pod
//             placed and some slot of the same gang (group_id) in the wave
//             went unplaced; its choice is then overwritten with -1
//             (all-or-nothing gang commit, models/state.unbind order);
//   release   sign -1 over the pods that completed at a chunk boundary.
// Pairs with a pod or node of -1 are skipped, so padded slots and PAD
// domains never touch column 0 of a plane.
//
// No float atomics: every state cell belongs to one thread for the whole
// launch (thread 0 the anti/pref terms, whose group ids may repeat within
// a pod; the others a used column or a match_count row), and that thread
// applies the pairs in order — deterministic sums equal to
// models/state._apply applied pod after pod.
//
// Bound on an H100: bytes — per pair R·4 + G + a few words; launch-bound
// at K = 1, latency-bound by the in-order walk at release sizes.
#include "ksim.cuh"

#define K3_THREADS 256

__global__ void __launch_bounds__(K3_THREADS) ksim_apply_kernel(KsimArgs a, const int32_t* pods, int32_t* nodes, int K,
                                  float sign, int rollback) {
  __shared__ uint8_t active[KSIM_MAX_WAVE];
  const int N = a.N, R = a.R, G = a.G, D = a.D;
  if (rollback) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      int p = pods[k], n = nodes[k];
      uint8_t act = 0;
      if (p >= 0 && n >= 0) {
        int g = a.group_id[p];
        if (g >= 0)
          for (int j = 0; j < K; ++j) {
            int pj = pods[j];
            if (pj >= 0 && a.group_id[pj] == g && nodes[j] < 0) act = 1;
          }
      }
      active[k] = act;
    }
    __syncthreads();
  }
  const int tid = threadIdx.x;
  for (int k = 0; k < K; ++k) {
    int p = pods[k], n = nodes[k];
    if (p < 0 || n < 0) continue;
    if (rollback && !active[k]) continue;
    if (tid == 0) {
      for (int t = 0; t < a.AA; ++t) {
        int g = a.anti_req[p * a.AA + t];
        if (g < 0) continue;
        int dom = a.gdom[g * N + n];
        if (dom >= 0) a.anti_active[g * D + dom] += sign;
      }
      for (int t = 0; t < a.PA; ++t) {
        int g = a.pref_aff[p * a.PA + t];
        if (g < 0) continue;
        int dom = a.gdom[g * N + n];
        if (dom >= 0) a.pref_wsum[g * D + dom] += sign * a.pref_aff_w[p * a.PA + t];
      }
    } else {
      for (int c = tid - 1; c < R + G; c += blockDim.x - 1) {
        if (c < R) {
          a.used[(size_t)n * R + c] += sign * a.requests[(size_t)p * R + c];
        } else {
          int g = c - R;
          if (!a.pmg[(size_t)p * G + g]) continue;
          int dom = a.gdom[g * N + n];
          if (dom >= 0) a.match_count[g * D + dom] += sign;
        }
      }
    }
  }
  if (rollback) {
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      if (active[k]) nodes[k] = KSIM_PAD;
  }
}

KSIM_EXPORT int ksim_apply_placements(const KsimArgs* args, const int32_t* pods, int32_t* nodes,
                                      int K, float sign, int rollback, void* stream) {
  if (K <= 0) return 0;
  if (rollback && K > KSIM_MAX_WAVE) return (int)cudaErrorInvalidValue;
  ksim_apply_kernel<<<1, K3_THREADS, 0, (cudaStream_t)stream>>>(*args, pods, nodes, K, sign,
                                                                 rollback);
  return (int)cudaGetLastError();
}
