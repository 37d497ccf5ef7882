// K8 shard_apply: add sign x the state contribution of K (pod, node) pairs to
// one scenario's node-sharded state, in pair order, one cooperative launch of
// NP * S blocks (block b: shard b % NP of scenario b / NP).
//
// Replaces: kubernetes_simulator_tpu/ops/tpu.py:1406 apply_binding_sharded
// (the owner-masked bind), :1435 apply_unbind_wave_sharded (the gang
// rollback from the wave's stacked domain rows) and the sharded release
// (the node-space delta of sim/jax_runtime.py:1224-1240 _to_dev_state_v2,
// subtracted from each shard's block).
//
// Pair k is pod pods[k] at the node of choice-buffer column pos[k] of the
// scenario's row (PAD pods and nodes are skipped). Three uses, as K3's:
//   bind      sign +1, K = 1, the slot K7 (shard_select.cu) just chose;
//   rollback  sign -1 over one wave's W slots: a pair is undone iff its pod
//             placed and a slot of the same gang in the wave went unplaced;
//             its choice is then overwritten with PAD;
//   release   sign -1 over one boundary's static bucket (pod order).
// Who writes what (one writer a cell, no float atomics):
//   - shard q's block owns the used rows of its node block [q * n_local,
//     (q + 1) * n_local): within it thread 1 + c owns column c and applies
//     the pairs whose node it owns in pair order; a release sums each
//     node's requests from zero in pair order and subtracts them once (the
//     reference's release delta; K3's order, the rel accumulator);
//   - the count planes [G, D] are replicated state, kept once on the card:
//     shard 0's block is their writer (thread 0 the anti-affinity and
//     preferred-affinity terms, whose group ids may repeat within a pod;
//     thread 1 + R + g the match_count row of group g) and applies every
//     pair at the domain ids of its column, cdom[s, pos[k], :], which K7's
//     owner wrote — never another shard's node tables (the stacked
//     gdom_at / has_dom rows of the reference's rollback);
//   - a rollback's PAD writes wait for a grid barrier, so every block has
//     read the wave's choices first; shard 0 writes them.
// Each shard reads the pod tables and the choice buffer, which every shard
// holds, and its own node block: on separate cards only cdom would cross.
//
// Bound on an H100: bytes — per pair R * 4 + G + a few words; launch-bound
// at K = 1, latency-bound by the in-order walk at release sizes.
#include "ksim.cuh"

#define K8_THREADS 256

__global__ void __launch_bounds__(K8_THREADS)
    ksim_shard_apply_kernel(KsimArgs a, const int32_t* pods, const int32_t* pos,
                            int32_t* choices, int K, int64_t choice_ss, float sign,
                            int rollback) {
  __shared__ uint8_t active[KSIM_MAX_WAVE];
  cg::grid_group grid = cg::this_grid();
  const int shard = blockIdx.x % a.NP;
  const int64_t scen = blockIdx.x / a.NP;
  const int R = a.R, G = a.G, D = a.D;
  const int lo = shard * a.n_local, hi = lo + a.n_local;
  const bool planes = shard == 0;
  int32_t* ch = choices + scen * choice_ss;
  const int32_t* cdom = a.cdom + scen * choice_ss * G;
  float* used = a.used + scen * a.used_ss;
  float* rel = a.rel + scen * a.used_ss;
  float* match_count = a.match_count + scen * a.plane_ss;
  float* anti_active = a.anti_active + scen * a.plane_ss;
  float* pref_wsum = a.pref_wsum + scen * a.plane_ss;
  if (rollback) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int p = pods[k], n = ch[pos[k]];
      uint8_t act = 0;
      if (p >= 0 && n >= 0) {
        const int g = a.group_id[p];
        if (g >= 0)
          for (int j = 0; j < K; ++j) {
            const int pj = pods[j];
            if (pj >= 0 && a.group_id[pj] == g && ch[pos[j]] < 0) act = 1;
          }
      }
      active[k] = act;
    }
    __syncthreads();
  }
  const bool summed = sign < 0.f && !rollback;
  const int tid = threadIdx.x;
  for (int k = 0; k < K; ++k) {
    const int p = pods[k];
    if (p < 0) continue;
    const int n = ch[pos[k]];
    if (n < 0) continue;
    if (rollback && !active[k]) continue;
    const int32_t* dom = cdom + (size_t)pos[k] * G;
    if (tid == 0) {
      if (!planes) continue;
      for (int t = 0; t < a.AA; ++t) {
        const int g = a.anti_req[p * a.AA + t];
        if (g < 0) continue;
        const int d = dom[g];
        if (d >= 0) anti_active[g * D + d] += sign;
      }
      for (int t = 0; t < a.PA; ++t) {
        const int g = a.pref_aff[p * a.PA + t];
        if (g < 0) continue;
        const int d = dom[g];
        if (d >= 0) pref_wsum[g * D + d] += sign * a.pref_aff_w[p * a.PA + t];
      }
    } else {
      const bool mine = n >= lo && n < hi;
      for (int c = tid - 1; c < R + G; c += blockDim.x - 1) {
        if (c < R) {
          if (!mine) continue;
          if (summed)
            rel[(size_t)n * R + c] += a.requests[(size_t)p * R + c];
          else
            used[(size_t)n * R + c] += sign * a.requests[(size_t)p * R + c];
        } else if (planes) {
          const int g = c - R;
          if (!a.pmg[(size_t)p * G + g]) continue;
          const int d = dom[g];
          if (d >= 0) match_count[g * D + d] += sign;
        }
      }
    }
  }
  if (summed && tid > 0) {
    for (int k = 0; k < K; ++k) {
      const int p = pods[k];
      const int n = p < 0 ? KSIM_PAD : ch[pos[k]];
      if (n < lo || n >= hi) continue;
      for (int c = tid - 1; c < R; c += blockDim.x - 1) {
        float* acc = rel + (size_t)n * R + c;
        used[(size_t)n * R + c] = used[(size_t)n * R + c] - *acc;
        *acc = 0.f;
      }
    }
  }
  if (rollback) {
    grid.sync();  // every block has read the wave's choices
    if (planes)
      for (int k = threadIdx.x; k < K; k += blockDim.x)
        if (active[k]) ch[pos[k]] = KSIM_PAD;
  }
}

KSIM_EXPORT int ksim_shard_apply(const KsimArgs* args, const int32_t* pods, const int32_t* pos,
                                 int32_t* choices, int K, long long choice_ss, float sign,
                                 int rollback, void* stream) {
  if (K <= 0) return 0;
  if (!args->cdom || args->S < 1 || args->NP < 1 || args->preempt || args->retry ||
      (long long)args->NP * args->n_local != args->N || (rollback && K > KSIM_MAX_WAVE))
    return (int)cudaErrorInvalidValue;
  const int cap = ksim_resident((const void*)ksim_shard_apply_kernel, K8_THREADS);
  if (cap < 0) return -cap;
  const long long blocks = (long long)args->NP * args->S;
  if (blocks > cap) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&pods,  (void*)&pos,  (void*)&choices,
                    (void*)&K,   (void*)&css,   (void*)&sign, (void*)&rollback};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ksim_shard_apply_kernel,
                                              (int)blocks, K8_THREADS, params, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
