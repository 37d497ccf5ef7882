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
// applies the slot's eviction record (k3_evict).
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

// The eviction step of a bind under tier preemption (sim/greedy.py:182-215;
// the victim walk of sim/jax_runtime.py:788 preemption_walk, done here on
// the device): scenario scen's record (ev_node, ev_tier) from K2 names the
// node. Every column of the choice buffer before the slot or in the
// pre-bound tail whose pod is non-gang, of a lower tier, bound at that node
// and not released at `boundary` gets PAD and is counted; used[node] drops
// by the lower tiers' usage summed from tier 0 up (the sum K1's fit after
// eviction used) and those tier cells are zeroed. The count planes keep
// the victims (phantom counts), and a victim's PAD keeps it out of every
// later release.
__device__ void k3_evict(const KsimArgs& a, int64_t scen, int32_t* ch, int slot, int L,
                         int boundary, float* used) {
  __shared__ int red[K3_THREADS / 32];
  const int ev = a.ev_node[scen];
  if (ev < 0) return;  // uniform over the block
  const int evt = a.ev_tier[scen];
  const int N = a.N, R = a.R;
  const int tail = L - a.n_slots;
  int cnt = 0;
  for (int i = threadIdx.x; i < slot + tail; i += blockDim.x) {
    const int c = i < slot ? i : a.n_slots + (i - slot);
    if (ch[c] != ev) continue;  // most columns: another node or PAD
    const int p = a.col_pod[c];
    if (p < 0 || a.group_id[p] >= 0 || a.pod_tier[p] >= evt || a.col_relb[c] <= boundary)
      continue;
    ch[c] = KSIM_PAD;
    ++cnt;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = cnt;
  float* ut = a.used_tier + scen * (int64_t)a.Tt * N * R;
  float* nt = a.npods_tier + scen * (int64_t)a.Tt * N;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float lower = 0.f;
    for (int t = 0; t < evt; ++t) {
      float* cell = ut + ((size_t)t * N + ev) * R + r;
      lower = lower + *cell;
      *cell = 0.f;
    }
    used[(size_t)ev * R + r] = used[(size_t)ev * R + r] - lower;
  }
  for (int t = threadIdx.x; t < evt; t += blockDim.x) nt[(size_t)t * N + ev] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
    a.victims[scen] += total;
  }
}

__global__ void __launch_bounds__(K3_THREADS)
    ksim_apply_kernel(KsimArgs a, const int32_t* pods_all, int64_t pod_ss, const int32_t* pos,
                      int32_t* choices, int K, int64_t choice_ss, float sign, int rollback,
                      int boundary, const int32_t* due_relb, int due_b, int append) {
  __shared__ uint8_t active[KSIM_MAX_WAVE];
  const int N = a.N, R = a.R, G = a.G, D = a.D;
  const int64_t scen = blockIdx.x;
  const int32_t* pods = pods_all + scen * pod_ss;
  const int32_t* relb = due_relb ? due_relb + scen * pod_ss : nullptr;
  int32_t* ch = choices + scen * choice_ss;
  float* used = a.used + scen * a.used_ss;
  float* match_count = a.match_count + scen * a.plane_ss;
  float* anti_active = a.anti_active + scen * a.plane_ss;
  float* pref_wsum = a.pref_wsum + scen * a.plane_ss;
  const int32_t* gdom = ksim_label_rows(a, scen).gdom;
  if (boundary >= 0 && a.preempt) {
    k3_evict(a, scen, ch, pos[0], (int)choice_ss, boundary, used);
    __syncthreads();
  }
  // Tier-plane columns of a pair (non-gang pods under tier preemption):
  // used_tier[tier, n, 0..R) then npods_tier[tier, n].
  const int TC = a.preempt ? R + 1 : 0;
  float* used_tier = a.used_tier + scen * (int64_t)a.Tt * N * R;
  float* npods_tier = a.npods_tier + scen * (int64_t)a.Tt * N;
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
    if (relb && relb[k] > due_b) continue;
    if (tid == 0) {
      for (int t = 0; t < a.AA; ++t) {
        int g = a.anti_req[p * a.AA + t];
        if (g < 0) continue;
        int dom = gdom[g * N + n];
        if (dom >= 0) anti_active[g * D + dom] += sign;
      }
      for (int t = 0; t < a.PA; ++t) {
        int g = a.pref_aff[p * a.PA + t];
        if (g < 0) continue;
        int dom = gdom[g * N + n];
        if (dom >= 0) pref_wsum[g * D + dom] += sign * a.pref_aff_w[p * a.PA + t];
      }
    } else {
      const bool tiered = TC && a.group_id[p] < 0;
      for (int c = tid - 1; c < R + G + TC; c += blockDim.x - 1) {
        if (c < R) {
          used[(size_t)n * R + c] += sign * a.requests[(size_t)p * R + c];
        } else if (c < R + G) {
          int g = c - R;
          if (!a.pmg[(size_t)p * G + g]) continue;
          int dom = gdom[g * N + n];
          if (dom >= 0) match_count[g * D + dom] += sign;
        } else if (tiered) {
          const int r = c - R - G;
          const size_t cell = (size_t)a.pod_tier[p] * N + n;
          if (r < R)
            used_tier[cell * R + r] += sign * a.requests[(size_t)p * R + r];
          else
            npods_tier[cell] += sign;
        }
      }
    }
  }
  if (rollback) {
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      if (active[k]) ch[pos[k]] = KSIM_PAD;
  }
  if (append && tid == 0) {
    for (int k = 0; k < K; ++k) {
      const int p = pods[k];
      if (p < 0 || ch[pos[k]] >= 0 || a.group_id[p] >= 0) continue;
      const int c = a.rcount[scen];
      if (c < a.RB) {
        a.rbuf[scen * a.RB + c] = p;
        a.rcount[scen] = c + 1;
      } else {
        a.rdrop[scen] += 1;
      }
    }
  }
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
