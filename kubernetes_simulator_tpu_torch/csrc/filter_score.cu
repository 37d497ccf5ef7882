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
// DoNotSchedule spread groups) into shared memory.
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
// Exactness: compiled with --fmad=false and IEEE division; every
// expression keeps the reference's operation order.
#include "ksim.cuh"

__device__ __forceinline__ float ksim_piecewise(const KsimArgs& a, float util) {
  // ops/cpu.py piecewise_interp_int: seg = y0 + floor(t·Δy), lowest
  // segment whose x1 >= util wins; util <= x0 of the first point → y0.
  float out = a.y_last;
  for (int i = a.n_seg - 1; i >= 0; --i) {
    float t = (util - a.seg_x0[i]) * a.seg_inv[i];
    float seg = a.seg_y0[i] + floorf(t * a.seg_dy[i]);
    if (util <= a.seg_x1[i]) out = seg;
  }
  if (util <= a.x_first) out = a.y_first;
  return out;
}

__global__ void __launch_bounds__(256) ksim_filter_score_kernel(KsimArgs a, int p_shared,
                                                                const int32_t* pod_of_s,
                                                                int64_t pod_ss) {
  __shared__ float s_total[KSIM_MAX_TERMS];  // Σ_d match_count[g, d], aff terms
  __shared__ float s_min[KSIM_MAX_TERMS];    // min_d<nd match_count[g, d], spread
  __shared__ int s_nd[KSIM_MAX_TERMS];

  const int N = a.N, R = a.R, G = a.G, D = a.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t scen = blockIdx.y;
  const int p = pod_of_s ? pod_of_s[scen * pod_ss] : p_shared;
  if (p < 0) {  // uniform over the block: this scenario's buffer slot is empty
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n < N) {
      a.feasible[scen * a.feas_ss + n] = 0;
      a.ignored[scen * a.feas_ss + n] = 0;
      for (int r = 0; r < KSIM_ROWS; ++r) a.scores[scen * a.scores_ss + r * N + n] = 0.f;
    }
    return;
  }
  const float* match_count = a.match_count + scen * a.plane_ss;
  const float* anti_active = a.anti_active + scen * a.plane_ss;
  const float* pref_wsum = a.pref_wsum + scen * a.plane_ss;
  const KsimLabels lab = ksim_label_rows(a, scen);
  const int32_t* gdom = lab.gdom;

  if (a.interpod) {
    for (int t = warp; t < a.AR; t += nwarps) {
      int g = a.aff_req[p * a.AR + t];
      float t_sum = 0.f;
      if (g >= 0)
        for (int d = lane; d < D; d += 32) t_sum += match_count[g * D + d];
      // integer-valued counts: any summation order is exact
      for (int o = 16; o > 0; o >>= 1) t_sum += __shfl_down_sync(0xffffffffu, t_sum, o);
      if (lane == 0) s_total[t] = t_sum;
    }
  }
  if (a.spread) {
    for (int t = warp; t < a.SP; t += nwarps) {
      int g = a.spread_g[p * a.SP + t];
      int nd = g >= 0 ? lab.gnd[g] : 0;
      float m = INFINITY;
      for (int d = lane; d < nd; d += 32) m = fminf(m, match_count[g * D + d]);
      for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_down_sync(0xffffffffu, m, o));
      if (lane == 0) {
        s_min[t] = m;
        s_nd[t] = nd;
      }
    }
  }
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  bool ok = true;      // every filter but the resource fit
  bool fit_ok = true;  // NodeResourcesFit
  const float* req = a.requests + (size_t)p * R;
  const float* used = a.used + scen * a.used_ss + (size_t)n * R;
  const float* alloc = a.alloc + scen * a.alloc_ss + (size_t)n * R;
  const int32_t* taint_key = a.taint_key + scen * a.taint_ss;
  const int32_t* taint_kv = a.taint_kv + scen * a.taint_ss;
  const int32_t* taint_effect = a.taint_effect + scen * a.taint_ss;

  // --- NodeResourcesFit ---------------------------------------------------
  float fit_score = 0.f;
  if (a.fit) {
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      float u = used[r], q = req[r], al = alloc[r];
      if (!(u + q <= al + 1e-6f)) fit_ok = false;
      float w = a.res_w[r];
      if (w == 0.f) continue;
      float frac;
      if (a.fit_strategy == 0)
        frac = al > 0.f ? ((al - u) - q) / al : 0.f;
      else
        frac = al > 0.f ? (u + q) / al : 0.f;
      frac = fminf(fmaxf(frac, 0.f), 1.f);
      float s = floorf(frac * 100.f);
      if (a.fit_strategy == 2) s = ksim_piecewise(a, s);
      acc = acc + s * w;
    }
    fit_score = (a.wsum == 0.f) ? acc : floorf(acc / a.wsum);
  }

  // --- TaintToleration ----------------------------------------------------
  float prefer_cnt = 0.f;
  if (a.taints) {
    for (int tt = 0; tt < a.TT; ++tt) {
      int key = taint_key[n * a.TT + tt];
      if (key == KSIM_PAD) continue;
      int eff = taint_effect[n * a.TT + tt];
      int kv = taint_kv[n * a.TT + tt];
      bool hard = eff == KSIM_NO_SCHEDULE || eff == KSIM_NO_EXECUTE;
      bool soft = eff == KSIM_PREFER_NO_SCHEDULE;
      if (!hard && !soft) continue;
      bool tolerated = false;
      for (int j = 0; j < a.TO; ++j) {
        int tk = a.tol_key[p * a.TO + j];
        if (tk == KSIM_TOL_PAD) continue;
        int tv = a.tol_kv[p * a.TO + j];
        int te = a.tol_effect[p * a.TO + j];
        bool key_ok = tk == KSIM_TOL_WILDCARD || tk == key;
        bool val_ok = tv == KSIM_PAD || tv == kv;
        bool eff_ok = te == 0 || te == eff;
        if (key_ok && val_ok && eff_ok) tolerated = true;
      }
      if (!tolerated) {
        if (hard) ok = false;
        if (soft) prefer_cnt += 1.f;
      }
    }
  }

  // --- NodeAffinity -------------------------------------------------------
  float na_raw = 0.f;
  if (a.node_affinity) {
    const uint8_t* M = lab.expr_match + (size_t)n * a.E;
    if (a.na_has_req[p]) {
      bool any = false;
      for (int t = 0; t < a.TR; ++t) {
        const int32_t* term = a.na_req + ((size_t)p * a.TR + t) * a.TE;
        if (term[0] < 0) continue;
        bool all = true;
        for (int e = 0; e < a.TE; ++e)
          if (term[e] >= 0 && !M[term[e]]) all = false;
        if (all) any = true;
      }
      if (!any) ok = false;
    }
    for (int t = 0; t < a.TP; ++t) {
      const int32_t* term = a.na_pref + ((size_t)p * a.TP + t) * a.TE;
      if (term[0] < 0) continue;
      bool all = true;
      for (int e = 0; e < a.TE; ++e)
        if (term[e] >= 0 && !M[term[e]]) all = false;
      if (all) na_raw = na_raw + a.na_pref_w[p * a.TP + t];
    }
  }

  // --- InterPodAffinity ---------------------------------------------------
  float ip_raw = 0.f;
  if (a.interpod) {
    const uint8_t* pm = a.pmg + (size_t)p * G;
    for (int t = 0; t < a.AR; ++t) {
      int g = a.aff_req[p * a.AR + t];
      if (g < 0) continue;
      int dom = gdom[g * N + n];
      float cnt = dom >= 0 ? match_count[g * D + dom] : 0.f;
      bool boot = s_total[t] == 0.f && pm[g];
      bool term_ok = cnt >= 1.f && dom >= 0;
      if (!(term_ok || boot)) ok = false;
    }
    for (int t = 0; t < a.AA; ++t) {
      int g = a.anti_req[p * a.AA + t];
      if (g < 0) continue;
      int dom = gdom[g * N + n];
      float cnt = dom >= 0 ? match_count[g * D + dom] : 0.f;
      if (cnt >= 1.f && dom >= 0) ok = false;
    }
    for (int g = 0; g < G; ++g) {
      if (!pm[g]) continue;
      int dom = gdom[g * N + n];
      if (dom >= 0 && anti_active[g * D + dom] > 0.f) ok = false;
    }
    for (int t = 0; t < a.PA; ++t) {
      int g = a.pref_aff[p * a.PA + t];
      if (g < 0) continue;
      int dom = gdom[g * N + n];
      float cnt = dom >= 0 ? match_count[g * D + dom] : 0.f;
      ip_raw = ip_raw + a.pref_aff_w[p * a.PA + t] * cnt;
    }
    if (a.has_symmetric_pref) {
      float sym = 0.f;
      for (int g = 0; g < G; ++g) {
        if (!pm[g]) continue;
        int dom = gdom[g * N + n];
        if (dom >= 0) sym = sym + pref_wsum[g * D + dom];
      }
      ip_raw = ip_raw + sym;
    }
  }

  // --- PodTopologySpread --------------------------------------------------
  float sp_raw = 0.f;
  bool ign = false;
  if (a.spread) {
    for (int t = 0; t < a.SP; ++t) {
      int g = a.spread_g[p * a.SP + t];
      if (g < 0) continue;
      int skew = a.spread_skew[p * a.SP + t];
      int dom = gdom[g * N + n];
      float cnt = dom >= 0 ? match_count[g * D + dom] : 0.f;
      if (a.spread_dns[p * a.SP + t]) {
        if (s_nd[t] == 0) {
          ok = false;
        } else {
          float self = a.pmg[(size_t)p * G + g] ? 1.f : 0.f;
          float nw = cnt + self;
          if (!(dom >= 0 && (nw - s_min[t]) <= (float)skew)) ok = false;
        }
      } else {
        sp_raw = sp_raw + (cnt * lab.sp_w[g] + (float)(skew - 1));
        if (dom < 0) ign = true;
      }
    }
    sp_raw = floorf(sp_raw + 0.5f);
  }

  // --- Tier preemption: the candidate row (sim/greedy.py _try_tier_preempt) --
  // Evicting every non-gang pod of a lower tier bound at n must make the pod
  // fit ((used - lower) + req <= alloc + 1e-6, lower summed from tier 0 up),
  // the other filters pass at their current values and a victim exist; the
  // rank is victims·1024 + the highest victim tier, +inf for no candidate.
  if (ksim_may_preempt(a, p)) {
    const int tp = a.pod_tier[p];
    const float* ut = a.used_tier + scen * (int64_t)a.Tt * N * R + (size_t)n * R;
    const float* nt = a.npods_tier + scen * (int64_t)a.Tt * N + n;
    bool pre_fit = true;
    for (int r = 0; r < R; ++r) {
      float lower = 0.f;
      for (int t = 0; t < tp; ++t) lower = lower + ut[(size_t)t * N * R + r];
      if (!((used[r] - lower) + req[r] <= alloc[r] + 1e-6f)) pre_fit = false;
    }
    float victims = 0.f, maxtier = -1.f;
    for (int t = 0; t < tp; ++t) {
      float c = nt[(size_t)t * N];
      victims = victims + c;
      if (c > 0.f) maxtier = (float)t;
    }
    a.cand[scen * N + n] =
        (pre_fit && ok && victims > 0.f) ? victims * 1024.f + maxtier : INFINITY;
  }

  a.feasible[scen * a.feas_ss + n] = (ok && fit_ok) ? 1 : 0;
  a.ignored[scen * a.feas_ss + n] = ign ? 1 : 0;
  float* scores = a.scores + scen * a.scores_ss;
  scores[KSIM_ROW_FIT * N + n] = fit_score;
  scores[KSIM_ROW_TAINT * N + n] = prefer_cnt;
  scores[KSIM_ROW_NA * N + n] = na_raw;
  scores[KSIM_ROW_IP * N + n] = ip_raw;
  scores[KSIM_ROW_SPREAD * N + n] = sp_raw;
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
