// Shared argument block and helpers of the replay kernels.
//
// Every kernel takes one KsimArgs by value: the device pointers of the
// encoded cluster, the encoded pod tables, the carried state, the per-slot
// scratch rows, the dimensions and the static step constants. The Python
// side (ops/kernels.py) mirrors this layout field for field as a
// ctypes.Structure and checks sizeof() against ksim_args_size() at load.
//
// Layouts (row-major, C-contiguous). S scenarios share the pod tables;
// each has its own state and scratch rows, may have its own allocatable
// and taints, and reads row lrow[s] of the L rows of label tables (row 0
// the base cluster, one more per scenario that relabels nodes):
//   cluster  alloc [S,N,R] f32, taint_* [S,N,TT] i32 (or [N,R] / [N,TT]
//            shared by every scenario), expr_match [L,N,E] u8,
//            gdom [L,G,N] i32 (domain of node n under group g's topology
//            key, -1 = none), gnd [L,G] i32 (domains of that key), sp_w
//            [L,G] f32, lrow [S] i32
//   pods     requests [P,R] f32, tol_* [P,TO], na_req [P,TR,TE],
//            na_pref [P,TP,TE], aff_req [P,AR], anti_req [P,AA],
//            pref_aff [P,PA], spread_* [P,SP], pmg [P,G] u8, group_id [P]
//   state    used [S,N,R] f32, match_count / anti_active / pref_wsum
//            [S,G,D] f32
//   scratch  feasible [S,N] u8, scores [S,5,N] f32, ignored [S,N] u8
//   tier preemption (preempt = 1; null pointers and Tt = 0 when off)
//            pod_tier [P] i32, used_tier [S,Tt,N,R] f32, npods_tier
//            [S,Tt,N] f32, cand [S,N] f32 (K1 -> K2), last_wave / ev_node /
//            ev_tier / victims [S] i32 (K2 -> K3), col_pod / col_relb [L]
//            i32 (pod of each choice-buffer column and the boundary at
//            which it releases; columns >= n_slots are the pre-bound tail)
//   retry buffer (retry = 1; null pointers and RB = 0 when off)
//            dur [P] f32 pod durations, tbt [B] f32 start times of the
//            finite boundaries, rbuf [S,RB] i32 FIFO of failed non-gang
//            pods (then -1), rcount / rdrop [S] i32, rchoice [S,RB] i32 (the
//            retry pass's K2 -> K3, K4), pend_id / pend_node / pend_relb
//            [S,RB] i32 pending releases of pods placed on retry (then -1),
//            rnode / rbind_b [S,P] i32 each pod's retried node and the
//            boundary of that bind
//   policies (null when off) wrow [S,6] f32: scenario s's Score weights
//            (columns 0-4, the plugin order of the weighted total) and its
//            NodeResourcesFit selector (column 5, > 0.5 -> LeastAllocated,
//            else MostAllocated; ignored under RequestedToCapacityRatio),
//            ops/policy.py POLICY_COLS
// The *_ss fields are the per-scenario strides in elements: scenario s of
// a table starts at base + s * ss, and ss = 0 where the table is shared.
// The single-scenario replay is the S = 1 case.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KSIM_PAD (-1)
#define KSIM_TOL_PAD (-2)
#define KSIM_TOL_WILDCARD (-1)
#define KSIM_MAX_SEG 16
#define KSIM_MAX_TERMS 64
#define KSIM_MAX_WAVE 1024
#define KSIM_MAX_RB 4096

// Taint effects (models/core.py Effect).
#define KSIM_NO_SCHEDULE 1
#define KSIM_PREFER_NO_SCHEDULE 2
#define KSIM_NO_EXECUTE 3

// Columns of a policy row (ops/policy.py POLICY_COLS).
#define KSIM_POLICY_COLS 6
#define KSIM_POLICY_FIT_LEAST 5

// Score rows of the scratch block.
#define KSIM_ROW_FIT 0
#define KSIM_ROW_TAINT 1
#define KSIM_ROW_NA 2
#define KSIM_ROW_IP 3
#define KSIM_ROW_SPREAD 4
#define KSIM_ROWS 5

struct KsimArgs {
  // cluster
  const float* alloc;
  const int32_t* taint_key;
  const int32_t* taint_kv;
  const int32_t* taint_effect;
  const uint8_t* expr_match;
  const int32_t* gdom;
  const int32_t* gnd;
  const float* sp_w;
  const int32_t* lrow;
  // pods
  const float* requests;
  const int32_t* tol_key;
  const int32_t* tol_kv;
  const int32_t* tol_effect;
  const int32_t* na_req;
  const uint8_t* na_has_req;
  const int32_t* na_pref;
  const float* na_pref_w;
  const int32_t* aff_req;
  const int32_t* anti_req;
  const int32_t* pref_aff;
  const float* pref_aff_w;
  const int32_t* spread_g;
  const int32_t* spread_skew;
  const uint8_t* spread_dns;
  const uint8_t* pmg;
  const int32_t* group_id;
  // state
  float* used;
  float* match_count;
  float* anti_active;
  float* pref_wsum;
  // scratch
  uint8_t* feasible;
  float* scores;
  uint8_t* ignored;
  const float* res_w;  // [R] NodeResourcesFit resource weights
  // tier preemption
  const int32_t* pod_tier;
  float* used_tier;
  float* npods_tier;
  float* cand;
  int32_t* last_wave;
  int32_t* ev_node;
  int32_t* ev_tier;
  int32_t* victims;
  const int32_t* col_pod;
  const int32_t* col_relb;
  // retry buffer
  const float* dur;
  const float* tbt;
  int32_t* rbuf;
  int32_t* rcount;
  int32_t* rdrop;
  int32_t* rchoice;
  int32_t* pend_id;
  int32_t* pend_node;
  int32_t* pend_relb;
  int32_t* rnode;
  int32_t* rbind_b;
  // per-scenario policies (null: the static constants below)
  const float* wrow;  // [S, KSIM_POLICY_COLS]
  // per-scenario strides (elements; 0 = shared)
  int64_t alloc_ss, taint_ss, used_ss, plane_ss, feas_ss, scores_ss;
  // dimensions
  int32_t S, N, R, TT, E, G, D;
  int32_t TO, TR, TE, TP, AR, AA, PA, SP;
  // static step constants (sim/torch_runtime.StepSpec)
  int32_t fit, taints, node_affinity, interpod, spread;
  int32_t on_fit, on_taint, on_na, on_ip, on_sp;
  int32_t has_symmetric_pref, sp_norm_f32, fit_strategy, n_seg;
  int32_t preempt, Tt, n_slots;
  int32_t retry, RB, B, P;
  float wsum, w_fit, w_taint, w_na, w_ip, w_sp;
  float x_first, y_first, y_last, pad0;
  float seg_x0[KSIM_MAX_SEG];
  float seg_x1[KSIM_MAX_SEG];
  float seg_y0[KSIM_MAX_SEG];
  float seg_inv[KSIM_MAX_SEG];
  float seg_dy[KSIM_MAX_SEG];
};

#define KSIM_EXPORT extern "C" __attribute__((visibility("default")))

// Layout check for the ctypes mirror (every library exports it).
KSIM_EXPORT int ksim_args_size() { return (int)sizeof(KsimArgs); }

// Scenario scen's rows of the label tables (ksim_label_rows).
struct KsimLabels {
  const uint8_t* expr_match;  // [N,E]
  const int32_t* gdom;        // [G,N]
  const int32_t* gnd;         // [G]
  const float* sp_w;          // [G]
};

__device__ __forceinline__ KsimLabels ksim_label_rows(const KsimArgs& a, int64_t scen) {
  const int64_t row = a.lrow[scen];
  return KsimLabels{a.expr_match + row * a.N * a.E, a.gdom + row * a.G * a.N,
                    a.gnd + row * a.G, a.sp_w + row * a.G};
}

// NodeResourcesFit strategy of scenario scen (0 Least, 1 Most, 2
// RequestedToCapacityRatio): the static one, or with policy rows the row's
// selector under a static Least/MostAllocated (ops/tpu3.py:1316-1329).
__device__ __forceinline__ int ksim_fit_strategy(const KsimArgs& a, int64_t scen) {
  if (a.wrow == nullptr || a.fit_strategy == 2) return a.fit_strategy;
  return a.wrow[scen * KSIM_POLICY_COLS + KSIM_POLICY_FIT_LEAST] > 0.5f ? 0 : 1;
}

// May pod p preempt (tier preemption on, non-gang, tier > 0)?
__device__ __forceinline__ bool ksim_may_preempt(const KsimArgs& a, int p) {
  return a.preempt && a.group_id[p] < 0 && a.pod_tier[p] > 0;
}

// Python floor division of int32 (jnp // and numpy // semantics).
__device__ __forceinline__ int32_t ksim_floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// ---------------------------------------------------------------------------
// The per-node Filter chain and raw Score rows of one pod (K1 filter_score and
// K5 first_reject evaluate every node through these, so the two kernels can
// never disagree on a mask).
// ---------------------------------------------------------------------------

// Filter plugins in the reference's evaluation order (spec_plugin_names of
// kubernetes_simulator_tpu/sim/jax_runtime.py:251): bit k of
// KsimNodeEval::pass is plugin k's verdict.
#define KSIM_PLUGIN_FIT 0
#define KSIM_PLUGIN_TAINT 1
#define KSIM_PLUGIN_NA 2
#define KSIM_PLUGIN_IP 3
#define KSIM_PLUGIN_SPREAD 4
#define KSIM_PLUGINS 5
#define KSIM_PASS_ALL ((1u << KSIM_PLUGINS) - 1u)

// Is Filter plugin k on in this step (a plugin that is off admits every node)?
__device__ __forceinline__ bool ksim_plugin_on(const KsimArgs& a, int k) {
  switch (k) {
    case KSIM_PLUGIN_FIT: return a.fit != 0;
    case KSIM_PLUGIN_TAINT: return a.taints != 0;
    case KSIM_PLUGIN_NA: return a.node_affinity != 0;
    case KSIM_PLUGIN_IP: return a.interpod != 0;
    default: return a.spread != 0;
  }
}

// Per-block term tables of pod p in one scenario (shared memory): the
// bootstrap totals Σ_d match_count[g, d] of its required-affinity groups and
// the minimum count over [0, gnd) of its spread groups, reduced one warp per
// term. The caller synchronises the block after it.
struct KsimTerms {
  float total[KSIM_MAX_TERMS];  // aff_req term t
  float min[KSIM_MAX_TERMS];    // spread term t
  int nd[KSIM_MAX_TERMS];       // spread term t: domains of its key
};

__device__ __forceinline__ void ksim_filter_prologue(const KsimArgs& a, int p,
                                                     const float* match_count,
                                                     const KsimLabels& lab, KsimTerms* terms) {
  const int D = a.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (a.interpod) {
    for (int t = warp; t < a.AR; t += nwarps) {
      int g = a.aff_req[p * a.AR + t];
      float t_sum = 0.f;
      if (g >= 0)
        for (int d = lane; d < D; d += 32) t_sum += match_count[g * D + d];
      // integer-valued counts: any summation order is exact
      for (int o = 16; o > 0; o >>= 1) t_sum += __shfl_down_sync(0xffffffffu, t_sum, o);
      if (lane == 0) terms->total[t] = t_sum;
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
        terms->min[t] = m;
        terms->nd[t] = nd;
      }
    }
  }
}

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

// One node's verdicts and (with SCORES) raw Score rows.
struct KsimNodeEval {
  unsigned pass;  // bit KSIM_PLUGIN_k: plugin k admits the node
  float fit_score, prefer_cnt, na_raw, ip_raw, sp_raw;
  bool ign;  // ScheduleAnyway spread: the node lacks a scored key
};

// The Filter chain (and, with SCORES, the raw Score rows) of pod p on node n
// of scenario scen, from the state planes given (a scenario's own, or a
// snapshot of them): ops/cpu.py's per-plugin chain and ops/tpu.py:eval_pod's,
// bit for bit, every expression in the reference's operation order.
template <bool SCORES>
__device__ __forceinline__ KsimNodeEval ksim_eval_node(
    const KsimArgs& a, int p, int64_t scen, int n, const KsimLabels& lab, const float* used_s,
    const float* match_count, const float* anti_active, const float* pref_wsum,
    const KsimTerms* terms) {
  const int N = a.N, R = a.R, G = a.G, D = a.D;
  const int32_t* gdom = lab.gdom;
  KsimNodeEval e;
  e.pass = KSIM_PASS_ALL;
  e.fit_score = e.prefer_cnt = e.na_raw = e.ip_raw = e.sp_raw = 0.f;
  e.ign = false;
  const float* req = a.requests + (size_t)p * R;
  const float* used = used_s + (size_t)n * R;
  const float* alloc = a.alloc + scen * a.alloc_ss + (size_t)n * R;
  const int32_t* taint_key = a.taint_key + scen * a.taint_ss;
  const int32_t* taint_kv = a.taint_kv + scen * a.taint_ss;
  const int32_t* taint_effect = a.taint_effect + scen * a.taint_ss;

  // --- NodeResourcesFit ---------------------------------------------------
  if (a.fit) {
    const int strategy = SCORES ? ksim_fit_strategy(a, scen) : 0;
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      float u = used[r], q = req[r], al = alloc[r];
      if (!(u + q <= al + 1e-6f)) e.pass &= ~(1u << KSIM_PLUGIN_FIT);
      if (!SCORES) continue;
      float w = a.res_w[r];
      if (w == 0.f) continue;
      float frac;
      if (strategy == 0)
        frac = al > 0.f ? ((al - u) - q) / al : 0.f;
      else
        frac = al > 0.f ? (u + q) / al : 0.f;
      frac = fminf(fmaxf(frac, 0.f), 1.f);
      float s = floorf(frac * 100.f);
      if (strategy == 2) s = ksim_piecewise(a, s);
      acc = acc + s * w;
    }
    if (SCORES) e.fit_score = (a.wsum == 0.f) ? acc : floorf(acc / a.wsum);
  }

  // --- TaintToleration ----------------------------------------------------
  if (a.taints) {
    for (int tt = 0; tt < a.TT; ++tt) {
      int key = taint_key[n * a.TT + tt];
      if (key == KSIM_PAD) continue;
      int eff = taint_effect[n * a.TT + tt];
      int kv = taint_kv[n * a.TT + tt];
      bool hard = eff == KSIM_NO_SCHEDULE || eff == KSIM_NO_EXECUTE;
      bool soft = SCORES && eff == KSIM_PREFER_NO_SCHEDULE;
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
        if (hard) e.pass &= ~(1u << KSIM_PLUGIN_TAINT);
        if (soft) e.prefer_cnt += 1.f;
      }
    }
  }

  // --- NodeAffinity -------------------------------------------------------
  if (a.node_affinity) {
    const uint8_t* M = lab.expr_match + (size_t)n * a.E;
    if (a.na_has_req[p]) {
      bool any = false;
      for (int t = 0; t < a.TR; ++t) {
        const int32_t* term = a.na_req + ((size_t)p * a.TR + t) * a.TE;
        if (term[0] < 0) continue;
        bool all = true;
        for (int e2 = 0; e2 < a.TE; ++e2)
          if (term[e2] >= 0 && !M[term[e2]]) all = false;
        if (all) any = true;
      }
      if (!any) e.pass &= ~(1u << KSIM_PLUGIN_NA);
    }
    if (SCORES) {
      for (int t = 0; t < a.TP; ++t) {
        const int32_t* term = a.na_pref + ((size_t)p * a.TP + t) * a.TE;
        if (term[0] < 0) continue;
        bool all = true;
        for (int e2 = 0; e2 < a.TE; ++e2)
          if (term[e2] >= 0 && !M[term[e2]]) all = false;
        if (all) e.na_raw = e.na_raw + a.na_pref_w[p * a.TP + t];
      }
    }
  }

  // --- InterPodAffinity ---------------------------------------------------
  if (a.interpod) {
    const uint8_t* pm = a.pmg + (size_t)p * G;
    bool ok = true;
    for (int t = 0; t < a.AR; ++t) {
      int g = a.aff_req[p * a.AR + t];
      if (g < 0) continue;
      int dom = gdom[g * N + n];
      float cnt = dom >= 0 ? match_count[g * D + dom] : 0.f;
      bool boot = terms->total[t] == 0.f && pm[g];
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
    if (!ok) e.pass &= ~(1u << KSIM_PLUGIN_IP);
    if (SCORES) {
      for (int t = 0; t < a.PA; ++t) {
        int g = a.pref_aff[p * a.PA + t];
        if (g < 0) continue;
        int dom = gdom[g * N + n];
        float cnt = dom >= 0 ? match_count[g * D + dom] : 0.f;
        e.ip_raw = e.ip_raw + a.pref_aff_w[p * a.PA + t] * cnt;
      }
      if (a.has_symmetric_pref) {
        float sym = 0.f;
        for (int g = 0; g < G; ++g) {
          if (!pm[g]) continue;
          int dom = gdom[g * N + n];
          if (dom >= 0) sym = sym + pref_wsum[g * D + dom];
        }
        e.ip_raw = e.ip_raw + sym;
      }
    }
  }

  // --- PodTopologySpread --------------------------------------------------
  if (a.spread) {
    float sp_raw = 0.f;
    for (int t = 0; t < a.SP; ++t) {
      int g = a.spread_g[p * a.SP + t];
      if (g < 0) continue;
      int skew = a.spread_skew[p * a.SP + t];
      int dom = gdom[g * N + n];
      float cnt = dom >= 0 ? match_count[g * D + dom] : 0.f;
      if (a.spread_dns[p * a.SP + t]) {
        bool ok;
        if (terms->nd[t] == 0) {
          ok = false;
        } else {
          float self = a.pmg[(size_t)p * G + g] ? 1.f : 0.f;
          float nw = cnt + self;
          ok = dom >= 0 && (nw - terms->min[t]) <= (float)skew;
        }
        if (!ok) e.pass &= ~(1u << KSIM_PLUGIN_SPREAD);
      } else if (SCORES) {
        sp_raw = sp_raw + (cnt * lab.sp_w[g] + (float)(skew - 1));
        if (dom < 0) e.ign = true;
      }
    }
    if (SCORES) e.sp_raw = floorf(sp_raw + 0.5f);
  }
  return e;
}
