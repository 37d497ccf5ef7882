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
//   release  rel [S,N,R] f32, zero between launches: K8 sums a release's
//            requests per node there before subtracting them
//   policies (null when off) wrow [S,6] f32: scenario s's Score weights
//            (columns 0-4, the plugin order of the weighted total) and its
//            NodeResourcesFit selector (column 5, > 0.5 -> LeastAllocated,
//            else MostAllocated; ignored under RequestedToCapacityRatio),
//            ops/policy.py POLICY_COLS
//   node shards (row B13; null pointers and NP = 1, n_local = n_real = N
//            when off) the node axis is NP shard blocks of n_local nodes
//            (N = NP * n_local), node n >= n_real a pad row; ext [S,NP,7]
//            f32 each shard's packed normalization extrema (K7's exchange,
//            KSIM_EXT_*), best_v [S,NP] f32 / best_i [S,NP] i32 each
//            shard's (best total, lowest global id) (K7's exchange), cdom
//            [S,L,G] i32 the domain ids of each choice-buffer column's node
//            (K7 -> K8, and K9's owner -> rank 0; L the choice buffer's row
//            length)
// The *_ss fields are the per-scenario strides in elements: scenario s of
// a table starts at base + s * ss, and ss = 0 where the table is shared.
// The single-scenario replay is the S = 1 case.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
  // [S,N,R] f32 all-zero accumulator of a release's summed requests (K8)
  float* rel;
  // node shards
  float* ext;
  float* best_v;
  int32_t* best_i;
  int32_t* cdom;
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
  int32_t n_real, NP, n_local;
  float wsum, w_fit, w_taint, w_na, w_ip, w_sp;
  float x_first, y_first, y_last, pad0;
  float seg_x0[KSIM_MAX_SEG];
  float seg_x1[KSIM_MAX_SEG];
  float seg_y0[KSIM_MAX_SEG];
  float seg_inv[KSIM_MAX_SEG];
  float seg_dy[KSIM_MAX_SEG];
};

#define KSIM_EXPORT extern "C" __attribute__((visibility("default")))

// Layout check for the ctypes mirror (every library exports it, from its
// first translation unit: a second one of the same library, such as
// chunk_replay_attributed.cu, defines KSIM_SECOND_TU).
#ifndef KSIM_SECOND_TU
KSIM_EXPORT int ksim_args_size() { return (int)sizeof(KsimArgs); }
#endif

// Blocks of `threads` threads of the cooperative `kernel` that the current
// device holds at once (K8's grid barrier needs every block resident), or a
// negative CUDA error (also where the device has no cooperative launch);
// cached per device, kernel and width.
static inline int ksim_resident(const void* kernel, int threads) {
  struct Entry {
    int dev, threads, n;
    const void* kernel;
  };
  static Entry cache[32];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].kernel == kernel && cache[i].threads == threads)
      return cache[i].n;
  int coop = 0;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = 1;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  int n = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) != cudaSuccess) return -(int)e;
  if (used < 32) cache[used++] = Entry{dev, threads, n, kernel};
  return n;
}

// Launch `kernel` over `grid` blocks of `threads` threads as clusters of C
// consecutive blocks (blockIdx.x / C is the cluster, its rank blockIdx.x % C).
// A plain clustered launch: clusters that the card cannot hold at once wait
// for free SMs, so no cluster may ever wait on another. Returns the launch's
// CUDA error: a refused launch never runs, and nothing falls back.
static inline int ksim_launch_clusters(const void* kernel, int grid, int threads, int C,
                                       void** params, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = C;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, params);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

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

// ---------------------------------------------------------------------------
// The bodies of the three per-slot kernels. K1 filter_score, K2
// normalize_select and K3 apply_placements are thin __global__ wrappers over
// them, and K6 chunk_replay runs the same three bodies for every slot of a
// chunk in one launch (one cluster a scenario), so the per-slot route and the
// chunk route execute the same arithmetic. Each body is written for one block;
// any block size that is a multiple of 32 and at most 1024 gives the same
// result (every reduction over nodes is a max, a min or a (value, index) pair
// with the lowest index on ties, and every state cell belongs to one thread,
// which applies pairs in order).
// ---------------------------------------------------------------------------

#define KSIM_MAX_WARPS 32

// K1's per-node body: the fused Filter + raw Score of pod p (p >= 0) on node
// n (this thread's node; n >= N is idle) of scenario scen into the scratch
// rows, with the tier-preemption candidate row, from the pod's term tables
// for scenario scen in `terms` (ksim_filter_prologue, then a block barrier).
__device__ __forceinline__ void ksim_filter_score_node(const KsimArgs& a, int p, int64_t scen,
                                                       int n, const KsimTerms* terms) {
  const int N = a.N, R = a.R;
  if (n >= N) return;
  const KsimLabels lab = ksim_label_rows(a, scen);
  const float* match_count = a.match_count + scen * a.plane_ss;
  const float* used_s = a.used + scen * a.used_ss;
  const KsimNodeEval e = ksim_eval_node<true>(a, p, scen, n, lab, used_s, match_count,
                                               a.anti_active + scen * a.plane_ss,
                                               a.pref_wsum + scen * a.plane_ss, terms);
  // every filter but the resource fit
  const bool ok = (e.pass | (1u << KSIM_PLUGIN_FIT)) == KSIM_PASS_ALL;
  const float* req = a.requests + (size_t)p * R;
  const float* used = used_s + (size_t)n * R;
  const float* alloc = a.alloc + scen * a.alloc_ss + (size_t)n * R;

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

  // A pad row of the sharded node axis is never feasible, whatever its fill
  // (ops/tpu.py:1096-1100); unsharded, n_real = N and the test never fails.
  a.feasible[scen * a.feas_ss + n] = (e.pass == KSIM_PASS_ALL && n < a.n_real) ? 1 : 0;
  a.ignored[scen * a.feas_ss + n] = e.ign ? 1 : 0;
  float* scores = a.scores + scen * a.scores_ss;
  scores[KSIM_ROW_FIT * N + n] = e.fit_score;
  scores[KSIM_ROW_TAINT * N + n] = e.prefer_cnt;
  scores[KSIM_ROW_NA * N + n] = e.na_raw;
  scores[KSIM_ROW_IP * N + n] = e.ip_raw;
  scores[KSIM_ROW_SPREAD * N + n] = e.sp_raw;
}

// K1's block body: the pod's term tables for scenario scen into `terms`,
// then ksim_filter_score_node on this thread's node n. p < 0 (an empty
// retry-buffer slot, uniform over the block) writes an all-zero mask, rows
// and ignored mask. A caller that runs the body again synchronises the
// block before it.
__device__ __forceinline__ void ksim_filter_score_body(const KsimArgs& a, int p, int64_t scen,
                                                       int n, KsimTerms* terms) {
  const int N = a.N;
  if (p < 0) {
    if (n < N) {
      a.feasible[scen * a.feas_ss + n] = 0;
      a.ignored[scen * a.feas_ss + n] = 0;
      for (int r = 0; r < KSIM_ROWS; ++r) a.scores[scen * a.scores_ss + r * N + n] = 0.f;
    }
    return;
  }
  ksim_filter_prologue(a, p, a.match_count + scen * a.plane_ss, ksim_label_rows(a, scen), terms);
  __syncthreads();
  ksim_filter_score_node(a, p, scen, n, terms);
}

// ---------------------------------------------------------------------------
// First-reject attribution: K5's count body and charge, which K6's attributed
// mode runs too, so the two count alike (ops/tpu.py:816 first_reject_counts
// over eval_pod(want_masks=True), sim/jax_runtime.py:270; the episode rule of
// sim/telemetry.py:338-404).
// ---------------------------------------------------------------------------

// Pod p's first-reject counts over the nodes [lo, hi) of scenario scen at the
// state planes given, a node a thread from lo: tot[k] the nodes Filter plugin
// k (in the reference's order) rejects first, tot[KSIM_PLUGINS] the nodes no
// plugin rejects. The Filter chain is K1's (ksim_eval_node without the score
// rows) from the block's term tables `terms` at the same planes. Counts are
// summed in registers, warp shuffles and shared memory (integers: any order
// is exact); tot is valid in thread 0 on return. A caller that runs the body
// again synchronises the block before it.
__device__ __forceinline__ void ksim_reject_count_body(
    const KsimArgs& a, int p, int64_t scen, int lo, int hi, const KsimLabels& lab,
    const float* used_s, const float* match_count, const float* anti_active,
    const float* pref_wsum, const KsimTerms* terms, int* tot) {
  __shared__ int s_cnt[KSIM_MAX_WARPS][KSIM_PLUGINS + 1];
  int cnt[KSIM_PLUGINS + 1];
#pragma unroll
  for (int k = 0; k <= KSIM_PLUGINS; ++k) cnt[k] = 0;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    const KsimNodeEval e = ksim_eval_node<false>(a, p, scen, n, lab, used_s, match_count,
                                                 anti_active, pref_wsum, terms);
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
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k <= KSIM_PLUGINS; ++k) {
      tot[k] = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot[k] += s_cnt[w][k];
    }
  }
}

// The charge of one failed slot of pod p in scenario scen from its counts
// over every node (ksim_reject_count_body's tot): nothing where a node admits
// the pod; else the counts of the plugins that are on, in their order, added
// to the scenario's `attempts` and, on the pod's first charge (its episode
// mark, never cleared: without kube preemption or chaos an episode ends only
// with a bind), to its `reasons`. One thread a (slot, scenario); the adds are
// integer atomics, so callers that charge one scenario from several blocks
// at once agree with any order.
__device__ __forceinline__ void ksim_reject_charge(const KsimArgs& a, const int* tot,
                                                   int64_t scen, int p, int32_t* reasons,
                                                   int32_t* attempts, uint8_t* attributed,
                                                   int K, int64_t attr_ss) {
  if (tot[KSIM_PLUGINS] > 0) return;  // a node admits the pod: nothing is charged
  uint8_t* attr = attributed + scen * attr_ss + p;
  const bool first_episode = *attr == 0;
  if (first_episode) *attr = 1;
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

__device__ __forceinline__ void ksim_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Lowest value, then lowest index (the masked argmin's order).
__device__ __forceinline__ void ksim_lower(float& bv, int& bi, float v, int i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Block-wide reduction of nv extrema (in shared scratch `red`, 32 a value);
// returns through the same array.
__device__ __forceinline__ void ksim_block_extrema(float* v, int nv, const bool* is_max,
                                                   float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < nv; ++k) {
    float x = v[k];
    for (int o = 16; o > 0; o >>= 1) {
      float y = __shfl_down_sync(0xffffffffu, x, o);
      x = is_max[k] ? fmaxf(x, y) : fminf(x, y);
    }
    if (lane == 0) red[k * 32 + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    for (int k = 0; k < nv; ++k) {
      float x = lane < nw ? red[k * 32 + lane] : (is_max[k] ? -INFINITY : INFINITY);
      for (int o = 16; o > 0; o >>= 1) {
        float y = __shfl_down_sync(0xffffffffu, x, o);
        x = is_max[k] ? fmaxf(x, y) : fminf(x, y);
      }
      if (lane == 0) red[k * 32] = x;
    }
  }
  __syncthreads();
  for (int k = 0; k < nv; ++k) v[k] = red[k * 32];
  __syncthreads();
}

// Block-wide (value, index) reduction through `better` (ksim_better for the
// argmax, ksim_lower for the argmin); the result is valid in thread 0 (and
// every lane of warp 0).
template <bool MAX>
__device__ __forceinline__ void ksim_block_pick(float& bv, int& bi, float* best_v,
                                                int* best_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float none = MAX ? -INFINITY : INFINITY;
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, o);
    int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (MAX) ksim_better(bv, bi, ov, oi); else ksim_lower(bv, bi, ov, oi);
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    bv = lane < nw ? best_v[lane] : none;
    bi = lane < nw ? best_i[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, bv, o);
      int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (MAX) ksim_better(bv, bi, ov, oi); else ksim_lower(bv, bi, ov, oi);
    }
  }
}

// The packed normalization extrema (ops/reference.py EXT_*): the max of the
// taint and node-affinity raws (0-filled over the feasible nodes), the
// inter-pod raw's -min and max, the spread raw's -min and max over the
// feasible, not ignored nodes, and the any-feasible bit. Packed, every value
// folds by max, so shards exchange them as one max (ops/tpu.py:1211-1223).
#define KSIM_EXT 7

// Unpacked extrema in K2's order: taint_hi, na_hi, ip_lo, ip_hi, sp_lo,
// sp_hi, any_f (the mins as mins).
__device__ __forceinline__ void ksim_extrema_init(float* v) {
  v[0] = -INFINITY; v[1] = -INFINITY; v[2] = INFINITY; v[3] = -INFINITY;
  v[4] = INFINITY; v[5] = -INFINITY; v[6] = 0.f;
}

#define KSIM_EXTREMA_IS_MAX {true, true, false, true, false, true, true}

// One node's scratch rows of one scenario — its mask bit, its ignored bit
// and its five raw Score rows — loaded together (independent loads overlap
// their latency): K2's two passes and K7 read the same values.
struct KsimRaw {
  bool f, ign;
  float fit, taint, na, ip, sp;
};

__device__ __forceinline__ KsimRaw ksim_raw(const KsimArgs& a, int64_t scen, int n) {
  const int N = a.N;
  const float* rows = a.scores + scen * a.scores_ss;
  KsimRaw r;
  r.f = a.feasible[scen * a.feas_ss + n] != 0;
  r.ign = a.ignored[scen * a.feas_ss + n] != 0;
  r.fit = rows[KSIM_ROW_FIT * N + n];
  r.taint = rows[KSIM_ROW_TAINT * N + n];
  r.na = rows[KSIM_ROW_NA * N + n];
  r.ip = rows[KSIM_ROW_IP * N + n];
  r.sp = rows[KSIM_ROW_SPREAD * N + n];
  return r;
}

// Fold one node's rows into the unpacked extrema v (K2's pass 1).
__device__ __forceinline__ void ksim_extrema_node(const KsimRaw& r, float* v) {
  v[0] = fmaxf(v[0], r.f ? r.taint : 0.f);
  v[1] = fmaxf(v[1], r.f ? r.na : 0.f);
  if (r.f) {
    v[2] = fminf(v[2], r.ip);
    v[3] = fmaxf(v[3], r.ip);
    v[6] = 1.f;
    if (!r.ign) {
      v[4] = fminf(v[4], r.sp);
      v[5] = fmaxf(v[5], r.sp);
    }
  }
}

// Packed <-> unpacked (the mins negate; -(+inf) = -inf is the identity).
__device__ __forceinline__ void ksim_extrema_flip(float* v) {
  v[2] = -v[2];
  v[4] = -v[4];
}

// ---------------------------------------------------------------------------
// The cluster exchange of the selects (K2, K6's phase 2, K7). A scenario is
// one thread-block cluster of C <= KSIM_MAX_CLUSTER blocks on neighbouring
// SMs; each block reduces its own part of the node axis and PUSHES its result
// into slot `rank` of every peer's shared memory (C remote stores through
// DSMEM, cluster.map_shared_rank, issued by C threads and not waited on);
// after a cluster barrier, which orders those stores, every thread folds the
// C slots of its own block's shared memory. Max and min are exact in any
// order, and a (value, index) pair with the lowest index on ties is a total
// order, so every thread ends with the value a single block would have
// reduced. Pushing, not pulling, keeps the remote traffic at C stores a
// block and leaves nothing to read after the last barrier, so a block may
// exit then. A block pushes into a slot array again only after the next
// barrier, which every peer reaches after folding that array.
// ---------------------------------------------------------------------------

#define KSIM_MAX_CLUSTER 8

// Push the unpacked extrema v (valid in every thread) into slot `rank` of
// every peer's `slots`.
__device__ __forceinline__ void ksim_cluster_push_extrema(const float* v,
                                                          float (*slots)[KSIM_EXT]) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned C = cl.num_blocks();
  if (threadIdx.x < C) {
    float* dst = cl.map_shared_rank(slots[cl.block_rank()], threadIdx.x);
    for (int k = 0; k < KSIM_EXT; ++k) dst[k] = v[k];
  }
}

// Fold the C slots of extrema (after the barrier) into v, in every thread.
__device__ __forceinline__ void ksim_cluster_fold_extrema(float* v, float (*slots)[KSIM_EXT]) {
  const int C = (int)cg::this_cluster().num_blocks();
  const bool is_max[KSIM_EXT] = KSIM_EXTREMA_IS_MAX;
  for (int k = 0; k < KSIM_EXT; ++k) {
    float x = slots[0][k];
    for (int r = 1; r < C; ++r) x = is_max[k] ? fmaxf(x, slots[r][k]) : fminf(x, slots[r][k]);
    v[k] = x;
  }
}

// Push the (value, index) pair thread 0 holds into slot `rank` of every
// peer's v_s / i_s; called by every thread of the block.
__device__ __forceinline__ void ksim_cluster_push_pick(float bv, int bi, float* v_s, int* i_s) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned C = cl.num_blocks();
  if (threadIdx.x < 32) {
    bv = __shfl_sync(0xffffffffu, bv, 0);
    bi = __shfl_sync(0xffffffffu, bi, 0);
    if (threadIdx.x < C) {
      *cl.map_shared_rank(v_s + cl.block_rank(), threadIdx.x) = bv;
      *cl.map_shared_rank(i_s + cl.block_rank(), threadIdx.x) = bi;
    }
  }
}

// Fold the C pairs of v_s / i_s (after the barrier) through ksim_better
// (MAX) or ksim_lower, in every thread.
template <bool MAX>
__device__ __forceinline__ void ksim_cluster_fold_pick(float& bv, int& bi, const float* v_s,
                                                       const int* i_s) {
  const int C = (int)cg::this_cluster().num_blocks();
  bv = v_s[0];
  bi = i_s[0];
  for (int r = 1; r < C; ++r) {
    if (MAX) ksim_better(bv, bi, v_s[r], i_s[r]); else ksim_lower(bv, bi, v_s[r], i_s[r]);
  }
}

// Fold the cluster's first-reject counts (ksim_reject_count_body's tot, in
// thread 0 of each block) into rank 0's thread 0: each rank's thread 0 writes
// its counts into slot `rank` of rank 0's slots, then a cluster barrier, which
// every thread of every block reaches; integer sums, in rank order. Rank 0
// folds the slots before it reaches the caller's next cluster barrier, after
// which a rank may write them again.
__device__ __forceinline__ void ksim_cluster_fold_counts(int* tot) {
  __shared__ int slots[KSIM_MAX_CLUSTER][KSIM_PLUGINS + 1];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  if (threadIdx.x == 0) {
    int* dst = cl.map_shared_rank(slots[cl.block_rank()], 0);
    for (int k = 0; k <= KSIM_PLUGINS; ++k) dst[k] = tot[k];
  }
  cl.sync();
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    for (int k = 0; k <= KSIM_PLUGINS; ++k) {
      int v = 0;
      for (int r = 0; r < C; ++r) v += slots[r][k];
      tot[k] = v;
    }
  }
}

// The row constants of one pod's NormalizeScore from its extrema
// (ops/tpu.py _normalize_row / spread_norm_from_extrema) and the Score
// weights of scenario scen.
struct KsimNorm {
  bool t_pos, na_pos, ip_ok, sp_has, sp_pos, any_scored;
  float t_den, na_den, ip_lo0, ip_k, sp_hi_f, sp_lo_f;
  int32_t sp_hi_i, sp_lo_i;
  float w_fit, w_taint, w_na, w_ip, w_sp;
};

__device__ __forceinline__ KsimNorm ksim_norm(const KsimArgs& a, int p, int64_t scen,
                                              const float* v) {
  KsimNorm c;
  const float taint_hi = v[0], na_hi = v[1], ip_lo = v[2], ip_hi = v[3];
  const float sp_lo = v[4], sp_hi = v[5];
  const bool any_f = v[6] > 0.f;
  c.any_scored = false;
  if (a.spread)
    for (int t = 0; t < a.SP; ++t)
      if (a.spread_g[p * a.SP + t] >= 0 && !a.spread_dns[p * a.SP + t]) c.any_scored = true;
  c.t_pos = taint_hi > 0.f;
  c.t_den = c.t_pos ? taint_hi : 1.f;
  c.na_pos = na_hi > 0.f;
  c.na_den = c.na_pos ? na_hi : 1.f;
  const float ip_span = ip_hi - ip_lo;
  c.ip_ok = any_f && ip_span > 0.f;
  c.ip_lo0 = c.ip_ok ? ip_lo : 0.f;
  c.ip_k = 100.f / (c.ip_ok ? ip_span : 1.f);
  c.sp_has = sp_hi > -INFINITY;
  c.sp_hi_f = c.sp_has ? sp_hi : 0.f;
  c.sp_lo_f = c.sp_has ? sp_lo : 0.f;
  c.sp_pos = c.sp_hi_f > 0.f;
  c.sp_hi_i = (int32_t)c.sp_hi_f;
  c.sp_lo_i = (int32_t)c.sp_lo_f;
  // Weights: the static constants, or scenario scen's policy row (columns
  // 0-4; every row the step enables enters the total, a zero weight as an
  // exact 0 * row, ops/tpu.py:62 policy_weight_fns).
  const float* wr = a.wrow ? a.wrow + scen * KSIM_POLICY_COLS : nullptr;
  c.w_fit = wr ? wr[0] : a.w_fit;
  c.w_taint = wr ? wr[1] : a.w_taint;
  c.w_na = wr ? wr[2] : a.w_na;
  c.w_ip = wr ? wr[3] : a.w_ip;
  c.w_sp = wr ? wr[4] : a.w_sp;
  return c;
}

// One node's weighted total of its normalized rows, in the reference's
// plugin order.
__device__ __forceinline__ float ksim_total(const KsimArgs& a, const KsimNorm& c,
                                            const KsimRaw& r) {
  float total = 0.f;
  if (a.on_fit) total = total + c.w_fit * r.fit;
  if (a.on_taint) {
    float o = floorf((r.taint * 100.f) / c.t_den);
    o = c.t_pos ? 100.f - o : 100.f;
    total = total + c.w_taint * o;
  }
  if (a.on_na) {
    float o = floorf((r.na * 100.f) / c.na_den);
    o = c.na_pos ? o : 0.f;
    total = total + c.w_na * o;
  }
  if (a.on_ip) {
    float o = floorf((r.ip - c.ip_lo0) * c.ip_k);
    o = c.ip_ok ? o : 0.f;
    total = total + c.w_ip * o;
  }
  if (a.on_sp) {
    const float sp = r.sp;
    float o;
    if (a.sp_norm_f32) {
      float vals = floorf((100.f * ((c.sp_hi_f + c.sp_lo_f) - sp)) / (c.sp_pos ? c.sp_hi_f : 1.f));
      o = c.sp_pos ? vals : 100.f;
    } else {
      int32_t num = 100 * ((c.sp_hi_i + c.sp_lo_i) - (int32_t)sp);
      int32_t vals = ksim_floordiv(num, c.sp_hi_i > 0 ? c.sp_hi_i : 1);
      o = c.sp_hi_i > 0 ? (float)vals : 100.f;
    }
    if (r.ign || !c.sp_has || !c.any_scored) o = 0.f;
    total = total + c.w_sp * o;
  }
  return total;
}

// K2's body, for one block of scenario scen's cluster: the normalized total
// and the lowest-index argmax of pod p's scratch rows; the cluster's rank-0
// block writes the choice (or PAD) to *choice. The block owns the nodes
// [lo, hi) of the scenario (a cluster of one block: [0, N), the one-block
// body, with no cluster barrier). p < 0 (an empty retry-buffer slot, uniform
// over the cluster) writes PAD. Under tier preemption a scenario with no
// feasible node takes, once per `wave`, the masked argmin of K1's candidate
// row and writes the eviction record K3 applies before the bind; every other
// scenario writes ev_node = -1. Every decision after an exchange (placed or
// PAD, `fire`) is uniform over the cluster, so every thread of every block
// reaches every cluster barrier. Returns, in every thread, the choice over
// the feasible nodes (PAD: none is, or p < 0), before any eviction: the gate
// of first-reject attribution (K6's attributed mode).
__device__ __forceinline__ int ksim_normalize_select_body(const KsimArgs& a, int p,
                                                           int64_t scen, int* choice,
                                                           int wave, int lo, int hi) {
  __shared__ float red[KSIM_EXT * 32];
  __shared__ float best_v[KSIM_MAX_WARPS];
  __shared__ int best_i[KSIM_MAX_WARPS];
  __shared__ int s_choice;
  // the cluster's slots (ksim_cluster_push_*): extrema, argmax and argmin pairs
  __shared__ float x_ext[KSIM_MAX_CLUSTER][KSIM_EXT];
  __shared__ float x_v[2][KSIM_MAX_CLUSTER];
  __shared__ int x_i[2][KSIM_MAX_CLUSTER];
  cg::cluster_group cl = cg::this_cluster();
  const bool multi = cl.num_blocks() > 1;
  const bool lead = cl.block_rank() == 0;
  if (p < 0) {
    if (lead && threadIdx.x == 0) *choice = KSIM_PAD;
    return KSIM_PAD;
  }
  // A block with at most one node a thread (a cluster's rank, as a rule)
  // loads its node's rows once, for both passes.
  const bool one = hi - lo <= (int)blockDim.x;  // uniform over the block
  const int n1 = lo + (int)threadIdx.x;
  KsimRaw r1 = {};
  if (one && n1 < hi) r1 = ksim_raw(a, scen, n1);

  // pass 1: extrema
  float v[KSIM_EXT];
  ksim_extrema_init(v);
  const bool is_max[KSIM_EXT] = KSIM_EXTREMA_IS_MAX;
  if (one) {
    if (n1 < hi) ksim_extrema_node(r1, v);
  } else {
    for (int n = n1; n < hi; n += blockDim.x) ksim_extrema_node(ksim_raw(a, scen, n), v);
  }
  ksim_block_extrema(v, KSIM_EXT, is_max, red);
  if (multi) {
    ksim_cluster_push_extrema(v, x_ext);
    cl.sync();
    ksim_cluster_fold_extrema(v, x_ext);
  }
  const KsimNorm c = ksim_norm(a, p, scen, v);

  // pass 2: total + argmax (lowest index on ties)
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  if (one) {
    if (n1 < hi) {
      const float total = ksim_total(a, c, r1);
      if (r1.f) ksim_better(bv, bi, total, n1);
    }
  } else {
    for (int n = n1; n < hi; n += blockDim.x) {
      const KsimRaw r = ksim_raw(a, scen, n);
      const float total = ksim_total(a, c, r);
      if (r.f) ksim_better(bv, bi, total, n);
    }
  }
  ksim_block_pick<true>(bv, bi, best_v, best_i);
  if (multi) {
    ksim_cluster_push_pick(bv, bi, x_v[0], x_i[0]);
    cl.sync();
    ksim_cluster_fold_pick<true>(bv, bi, x_v[0], x_i[0]);
  }
  if (threadIdx.x == 0) s_choice = bv > -INFINITY ? bi : KSIM_PAD;
  __syncthreads();
  if (!a.preempt) {
    if (lead && threadIdx.x == 0) *choice = s_choice;
    return s_choice;
  }
  // Tier preemption (ops/tpu3.py:1542-1575): nothing feasible, the pod may
  // preempt and no preemption fired yet in this wave of this scenario ->
  // the lowest-index masked argmin (ops/tpu.py:788) of K1's candidate row,
  // and the eviction record K3 applies before the bind. Every block reads
  // last_wave before the argmin's barrier; rank 0 writes it after.
  const bool fire = s_choice == KSIM_PAD && ksim_may_preempt(a, p) &&
                    a.last_wave[scen] != wave;  // uniform over the cluster
  int node = KSIM_PAD;
  if (fire) {
    const float* cand = a.cand + scen * a.N;
    float mv = INFINITY;
    int mi = 0x7fffffff;
    for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
      float c2 = cand[n];
      if (c2 < INFINITY) ksim_lower(mv, mi, c2, n);
    }
    ksim_block_pick<false>(mv, mi, best_v, best_i);
    if (multi) {
      ksim_cluster_push_pick(mv, mi, x_v[1], x_i[1]);
      cl.sync();
      ksim_cluster_fold_pick<false>(mv, mi, x_v[1], x_i[1]);
    }
    if (threadIdx.x == 0 && mv < INFINITY) node = mi;
  }
  if (lead && threadIdx.x == 0) {
    if (node >= 0) {
      *choice = node;
      a.ev_node[scen] = node;
      a.ev_tier[scen] = a.pod_tier[p];
      a.last_wave[scen] = wave;
    } else {
      *choice = s_choice;
      a.ev_node[scen] = KSIM_PAD;
    }
  }
  return s_choice;  // written once a call, before the barrier above
}

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
__device__ __forceinline__ void ksim_evict(const KsimArgs& a, int64_t scen, int32_t* ch,
                                           int slot, int L, int boundary, float* used) {
  __shared__ int red[KSIM_MAX_WARPS];
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

// K3's block body in scenario scen: sign × the contribution of K (pod, node)
// pairs, in pair order — a bind (sign +1) or a gang rollback (sign -1,
// rollback); a release is ksim_release's (apply_placements.cu). Pair k is pod
// pods_all[scen * pod_ss + k] at the node of choice-buffer column pos[k] (pos
// null: column col0 + k) of the scenario's row choices + scen * choice_ss.
// rollback, boundary (the eviction step of a bind under tier preemption) and
// append (the failure append of a main-path bind) as K3's launch takes them.
__device__ __forceinline__ void ksim_apply_body(const KsimArgs& a, int64_t scen,
                                                const int32_t* pods_all, int64_t pod_ss,
                                                const int32_t* pos, int col0, int32_t* choices,
                                                int K, int64_t choice_ss, float sign,
                                                int rollback, int boundary, int append) {
  __shared__ uint8_t active[KSIM_MAX_WAVE];
  const int N = a.N, R = a.R, G = a.G, D = a.D;
  const int32_t* pods = pods_all + scen * pod_ss;
  int32_t* ch = choices + scen * choice_ss;
  float* used = a.used + scen * a.used_ss;
  float* match_count = a.match_count + scen * a.plane_ss;
  float* anti_active = a.anti_active + scen * a.plane_ss;
  float* pref_wsum = a.pref_wsum + scen * a.plane_ss;
  const int32_t* gdom = ksim_label_rows(a, scen).gdom;
#define KSIM_COL(k) (pos ? pos[(k)] : col0 + (k))
  if (boundary >= 0 && a.preempt) {
    ksim_evict(a, scen, ch, KSIM_COL(0), (int)choice_ss, boundary, used);
    __syncthreads();
  }
  // Tier-plane columns of a pair (non-gang pods under tier preemption):
  // used_tier[tier, n, 0..R) then npods_tier[tier, n].
  const int TC = a.preempt ? R + 1 : 0;
  float* used_tier = a.used_tier + scen * (int64_t)a.Tt * N * R;
  float* npods_tier = a.npods_tier + scen * (int64_t)a.Tt * N;
  if (rollback) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      int p = pods[k], n = ch[KSIM_COL(k)];
      uint8_t act = 0;
      if (p >= 0 && n >= 0) {
        int g = a.group_id[p];
        if (g >= 0)
          for (int j = 0; j < K; ++j) {
            int pj = pods[j];
            if (pj >= 0 && a.group_id[pj] == g && ch[KSIM_COL(j)] < 0) act = 1;
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
    int n = ch[KSIM_COL(k)];
    if (n < 0) continue;
    if (rollback && !active[k]) continue;
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
      if (active[k]) ch[KSIM_COL(k)] = KSIM_PAD;
  }
  if (append && tid == 0) {
    for (int k = 0; k < K; ++k) {
      const int p = pods[k];
      if (p < 0 || ch[KSIM_COL(k)] >= 0 || a.group_id[p] >= 0) continue;
      const int c = a.rcount[scen];
      if (c < a.RB) {
        a.rbuf[scen * a.RB + c] = p;
        a.rcount[scen] = c + 1;
      } else {
        a.rdrop[scen] += 1;
      }
    }
  }
#undef KSIM_COL
}

// ---------------------------------------------------------------------------
// The bodies of the node-shard kernels (row B13). K7 shard_select and K8
// shard_apply are thin __global__ wrappers over them, and K9
// shard_chunk_replay runs K1's per-node body and these two for every slot of a
// chunk in one launch (one cluster a scenario), so the per-slot shard route
// and the chunk's execute the same arithmetic.
// ---------------------------------------------------------------------------

#define KSIM_SHARD_NONE 0x7fffffff

// A barrier over the C blocks of a scenario's cluster (C = 1: the block's).
__device__ __forceinline__ void ksim_cluster_barrier(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// K7's body for one block of scenario scen's cluster of C blocks, block rank
// r owning shards r, r + C, ... (phases (0)-(d) of shard_select.cu): each own
// shard's packed extrema into ext, their fold over the cluster, each own
// shard's (max total, lowest global id) pair into best_v / best_i, their fold
// over the cluster; the owner of the winner's shard writes the choice into
// column `slot` of the scenario's row of the choice buffer and the winner's
// domain row, from its own gdom block, into cdom[s, slot, :] (unplaced: rank
// 0 writes PAD into both). Reads the scratch rows of its own shards only,
// which the block wrote (K9) or K1 did before the launch. Two cluster
// barriers at C > 1, reached by every thread. Returns the choice (PAD:
// unplaced) in every thread.
__device__ __forceinline__ int ksim_shard_select_body(const KsimArgs& a, int p, int64_t scen,
                                                      int32_t* choices, int64_t choice_ss,
                                                      int slot) {
  __shared__ float red[KSIM_EXT * 32];
  __shared__ float best_v[KSIM_MAX_WARPS];
  __shared__ int best_i[KSIM_MAX_WARPS];
  __shared__ int s_choice;
  // the cluster's slots (ksim_cluster_push_*): extrema and (total, id) pairs
  __shared__ float x_ext[KSIM_MAX_CLUSTER][KSIM_EXT];
  __shared__ float x_v[KSIM_MAX_CLUSTER];
  __shared__ int x_i[KSIM_MAX_CLUSTER];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const bool is_max[KSIM_EXT] = KSIM_EXTREMA_IS_MAX;

  // (0) each own shard's packed extrema, and their fold (unpacked)
  float v[KSIM_EXT];
  ksim_extrema_init(v);
  for (int q = rank; q < a.NP; q += C) {
    const int n0 = q * a.n_local;
    float u[KSIM_EXT];
    ksim_extrema_init(u);
    for (int i = threadIdx.x; i < a.n_local; i += blockDim.x)
      ksim_extrema_node(ksim_raw(a, scen, n0 + i), u);
    ksim_block_extrema(u, KSIM_EXT, is_max, red);
    for (int k = 0; k < KSIM_EXT; ++k) v[k] = is_max[k] ? fmaxf(v[k], u[k]) : fminf(v[k], u[k]);
    if (threadIdx.x == 0) {
      ksim_extrema_flip(u);
      float* out = a.ext + (scen * a.NP + q) * KSIM_EXT;
      for (int k = 0; k < KSIM_EXT; ++k) out[k] = u[k];
    }
  }
  // (a) the cluster's fold of the shards' extrema
  if (C > 1) {
    ksim_cluster_push_extrema(v, x_ext);
    cl.sync();
    ksim_cluster_fold_extrema(v, x_ext);
  }
  const KsimNorm c = ksim_norm(a, p, scen, v);

  // (b) each own shard's (max total, lowest global id), folded in shard order
  float fv = -INFINITY;
  int fi = KSIM_SHARD_NONE;
  for (int q = rank; q < a.NP; q += C) {
    const int n0 = q * a.n_local;
    float bv = -INFINITY;
    int bi = KSIM_SHARD_NONE;
    for (int i = threadIdx.x; i < a.n_local; i += blockDim.x) {
      const int n = n0 + i;
      const KsimRaw r = ksim_raw(a, scen, n);
      const float total = ksim_total(a, c, r);
      if (r.f) ksim_better(bv, bi, total, n);
    }
    ksim_block_pick<true>(bv, bi, best_v, best_i);
    if (threadIdx.x == 0) {
      if (!(bv > -INFINITY)) bi = KSIM_SHARD_NONE;
      a.best_v[scen * a.NP + q] = bv;
      a.best_i[scen * a.NP + q] = bi;
      ksim_better(fv, fi, bv, bi);
    }
    __syncthreads();  // the next shard's pick rewrites best_v / best_i
  }
  // (c) the cluster's fold of the pairs
  if (C > 1) {
    ksim_cluster_push_pick(fv, fi, x_v, x_i);
    cl.sync();
    ksim_cluster_fold_pick<true>(fv, fi, x_v, x_i);
  }
  if (threadIdx.x == 0) s_choice = fv > -INFINITY ? fi : KSIM_PAD;
  __syncthreads();

  // (d) the owner's (or, unplaced, rank 0's) writes
  const int choice = s_choice;
  const bool owner = choice >= 0 ? (choice / a.n_local) % C == rank : rank == 0;
  if (owner) {
    int32_t* cd = a.cdom + (scen * choice_ss + slot) * a.G;
    const int32_t* gdom = ksim_label_rows(a, scen).gdom;
    for (int g = threadIdx.x; g < a.G; g += blockDim.x)
      cd[g] = choice >= 0 ? gdom[(size_t)g * a.N + choice] : KSIM_PAD;
    if (threadIdx.x == 0) choices[scen * choice_ss + slot] = choice;
  }
  return choice;
}

// K8's body for one block of scenario scen: sign x the contribution of K
// (pod, node) pairs, in pair order. Pair k is pod pods[k] at the node of
// choice-buffer column pos[k] (pos null: col0 + k) of the scenario's row
// (PAD pods and nodes skipped). The block owns the nodes of the shards q with
// q % CO == RO (K8: CO = NP, RO its shard; K9: CO = C, RO its rank) and
// applies the pairs at those nodes to their used rows, thread 1 + c a column
// c; with `planes` (the block holding shard 0) it applies every pair to the
// replicated count planes at the domain ids of its column, cdom[s, col, :],
// never reading another shard's gdom block (thread 0 the anti-affinity and
// preferred-affinity terms, thread 1 + R + g group g's match_count). Three
// uses, as K3's:
//   bind      sign +1;
//   rollback  sign -1 over one wave: a pair is undone iff its pod placed and
//             a slot of the same gang in the wave went unplaced; after
//             `sync()` (a barrier over every block of the scenario, which
//             every block reaches: each has read the wave's choices) the
//             planes block writes PAD over the undone pairs' choices;
//   release   sign -1, not a rollback: each owned node's requests summed from
//             zero in pair order (the rel accumulator), then subtracted once.
template <class Sync>
__device__ __forceinline__ void ksim_shard_apply_body(const KsimArgs& a, int64_t scen,
                                                      const int32_t* pods, const int32_t* pos,
                                                      int col0, int32_t* choices, int K,
                                                      int64_t choice_ss, float sign,
                                                      int rollback, int CO, int RO, bool planes,
                                                      Sync sync) {
  __shared__ uint8_t active[KSIM_MAX_WAVE];
  const int R = a.R, G = a.G, D = a.D;
  int32_t* ch = choices + scen * choice_ss;
  const int32_t* cdom = a.cdom + scen * choice_ss * G;
  float* used = a.used + scen * a.used_ss;
  float* rel = a.rel + scen * a.used_ss;
  float* match_count = a.match_count + scen * a.plane_ss;
  float* anti_active = a.anti_active + scen * a.plane_ss;
  float* pref_wsum = a.pref_wsum + scen * a.plane_ss;
#define KSIM_SCOL(k) (pos ? pos[(k)] : col0 + (k))
  auto mine = [&](int n) { return n >= 0 && (n / a.n_local) % CO == RO; };
  if (rollback) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int p = pods[k], n = ch[KSIM_SCOL(k)];
      uint8_t act = 0;
      if (p >= 0 && n >= 0) {
        const int g = a.group_id[p];
        if (g >= 0)
          for (int j = 0; j < K; ++j) {
            const int pj = pods[j];
            if (pj >= 0 && a.group_id[pj] == g && ch[KSIM_SCOL(j)] < 0) act = 1;
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
    const int col = KSIM_SCOL(k);
    const int n = ch[col];
    if (n < 0) continue;
    if (rollback && !active[k]) continue;
    const int32_t* dom = cdom + (size_t)col * G;
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
      const bool own = mine(n);
      for (int c = tid - 1; c < R + G; c += blockDim.x - 1) {
        if (c < R) {
          if (!own) continue;
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
      const int n = p < 0 ? KSIM_PAD : ch[KSIM_SCOL(k)];
      if (!mine(n)) continue;
      for (int c = tid - 1; c < R; c += blockDim.x - 1) {
        float* acc = rel + (size_t)n * R + c;
        used[(size_t)n * R + c] = used[(size_t)n * R + c] - *acc;
        *acc = 0.f;
      }
    }
  }
  if (rollback) {
    sync();  // every block has read the wave's choices
    if (planes)
      for (int k = threadIdx.x; k < K; k += blockDim.x)
        if (active[k]) ch[KSIM_SCOL(k)] = KSIM_PAD;
  }
#undef KSIM_SCOL
}

// ---------------------------------------------------------------------------
// The retry buffer's boundary bodies (sim/whatif.py:1433-1494): the pending
// release and K4's bookkeeping. K4 retry_boundary is a thin __global__
// wrapper over the bookkeeping; K3's release (apply_placements.cu) shares
// ksim_release_cells; K6's retry mode (chunk_replay.cuh) runs both on the
// rank-0 block of a scenario's cluster.
// ---------------------------------------------------------------------------

// The count-plane cells of pod p at node n: f(plane, cell, term) for each
// (0 match_count, 1 anti_active, 2 pref_wsum), the term an integer. The
// pod's pmg row is read a 4-byte word at a time (most of it is zero).
template <class F>
__device__ __forceinline__ void ksim_release_cells(const KsimArgs& a, const int32_t* gdom, int p,
                                                   int n, F f) {
  const int N = a.N, G = a.G, D = a.D;
  const uint8_t* row = a.pmg + (size_t)p * G;
  const uint32_t* w0 = (const uint32_t*)((uintptr_t)row & ~(uintptr_t)3);
  const int skip = (int)((uintptr_t)row & 3);  // bytes of the first word before the row
#pragma unroll 4
  for (int w = 0; 4 * w - skip < G; ++w) {
    const uint32_t v = w0[w];
    if (!v) continue;
    for (int b = 0; b < 4; ++b) {
      const int g = 4 * w + b - skip;
      if (g < 0 || g >= G || !((v >> (8 * b)) & 0xffu)) continue;
      const int dom = gdom[(size_t)g * N + n];
      if (dom >= 0) f(0, g * D + dom, 1);
    }
  }
  for (int t = 0; t < a.AA; ++t) {
    const int g = a.anti_req[p * a.AA + t];
    if (g < 0) continue;
    const int dom = gdom[(size_t)g * N + n];
    if (dom >= 0) f(1, g * D + dom, 1);
  }
  for (int t = 0; t < a.PA; ++t) {
    const int g = a.pref_aff[p * a.PA + t];
    if (g < 0) continue;
    const int dom = gdom[(size_t)g * N + n];
    if (dom >= 0) f(2, g * D + dom, (int)a.pref_aff_w[p * a.PA + t]);
  }
}


// Scenario scen's pending release at boundary due_b in one block (K6's retry
// mode): the pairs (pend_id[k], pend_node[k]) with pend_relb[k] <= due_b, in
// list order. Each node's requests are summed from zero in pair order by the
// thread that owns the node's first pair and subtracted once, as K3's release
// and the twin's _add_in_pair_order do (models/state.py release_delta); thread
// 0 then moves the count-plane cells pair by pair (integer terms below 2^24,
// exact in any order, one writer). Synchronises the block on return.
__device__ __forceinline__ void ksim_pending_release(const KsimArgs& a, int64_t scen, int due_b) {
  __shared__ int node_of[KSIM_MAX_RB];  // the pair's node, PAD for a pair not due
  const int RB = a.RB, R = a.R;
  const int32_t* id = a.pend_id + scen * RB;
  const int32_t* nd = a.pend_node + scen * RB;
  const int32_t* relb = a.pend_relb + scen * RB;
  for (int k = threadIdx.x; k < RB; k += blockDim.x)
    node_of[k] = id[k] >= 0 && nd[k] >= 0 && relb[k] <= due_b ? nd[k] : KSIM_PAD;
  __syncthreads();
  float* used = a.used + scen * a.used_ss;
  for (int k = threadIdx.x; k < RB; k += blockDim.x) {
    const int n = node_of[k];
    if (n < 0) continue;
    int j = 0;
    while (j < k && node_of[j] != n) ++j;
    if (j < k) continue;  // not the node's first pair
    for (int c = 0; c < R; ++c) {
      float acc = 0.f;
      for (j = k; j < RB; ++j)
        if (node_of[j] == n) acc = acc + a.requests[(size_t)id[j] * R + c];
      used[(size_t)n * R + c] = used[(size_t)n * R + c] - acc;
    }
  }
  if (threadIdx.x == 0) {
    float* planes[3] = {a.match_count + scen * a.plane_ss, a.anti_active + scen * a.plane_ss,
                        a.pref_wsum + scen * a.plane_ss};
    const int32_t* gdom = ksim_label_rows(a, scen).gdom;
    for (int k = 0; k < RB; ++k)
      if (node_of[k] >= 0)
        ksim_release_cells(a, gdom, id[k], node_of[k], [&](int plane, int cell, int v) {
          planes[plane][cell] = planes[plane][cell] - (float)v;
        });
  }
  __syncthreads();
}

#define KSIM_RB_THREADS 1024
#define KSIM_RB_ITEMS (KSIM_MAX_RB / KSIM_RB_THREADS)

// Exclusive block-wide prefix sum of one int per thread; *total gets the
// block's sum. Every thread of the block must call it.
__device__ __forceinline__ int ksim_block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sum[KSIM_RB_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  const int before = warp ? warp_sum[warp - 1] : 0;
  *total = warp_sum[nw - 1];
  __syncthreads();  // the next call may reuse warp_sum
  return before + x - v;
}

#define KSIM_NEVER 0x7fffffff
// first_b of a pod bound in its wave (or pre-bound) and evicted since.
#define KSIM_FIRST_IN_WAVE (-2)

// The timeline's event log (ops/reference.py EventLog; null rec: none): rec
// [S, cap, 4] i32 records (kind, boundary, pod, node) in append order, n [S]
// the records each scenario appended. Past cap a record is dropped and n
// still counts it, so the host sees a full log after the run and raises.
#define KSIM_LOG_BIND 0
#define KSIM_LOG_PREEMPT 1
#define KSIM_LOG_EVICT 2
struct KsimLog {
  int32_t* rec;
  int32_t* n;
  int32_t cap;
  int32_t pad0;
};

// Append one record to scenario scen's log: one thread, the scenario's only
// writer (K6's rank 0, K10's block), in the reference's event order.
__device__ __forceinline__ void ksim_log_append(const KsimLog& lg, int64_t scen, int kind,
                                                int b, int pod, int node) {
  if (!lg.rec) return;
  const int i = lg.n[scen];
  if (i < lg.cap) {
    int32_t* r = lg.rec + (scen * lg.cap + i) * 4;
    r[0] = kind;
    r[1] = b;
    r[2] = pod;
    r[3] = node;
  }
  lg.n[scen] = i + 1;
}

// What K6's retry mode adds to a retried bind under a chaos timeline
// (sim/boundary.py:401-475, :632-639; null pointers: nothing): rrel / first_b
// [S,P] the boundary of each retried pod's pending release (KSIM_NEVER: none
// listed) and its first bind, which K10 reads to find a pod's node; evict_t
// [S,P] f64 the start time of the boundary that evicted a pod still waiting
// for a re-bind (negative: none), resched [S] the re-binds and evict_lat [S]
// f64 their summed latency; t_bd the boundary's f64 start time (inf: the
// trailing boundary, which counts a re-bind and adds no latency).
struct KsimRebind {
  int32_t* rrel;
  int32_t* first_b;
  double* evict_t;
  int32_t* resched;
  double* evict_lat;
  double t_bd;
};

// Pod row i (scenario scen) is bound by the retry pass: a chaos victim
// waiting for a re-bind is re-bound — its eviction time cleared, the re-bind
// counted, t_bd − t_evict added in f64 at a finite boundary. One thread, in
// bind order.
__device__ __forceinline__ void ksim_chaos_rebind(const KsimRebind& rb, int64_t scen,
                                                  int64_t i) {
  const double te = rb.evict_t[i];
  if (te < 0.0) return;
  rb.evict_t[i] = -1.0;
  rb.resched[scen] += 1;
  if (isfinite(rb.t_bd)) rb.evict_lat[scen] = rb.evict_lat[scen] + (rb.t_bd - te);
}

// K4's bookkeeping of boundary b (start time t_b, f32) in scenario scen, in
// one block of KSIM_RB_THREADS threads, after the retry pass wrote its choice
// of each buffer slot k to rchoice[scen, k] (retry_boundary.cu describes the
// three steps: the retried binds recorded, the pending list rebuilt, the
// buffer compacted). Each thread owns a contiguous run of at most
// KSIM_RB_ITEMS buffer slots and pending entries and reads all of them before
// the block writes (the compactions are in place); block-wide exclusive scans
// of the per-thread counts give every kept entry its position: stable,
// integer-only, no atomics. With `rb` (K6's retry mode under a chaos
// timeline) each retried bind also records its pending release's boundary
// and its first bind, and thread 0 counts the re-binds of evicted pods in
// buffer order (the pass's bind order).
__device__ __forceinline__ void ksim_retry_bookkeeping(const KsimArgs& a, int64_t scen, int b,
                                                       float t_b,
                                                       const KsimRebind* rb = nullptr) {
  const int RB = a.RB, B = a.B;
  int32_t* rbuf = a.rbuf + scen * RB;
  const int32_t* rch = a.rchoice + scen * RB;
  int32_t* pend_id = a.pend_id + scen * RB;
  int32_t* pend_node = a.pend_node + scen * RB;
  int32_t* pend_relb = a.pend_relb + scen * RB;
  int32_t* rnode = a.rnode + scen * (int64_t)a.P;
  int32_t* rbind_b = a.rbind_b + scen * (int64_t)a.P;
  const int per = (RB + blockDim.x - 1) / blockDim.x;  // <= KSIM_RB_ITEMS
  const int k0 = threadIdx.x * per;
  int32_t* rrel = rb ? rb->rrel : nullptr;
  int32_t* first_b = rb ? rb->first_b : nullptr;
  if (rrel) {
    rrel += scen * (int64_t)a.P;
    first_b += scen * (int64_t)a.P;
  }
  if (rb && rb->evict_t && threadIdx.x == 0)  // reads only: the block's writes come later
    for (int k = 0; k < RB && rbuf[k] >= 0; ++k)
      if (rch[k] >= 0) ksim_chaos_rebind(*rb, scen, scen * (int64_t)a.P + rbuf[k]);

  // Read this thread's buffer slots and pending entries.
  int pod[KSIM_RB_ITEMS], node[KSIM_RB_ITEMS], relb_new[KSIM_RB_ITEMS];
  int old_id[KSIM_RB_ITEMS], old_node[KSIM_RB_ITEMS], old_relb[KSIM_RB_ITEMS];
  int n_keep = 0, n_add = 0, n_old = 0;
  for (int i = 0; i < per; ++i) {
    const int k = k0 + i;
    const int q = k < RB ? rbuf[k] : KSIM_PAD;
    const int c = q >= 0 ? rch[k] : KSIM_PAD;
    pod[i] = q;
    node[i] = c;
    relb_new[i] = KSIM_PAD;
    if (q >= 0 && c >= 0) {
      rnode[q] = c;
      rbind_b[q] = b;
      if (rrel) {
        if (first_b[q] == KSIM_PAD) first_b[q] = b;
        rrel[q] = KSIM_NEVER;  // until its pending entry is listed below
      }
      const float v = t_b + a.dur[q];
      int lo = 0, hi = B;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a.tbt[mid] < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo < B) {
        relb_new[i] = lo > b + 1 ? lo : b + 1;
        ++n_add;
      }
    } else if (q >= 0) {
      ++n_keep;
    }
    old_id[i] = KSIM_PAD;
    if (k < RB && pend_id[k] >= 0 && pend_relb[k] > b) {
      old_id[i] = pend_id[k];
      old_node[i] = pend_node[k];
      old_relb[i] = pend_relb[k];
      ++n_old;
    }
  }
  __syncthreads();  // every read before any write: the compactions are in place

  // The pending list: the kept entries, then the new ones, the first RB.
  int total_old, total_add;
  int j = ksim_block_exclusive_scan(n_old, &total_old);
  const int off_add = ksim_block_exclusive_scan(n_add, &total_add);
  for (int i = 0; i < per; ++i) {
    if (old_id[i] < 0) continue;
    pend_id[j] = old_id[i];  // j < total_old <= RB
    pend_node[j] = old_node[i];
    pend_relb[j] = old_relb[i];
    ++j;
  }
  j = total_old + off_add;
  for (int i = 0; i < per; ++i) {
    if (relb_new[i] < 0) continue;
    if (j < RB) {
      pend_id[j] = pod[i];
      pend_node[j] = node[i];
      pend_relb[j] = relb_new[i];
      if (rrel) rrel[pod[i]] = relb_new[i];
    }
    ++j;
  }
  const int n_pend = min(total_old + total_add, RB);
  for (int k = n_pend + threadIdx.x; k < RB; k += blockDim.x) {
    pend_id[k] = KSIM_PAD;
    pend_node[k] = KSIM_PAD;
    pend_relb[k] = KSIM_PAD;
  }

  // The buffer: its unplaced pods, in FIFO order.
  int total_keep;
  j = ksim_block_exclusive_scan(n_keep, &total_keep);
  for (int i = 0; i < per; ++i)
    if (pod[i] >= 0 && node[i] < 0) rbuf[j++] = pod[i];
  for (int k = total_keep + threadIdx.x; k < RB; k += blockDim.x) rbuf[k] = KSIM_PAD;
  if (threadIdx.x == 0) a.rcount[scen] = total_keep;
}

// ---------------------------------------------------------------------------
// Kube preemption: the PostFilter of one scenario's cluster
// (kubernetes_simulator_tpu/framework/framework.py:190-292
// _post_filter_preempt and :290 _fits_after, decision for decision). K6's
// retry mode (chunk_replay_retry.cu) runs it in its kube pass for a pod that
// no node admits, and commits its victims there.
// ---------------------------------------------------------------------------

// The kube tables of a retry-mode launch (ops/reference.py Retry's kube
// fields; the scratch is ops/kernels.py Bound's): raw priorities, each pod's
// choice-buffer column and each column's static release boundary, each
// pod's pending-release boundary (rrel: KSIM_NEVER, holds its node) and
// first-bind mark, the victim counter; the pass's queue ring kq [S,RB] and
// its state kst [S,4] (head, unwalked count, kept count, pending length);
// the PostFilter's scratch kvic [S,P] (each node's victims, grouped by node)
// and koff / kcnt [S,N]; the choice buffer.
struct KsimKube {
  const int32_t* prio;
  const int32_t* col_of;
  const int32_t* col_relb;
  int32_t* rrel;
  int32_t* first_b;
  int32_t* preempt;
  int32_t* kq;
  int32_t* kst;
  int32_t* kvic;
  int32_t* koff;
  int32_t* kcnt;
  int32_t* choices;
  int64_t choice_ss;
  int32_t trace_has_anti;
  int32_t pad0;
};

// Pod q's node in scenario scen during boundary b's pass (PAD: not bound):
// its retried node while its pending release has not fired, else its
// choice-buffer column's node while the column's static release has not.
__device__ __forceinline__ int ksim_bound_node(const KsimArgs& a, const KsimKube& k,
                                               int64_t scen, int q, int b) {
  const int64_t i = scen * (int64_t)a.P + q;
  const int rn = a.rnode[i];
  if (rn >= 0) return k.rrel[i] > b ? rn : KSIM_PAD;
  const int c = k.col_of[q];
  if (c < 0) return KSIM_PAD;
  const int n = k.choices[scen * k.choice_ss + c];
  return n >= 0 && k.col_relb[c] > b ? n : KSIM_PAD;
}

// Victims v[0, nv) of one node that match count group g (their
// match_count contributions there), and their required anti terms on g.
__device__ __forceinline__ float ksim_victims_match(const KsimArgs& a, const int32_t* v, int nv,
                                                    int g) {
  float d = 0.f;
  for (int i = 0; i < nv; ++i) d += a.pmg[(size_t)v[i] * a.G + g] ? 1.f : 0.f;
  return d;
}

__device__ __forceinline__ float ksim_victims_anti(const KsimArgs& a, const int32_t* v, int nv,
                                                   int g) {
  float d = 0.f;
  for (int i = 0; i < nv; ++i)
    for (int t = 0; t < a.AA; ++t) d += a.anti_req[v[i] * a.AA + t] == g ? 1.f : 0.f;
  return d;
}

// _fits_after's verdict at node n once the victims v[0, nv) on n are
// evicted, beyond the resource fit (checked by the caller at the trial
// usage) and the static filters (taints, node affinity: unchanged): the
// inter-pod and DoNotSchedule spread filters of pod p at the planes less the
// victims, whose contributions all sit at n's own domains. So the trial is
// deltas at those domains (the planes are never written): a count there
// drops by the matching victims, the bootstrap total of a required-affinity
// group by as many, a spread minimum becomes min(old minimum, the count at
// n's domain less the delta). Integer-valued counts: exact.
__device__ __forceinline__ bool ksim_fits_after(const KsimArgs& a, int p, int n,
                                                const KsimLabels& lab, const float* mc,
                                                const float* aa, const KsimTerms* terms,
                                                const int32_t* v, int nv) {
  const int N = a.N, G = a.G, D = a.D;
  const int32_t* gdom = lab.gdom;
  const uint8_t* pm = a.pmg + (size_t)p * G;
  if (a.interpod) {
    for (int t = 0; t < a.AR; ++t) {
      const int g = a.aff_req[p * a.AR + t];
      if (g < 0) continue;
      const int dom = gdom[g * N + n];
      const float d = dom >= 0 ? ksim_victims_match(a, v, nv, g) : 0.f;
      const float cnt = dom >= 0 ? mc[g * D + dom] - d : 0.f;
      const bool boot = terms->total[t] - d == 0.f && pm[g];
      if (!((cnt >= 1.f && dom >= 0) || boot)) return false;
    }
    for (int t = 0; t < a.AA; ++t) {
      const int g = a.anti_req[p * a.AA + t];
      if (g < 0) continue;
      const int dom = gdom[g * N + n];
      if (dom < 0) continue;
      if (mc[g * D + dom] - ksim_victims_match(a, v, nv, g) >= 1.f) return false;
    }
    for (int g = 0; g < G; ++g) {
      if (!pm[g]) continue;
      const int dom = gdom[g * N + n];
      if (dom >= 0 && aa[g * D + dom] - ksim_victims_anti(a, v, nv, g) > 0.f) return false;
    }
  }
  if (a.spread) {
    for (int t = 0; t < a.SP; ++t) {
      const int g = a.spread_g[p * a.SP + t];
      if (g < 0 || !a.spread_dns[p * a.SP + t]) continue;
      if (terms->nd[t] == 0) return false;
      const int dom = gdom[g * N + n];
      if (dom < 0) return false;
      const float cnt = mc[g * D + dom] - ksim_victims_match(a, v, nv, g);
      const float mn = fminf(terms->min[t], cnt);
      const float self = pm[g] ? 1.f : 0.f;
      if (!((cnt + self) - mn <= (float)a.spread_skew[p * a.SP + t])) return false;
    }
  }
  return true;
}

// The victims pod p needs at node n of scenario scen from n's candidates
// v[0, len) in (priority, pod index) order: nv in 1..len, or 0 where no
// prefix makes it fit. state_free (no state-dependent filter on p): the
// smallest prefix whose cumulative requests fit every resource,
// (used + req) - cum <= alloc + 1e-6 with cum summed in f32 in victim order
// (the reference's np.cumsum); each resource's fit only improves as cum
// grows, so the smallest prefix is the largest of the per-resource ones.
// Otherwise the reference's trial walk: evict v[0], v[1], ...; after each,
// the resource fit at the trial usage (used minus the victims' requests one
// by one, as unbind subtracts them), then the full chain's verdict at n
// (ksim_fits_after) unless state_free.
__device__ __forceinline__ int ksim_victims_needed(const KsimArgs& a, int p, int64_t scen, int n,
                                                   const int32_t* v, int len, bool state_free,
                                                   const KsimLabels& lab, const float* used_s,
                                                   const float* mc, const float* aa,
                                                   const KsimTerms* terms) {
  const int R = a.R;
  const float* req = a.requests + (size_t)p * R;
  const float* used = used_s + (size_t)n * R;
  const float* alloc = a.alloc + scen * a.alloc_ss + (size_t)n * R;
  if (a.fit && state_free) {
    int need = 0;
    for (int r = 0; r < R; ++r) {
      const float base = used[r] + req[r], lim = alloc[r] + 1e-6f;
      float cum = 0.f;
      int kr = -1;
      for (int i = 0; i < len; ++i) {
        cum = cum + a.requests[(size_t)v[i] * R + r];
        if (base - cum <= lim) {
          kr = i + 1;
          break;
        }
      }
      if (kr < 0) return 0;
      need = max(need, kr);
    }
    return need;
  }
  for (int k = 0; k < len; ++k) {
    if (a.fit) {
      bool fit = true;
      for (int r = 0; r < R; ++r) {
        float u = used[r];
        for (int i = 0; i <= k; ++i) u = u - a.requests[(size_t)v[i] * R + r];
        if (!(u + req[r] <= alloc[r] + 1e-6f)) fit = false;
      }
      if (!fit) continue;
    }
    if (state_free || ksim_fits_after(a, p, n, lab, mc, aa, terms, v, k + 1)) return k + 1;
  }
  return 0;
}

// (key, node) lexicographic minimum.
__device__ __forceinline__ void ksim_lower_key(unsigned long long& bk, int& bn,
                                               unsigned long long k2, int n2) {
  if (k2 < bk || (k2 == bk && n2 < bn)) {
    bk = k2;
    bn = n2;
  }
}

// The PostFilter of pod p (whose choice over the feasible nodes was PAD) in
// scenario scen's cluster at boundary b, this block owning the nodes
// [lo, hi) (every block of the cluster calls it; terms holds p's term tables
// at the current planes, from phase 1):
//   (1) the block's nodes' victim counts: each bound non-gang pod of lower
//       raw priority (ksim_bound_node), counted on its node with integer
//       atomics, those on nodes below lo summed;
//   (2) each node's offset into kvic (the victims below lo first, so every
//       rank writes a disjoint part), then each victim scattered there and
//       each node's list sorted by (priority, pod index), one thread a node;
//   (3) each node of the block, one thread a node: the static filters (taints
//       and node affinity, K1's chain's bits), then ksim_victims_needed;
//       a candidate's key is (victims, highest victim priority), with the
//       node, folded to the lexicographic minimum over the block (warp
//       shuffles, shared memory) and the cluster (each rank pushes its pair
//       into every peer's shared slots through DSMEM, then a cluster barrier,
//       which every thread reaches).
// Returns the chosen node (PAD: none) and *nv its victims, in every thread of
// the cluster; the victims are kvic[scen][koff[node] + i], i < *nv, written
// before the barrier. Integer arithmetic and exact float comparisons only.
__device__ __forceinline__ int ksim_post_filter(const KsimArgs& a, const KsimKube& k, int p,
                                                int64_t scen, int b, int lo, int hi,
                                                const KsimLabels& lab, const KsimTerms* terms,
                                                int* nv_out) {
  __shared__ int s_below[KSIM_MAX_WARPS];
  __shared__ unsigned long long s_key[KSIM_MAX_WARPS];
  __shared__ int s_node[KSIM_MAX_WARPS];
  __shared__ unsigned long long x_key[KSIM_MAX_CLUSTER];
  __shared__ int x_node[KSIM_MAX_CLUSTER];
  __shared__ unsigned long long s_best_key;
  __shared__ int s_best_node;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int P = a.P, N = a.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int pp = k.prio[p];
  int32_t* kcnt = k.kcnt + scen * N;
  int32_t* koff = k.koff + scen * N;
  int32_t* kvic = k.kvic + scen * (int64_t)P;
  // (1)
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) kcnt[n] = 0;
  __syncthreads();
  int below = 0;
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    if (k.prio[q] >= pp || a.group_id[q] >= 0) continue;
    const int n = ksim_bound_node(a, k, scen, q, b);
    if (n < 0) continue;
    if (n < lo)
      ++below;
    else if (n < hi)
      atomicAdd(kcnt + n, 1);
  }
  for (int o = 16; o > 0; o >>= 1) below += __shfl_down_sync(0xffffffffu, below, o);
  if (lane == 0) s_below[warp] = below;
  __syncthreads();
  // (2)
  if (threadIdx.x == 0) {
    int off = 0;
    for (int w = 0; w < nw; ++w) off += s_below[w];
    for (int n = lo; n < hi; ++n) {
      koff[n] = off;
      off += kcnt[n];
      kcnt[n] = 0;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    if (k.prio[q] >= pp || a.group_id[q] >= 0) continue;
    const int n = ksim_bound_node(a, k, scen, q, b);
    if (n < lo || n >= hi) continue;
    kvic[koff[n] + atomicAdd(kcnt + n, 1)] = q;
  }
  __syncthreads();
  // (3)
  bool state_free = true;
  if (a.interpod && ((a.AR > 0 && a.aff_req[p * a.AR] >= 0) ||
                     (a.AA > 0 && a.anti_req[p * a.AA] >= 0) || k.trace_has_anti))
    state_free = false;
  if (a.spread)
    for (int t = 0; t < a.SP; ++t)
      if (a.spread_g[p * a.SP + t] >= 0 && a.spread_dns[p * a.SP + t]) state_free = false;
  const float* used_s = a.used + scen * a.used_ss;
  const float* mc = a.match_count + scen * a.plane_ss;
  const float* aa = a.anti_active + scen * a.plane_ss;
  const float* pw = a.pref_wsum + scen * a.plane_ss;
  unsigned long long bk = ~0ull;
  int bn = 0x7fffffff;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    const int len = kcnt[n];
    if (len == 0) continue;
    int32_t* v = kvic + koff[n];
    for (int i = 1; i < len; ++i) {
      const int x = v[i], px = k.prio[x];
      int j = i - 1;
      while (j >= 0 && (k.prio[v[j]] > px || (k.prio[v[j]] == px && v[j] > x))) {
        v[j + 1] = v[j];
        --j;
      }
      v[j + 1] = x;
    }
    const KsimNodeEval e = ksim_eval_node<false>(a, p, scen, n, lab, used_s, mc, aa, pw, terms);
    const unsigned stat = (1u << KSIM_PLUGIN_TAINT) | (1u << KSIM_PLUGIN_NA);
    if ((e.pass & stat) != stat) continue;
    const int nv = ksim_victims_needed(a, p, scen, n, v, len, state_free, lab, used_s, mc, aa,
                                       terms);
    if (nv == 0) continue;
    const unsigned long long key =
        ((unsigned long long)nv << 32) | (unsigned)(k.prio[v[nv - 1]] ^ (int)0x80000000);
    ksim_lower_key(bk, bn, key, n);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ok = __shfl_down_sync(0xffffffffu, bk, o);
    const int on = __shfl_down_sync(0xffffffffu, bn, o);
    ksim_lower_key(bk, bn, ok, on);
  }
  if (lane == 0) {
    s_key[warp] = bk;
    s_node[warp] = bn;
  }
  __syncthreads();
  if (warp == 0) {
    bk = lane < nw ? s_key[lane] : ~0ull;
    bn = lane < nw ? s_node[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long ok = __shfl_down_sync(0xffffffffu, bk, o);
      const int on = __shfl_down_sync(0xffffffffu, bn, o);
      ksim_lower_key(bk, bn, ok, on);
    }
    bk = __shfl_sync(0xffffffffu, bk, 0);
    bn = __shfl_sync(0xffffffffu, bn, 0);
    if (C > 1 && threadIdx.x < C) {
      *cl.map_shared_rank(x_key + cl.block_rank(), threadIdx.x) = bk;
      *cl.map_shared_rank(x_node + cl.block_rank(), threadIdx.x) = bn;
    }
    if (C == 1 && threadIdx.x == 0) {
      s_best_key = bk;
      s_best_node = bn;
    }
  }
  if (C > 1) {
    cl.sync();
    bk = x_key[0];
    bn = x_node[0];
    for (int r = 1; r < C; ++r) ksim_lower_key(bk, bn, x_key[r], x_node[r]);
  } else {
    __syncthreads();
    bk = s_best_key;
    bn = s_best_node;
  }
  *nv_out = bk == ~0ull ? 0 : (int)(bk >> 32);
  return bk == ~0ull ? KSIM_PAD : bn;
}
