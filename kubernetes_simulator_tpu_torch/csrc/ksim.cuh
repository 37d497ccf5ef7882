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
