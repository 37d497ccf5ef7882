// K10 evict_node: the NoExecute eviction of a chaos node_down at one chunk
// boundary, one block of 1,024 threads a scenario that has a node_down due
// there, before the boundary's releases and retry pass.
//
// Replaces: kubernetes_simulator_tpu/sim/boundary.py:430-475 evict_node (the
// host mirror's eviction, which the JAX package runs at a boundary where a
// node_down falls due: sim/jax_runtime.py:1755-1793 in the single replay,
// sim/whatif.py:3266-3330 per scenario in the what-if batch).
//
// For each down node of the scenario, in timeline order:
//   1. the victims, in ascending pod index: the pods whose node before this
//      boundary's releases is that node — ksim_bound_node at b - 1 (its
//      retried node while rrel >= b, else its choice-buffer column's node
//      while the column's static release boundary col_relb >= b): a release
//      that falls due at b has not fired, so such a pod is evicted, not
//      released. The pod axis is walked in tiles of the block's width; a
//      block-wide exclusive scan of the per-thread hits gives each victim its
//      place in the tile's list (no atomics, the order is the pod order);
//   2. thread 0 walks the tile's victims in order, as the reference's loop
//      does: the node's used row minus the victim's requests and its
//      count-plane cells rewound (models/state.py unbind, as K6's kube pass
//      rewinds its victims), its pending entry cancelled (the list stays
//      dense), its retried node (and rrel) or its choice-buffer column
//      cleared — so neither K3's static release nor the pending release
//      fires for it, and its assignment reads PAD — its first_b marked when
//      it was first bound in its wave (the summary latency counts first binds
//      only), its eviction time t_bd stored as a double, the scenario's
//      eviction counted, and a non-gang victim appended to the retry buffer
//      at rcount while rcount < RB, else counted in rdrop (a gang victim
//      stays displaced: Permit is in-wave); at telemetry series its episode
//      mark cleared (sim/telemetry.py clear_episode: an eviction starts a
//      new unschedulable episode), and at timeline its evict record appended
//      to the scenario's event log (ksim.cuh KsimLog), in victim order —
//      both optional, so a run without telemetry does the same work as
//      without them.
// Walking a victim writes only its own records, the pending list and the
// buffer, so the next tile's test (which reads each pod's own records) sees
// the pods not yet walked as they were. No float atomics: every state cell
// has one writer, in the reference's order.
//
// Bound on an H100: bytes — the pod axis's records read once a down node
// (rnode, rrel, col_of and the column's choice and release boundary: 20 B a
// pod) and, per victim, its requests and count cells, the pending list and
// the buffer slot it writes; the walk is one thread's, so the launch is
// latency-bound.
#include "ksim.cuh"

#define K10_THREADS 1024

// One launch's work (ops/kernels.py KsimEvict): scenario scen[i] (i < the
// grid) takes its down nodes nodes[off[i] .. off[i + 1]); the node tables
// (ksim.cuh KsimKube's col_of, col_relb, rrel, first_b; the choice buffer
// [S, choice_ss]); the chaos records evict_t [S,P] f64 (negative: none) and
// evictions [S]; the boundary b and its f64 start time t_bd; the episode
// marks attributed [S, attr_ss] u8 of series telemetry (null: none) and the
// event log of a timeline (log.rec null: none).
struct KsimEvict {
  const int32_t* scen;
  const int32_t* off;
  const int32_t* nodes;
  const int32_t* col_of;
  const int32_t* col_relb;
  int32_t* rrel;
  int32_t* first_b;
  int32_t* choices;
  int64_t choice_ss;
  double* evict_t;
  int32_t* evictions;
  double t_bd;
  int32_t b;
  int32_t pad0;
  uint8_t* attributed;
  int64_t attr_ss;
  KsimLog log;
};

__global__ void __launch_bounds__(K10_THREADS, 1)
    ksim_evict_node_kernel(KsimArgs a, KsimEvict e) {
  __shared__ int32_t vic[K10_THREADS];
  const int64_t scen = e.scen[blockIdx.x];
  KsimKube k = {};
  k.col_of = e.col_of;
  k.col_relb = e.col_relb;
  k.rrel = e.rrel;
  k.first_b = e.first_b;
  k.choices = e.choices;
  k.choice_ss = e.choice_ss;
  const int P = a.P, RB = a.RB, R = a.R;
  const int32_t* gdom = ksim_label_rows(a, scen).gdom;
  float* used = a.used + scen * a.used_ss;
  float* planes[3] = {a.match_count + scen * a.plane_ss, a.anti_active + scen * a.plane_ss,
                      a.pref_wsum + scen * a.plane_ss};
  int32_t* pid = a.pend_id + scen * RB;
  int32_t* pnode = a.pend_node + scen * RB;
  int32_t* prelb = a.pend_relb + scen * RB;
  int32_t* rbuf = a.rbuf + scen * RB;
  for (int j = e.off[blockIdx.x]; j < e.off[blockIdx.x + 1]; ++j) {
    const int node = e.nodes[j];
    for (int base = 0; base < P; base += blockDim.x) {
      const int q = base + threadIdx.x;
      const int hit = q < P && ksim_bound_node(a, k, scen, q, e.b - 1) == node;
      int total;
      const int at = ksim_block_exclusive_scan(hit, &total);
      if (hit) vic[at] = q;
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int i = 0; i < total; ++i) {
          const int v = vic[i];
          if (e.attributed) e.attributed[scen * e.attr_ss + v] = 0;
          ksim_log_append(e.log, scen, KSIM_LOG_EVICT, e.b, v, node);
          for (int r = 0; r < R; ++r)
            used[(size_t)node * R + r] = used[(size_t)node * R + r] - a.requests[(size_t)v * R + r];
          ksim_release_cells(a, gdom, v, node, [&](int plane, int cell, int t) {
            planes[plane][cell] = planes[plane][cell] - (float)t;
          });
          int len = 0;  // the pending list is dense from 0
          while (len < RB && pid[len] >= 0) ++len;
          int m = 0;
          for (int x = 0; x < len; ++x) {
            if (pid[x] == v) continue;
            pid[m] = pid[x];
            pnode[m] = pnode[x];
            prelb[m] = prelb[x];
            ++m;
          }
          for (int x = m; x < len; ++x) pid[x] = pnode[x] = prelb[x] = KSIM_PAD;
          const int64_t iv = scen * P + v;
          if (a.rnode[iv] >= 0) {
            a.rnode[iv] = KSIM_PAD;
            e.rrel[iv] = KSIM_NEVER;
          } else {
            e.choices[scen * e.choice_ss + e.col_of[v]] = KSIM_PAD;
          }
          if (e.first_b[iv] == KSIM_PAD) e.first_b[iv] = KSIM_FIRST_IN_WAVE;
          e.evict_t[iv] = e.t_bd;
          e.evictions[scen] += 1;
          if (a.group_id[v] < 0) {
            const int c = a.rcount[scen];
            if (c < RB) {
              rbuf[c] = v;
              a.rcount[scen] = c + 1;
            } else {
              a.rdrop[scen] += 1;
            }
          }
        }
      }
      __syncthreads();  // the walk's writes before the next tile's tests
    }
  }
}

// Launch K10 over the m scenarios of `ev` (the grid), each with the retry
// buffer's tables of `args`, on `stream`.
KSIM_EXPORT int ksim_evict_node(const KsimArgs* args, const KsimEvict* ev, int ev_size, int m,
                                void* stream) {
  if (ev_size != (int)sizeof(KsimEvict) || m < 1 || m > args->S || !args->retry ||
      args->RB < 1 || args->RB > KSIM_MAX_RB || args->P < 1 || args->NP != 1 ||
      args->preempt || !ev->scen || !ev->off || !ev->nodes || !ev->col_of || !ev->col_relb ||
      !ev->rrel || !ev->first_b || !ev->choices || ev->choice_ss < 1 || !ev->evict_t ||
      !ev->evictions || ev->b < 0 || (ev->attributed && ev->attr_ss < args->P) ||
      (ev->log.rec && (!ev->log.n || ev->log.cap < 1)))
    return (int)cudaErrorInvalidValue;
  ksim_evict_node_kernel<<<m, K10_THREADS, 0, (cudaStream_t)stream>>>(*args, *ev);
  return (int)cudaGetLastError();
}
