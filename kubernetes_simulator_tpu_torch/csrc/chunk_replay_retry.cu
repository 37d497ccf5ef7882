// K6's retry mode (chunk_replay.cuh, RETRY = true; the retry buffer on the
// chunk route): its instantiation and its boundary sequence in a translation
// unit of its own, linked into chunk_replay.cu's library, whose entry
// ksim_chunk_replay checks the arguments and calls this launch when it is
// given a boundary.
#define KSIM_SECOND_TU  // chunk_replay.cu exports ksim_args_size
#include "chunk_replay.cuh"

// The launch's boundary and a copy of its KsimArgs (the kernel's parameter,
// byte for byte), which the boundary sequence reads: compiled out of line, it
// takes no reference to the kernel's parameter, which would make the kernel
// copy the whole block to local memory and read it there, waves included.
static __constant__ KsimRetryPhase ksim_k6_retry;
static __constant__ KsimArgs ksim_k6_args;

// Pod p's first-reject counts in scenario scen's cluster at the pass's
// planes (K5's count body over each rank's nodes [lo, hi), the ranks' counts
// folded into rank 0), written by rank 0's thread 0 to `tot` (the kube pass's
// shared slots, KSIM_PLUGINS + 1). Out of line, so the kube pass keeps its
// own register allocation without the count body's, and the counts wait for
// the PostFilter in shared memory, not in registers; every thread of the
// cluster calls it (the fold's barrier).
__device__ __noinline__ void ksim_k6_kube_counts(int64_t scen, int C, int p, int lo, int hi,
                                                 KsimTerms* terms, int* tot) {
  const KsimArgs& a = ksim_k6_args;
  int t[KSIM_PLUGINS + 1];  // thread 0's
  ksim_reject_count_body(a, p, scen, lo, hi, ksim_label_rows(a, scen),
                         a.used + scen * a.used_ss, a.match_count + scen * a.plane_ss,
                         a.anti_active + scen * a.plane_ss, a.pref_wsum + scen * a.plane_ss,
                         terms, t);
  if (C > 1) ksim_cluster_fold_counts(t);
  if (threadIdx.x == 0)
    for (int k = 0; k <= KSIM_PLUGINS; ++k) tot[k] = t[k];
}

// The kube pass, (ii)-(iii) under kube preemption (chunk_replay.cuh's
// header), in scenario scen's cluster; rank `lead` owns the nodes [lo, hi).
// Rank 0 alone writes the pass's state (the ring, kst, the buffer, the
// pending list, the victims' and the pods' records, the counters, the episode
// marks and the event log); every rank reads the ring's count and head pod
// after a cluster barrier, so the loop's trip, the PostFilter's PAD and the
// count body's are uniform over the cluster. Out of line, as the boundary is.
__device__ __noinline__ void ksim_k6_kube_pass(int64_t scen, int C, bool lead, int lo, int hi,
                                               KsimTerms* terms) {
  __shared__ int32_t s_pod;  // the bound pod, for K3's body
  __shared__ int s_tot[KSIM_PLUGINS + 1];  // rank 0's: the counts before the PostFilter
  const KsimArgs& a = ksim_k6_args;
  const KsimRetryPhase& ph = ksim_k6_retry;
  const KsimReject& rj = ksim_k6_reject;
  const KsimKube& k = ph.k;
  const KsimLabels lab = ksim_label_rows(a, scen);
  const float* match_count = a.match_count + scen * a.plane_ss;
  const int RB = a.RB, R = a.R, b = ph.b;
  const int64_t P = a.P;
  int32_t* rbuf = a.rbuf + scen * RB;
  int32_t* rch = a.rchoice + scen * RB;
  int32_t* kq = k.kq + scen * RB;
  int32_t* kst = k.kst + scen * 4;  // ring head, unwalked count, kept count, pending length
  int32_t* pid = a.pend_id + scen * RB;
  int32_t* pnode = a.pend_node + scen * RB;
  int32_t* prelb = a.pend_relb + scen * RB;
  if (lead) {
    if (threadIdx.x == 0) {
      int m = 0;  // the pending list without its due entries (released before the pass)
      for (int j = 0; j < RB; ++j) {
        if (pid[j] < 0 || prelb[j] <= b) continue;
        pid[m] = pid[j];
        pnode[m] = pnode[j];
        prelb[m] = prelb[j];
        ++m;
      }
      for (int j = m; j < RB; ++j) pid[j] = pnode[j] = prelb[j] = KSIM_PAD;
      const int n = a.rcount[scen];
      for (int j = 0; j < n; ++j) kq[j] = rbuf[j];
      kst[0] = 0;
      kst[1] = n;
      kst[2] = 0;
      kst[3] = m;
    }
    for (int j = threadIdx.x; j < RB; j += blockDim.x) rch[j] = KSIM_PAD;
  }
  ksim_cluster_barrier(C);
  for (;;) {
    if (kst[1] == 0) break;  // uniform: rank 0 wrote it before the barrier
    const int h = kst[0];
    const int p = kq[h];
    ksim_filter_prologue(a, p, match_count, lab, terms);
    __syncthreads();
    for (int m = lo + threadIdx.x; m < hi; m += blockDim.x)
      ksim_filter_score_node(a, p, scen, m, terms);
    __syncthreads();
    int node = ksim_normalize_select_body(a, p, scen, rch, -1, lo, hi);
    int nv = 0;
    const bool failed = node == KSIM_PAD;  // uniform over the cluster
    if (failed && rj.reasons) ksim_k6_kube_counts(scen, C, p, lo, hi, terms, s_tot);
    if (failed) node = ksim_post_filter(a, k, p, scen, b, lo, hi, lab, terms, &nv);
    if (lead) {
      __syncthreads();
      if (threadIdx.x == 0) {
        int head = h + 1 == RB ? 0 : h + 1, cnt = kst[1] - 1, kept = kst[2], plen = kst[3];
        if (node < 0) {
          rbuf[kept++] = p;
          if (rj.reasons)  // no node even with victims: the pod is charged
            ksim_reject_charge(a, s_tot, scen, p, rj.reasons, rj.attempts, rj.attributed, rj.K,
                               rj.attr_ss);
        } else {
          const int32_t* vic = k.kvic + scen * P + k.koff[scen * a.N + node];
          float* used = a.used + scen * a.used_ss + (size_t)node * R;
          float* planes[3] = {a.match_count + scen * a.plane_ss,
                              a.anti_active + scen * a.plane_ss, a.pref_wsum + scen * a.plane_ss};
          for (int i = 0; i < nv; ++i) {
            const int v = vic[i];
            if (rj.attributed) rj.attributed[scen * rj.attr_ss + v] = 0;
            ksim_log_append(ph.log, scen, KSIM_LOG_PREEMPT, b, v, node);
            for (int r = 0; r < R; ++r) used[r] = used[r] - a.requests[(size_t)v * R + r];
            ksim_release_cells(a, lab.gdom, v, node, [&](int plane, int cell, int t) {
              planes[plane][cell] = planes[plane][cell] - (float)t;
            });
            int m = 0;  // its pending entry cancelled
            for (int j = 0; j < plen; ++j) {
              if (pid[j] == v) continue;
              pid[m] = pid[j];
              pnode[m] = pnode[j];
              prelb[m] = prelb[j];
              ++m;
            }
            for (int j = m; j < plen; ++j) pid[j] = pnode[j] = prelb[j] = KSIM_PAD;
            plen = m;
            const int64_t iv = scen * P + v;
            if (a.rnode[iv] >= 0) {
              a.rnode[iv] = KSIM_PAD;
              k.rrel[iv] = KSIM_NEVER;
            } else {
              k.choices[scen * k.choice_ss + k.col_of[v]] = KSIM_PAD;
            }
            if (k.first_b[iv] == KSIM_PAD) k.first_b[iv] = KSIM_FIRST_IN_WAVE;
            k.preempt[scen] += 1;
            if (cnt + kept < RB) {
              const int tail = head + cnt;
              kq[tail >= RB ? tail - RB : tail] = v;
              ++cnt;
            } else {
              a.rdrop[scen] += 1;
            }
          }
          rch[0] = node;
        }
        kst[0] = head;
        kst[1] = cnt;
        kst[2] = kept;
        kst[3] = plen;
        s_pod = p;  // a pushed victim may take the pod's ring slot
      }
      __syncthreads();
      if (node >= 0) {
        ksim_apply_body(a, scen, &s_pod, 0, nullptr, 0, a.rchoice, 1, RB, 1.f, 0, -1, 0);
        __syncthreads();
        if (threadIdx.x == 0) {
          const int64_t ip = scen * P + p;
          if (rj.attributed) rj.attributed[scen * rj.attr_ss + p] = 0;
          ksim_log_append(ph.log, scen, KSIM_LOG_BIND, b, p, node);
          a.rnode[ip] = node;
          a.rbind_b[ip] = b;
          if (k.first_b[ip] == KSIM_PAD) k.first_b[ip] = b;
          // its pending release: f32 boundary search, >= b + 1
          const float t = ph.t_b + a.dur[p];
          int lo2 = 0, hi2 = a.B;
          while (lo2 < hi2) {
            const int mid = (lo2 + hi2) >> 1;
            if (a.tbt[mid] < t)
              lo2 = mid + 1;
            else
              hi2 = mid;
          }
          int plen = kst[3], rrel = KSIM_NEVER;
          if (lo2 < a.B && plen < RB) {
            rrel = lo2 > b + 1 ? lo2 : b + 1;
            pid[plen] = p;
            pnode[plen] = node;
            prelb[plen] = rrel;
            kst[3] = plen + 1;
          }
          k.rrel[ip] = rrel;
          if (ph.evict_t)
            ksim_chaos_rebind(KsimRebind{k.rrel, k.first_b, ph.evict_t, ph.resched,
                                         ph.evict_lat, ph.t_bd},
                              scen, ip);
          rch[0] = KSIM_PAD;
        }
      }
    }
    ksim_cluster_barrier(C);
  }
  if (lead) {
    const int kept = kst[2];
    for (int j = kept + threadIdx.x; j < RB; j += blockDim.x) rbuf[j] = KSIM_PAD;
    if (threadIdx.x == 0) a.rcount[scen] = kept;
  }
  ksim_cluster_barrier(C);
}

// The boundary sequence (i)-(iii) and the samples of scenario scen's
// cluster (chunk_replay.cuh's header), before the chunk's first wave; rank
// `lead` owns the nodes [lo, hi), `terms` is the kernel's term table. Not
// inlined: compiled into the kernel, its registers (K4's per-thread runs,
// the pending release) made the whole launch spill more, the waves' slots
// included (a retry launch's waves ran ≈45 % slower a slot than the summary
// build's); called once a launch, it keeps an allocation of its own.
__device__ __noinline__ void ksim_k6_boundary(int64_t scen, int C, bool lead, int lo, int hi,
                                              KsimTerms* terms) {
  const KsimArgs& a = ksim_k6_args;
  const KsimRetryPhase& ph = ksim_k6_retry;
  const KsimReject& rj = ksim_k6_reject;
  const KsimLabels lab = ksim_label_rows(a, scen);
  const float* match_count = a.match_count + scen * a.plane_ss;
  const int RB = a.RB;
  if (ph.pending) {  // (i)
    if (lead) ksim_pending_release(a, scen, ph.b);
    ksim_cluster_barrier(C);
  }
  if (ph.kube) {  // (ii)-(iii) under kube preemption
    ksim_k6_kube_pass(scen, C, lead, lo, hi, terms);
  } else {
    const int n = a.rcount[scen];  // (ii): uniform over the cluster
    const int32_t* rbuf = a.rbuf + scen * RB;
    int32_t* rch = a.rchoice + scen * RB;
    for (int k = 0; k < n; ++k) {
      const int p = rbuf[k];  // >= 0: the buffer is dense from 0
      ksim_filter_prologue(a, p, match_count, lab, terms);
      __syncthreads();
      for (int m = lo + threadIdx.x; m < hi; m += blockDim.x)
        ksim_filter_score_node(a, p, scen, m, terms);
      __syncthreads();
      const int got = ksim_normalize_select_body(a, p, scen, rch + k, -1, lo, hi);
      if (rj.reasons && got == KSIM_PAD) {  // uniform over the cluster
        int tot[KSIM_PLUGINS + 1];  // thread 0's
        ksim_reject_count_body(a, p, scen, lo, hi, lab, a.used + scen * a.used_ss,
                               match_count, a.anti_active + scen * a.plane_ss,
                               a.pref_wsum + scen * a.plane_ss, terms, tot);
        if (C > 1) ksim_cluster_fold_counts(tot);
        if (lead && threadIdx.x == 0)
          ksim_reject_charge(a, tot, scen, p, rj.reasons, rj.attempts, rj.attributed, rj.K,
                             rj.attr_ss);
      }
      if (lead) {
        __syncthreads();
        ksim_apply_body(a, scen, a.rbuf + k, RB, nullptr, k, a.rchoice, 1, RB, 1.f, 0, -1, 0);
        if (threadIdx.x == 0 && rch[k] >= 0)  // a chaos timeline's bind record
          ksim_log_append(ph.log, scen, KSIM_LOG_BIND, ph.b, p, rch[k]);
      }
      ksim_cluster_barrier(C);
    }
    if (lead) {  // (iii)
      for (int k = n + threadIdx.x; k < RB; k += blockDim.x) rch[k] = KSIM_PAD;
      __syncthreads();
      const KsimRebind rb{ph.k.rrel, ph.k.first_b, ph.evict_t, ph.resched, ph.evict_lat,
                          ph.t_bd};
      ksim_retry_bookkeeping(a, scen, ph.b, ph.t_b, rb.rrel ? &rb : nullptr);
    }
    ksim_cluster_barrier(C);
  }
  if (!ph.used_out && !ph.snap_used) return;
  // The samples: each rank its nodes' used rows, rank 0 the rest.
  const int R = a.R;
  const float* used = a.used + scen * a.used_ss;
  const int64_t NR = (int64_t)a.N * R;
  for (int i = lo * R + threadIdx.x; i < hi * R; i += blockDim.x) {
    if (ph.used_out) ph.used_out[scen * NR + i] = used[i];
    if (ph.snap_used) ph.snap_used[scen * NR + i] = used[i];
  }
  if (lead) {
    if (ph.used_out) {
      if (threadIdx.x == 0) ph.rcount_out[scen] = a.rcount[scen];
      for (int k = threadIdx.x; k < RB; k += blockDim.x)
        ph.pend_out[scen * RB + k] = a.pend_id[scen * RB + k];
    }
    if (ph.snap_used) {
      const int64_t GD = (int64_t)a.G * a.D;
      for (int64_t i = threadIdx.x; i < GD; i += blockDim.x) {
        ph.snap_mc[scen * GD + i] = a.match_count[scen * a.plane_ss + i];
        ph.snap_aa[scen * GD + i] = a.anti_active[scen * a.plane_ss + i];
        ph.snap_pw[scen * GD + i] = a.pref_wsum[scen * a.plane_ss + i];
      }
    }
  }
  ksim_cluster_barrier(C);
}


// Write the pass's counters (reasons null: no charge), the boundary and the
// arguments into constant memory on `stream`, then launch the retry kernel
// with the summary build's parameters `params`.
int ksim_chunk_replay_retry_launch(void** params, int grid, int C, const KsimArgs& args,
                                   const KsimReject& rj, const KsimRetryPhase& ph,
                                   cudaStream_t stream) {
  cudaError_t e = cudaMemcpyToSymbolAsync(ksim_k6_reject, &rj, sizeof rj, 0,
                                          cudaMemcpyHostToDevice, stream);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(ksim_k6_retry, &ph, sizeof ph, 0, cudaMemcpyHostToDevice,
                                stream);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(ksim_k6_args, &args, sizeof args, 0, cudaMemcpyHostToDevice,
                                stream);
  if (e != cudaSuccess) return (int)e;
  return ksim_launch_clusters((const void*)ksim_chunk_replay_kernel<false, true>, grid,
                              K6_THREADS, C, params, stream);
}

cudaError_t ksim_chunk_replay_retry_attrs(cudaFuncAttributes* at) {
  return cudaFuncGetAttributes(at, (const void*)ksim_chunk_replay_kernel<false, true>);
}
