// K6 chunk_replay: the summary build of the kernel in chunk_replay.cuh (its
// description there) and K6's entry points. The attributed and retry modes'
// instantiations are compiled in chunk_replay_attributed.cu and
// chunk_replay_retry.cu, linked into the same library (ops/kernels.py builds
// the three sources into one), so this translation unit compiles the summary
// kernel alone, as before the modes.
#include "ksim.cuh"

// Phase stamps, for scripts/cluster_sweep.py --split alone: that script builds
// this file with -DKSIM_K6_STAMPS (and chunk_replay_attributed.cu, which
// carries no stamp) into a library of its own; the kernels' build defines
// nothing and carries no stamp. Thread 0 of block 0 (scenario
// 0's rank 0) records clock64() at K6_POINTS points of each of the launch's
// first K6_STAMP_SLOTS non-PAD slots — the slot's start, the prologue's end,
// phase 1's end, phase 2's K2 body's end, the bind's end, the cluster
// barrier's end — and (%globaltimer, clock64()) at the launch's start and end,
// which give the clock's rate.
#ifdef KSIM_K6_STAMPS
#define K6_STAMP_SLOTS 4096
#define K6_POINTS 6
__device__ long long ksim_k6_stamps[4 + K6_STAMP_SLOTS * K6_POINTS];
__device__ __forceinline__ long long ksim_globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K6_STAMP(i, j)                                                     \
  do {                                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (i) < K6_STAMP_SLOTS)       \
      ksim_k6_stamps[4 + (i) * K6_POINTS + (j)] = clock64();               \
  } while (0)
#define K6_STAMP_EDGE(j)                                                   \
  do {                                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                             \
      ksim_k6_stamps[2 * (j)] = ksim_globaltimer();                        \
      ksim_k6_stamps[2 * (j) + 1] = clock64();                             \
    }                                                                      \
  } while (0)
// Copy the first n stamps to the host buffer `out`.
KSIM_EXPORT int ksim_chunk_replay_stamps(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ksim_k6_stamps, n * sizeof(long long));
}
#endif

#include "chunk_replay.cuh"

KSIM_EXPORT int ksim_chunk_replay(const KsimArgs* args, const int32_t* idx, const uint8_t* gang,
                                  int32_t* choices, long long choice_ss, int W, int first,
                                  int end, int boundary, int append, int C, int threads,
                                  int span, int32_t* reasons, int32_t* attempts,
                                  uint8_t* attributed, int K, long long attr_ss,
                                  const KsimRetryPhase* retry, int retry_size, void* stream) {
  if (args->S < 1 || W < 1 || W > KSIM_MAX_WAVE || first < 0 || end < first)
    return (int)cudaErrorInvalidValue;
  if ((long long)end * W > choice_ss) return (int)cudaErrorInvalidValue;
  if (boundary >= 0 && !args->preempt) return (int)cudaErrorInvalidValue;
  if (append && !args->retry) return (int)cudaErrorInvalidValue;
  if (threads != K6_THREADS) return (int)cudaErrorInvalidValue;  // ops/kernels.py chunk_plan
  if (C < 1 || C > KSIM_MAX_CLUSTER || span < 1 || (long long)C * span < args->N ||
      (long long)(C - 1) * span >= args->N)
    return (int)cudaErrorInvalidValue;
  // the attributed mode: the plain path's counters (no tier preemption, whose
  // choice may be an eviction's node); with a retry boundary, the retry
  // pass's counters
  const bool attr = reasons != nullptr;
  if (attr && (!attempts || !attributed || K < 1 || K > KSIM_PLUGINS || attr_ss < 1 ||
               args->preempt))
    return (int)cudaErrorInvalidValue;
  // the retry mode: a boundary b > 0 of a run with the retry buffer (b = 0
  // too, where K10 evicted pre-bound pods), without tier preemption or node
  // shards; samples given whole or not at all
  if (retry) {
    if (retry_size != (int)sizeof(KsimRetryPhase) || !args->retry || !append ||
        args->preempt || args->NP != 1 || args->RB < 1 || args->RB > KSIM_MAX_RB ||
        args->B < 1 || retry->b < 0 || (end == first && !retry->kube))
      return (int)cudaErrorInvalidValue;
    // a chaos timeline: its counters whole, and the node tables K10 reads
    if (retry->evict_t && (!retry->resched || !retry->evict_lat || !retry->k.rrel ||
                           !retry->k.first_b))
      return (int)cudaErrorInvalidValue;
    // kube preemption: its tables whole; a launch with no waves is the
    // trailing boundary
    const KsimKube& k = retry->k;
    if (retry->kube &&
        (!k.prio || !k.col_of || !k.col_relb || !k.rrel || !k.first_b || !k.preempt || !k.kq ||
         !k.kst || !k.kvic || !k.koff || !k.kcnt || k.choices != choices ||
         k.choice_ss != choice_ss))
      return (int)cudaErrorInvalidValue;
    // the event log: under kube or a chaos timeline, whole
    if (retry->log.rec && (!retry->log.n || retry->log.cap < 1 ||
                           !(retry->kube || retry->evict_t)))
      return (int)cudaErrorInvalidValue;
    if (retry->used_out && (!retry->rcount_out || !retry->pend_out))
      return (int)cudaErrorInvalidValue;
    if (retry->snap_used && (!retry->snap_mc || !retry->snap_aa || !retry->snap_pw))
      return (int)cudaErrorInvalidValue;
  }
  if (end == first && !(retry && retry->kube)) return 0;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&idx,      (void*)&gang,   (void*)&choices,
                    (void*)&css, (void*)&W,        (void*)&first,  (void*)&end,
                    (void*)&boundary, (void*)&append, (void*)&span};
  if (retry)
    return ksim_chunk_replay_retry_launch(
        params, args->S * C, C, *args,
        KsimReject{reasons, attempts, attributed, K, (int64_t)attr_ss}, *retry,
        (cudaStream_t)stream);
  if (attr)
    return ksim_chunk_replay_attributed_launch(
        params, args->S * C, C, KsimReject{reasons, attempts, attributed, K, (int64_t)attr_ss},
        (cudaStream_t)stream);
  return ksim_launch_clusters((const void*)ksim_chunk_replay_kernel<false, false>, args->S * C,
                              K6_THREADS, C, params, (cudaStream_t)stream);
}

// Registers a thread, static shared bytes and largest block of each mode's
// kernel (cudaFuncGetAttributes; mode 0 the summary build's, 1 the
// attributed, 2 the retry), for the build's report.
KSIM_EXPORT int ksim_chunk_replay_attrs(int mode, int* regs, int* shared_bytes,
                                        int* max_threads) {
  cudaFuncAttributes at;
  const void* summary = (const void*)ksim_chunk_replay_kernel<false, false>;
  cudaError_t e = mode == 2   ? ksim_chunk_replay_retry_attrs(&at)
                  : mode == 1 ? ksim_chunk_replay_attributed_attrs(&at)
                              : cudaFuncGetAttributes(&at, summary);
  if (e != cudaSuccess) return (int)e;
  *regs = at.numRegs;
  *shared_bytes = (int)at.sharedSizeBytes;
  *max_threads = at.maxThreadsPerBlock;
  return 0;
}
