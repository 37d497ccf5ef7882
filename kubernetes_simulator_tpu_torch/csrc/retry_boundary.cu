// K4 retry_boundary: the bookkeeping of one chunk boundary's retry pass in
// each of S scenarios, one block of 1024 threads per scenario.
//
// Replaces: kubernetes_simulator_tpu/sim/whatif.py:1456-1497, the pend
// append and the buffer compaction of per_scenario_retry (the retry
// variant of _build_chunk_fn :1285), whose semantics are the host pass of
// sim/boundary.py:547-678 (boundary_retry) and sim/greedy.py:110
// greedy_replay(retry_buffer=...).
//
// Runs after the pass: K3 released the pending list's due entries and
// K1 -> K2 -> K3 ran every buffer slot, K2 writing its choice to
// rchoice[s, k]. Then, in scenario s (boundary b, start time t_b as f32):
//   1. each buffered pod the pass placed records its node in rnode[s, pod]
//      and b in rbind_b[s, pod];
//   2. the pending list drops its due entries (relb <= b) and appends, in
//      buffer order, each placed pod whose release boundary exists:
//      rbn = #{i : tbt[i] < t_b + dur[pod]} (np.searchsorted side="left"
//      over the f32 finite boundary times, the f32 sum as the reference
//      forms it); if rbn < B the entry (pod, node, max(rbn, b + 1)) goes
//      on the list. The first RB entries are kept (a release that does not
//      fit is lost: the pod keeps its node to the end, whatif.py:1481);
//   3. the buffer keeps its unplaced pods in FIFO order and rcount[s]
//      becomes their number.
// Entries past a list's end become -1 in every field.
//
// Each thread owns a contiguous run of at most KSIM_MAX_RB / 1024 buffer
// slots and pending entries; it reads all of them before the block
// writes (the compactions are in place), and block-wide exclusive scans of
// the per-thread counts give every kept entry its position: stable,
// integer-only, no atomics.
//
// Bound on an H100: bytes — per scenario the buffer, its choices and the
// pending list (RB * 20 B read, RB * 16 B written), the durations and
// tbt entries the searches touch and 8 B per retried bind; launch-bound.
#include "ksim.cuh"

#define K4_THREADS 1024
#define K4_ITEMS (KSIM_MAX_RB / K4_THREADS)

// Exclusive block-wide prefix sum of one int per thread; *total gets the
// block's sum. Every thread of the block must call it.
__device__ int k4_exclusive_scan(int v, int* total) {
  __shared__ int warp_sum[K4_THREADS / 32];
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

__global__ void __launch_bounds__(K4_THREADS) ksim_retry_boundary_kernel(KsimArgs a, int b,
                                                                          float t_b) {
  const int RB = a.RB, B = a.B;
  const int64_t scen = blockIdx.x;
  int32_t* rbuf = a.rbuf + scen * RB;
  const int32_t* rch = a.rchoice + scen * RB;
  int32_t* pend_id = a.pend_id + scen * RB;
  int32_t* pend_node = a.pend_node + scen * RB;
  int32_t* pend_relb = a.pend_relb + scen * RB;
  int32_t* rnode = a.rnode + scen * (int64_t)a.P;
  int32_t* rbind_b = a.rbind_b + scen * (int64_t)a.P;
  const int per = (RB + blockDim.x - 1) / blockDim.x;  // <= K4_ITEMS
  const int k0 = threadIdx.x * per;

  // Read this thread's buffer slots and pending entries.
  int pod[K4_ITEMS], node[K4_ITEMS], relb_new[K4_ITEMS];
  int old_id[K4_ITEMS], old_node[K4_ITEMS], old_relb[K4_ITEMS];
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
  int j = k4_exclusive_scan(n_old, &total_old);
  const int off_add = k4_exclusive_scan(n_add, &total_add);
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
  j = k4_exclusive_scan(n_keep, &total_keep);
  for (int i = 0; i < per; ++i)
    if (pod[i] >= 0 && node[i] < 0) rbuf[j++] = pod[i];
  for (int k = total_keep + threadIdx.x; k < RB; k += blockDim.x) rbuf[k] = KSIM_PAD;
  if (threadIdx.x == 0) a.rcount[scen] = total_keep;
}

KSIM_EXPORT int ksim_retry_boundary(const KsimArgs* args, int b, float t_b, void* stream) {
  if (args->S < 1 || !args->retry || args->RB < 1 || args->RB > KSIM_MAX_RB || args->B < 1)
    return (int)cudaErrorInvalidValue;
  ksim_retry_boundary_kernel<<<args->S, K4_THREADS, 0, (cudaStream_t)stream>>>(*args, b, t_b);
  return (int)cudaGetLastError();
}
