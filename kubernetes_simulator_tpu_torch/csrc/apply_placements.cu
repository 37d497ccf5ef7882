// K3 apply_placements: add sign × (state contribution) of K (pod, node)
// pairs to the carried state of each of S scenarios — used [S,N,R] and the
// match_count / anti_active / pref_wsum [S,G,D] planes — in pair order.
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
// applies the slot's eviction record (ksim_evict).
//
// Binds and rollbacks (ksim_apply_kernel, one block a scenario): every state
// cell belongs to one thread for the whole launch (thread 0 the anti/pref
// terms, whose group ids may repeat within a pod; the others a used column
// or a match_count row), and that thread applies the pairs in order. K6 runs
// the same body (ksim.cuh ksim_apply_body).
//
// Releases (ksim_release, two launches, any number of blocks a scenario):
// only the order within a node matters (ops/reference.py
// _add_in_pair_order, the twin's spec), so the scenario's live pairs — pod
// >= 0, node >= 0 and, pending, relb <= due_b — are grouped by node, then
// summed a node at a time:
//   sort    a block a tile of P pairs (a power of two, at most K3R_TILE;
//           ops/kernels.py release_tile): each live pair's key (node << 12
//           | its index in the tile) into shared memory, a bitonic sort of
//           the tile's keys — the keys are distinct, so the sort is stable
//           by node — then the sorted keys to keys[s, tile, ·] and each
//           node's [begin, end) among them to run[s, tile, n]; beside the
//           sort blocks, a thread a pair adds its count-plane terms to the
//           integer deltas dplane [S, 3, G, D] (integer atomics);
//   sums    a thread a (node, resource): the node's pairs, tile by tile
//           from run (an entry counts only where the key it begins at has
//           the node, so run needs no clearing), summed from zero in pair
//           order and subtracted once (models/state.py release_delta), its
//           tier cells moved pair by pair in the same order; beside them,
//           a thread a pair takes each count-plane cell's delta (atomicExch
//           to 0: one pair a cell) and subtracts it — one writer a cell,
//           no float atomics.
// The count planes hold integers (pod counts; pref_wsum's integer
// preferred-affinity weights, which ops/kernels.py pack_args checks), each
// below 2^24, so their release sums are exact in any order and equal the
// twin's ±1 / ±w steps bit for bit.
//
// Bound on an H100: bytes — per pair and scenario R·4 + G + a few words;
// launch-bound at K = 1 (bind). A release reads each pair's pod, node and
// requests, writes and reads its key, and reads run (S·tiles·N·2 u16).
#include "ksim.cuh"

#define K3_THREADS 256
#define K3R_TILE 4096       // pairs a sort block, at most (a key's low K3R_BITS)
#define K3R_BITS 12
#define K3R_THREADS 1024    // threads of a sort block, at most
#define K3R_SUMS 256        // threads of a sums block
#define K3R_DEAD 0xffffffffu  // the key of a dead pair: above every node's

// The body, with the eviction step, is ksim.cuh's ksim_apply_body (and
// ksim_evict), which K6 (chunk_replay.cu) runs too.
__global__ void __launch_bounds__(K3_THREADS)
    ksim_apply_kernel(KsimArgs a, const int32_t* pods_all, int64_t pod_ss, const int32_t* pos,
                      int32_t* choices, int K, int64_t choice_ss, float sign, int rollback,
                      int boundary, int append) {
  ksim_apply_body(a, blockIdx.x, pods_all, pod_ss, pos, 0, choices, K, choice_ss, sign,
                  rollback, boundary, append);
}

KSIM_EXPORT int ksim_apply_placements(const KsimArgs* args, const int32_t* pods,
                                      long long pod_ss, const int32_t* pos, int32_t* choices,
                                      int K, long long choice_ss, float sign, int rollback,
                                      int boundary, int append, void* stream) {
  if (K <= 0) return 0;
  if (args->S < 1 || (sign < 0.f && !rollback)) return (int)cudaErrorInvalidValue;
  if (rollback && (K > KSIM_MAX_WAVE || pod_ss)) return (int)cudaErrorInvalidValue;
  if (boundary >= 0 && (K != 1 || rollback)) return (int)cudaErrorInvalidValue;
  if ((append || pod_ss) && !args->retry) return (int)cudaErrorInvalidValue;
  ksim_apply_kernel<<<args->S, K3_THREADS, 0, (cudaStream_t)stream>>>(
      *args, pods, (int64_t)pod_ss, pos, choices, K, (int64_t)choice_ss, sign, rollback,
      boundary, append);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The release
// ---------------------------------------------------------------------------

// A release's pairs and its workspace (ops/kernels.py apply_placements).
struct KsimRelease {
  const int32_t* pods;  // [S, K] at pod_ss (0: [K] shared)
  int64_t pod_ss;
  const int32_t* pos;      // [K] choice-buffer columns
  const int32_t* choices;  // [S, choice_ss]
  int64_t choice_ss;
  const int32_t* relb;  // laid out like pods, or null (every pair due)
  int due_b, K, P, tiles;  // P pairs a tile (a power of two), tiles = ceil(K / P)
  uint32_t* keys;  // [S, tiles, P] each tile's keys, sorted
  uint16_t* run;   // [S, tiles, N, 2] a node's keys [begin, end) in a tile (where it has any)
  int32_t* dplane;  // [S, 3, G, D], zero between releases
};

// The node of scenario scen's pair k (its pod in p), or PAD for a dead pair.
__device__ __forceinline__ int ksim_release_node(const KsimRelease& r, int64_t scen, int k,
                                                 int& p) {
  p = r.pods[scen * r.pod_ss + k];
  if (p < 0) return KSIM_PAD;
  const int n = r.choices[scen * r.choice_ss + r.pos[k]];
  if (n < 0 || (r.relb && r.relb[scen * r.pod_ss + k] > r.due_b)) return KSIM_PAD;
  return n;
}

// Blocks [0, S·tiles): a block a (scenario, tile), the sort; the rest: a
// thread a (scenario, pair), the count planes' integer deltas.
__global__ void __launch_bounds__(K3R_THREADS) ksim_release_sort_kernel(KsimArgs a, KsimRelease r) {
  __shared__ uint32_t keys[K3R_TILE];
  const int sort_blocks = a.S * r.tiles;
  if ((int)blockIdx.x >= sort_blocks) {
    const int64_t i = (int64_t)(blockIdx.x - sort_blocks) * blockDim.x + threadIdx.x;
    if (i >= (int64_t)a.S * r.K) return;
    const int64_t scen = i / r.K;
    int p;
    const int n = ksim_release_node(r, scen, (int)(i % r.K), p);
    if (n < 0) return;
    int32_t* dp = r.dplane + scen * 3 * (int64_t)a.G * a.D;
    const int64_t GD = (int64_t)a.G * a.D;
    ksim_release_cells(a, ksim_label_rows(a, scen).gdom, p, n,
                       [&](int plane, int cell, int v) { atomicAdd(dp + plane * GD + cell, v); });
    return;
  }
  const int64_t scen = blockIdx.x / r.tiles;
  const int P = r.P, T = blockDim.x, k0 = (blockIdx.x % r.tiles) * P;
  for (int i = threadIdx.x; i < P; i += T) {
    int p, n = KSIM_PAD;
    if (k0 + i < r.K) n = ksim_release_node(r, scen, k0 + i, p);
    keys[i] = n < 0 ? K3R_DEAD : ((uint32_t)n << K3R_BITS) | (uint32_t)i;
  }
  __syncthreads();
  // Bitonic sort, ascending: the pairs (lo, lo + j) of each stage, lo's bit j clear.
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += T) {
        const int lo = 2 * i - (i & (j - 1)), hi = lo + j;
        const uint32_t x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
  uint32_t* out = r.keys + (int64_t)blockIdx.x * P;
  uint16_t* run = r.run + (int64_t)blockIdx.x * a.N * 2;
  for (int i = threadIdx.x; i < P; i += T) {
    const uint32_t key = keys[i], n = key >> K3R_BITS;
    out[i] = key;
    if (key == K3R_DEAD) continue;
    if (i == 0 || keys[i - 1] >> K3R_BITS != n) run[2 * n] = (uint16_t)i;
    if (i == P - 1 || keys[i + 1] >> K3R_BITS != n) run[2 * n + 1] = (uint16_t)(i + 1);
  }
}

// f(k) for each pair k of scenario scen at node n, in pair order (tile by
// tile, each tile's keys sorted); false when the node has none. A run entry
// counts only where the key it begins at has the node: the sort wrote both
// halves of every such entry, so the workspace needs no clearing.
template <class F>
__device__ __forceinline__ bool ksim_release_walk(const KsimRelease& r, int N, int64_t scen,
                                                  int n, F f) {
  bool any = false;
  for (int t = 0; t < r.tiles; ++t) {
    const int64_t tile = scen * r.tiles + t;
    const uint32_t* kt = r.keys + tile * r.P;
    const uint32_t be = ((const uint32_t*)r.run)[tile * N + n];
    const int b = (int)(be & 0xffffu), e = (int)(be >> 16);
    if (b >= e || e > r.P || kt[b] >> K3R_BITS != (uint32_t)n) continue;
    any = true;
#pragma unroll 4
    for (int j = b; j < e; ++j) f(t * r.P + (int)(kt[j] & ((1u << K3R_BITS) - 1)));
  }
  return any;
}

// Blocks [0, sum_blocks): a thread a (scenario, node, resource), the sums;
// the rest: a thread a (scenario, pair), the count planes.
__global__ void __launch_bounds__(K3R_SUMS)
    ksim_release_sums_kernel(KsimArgs a, KsimRelease r, int sum_blocks) {
  const int N = a.N, R = a.R;
  if ((int)blockIdx.x >= sum_blocks) {
    const int64_t i = (int64_t)(blockIdx.x - sum_blocks) * K3R_SUMS + threadIdx.x;
    if (i >= (int64_t)a.S * r.K) return;
    const int64_t scen = i / r.K;
    int p;
    const int n = ksim_release_node(r, scen, (int)(i % r.K), p);
    if (n < 0) return;
    // One pair takes each count-plane cell's delta and subtracts it.
    int32_t* dp = r.dplane + scen * 3 * (int64_t)a.G * a.D;
    const int64_t GD = (int64_t)a.G * a.D;
    float* planes[3] = {a.match_count + scen * a.plane_ss, a.anti_active + scen * a.plane_ss,
                        a.pref_wsum + scen * a.plane_ss};
    ksim_release_cells(a, ksim_label_rows(a, scen).gdom, p, n, [&](int plane, int cell, int) {
      const int v = atomicExch(dp + plane * GD + cell, 0);
      if (v) planes[plane][cell] = planes[plane][cell] - (float)v;
    });
    return;
  }
  const int64_t i = (int64_t)blockIdx.x * K3R_SUMS + threadIdx.x;
  if (i >= (int64_t)a.S * N * R) return;
  const int c = (int)(i % R);
  const int n = (int)((i / R) % N);
  const int64_t scen = i / ((int64_t)R * N);
  const int32_t* pods = r.pods + scen * r.pod_ss;
  float acc = 0.f;
  if (!ksim_release_walk(r, N, scen, n,
                         [&](int k) { acc = acc + a.requests[(size_t)pods[k] * R + c]; }))
    return;
  float* u = a.used + scen * a.used_ss + (size_t)n * R + c;
  *u = *u - acc;
  if (!a.preempt) return;
  float* ut = a.used_tier + scen * (int64_t)a.Tt * N * R;
  float* nt = a.npods_tier + scen * (int64_t)a.Tt * N;
  ksim_release_walk(r, N, scen, n, [&](int k) {
    const int p = pods[k];
    if (a.group_id[p] >= 0) return;
    const size_t cell = (size_t)a.pod_tier[p] * N + n;
    ut[cell * R + c] += -a.requests[(size_t)p * R + c];
    if (c == 0) nt[cell] += -1.f;
  });
}

KSIM_EXPORT int ksim_release(const KsimArgs* args, const int32_t* pods, long long pod_ss,
                             const int32_t* pos, const int32_t* choices, int K,
                             long long choice_ss, const int32_t* due_relb, int due_b, int P,
                             uint32_t* keys, uint16_t* run, int32_t* dplane, void* stream) {
  if (K <= 0) return 0;
  if (args->S < 1 || args->N < 1 || args->R < 1 || args->N >= (1 << (32 - K3R_BITS)) - 1)
    return (int)cudaErrorInvalidValue;
  // P: a power of two, at most K3R_TILE, no more than twice K (ops/kernels.py release_tile)
  if (P < 2 || P > K3R_TILE || (P & (P - 1)) || (P >= 2 * K && P > 2))
    return (int)cudaErrorInvalidValue;
  if ((due_relb || pod_ss) && !args->retry) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  KsimRelease r;
  r.pods = pods;
  r.pod_ss = (int64_t)pod_ss;
  r.pos = pos;
  r.choices = choices;
  r.choice_ss = (int64_t)choice_ss;
  r.relb = due_relb;
  r.due_b = due_b;
  r.K = K;
  r.P = P;
  r.tiles = (K + P - 1) / P;
  r.keys = keys;
  r.run = run;
  r.dplane = dplane;
  const int64_t pairs = (int64_t)args->S * K;
  const int threads = P / 2 > K3R_THREADS ? K3R_THREADS : P / 2 < 32 ? 32 : P / 2;
  const int sort_blocks = args->S * r.tiles;
  const int count_blocks = (int)((pairs + threads - 1) / threads);
  ksim_release_sort_kernel<<<sort_blocks + count_blocks, threads, 0, st>>>(*args, r);
  const int64_t cells = (int64_t)args->S * args->N * args->R;
  const int sum_blocks = (int)((cells + K3R_SUMS - 1) / K3R_SUMS);
  const int pair_blocks = (int)((pairs + K3R_SUMS - 1) / K3R_SUMS);
  ksim_release_sums_kernel<<<sum_blocks + pair_blocks, K3R_SUMS, 0, st>>>(*args, r, sum_blocks);
  return (int)cudaGetLastError();
}
