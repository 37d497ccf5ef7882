// K7 shard_select: the two-stage node choice of ONE pod slot over NP node
// shards of each of S scenarios, one cooperative launch of NP * S blocks
// (block b: shard b % NP of scenario b / NP).
//
// Replaces: kubernetes_simulator_tpu/ops/tpu.py:1316 select_node_sharded
// (the two-phase program: an all_gather of each shard's (score, global id)
// pair, a static fold, and the owner-masked psum of the winner's domain
// row), together with the sharded normalize of eval_pod_fused (:1200-1225:
// the one packed pmax of the normalization extrema and the any-feasible
// bit) that feeds it.
//
// Inputs: K1 (filter_score.cu, over the padded node axis, pad rows masked)
// left the mask and raw Score rows in the scratch rows; shard q's are its
// node block's. Phases:
//   (0) each block reduces its shard's packed normalization extrema and
//       any-feasible bit over its own block (K2's pass 1, ksim_extrema_node)
//       into its row of ext [S, NP, 7] — each shard's half of the
//       reference's packed pmax (:1211-1223);
//   grid barrier (cooperative_groups);
//   (a) every block folds the NP packed extrema rows by max (the pmax
//       exchange; an f32 max of maxes is the max, and -(+inf) = -inf keeps
//       an empty shard neutral) into the global extrema, and derives the
//       row constants exactly as K2 does (ksim_norm);
//   (b) the block normalizes its own nodes' rows against them, takes the
//       weighted total in K2's order (ksim_total) and reduces its shard's
//       (max total, lowest global id) pair; a shard with no feasible node
//       gives (-inf, INT32_MAX), which loses every fold
//       (ops/tpu.py:1366-1367, with an i32 max in place of the f32 2^31);
//       the pair goes to best_v / best_i [S, NP] (the all_gather);
//   grid barrier (cooperative_groups);
//   (c) every block folds the NP pairs in shard order: the larger total
//       wins, the lower global id on equal totals — the replicated fold;
//   (d) the owner shard (winner / n_local) writes the choice into column
//       `slot` of the scenario's row of the choice buffer and the winner's
//       domain ids under every group's key, read from its own node ->
//       domain block (gdom), into cdom[s, slot, :] (the counterpart of
//       gdom_at / has_dom and the owner-masked psum); unplaced, shard 0
//       writes PAD into both. K8 (shard_apply.cu) reads them.
// The choice equals K2's on the unsharded tables bit for bit: the extrema
// are the same values, ksim_norm / ksim_total are K2's own code, and the
// (max, lowest id) fold over contiguous blocks is the lowest-index argmax.
//
// Every shard reads node-axis data only from its own block; everything that
// crosses shards goes through ext, best_v / best_i and cdom, so shards on
// separate cards would change only those exchanges.
//
// Bound on an H100: bytes — one read of the [5, N] f32 rows and the [N]
// masks (~0.28 MB at config13's N = 10,000: 0.08 us at 3.35 TB/s); at one
// scenario the launch is latency-bound (three block reductions and two grid
// barriers a slot).
//
// Exactness: compiled with --fmad=false and IEEE division, as K2.
#include <cooperative_groups.h>

#include "ksim.cuh"

namespace cg = cooperative_groups;

#define K7_THREADS 1024
#define KSIM_SHARD_NONE 0x7fffffff

__global__ void __launch_bounds__(K7_THREADS, 1)
    ksim_shard_select_kernel(KsimArgs a, int p, int32_t* choices, int64_t choice_ss,
                             int slot) {
  __shared__ float red[KSIM_EXT * 32];
  __shared__ float best_v[KSIM_MAX_WARPS];
  __shared__ int best_i[KSIM_MAX_WARPS];
  __shared__ int s_choice;
  cg::grid_group grid = cg::this_grid();
  const int shard = blockIdx.x % a.NP;
  const int64_t scen = blockIdx.x / a.NP;
  const int n0 = shard * a.n_local;

  // (0) this shard's packed extrema
  float v[KSIM_EXT];
  ksim_extrema_init(v);
  const bool is_max[KSIM_EXT] = KSIM_EXTREMA_IS_MAX;
  for (int i = threadIdx.x; i < a.n_local; i += blockDim.x)
    ksim_extrema_node(a, scen, n0 + i, v);
  ksim_block_extrema(v, KSIM_EXT, is_max, red);
  if (threadIdx.x == 0) {
    ksim_extrema_flip(v);
    float* out = a.ext + (scen * a.NP + shard) * KSIM_EXT;
    for (int k = 0; k < KSIM_EXT; ++k) out[k] = v[k];
  }
  grid.sync();

  // (a) the packed max of the shards' extrema
  for (int k = 0; k < KSIM_EXT; ++k) {
    float m = -INFINITY;
    for (int q = 0; q < a.NP; ++q) m = fmaxf(m, a.ext[(scen * a.NP + q) * KSIM_EXT + k]);
    v[k] = m;
  }
  ksim_extrema_flip(v);
  const KsimNorm c = ksim_norm(a, p, scen, v);

  // (b) this shard's (max total, lowest global id)
  const uint8_t* feas = a.feasible + scen * a.feas_ss;
  float bv = -INFINITY;
  int bi = KSIM_SHARD_NONE;
  for (int i = threadIdx.x; i < a.n_local; i += blockDim.x) {
    const int n = n0 + i;
    const float total = ksim_total(a, c, scen, n);
    if (feas[n]) ksim_better(bv, bi, total, n);
  }
  ksim_block_pick<true>(bv, bi, best_v, best_i);
  if (threadIdx.x == 0) {
    a.best_v[scen * a.NP + shard] = bv;
    a.best_i[scen * a.NP + shard] = bv > -INFINITY ? bi : KSIM_SHARD_NONE;
  }
  grid.sync();

  // (c) the fold, in shard order
  if (threadIdx.x == 0) {
    float fv = -INFINITY;
    int fi = KSIM_SHARD_NONE;
    for (int q = 0; q < a.NP; ++q) {
      const float qv = a.best_v[scen * a.NP + q];
      const int qi = a.best_i[scen * a.NP + q];
      if (qv > fv || (qv == fv && qi < fi)) {
        fv = qv;
        fi = qi;
      }
    }
    s_choice = fv > -INFINITY ? fi : KSIM_PAD;
  }
  __syncthreads();

  // (d) the owner's (or, unplaced, shard 0's) writes
  const int choice = s_choice;
  const bool owner = choice >= 0 ? choice / a.n_local == shard : shard == 0;
  if (!owner) return;
  int32_t* cd = a.cdom + (scen * choice_ss + slot) * a.G;
  const int32_t* gdom = ksim_label_rows(a, scen).gdom;
  for (int g = threadIdx.x; g < a.G; g += blockDim.x)
    cd[g] = choice >= 0 ? gdom[(size_t)g * a.N + choice] : KSIM_PAD;
  if (threadIdx.x == 0) choices[scen * choice_ss + slot] = choice;
}

// Blocks a cooperative launch of the kernel may hold on the current device
// (cached per device), or a negative CUDA error.
static int k7_max_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ksim_shard_select_kernel,
                                                         K7_THREADS, 0)) != cudaSuccess)
    return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

KSIM_EXPORT int ksim_shard_select(const KsimArgs* args, int pod, int32_t* choices,
                                  long long choice_ss, int slot, void* stream) {
  if (!args->ext || !args->best_v || !args->best_i || !args->cdom || args->S < 1 ||
      args->NP < 1 || pod < 0 || slot < 0 || slot >= choice_ss || args->preempt ||
      (long long)args->NP * args->n_local != args->N)
    return (int)cudaErrorInvalidValue;
  const int cap = k7_max_blocks();
  if (cap < 0) return -cap;
  const long long blocks = (long long)args->NP * args->S;
  if (blocks > cap) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t css = (int64_t)choice_ss;
  void* params[] = {(void*)args, (void*)&pod, (void*)&choices, (void*)&css, (void*)&slot};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ksim_shard_select_kernel,
                                              (int)blocks, K7_THREADS, params, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
