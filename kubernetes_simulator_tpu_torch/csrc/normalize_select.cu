// K2 normalize_select: per-plugin NormalizeScore, the weighted total and
// the node choice of ONE pod slot in each of S scenarios, one block of 1024
// threads per scenario (the scenario axis of sim/whatif.py:1285
// _build_chunk_fn).
//
// Replaces: kubernetes_simulator_tpu/ops/tpu.py:739 select_node (and the
// packed variant :840 the TPU build takes under its f32 gate) plus the
// normalize step of ops/tpu3.py:944 make_wave_step3 — ops/tpu.py
// _normalize_row (:699) and spread_norm_from_extrema (:565), including the
// int32 floor-division form when the static sp_norm_f32 gate is off.
//
//   pass 1  masked extrema over the feasible nodes: max of the taint and
//           node-affinity raws (0-filled), min/max of the inter-pod raw,
//           min/max of the spread raw over feasible & ~ignored;
//   pass 2  normalized rows, total = Σ w·row in the reference's plugin
//           order, and the argmax with lowest-index ties; placed iff the
//           best masked total is > -inf.
// Scenario s's choice (or -1) is written to the device int32
// choice_out[s * choice_ss] — nothing returns to the host per slot.
// Under tier preemption a scenario with no feasible node may instead take
// the masked argmin of K1's candidate row (ops/tpu.py:788 masked_argmin),
// once per wave, and writes the eviction record (ev_node, ev_tier) that
// K3 applies before the bind; every other scenario writes ev_node = -1.
//
// The retry pass (sim/whatif.py:1444-1455) selects for one pod per
// scenario: given pod_of_s, scenario s's block takes pod pod_of_s[s *
// pod_ss] and an empty buffer slot (-1) writes -1.
//
// Bound on an H100: bytes — one read of the [5,N] f32 rows and the [N]
// masks per scenario (~0.11 MB at S=1, N=5000; ~5.6 MB at S=128, N=2000:
// 1.7 µs at 3.35 TB/s). One block per scenario keeps each reduction
// deterministic; at S=1 the kernel is launch-bound.
#include "ksim.cuh"

#define K2_THREADS 1024

__device__ __forceinline__ void k2_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Block-wide reduction of 7 extrema (in shared scratch `red`) plus the
// any-feasible flag; returns through the same arrays.
__device__ void k2_reduce(float* v, int nv, const bool* is_max, float* red) {
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

// Lowest value, then lowest index (the masked argmin's order).
__device__ __forceinline__ void k2_lower(float& bv, int& bi, float v, int i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(K2_THREADS)
    ksim_normalize_select_kernel(KsimArgs a, int p_shared, int* choice_out, int64_t choice_ss,
                                 int wave, const int32_t* pod_of_s, int64_t pod_ss) {
  __shared__ float red[7 * 32];
  __shared__ float best_v[32];
  __shared__ int best_i[32];
  __shared__ int s_choice;
  const int N = a.N;
  const int64_t scen = blockIdx.x;
  const int p = pod_of_s ? pod_of_s[scen * pod_ss] : p_shared;
  if (p < 0) {  // uniform over the block: this scenario's buffer slot is empty
    if (threadIdx.x == 0) choice_out[scen * choice_ss] = KSIM_PAD;
    return;
  }
  const uint8_t* feas = a.feasible + scen * a.feas_ss;
  const uint8_t* ignored = a.ignored + scen * a.feas_ss;
  const float* rows = a.scores + scen * a.scores_ss;
  const float* taint = rows + KSIM_ROW_TAINT * N;
  const float* na = rows + KSIM_ROW_NA * N;
  const float* ip = rows + KSIM_ROW_IP * N;
  const float* sp = rows + KSIM_ROW_SPREAD * N;
  const float* fit = rows + KSIM_ROW_FIT * N;

  // pass 1: extrema. Order: taint_hi, na_hi, ip_lo, ip_hi, sp_lo, sp_hi, any_f
  float v[7] = {-INFINITY, -INFINITY, INFINITY, -INFINITY, INFINITY, -INFINITY, 0.f};
  const bool is_max[7] = {true, true, false, true, false, true, true};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool f = feas[n] != 0;
    v[0] = fmaxf(v[0], f ? taint[n] : 0.f);
    v[1] = fmaxf(v[1], f ? na[n] : 0.f);
    if (f) {
      v[2] = fminf(v[2], ip[n]);
      v[3] = fmaxf(v[3], ip[n]);
      v[6] = 1.f;
      if (!ignored[n]) {
        v[4] = fminf(v[4], sp[n]);
        v[5] = fmaxf(v[5], sp[n]);
      }
    }
  }
  k2_reduce(v, 7, is_max, red);
  const float taint_hi = v[0], na_hi = v[1], ip_lo = v[2], ip_hi = v[3];
  const float sp_lo = v[4], sp_hi = v[5];
  const bool any_f = v[6] > 0.f;

  bool any_scored = false;
  if (a.spread)
    for (int t = 0; t < a.SP; ++t)
      if (a.spread_g[p * a.SP + t] >= 0 && !a.spread_dns[p * a.SP + t]) any_scored = true;

  // Row constants (ops/tpu.py _normalize_row / spread_norm_from_extrema).
  const bool t_pos = taint_hi > 0.f;
  const float t_den = t_pos ? taint_hi : 1.f;
  const bool na_pos = na_hi > 0.f;
  const float na_den = na_pos ? na_hi : 1.f;
  const float ip_span = ip_hi - ip_lo;
  const bool ip_ok = any_f && ip_span > 0.f;
  const float ip_lo0 = ip_ok ? ip_lo : 0.f;
  const float ip_k = 100.f / (ip_ok ? ip_span : 1.f);
  const bool sp_has = sp_hi > -INFINITY;
  const float sp_hi_f = sp_has ? sp_hi : 0.f;
  const float sp_lo_f = sp_has ? sp_lo : 0.f;
  const bool sp_pos = sp_hi_f > 0.f;
  const int32_t sp_hi_i = (int32_t)sp_hi_f;
  const int32_t sp_lo_i = (int32_t)sp_lo_f;

  // pass 2: total + argmax (lowest index on ties)
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float total = 0.f;
    if (a.on_fit) total = total + a.w_fit * fit[n];
    if (a.on_taint) {
      float o = floorf((taint[n] * 100.f) / t_den);
      o = t_pos ? 100.f - o : 100.f;
      total = total + a.w_taint * o;
    }
    if (a.on_na) {
      float o = floorf((na[n] * 100.f) / na_den);
      o = na_pos ? o : 0.f;
      total = total + a.w_na * o;
    }
    if (a.on_ip) {
      float o = floorf((ip[n] - ip_lo0) * ip_k);
      o = ip_ok ? o : 0.f;
      total = total + a.w_ip * o;
    }
    if (a.on_sp) {
      float o;
      if (a.sp_norm_f32) {
        float vals = floorf((100.f * ((sp_hi_f + sp_lo_f) - sp[n])) / (sp_pos ? sp_hi_f : 1.f));
        o = sp_pos ? vals : 100.f;
      } else {
        int32_t num = 100 * ((sp_hi_i + sp_lo_i) - (int32_t)sp[n]);
        int32_t vals = ksim_floordiv(num, sp_hi_i > 0 ? sp_hi_i : 1);
        o = sp_hi_i > 0 ? (float)vals : 100.f;
      }
      if (ignored[n] || !sp_has || !any_scored) o = 0.f;
      total = total + a.w_sp * o;
    }
    if (feas[n]) k2_better(bv, bi, total, n);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, o);
    int oi = __shfl_down_sync(0xffffffffu, bi, o);
    k2_better(bv, bi, ov, oi);
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    bv = lane < nw ? best_v[lane] : -INFINITY;
    bi = lane < nw ? best_i[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, bv, o);
      int oi = __shfl_down_sync(0xffffffffu, bi, o);
      k2_better(bv, bi, ov, oi);
    }
    if (lane == 0) s_choice = bv > -INFINITY ? bi : KSIM_PAD;
  }
  __syncthreads();
  if (!a.preempt) {
    if (threadIdx.x == 0) choice_out[scen * choice_ss] = s_choice;
    return;
  }
  // Tier preemption (ops/tpu3.py:1542-1575): nothing feasible, the pod may
  // preempt and no preemption fired yet in this wave of this scenario ->
  // the lowest-index masked argmin (ops/tpu.py:788) of K1's candidate row,
  // and the eviction record K3 applies before the bind.
  const bool fire = s_choice == KSIM_PAD && ksim_may_preempt(a, p) &&
                    a.last_wave[scen] != wave;  // uniform over the block
  int node = KSIM_PAD;
  if (fire) {
    const float* cand = a.cand + scen * N;
    float mv = INFINITY;
    int mi = 0x7fffffff;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float c = cand[n];
      if (c < INFINITY) k2_lower(mv, mi, c, n);
    }
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, mv, o);
      int oi = __shfl_down_sync(0xffffffffu, mi, o);
      k2_lower(mv, mi, ov, oi);
    }
    if (lane == 0) {
      best_v[warp] = mv;
      best_i[warp] = mi;
    }
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      mv = lane < nw ? best_v[lane] : INFINITY;
      mi = lane < nw ? best_i[lane] : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        float ov = __shfl_down_sync(0xffffffffu, mv, o);
        int oi = __shfl_down_sync(0xffffffffu, mi, o);
        k2_lower(mv, mi, ov, oi);
      }
      if (lane == 0 && mv < INFINITY) node = mi;
    }
  }
  if (threadIdx.x == 0) {
    if (node >= 0) {
      choice_out[scen * choice_ss] = node;
      a.ev_node[scen] = node;
      a.ev_tier[scen] = a.pod_tier[p];
      a.last_wave[scen] = wave;
    } else {
      choice_out[scen * choice_ss] = s_choice;
      a.ev_node[scen] = KSIM_PAD;
    }
  }
}

KSIM_EXPORT int ksim_normalize_select(const KsimArgs* args, int pod, int* choice_out,
                                      long long choice_ss, int wave, const int32_t* pod_of_s,
                                      long long pod_ss, void* stream) {
  if (args->S < 1) return (int)cudaErrorInvalidValue;
  if (pod_of_s && args->preempt) return (int)cudaErrorInvalidValue;
  ksim_normalize_select_kernel<<<args->S, K2_THREADS, 0, (cudaStream_t)stream>>>(
      *args, pod, choice_out, (int64_t)choice_ss, wave, pod_of_s, (int64_t)pod_ss);
  return (int)cudaGetLastError();
}
