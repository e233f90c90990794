// The fused FFD scan (the one-dispatch solve), written by hand for Hopper
// (sm_90a). Built by karpenter_tpu_torch/device.py with nvcc
// (-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false) into a shared
// library with a plain C interface, loaded with ctypes. The wrapper, its
// checks and the plain torch version the kernel is held against live in
// karpenter_tpu_torch/ops/packer.py.
//
// What it replaces: the reference's one-dispatch scan, the lax.while_loop
// program karpenter_tpu/ops/packer.py:494 _scan_program with its init
// (:784 _scan_init) and finals (:822 _scan_finals), in all three of its
// variants: solve_scan_fn (:889, B14) and solve_scan_full_fn (:898, B15) are
// the full mode of this kernel (the init, then the loop; the caller reads
// the 10 outputs or the whole state), solve_scan_resume_fn (:909, B16) its
// resume mode (:840 _solve_scan_resume_core: the scalars loaded from the
// resident state, the suffix pods enqueued, then the same loop). The state
// buffers belong to the caller and are written in place, where the
// reference donates them to XLA.
//
// What bounds it on this card: the bytes it must move are the 27 operands
// and 10 outputs, a few MB at the solve's shape (P=65536 pods, G=128
// groups, C=2048 claim slots, U=36 unique allocatable rows, D=4 dims): under
// 2 us at 3.35 TB/s. The work is a chain of about one dependent step per
// pod (50,000 steps with no requeues), each of which reads what the last one
// wrote, so what really bounds it is the latency of one step: a handful of
// block barriers and L2 round trips. The design keeps the whole loop in ONE
// CTA of 1024 threads (no grid-wide synchronisation), the loop state in the
// caller's global buffers (they stay in the 50 MB L2), and the step's
// scalars, the group's dim rows and the row being committed in shared
// memory. Inside a step: block-wide reductions give the first fitting
// existing node and the least int64 claim key, the templates are tried in
// order, the touched row is committed, and its cfit row is refreshed with one
// warp per group.
//
// Float64 arithmetic follows the reference's order of operations exactly
// (the sum before the subtraction for an opening, one subtraction per join,
// the epsilon added before each comparison), with no contraction
// (--fmad=false) and no fast math, so results match bit for bit.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SCAN_THREADS = 1024;
constexpr int NWARPS = SCAN_THREADS / 32;
constexpr int64_t KEY_MAX = int64_t(1) << 62;
constexpr double EPS = 1e-9;
constexpr int SCAN_OK = 0, SCAN_CLAIM_OVERFLOW = 1, SCAN_QUEUE_OVERFLOW = 2;
constexpr int KIND_REJECT = 0;
constexpr int NO_NODE = 0x7fffffff;
constexpr int MODE_FULL = 0, MODE_RESUME = 1;

struct ScanParams {
  // operands (the reference layout; bools one byte each)
  const int32_t* pod_gi;      // [P]
  const double* g_req;        // [G, D]
  const double* g_floor;      // [G, D]
  const double* uniq_alloc;   // [U, D]
  const double* usage0;       // [T, D]
  const uint8_t* tol;         // [T, G]
  const uint8_t* open_ok;     // [T, G]
  const int32_t* open_fam;    // [T, G]
  const uint8_t* open_uok;    // [T, G, U]
  const int8_t* trans_kind;   // [F, G]
  const int32_t* trans_fam;   // [F, G]
  const uint8_t* famu_ok;     // [T, F, U]
  const uint8_t* node_ok;     // [N, G]  (nodes)
  const double* node_rem0;    // [N, D]  (nodes)
  const uint8_t* fam_mask;    // [F, I]
  const uint8_t* tmpl_mask;   // [T, I]  (limits)
  const uint8_t* open_cand;   // [T, G, I] (limits)
  const uint8_t* uid_onehot;  // [U, I]
  const int32_t* uid_of_type; // [I]     (limits)
  const double* cap_f;        // [I, D]  (limits)
  const int32_t* pool_of_t;   // [T]     (limits; -1 = unlimited)
  const double* pool_rem0;    // [L, D]  (limits)
  const uint8_t* pool_has;    // [L, D]  (limits)
  const uint8_t* pool_bad;    // [L]     (limits)
  // loop state, caller-owned (written here; never read through the
  // non-coherent read-only path)
  int32_t* scal;       // [8] head, tail, stop, abort, seqc, done, nclaims, steps
  int32_t* queue;      // [Qcap]
  int32_t* last_len;   // [P]
  int32_t* pod_claim;  // [P]
  int32_t* pod_node;   // [P]
  int32_t* pod_seq;    // [P]
  int32_t* claim_ti;   // [C]
  int32_t* claim_fam;  // [C]
  int32_t* claim_count;// [C]
  int64_t* claim_key;  // [C]
  uint8_t* u_valid;    // [C, U]
  double* rem;         // [C, U, D]
  uint8_t* cfit;       // [C, G]
  int32_t* nptr;       // [G]
  double* node_rem;    // [N, D] (nodes) or [1, D]
  uint8_t* tm_st;      // [C, I] (limits) or [C, 1]
  double* pool_rem;    // [L, D] (limits) or [1, D]
  uint32_t* colw;      // [I, WU] scratch: uid_onehot columns as U-bit words
  int P, G, C, U, D, F, T, N, I, L, Qcap, WU, n_pods, n_nodes, has_nodes, has_limits;
  int mode;  // MODE_FULL: init + loop; MODE_RESUME: resume the state + loop
  int p_lo;  // resume: the first suffix pod
};

// the step's scalars, shared by the block
struct StepShared {
  int head, tail, stop, abort_, seqc, done, nclaims, steps;
  int cont, pod, g, stop_now;
  int any_node, jn, any_claim, ci, c_ti, f2, want_open;
  int sel_ti, sel_pl;
  int do_open, overflow_c, placed, failed, adv, row, join, opening;
  int r_ti, r_fam;
  int red_node[NWARPS];
  int red_ci[NWARPS];
  int red_any[NWARPS];
  long long red_key[NWARPS];
  double red_max[NWARPS];
};

__device__ __forceinline__ void better_key(long long& k, int& c, long long k2, int c2) {
  if (k2 < k || (k2 == k && c2 < c)) {
    k = k2;
    c = c2;
  }
}

// block-wide max of one double per thread; every thread gets the result
__device__ double block_max(double v, StepShared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o; o >>= 1) {
    const double w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  if (lane == 0) s.red_max[warp] = v;
  __syncthreads();
  double r = s.red_max[0];
  for (int w = 1; w < NWARPS; ++w) r = s.red_max[w] > r ? s.red_max[w] : r;
  __syncthreads();  // red_max may be reused by the next call
  return r;
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int u) {
  return (words[u >> 5] >> (u & 31)) & 1u;
}

// OR the uid words of every type in `mask` (an [I] byte vector in shared
// memory) into acc (WU words, zeroed by the caller before a barrier): the
// device-side uid_project (karpenter_tpu/ops/feasibility.py:332).
__device__ void project_block(const ScanParams& p, const uint8_t* mask, uint32_t* acc) {
  for (int i = threadIdx.x; i < p.I; i += SCAN_THREADS) {
    if (!mask[i]) continue;
    const uint32_t* cw = p.colw + static_cast<size_t>(i) * p.WU;
    for (int w = 0; w < p.WU; ++w)
      if (cw[w]) atomicOr(&acc[w], cw[w]);
  }
}

template <bool HAS_NODES, bool HAS_LIMITS>
__global__ void __launch_bounds__(SCAN_THREADS, 1) solve_scan_kernel(const ScanParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StepShared s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, D = p.D, U = p.U, I = p.I, C = p.C;

  // dynamic shared layout (scan_shared_bytes below)
  double* s_rem = reinterpret_cast<double*>(smem);  // [U, D] the committed row
  double* s_greq = s_rem + U * D;                    // [D]
  double* s_gfloor = s_greq + D;                     // [D]
  double* s_sub = s_gfloor + D;                      // [D] the open's pool charge
  uint8_t* s_fit = reinterpret_cast<uint8_t*>(s_sub + D);  // [U] fit_u of the join
  uint8_t* s_uvt = s_fit + U;                        // [U] the taken template's uv
  uint8_t* s_uv = s_uvt + U;                         // [U] the committed row's uv
  uint32_t* s_acck = nullptr;  // [WU] keep_u of the join (limits)
  uint32_t* s_accl = nullptr;  // [WU] live_u of a template (limits)
  uint8_t* s_newtm = nullptr;  // [I] the join's narrowed type mask (limits)
  uint8_t* s_cand = nullptr;   // [I] a template's candidate mask (limits)
  uint8_t* s_tm = nullptr;     // [I] the committed row's type mask (limits)
  if (HAS_LIMITS) {
    const size_t off = ((s_uv + U) - smem + 3) / 4 * 4;
    s_acck = reinterpret_cast<uint32_t*>(smem + off);
    s_accl = s_acck + p.WU;
    s_newtm = reinterpret_cast<uint8_t*>(s_accl + p.WU);
    s_cand = s_newtm + I;
    s_tm = s_cand + I;
  }

  // colw is scratch, not state: rebuilt by every launch
  if (HAS_LIMITS) {
    for (int k = tid; k < I * p.WU; k += SCAN_THREADS) {
      const int i = k / p.WU, w = k % p.WU;
      uint32_t bits = 0;
      for (int b = 0; b < 32 && w * 32 + b < U; ++b)
        bits |= static_cast<uint32_t>(p.uid_onehot[static_cast<size_t>(w * 32 + b) * I + i] != 0) << b;
      p.colw[k] = bits;
    }
  }
  if (p.mode == MODE_RESUME) {
    // -- _solve_scan_resume_core: the resident scalars, then the suffix
    //    [p_lo, n_pods) enqueued at queue[tail + k], tail += nsuf --
    if (tid == 0) {
      s.head = p.scal[0];
      s.tail = p.scal[1];
      s.stop = p.scal[2];
      s.abort_ = p.scal[3];
      s.seqc = p.scal[4];
      s.done = p.scal[5];
      s.nclaims = p.scal[6];
      s.steps = 0;  // this launch's iterations
    }
    __syncthreads();
    const int tail0 = s.tail;
    const int nsuf = p.n_pods - p.p_lo > 0 ? p.n_pods - p.p_lo : 0;
    for (int k = tid; k < nsuf; k += SCAN_THREADS) {
      int idx = tail0 + k;
      idx = idx < 0 ? 0 : (idx > p.Qcap - 1 ? p.Qcap - 1 : idx);
      p.queue[idx] = p.p_lo + k;
    }
    __syncthreads();
    if (tid == 0) s.tail = tail0 + nsuf;
    __syncthreads();
  } else {
    // -- _scan_init --
    const int NR = HAS_NODES ? p.N : 1;
    const int IL = HAS_LIMITS ? I : 1;
    const int LR = HAS_LIMITS ? p.L : 1;
    for (int k = tid; k < p.Qcap; k += SCAN_THREADS) p.queue[k] = k < p.P ? k : 0;
    for (int k = tid; k < p.P; k += SCAN_THREADS) {
      p.last_len[k] = -1;
      p.pod_claim[k] = -1;
      p.pod_node[k] = -1;
      p.pod_seq[k] = -1;
    }
    for (int k = tid; k < C; k += SCAN_THREADS) {
      p.claim_ti[k] = 0;
      p.claim_fam[k] = 0;
      p.claim_count[k] = 0;
      p.claim_key[k] = KEY_MAX;
    }
    for (int k = tid; k < C * U; k += SCAN_THREADS) p.u_valid[k] = 0;
    for (size_t k = tid; k < static_cast<size_t>(C) * U * D; k += SCAN_THREADS) p.rem[k] = 0.0;
    for (size_t k = tid; k < static_cast<size_t>(C) * G; k += SCAN_THREADS) p.cfit[k] = 0;
    for (int k = tid; k < G; k += SCAN_THREADS) p.nptr[k] = 0;
    for (int k = tid; k < NR * D; k += SCAN_THREADS) p.node_rem[k] = HAS_NODES ? p.node_rem0[k] : 0.0;
    for (size_t k = tid; k < static_cast<size_t>(C) * IL; k += SCAN_THREADS) p.tm_st[k] = 0;
    for (int k = tid; k < LR * D; k += SCAN_THREADS) p.pool_rem[k] = HAS_LIMITS ? p.pool_rem0[k] : 0.0;
    if (tid == 0) {
      s.head = 0;
      s.tail = p.n_pods;
      s.stop = 0;
      s.abort_ = SCAN_OK;
      s.seqc = 0;
      s.done = 0;
      s.nclaims = 0;
      s.steps = 0;
    }
    __syncthreads();
  }

  while (true) {
    // -- the step's pod (cond, then the queue pop) --
    if (tid == 0) {
      s.cont = s.head < s.tail && !s.stop && s.abort_ == SCAN_OK;
      if (s.cont) {
        s.steps = s.steps + 1;
        s.pod = p.queue[s.head];
        s.g = p.pod_gi[s.pod];
        s.stop_now = p.last_len[s.pod] == s.tail - s.head;
      }
    }
    __syncthreads();
    if (!s.cont) break;
    const int g = s.g;
    if (tid < D) {
      s_greq[tid] = p.g_req[g * D + tid];
      s_gfloor[tid] = p.g_floor[g * D + tid];
    }
    __syncthreads();

    // -- first fitting existing node (host _try_nodes) and the least claim
    //    key among the fitting claims (host _try_claims), block-wide --
    int best_n = NO_NODE;
    if (HAS_NODES) {
      const int np0 = p.nptr[g];
      for (int j = tid; j < p.n_nodes; j += SCAN_THREADS) {
        if (j < np0 || !p.node_ok[static_cast<size_t>(j) * G + g]) continue;
        bool fit = true;
        for (int d = 0; d < D; ++d) {
          const double req = s_greq[d];
          if (req > 0) {
            const double have = p.node_rem[j * D + d] + EPS;
            fit = fit && have >= req;
          }
        }
        if (fit) {
          best_n = j;
          break;
        }
      }
    }
    long long best_k = KEY_MAX;
    int best_c = 0, any_c = 0;
    const int nclaims = s.nclaims;
    for (int c = tid; c < nclaims; c += SCAN_THREADS) {
      if (p.cfit[static_cast<size_t>(c) * G + g]) {
        any_c = 1;
        better_key(best_k, best_c, p.claim_key[c], c);
      }
    }
    for (int o = 16; o; o >>= 1) {
      best_n = min(best_n, __shfl_xor_sync(0xffffffffu, best_n, o));
      any_c |= __shfl_xor_sync(0xffffffffu, any_c, o);
      const long long k2 = __shfl_xor_sync(0xffffffffu, best_k, o);
      const int c2 = __shfl_xor_sync(0xffffffffu, best_c, o);
      better_key(best_k, best_c, k2, c2);
    }
    if (lane == 0) {
      s.red_node[warp] = best_n;
      s.red_any[warp] = any_c;
      s.red_key[warp] = best_k;
      s.red_ci[warp] = best_c;
    }
    __syncthreads();
    if (warp == 0) {
      best_n = s.red_node[lane];
      any_c = s.red_any[lane];
      best_k = s.red_key[lane];
      best_c = s.red_ci[lane];
      for (int o = 16; o; o >>= 1) {
        best_n = min(best_n, __shfl_xor_sync(0xffffffffu, best_n, o));
        any_c |= __shfl_xor_sync(0xffffffffu, any_c, o);
        const long long k2 = __shfl_xor_sync(0xffffffffu, best_k, o);
        const int c2 = __shfl_xor_sync(0xffffffffu, best_c, o);
        better_key(best_k, best_c, k2, c2);
      }
      if (lane == 0) {
        const int any_node = HAS_NODES && best_n != NO_NODE;
        s.any_node = any_node;
        s.jn = any_node ? best_n : 0;
        s.any_claim = !any_node && any_c;
        // argmin over all-KEY_MAX values is index 0: claim 0's state is
        // still read below, as the reference reads it
        const int ci = best_c;
        s.ci = ci;
        s.c_ti = p.claim_ti[ci];
        s.f2 = p.trans_fam[p.claim_fam[ci] * G + g];
        s.want_open = !any_node && !s.any_claim;
        s.sel_ti = -1;
        s.sel_pl = 0;
        if (!HAS_LIMITS && s.want_open) {
          for (int ti = 0; ti < p.T; ++ti) {
            if (p.open_ok[ti * G + g] && p.tol[ti * G + g]) {
              s.sel_ti = ti;
              break;
            }
          }
        }
      }
    }
    __syncthreads();
    const int ci = s.ci, f2 = s.f2;

    if (HAS_LIMITS) {
      // the join's narrowed type mask and its surviving uids
      for (int w = tid; w < p.WU; w += SCAN_THREADS) s_acck[w] = 0;
      for (int i = tid; i < I; i += SCAN_THREADS)
        s_newtm[i] = p.tm_st[static_cast<size_t>(ci) * I + i] & p.fam_mask[static_cast<size_t>(f2) * I + i];
      __syncthreads();
      project_block(p, s_newtm, s_acck);
      __syncthreads();
      // -- open a new claim (host _new_claim, template order), block-wide --
      if (s.want_open) {
        for (int ti = 0; ti < p.T; ++ti) {
          if (!(p.open_ok[ti * G + g] && p.tol[ti * G + g])) continue;
          const int pool = p.pool_of_t[ti];
          const int pl = pool > 0 ? pool : 0;
          const uint8_t* uok = p.open_uok + (static_cast<size_t>(ti) * G + g) * U;
          const uint8_t* oc = p.open_cand + (static_cast<size_t>(ti) * G + g) * I;
          if (pool < 0) {
            // unlimited template: its limitless verdicts stand, no charge
            for (int u = tid; u < U; u += SCAN_THREADS) s_uvt[u] = uok[u];
            for (int i = tid; i < I; i += SCAN_THREADS) s_cand[i] = oc[i];
            if (tid < D) s_sub[tid] = 0.0 + 0.0;
            if (tid == 0) {
              s.sel_ti = ti;
              s.sel_pl = pl;
            }
            break;
          }
          for (int w = tid; w < p.WU; w += SCAN_THREADS) s_accl[w] = 0;
          __syncthreads();
          const bool bad = p.pool_bad[pl] != 0;
          int left = 0;
          for (int i = tid; i < I; i += SCAN_THREADS) {
            bool lm = !bad;
            for (int d = 0; d < D && lm; ++d) {
              if (p.pool_has[pl * D + d]) {
                const double budget = p.pool_rem[pl * D + d] + EPS;
                lm = p.cap_f[static_cast<size_t>(i) * D + d] <= budget;
              }
            }
            left |= lm && p.tmpl_mask[static_cast<size_t>(ti) * I + i];
            const uint8_t cand = oc[i] && lm;
            s_cand[i] = cand;
          }
          __syncthreads();
          project_block(p, s_cand, s_accl);
          const int any_left = __syncthreads_or(left);
          int uvp = 0;
          for (int u = tid; u < U; u += SCAN_THREADS) {
            const uint8_t uv = uok[u] && bit_of(s_accl, u);
            s_uvt[u] = uv;
            uvp |= uv;
          }
          const int any_uv = __syncthreads_or(uvp);
          if (!(any_left && any_uv)) continue;
          // taken: the pool charge is the max capacity per dim over the
          // narrowed option set (host _subtract_max)
          int anysub = 0;
          for (int i = tid; i < I; i += SCAN_THREADS) anysub |= s_cand[i] && s_uvt[p.uid_of_type[i]];
          const int any_sub = __syncthreads_or(anysub);
          for (int d = 0; d < D; ++d) {
            double m = __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));  // -inf
            for (int i = tid; i < I; i += SCAN_THREADS) {
              if (s_cand[i] && s_uvt[p.uid_of_type[i]]) {
                const double v = p.cap_f[static_cast<size_t>(i) * D + d];
                m = v > m ? v : m;
              }
            }
            const double mx = block_max(m, s);
            if (tid == 0) {
              const double maxes = any_sub ? mx : 0.0;
              s_sub[d] = 0.0 + (p.pool_has[pl * D + d] ? maxes : 0.0);
            }
          }
          if (tid == 0) {
            s.sel_ti = ti;
            s.sel_pl = pl;
          }
          break;
        }
      }
    }

    // -- the join's fitting uids; the commit's scalars --
    for (int u = tid; u < U; u += SCAN_THREADS) {
      bool keep = HAS_LIMITS ? bit_of(s_acck, u)
                             : p.famu_ok[(static_cast<size_t>(s.c_ti) * p.F + f2) * U + u] != 0;
      keep = keep && p.u_valid[static_cast<size_t>(ci) * U + u];
      bool fit = keep;
      for (int d = 0; d < D; ++d)
        fit = fit && p.rem[(static_cast<size_t>(ci) * U + u) * D + d] >= s_gfloor[d];
      s_fit[u] = fit;
    }
    __syncthreads();  // sel_ti / sel_pl / s_sub of the template loop
    if (tid == 0) {
      int do_open = s.want_open && s.sel_ti >= 0;
      const int overflow_c = do_open && s.nclaims >= C;
      do_open = do_open && !overflow_c;
      const int placed = s.any_node || s.any_claim || do_open;
      const int adv = !s.stop_now;
      s.do_open = do_open;
      s.overflow_c = overflow_c;
      s.placed = placed;
      s.failed = !placed && !s.stop_now;
      s.adv = adv;
      int row = s.any_claim ? ci : (do_open ? s.nclaims : 0);
      s.row = row < C - 1 ? row : C - 1;
      s.join = s.any_claim && adv;
      s.opening = do_open && adv;
    }
    __syncthreads();

    // -- commit: one claim row, the joined node, the pool budget --
    const int row = s.row, join = s.join, opening = s.opening, sel_ti = s.sel_ti;
    const size_t rrow = static_cast<size_t>(row) * U * D;
    for (int k = tid; k < U * D; k += SCAN_THREADS) {
      const int u = k / D, d = k % D;
      double v = p.rem[rrow + k];
      if (join) {
        v = v - s_greq[d];
      } else if (opening) {
        const double need = p.usage0[sel_ti * D + d] + s_greq[d];
        v = p.uniq_alloc[u * D + d] - need;
      }
      p.rem[rrow + k] = v;
      s_rem[k] = v;
    }
    for (int u = tid; u < U; u += SCAN_THREADS) {
      uint8_t uv = p.u_valid[static_cast<size_t>(row) * U + u];
      if (join) uv = s_fit[u];
      else if (opening) uv = HAS_LIMITS ? s_uvt[u] : p.open_uok[(static_cast<size_t>(sel_ti) * G + g) * U + u];
      p.u_valid[static_cast<size_t>(row) * U + u] = uv;
      s_uv[u] = uv;
    }
    if (HAS_LIMITS) {
      for (int i = tid; i < I; i += SCAN_THREADS) {
        uint8_t tm = p.tm_st[static_cast<size_t>(row) * I + i];
        if (join) tm = s_newtm[i];
        else if (opening) tm = s_cand[i];
        p.tm_st[static_cast<size_t>(row) * I + i] = tm;
        s_tm[i] = tm;
      }
      if (opening && tid < D) {
        const int pl = s.sel_pl;
        p.pool_rem[pl * D + tid] = p.pool_rem[pl * D + tid] - s_sub[tid];
      }
    }
    if (HAS_NODES && s.any_node && s.adv && tid < D) {
      const int jn = s.jn;
      p.node_rem[jn * D + tid] = p.node_rem[jn * D + tid] - s_greq[tid];
    }
    if (tid == 0) {
      const int adv = s.adv, pod = s.pod;
      const int touch = join || opening;
      const int seq2 = touch ? s.seqc + 1 : s.seqc;
      int ti_row = p.claim_ti[row], fam_row = p.claim_fam[row], count = p.claim_count[row];
      int rank = 0;
      if (join) {
        fam_row = s.f2;
        count = count + 1;
        rank = -seq2;
      } else if (opening) {
        ti_row = sel_ti;
        fam_row = p.open_fam[sel_ti * G + g];
        count = 1;
        rank = seq2;
      }
      p.claim_ti[row] = ti_row;
      p.claim_fam[row] = fam_row;
      p.claim_count[row] = count;
      if (touch)
        p.claim_key[row] = static_cast<long long>(count) * (1LL << 39) +
                           (static_cast<long long>(rank) + (1LL << 20)) * (1LL << 18) + row;
      s.r_ti = ti_row;
      s.r_fam = fam_row;
      if (HAS_NODES && adv) p.nptr[g] = s.any_node ? s.jn : p.n_nodes;
      if (opening) s.nclaims = s.nclaims + 1;
      // pod bookkeeping
      const int head2 = adv ? s.head + 1 : s.head;
      p.pod_claim[pod] = join ? ci : (opening ? row : -1);
      p.pod_node[pod] = (HAS_NODES && s.any_node && adv) ? s.jn : -1;
      if (s.placed && adv) {
        p.pod_seq[pod] = s.done;
        s.done = s.done + 1;
      }
      // failure: requeue + cycle-detection bookkeeping
      const int overflow_q = s.failed && s.tail >= p.Qcap;
      int tail2 = s.tail;
      if (s.failed && !overflow_q) {
        p.queue[s.tail] = pod;
        tail2 = s.tail + 1;
      }
      if (s.failed && adv) p.last_len[pod] = tail2 - head2;
      if (s.overflow_c) s.abort_ = SCAN_CLAIM_OVERFLOW;
      else if (overflow_q) s.abort_ = SCAN_QUEUE_OVERFLOW;
      s.stop = s.stop || s.stop_now;
      s.head = head2;
      s.tail = tail2;
      s.seqc = seq2;
    }
    __syncthreads();

    // -- cfit row refresh for the committed row: one warp per group --
    {
      const int r_ti = s.r_ti, r_fam = s.r_fam;
      for (int gp = warp; gp < G; gp += NWARPS) {
        const int kind = p.trans_kind[r_fam * G + gp];
        const int f2g = p.trans_fam[r_fam * G + gp];
        int hit = 0;
        if (kind != KIND_REJECT && p.tol[r_ti * G + gp]) {
          const double* gf = p.g_floor + static_cast<size_t>(gp) * D;
          for (int w = 0; w < p.WU; ++w) {
            const int u = w * 32 + lane;
            bool keep;
            if (HAS_LIMITS) {
              uint32_t word = 0;
              const uint8_t* fm = p.fam_mask + static_cast<size_t>(f2g) * I;
              for (int i = lane; i < I; i += 32)
                if (fm[i] && s_tm[i]) word |= p.colw[static_cast<size_t>(i) * p.WU + w];
              word = __reduce_or_sync(0xffffffffu, word);
              keep = (word >> lane) & 1u;
            } else {
              keep = u < U && p.famu_ok[(static_cast<size_t>(r_ti) * p.F + f2g) * U + u];
            }
            if (u < U && keep && s_uv[u]) {
              bool fits = true;
              for (int d = 0; d < D; ++d) fits = fits && s_rem[u * D + d] >= gf[d];
              hit |= fits;
            }
          }
        }
        hit = __any_sync(0xffffffffu, hit);
        if (lane == 0) p.cfit[static_cast<size_t>(row) * G + gp] = hit;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    p.scal[0] = s.head;
    p.scal[1] = s.tail;
    p.scal[2] = s.stop;
    p.scal[3] = s.abort_;
    p.scal[4] = s.seqc;
    p.scal[5] = s.done;
    p.scal[6] = s.nclaims;
    p.scal[7] = s.steps;  // loop iterations, read by the caller
  }
}

size_t scan_shared_bytes(int U, int D, int I, int WU, bool has_limits) {
  size_t n = 8 * static_cast<size_t>(U * D + 3 * D) + 3 * static_cast<size_t>(U);
  if (has_limits) n = (n + 3) / 4 * 4 + 8 * static_cast<size_t>(WU) + 3 * static_cast<size_t>(I);
  return n;
}

template <bool HAS_NODES, bool HAS_LIMITS>
int launch(const ScanParams& p, cudaStream_t stream) {
  const size_t shmem = scan_shared_bytes(p.U, p.D, p.I, p.WU, HAS_LIMITS);
  cudaError_t err = cudaFuncSetAttribute(solve_scan_kernel<HAS_NODES, HAS_LIMITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  solve_scan_kernel<HAS_NODES, HAS_LIMITS><<<1, SCAN_THREADS, shmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ptrs: the 24 operand pointers (the reference order, less claim_pad,
// n_pods and n_nodes), the 17 state pointers and the colw scratch, as in
// ScanParams; dims: P, G, C, U, D, F, T, N, I, L, Qcap, WU, n_pods, n_nodes,
// has_nodes, has_limits, mode (0 full, 1 resume), p_lo. Returns the
// launch's cudaError_t.
constexpr int N_PTRS = 42, N_DIMS = 18;
static_assert(offsetof(ScanParams, P) == N_PTRS * sizeof(void*), "ScanParams: pointers first");
static_assert(offsetof(ScanParams, p_lo) == N_PTRS * sizeof(void*) + (N_DIMS - 1) * sizeof(int),
              "ScanParams: p_lo is the last int");
static_assert(sizeof(ScanParams) == N_PTRS * sizeof(void*) + N_DIMS * sizeof(int),
              "ScanParams: 42 pointers then 18 ints");

int kt_solve_scan(void* const* ptrs, const int* dims, void* stream) {
  ScanParams p;
  void** f = reinterpret_cast<void**>(&p);
  for (int k = 0; k < N_PTRS; ++k) f[k] = ptrs[k];
  int* d = &p.P;
  for (int k = 0; k < N_DIMS; ++k) d[k] = dims[k];
  if (p.mode != MODE_FULL && p.mode != MODE_RESUME) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.has_nodes) {
    return p.has_limits ? launch<true, true>(p, st) : launch<true, false>(p, st);
  }
  return p.has_limits ? launch<false, true>(p, st) : launch<false, false>(p, st);
}

}  // extern "C"
