// The fused FFD scan (the one-dispatch solve), written by hand for Hopper
// (sm_90a). Built by karpenter_tpu_torch/device.py with nvcc
// (-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false) into a shared
// library with a plain C interface, loaded with ctypes. The wrapper, its
// checks, the choice between the two designs below and the plain torch
// version the kernels are held against live in
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
// wrote, so what really bounds it is the latency of one step: its block
// barriers and its dependent L2 round trips. Both designs keep the whole
// loop in ONE CTA (no grid-wide synchronisation).
//
// The resident design (solve_scan_resident_kernel, the one the wrapper
// takes whenever scan_resident_bytes fits the 227 KB a block may use):
// shared memory holds, for the whole launch, every constant table a step
// reads (g_req, g_floor, tol, open_ok, open_fam, open_uok and famu_ok as
// U-bit words, trans_kind, trans_fam as int16, uniq_alloc, usage0) and the
// claim state (claim_key, claim_ti, claim_fam, claim_count, u_valid as
// U-bit words, cfit as bits transposed to [G][C/32], so a group's candidate
// claims are contiguous words). The launch loads them at init or resume and
// writes the claim state back to the caller's buffers before it ends (every
// row in full mode, the rows it touched in resume mode); rem ([C, U, D]
// float64, MBs) stays in global memory. A step of the classic variant is:
//   1. every thread: the least key among the group's candidate claims (and,
//      with nodes, the first fitting node), reduced per warp with redux;
//      block barrier;
//   2. warp 0 alone, the block's scalars in its registers: the last step of
//      the argmin (a touched claim's key ends in its row, so the least key
//      names the claim; all-KEY_MAX is claim 0), the join's rem row read
//      once (the step's one dependent L2 round trip), ci, f2, want_open,
//      the template, the fit of the U rows (a ballot per 32 elements of
//      the row, then per 32 uids) and the commit (the rem row written back
//      and kept in shared memory); then it arrives at a named barrier;
//   3. warps 1.. wait there and refresh the committed row's cfit bit for
//      every group (a thread per group) while warp 0 keeps the books: the
//      claim's key and counts, the pod's entries, the requeue and the next
//      step's pop, prefetched during the step whenever head + 1 < tail (only
//      a requeue of the last queued pod makes the next pod unknown); block
//      barrier.
// So a step has three barriers (the middle one a named producer-consumer
// barrier) and one L2 round trip; the stores of the rem row and the pod's
// entries do not wait. Each barrier a step drops, and each round trip, is
// latency off a chain of 50,000 dependent steps. The limits variant adds
// the block-wide template loop and its barriers and refreshes after the
// books; node_ok, node_rem, nptr, tm_st, fam_mask, open_cand, the pool
// arrays and colw stay in global memory. A block of up to 512 threads
// gets 128 registers a thread, one of 1024 only 64.
//
// The global design (solve_scan_kernel, the first design, unchanged; the
// wrapper takes it for shapes whose resident set does not fit, e.g. a claim
// axis of pow2(P) at large P): 1024 threads, the loop state in the caller's
// global buffers (they stay in the 50 MB L2), the step's scalars, the
// group's dim rows and the row being committed in shared memory; eight
// block barriers and about eleven dependent L2 round trips a step.
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
  int design;   // DESIGN_GLOBAL or DESIGN_RESIDENT
  int threads;  // the resident design's block size (the global design's is SCAN_THREADS)
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

// == the resident design ======================================================

constexpr int RES_MAX_THREADS = 1024;
constexpr int RES_MAX_WARPS = RES_MAX_THREADS / 32;
// shared memory a block may use on sm_90 (227 KB), and the share of it the
// resident kernel's static ResShared takes; ops/packer.py holds the same
constexpr size_t SMEM_PER_BLOCK = 232448;
constexpr size_t RES_STATIC_RESERVE = 1024;
constexpr long long KEY_ROW_MASK = (1LL << 18) - 1;  // a touched claim's key ends in its row
constexpr int DESIGN_GLOBAL = 0, DESIGN_RESIDENT = 1;
constexpr int REM_BATCH = 8;  // rem elements each lane of warp 0 has in flight
constexpr unsigned FULL_MASK = 0xffffffffu;

// what the block shares: the loop's scalars at init, then what warp 0
// tells the block each step (written between barriers)
struct ResShared {
  int head, tail, stop, abort_, seqc, done, nclaims;  // init; nclaims then every step
  int cont, g;                                   // the coming step's pop
  int touch, join, row, r_ti, r_fam;             // the row the step committed
  int ci, f2, want_open, sel_ti, sel_pl;         // limits: for the block-wide template loop
  int part_node[RES_MAX_WARPS];
  long long part_key[RES_MAX_WARPS];
  double red_max[RES_MAX_WARPS];
};
static_assert(sizeof(ResShared) <= RES_STATIC_RESERVE, "ResShared outgrew its reserve");

// byte offsets of the resident set in dynamic shared memory, widest elements
// first so every array is aligned
struct ResLayout {
  size_t key, greq, gfloor, ualloc, usage0, rem, sub;                    // 8 bytes
  size_t cfit, uv, ti, count, fam, famu, ouok, ofam, dirty, bad, acck, accl;  // 4 bytes
  size_t tfam;                                                           // 2 bytes
  size_t tkind, tol, ook, uvt, newtm, cand, tm;                          // 1 byte
  size_t total;
  int wc, wcp, wu, nbad;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += bytes;
  return at;
}

__host__ __device__ inline ResLayout res_layout(int C, int G, int U, int D, int T, int F, int I, bool lim) {
  ResLayout L;
  L.wc = (C + 31) / 32;
  L.wcp = L.wc | 1;  // an odd row stride: the refresh's per-group words fall in distinct banks
  L.wu = (U + 31) / 32;
  L.nbad = (U * D + 31) / 32;
  const size_t c = C, g = G, u = U, d = D, t = T, f = F, i = I, wc = L.wc, wcp = L.wcp, wu = L.wu;
  size_t o = 0;
  L.key = take(o, 8 * c);
  L.greq = take(o, 8 * g * d);
  L.gfloor = take(o, 8 * g * d);
  L.ualloc = take(o, 8 * u * d);
  L.usage0 = take(o, 8 * t * d);
  L.rem = take(o, 8 * u * d);
  L.sub = take(o, lim ? 8 * d : 0);
  L.cfit = take(o, 4 * g * wcp);
  L.uv = take(o, 4 * c * wu);
  L.ti = take(o, 4 * c);
  L.count = take(o, 4 * c);
  L.fam = take(o, 4 * c);
  L.famu = take(o, 4 * t * f * wu);
  L.ouok = take(o, 4 * t * g * wu);
  L.ofam = take(o, 4 * t * g);
  L.dirty = take(o, 4 * wc);
  L.bad = take(o, 4 * static_cast<size_t>(L.nbad));
  L.acck = take(o, lim ? 4 * wu : 0);
  L.accl = take(o, lim ? 4 * wu : 0);
  L.tfam = take(o, 2 * f * g);
  L.tkind = take(o, f * g);
  L.tol = take(o, t * g);
  L.ook = take(o, t * g);
  L.uvt = take(o, lim ? u : 0);
  L.newtm = take(o, lim ? i : 0);
  L.cand = take(o, lim ? i : 0);
  L.tm = take(o, lim ? i : 0);
  L.total = (o + 15) / 16 * 16;
  return L;
}

// the least of one non-negative int64 per lane, in every lane: two redux
// instructions, on the high word and then on the low words that tie there
__device__ __forceinline__ long long warp_min64(long long k) {
  const unsigned hi = static_cast<unsigned>(static_cast<unsigned long long>(k) >> 32);
  const unsigned lo = static_cast<unsigned>(static_cast<unsigned long long>(k));
  const unsigned mhi = __reduce_min_sync(FULL_MASK, hi);
  const unsigned mlo = __reduce_min_sync(FULL_MASK, hi == mhi ? lo : 0xffffffffu);
  return static_cast<long long>((static_cast<unsigned long long>(mhi) << 32) | mlo);
}

__device__ __forceinline__ void set_bit(uint32_t* dst, int r, int c, int wpr, bool transposed) {
  if (transposed) atomicOr(&dst[static_cast<size_t>(c) * wpr + (r >> 5)], 1u << (r & 31));
  else atomicOr(&dst[static_cast<size_t>(r) * wpr + (c >> 5)], 1u << (c & 31));
}

// OR the set bytes of a row-major [rows, cols] byte matrix into zeroed bit
// words: bit (r, c) of dst[r * wpr + c / 32], or of dst[c * wpr + r / 32]
// when transposed. Block-wide, 16 bytes a load where the source is aligned.
__device__ void bytes_to_bits(const uint8_t* src, int rows, int cols, uint32_t* dst, int wpr,
                              bool transposed) {
  const int n = rows * cols;
  int k0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* v16 = reinterpret_cast<const uint4*>(src);
    const int n16 = n / 16;
    for (int q = threadIdx.x; q < n16; q += blockDim.x) {
      const uint4 v = v16[q];
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if ((w4[j >> 2] >> (8 * (j & 3))) & 0xffu) {
          const int k = q * 16 + j;
          set_bit(dst, k / cols, k % cols, wpr, transposed);
        }
      }
    }
    k0 = n16 * 16;
  }
  for (int k = k0 + threadIdx.x; k < n; k += blockDim.x)
    if (src[k]) set_bit(dst, k / cols, k % cols, wpr, transposed);
}

// the bit matrix back as bytes, dst[r * cols + c] = bit (r, c), for every
// row (all) or the rows whose dirty bit is set; one warp per row
__device__ void bits_to_bytes(uint8_t* dst, int rows, int cols, const uint32_t* bits, int wpr,
                              bool transposed, bool all, const uint32_t* dirty) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nw) {
    if (!all && !((dirty[r >> 5] >> (r & 31)) & 1u)) continue;
    for (int c = lane; c < cols; c += 32) {
      const uint32_t w = transposed ? bits[static_cast<size_t>(c) * wpr + (r >> 5)] >> (r & 31)
                                    : bits[static_cast<size_t>(r) * wpr + (c >> 5)] >> (c & 31);
      dst[static_cast<size_t>(r) * cols + c] = static_cast<uint8_t>(w & 1u);
    }
  }
}

// named barrier `id` over `count` threads: arrive without waiting (the
// producer), or wait for every arrival (the consumers); a thread's earlier
// shared and global writes are visible to the consumers after the wait
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// project_block for any block size
__device__ void project_n(const ScanParams& p, const uint8_t* mask, uint32_t* acc) {
  for (int i = threadIdx.x; i < p.I; i += blockDim.x) {
    if (!mask[i]) continue;
    const uint32_t* cw = p.colw + static_cast<size_t>(i) * p.WU;
    for (int w = 0; w < p.WU; ++w)
      if (cw[w]) atomicOr(&acc[w], cw[w]);
  }
}

// block_max for any block size
__device__ double block_max_n(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 16; o; o >>= 1) {
    const double w = __shfl_xor_sync(FULL_MASK, v, o);
    v = w > v ? w : v;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double r = red[0];
  for (int w = 1; w < nw; ++w) r = red[w] > r ? red[w] : r;
  __syncthreads();  // red may be reused by the next call
  return r;
}

// MAX_THREADS bounds the block: 512 leaves a thread 128 registers, 1024 only 64
template <bool HAS_NODES, bool HAS_LIMITS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1) solve_scan_resident_kernel(const ScanParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ResShared s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int G = p.G, D = p.D, U = p.U, I = p.I, C = p.C, T = p.T, F = p.F;
  const int UD = U * D;
  const bool full = p.mode == MODE_FULL;
  const ResLayout L = res_layout(C, G, U, D, T, F, I, HAS_LIMITS);
  const int WC = L.wc, WCP = L.wcp, WU = L.wu;
  long long* s_key = reinterpret_cast<long long*>(smem + L.key);
  double* s_greq = reinterpret_cast<double*>(smem + L.greq);
  double* s_gfloor = reinterpret_cast<double*>(smem + L.gfloor);
  double* s_ualloc = reinterpret_cast<double*>(smem + L.ualloc);
  double* s_usage0 = reinterpret_cast<double*>(smem + L.usage0);
  double* s_rem = reinterpret_cast<double*>(smem + L.rem);    // [U, D] the step's committed row
  double* s_sub = reinterpret_cast<double*>(smem + L.sub);    // [D] the open's pool charge (limits)
  uint32_t* s_cfit = reinterpret_cast<uint32_t*>(smem + L.cfit);  // [G][WCP] bit c: cfit[c, g]
  uint32_t* s_uv = reinterpret_cast<uint32_t*>(smem + L.uv);      // [C][WU]
  int32_t* s_ti = reinterpret_cast<int32_t*>(smem + L.ti);
  int32_t* s_count = reinterpret_cast<int32_t*>(smem + L.count);
  int32_t* s_fam = reinterpret_cast<int32_t*>(smem + L.fam);
  uint32_t* s_famu = reinterpret_cast<uint32_t*>(smem + L.famu);  // [T][F][WU]
  uint32_t* s_ouok = reinterpret_cast<uint32_t*>(smem + L.ouok);  // [T][G][WU]
  int32_t* s_ofam = reinterpret_cast<int32_t*>(smem + L.ofam);
  uint32_t* s_dirty = reinterpret_cast<uint32_t*>(smem + L.dirty);  // [WC] rows this launch touched
  uint32_t* s_bad = reinterpret_cast<uint32_t*>(smem + L.bad);  // [U D / 32] the join's misses
  uint32_t* s_acck = reinterpret_cast<uint32_t*>(smem + L.acck);    // [WU] keep_u of the join (limits)
  uint32_t* s_accl = reinterpret_cast<uint32_t*>(smem + L.accl);    // [WU] live_u of a template (limits)
  int16_t* s_tfam = reinterpret_cast<int16_t*>(smem + L.tfam);
  int8_t* s_tkind = reinterpret_cast<int8_t*>(smem + L.tkind);
  uint8_t* s_tol = smem + L.tol;
  uint8_t* s_ook = smem + L.ook;
  uint8_t* s_uvt = smem + L.uvt;      // [U] the taken template's uv (limits)
  uint8_t* s_newtm = smem + L.newtm;  // [I] the join's narrowed type mask (limits)
  uint8_t* s_cand = smem + L.cand;    // [I] a template's candidate mask (limits)
  uint8_t* s_tm = smem + L.tm;        // [I] the committed row's type mask (limits)

  // -- load the constant tables; zero the bit words --
  for (int k = tid; k < G * D; k += nt) {
    s_greq[k] = p.g_req[k];
    s_gfloor[k] = p.g_floor[k];
  }
  for (int k = tid; k < UD; k += nt) s_ualloc[k] = p.uniq_alloc[k];
  for (int k = tid; k < T * D; k += nt) s_usage0[k] = p.usage0[k];
  for (int k = tid; k < T * G; k += nt) {
    s_tol[k] = p.tol[k];
    s_ook[k] = p.open_ok[k];
    s_ofam[k] = p.open_fam[k];
  }
  for (int k = tid; k < F * G; k += nt) {
    s_tkind[k] = p.trans_kind[k];
    s_tfam[k] = static_cast<int16_t>(p.trans_fam[k]);
  }
  for (int k = tid; k < T * F * WU; k += nt) s_famu[k] = 0;
  for (int k = tid; k < T * G * WU; k += nt) s_ouok[k] = 0;
  for (int k = tid; k < G * WCP; k += nt) s_cfit[k] = 0;
  for (int k = tid; k < C * WU; k += nt) s_uv[k] = 0;
  for (int k = tid; k < WC; k += nt) s_dirty[k] = 0;
  if (HAS_LIMITS) {  // colw is scratch, not state: rebuilt by every launch
    for (int k = tid; k < I * p.WU; k += nt) {
      const int i = k / p.WU, w = k % p.WU;
      uint32_t bits = 0;
      for (int b = 0; b < 32 && w * 32 + b < U; ++b)
        bits |= static_cast<uint32_t>(p.uid_onehot[static_cast<size_t>(w * 32 + b) * I + i] != 0) << b;
      p.colw[k] = bits;
    }
  }
  if (full) {
    // -- _scan_init: the global state here, the claim state in shared
    //    memory (written back at the end) --
    const int NR = HAS_NODES ? p.N : 1;
    const int IL = HAS_LIMITS ? I : 1;
    const int LR = HAS_LIMITS ? p.L : 1;
    for (int k = tid; k < p.Qcap; k += nt) p.queue[k] = k < p.P ? k : 0;
    for (int k = tid; k < p.P; k += nt) {
      p.last_len[k] = -1;
      p.pod_claim[k] = -1;
      p.pod_node[k] = -1;
      p.pod_seq[k] = -1;
    }
    for (size_t k = tid; k < static_cast<size_t>(C) * UD; k += nt) p.rem[k] = 0.0;
    for (int k = tid; k < G; k += nt) p.nptr[k] = 0;
    for (int k = tid; k < NR * D; k += nt) p.node_rem[k] = HAS_NODES ? p.node_rem0[k] : 0.0;
    for (size_t k = tid; k < static_cast<size_t>(C) * IL; k += nt) p.tm_st[k] = 0;
    for (int k = tid; k < LR * D; k += nt) p.pool_rem[k] = HAS_LIMITS ? p.pool_rem0[k] : 0.0;
    for (int k = tid; k < C; k += nt) {
      s_ti[k] = 0;
      s_fam[k] = 0;
      s_count[k] = 0;
      s_key[k] = KEY_MAX;
    }
    if (tid == 0) {
      s.head = 0;
      s.tail = p.n_pods;
      s.stop = 0;
      s.abort_ = SCAN_OK;
      s.seqc = 0;
      s.done = 0;
      s.nclaims = 0;
    }
  } else {
    // -- _solve_scan_resume_core: the resident state --
    for (int k = tid; k < C; k += nt) {
      s_ti[k] = p.claim_ti[k];
      s_fam[k] = p.claim_fam[k];
      s_count[k] = p.claim_count[k];
      s_key[k] = p.claim_key[k];
    }
    if (tid == 0) {
      s.head = p.scal[0];
      s.tail = p.scal[1];
      s.stop = p.scal[2];
      s.abort_ = p.scal[3];
      s.seqc = p.scal[4];
      s.done = p.scal[5];
      s.nclaims = p.scal[6];
    }
  }
  __syncthreads();
  bytes_to_bits(p.famu_ok, T * F, U, s_famu, WU, false);
  bytes_to_bits(p.open_uok, T * G, U, s_ouok, WU, false);
  const int nsuf = full ? 0 : (p.n_pods - p.p_lo > 0 ? p.n_pods - p.p_lo : 0);
  if (!full) {
    bytes_to_bits(p.u_valid, C, U, s_uv, WU, false);
    bytes_to_bits(p.cfit, C, G, s_cfit, WCP, true);
    // the suffix [p_lo, n_pods) enqueued at queue[tail + k], tail += nsuf
    const int tail0 = s.tail;
    for (int k = tid; k < nsuf; k += nt) {
      int idx = tail0 + k;
      idx = idx < 0 ? 0 : (idx > p.Qcap - 1 ? p.Qcap - 1 : idx);
      p.queue[idx] = p.p_lo + k;
    }
  }
  __syncthreads();
  // warp 0 keeps the loop's scalars in registers, the same in every lane;
  // the block reads what it needs of them from `s`
  int head = s.head, tail = s.tail + nsuf, stop = s.stop, abort_ = s.abort_, seqc = s.seqc;
  int done = s.done, nclaims = s.nclaims, steps = 0, pod = 0, g = 0, stop_now = 0;
  // the dim of rem row element `lane`, and the step of an element's dim
  // from one 32-element batch to the next
  const int d_lane = lane % D, d_step = 32 % D;
  if (warp == 0) {  // the first pop
    const int cont = head < tail && !stop && abort_ == SCAN_OK;
    if (cont) {
      steps = 1;
      pod = p.queue[head];
      g = p.pod_gi[pod];
      stop_now = p.last_len[pod] == tail - head;
    }
    if (lane == 0) {
      s.cont = cont;
      s.g = g;
    }
  }
  __syncthreads();

  while (s.cont) {
    const int gs = s.g, ncl = s.nclaims;  // the step's group and open claims, for every warp
    // warp 0: the next queue entry, already known when head + 1 < tail
    // (the step can only write queue[tail]), fetched while the step runs
    const bool pf = head + 1 < tail;
    int pf_pod = 0;
    if (warp == 0 && pf) pf_pod = p.queue[head + 1];

    // -- 1. partial minima: the first fitting existing node (host
    //    _try_nodes), the least key among the group's candidate claims
    //    (host _try_claims) --
    int best_n = NO_NODE;
    if (HAS_NODES) {
      const int np0 = p.nptr[gs];
      const double* greq = s_greq + gs * D;
      for (int j = tid; j < p.n_nodes; j += nt) {
        if (j < np0 || !p.node_ok[static_cast<size_t>(j) * G + gs]) continue;
        bool fit = true;
        for (int d = 0; d < D; ++d) {
          const double req = greq[d];
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
      best_n = __reduce_min_sync(FULL_MASK, best_n);
    }
    long long best = KEY_MAX;
    const uint32_t* gbits = s_cfit + static_cast<size_t>(gs) * WCP;
    for (int c = tid; c < ncl; c += nt) {
      if ((gbits[c >> 5] >> (c & 31)) & 1u) {
        const long long k = s_key[c];
        best = k < best ? k : best;
      }
    }
    best = warp_min64(best);
    if (lane == 0) {
      s.part_key[warp] = best;
      s.part_node[warp] = best_n;
    }
    __syncthreads();  // barrier 1

    // -- 2. warp 0: the claim, the template, the commit, the bookkeeping --
    int any_node = 0, jn = 0, any_claim = 0, ci = 0, c_ti = 0, f2 = 0, want_open = 0;
    int pf_g = 0, pf_ll = 0;
    double v[REM_BATCH];  // the join's rem row, element j * 32 + lane
    if (warp == 0) {
      if (pf) {
        pf_g = p.pod_gi[pf_pod];
        pf_ll = p.last_len[pf_pod];
      }
      const long long k = warp_min64(lane < nw ? s.part_key[lane] : KEY_MAX);
      if (HAS_NODES) {
        const int bn = __reduce_min_sync(FULL_MASK, lane < nw ? s.part_node[lane] : NO_NODE);
        any_node = bn != NO_NODE;
        jn = any_node ? bn : 0;
      }
      any_claim = !any_node && k != KEY_MAX;
      // keys of touched claims are unique and end in their row; an argmin
      // over all-KEY_MAX keys is index 0, and claim 0's state is still read
      // below, as the reference reads it
      ci = k != KEY_MAX ? static_cast<int>(k & KEY_ROW_MASK) : 0;
      if (any_claim && !stop_now) {
        // the join's rem row: the step's one dependent L2 round trip
        const double* src = p.rem + static_cast<size_t>(ci) * UD;
#pragma unroll
        for (int j = 0; j < REM_BATCH; ++j) {
          const int e = j * 32 + lane;
          v[j] = e < UD ? src[e] : 0.0;
        }
      }
      c_ti = s_ti[ci];
      f2 = s_tfam[s_fam[ci] * G + g];
      want_open = !any_node && !any_claim;
      if (HAS_LIMITS && lane == 0) {
        s.ci = ci;
        s.f2 = f2;
        s.want_open = want_open;
        s.sel_ti = -1;
        s.sel_pl = 0;
      }
    }

    if (HAS_LIMITS) {
      __syncthreads();
      // the join's narrowed type mask and its surviving uids
      const int lci = s.ci, lf2 = s.f2;
      for (int w = tid; w < WU; w += nt) s_acck[w] = 0;
      for (int i = tid; i < I; i += nt)
        s_newtm[i] = p.tm_st[static_cast<size_t>(lci) * I + i] & p.fam_mask[static_cast<size_t>(lf2) * I + i];
      __syncthreads();
      project_n(p, s_newtm, s_acck);
      __syncthreads();
      // -- open a new claim (host _new_claim, template order), block-wide --
      if (s.want_open) {
        for (int ti = 0; ti < T; ++ti) {
          if (!(s_ook[ti * G + gs] && s_tol[ti * G + gs])) continue;
          const int pool = p.pool_of_t[ti];
          const int pl = pool > 0 ? pool : 0;
          const uint32_t* uok = s_ouok + (static_cast<size_t>(ti) * G + gs) * WU;
          const uint8_t* oc = p.open_cand + (static_cast<size_t>(ti) * G + gs) * I;
          if (pool < 0) {
            // unlimited template: its limitless verdicts stand, no charge
            for (int u = tid; u < U; u += nt) s_uvt[u] = bit_of(uok, u);
            for (int i = tid; i < I; i += nt) s_cand[i] = oc[i];
            if (tid < D) s_sub[tid] = 0.0 + 0.0;
            if (tid == 0) {
              s.sel_ti = ti;
              s.sel_pl = pl;
            }
            break;
          }
          for (int w = tid; w < WU; w += nt) s_accl[w] = 0;
          __syncthreads();
          const bool bad = p.pool_bad[pl] != 0;
          int left = 0;
          for (int i = tid; i < I; i += nt) {
            bool lm = !bad;
            for (int d = 0; d < D && lm; ++d) {
              if (p.pool_has[pl * D + d]) {
                const double budget = p.pool_rem[pl * D + d] + EPS;
                lm = p.cap_f[static_cast<size_t>(i) * D + d] <= budget;
              }
            }
            left |= lm && p.tmpl_mask[static_cast<size_t>(ti) * I + i];
            s_cand[i] = oc[i] && lm;
          }
          __syncthreads();
          project_n(p, s_cand, s_accl);
          const int any_left = __syncthreads_or(left);
          int uvp = 0;
          for (int u = tid; u < U; u += nt) {
            const uint8_t uv = bit_of(uok, u) && bit_of(s_accl, u);
            s_uvt[u] = uv;
            uvp |= uv;
          }
          const int any_uv = __syncthreads_or(uvp);
          if (!(any_left && any_uv)) continue;
          // taken: the pool charge is the max capacity per dim over the
          // narrowed option set (host _subtract_max)
          int anysub = 0;
          for (int i = tid; i < I; i += nt) anysub |= s_cand[i] && s_uvt[p.uid_of_type[i]];
          const int any_sub = __syncthreads_or(anysub);
          for (int d = 0; d < D; ++d) {
            double m = __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));  // -inf
            for (int i = tid; i < I; i += nt) {
              if (s_cand[i] && s_uvt[p.uid_of_type[i]]) {
                const double v = p.cap_f[static_cast<size_t>(i) * D + d];
                m = v > m ? v : m;
              }
            }
            const double mx = block_max_n(m, s.red_max);
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
      __syncthreads();  // sel_ti / sel_pl / s_uvt / s_cand / s_sub
    }

    if (warp == 0) {
      int sel_ti;
      if (HAS_LIMITS) {
        sel_ti = s.sel_ti;
      } else {
        const bool ok = want_open && lane < T && s_ook[lane * G + g] && s_tol[lane * G + g];
        const unsigned m = __ballot_sync(FULL_MASK, ok);
        sel_ti = m ? __ffs(m) - 1 : -1;
      }
      int do_open = want_open && sel_ti >= 0;
      const int overflow_c = do_open && nclaims >= C;
      do_open = do_open && !overflow_c;
      const int placed = any_node || any_claim || do_open;
      const int adv = !stop_now;
      const int failed = !placed && !stop_now;
      int row = any_claim ? ci : (do_open ? nclaims : 0);
      row = row < C - 1 ? row : C - 1;
      const int join = any_claim && adv, opening = do_open && adv;
      const double* greq = s_greq + g * D;
      const double* gfl = s_gfloor + g * D;
      double* dst = p.rem + static_cast<size_t>(row) * UD;
      if (join) {
        // the new row, one subtraction per element, and per element whether
        // the old value missed the group's floor: a ballot per 32 elements
        for (int k0 = 0;;) {
          // element j * 32 + lane's floor and request, loaded ahead
          double fl[REM_BATCH], rq[REM_BATCH];
          int d = k0 ? (k0 + lane) % D : d_lane;
#pragma unroll
          for (int j = 0; j < REM_BATCH; ++j) {
            fl[j] = gfl[d];
            rq[j] = greq[d];
            d += d_step;
            d = d >= D ? d - D : d;
          }
#pragma unroll
          for (int j = 0; j < REM_BATCH; ++j) {
            if (k0 + j * 32 >= UD) break;  // the same in every lane
            const int e = k0 + j * 32 + lane;
            const bool in = e < UD;
            const unsigned miss = __ballot_sync(FULL_MASK, in && !(v[j] >= fl[j]));
            if (lane == 0) s_bad[(k0 >> 5) + j] = miss;
            if (in) {
              const double nv = v[j] - rq[j];
              s_rem[e] = nv;
              dst[e] = nv;
            }
          }
          k0 += 32 * REM_BATCH;
          if (k0 >= UD) break;
          const double* src = p.rem + static_cast<size_t>(ci) * UD;  // a row past 32 * REM_BATCH
#pragma unroll
          for (int j = 0; j < REM_BATCH; ++j) {
            const int e = k0 + j * 32 + lane;
            v[j] = e < UD ? src[e] : 0.0;
          }
        }
        __syncwarp();
        // the join's fitting uids: kept, and no dim of the old row missed
        for (int w = 0; w < WU; ++w) {
          const int u = w * 32 + lane;
          const uint32_t keep =
              (HAS_LIMITS ? s_acck[w] : s_famu[(static_cast<size_t>(c_ti) * F + f2) * WU + w]) &
              s_uv[static_cast<size_t>(ci) * WU + w];
          bool fit = u < U && ((keep >> lane) & 1u);
          for (int b = u * D, end = b + D; fit && b < end;) {
            const int off = b & 31, n = min(32 - off, end - b);
            const uint32_t m = n == 32 ? FULL_MASK : (1u << n) - 1u;
            fit = !((s_bad[b >> 5] >> off) & m);
            b += n;
          }
          const uint32_t fw = __ballot_sync(FULL_MASK, fit);
          if (lane == 0) s_uv[static_cast<size_t>(row) * WU + w] = fw;
        }
      } else if (opening) {
        const double* use = s_usage0 + sel_ti * D;
        int d = d_lane;
        for (int e = lane; e < UD; e += 32) {
          const double need = use[d] + greq[d];
          const double nv = s_ualloc[e] - need;
          s_rem[e] = nv;
          dst[e] = nv;
          d += d_step;
          d = d >= D ? d - D : d;
        }
        for (int w = 0; w < WU; ++w) {
          uint32_t word;
          if (HAS_LIMITS) {
            const int u = w * 32 + lane;
            word = __ballot_sync(FULL_MASK, u < U && s_uvt[u]);
          } else {
            word = s_ouok[(static_cast<size_t>(sel_ti) * G + g) * WU + w];
          }
          if (lane == 0) s_uv[static_cast<size_t>(row) * WU + w] = word;
        }
      }
      if (HAS_LIMITS && opening) {
        const int pl = s.sel_pl;
        for (int d = lane; d < D; d += 32) p.pool_rem[pl * D + d] = p.pool_rem[pl * D + d] - s_sub[d];
      }
      if (HAS_NODES && any_node && adv) {
        for (int d = lane; d < D; d += 32) p.node_rem[jn * D + d] = p.node_rem[jn * D + d] - greq[d];
      }
      // the committed row, for the refresh
      const int touch = join || opening;
      const int ti_row = join ? c_ti : sel_ti;
      const int fam_row = join ? f2 : (opening ? s_ofam[sel_ti * G + g] : 0);
      if (lane == 0) {
        s.touch = touch;
        s.join = join;
        s.row = row;
        s.r_ti = ti_row;
        s.r_fam = fam_row;
      }
      // the other warps refresh the row while warp 0 keeps the books
      if (!HAS_LIMITS) named_arrive(1, nt);
      // the claim's bookkeeping
      const int seq2 = touch ? seqc + 1 : seqc;
      if (touch && lane == 0) {
        const int count = join ? s_count[row] + 1 : 1;
        const int rank = join ? -seq2 : seq2;
        s_ti[row] = ti_row;
        s_fam[row] = fam_row;
        s_count[row] = count;
        s_key[row] = static_cast<long long>(count) * (1LL << 39) +
                     (static_cast<long long>(rank) + (1LL << 20)) * (1LL << 18) + row;
        s_dirty[row >> 5] |= 1u << (row & 31);
      }
      if (opening) nclaims = nclaims + 1;
      // the pod's bookkeeping; a failure requeues it (cycle detection)
      const int head2 = adv ? head + 1 : head;
      const int overflow_q = failed && tail >= p.Qcap;
      const int tail2 = failed && !overflow_q ? tail + 1 : tail;
      if (lane == 0) {
        if (HAS_NODES && adv) p.nptr[g] = any_node ? jn : p.n_nodes;
        p.pod_claim[pod] = join ? ci : (opening ? row : -1);
        p.pod_node[pod] = (HAS_NODES && any_node && adv) ? jn : -1;
        if (placed && adv) p.pod_seq[pod] = done;
        if (failed && !overflow_q) p.queue[tail] = pod;
        if (failed && adv) p.last_len[pod] = tail2 - head2;
      }
      if (placed && adv) done = done + 1;
      if (overflow_c) abort_ = SCAN_CLAIM_OVERFLOW;
      else if (overflow_q) abort_ = SCAN_QUEUE_OVERFLOW;
      stop = stop || stop_now;
      head = head2;
      tail = tail2;
      seqc = seq2;
      // the next step's pop: it continues only if this step advanced, so
      // head == the old head + 1. Then the pod is the prefetched entry (a
      // pod is queued at most once in [head, tail), so this step wrote
      // nothing of it), or else (the old head + 1 == the old tail) the pod
      // this step requeued, the only one left: its last_len, 1, equals
      // tail - head, so it stops the loop
      const int cont = head < tail && !stop && abort_ == SCAN_OK;
      if (cont) {
        steps = steps + 1;
        if (pf) {
          pod = pf_pod;
          g = pf_g;
          stop_now = pf_ll == tail - head;
        } else {
          stop_now = 1;
        }
      }
      if (lane == 0) {
        s.cont = cont;
        s.g = g;
        s.nclaims = nclaims;
      }
    } else if (!HAS_LIMITS) {
      named_sync(1, nt);  // the committed row
    }

    // -- 3. the committed row's cfit bit, for every group --
    if (HAS_LIMITS) {
      __syncthreads();  // barrier 2
      if (s.touch) {
        const int row = s.row, r_ti = s.r_ti, r_fam = s.r_fam;
        const uint32_t bit = 1u << (row & 31);
        const int rw = row >> 5;
        const uint32_t* uvr = s_uv + static_cast<size_t>(row) * WU;
        const int join = s.join;
        for (int i = tid; i < I; i += nt) {
          const uint8_t tm = join ? s_newtm[i] : s_cand[i];
          p.tm_st[static_cast<size_t>(row) * I + i] = tm;
          s_tm[i] = tm;
        }
        __syncthreads();
        // one warp per group: the uid projection of the narrowed mask
        for (int gp = warp; gp < G; gp += nw) {
          int hit = 0;
          if (s_tkind[r_fam * G + gp] != KIND_REJECT && s_tol[r_ti * G + gp]) {
            const int f2g = s_tfam[r_fam * G + gp];
            const uint8_t* fm = p.fam_mask + static_cast<size_t>(f2g) * I;
            const double* gf = s_gfloor + gp * D;
            for (int w = 0; w < WU; ++w) {
              uint32_t word = 0;
              for (int i = lane; i < I; i += 32)
                if (fm[i] && s_tm[i]) word |= p.colw[static_cast<size_t>(i) * p.WU + w];
              word = __reduce_or_sync(FULL_MASK, word) & uvr[w];
              const int u = w * 32 + lane;
              if (u < U && ((word >> lane) & 1u)) {
                bool fits = true;
                for (int d = 0; d < D; ++d) fits = fits && s_rem[u * D + d] >= gf[d];
                hit |= fits;
              }
            }
          }
          hit = __any_sync(FULL_MASK, hit);
          if (lane == 0) {
            uint32_t* word = s_cfit + static_cast<size_t>(gp) * WCP + rw;
            *word = hit ? (*word | bit) : (*word & ~bit);
          }
        }
      }
    } else if (warp != 0 && s.touch) {
      // one thread of warps 1.. per group, over the set bits of keep =
      // famu_ok & u_valid; the group's first four floors in registers, a
      // uid's dims loaded together
      const int row = s.row, r_ti = s.r_ti, r_fam = s.r_fam;
      const uint32_t bit = 1u << (row & 31);
      const int rw = row >> 5;
      const uint32_t* uvr = s_uv + static_cast<size_t>(row) * WU;
      const double NEG_INF = __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));
      for (int gp = tid - 32; gp < G; gp += nt - 32) {
        bool hit = false;
        if (s_tkind[r_fam * G + gp] != KIND_REJECT && s_tol[r_ti * G + gp]) {
          const uint32_t* fk = s_famu + (static_cast<size_t>(r_ti) * F + s_tfam[r_fam * G + gp]) * WU;
          const double* gf = s_gfloor + gp * D;
          double f[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) f[k] = k < D ? gf[k] : NEG_INF;
          for (int w = 0; w < WU && !hit; ++w) {
            uint32_t keep = fk[w] & uvr[w];
            while (keep && !hit) {
              const double* r = s_rem + (w * 32 + __ffs(keep) - 1) * D;
              keep &= keep - 1;
              bool fits = true;
#pragma unroll
              for (int k = 0; k < 4; ++k) fits &= (k < D ? r[k] : 0.0) >= f[k];
              for (int d = 4; d < D && fits; ++d) fits = r[d] >= gf[d];
              hit = fits;
            }
          }
        }
        uint32_t* word = s_cfit + static_cast<size_t>(gp) * WCP + rw;
        *word = hit ? (*word | bit) : (*word & ~bit);
      }
    }
    __syncthreads();  // barrier 3
  }

  // -- the claim state back to the caller's buffers --
  if (tid == 0) {
    p.scal[0] = head;
    p.scal[1] = tail;
    p.scal[2] = stop;
    p.scal[3] = abort_;
    p.scal[4] = seqc;
    p.scal[5] = done;
    p.scal[6] = nclaims;
    p.scal[7] = steps;  // loop iterations, read by the caller
  }
  for (int c = tid; c < C; c += nt) {
    if (full || ((s_dirty[c >> 5] >> (c & 31)) & 1u)) {
      p.claim_ti[c] = s_ti[c];
      p.claim_fam[c] = s_fam[c];
      p.claim_count[c] = s_count[c];
      p.claim_key[c] = s_key[c];
    }
  }
  bits_to_bytes(p.u_valid, C, U, s_uv, WU, false, full, s_dirty);
  bits_to_bytes(p.cfit, C, G, s_cfit, WCP, true, full, s_dirty);
}

template <bool HAS_NODES, bool HAS_LIMITS, int MAX_THREADS>
int launch_resident_bounded(const ScanParams& p, size_t shmem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(solve_scan_resident_kernel<HAS_NODES, HAS_LIMITS, MAX_THREADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  solve_scan_resident_kernel<HAS_NODES, HAS_LIMITS, MAX_THREADS><<<1, p.threads, shmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool HAS_NODES, bool HAS_LIMITS>
int launch_resident(const ScanParams& p, cudaStream_t stream) {
  const ResLayout L = res_layout(p.C, p.G, p.U, p.D, p.T, p.F, p.I, HAS_LIMITS);
  if (L.total + RES_STATIC_RESERVE > SMEM_PER_BLOCK || p.F > 32767 || p.threads < 64 ||
      p.threads > RES_MAX_THREADS || p.threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return p.threads <= 512 ? launch_resident_bounded<HAS_NODES, HAS_LIMITS, 512>(p, L.total, stream)
                          : launch_resident_bounded<HAS_NODES, HAS_LIMITS, RES_MAX_THREADS>(p, L.total, stream);
}

}  // namespace

extern "C" {

// ptrs: the 24 operand pointers (the reference order, less claim_pad,
// n_pods and n_nodes), the 17 state pointers and the colw scratch, as in
// ScanParams; dims: P, G, C, U, D, F, T, N, I, L, Qcap, WU, n_pods, n_nodes,
// has_nodes, has_limits, mode (0 full, 1 resume), p_lo, design (0 global,
// 1 resident), threads. Returns the launch's cudaError_t; a resident launch
// whose set does not fit, or with a block size that is not a multiple of 32
// up to 1024, is refused (cudaErrorInvalidValue) and never runs.
constexpr int N_PTRS = 42, N_DIMS = 20;
static_assert(offsetof(ScanParams, P) == N_PTRS * sizeof(void*), "ScanParams: pointers first");
static_assert(offsetof(ScanParams, threads) == N_PTRS * sizeof(void*) + (N_DIMS - 1) * sizeof(int),
              "ScanParams: threads is the last int");
static_assert(sizeof(ScanParams) == N_PTRS * sizeof(void*) + N_DIMS * sizeof(int),
              "ScanParams: 42 pointers then 20 ints");

int kt_solve_scan(void* const* ptrs, const int* dims, void* stream) {
  ScanParams p;
  void** f = reinterpret_cast<void**>(&p);
  for (int k = 0; k < N_PTRS; ++k) f[k] = ptrs[k];
  int* d = &p.P;
  for (int k = 0; k < N_DIMS; ++k) d[k] = dims[k];
  if (p.mode != MODE_FULL && p.mode != MODE_RESUME) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.design == DESIGN_RESIDENT) {
    if (p.has_nodes) {
      return p.has_limits ? launch_resident<true, true>(p, st) : launch_resident<true, false>(p, st);
    }
    return p.has_limits ? launch_resident<false, true>(p, st) : launch_resident<false, false>(p, st);
  }
  if (p.design != DESIGN_GLOBAL) return static_cast<int>(cudaErrorInvalidValue);
  if (p.has_nodes) {
    return p.has_limits ? launch<true, true>(p, st) : launch<true, false>(p, st);
  }
  return p.has_limits ? launch<false, true>(p, st) : launch<false, false>(p, st);
}

// The resident design's dynamic shared memory in bytes for dims C, G, U, D,
// T, F, I, has_limits (ops/packer.py scan_resident_bytes must agree).
long long kt_scan_resident_bytes(const int* dims) {
  return static_cast<long long>(
      res_layout(dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7] != 0).total);
}

}  // extern "C"
