// Native steady-state driver for the device-accelerated FFD simulation
// (ops/ffd.py). The per-pod queue loop — per-group lazy heaps over in-flight
// claims, fit checks against each claim's remaining-headroom rows, permanent
// monotone rejections, family-transition application — runs here at ~100ns
// per pod; Python is re-entered only for events that need requirement
// algebra: a (family, group) transition miss, a new-claim opening, or an
// existing-node join. Both sides replay the exact float64 operations of the
// Python loop (IEEE semantics are identical), so decision parity with the
// host oracle (reference scheduler.go:346-401) is preserved bit-for-bit;
// the parity fuzz in tests/test_device_parity.py exercises this path.
//
// Control protocol: kt_run() executes until DONE / TIMEOUT or an action that
// needs Python, communicated via an out[] vector; Python installs the result
// (kt_set_tol / kt_set_join / kt_add_claim / kt_resolve_*) and calls
// kt_run() again — the claims scan restarts for the current pod, which is
// safe because every partial effect (popping stale or dropped heap entries)
// is idempotent.

#include <cstdint>
#include <cstring>
#include <ctime>
#include <unordered_map>
#include <vector>

using std::int32_t;
using std::int64_t;
using std::uint64_t;
using std::uint8_t;

namespace {

constexpr int ACT_DONE = 0;
constexpr int ACT_NEED_TOL = 1;      // out: [pod, gi, ci, ti]
constexpr int ACT_NEED_JOIN = 2;     // out: [pod, gi, ci, fam]
constexpr int ACT_NEED_NEW_CLAIM = 3;  // out: [pod, gi]
constexpr int ACT_NEED_NODES = 4;    // out: [pod, gi]
constexpr int ACT_TIMEOUT = 5;       // out: [head]
constexpr int ACT_ERROR = 6;

constexpr int8_t TOL_UNKNOWN = 0, TOL_OK = 1, TOL_NO = 2;
constexpr int8_t JOIN_REJECT = 1, JOIN_SAME = 2, JOIN_NARROW = 3;

struct HeapItem {
  int64_t count;
  int64_t rank;
  int32_t ci;
};

inline bool heap_less(const HeapItem& a, const HeapItem& b) {
  if (a.count != b.count) return a.count < b.count;
  if (a.rank != b.rank) return a.rank < b.rank;
  return a.ci < b.ci;
}

struct Heap {
  std::vector<HeapItem> v;

  void sift_up(size_t i) {
    while (i > 0) {
      size_t p = (i - 1) / 2;
      if (heap_less(v[i], v[p])) {
        std::swap(v[i], v[p]);
        i = p;
      } else {
        break;
      }
    }
  }
  void sift_down(size_t i) {
    size_t n = v.size();
    for (;;) {
      size_t l = 2 * i + 1, r = l + 1, s = i;
      if (l < n && heap_less(v[l], v[s])) s = l;
      if (r < n && heap_less(v[r], v[s])) s = r;
      if (s == i) break;
      std::swap(v[i], v[s]);
      i = s;
    }
  }
  void push(HeapItem it) {
    v.push_back(it);
    sift_up(v.size() - 1);
  }
  void pop() {
    v[0] = v.back();
    v.pop_back();
    if (!v.empty()) sift_down(0);
  }
  void replace(HeapItem it) {
    v[0] = it;
    sift_down(0);
  }
};

struct Claim {
  int32_t ti;
  int32_t fam;
  int64_t count;
  int64_t rank;
  int32_t M;                    // live unique-alloc rows
  std::vector<double> rem;      // [M, D] row-major headroom
  std::vector<int32_t> u_ids;   // [M]
  std::vector<uint64_t> type_mask;  // [W] bit per instance type
  std::vector<uint8_t> gdrop;   // [G]
  std::vector<uint8_t> gknown;  // [G]
  std::vector<int32_t> members;      // pod indices, join order
  std::vector<int32_t> group_count;  // [G]
  std::vector<int32_t> group_order;  // first-join order of groups
};

struct FamEnt {
  int8_t kind;
  int32_t new_fam;
  std::vector<uint64_t> mask;  // NARROW only: combined compat∧offer bits [W]
};

struct Ctx {
  int32_t P, G, D, U, W;
  std::vector<int32_t> qpods;   // pod indices; retries appended
  int64_t head;
  std::vector<int32_t> pod_group;   // [P]
  std::vector<double> g_req;        // [G*D]
  std::vector<double> g_fit;        // [G*D] fit floors (req - eps)
  std::vector<int32_t> g_ndim;      // [G] nonzero request dims
  std::vector<int32_t> g_didx;      // [G*D] their indices (first g_ndim)
  std::vector<int64_t> last_len;    // [P]
  std::vector<uint8_t> pod_failed;  // [P]
  std::vector<uint64_t> utype_mask;  // [U*W] types per unique-alloc row
  std::vector<Claim> claims;
  std::vector<Heap> heaps;          // [G]
  std::vector<int64_t> gsynced;     // [G]
  std::vector<int8_t> tol;          // [T*G]
  int32_t T;
  std::unordered_map<int64_t, FamEnt> fam_join;
  int64_t seq;
  uint8_t nodes_active;
  std::vector<uint8_t> g_nodes_done;  // [G]
  double deadline;  // CLOCK_MONOTONIC seconds; <0 → none
  int64_t check;    // pods processed since last deadline poll (spans up-calls)
  uint8_t timed_out;
  // resume state: pod currently mid-claims-scan (or -1)
  int32_t cur_pod;
  uint8_t cur_try_nodes_done;
  // scratch
  std::vector<uint8_t> fitrows;
};

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

// returns: 1 placed, 0 not placed, -1 action pending (ctx->act filled)
int try_claims(Ctx* c, int32_t pod, int32_t gi, int64_t* out, int* act) {
  Heap& heap = c->heaps[gi];
  // lazy sync of claims opened since this group last looked
  int64_t n = int64_t(c->claims.size());
  for (int64_t ci = c->gsynced[gi]; ci < n; ++ci) {
    const Claim& cl = c->claims[ci];
    heap.push({cl.count, cl.rank, int32_t(ci)});
  }
  c->gsynced[gi] = n;

  const double* req = &c->g_req[size_t(gi) * c->D];
  const double* fit = &c->g_fit[size_t(gi) * c->D];
  const int D = c->D, W = c->W;
  // zero-request dims always pass the fit floor (headroom there is
  // >= -eps from claim open and never shrinks), so loops touch only the
  // group's nonzero dims — bit-identical, ~2x fewer double ops
  const int nd = c->g_ndim[gi];
  const int32_t* didx = &c->g_didx[size_t(gi) * c->D];

  while (!heap.v.empty()) {
    HeapItem top = heap.v[0];
    Claim& cl = c->claims[top.ci];
    if (cl.gdrop[gi]) {
      heap.pop();
      continue;
    }
    if (cl.count != top.count || cl.rank != top.rank) {
      heap.replace({cl.count, cl.rank, top.ci});
      continue;
    }
    std::vector<uint8_t>& fitrows = c->fitrows;
    fitrows.assign(size_t(cl.M), 0);
    bool any = false, all = true;
    if (cl.gknown[gi]) {
      for (int32_t r = 0; r < cl.M; ++r) {
        const double* rem = &cl.rem[size_t(r) * D];
        bool ok = true;
        for (int k = 0; k < nd; ++k) {
          int d = didx[k];
          if (!(rem[d] >= fit[d])) {
            ok = false;
            break;
          }
        }
        fitrows[r] = ok;
        any |= ok;
        all &= ok;
      }
      if (!any) {
        cl.gdrop[gi] = 1;
        heap.pop();
        continue;
      }
    } else {
      // first join of this group onto this claim: tolerance gate, then the
      // memoized family transition
      int8_t t = c->tol[size_t(cl.ti) * c->G + gi];
      if (t == TOL_UNKNOWN) {
        out[0] = pod;
        out[1] = gi;
        out[2] = top.ci;
        out[3] = cl.ti;
        *act = ACT_NEED_TOL;
        return -1;
      }
      if (t == TOL_NO) {
        cl.gdrop[gi] = 1;
        heap.pop();
        continue;
      }
      int64_t key = (int64_t(cl.fam) << 32) | uint32_t(gi);
      auto it = c->fam_join.find(key);
      if (it == c->fam_join.end()) {
        out[0] = pod;
        out[1] = gi;
        out[2] = top.ci;
        out[3] = cl.fam;
        *act = ACT_NEED_JOIN;
        return -1;
      }
      const FamEnt& ent = it->second;
      if (ent.kind == JOIN_REJECT) {
        cl.gdrop[gi] = 1;
        heap.pop();
        continue;
      }
      if (ent.kind == JOIN_NARROW) {
        // candidate narrowed mask; keep rows whose unique-alloc id still has
        // a surviving type, then fit-check — mirrors _try_first_join exactly
        std::vector<uint64_t> new_mask((size_t)W, 0);
        for (int w = 0; w < W; ++w)
          new_mask[w] = cl.type_mask[w] & ent.mask[w];
        std::vector<uint8_t> keep(size_t(cl.M), 0);
        any = false;
        for (int32_t r = 0; r < cl.M; ++r) {
          const uint64_t* um = &c->utype_mask[size_t(cl.u_ids[r]) * W];
          bool kr = false;
          for (int w = 0; w < W; ++w) {
            if (new_mask[w] & um[w]) {
              kr = true;
              break;
            }
          }
          keep[r] = kr;
          bool ok = kr;
          if (ok) {
            const double* rem = &cl.rem[size_t(r) * D];
            for (int k = 0; k < nd; ++k) {
              int d = didx[k];
              if (!(rem[d] >= fit[d])) {
                ok = false;
                break;
              }
            }
          }
          fitrows[r] = ok;
          any |= ok;
        }
        if (!any) {
          cl.gdrop[gi] = 1;
          heap.pop();
          continue;
        }
        // commit narrowing: compact to keep, fitrows follows
        int32_t m2 = 0;
        for (int32_t r = 0; r < cl.M; ++r) {
          if (keep[r]) {
            if (m2 != r) {
              std::memcpy(&cl.rem[size_t(m2) * D], &cl.rem[size_t(r) * D],
                          sizeof(double) * D);
              cl.u_ids[m2] = cl.u_ids[r];
            }
            fitrows[m2] = fitrows[r];
            ++m2;
          }
        }
        cl.M = m2;
        cl.rem.resize(size_t(m2) * D);
        cl.u_ids.resize(size_t(m2));
        fitrows.resize(size_t(m2));
        cl.type_mask = std::move(new_mask);
        cl.fam = ent.new_fam;
        cl.gknown[gi] = 1;
        any = all = true;
        for (int32_t r = 0; r < m2; ++r) {
          if (!fitrows[r]) {
            all = false;
            break;
          }
        }
      } else {  // JOIN_SAME
        any = false;
        all = true;
        for (int32_t r = 0; r < cl.M; ++r) {
          const double* rem = &cl.rem[size_t(r) * D];
          bool ok = true;
          for (int k = 0; k < nd; ++k) {
            int d = didx[k];
            if (!(rem[d] >= fit[d])) {
              ok = false;
              break;
            }
          }
          fitrows[r] = ok;
          any |= ok;
          all &= ok;
        }
        if (!any) {
          cl.gdrop[gi] = 1;
          heap.pop();
          continue;
        }
        cl.gknown[gi] = 1;
      }
    }
    // join: subtract the request; rows that no longer fit die permanently
    if (all) {
      for (int32_t r = 0; r < cl.M; ++r) {
        double* rem = &cl.rem[size_t(r) * D];
        for (int k = 0; k < nd; ++k) rem[didx[k]] -= req[didx[k]];
      }
    } else {
      int32_t m2 = 0;
      for (int32_t r = 0; r < cl.M; ++r) {
        if (fitrows[r]) {
          if (m2 != r) {
            std::memcpy(&cl.rem[size_t(m2) * D], &cl.rem[size_t(r) * D],
                        sizeof(double) * D);
            cl.u_ids[m2] = cl.u_ids[r];
          }
          ++m2;
        }
      }
      cl.M = m2;
      cl.rem.resize(size_t(m2) * D);
      cl.u_ids.resize(size_t(m2));
      for (int32_t r = 0; r < m2; ++r) {
        double* rem = &cl.rem[size_t(r) * D];
        for (int k = 0; k < nd; ++k) rem[didx[k]] -= req[didx[k]];
      }
    }
    cl.count = top.count + 1;
    c->seq += 1;
    cl.rank = -c->seq;
    cl.members.push_back(pod);
    if (cl.group_count[gi] == 0) cl.group_order.push_back(gi);
    cl.group_count[gi] += 1;
    heap.replace({cl.count, cl.rank, top.ci});
    return 1;
  }
  return 0;
}

}  // namespace

extern "C" {

Ctx* kt_new(int32_t P, int32_t G, int32_t D, int32_t U, int32_t W, int32_t T,
            const int32_t* pod_group, const double* g_req, const double* g_fit,
            const int32_t* g_ndim, const int32_t* g_didx,
            const uint64_t* utype_mask, uint8_t nodes_active,
            double timeout_s) {
  Ctx* c = new (std::nothrow) Ctx();
  if (!c) return nullptr;
  c->P = P;
  c->G = G;
  c->D = D;
  c->U = U;
  c->W = W;
  c->T = T;
  c->qpods.reserve(size_t(P) + 64);
  for (int32_t i = 0; i < P; ++i) c->qpods.push_back(i);
  c->head = 0;
  c->pod_group.assign(pod_group, pod_group + P);
  c->g_req.assign(g_req, g_req + size_t(G) * D);
  c->g_fit.assign(g_fit, g_fit + size_t(G) * D);
  c->g_ndim.assign(g_ndim, g_ndim + G);
  c->g_didx.assign(g_didx, g_didx + size_t(G) * D);
  c->last_len.assign(size_t(P), -1);
  c->pod_failed.assign(size_t(P), 0);
  c->utype_mask.assign(utype_mask, utype_mask + size_t(U) * W);
  c->heaps.resize(size_t(G));
  c->gsynced.assign(size_t(G), 0);
  c->tol.assign(size_t(T) * G, TOL_UNKNOWN);
  c->seq = 0;
  c->nodes_active = nodes_active;
  c->g_nodes_done.assign(size_t(G), nodes_active ? 0 : 1);
  c->deadline = timeout_s >= 0 ? now_s() + timeout_s : -1.0;
  c->check = 0;
  c->timed_out = 0;
  c->cur_pod = -1;
  c->cur_try_nodes_done = 0;
  return c;
}

void kt_free(Ctx* c) { delete c; }

void kt_set_tol(Ctx* c, int32_t ti, int32_t gi, uint8_t ok) {
  c->tol[size_t(ti) * c->G + gi] = ok ? TOL_OK : TOL_NO;
}

void kt_set_join(Ctx* c, int32_t fam, int32_t gi, int8_t kind, int32_t new_fam,
                 const uint64_t* mask) {
  FamEnt ent;
  ent.kind = kind;
  ent.new_fam = new_fam;
  if (kind == JOIN_NARROW) ent.mask.assign(mask, mask + c->W);
  c->fam_join.emplace((int64_t(fam) << 32) | uint32_t(gi), std::move(ent));
}

// Register a freshly opened claim (Python ran _new_claim). Mirrors _Claim
// construction: count=1, rank=+seq (fresh claims tie-break in opening order),
// the opening pod already a member.
int32_t kt_add_claim(Ctx* c, int32_t ti, int32_t fam, int32_t pod, int32_t gi,
                     const uint64_t* type_mask, const int32_t* u_ids,
                     const double* rem, int32_t M) {
  Claim cl;
  cl.ti = ti;
  cl.fam = fam;
  c->seq += 1;
  cl.count = 1;
  cl.rank = c->seq;
  cl.M = M;
  cl.rem.assign(rem, rem + size_t(M) * c->D);
  cl.u_ids.assign(u_ids, u_ids + M);
  cl.type_mask.assign(type_mask, type_mask + c->W);
  cl.gdrop.assign(size_t(c->G), 0);
  cl.gknown.assign(size_t(c->G), 0);
  cl.gknown[gi] = 1;
  cl.members.push_back(pod);
  cl.group_count.assign(size_t(c->G), 0);
  cl.group_count[gi] = 1;
  cl.group_order.push_back(gi);
  c->claims.push_back(std::move(cl));
  return int32_t(c->claims.size()) - 1;
}

void kt_set_nodes_done(Ctx* c, int32_t gi) { c->g_nodes_done[gi] = 1; }

// outcome of a Python-resolved step for the CURRENT pod:
//   0 — not resolved, continue the pipeline (e.g. node try failed → claims)
//   1 — pod placed (on a node, or via kt_add_claim)
//   2 — pod failed (new-claim error): append to retry queue
void kt_resolve(Ctx* c, int32_t outcome) {
  int32_t pod = c->cur_pod;
  if (pod < 0) return;
  if (outcome == 1) {
    c->pod_failed[pod] = 0;
    c->cur_pod = -1;
    c->cur_try_nodes_done = 0;
  } else if (outcome == 2) {
    c->pod_failed[pod] = 1;
    c->qpods.push_back(pod);
    c->last_len[pod] = int64_t(c->qpods.size()) - c->head;
    c->cur_pod = -1;
    c->cur_try_nodes_done = 0;
  } else {
    c->cur_try_nodes_done = 1;  // nodes tried, fall through to claims
  }
}

int kt_run(Ctx* c, int64_t* out) {
  for (;;) {
    int32_t pod;
    int32_t gi;
    if (c->cur_pod >= 0) {
      pod = c->cur_pod;
      gi = c->pod_group[pod];
    } else {
      if (c->head >= int64_t(c->qpods.size())) return ACT_DONE;
      pod = c->qpods[c->head];
      if (c->last_len[pod] == int64_t(c->qpods.size()) - c->head)
        return ACT_DONE;  // no progress since this pod last failed
      if (c->deadline >= 0 && (++c->check & 0x1FF) == 0 && now_s() > c->deadline) {
        c->timed_out = 1;
        out[0] = c->head;
        return ACT_TIMEOUT;
      }
      c->head += 1;
      c->cur_pod = pod;
      c->cur_try_nodes_done = 0;
      gi = c->pod_group[pod];
    }
    if (c->nodes_active && !c->g_nodes_done[gi] && !c->cur_try_nodes_done) {
      out[0] = pod;
      out[1] = gi;
      return ACT_NEED_NODES;
    }
    int act = 0;
    int r = try_claims(c, pod, gi, out, &act);
    if (r < 0) return act;  // cur_pod stays set; scan restarts on re-entry
    if (r == 1) {
      c->pod_failed[pod] = 0;
      c->cur_pod = -1;
      c->cur_try_nodes_done = 0;
      continue;
    }
    // no claim took it → Python opens a new claim or records the error
    out[0] = pod;
    out[1] = gi;
    return ACT_NEED_NEW_CLAIM;
  }
}

uint8_t kt_timed_out(Ctx* c) { return c->timed_out; }
int64_t kt_head(Ctx* c) { return c->head; }
int64_t kt_queue_len(Ctx* c) { return int64_t(c->qpods.size()); }
void kt_queue_tail(Ctx* c, int64_t from, int32_t* dst) {
  for (int64_t i = from; i < int64_t(c->qpods.size()); ++i)
    dst[i - from] = c->qpods[i];
}
void kt_failed(Ctx* c, uint8_t* dst) {
  std::memcpy(dst, c->pod_failed.data(), size_t(c->P));
}

int32_t kt_num_claims(Ctx* c) { return int32_t(c->claims.size()); }

// bulk readback for emit: one call sizes everything, one call fills the
// caller's flat buffers (per-claim calls cost ~509 x 5 ctypes round trips)
void kt_export_sizes(Ctx* c, int64_t* out) {
  int64_t u = 0, m = 0, g = 0;
  for (const Claim& cl : c->claims) {
    u += cl.M;
    m += int64_t(cl.members.size());
    g += int64_t(cl.group_order.size());
  }
  out[0] = int64_t(c->claims.size());
  out[1] = u;
  out[2] = m;
  out[3] = g;
}

// info layout per claim: [ti, fam, count, M, n_members, n_groups]
void kt_export(Ctx* c, int64_t* info, uint64_t* type_masks, int32_t* u_ids,
               int32_t* members, int32_t* groups, int32_t* counts) {
  int64_t ui = 0, mi = 0, gi2 = 0;
  for (size_t ci = 0; ci < c->claims.size(); ++ci) {
    const Claim& cl = c->claims[ci];
    int64_t* row = info + ci * 6;
    row[0] = cl.ti;
    row[1] = cl.fam;
    row[2] = cl.count;
    row[3] = cl.M;
    row[4] = int64_t(cl.members.size());
    row[5] = int64_t(cl.group_order.size());
    std::memcpy(type_masks + ci * c->W, cl.type_mask.data(),
                sizeof(uint64_t) * c->W);
    std::memcpy(u_ids + ui, cl.u_ids.data(), sizeof(int32_t) * cl.M);
    ui += cl.M;
    std::memcpy(members + mi, cl.members.data(),
                sizeof(int32_t) * cl.members.size());
    mi += int64_t(cl.members.size());
    for (int32_t g : cl.group_order) {
      groups[gi2] = g;
      counts[gi2] = cl.group_count[g];
      ++gi2;
    }
  }
}

}  // extern "C"
