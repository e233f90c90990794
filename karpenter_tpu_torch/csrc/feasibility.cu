// The batched feasibility sweep of the provisioning solve, written by hand
// for Hopper (sm_90a). Built by karpenter_tpu_torch/device.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// wrappers, their checks and the plain torch versions the kernels are held
// against live in karpenter_tpu_torch/ops/feasibility.py.
//
// What each kernel replaces (the JAX device programs of the reference):
//   kt_row_compat  <- karpenter_tpu/ops/feasibility.py:48 req_rows_vs_sets
//                     (kernel name catalog.row_compat)
//   kt_membership  <- karpenter_tpu/ops/feasibility.py:177 membership_all,
//                     and the compat half of _cube_math (:265)
//   kt_cube_offer  <- karpenter_tpu/ops/feasibility.py:265 _cube_math /
//                     production_cube, the offering half
//
// These are boolean reductions, not float math. The JAX package counts bad
// rows with an f32 matmul and thresholds at 0.5; here every test is exact
// bit logic on packed uint32 words, so there is no threshold and no rounding.
//
// What bounds them on this card: at the solve's shapes (P=256 entities,
// R<=128 rows, 1008 types, 8064 offerings, W=8 mask words) each call moves
// well under 3 MB, which is under a microsecond at 3.35 TB/s. They are bound
// by launch latency and by the re-reads of the compat matrices from L2,
// not by device memory or arithmetic. The design keeps each call to one
// launch per output, packs the R axis 32 rows to a word so one AND tests 32
// rows, and tiles 32 entities per thread so a column of the compat matrix is
// read once per 32 entities instead of once per entity.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NO_GT = INT32_MIN;    // encoding.NO_GT: no lower bound
constexpr int32_t NO_LT = INT32_MAX;    // encoding.NO_LT: no upper bound
constexpr int32_t NOT_INT = INT32_MIN;  // encoding.NOT_INT: non-integer slot
constexpr int TILE = 32;                // entities per thread (one bit each)
constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// B1: compat[r, n] — does requirement row r intersect set n on r's key?
//
// One block per (row, 256 sets). The row's candidate slots — its value mask,
// complemented for NotIn/DoesNotExist rows, restricted to the slots of its
// own key — are built once per block in shared memory. Padding slots carry
// slot_key = -1 (encoding.Vocab.tables), so the key restriction clears the
// bits a complement sets there. Each thread then ANDs those words with its
// set's (complemented) mask word by word; only when a Gt/Lt bound is in
// force does it walk the surviving slots and test value_int against the
// merged bounds. Semantics: requirement.go HasIntersection and the
// NotIn/DoesNotExist exemption of requirements.go Intersects.
__global__ void row_compat_kernel(
    const int32_t* __restrict__ row_key, const uint8_t* __restrict__ row_comp,
    const uint8_t* __restrict__ row_hasv, const int32_t* __restrict__ row_gt,
    const int32_t* __restrict__ row_lt, const uint32_t* __restrict__ row_mask,
    const uint8_t* __restrict__ set_present, const uint8_t* __restrict__ set_comp,
    const uint8_t* __restrict__ set_hasv, const int32_t* __restrict__ set_gt,
    const int32_t* __restrict__ set_lt, const uint32_t* __restrict__ set_mask,
    const int32_t* __restrict__ slot_key, const int32_t* __restrict__ value_int,
    uint8_t* __restrict__ out, int R, int N, int K, int W) {
  extern __shared__ uint32_t a_words[];  // [W]
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const int32_t k = row_key[r];
    const bool rc = row_comp[r] != 0;
    __syncthreads();  // a_words of the previous row are no longer read
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      uint32_t keymask = 0;
      for (int b = 0; b < 32; ++b)
        keymask |= static_cast<uint32_t>(slot_key[w * 32 + b] == k) << b;
      const uint32_t m = row_mask[static_cast<size_t>(r) * W + w];
      a_words[w] = (rc ? ~m : m) & keymask;
    }
    __syncthreads();
    if (n >= N) continue;
    const size_t nk = static_cast<size_t>(n) * K + k;
    uint8_t res;
    if (!set_present[nk]) {
      res = 1;  // a key the set does not constrain is compatible
    } else {
      const bool sc = set_comp[nk] != 0;
      const bool rhv = row_hasv[r] != 0;
      const bool shv = set_hasv[nk] != 0;
      const bool row_exempt = rc ? rhv : !rhv;
      const bool set_exempt = sc ? shv : !shv;
      if (row_exempt && set_exempt) {
        res = 1;
      } else {
        const int32_t g = max(row_gt[r], set_gt[nk]);
        const int32_t l = min(row_lt[r], set_lt[nk]);
        if (g != NO_GT && l != NO_LT && g >= l) {
          res = 0;  // empty integer range
        } else if (rc && sc) {
          res = 1;  // two complements always intersect (open world)
        } else {
          const bool unbounded = g == NO_GT && l == NO_LT;
          const uint32_t* sm = set_mask + static_cast<size_t>(n) * W;
          bool any = false;
          for (int w = 0; w < W && !any; ++w) {
            const uint32_t m = sm[w];
            uint32_t c = a_words[w] & (sc ? ~m : m);
            if (unbounded) {
              any = c != 0;
            } else {
              while (c) {
                const int b = __ffs(c) - 1;
                c &= c - 1;
                const int32_t v = value_int[w * 32 + b];
                if (v != NOT_INT && v > g && v < l) {
                  any = true;
                  break;
                }
              }
            }
          }
          res = any;
        }
      }
    }
    out[static_cast<size_t>(r) * N + n] = res;
  }
}

// ---------------------------------------------------------------------------
// B2: out[p, n] = every row of entity p is compatible with target n.
//
// One thread per (target n, tile of 32 entities). Rows are walked 32 at a
// time: the first 32 threads pack the tile's membership bits for those rows
// into shared memory, every thread packs the 32 incompatibility bits of its
// own column (~ok[r, n]), and one AND per entity tests all 32 rows at once.
// Reads of `ok` are coalesced across the warp (consecutive n).
__global__ void membership_kernel(const uint8_t* __restrict__ mem,
                                  const uint8_t* __restrict__ ok,
                                  uint8_t* __restrict__ out, int P, int R,
                                  int N) {
  __shared__ uint32_t memw[TILE];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int p0 = blockIdx.y * TILE;
  uint32_t bad = 0;  // bit j: entity p0 + j has a row incompatible with n
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int rn = min(32, R - r0);
    __syncthreads();
    if (threadIdx.x < TILE) {
      const int p = p0 + threadIdx.x;
      uint32_t w = 0;
      if (p < P) {
        const uint8_t* mp = mem + static_cast<size_t>(p) * R + r0;
        for (int b = 0; b < rn; ++b) w |= static_cast<uint32_t>(mp[b] != 0) << b;
      }
      memw[threadIdx.x] = w;
    }
    __syncthreads();
    if (n < N) {
      uint32_t badw = 0;
      for (int b = 0; b < rn; ++b)
        badw |= static_cast<uint32_t>(ok[static_cast<size_t>(r0 + b) * N + n] == 0) << b;
      if (badw) {
        for (int j = 0; j < TILE; ++j)
          bad |= static_cast<uint32_t>((memw[j] & badw) != 0) << j;
      }
    }
  }
  if (n < N) {
    const int pn = min(TILE, P - p0);
    for (int j = 0; j < pn; ++j)
      out[static_cast<size_t>(p0 + j) * N + n] = !((bad >> j) & 1u);
  }
}

// ---------------------------------------------------------------------------
// B3, offering half: has_offering[p, i] = some offering o of type i is
// available, every row of p is compatible with o, and p defines every
// custom key o needs (the undefined-label rule of requirements.go
// Compatible).
//
// The JAX program any-reduces offerings onto their owners with a one-hot
// [O, I] matmul thresholded at 0.5. Every offering has exactly one owner,
// so that is the OR over the offerings whose owner is i; here it is done by
// owner index with no atomics: the engine stores offerings owner-major
// (offering_owner is non-decreasing, checked when the catalog is encoded),
// so one thread per (type i, tile of 32 entities) finds its type's
// contiguous offering range by binary search and ORs over it. The tile's
// membership words (all rows) and missing-key words are packed into shared
// memory once per block.
__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void cube_offer_kernel(
    const uint8_t* __restrict__ mem, const uint8_t* __restrict__ offer_ok,
    const uint8_t* __restrict__ custom_need, const uint8_t* __restrict__ key_present,
    const uint8_t* __restrict__ available, const int32_t* __restrict__ owner,
    uint8_t* __restrict__ out, int P, int R, int O, int K, int I) {
  extern __shared__ uint32_t smem[];
  const int WR = (R + 31) / 32;
  const int WK = (K + 31) / 32;
  uint32_t* memw = smem;               // [TILE][WR] row-membership bits
  uint32_t* absw = smem + TILE * WR;   // [TILE][WK] keys the entity lacks
  const int p0 = blockIdx.y * TILE;
  for (int idx = threadIdx.x; idx < TILE * WR; idx += blockDim.x) {
    const int j = idx / WR, w = idx % WR, p = p0 + j;
    uint32_t bits = 0;
    if (p < P) {
      const int rn = min(32, R - w * 32);
      const uint8_t* mp = mem + static_cast<size_t>(p) * R + w * 32;
      for (int b = 0; b < rn; ++b) bits |= static_cast<uint32_t>(mp[b] != 0) << b;
    }
    memw[idx] = bits;
  }
  for (int idx = threadIdx.x; idx < TILE * WK; idx += blockDim.x) {
    const int j = idx / WK, w = idx % WK, p = p0 + j;
    uint32_t bits = 0;
    if (p < P) {
      const int kn = min(32, K - w * 32);
      const uint8_t* kp = key_present + static_cast<size_t>(p) * K + w * 32;
      for (int b = 0; b < kn; ++b) bits |= static_cast<uint32_t>(kp[b] == 0) << b;
    }
    absw[idx] = bits;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I) return;
  const int lo = lower_bound(owner, O, i);
  const int hi = lower_bound(owner, O, i + 1);
  uint32_t has = 0;  // bit j: entity p0 + j has a usable offering of type i
  for (int o = lo; o < hi; ++o) {
    if (!available[o]) continue;
    uint32_t okp = 0xffffffffu;
    for (int w = 0; w < WR && okp; ++w) {
      const int rn = min(32, R - w * 32);
      uint32_t badw = 0;
      for (int b = 0; b < rn; ++b)
        badw |= static_cast<uint32_t>(offer_ok[static_cast<size_t>(w * 32 + b) * O + o] == 0) << b;
      if (badw) {
        for (int j = 0; j < TILE; ++j)
          if (memw[j * WR + w] & badw) okp &= ~(1u << j);
      }
    }
    for (int w = 0; w < WK && okp; ++w) {
      const int kn = min(32, K - w * 32);
      const uint8_t* cn = custom_need + static_cast<size_t>(o) * K + w * 32;
      uint32_t need = 0;
      for (int b = 0; b < kn; ++b) need |= static_cast<uint32_t>(cn[b] != 0) << b;
      if (need) {
        for (int j = 0; j < TILE; ++j)
          if (absw[j * WK + w] & need) okp &= ~(1u << j);
      }
    }
    has |= okp;
  }
  const int pn = min(TILE, P - p0);
  for (int j = 0; j < pn; ++j)
    out[static_cast<size_t>(p0 + j) * I + i] = (has >> j) & 1u;
}

constexpr int MAX_GRID_Y = 65535;

}  // namespace

extern "C" {

int kt_row_compat(const void* row_key, const void* row_comp, const void* row_hasv,
                  const void* row_gt, const void* row_lt, const void* row_mask,
                  const void* set_present, const void* set_comp,
                  const void* set_hasv, const void* set_gt, const void* set_lt,
                  const void* set_mask, const void* slot_key,
                  const void* value_int, void* out, int R, int N, int K, int W,
                  void* stream) {
  if (R == 0 || N == 0) return 0;
  const dim3 block(256);
  const dim3 grid((N + 255) / 256, R < MAX_GRID_Y ? R : MAX_GRID_Y);
  row_compat_kernel<<<grid, block, W * sizeof(uint32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_key), static_cast<const uint8_t*>(row_comp),
      static_cast<const uint8_t*>(row_hasv), static_cast<const int32_t*>(row_gt),
      static_cast<const int32_t*>(row_lt), static_cast<const uint32_t*>(row_mask),
      static_cast<const uint8_t*>(set_present), static_cast<const uint8_t*>(set_comp),
      static_cast<const uint8_t*>(set_hasv), static_cast<const int32_t*>(set_gt),
      static_cast<const int32_t*>(set_lt), static_cast<const uint32_t*>(set_mask),
      static_cast<const int32_t*>(slot_key), static_cast<const int32_t*>(value_int),
      static_cast<uint8_t*>(out), R, N, K, W);
  return static_cast<int>(cudaGetLastError());
}

int kt_membership(const void* mem, const void* ok, void* out, int P, int R, int N,
                  void* stream) {
  if (P == 0 || N == 0) return 0;
  const dim3 block(THREADS);
  const dim3 grid((N + THREADS - 1) / THREADS, (P + TILE - 1) / TILE);
  membership_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mem), static_cast<const uint8_t*>(ok),
      static_cast<uint8_t*>(out), P, R, N);
  return static_cast<int>(cudaGetLastError());
}

int kt_cube_offer(const void* mem, const void* offer_ok, const void* custom_need,
                  const void* key_present, const void* available,
                  const void* owner, void* out, int P, int R, int O, int K, int I,
                  void* stream) {
  if (P == 0 || I == 0) return 0;
  const int WR = (R + 31) / 32, WK = (K + 31) / 32;
  const size_t shmem = static_cast<size_t>(TILE) * (WR + WK) * sizeof(uint32_t);
  const dim3 block(THREADS);
  const dim3 grid((I + THREADS - 1) / THREADS, (P + TILE - 1) / TILE);
  cube_offer_kernel<<<grid, block, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mem), static_cast<const uint8_t*>(offer_ok),
      static_cast<const uint8_t*>(custom_need), static_cast<const uint8_t*>(key_present),
      static_cast<const uint8_t*>(available), static_cast<const int32_t*>(owner),
      static_cast<uint8_t*>(out), P, R, O, K, I);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
