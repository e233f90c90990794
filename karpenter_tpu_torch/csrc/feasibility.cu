// The batched feasibility sweep of the provisioning solve, written by hand
// for Hopper (sm_90a). Built by karpenter_tpu_torch/device.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// wrappers, their checks and the plain torch versions the kernels are held
// against live in karpenter_tpu_torch/ops/feasibility.py.
//
// What each kernel replaces (the JAX device programs of the reference):
//   kt_row_compat  <- karpenter_tpu/ops/feasibility.py:48 req_rows_vs_sets,
//                     one launch for the rows of a batch against one or two
//                     targets (the catalog's types and its offerings)
//                     (kernel name catalog.row_compat)
//   kt_membership  <- karpenter_tpu/ops/feasibility.py:177 membership_all
//   kt_cube        <- karpenter_tpu/ops/feasibility.py:265 _cube_math /
//                     production_cube, both halves in one launch, the rows
//                     read in place by index; with no compat plane, the
//                     offering half alone: :430 offering_reduce
//   kt_cube_fused  <- karpenter_tpu/ops/feasibility.py:305-329 sharded_cube,
//                     both halves of the cube for every shard of one card
//   kt_uid_project <- karpenter_tpu/ops/feasibility.py:332 uid_project, from the
//                     factored masks (its call in ops/fused.py:433-436)
//   kt_fits_matrix_f32 / kt_fits_matrix_i32
//                  <- karpenter_tpu/ops/feasibility.py:222 fits_matrix
//   kt_stage_plane <- karpenter_tpu/ops/feasibility.py:384 stage_plane
//
// These are boolean reductions, not float math. The JAX package counts bad
// rows with an f32 matmul and thresholds at 0.5; here every test is exact
// bit logic on packed uint32 words, so there is no threshold and no rounding.
//
// What bounds them on this card: at the solve's shapes (the bench
// workload's sweeps are 16 entities x 7 used rows, padded to 8, and 1
// entity with no row, against 1008 types and 8064 offerings; its row
// batches 7 rows, W=8 mask words; up to 256 x 128 for a more diverse
// backlog) each call moves well under 3 MB, under a microsecond at 3.35 TB/s.
// They are bound by launch latency and by dependent loads from L2, not by
// device memory or arithmetic. The design keeps each call to one launch,
// packs entities 32 to a word so one AND tests a row for 32 entities,
// gives the card enough blocks to fill its SMs, and lays tables out so
// that neighbouring threads read neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int32_t NO_GT = INT32_MIN;    // encoding.NO_GT: no lower bound
constexpr int32_t NO_LT = INT32_MAX;    // encoding.NO_LT: no upper bound
constexpr int32_t NOT_INT = INT32_MIN;  // encoding.NOT_INT: non-integer slot
constexpr int TILE = 32;                // entities per thread (one bit each)
constexpr int THREADS = 128;
constexpr int SMS = 132;                // the H100 SXM's SMs
constexpr int MAX_GRID_Y = 65535;

inline bool aligned_to(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Bit 7 of each byte of x set iff that byte is not zero (the other bits
// are not meaningful): bit 7 of (b & 0x7f) + 0x7f is set iff b's low seven
// bits are not all zero (no carry leaves the byte), and OR b adds b's own
// bit 7. Any non-zero byte reads as true, so no kernel relies on torch
// storing bool as 0/1.
__device__ __forceinline__ uint32_t nonzero_high(uint32_t x) {
  return ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x;
}

// 0x01 in each byte of x that is not zero, 0x00 in each that is.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (nonzero_high(x) >> 7) & 0x01010101u;
}

// ---------------------------------------------------------------------------
// B1: compat[r, col_t + n] — does requirement row r intersect set n of
// target t on r's key?
//
// One launch covers a row batch against one or two targets (the catalog's
// types and its offerings): grid.x runs over the first target's tiles of
// 256 sets, then the second's; grid.y over the rows. The row side is one
// int32 table [R, 5 + W] (ops/feasibility.py row_table: key, complement,
// has_values, gt, lt, then the mask words), one upload. Each target's set side
// comes packed once per catalog encode (ops/feasibility.py pack_sets): the
// present / complement / has_values flags of (key, set) in one int32 word,
// laid out [K, N] as are gt and lt, the mask words [W, N], so the threads
// of consecutive sets read consecutive words for the row's key. The row's
// candidate slots — its value mask, complemented for NotIn/DoesNotExist
// rows, restricted to the slots of its own key — are built once per block
// in shared memory from the key-slot words [K, W] (bit b of word w: slot
// 32 w + b belongs to key k), computed once per vocabulary version, so a
// complement's bits on padding slots and other keys' slots are cleared by
// one AND a word. Each thread then ANDs those words with its set's
// (complemented) mask word by word; only when a Gt/Lt bound is in force
// does it walk the surviving slots and test value_int against the merged
// bounds. Semantics: requirement.go HasIntersection and the
// NotIn/DoesNotExist exemption of requirements.go Intersects.
constexpr int SET_PRESENT = 1;     // pack_sets' flag bits
constexpr int SET_COMPLEMENT = 2;
constexpr int SET_HAS_VALUES = 4;
constexpr int ROW_THREADS = 256;

struct SetTarget {
  const int32_t* flags;  // [K, N]
  const int32_t* gt;     // [K, N]
  const int32_t* lt;     // [K, N]
  const uint32_t* mask;  // [W, N]
  int n;                 // sets
  int col;               // the target's first output column
  int blocks;            // its grid.x blocks
};

constexpr int ROW_FIELDS = 5;  // row_table's columns before the mask words

__global__ void row_compat_kernel(
    const int32_t* __restrict__ rows, const SetTarget first, const SetTarget second,
    const uint32_t* __restrict__ key_slots, const int32_t* __restrict__ value_int,
    uint8_t* __restrict__ out, int out_stride, int R, int W) {
  extern __shared__ uint32_t a_words[];  // [W]
  // the block's target, field by field (no copy of a parameter struct)
  const bool is_second = static_cast<int>(blockIdx.x) >= first.blocks;
  const int32_t* __restrict__ flags = is_second ? second.flags : first.flags;
  const int32_t* __restrict__ set_gt = is_second ? second.gt : first.gt;
  const int32_t* __restrict__ set_lt = is_second ? second.lt : first.lt;
  const uint32_t* __restrict__ set_mask = is_second ? second.mask : first.mask;
  const int N = is_second ? second.n : first.n;
  const int col = is_second ? second.col : first.col;
  const int n = (blockIdx.x - (is_second ? first.blocks : 0)) * blockDim.x + threadIdx.x;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const int32_t* row = rows + static_cast<size_t>(r) * (ROW_FIELDS + W);
    const int32_t k = row[0];
    const bool rc = row[1] != 0;
    __syncthreads();  // a_words of the previous row are no longer read
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const uint32_t m = static_cast<uint32_t>(row[ROW_FIELDS + w]);
      a_words[w] = (rc ? ~m : m) & key_slots[static_cast<size_t>(k) * W + w];
    }
    __syncthreads();
    if (n >= N) continue;
    const size_t kn = static_cast<size_t>(k) * N + n;
    const int32_t f = flags[kn];
    uint8_t res;
    if (!(f & SET_PRESENT)) {
      res = 1;  // a key the set does not constrain is compatible
    } else {
      const bool sc = (f & SET_COMPLEMENT) != 0;
      const bool rhv = row[2] != 0;
      const bool shv = (f & SET_HAS_VALUES) != 0;
      const bool row_exempt = rc ? rhv : !rhv;
      const bool set_exempt = sc ? shv : !shv;
      if (row_exempt && set_exempt) {
        res = 1;
      } else {
        const int32_t g = max(row[3], set_gt[kn]);
        const int32_t l = min(row[4], set_lt[kn]);
        if (g != NO_GT && l != NO_LT && g >= l) {
          res = 0;  // empty integer range
        } else if (rc && sc) {
          res = 1;  // two complements always intersect (open world)
        } else {
          const bool unbounded = g == NO_GT && l == NO_LT;
          bool any = false;
          for (int w = 0; w < W && !any; ++w) {
            const uint32_t m = set_mask[static_cast<size_t>(w) * N + n];
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
    out[static_cast<size_t>(r) * out_stride + col + n] = res;
  }
}

// ---------------------------------------------------------------------------
// B2: out[p, n] = every row of entity p is compatible with target n: no row
// r with mem[p, r] and !ok[r, n] (mem [P, R], ok [R, N], out [P, N], bool).
//
// Bound by the bytes it writes (P*N outputs against P*R + R*N inputs); at
// the ladder's rungs (P <= 1024, R <= 64, N = 1008) a call moves at most
// 1.2 MB, so there launch latency and dependent trips to memory set the
// time. Two forms, each in a wide, a mid and a narrow instance (W = 16, 4,
// 1, picked by the C entry from N and the alignment of ok and out):
//
// The register form (R <= RMAX, 8 or 16 rows: the sweep's entities hold
// up to 8 rows, the ladder's rungs 4 and 16) is bit-sliced:
//   - a warp owns a tile of 32 targets [n0, n0 + 32) and walks tiles of 32
//     entities, lane l holding entity p0 + l's 32 results as the bits of
//     one word;
//   - lane l reads target n0 + l's byte of each ok row (32 contiguous bytes
//     a row) and __ballot_sync turns the row into one word of 32 target
//     bits, the same in every lane: a set row then costs one AND for 32
//     targets; the words stay in registers for every entity tile the warp
//     visits (the grid is persistent over the entities);
//   - lane l reads its own entity's R membership bytes (a warp load spans
//     32 R <= 512 bytes), the first tile's in the same trip as the ok
//     bytes and each later tile's while the one before it is used, and
//     ANDs the words of the rows its entity holds;
//   - the warp writes its 32 x 32 tile row by row: __shfl_sync brings an
//     entity's word to the lanes that store its row and a multiply spreads
//     4 bits into 4 bytes, so every store instruction writes whole 32-byte
//     rows (W = 16: two lanes a row; W = 4: eight; W = 1: 32);
//   - the rows are unrolled to RMAX and predicated, with no branch: a
//     break at R measured slower at R = 16 than the predicated rows.
//
// The walking form (R > 16) reads only the rows an entity holds (about 4
// of R): a thread owns W consecutive targets and a warp one entity at a
// time; lane l reads byte r0 + l of the entity's row for every chunk of 32
// rows (up to MEM_CHUNKS chunks at once) and a ballot a chunk gives the
// entity's row bits, the same in every lane; the set rows' ok bytes (W a
// load, from L1 / L2) are read MEM_WALK at a time and ANDed as bytes, and
// each thread writes its W outputs in one store. The bit-sliced form
// would rebuild 32 words a chunk for every entity tile: slower at R = 64
// on an H100.
//
// Any non-zero byte of mem or ok reads as true, and each output byte is
// exactly 0 or 1.
constexpr int MEM_THREADS = 256;      // 8 warps a block
constexpr int MEM_BLOCKS_PER_SM = 2;
constexpr int MEM_RREG = 16;          // most rows of the register form
constexpr int MEM_CHUNKS = 4;         // the walking form: 32-row chunks balloted at once (bits[0-3])
constexpr int MEM_WALK = 4;           // the walking form: set rows whose ok loads fly together

// Bits 0-3 of x as four 0/1 bytes: bit i lands on bit 8i (i + 7k is a
// multiple of 8 only for k = i, and no two terms overlap, so nothing
// carries).
__device__ __forceinline__ uint32_t expand4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

// The register form's tile of results: lane l's acc holds entity p0 + l's
// bits for targets [n0, n0 + 32). Writes out[p0 + e, n0 + t] for p0 + e < P
// and n0 + t < N, every store instruction whole rows of 32 bytes.
template <int W>
__device__ __forceinline__ void store_tile(uint8_t* __restrict__ out, uint32_t acc, long long p0,
                                           long long n0, int P, int N, int lane) {
  constexpr unsigned FULL = 0xffffffffu;
  if constexpr (W == 16) {  // lane l: half l % 2 of row l / 2 + 16 h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane / 2 + 16 * h;
      const uint32_t a = __shfl_sync(FULL, acc, e) >> (16 * (lane & 1));
      const long long n = n0 + 16 * (lane & 1);
      if (p0 + e < P && n < N)
        *reinterpret_cast<uint4*>(out + (p0 + e) * N + n) =
            make_uint4(expand4(a), expand4(a >> 4), expand4(a >> 8), expand4(a >> 12));
    }
  } else if constexpr (W == 4) {  // lane l: word l % 8 of row l / 8 + 4 i
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane / 8 + 4 * i;
      const uint32_t a = __shfl_sync(FULL, acc, e) >> (4 * (lane & 7));
      const long long n = n0 + 4 * (lane & 7);
      if (p0 + e < P && n < N) *reinterpret_cast<unsigned int*>(out + (p0 + e) * N + n) = expand4(a);
    }
  } else {  // lane l: byte l of every row
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const uint32_t a = __shfl_sync(FULL, acc, e);
      if (p0 + e < P && n0 + lane < N) out[(p0 + e) * N + n0 + lane] = static_cast<uint8_t>((a >> lane) & 1u);
    }
  }
}

// Entity p's membership bytes of rows [0, min(R, RMAX)), 0 past them or P.
template <int RMAX>
__device__ __forceinline__ void load_membership(uint8_t (&m)[RMAX], const uint8_t* __restrict__ mem,
                                                long long p, int P, int R) {
#pragma unroll
  for (int k = 0; k < RMAX; ++k) m[k] = p < P && k < R ? mem[p * R + k] : 0;
}

// The register form's work on one entity tile: the AND of the words of
// the rows each lane's entity holds, then the tile's stores.
template <int W, int RMAX>
__device__ __forceinline__ void membership_tile(const uint8_t (&m)[RMAX], const uint32_t (&word)[RMAX],
                                                uint8_t* __restrict__ out, long long p0,
                                                long long n0, int P, int N, int lane) {
  uint32_t acc = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < RMAX; ++k)
    if (m[k] != 0) acc &= word[k];
  store_tile<W>(out, acc, p0, n0, P, N, lane);
}

// W target bytes in 32-bit words: W / 4 of them, or one byte in a word.
template <int W>
struct MemWords {
  static constexpr int NW = W >= 4 ? W / 4 : 1;
  uint32_t w[NW];
};

template <int W>
__device__ __forceinline__ MemWords<W> load_targets(const uint8_t* p) {
  MemWords<W> v;
  if constexpr (W == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = q.x, v.w[1] = q.y, v.w[2] = q.z, v.w[3] = q.w;
  } else if constexpr (W == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    v.w[0] = __ldg(p);
  }
  return v;
}

// The walking form's W outputs: acc's words hold bit 7 of a byte set where
// the target passed every row; one W-byte store of 0/1 bytes.
template <int W>
__device__ __forceinline__ void store_targets(uint8_t* p, const uint32_t (&acc)[MemWords<W>::NW]) {
  uint32_t b[MemWords<W>::NW];
#pragma unroll
  for (int j = 0; j < MemWords<W>::NW; ++j) b[j] = (acc[j] >> 7) & 0x01010101u;
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(b[0], b[1], b[2], b[3]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<unsigned int*>(p) = b[0];
  } else {
    *p = static_cast<uint8_t>(b[0]);
  }
}

// blockDim.x = MEM_THREADS. RMAX > 0, the register form (R <= RMAX): warp
// w of block x owns target tile 8x + w, grid.y walks the entity tiles.
// RMAX = 0, the walking form: grid.x tiles the targets 32 W at a time,
// grid.y walks the entities, a warp one at a time. W > 1 needs N % W == 0
// and ok and out aligned to W bytes.
template <int W, int RMAX>
__global__ void __launch_bounds__(MEM_THREADS, MEM_BLOCKS_PER_SM)
membership_kernel(const uint8_t* __restrict__ mem, const uint8_t* __restrict__ ok,
                  uint8_t* __restrict__ out, int P, int R, int N) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  if constexpr (RMAX > 0) {
    const long long n0 = (static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32) * 32;
    if (n0 >= N) return;  // the whole warp
    const bool has_n = n0 + lane < N;
    const long long tiles = (static_cast<long long>(P) + 31) / 32;
    const long long step = gridDim.y;
    long long t = blockIdx.y;
    uint8_t ma[RMAX], mb[RMAX], o[RMAX];
    load_membership(ma, mem, t * 32 + lane, P, R);
#pragma unroll
    for (int k = 0; k < RMAX; ++k) o[k] = k < R && has_n ? ok[k * static_cast<long long>(N) + n0 + lane] : 0;
    uint32_t word[RMAX];
#pragma unroll
    for (int k = 0; k < RMAX; ++k) word[k] = __ballot_sync(FULL, o[k] != 0);
    // two tiles a turn, so that each tile's loads fly while the one
    // before it is used, with no copy between the buffers
    while (t < tiles) {
      load_membership(mb, mem, (t + step) * 32 + lane, P, R);
      membership_tile<W>(ma, word, out, t * 32, n0, P, N, lane);
      t += step;
      if (t >= tiles) break;
      load_membership(ma, mem, (t + step) * 32 + lane, P, R);
      membership_tile<W>(mb, word, out, t * 32, n0, P, N, lane);
      t += step;
    }
  } else {
    constexpr int NW = MemWords<W>::NW;
    const long long n0 = (static_cast<long long>(blockIdx.x) * 32 + lane) * W;
    const bool active = n0 < N;
    const long long warps = blockDim.x / 32;
    const long long step = gridDim.y * warps;
    for (long long p = blockIdx.y * warps + threadIdx.x / 32; p < P; p += step) {
      const uint8_t* row = mem + p * R;
      uint32_t acc[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = FULL;
      for (int g = 0; g < R; g += 32 * MEM_CHUNKS) {
        // every chunk's membership byte first, then the ballots
        uint8_t m[MEM_CHUNKS];
#pragma unroll
        for (int c = 0; c < MEM_CHUNKS; ++c) {
          const int r = g + 32 * c + lane;
          m[c] = r < R ? row[r] : 0;
        }
        uint32_t bits[MEM_CHUNKS];  // the same in every lane
#pragma unroll
        for (int c = 0; c < MEM_CHUNKS; ++c) bits[c] = __ballot_sync(FULL, m[c] != 0);
        // the set rows, MEM_WALK loads in flight (the chunks unrolled, so
        // the bit words stay in registers)
        while ((bits[0] | bits[1] | bits[2] | bits[3]) != 0) {
          int r[MEM_WALK];
#pragma unroll
          for (int k = 0; k < MEM_WALK; ++k) {
            r[k] = -1;
#pragma unroll
            for (int c = 0; c < MEM_CHUNKS; ++c) {
              if (r[k] < 0 && bits[c] != 0) {
                r[k] = g + 32 * c + __ffs(bits[c]) - 1;
                bits[c] &= bits[c] - 1;
              }
            }
          }
          MemWords<W> v[MEM_WALK];
#pragma unroll
          for (int k = 0; k < MEM_WALK; ++k) {
#pragma unroll
            for (int j = 0; j < NW; ++j) v[k].w[j] = FULL;
            if (active && r[k] >= 0) v[k] = load_targets<W>(ok + r[k] * static_cast<long long>(N) + n0);
          }
#pragma unroll
          for (int k = 0; k < MEM_WALK; ++k)
#pragma unroll
            for (int j = 0; j < NW; ++j) acc[j] &= nonzero_high(v[k].w[j]);
        }
      }
      if (active) store_targets<W>(out + p * N + n0, acc);
    }
  }
}

template <int W, int RMAX>
int launch_membership_w(const uint8_t* mem, const uint8_t* ok, uint8_t* out, int P, int R, int N,
                        cudaStream_t stream) {
  const long long warps = MEM_THREADS / 32;
  // the register form: a warp a tile of 32 targets, grid.y over tiles of
  // 32 entities; the walking form: a lane W targets, grid.y over entities
  // a warp at a time
  const long long gx = RMAX > 0 ? ((static_cast<long long>(N) + 31) / 32 + warps - 1) / warps
                                : ((static_cast<long long>(N) + W - 1) / W + 31) / 32;
  long long gy = RMAX > 0 ? (static_cast<long long>(P) + 31) / 32 : (P + warps - 1) / warps;
  // one wave: every block resident at once, each warp walking its share
  // of the entities (the register form builds its words once)
  const long long wave = (SMS * MEM_BLOCKS_PER_SM + gx - 1) / gx;
  if (gy > wave) gy = wave;
  if (gy > MAX_GRID_Y) gy = MAX_GRID_Y;
  membership_kernel<W, RMAX><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                               MEM_THREADS, 0, stream>>>(mem, ok, out, P, R, N);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_membership(const uint8_t* mem, const uint8_t* ok, uint8_t* out, int P, int R, int N,
                      cudaStream_t stream) {
  if (R <= 8) return launch_membership_w<W, 8>(mem, ok, out, P, R, N, stream);
  if (R <= MEM_RREG) return launch_membership_w<W, MEM_RREG>(mem, ok, out, P, R, N, stream);
  return launch_membership_w<W, 0>(mem, ok, out, P, R, N, stream);
}

// ---------------------------------------------------------------------------
// B3: the production cube, compat[p, i] and has_offering[p, i], in one
// launch; with no compat plane (req_ok null) the offering half alone, B8.
//
// compat: every row of p is compatible with type i (req_ok). has_offering:
// some offering o of type i is available, every row of p is compatible
// with o (offer_ok), and p defines every custom key o needs (the
// undefined-label rule of requirements.go Compatible). The JAX program
// any-reduces offerings onto their owners with a one-hot [O, I] matmul
// thresholded at 0.5; every offering has exactly one owner, so that is the
// OR over the offerings whose owner is i (offerings are owner-major).
//
// The entity rows come with a row stride, so membership and key_present
// may be two column ranges of one uploaded [P, R2 + K] array. The rows are
// read in place: req_ok [Rtot, I] and offer_ok [Rtot, O] are
// the engine's resident matrices, and rows[r] names the matrix row of
// membership column r (columns past R are padding and are not read; a row
// id outside [0, Rtot) reads nothing and decides nothing). The catalog's
// constant tables come packed once per catalog (ops/feasibility.py
// cube_pack): custom_need as key words per offering [WK, O], each type's
// offering range (type_start [I + 1]) and a block plan: runs of
// consecutive types of at most CUBE_THREADS types and, unless one type
// alone has more, at most CUBE_THREADS offerings (plan[b]..plan[b + 1]).
// One block covers one run for one tile of 32 entities, so the grid is
// runs x tiles (63 x 1 at 1008 types of 8 offerings and 16 entities).
//
// Inside a block: the tile's entity bits are packed by row into shared
// memory, one warp ballot a word: rowent[r] holds the tile's entities
// constrained by row r, keyent[k] those that leave custom key k undefined,
// absent_any[w] the keys some entity leaves undefined. Consecutive
// threads take consecutive offerings of the run, so the byte loads of
// offer_ok[rows[r], o] coalesce; a row no remaining entity uses is not
// read; the custom-key test is one AND of the offering's key word with
// absent_any, and only its set bits cost a shared load. Each offering ORs
// the mask of the entities that may use it into its type's word in shared
// memory (atomicOr, exact). Then one thread a type ORs the rowent of the
// rows the type fails for the compat plane and writes both planes, the
// threads of a run writing consecutive bytes.
constexpr int CUBE_THREADS = 128;

__global__ void cube_kernel(
    const uint8_t* __restrict__ mem, int mem_stride, const uint8_t* __restrict__ key_present,
    int kp_stride, const int32_t* __restrict__ rows, int R, const uint8_t* __restrict__ req_ok,
    const uint8_t* __restrict__ offer_ok, int Rtot, const uint32_t* __restrict__ need_words,
    const uint8_t* __restrict__ available, const int32_t* __restrict__ owner,
    const int32_t* __restrict__ type_start, const int32_t* __restrict__ plan,
    uint8_t* __restrict__ compat_out, uint8_t* __restrict__ offer_out, int P, int O, int K,
    int I) {
  extern __shared__ uint32_t smem[];
  const int WK = (K + 31) / 32;
  uint32_t* rowent = smem;                                  // [R]
  int32_t* rowid = reinterpret_cast<int32_t*>(smem + R);    // [R]
  uint32_t* keyent = smem + 2 * R;                          // [K]
  uint32_t* absent_any = keyent + K;                        // [WK]
  __shared__ uint32_t has_tile[CUBE_THREADS];  // bit j: entity j may use an offering of type t0 + t
  const int p0 = blockIdx.y * TILE;
  const int pn = min(TILE, P - p0);
  const int t0 = plan[blockIdx.x], t1 = plan[blockIdx.x + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const bool live = lane < pn;
  const uint8_t* mem_j = mem + static_cast<size_t>(p0 + (live ? lane : 0)) * mem_stride;
  const uint8_t* kp_j = key_present + static_cast<size_t>(p0 + (live ? lane : 0)) * kp_stride;
  for (int r = warp; r < R; r += nwarps) {
    const uint32_t word = __ballot_sync(0xffffffffu, live && mem_j[r] != 0);
    if (lane == 0) {
      rowent[r] = word;
      const int32_t id = rows[r];
      rowid[r] = static_cast<unsigned>(id) < static_cast<unsigned>(Rtot) ? id : -1;
    }
  }
  for (int k = warp; k < K; k += nwarps) {
    const uint32_t word = __ballot_sync(0xffffffffu, live && kp_j[k] == 0);
    if (lane == 0) keyent[k] = word;
  }
  for (int t = threadIdx.x; t < CUBE_THREADS; t += blockDim.x) has_tile[t] = 0;
  __syncthreads();
  for (int w = warp; w < WK; w += nwarps) {
    const int k = w * 32 + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, k < K && keyent[k] != 0);
    if (lane == 0) absent_any[w] = word;
  }
  __syncthreads();
  const uint32_t tile = pn == TILE ? 0xffffffffu : (1u << pn) - 1u;
  const int o_hi = type_start[t1];
  for (int o = type_start[t0] + threadIdx.x; o < o_hi; o += blockDim.x) {
    if (!available[o]) continue;
    uint32_t okp = tile;  // bit j: offering o is usable by entity j
    for (int r = 0; r < R && okp; ++r) {
      const uint32_t e = rowent[r] & okp;
      const int id = rowid[r];
      if (e && id >= 0 && !offer_ok[static_cast<size_t>(id) * O + o]) okp &= ~e;
    }
    for (int w = 0; w < WK && okp; ++w) {
      uint32_t m = need_words[static_cast<size_t>(w) * O + o] & absent_any[w];
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        okp &= ~keyent[w * 32 + b];
      }
    }
    if (okp) atomicOr(&has_tile[owner[o] - t0], okp);
  }
  __syncthreads();
  const int i = t0 + threadIdx.x;
  if (i >= t1) return;
  if (compat_out != nullptr) {
    uint32_t bad = 0;  // bit j: entity j has a row incompatible with type i
    for (int r = 0; r < R; ++r) {
      const uint32_t e = rowent[r] & ~bad;
      const int id = rowid[r];
      if (e && id >= 0 && !req_ok[static_cast<size_t>(id) * I + i]) bad |= e;
    }
    for (int j = 0; j < pn; ++j)
      compat_out[static_cast<size_t>(p0 + j) * I + i] = !((bad >> j) & 1u);
  }
  const uint32_t has = has_tile[threadIdx.x];
  for (int j = 0; j < pn; ++j) offer_out[static_cast<size_t>(p0 + j) * I + i] = (has >> j) & 1u;
}

// The first index of a non-decreasing array `a` of n whose value is not
// below v (n when none is).
__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// B5: the production cube over a mesh, both halves in one launch per card.
//
// Replaces karpenter_tpu/ops/feasibility.py:305-329 (sharded_cube: the
// shard_map of _cube_math over the entity axis, the catalog replicated).
// What bounds it: at the mesh path's shapes (8 entities a shard, 8 rows,
// 1008 types, 8064 offerings) the call moves ~0.4 MB and is bound by launch
// latency; above them, by the bytes of the two [P, I] output planes and the
// re-reads of the compat matrices. The design: one launch covers every
// shard the card holds (blockIdx.z indexes a slab table: the shard's first
// entity row in the card's entity operands, its row count and its first
// output row, so card 0 writes straight into the gathered planes). A block
// covers 128 types and a tile of 32 entities and computes both halves, so
// no plane is written twice. Its entity bits are packed into shared memory
// once, by row rather than by entity: rowent[r] holds the tile's entities
// constrained by row r, keyent[k] those that leave custom key k undefined.
// So one incompatible row clears all its entities with one OR, where the
// per-entity words of an entity-major layout cost a 32-step loop a row word. compat:
// the OR of rowent[r] over the rows r that type i fails (req_compat).
// has_offering, computed by offering: the block's offerings are the
// owner-major range of its types (two threads search its two ends at once),
// consecutive threads take consecutive offerings, and each tests available,
// every row (offer_compat) and every custom key (custom_need) — the tests
// of kt_cube — and ORs the tile mask of the entities that may use it
// into its owner's word in shared memory (atomicOr). No thread runs a
// search of its own or walks its type's offerings one after another. The
// entity operands are read with a row stride, so the group solver's
// [G, R+K] rows would serve as they are.
__global__ void cube_fused_kernel(
    const uint8_t* __restrict__ mem, int mem_stride, const uint8_t* __restrict__ key_present,
    int kp_stride, const uint8_t* __restrict__ req_ok, const uint8_t* __restrict__ offer_ok,
    const uint8_t* __restrict__ custom_need, const uint8_t* __restrict__ available,
    const int32_t* __restrict__ owner, uint8_t* __restrict__ compat_out,
    uint8_t* __restrict__ offer_out, const SlabTable slabs, int R, int O, int K, int I) {
  extern __shared__ uint32_t smem[];
  uint32_t* rowent = smem;      // [R]: bit j, entity j of the tile is constrained by row r
  uint32_t* keyent = smem + R;  // [K]: bit j, entity j leaves custom key k undefined
  __shared__ uint32_t has_tile[THREADS];  // bit j: entity j has a usable offering of type i0 + t
  __shared__ int bounds[2];
  const int z = blockIdx.z;
  const int t0 = blockIdx.y * TILE;    // the tile's first row within the shard
  const int pn = min(TILE, slabs.rows[z] - t0);
  if (pn <= 0) return;                 // the whole block: a shorter shard
  const size_t src = static_cast<size_t>(slabs.src[z]) + t0;
  const uint8_t* mem_t = mem + src * mem_stride;
  const uint8_t* kp_t = key_present + src * kp_stride;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    uint32_t bits = 0;
    for (int j = 0; j < pn; ++j)
      bits |= static_cast<uint32_t>(mem_t[static_cast<size_t>(j) * mem_stride + r] != 0) << j;
    rowent[r] = bits;
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    uint32_t bits = 0;
    for (int j = 0; j < pn; ++j)
      bits |= static_cast<uint32_t>(kp_t[static_cast<size_t>(j) * kp_stride + k] == 0) << j;
    keyent[k] = bits;
  }
  const int i0 = blockIdx.x * blockDim.x;
  const int i1 = min(i0 + static_cast<int>(blockDim.x), I);
  has_tile[threadIdx.x] = 0;
  // the block's offerings: the owner-major range of its types, its two
  // ends searched at once by two threads
  if (threadIdx.x == 0) bounds[0] = lower_bound(owner, O, i0);
  if (threadIdx.x == blockDim.x - 1) bounds[1] = lower_bound(owner, O, i1);
  __syncthreads();
  for (int o = bounds[0] + threadIdx.x; o < bounds[1]; o += blockDim.x) {
    if (!available[o]) continue;
    uint32_t okp = 0xffffffffu;  // bit j: offering o is usable by entity j
    for (int r = 0; r < R; ++r)
      if (!offer_ok[static_cast<size_t>(r) * O + o]) okp &= ~rowent[r];
    for (int k = 0; k < K; ++k)
      if (custom_need[static_cast<size_t>(o) * K + k]) okp &= ~keyent[k];
    if (okp) atomicOr(&has_tile[owner[o] - i0], okp);
  }
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= I) return;
  uint32_t bad = 0;  // bit j: entity j has a row incompatible with type i
  for (int r = 0; r < R; ++r)
    if (!req_ok[static_cast<size_t>(r) * I + i]) bad |= rowent[r];
  const uint32_t has = has_tile[threadIdx.x];
  const size_t d0 = static_cast<size_t>(slabs.dst[z]) + t0;
  for (int j = 0; j < pn; ++j) {
    compat_out[(d0 + j) * I + i] = !((bad >> j) & 1u);
    offer_out[(d0 + j) * I + i] = (has >> j) & 1u;
  }
}

// ---------------------------------------------------------------------------
// B6: out[t, f, u] = some type i with uid_onehot[u, i] survives in tmpl[t, i]
// AND fam[f, i] — the fused scan's famu_ok, straight from the factored
// masks; with no second factor (F = 0) out[t, u] from tmpl alone, the
// generic uid_project over any [..., I] mask.
//
// The JAX program counts surviving types per unique-allocatable row with an
// f32 matmul over the [T, F, I] product and thresholds at 0.5; here it is
// the exact OR, and the product never leaves registers. One block of
// UID_WARPS warps per output row (t, f). Each lane loads its share of the
// row's two mask rows once, UID_KV loads of 16 bytes when I is a multiple
// of 16 and the operands are 16-byte aligned (else of one byte), and ANDs
// them in registers; then the block's warps walk the uids, UID_UNROLL
// one-hot rows a warp at a time with all their loads issued before the
// warp votes. A mask tile with no set bit is skipped whole. At the fused
// solve's shape (T = 1, F = 64, U = 36, I = 1008: 2 loads of 16 bytes a
// lane) that is 64 blocks, each reading its 2 KB of masks and the 36 KB
// one-hot (L2-resident after the first blocks) in at most two rounds of
// independent loads. ~100 KB a call: launch-bound. The design before (a
// warp per output, a chain of 32 dependent byte loads between votes, the
// [T, F, I] product built by a separate torch op) took 0.0084 ms of device
// time (PERF.md).
constexpr int UID_WARPS = 8;
constexpr int UID_UNROLL = 4;

__device__ __forceinline__ bool nonzero(uint4 v) { return (v.x | v.y | v.z | v.w) != 0u; }
__device__ __forceinline__ bool nonzero(uint8_t v) { return v != 0; }
__device__ __forceinline__ uint4 band(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint8_t band(uint8_t a, uint8_t b) { return a & b; }

// V: the load unit (uint4 or a byte); KV: loads a lane per mask tile; N:
// a row's length in V units; fam null: no second factor
template <typename V, int KV>
__global__ void __launch_bounds__(UID_WARPS * 32) uid_project_kernel(
    const V* __restrict__ onehot, const V* __restrict__ tmpl, const V* __restrict__ fam,
    uint8_t* __restrict__ out, int F, int U, int N) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const V* m1 = tmpl + static_cast<size_t>(fam != nullptr ? row / F : row) * N;
  const V* m2 = fam != nullptr ? fam + static_cast<size_t>(row % F) * N : nullptr;
  uint8_t* o = out + static_cast<size_t>(row) * U;
  for (int u = threadIdx.x; u < U; u += UID_WARPS * 32) o[u] = 0;
  __syncthreads();  // the zeros land before any warp sets a hit
  for (int n0 = 0; n0 < N; n0 += 32 * KV) {
    V m[KV];
    bool any_m = false;
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int n = n0 + k * 32 + lane;
      V v{};
      if (n < N) {
        v = m1[n];
        if (m2 != nullptr) v = band(v, m2[n]);
      }
      m[k] = v;
      any_m |= nonzero(v);
    }
    if (!__any_sync(0xffffffffu, any_m)) continue;  // no type of the tile survives
    for (int u0 = warp * UID_UNROLL; u0 < U; u0 += UID_WARPS * UID_UNROLL) {  // warp-uniform
      V h[UID_UNROLL][KV];
#pragma unroll
      for (int j = 0; j < UID_UNROLL; ++j) {
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int n = n0 + k * 32 + lane;
          h[j][k] = V{};
          if (u0 + j < U && n < N) h[j][k] = onehot[static_cast<size_t>(u0 + j) * N + n];
        }
      }
#pragma unroll
      for (int j = 0; j < UID_UNROLL; ++j) {
        bool b = false;
#pragma unroll
        for (int k = 0; k < KV; ++k) b |= nonzero(band(h[j][k], m[k]));
        if (__any_sync(0xffffffffu, b) && lane == 0 && u0 + j < U) o[u0 + j] = 1;
      }
    }
  }
}

__global__ void noop_kernel() {}

// ---------------------------------------------------------------------------
// B4: fits[p, i] = all_d(req[p, d] <= alloc[i, d]) — resources.Fits: a
// positive request against a zero capacity fails. float32 (the reference's
// own test passes it) and int32 (the quantized units of the exact path).
//
// Bound by the bytes it writes (P*I bools against P*D + I*D inputs), and
// close behind them by its compares (P*I*D): at the workload's [50000, 4] x
// [1008, 4] 50.4 MB take 0.015 ms at 3.35 TB/s and 201.6 M compares 0.012 ms
// at 64 a clock an SM. So the design spends few instructions per output
// byte (a chain of 4 predicate compares, a select and a share of the
// packing: 117 SASS instructions per 16 outputs) and writes 16 bytes a
// store. The compare chains, not the stores, set its time (PERF.md, B4):
//   - a thread owns W consecutive types (16, 4 or 1: the wide, mid and
//     narrow instances, picked by the C entry from I and the output's
//     alignment) and holds their first FITS_DREG capacities in registers
//     for every row it visits, padded with the type's largest value so a
//     missing dim always fits without a branch;
//   - a block is ct threads of W types along the row (a tile of the type
//     axis, grid.x) times rpb rows; it stages a tile of request rows in
//     shared memory with coalesced loads, FITS_DREG values a row (padded
//     with the smallest value), and a thread reads its row's values with
//     one 16-byte broadcast load;
//   - a row's W results are packed into the bytes of 32-bit words and leave
//     in one W-byte store, neighbouring threads on neighbouring addresses
//     (a 1008-type row is 63 16-byte stores);
//   - the grid is persistent: one block an SM walks the row tiles
//     (grid.y), so each block loads its capacities once (two blocks an SM
//     ran no faster).
// Dims past FITS_DREG read both operands from global memory (L1): correct
// for any D, fast for the solve path's D = 4. The compares are C++'s <=
// without fast-math, as JAX's: NaN on either side fails, -0.0 <= 0.0 holds.
constexpr int FITS_DREG = 4;             // dims a thread holds in registers
constexpr int FITS_THREADS = 256;        // most threads a block
constexpr int FITS_ROWS_PER_THREAD = 8;  // rows a thread takes from a staged tile
constexpr int FITS_BLOCKS_PER_SM = 1;

template <typename T> struct FitsRange;
template <> struct FitsRange<int32_t> {
  static __device__ __forceinline__ int32_t lo() { return INT32_MIN; }
  static __device__ __forceinline__ int32_t hi() { return INT32_MAX; }
};
template <> struct FitsRange<float> {
  static __device__ __forceinline__ float lo() { return __int_as_float(0xff800000); }  // -inf
  static __device__ __forceinline__ float hi() { return __int_as_float(0x7f800000); }  // +inf
};

template <typename T>
struct alignas(16) FitsQuad {
  T v[FITS_DREG];
};

// W result bytes (one a type, 0 or 1) to out[0, W) in one store.
template <int W>
__device__ __forceinline__ void store_bytes(uint8_t* out, const uint32_t (&w)[(W + 3) / 4]) {
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint32_t*>(out) = w[0];
  } else {
    *out = static_cast<uint8_t>(w[0]);
  }
}

// Rows r = first, first + step, ... < rows of the staged tile whose row 0
// is entity row p0. MORE: D > FITS_DREG, the dims past the registers read
// from global memory.
template <typename T, int W, bool MORE>
__device__ __forceinline__ void fits_rows(const FitsQuad<T>* tile, const T (&cap)[W][FITS_DREG],
                                          const T* __restrict__ req, const T* __restrict__ alloc,
                                          uint8_t* __restrict__ out, long long p0, int first,
                                          int step, int rows, int i0, int I, int D) {
  for (int r = first; r < rows; r += step) {
    const FitsQuad<T> q = tile[r];
    const long long p = p0 + r;
    uint32_t w[(W + 3) / 4] = {};
#pragma unroll
    for (int j = 0; j < W; ++j) {
      bool ok = true;
#pragma unroll
      for (int d = 0; d < FITS_DREG; ++d) ok &= q.v[d] <= cap[j][d];
      if (MORE) {
        for (int d = FITS_DREG; d < D; ++d)
          ok &= req[p * D + d] <= alloc[static_cast<long long>(i0 + j) * D + d];
      }
      w[j / 4] |= static_cast<uint32_t>(ok) << (8 * (j % 4));
    }
    store_bytes<W>(out + p * I + i0, w);
  }
}

// blockDim.x = ct * rpb: thread t owns types [i0, i0 + W) in row slot
// t / ct; grid.x tiles the types ct * W at a time, grid.y walks the row
// tiles of tile_rows = rpb * FITS_ROWS_PER_THREAD rows. W > 1 needs
// I % W == 0 and out aligned to W bytes.
template <typename T, int W>
__global__ void __launch_bounds__(FITS_THREADS, FITS_BLOCKS_PER_SM)
fits_matrix_kernel(const T* __restrict__ req, const T* __restrict__ alloc,
                   uint8_t* __restrict__ out, int P, int I, int D, int ct, int tile_rows) {
  extern __shared__ __align__(16) unsigned char fits_smem[];
  const FitsQuad<T>* tile = reinterpret_cast<const FitsQuad<T>*>(fits_smem);
  T* staged = reinterpret_cast<T*>(fits_smem);
  const int t = threadIdx.x;
  const int rpb = blockDim.x / ct;
  const int i0 = (blockIdx.x * ct + t % ct) * W;
  const bool active = i0 < I;
  T cap[W][FITS_DREG];
#pragma unroll
  for (int j = 0; j < W; ++j)
#pragma unroll
    for (int d = 0; d < FITS_DREG; ++d)
      cap[j][d] = active && d < D ? alloc[static_cast<long long>(i0 + j) * D + d]
                                  : FitsRange<T>::hi();
  const long long stride = static_cast<long long>(gridDim.y) * tile_rows;
  for (long long p0 = static_cast<long long>(blockIdx.y) * tile_rows; p0 < P; p0 += stride) {
    const int rows = P - p0 < tile_rows ? static_cast<int>(P - p0) : tile_rows;
    __syncthreads();  // every thread is done with the previous tile
    for (int k = t; k < rows * FITS_DREG; k += blockDim.x) {
      const int r = k / FITS_DREG, d = k % FITS_DREG;
      staged[k] = d < D ? req[(p0 + r) * D + d] : FitsRange<T>::lo();
    }
    __syncthreads();
    if (!active) continue;
    if (D > FITS_DREG)
      fits_rows<T, W, true>(tile, cap, req, alloc, out, p0, t / ct, rpb, rows, i0, I, D);
    else
      fits_rows<T, W, false>(tile, cap, req, alloc, out, p0, t / ct, rpb, rows, i0, I, D);
  }
}

// ---------------------------------------------------------------------------
// B7: the uint8 first-failing-stage code of each (entity, type) pair from
// the cube's three bool planes, in the funnel's order: requirements (1),
// resources (2), offerings (3), survived (0) — the reference's nested
// jnp.where. Bound by bytes (3 read, 1 written an element).
//
// A thread takes W elements a step (16, 4 or 1: the wide, mid and narrow
// instances, picked by the C entry from the four pointers' alignment): one
// W-byte load from each plane, the codes made branch-free on 32-bit words
// of four elements, one W-byte store; a grid-stride loop over the n / W
// vectors, then block 0 makes the n % W elements left, one a thread. Each
// plane's bytes are first made 0 or 1 (nonzero_bytes), so any non-zero
// byte counts as true, as the plain version reads a bool: the codes do not
// rely on torch storing bool as 0/1.
constexpr int STAGE_THREADS = 256;
constexpr int STAGE_BLOCKS_PER_SM = 8;

// The codes of four elements, a byte each: 1 where !c, else 2 where !f,
// else 3 where !o, else 0. On 0/1 bytes no term carries out of its byte.
__device__ __forceinline__ uint32_t stage_codes(uint32_t c, uint32_t f, uint32_t o) {
  constexpr uint32_t ONE = 0x01010101u;
  c = nonzero_bytes(c);
  f = nonzero_bytes(f);
  o = nonzero_bytes(o);
  return (c ^ ONE) | ((c & (f ^ ONE)) << 1) | ((c & f & (o ^ ONE)) * 3u);
}

__device__ __forceinline__ uint4 stage_codes(uint4 c, uint4 f, uint4 o) {
  return make_uint4(stage_codes(c.x, f.x, o.x), stage_codes(c.y, f.y, o.y),
                    stage_codes(c.z, f.z, o.z), stage_codes(c.w, f.w, o.w));
}

__device__ __forceinline__ uint8_t stage_codes(uint8_t c, uint8_t f, uint8_t o) {
  return static_cast<uint8_t>(stage_codes(uint32_t{c}, uint32_t{f}, uint32_t{o}));
}

template <typename V>  // uint4, uint32_t or uint8_t: W = sizeof(V) elements a step
__global__ void __launch_bounds__(STAGE_THREADS)
stage_plane_kernel(const uint8_t* __restrict__ compat, const uint8_t* __restrict__ fits,
                   const uint8_t* __restrict__ offer, uint8_t* __restrict__ out, long long n) {
  constexpr int W = sizeof(V);
  const long long nv = n / W;
  const V* c = reinterpret_cast<const V*>(compat);
  const V* f = reinterpret_cast<const V*>(fits);
  const V* o = reinterpret_cast<const V*>(offer);
  V* dst = reinterpret_cast<V*>(out);
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; k < nv;
       k += static_cast<long long>(gridDim.x) * blockDim.x)
    dst[k] = stage_codes(c[k], f[k], o[k]);
  if (W > 1 && blockIdx.x == 0 && threadIdx.x < n - nv * W) {
    const long long k = nv * W + threadIdx.x;
    out[k] = stage_codes(compat[k], fits[k], offer[k]);
  }
}

template <typename T, int W>
int launch_fits_w(const T* req, const T* alloc, uint8_t* out, int P, int I, int D,
                  cudaStream_t stream) {
  const int chunks = (I + W - 1) / W;
  const int ct = chunks < FITS_THREADS ? chunks : FITS_THREADS;
  const int rpb = FITS_THREADS / ct;
  const int tile_rows = rpb * FITS_ROWS_PER_THREAD;
  const int gx = (chunks + ct - 1) / ct;
  const long long row_tiles = (static_cast<long long>(P) + tile_rows - 1) / tile_rows;
  long long gy = (SMS * FITS_BLOCKS_PER_SM + gx - 1) / gx;
  if (gy > row_tiles) gy = row_tiles;
  if (gy > MAX_GRID_Y) gy = MAX_GRID_Y;
  const size_t shmem = static_cast<size_t>(tile_rows) * sizeof(FitsQuad<T>);
  fits_matrix_kernel<T, W><<<dim3(gx, static_cast<unsigned>(gy)), ct * rpb, shmem, stream>>>(
      req, alloc, out, P, I, D, ct, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fits(const void* req, const void* alloc, void* out, int P, int I, int D,
                void* stream) {
  if (P < 0 || I < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || I == 0) return 0;
  const T* r = static_cast<const T*>(req);
  const T* a = static_cast<const T*>(alloc);
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (I % 16 == 0 && aligned_to(out, 16)) return launch_fits_w<T, 16>(r, a, o, P, I, D, s);
  if (I % 4 == 0 && aligned_to(out, 4)) return launch_fits_w<T, 4>(r, a, o, P, I, D, s);
  return launch_fits_w<T, 1>(r, a, o, P, I, D, s);
}

template <typename V>
int launch_stage(const void* compat, const void* fits, const void* offer, void* out, long long n,
                 cudaStream_t stream) {
  const long long vec_blocks =
      (n / static_cast<long long>(sizeof(V)) + STAGE_THREADS - 1) / STAGE_THREADS;
  const long long most = SMS * STAGE_BLOCKS_PER_SM;
  const long long blocks = vec_blocks < 1 ? 1 : (vec_blocks < most ? vec_blocks : most);
  stage_plane_kernel<V><<<static_cast<unsigned>(blocks), STAGE_THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(compat), static_cast<const uint8_t*>(fits),
      static_cast<const uint8_t*>(offer), static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The row table [R, 5 + W] int32 against one or two targets' packed set
// sides (flags, gt, lt [K, N_t], mask [W, N_t]; n1 = 0: one target);
// key_slots [K, W], value_int [32 W]; out [R, out_stride] bool, target 0's
// sets at columns [0, n0), target 1's at [n0, n0 + n1). Returns the
// launch's cudaError_t.
int kt_row_compat(const void* rows,
                  const void* flags0, const void* gt0, const void* lt0, const void* mask0, int n0,
                  const void* flags1, const void* gt1, const void* lt1, const void* mask1, int n1,
                  const void* key_slots, const void* value_int, void* out, int out_stride,
                  int R, int W, void* stream) {
  if (R == 0 || n0 + n1 == 0) return 0;
  const SetTarget first{static_cast<const int32_t*>(flags0), static_cast<const int32_t*>(gt0),
                        static_cast<const int32_t*>(lt0), static_cast<const uint32_t*>(mask0), n0,
                        0, (n0 + ROW_THREADS - 1) / ROW_THREADS};
  const SetTarget second{static_cast<const int32_t*>(flags1), static_cast<const int32_t*>(gt1),
                         static_cast<const int32_t*>(lt1), static_cast<const uint32_t*>(mask1), n1,
                         n0, (n1 + ROW_THREADS - 1) / ROW_THREADS};
  const dim3 grid(first.blocks + second.blocks, R < MAX_GRID_Y ? R : MAX_GRID_Y);
  row_compat_kernel<<<grid, ROW_THREADS, W * sizeof(uint32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), first, second,
      static_cast<const uint32_t*>(key_slots), static_cast<const int32_t*>(value_int),
      static_cast<uint8_t*>(out), out_stride, R, W);
  return static_cast<int>(cudaGetLastError());
}

// mem [P, R], ok [R, N] and out [P, N] bool: the wide instance when N % 16
// == 0 and ok and out are 16-byte aligned, the mid when N % 4 == 0 and
// they are 4-byte aligned, else the narrow; each in its register form for
// R <= 8 or R <= 16, else its walking form.
int kt_membership(const void* mem, const void* ok, void* out, int P, int R, int N,
                  void* stream) {
  if (P < 0 || R < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || N == 0) return 0;
  const uint8_t* m = static_cast<const uint8_t*>(mem);
  const uint8_t* k = static_cast<const uint8_t*>(ok);
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 16 == 0 && aligned_to(ok, 16) && aligned_to(out, 16))
    return launch_membership<16>(m, k, o, P, R, N, s);
  if (N % 4 == 0 && aligned_to(ok, 4) && aligned_to(out, 4))
    return launch_membership<4>(m, k, o, P, R, N, s);
  return launch_membership<1>(m, k, o, P, R, N, s);
}

// mem [P, mem_stride] and key_present [P, kp_stride] bool entity rows
// (membership's first R columns and key_present's first K read); rows [R]
// int32, membership column r's row of req_ok [Rtot, I] (null: no compat
// plane) and offer_ok [Rtot, O] bool; need_words [WK, O] int32;
// available [O] bool; owner [O] int32 non-decreasing; type_start [I + 1]
// and plan [runs + 1] int32 (ops/feasibility.py cube_pack); compat_out
// (null with req_ok) and offer_out [P, I] bool. Returns the launch's
// cudaError_t.
int kt_cube(const void* mem, int mem_stride, const void* key_present, int kp_stride,
            const void* rows, int R,
            const void* req_ok, const void* offer_ok, int Rtot, const void* need_words,
            const void* available, const void* owner, const void* type_start, const void* plan,
            int runs, void* compat_out, void* offer_out, int P, int O, int K, int I,
            void* stream) {
  if (P == 0 || runs == 0) return 0;
  const size_t shmem = static_cast<size_t>(2 * R + K + (K + 31) / 32) * sizeof(uint32_t);
  const dim3 grid(runs, (P + TILE - 1) / TILE);
  cube_kernel<<<grid, CUBE_THREADS, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mem), mem_stride, static_cast<const uint8_t*>(key_present),
      kp_stride, static_cast<const int32_t*>(rows), R, static_cast<const uint8_t*>(req_ok),
      static_cast<const uint8_t*>(offer_ok), Rtot, static_cast<const uint32_t*>(need_words),
      static_cast<const uint8_t*>(available), static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(type_start), static_cast<const int32_t*>(plan),
      static_cast<uint8_t*>(compat_out), static_cast<uint8_t*>(offer_out), P, O, K, I);
  return static_cast<int>(cudaGetLastError());
}

// mem [*, mem_stride] and key_present [*, kp_stride] bool rows of the
// card's entities; req_ok [R, I], offer_ok [R, O], custom_need [O, K],
// available [O] bool; owner [O] int32 non-decreasing; compat_out and
// offer_out [*, I] bool. `slabs` holds n_slabs (src, rows, dst) triples,
// one per shard on this card. Returns the launch's cudaError_t.
int kt_cube_fused(const void* mem, int mem_stride, const void* key_present, int kp_stride,
                  const void* req_ok, const void* offer_ok, const void* custom_need,
                  const void* available, const void* owner, void* compat_out, void* offer_out,
                  const int* slabs, int n_slabs, int R, int O, int K, int I, void* stream) {
  SlabTable table;
  int max_rows;
  if (!read_slabs(slabs, n_slabs, table, max_rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (max_rows == 0 || I == 0) return 0;
  const size_t shmem = static_cast<size_t>(R + K) * sizeof(uint32_t);  // rowent, keyent
  const dim3 block(THREADS);
  const dim3 grid((I + THREADS - 1) / THREADS, (max_rows + TILE - 1) / TILE, n_slabs);
  cube_fused_kernel<<<grid, block, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mem), mem_stride, static_cast<const uint8_t*>(key_present),
      kp_stride, static_cast<const uint8_t*>(req_ok), static_cast<const uint8_t*>(offer_ok),
      static_cast<const uint8_t*>(custom_need), static_cast<const uint8_t*>(available),
      static_cast<const int32_t*>(owner), static_cast<uint8_t*>(compat_out),
      static_cast<uint8_t*>(offer_out), table, R, O, K, I);
  return static_cast<int>(cudaGetLastError());
}

// uid_onehot [U, I], tmpl [T, I] and, with F > 0, fam [F, I] bool; out
// [T, F, U] bool (with F = 0: [T, U], fam unread). Returns the launch's
// cudaError_t.
int kt_uid_project(const void* onehot, const void* tmpl, const void* fam, void* out, int T,
                   int F, int U, int I, void* stream) {
  if (T < 0 || F < 0 || U < 0 || I < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = F > 0 ? static_cast<long long>(T) * F : T;
  if (rows == 0 || U == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = I % 16 == 0 && aligned_to(onehot, 16) && aligned_to(tmpl, 16) &&
                    (F == 0 || aligned_to(fam, 16));
  const dim3 grid(static_cast<unsigned>(rows)), block(UID_WARPS * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    uid_project_kernel<uint4, 2><<<grid, block, 0, s>>>(
        static_cast<const uint4*>(onehot), static_cast<const uint4*>(tmpl),
        F > 0 ? static_cast<const uint4*>(fam) : nullptr, static_cast<uint8_t*>(out), F, U,
        I / 16);
  } else {
    uid_project_kernel<uint8_t, 8><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(onehot), static_cast<const uint8_t*>(tmpl),
        F > 0 ? static_cast<const uint8_t*>(fam) : nullptr, static_cast<uint8_t*>(out), F, U, I);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: the launch floor (device time and host enqueue) that
// PERF.md sets beside the kernel table.
int kt_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// req [P, D] and alloc [I, D] of the entry's type, out [P, I] bool: the
// wide instance when I % 16 == 0 and out is 16-byte aligned, the mid when
// I % 4 == 0 and 4-byte, else the narrow.
int kt_fits_matrix_f32(const void* req, const void* alloc, void* out, int P, int I, int D,
                       void* stream) {
  return launch_fits<float>(req, alloc, out, P, I, D, stream);
}

int kt_fits_matrix_i32(const void* req, const void* alloc, void* out, int P, int I, int D,
                       void* stream) {
  return launch_fits<int32_t>(req, alloc, out, P, I, D, stream);
}

// compat, fits, offer and out: n bytes each. The wide instance when all
// four are 16-byte aligned, the mid when 4-byte, else the narrow.
int kt_stage_plane(const void* compat, const void* fits, const void* offer, void* out,
                   long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto all_aligned = [&](uintptr_t b) {
    return aligned_to(compat, b) && aligned_to(fits, b) && aligned_to(offer, b) && aligned_to(out, b);
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (all_aligned(16)) return launch_stage<uint4>(compat, fits, offer, out, n, s);
  if (all_aligned(4)) return launch_stage<uint32_t>(compat, fits, offer, out, n, s);
  return launch_stage<uint8_t>(compat, fits, offer, out, n, s);
}

}  // extern "C"
