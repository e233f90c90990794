// The group solver's kernels, written by hand for Hopper (sm_90a). Built by
// karpenter_tpu_torch/device.py with nvcc (-gencode arch=compute_90a,
// code=sm_90a -O3 --fmad=false) into a shared library with a plain C
// interface, loaded with ctypes. The wrappers, their checks and the plain
// torch versions the kernels are held against live in
// karpenter_tpu_torch/ops/packer.py.
//
// What they replace (karpenter_tpu/ops/packer.py):
//   kt_solve_block     the rest of _solve_parts (:65) after the two cube
//                      halves, and _count_finalize (:109): solve_block_jit
//                      (:148, B9) with the finalize on, _solve_block_core
//                      (:162, B10) with it off. The cube's halves come from
//                      kt_membership (B2) and kt_cube_offer (B8,
//                      feasibility.offering_reduce) in csrc/feasibility.cu.
//   kt_group_solve     sharded_solve_block (:217-240, B13): the whole
//                      per-group solve of every shard on one card, the
//                      cube's halves included, in one launch.
//   kt_delta_scatter   delta_scatter_rows (:185, B11): core[slots] = rows,
//                      in place where the reference donates `core`.
//   kt_delta_finalize  delta_finalize (:196, B12): core[order], then the
//                      same finalize as kt_solve_block (one __device__
//                      helper, so B9 and B12 cannot drift apart).
//
// What bounds them on this card: bytes. At the group solver's shape (G=256
// groups x I=1008 types, D=4) kt_solve_block reads the two [G, I] bool
// planes, the [I, D] allocatable and the [I] prices once (~0.5 MB, 0.16 us at
// 3.35 TB/s) and does ~G*I*(D+3) integer and float compares; the delta
// kernels move a few KB. All three are launch-bound at these sizes. The
// design: one block per group walks the type axis with coalesced loads and
// reduces (price, index) pairs with warp shuffles and one shared-memory
// pass, the least price and then the least index winning, as argmin does.
// Integer division rounds toward minus infinity (floor_div), as the
// reference's `//` does, not toward zero as C's `/`.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BLOCK_THREADS = 256;
constexpr int NWARPS = BLOCK_THREADS / 32;
constexpr float INF_PRICE = 3.4e38f;  // the reference's jnp.float32(3.4e38)
constexpr int INT32_MAX_V = 0x7fffffff;

// a // b rounded toward minus infinity, for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// _count_finalize for one group: (choice, feasible, nodes, unschedulable)
__device__ __forceinline__ void finalize_row(int choice, bool feasible, int ppn, int count,
                                             int32_t* out4) {
  const bool ok = feasible && ppn > 0;
  const int pp = ppn > 1 ? ppn : 1;
  out4[0] = choice;
  out4[1] = feasible ? 1 : 0;
  out4[2] = ok ? -floor_div(-count, pp) : 0;  // ceil division
  out4[3] = ok ? 0 : count;
}

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The block's choice for one group, from each thread's least (price,
// index) and any-feasible over the types it walked: warp shuffles, then one
// shared-memory pass, the least price and then the least index winning, as
// argmin does. Thread 0 then takes pods-per-node of the chosen type (the
// least floor(alloc / request) over the requested dims, 0 at the least) and
// returns true with (choice, feasible, ppn); every other thread returns
// false. Shared by kt_solve_block and kt_group_solve.
template <int WARPS>
__device__ __forceinline__ bool block_choice(float best_v, int best_i, int any,
                                             const int32_t* __restrict__ req,
                                             const int32_t* __restrict__ alloc_q, int D,
                                             int& choice, bool& feasible, int& ppn) {
  __shared__ float s_v[WARPS];
  __shared__ int s_i[WARPS];
  __shared__ int s_any[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int o = 16; o; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best_v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
    better(best_v, best_i, v2, i2);
    any |= __shfl_xor_sync(0xffffffffu, any, o);
  }
  if (lane == 0) {
    s_v[warp] = best_v;
    s_i[warp] = best_i;
    s_any[warp] = any;
  }
  __syncthreads();
  if (tid != 0) return false;
  for (int w = 1; w < WARPS; ++w) {
    better(best_v, best_i, s_v[w], s_i[w]);
    any |= s_any[w];
  }
  choice = best_i;
  int m = INT32_MAX_V;
  for (int d = 0; d < D; ++d) {
    const int r = req[d];
    const int per = r > 0 ? floor_div(alloc_q[static_cast<size_t>(choice) * D + d], r) : INT32_MAX_V;
    m = per < m ? per : m;
  }
  ppn = m > 0 ? m : 0;
  feasible = any != 0;
  return true;
}

// One block per group g: feasible[i] = compat & has_offering & fits, the
// least (price, index) over the feasible types (3.4e38 for the others),
// pods-per-node of the chosen type; then the core row or the finalized row.
__global__ void __launch_bounds__(BLOCK_THREADS) solve_block_kernel(
    const uint8_t* __restrict__ compat, const uint8_t* __restrict__ has_offering,
    const int32_t* __restrict__ group_ints, const int32_t* __restrict__ alloc_q,
    const float* __restrict__ price, int32_t* __restrict__ out, int I, int D, int finalize) {
  const int g = blockIdx.x;
  const int32_t* req = group_ints + static_cast<size_t>(g) * (D + 1);
  const uint8_t* cg = compat + static_cast<size_t>(g) * I;
  const uint8_t* hg = has_offering + static_cast<size_t>(g) * I;
  float best_v = __int_as_float(0x7f800000);  // +inf: every real type beats it on index
  int best_i = INT32_MAX_V;
  int any = 0;
  for (int i = threadIdx.x; i < I; i += BLOCK_THREADS) {
    bool f = cg[i] && hg[i];
    for (int d = 0; d < D && f; ++d) f = req[d] <= alloc_q[static_cast<size_t>(i) * D + d];
    any |= f;
    better(best_v, best_i, f ? price[i] : INF_PRICE, i);
  }
  int choice, ppn;
  bool feasible;
  if (!block_choice<NWARPS>(best_v, best_i, any, req, alloc_q, D, choice, feasible, ppn)) return;
  if (finalize) {
    finalize_row(choice, feasible, ppn, req[D], out + static_cast<size_t>(g) * 4);
  } else {
    int32_t* o3 = out + static_cast<size_t>(g) * 3;
    o3[0] = choice;
    o3[1] = feasible ? 1 : 0;
    o3[2] = ppn;
  }
}

// ---------------------------------------------------------------------------
// B13: the group solve over a mesh, one launch per card.
//
// Replaces karpenter_tpu/ops/packer.py:217-240 (sharded_solve_block: the
// shard_map of _solve_block over the group axis, the catalog replicated).
// What bounds it: at the mesh path's shapes (128 groups a shard, R+K=15,
// 1008 types, 8064 offerings, D=4) launch latency and the dependent loads
// inside a block; above them, the reads of the offering tables from L2
// (every group reads available, owner and custom_need whole, and the
// offer_compat rows it is a member of). The design: the whole per-group
// solve in one kernel, with no [G, I] plane in device memory. blockIdx.z
// indexes the slab table (csrc/common.cuh), as in kt_cube_fused. One block
// of 1024 threads per group packs the group's membership (columns [0, R)
// of group_bools, read in place) and its absent custom keys (columns
// [R, R+K)) into shared memory. Then has_offering, one thread per
// offering: offering o is usable when it is available, compatible with
// every row of the group and needs no custom key the group leaves
// undefined (the tests of kt_cube_offer), and sets its owner's bit in a
// shared-memory bitmask (atomicOr). Consecutive threads read consecutive
// offerings, every load is independent, and no search runs: the owner
// index is read, not looked up. Then one thread per type: compat, the AND
// of req_ok[r, i] over the group's rows (its set bits), the alloc_q fit and
// the owner bit; the choice and finalize are block_choice and finalize_row.
constexpr int GROUP_THREADS = 1024;
constexpr int MAX_WORDS = 64;  // R and K each up to 2048

__global__ void __launch_bounds__(GROUP_THREADS) group_solve_kernel(
    const uint8_t* __restrict__ group_bools, const int32_t* __restrict__ group_ints,
    const uint8_t* __restrict__ req_ok, const uint8_t* __restrict__ offer_ok,
    const uint8_t* __restrict__ custom_need, const uint8_t* __restrict__ available,
    const int32_t* __restrict__ owner, const int32_t* __restrict__ alloc_q,
    const float* __restrict__ price, int32_t* __restrict__ out, const SlabTable slabs, int R,
    int K, int O, int I, int D) {
  extern __shared__ uint32_t has_bits[];  // [(I + 31) / 32]: type i has a usable offering
  __shared__ uint32_t memw[MAX_WORDS];    // the group's rows
  __shared__ uint32_t absw[MAX_WORDS];    // the custom keys it does not define
  const int z = blockIdx.z;
  if (static_cast<int>(blockIdx.x) >= slabs.rows[z]) return;  // the whole block
  const size_t g = static_cast<size_t>(slabs.src[z]) + blockIdx.x;
  const int WR = (R + 31) / 32, WK = (K + 31) / 32, WI = (I + 31) / 32;
  const uint8_t* row = group_bools + g * (R + K);
  for (int w = threadIdx.x; w < WR + WK; w += GROUP_THREADS) {
    uint32_t bits = 0;
    if (w < WR) {
      const int rn = min(32, R - w * 32);
      for (int b = 0; b < rn; ++b) bits |= static_cast<uint32_t>(row[w * 32 + b] != 0) << b;
      memw[w] = bits;
    } else {
      const int k0 = (w - WR) * 32, kn = min(32, K - k0);
      for (int b = 0; b < kn; ++b) bits |= static_cast<uint32_t>(row[R + k0 + b] == 0) << b;
      absw[w - WR] = bits;
    }
  }
  for (int w = threadIdx.x; w < WI; w += GROUP_THREADS) has_bits[w] = 0;
  __syncthreads();
  for (int o = threadIdx.x; o < O; o += GROUP_THREADS) {  // has_offering, by offering
    bool ok = available[o] != 0;
    for (int w = 0; w < WR; ++w) {
      for (uint32_t c = memw[w]; c; c &= c - 1)
        ok &= offer_ok[static_cast<size_t>(w * 32 + __ffs(c) - 1) * O + o] != 0;
    }
    for (int w = 0; w < WK; ++w) {
      const int kn = min(32, K - w * 32);
      const uint8_t* cn = custom_need + static_cast<size_t>(o) * K + w * 32;
      uint32_t need = 0;
      for (int b = 0; b < kn; ++b) need |= static_cast<uint32_t>(cn[b] != 0) << b;
      ok &= (need & absw[w]) == 0;
    }
    const int t = owner[o];
    if (ok && static_cast<unsigned>(t) < static_cast<unsigned>(I))
      atomicOr(&has_bits[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
  const int32_t* req = group_ints + g * (D + 1);
  float best_v = __int_as_float(0x7f800000);  // +inf: every real type beats it on index
  int best_i = INT32_MAX_V;
  int any = 0;
  for (int i = threadIdx.x; i < I; i += GROUP_THREADS) {
    bool f = (has_bits[i >> 5] >> (i & 31)) & 1u;
    for (int w = 0; w < WR; ++w) {  // compat: every row of the group
      for (uint32_t c = memw[w]; c; c &= c - 1)
        f &= req_ok[static_cast<size_t>(w * 32 + __ffs(c) - 1) * I + i] != 0;
    }
    for (int d = 0; d < D; ++d) f &= req[d] <= alloc_q[static_cast<size_t>(i) * D + d];
    any |= f;
    better(best_v, best_i, f ? price[i] : INF_PRICE, i);
  }
  int choice, ppn;
  bool feasible;
  if (!block_choice<GROUP_THREADS / 32>(best_v, best_i, any, req, alloc_q, D, choice, feasible, ppn))
    return;
  finalize_row(choice, feasible, ppn, req[D],
               out + (static_cast<size_t>(slabs.dst[z]) + blockIdx.x) * 4);
}

// core[slots[j], c] = rows[j, c]; a negative slot counts from the end, a
// slot outside [0, cap) is dropped (the reference's scatter semantics).
// Duplicate (edge-padded) slots carry equal values, so their races are
// harmless.
__global__ void delta_scatter_kernel(int32_t* __restrict__ core, const int32_t* __restrict__ slots,
                                     const int32_t* __restrict__ rows, int n, int cap) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n * 3) return;
  const int j = k / 3, c = k % 3;
  int slot = slots[j];
  if (slot < 0) slot += cap;
  if (slot < 0 || slot >= cap) return;
  core[static_cast<size_t>(slot) * 3 + c] = rows[k];
}

// out[j] = finalize(core[order[j]], counts[j]); a negative index counts
// from the end and an index past the end clamps (the reference's gather).
__global__ void delta_finalize_kernel(const int32_t* __restrict__ core,
                                      const int32_t* __restrict__ order,
                                      const int32_t* __restrict__ counts, int32_t* __restrict__ out,
                                      int n, int cap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int o = order[j];
  if (o < 0) o += cap;
  o = o < 0 ? 0 : (o > cap - 1 ? cap - 1 : o);
  const int32_t* r = core + static_cast<size_t>(o) * 3;
  finalize_row(r[0], r[1] != 0, r[2], counts[j], out + static_cast<size_t>(j) * 4);
}

}  // namespace

extern "C" {

// compat, has_offering: [G, I] bool; group_ints [G, D+1] int32 (requests_q
// then counts); alloc_q [I, D] int32; price [I] float32; out [G, 4] int32
// when finalize, else [G, 3]. Returns the launch's cudaError_t.
int kt_solve_block(const void* compat, const void* has_offering, const void* group_ints,
                   const void* alloc_q, const void* price, void* out, int G, int I, int D,
                   int finalize, void* stream) {
  if (G == 0) return 0;
  if (I <= 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  solve_block_kernel<<<G, BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(compat), static_cast<const uint8_t*>(has_offering),
      static_cast<const int32_t*>(group_ints), static_cast<const int32_t*>(alloc_q),
      static_cast<const float*>(price), static_cast<int32_t*>(out), I, D, finalize);
  return static_cast<int>(cudaGetLastError());
}

// group_bools [*, R+K] bool and group_ints [*, D+1] int32 rows of the
// card's groups (membership | key_present, requests_q | counts); req_ok
// [R, I], offer_ok [R, O], custom_need [O, K], available [O] bool; owner [O]
// int32 in [0, I); alloc_q [I, D] int32; price [I] float32; out [*, 4]
// int32 finalized rows. `slabs` holds n_slabs (src, rows, dst) triples, one
// per shard on this card. Returns the launch's cudaError_t.
int kt_group_solve(const void* group_bools, const void* group_ints, const void* req_ok,
                   const void* offer_ok, const void* custom_need, const void* available,
                   const void* owner, const void* alloc_q, const void* price, void* out,
                   const int* slabs, int n_slabs, int R, int K, int O, int I, int D,
                   void* stream) {
  if (I <= 0 || D < 0 || R < 0 || K < 0 || (R + 31) / 32 > MAX_WORDS || (K + 31) / 32 > MAX_WORDS)
    return static_cast<int>(cudaErrorInvalidValue);
  SlabTable table;
  int max_rows;
  if (!read_slabs(slabs, n_slabs, table, max_rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (max_rows == 0) return 0;
  const size_t shmem = static_cast<size_t>((I + 31) / 32) * sizeof(uint32_t);
  if (shmem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(max_rows, 1, n_slabs);
  group_solve_kernel<<<grid, GROUP_THREADS, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(group_bools), static_cast<const int32_t*>(group_ints),
      static_cast<const uint8_t*>(req_ok), static_cast<const uint8_t*>(offer_ok),
      static_cast<const uint8_t*>(custom_need), static_cast<const uint8_t*>(available),
      static_cast<const int32_t*>(owner), static_cast<const int32_t*>(alloc_q),
      static_cast<const float*>(price), static_cast<int32_t*>(out), table, R, K, O, I, D);
  return static_cast<int>(cudaGetLastError());
}

// core [cap, 3] int32 (written in place), slots [n] int32, rows [n, 3] int32
int kt_delta_scatter(void* core, const void* slots, const void* rows, int n, int cap,
                     void* stream) {
  if (n == 0) return 0;
  const int threads = 256, blocks = (n * 3 + threads - 1) / threads;
  delta_scatter_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(core), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(rows), n, cap);
  return static_cast<int>(cudaGetLastError());
}

// core [cap, 3] int32, order [n] int32, counts [n] int32, out [n, 4] int32
int kt_delta_finalize(const void* core, const void* order, const void* counts, void* out, int n,
                      int cap, void* stream) {
  if (n == 0) return 0;
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256, blocks = (n + threads - 1) / threads;
  delta_finalize_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(core), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(out), n, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
