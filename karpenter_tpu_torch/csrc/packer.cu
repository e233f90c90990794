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

// One block per group g: feasible[i] = compat & has_offering & fits, the
// least (price, index) over the feasible types (3.4e38 for the others),
// pods-per-node of the chosen type; then the core row or the finalized row.
__global__ void __launch_bounds__(BLOCK_THREADS) solve_block_kernel(
    const uint8_t* __restrict__ compat, const uint8_t* __restrict__ has_offering,
    const int32_t* __restrict__ group_ints, const int32_t* __restrict__ alloc_q,
    const float* __restrict__ price, int32_t* __restrict__ out, int I, int D, int finalize) {
  __shared__ float s_v[NWARPS];
  __shared__ int s_i[NWARPS];
  __shared__ int s_any[NWARPS];
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* req = group_ints + static_cast<size_t>(g) * (D + 1);
  const uint8_t* cg = compat + static_cast<size_t>(g) * I;
  const uint8_t* hg = has_offering + static_cast<size_t>(g) * I;
  float best_v = __int_as_float(0x7f800000);  // +inf: every real type beats it on index
  int best_i = INT32_MAX_V;
  int any = 0;
  for (int i = tid; i < I; i += BLOCK_THREADS) {
    bool f = cg[i] && hg[i];
    for (int d = 0; d < D && f; ++d) f = req[d] <= alloc_q[static_cast<size_t>(i) * D + d];
    any |= f;
    better(best_v, best_i, f ? price[i] : INF_PRICE, i);
  }
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
  if (tid != 0) return;
  for (int w = 1; w < NWARPS; ++w) {
    better(best_v, best_i, s_v[w], s_i[w]);
    any |= s_any[w];
  }
  const int choice = best_i;
  int m = INT32_MAX_V;
  for (int d = 0; d < D; ++d) {
    const int r = req[d];
    const int per = r > 0 ? floor_div(alloc_q[static_cast<size_t>(choice) * D + d], r) : INT32_MAX_V;
    m = per < m ? per : m;
  }
  const int ppn = m > 0 ? m : 0;
  if (finalize) {
    finalize_row(choice, any != 0, ppn, req[D], out + static_cast<size_t>(g) * 4);
  } else {
    int32_t* o3 = out + static_cast<size_t>(g) * 3;
    o3[0] = choice;
    o3[1] = any ? 1 : 0;
    o3[2] = ppn;
  }
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
