// The group solver's kernels, written by hand for Hopper (sm_90a). Built by
// karpenter_tpu_torch/device.py with nvcc (-gencode arch=compute_90a,
// code=sm_90a -O3 --fmad=false) into a shared library with a plain C
// interface, loaded with ctypes. The wrappers, their checks and the plain
// torch versions the kernels are held against live in
// karpenter_tpu_torch/ops/packer.py.
//
// What they replace (karpenter_tpu/ops/packer.py):
//   kt_group_solve     the whole per-group solve, the feasibility cube's two
//                      halves (feasibility.membership_all and
//                      offering_reduce, B8) included, in one launch, in
//                      four output modes: finalized rows for
//                      solve_block_jit (:133-148, B9) and sharded_solve_block
//                      (:217-240, B13: every shard of one card in one
//                      launch); core rows for _solve_block_core (:162-182,
//                      B10); core rows scattered into the delta residency's
//                      core matrix for the frontier pass, which the
//                      reference runs as B10 then delta_scatter_rows
//                      (:185-193, B11); and the scatter followed by the
//                      pass's finalize (delta_finalize, :196-208, B12) in
//                      the launch's last block: a delta pass with a
//                      frontier, B10 + B11 + B12 in one launch.
//   kt_delta_scatter   delta_scatter_rows (B11) on its own: core[slots] =
//                      rows, in place where the reference donates `core`.
//   kt_delta_finalize  delta_finalize (:196-208, B12) on its own, a delta
//                      pass without a frontier: core[order], then the same
//                      finalize as kt_group_solve (one __device__ helper,
//                      so B9 and B12 cannot drift apart).
//
// What bounds them on this card: launch latency and, inside a group
// solve's block, its chain of dependent loads from L2 (every group reads
// the packed offering tables whole). At the group solver's shape (G=200
// groups, R+K=15, I=1008 types, O=8064 offerings, D=4) the bytes a call
// must move are ~0.1 MB and the word operations ~4.4 M: 0.03 and 0.27 us;
// a block takes ~7 us, two to four L2 round trips a phase. The delta
// kernels move a few KB. Integer division rounds toward minus
// infinity (floor_div), as the reference's `//` does, not toward zero as
// C's `/`.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

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

// (v, i, p) takes (v2, i2, p2) when v2 is the lower price, or the same
// price at a lower index: argmin's order, pods-per-node riding along
__device__ __forceinline__ void better(float& v, int& i, int& p, float v2, int i2, int p2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
    p = p2;
  }
}

// A warp's least (price, index) with its pods-per-node, and any-feasible,
// in every lane (xor shuffles: the order is a total one, so every lane ends
// with the same winner)
__device__ __forceinline__ void warp_choice(float& v, int& i, int& p, int& any) {
  for (int o = 16; o; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    const int p2 = __shfl_xor_sync(0xffffffffu, p, o);
    better(v, i, p, v2, i2, p2);
    any |= __shfl_xor_sync(0xffffffffu, any, o);
  }
}

// ---------------------------------------------------------------------------
// kt_group_solve: B9, B10, B13 and the frontier scatter, one launch a call.
//
// One block of GROUP_THREADS per group (blockIdx.x), blockIdx.z indexing the
// slab table (csrc/common.cuh): one slab of every row for B9, B10 and the
// scatter, one per shard on the card for B13. No [G, I] plane reaches device
// memory. The catalog comes packed, built once per catalog generation by
// ops/packer.py pack_catalog: req_words [WR, I] and offer_words [WR, O]
// hold the requirement rows' compatibility with each type and offering as
// bits (bit b of word w: row 32 w + b), need_words [WK, O] each offering's
// custom keys, type_start [I + 1] each type's offering range (offerings are
// owner-major). So a test of a row set or a key set is one coalesced word
// load and an AND a word, where it was one byte load a row or a key.
//   1. pack: each warp turns 32 columns of the group's row (read in place
//      from group_bools) into one word with a ballot: the rows it is
//      constrained by (columns [0, R)) and the custom keys it leaves
//      undefined (columns [R, R+K)); its requests and count to shared
//      memory;
//   then, GROUP_THREADS types at a time (one chunk at the solver's shapes),
//   one type a thread:
//   2. the usable offerings of the chunk's offering range, a window of at
//      most WINDOW_WORDS * 32 at a time, UNROLL a thread with all their
//      loads issued before any test: available, compatible with every row
//      of the group (memw & ~offer_word == 0), needing no key the group
//      leaves undefined (absw & need_word == 0); a ballot makes each warp's
//      32 results one word of a shared bitmask; the type's has_offering is
//      the bits of its range (a word or two of shared memory);
//   3. the type: compat (its words), the alloc_q fit and pods-per-node in
//      one pass over the dims, its price; the thread keeps its least
//      (price, index) and that type's pods-per-node. These loads come after
//      the window pass, so nothing of the type is held in registers across
//      it (the cap is 32 a thread, for two blocks of 1024 on an SM);
//   4. reduction: warp shuffles, one shared-memory row of warp results,
//      warp 0 shuffles again; its lane 0 writes the row. Nothing is loaded
//      from global memory after the reduction.
// Why this shape: the phase splits of two earlier designs (PERF.md): one
// thread an offering setting its owner's bit with shared atomics spent
// 71% of a block in that pass, and one thread a type walking its own
// offerings one at a time, a byte load a row and a key each, still 80%.
//
// Output modes: MODE_FINALIZE writes out[row] = (choice, feasible, nodes,
// unschedulable), MODE_CORE out[row] = (choice, feasible, pods-per-node),
// MODE_SCATTER the core row at out[slots[row]] of the [cap, 3] core matrix:
// a negative slot counts from the end and a slot outside [0, cap) is
// dropped (the reference's core.at[slots].set(rows)); edge-padded duplicate
// slots carry rows that solve to equal values, so their writes agree.
// MODE_PASS scatters as MODE_SCATTER, then finalizes the pass in the last
// block to finish (one slab only): each block's writing thread writes its
// core row, fences (__threadfence) and counts itself in `counter`, which
// the C entry zeroes on the launch's stream first; the block that counts
// last gathers fout[j] = finalize(core[order[j]], counts[j]) for j < n_out,
// an order entry counting from the end when negative and clamped into
// [0, cap) (the reference's gather), reading the core past L1 (__ldcg) so
// that it sees every other block's row.
//
// `stamps`, null on every solve path, else STAMP_HEAD + 3 G uint64: block 0
// writes %globaltimer (ns) at its start and after phases 1, 2 (the first
// window), 3 (every chunk) and 4 into [0, 5), clock64 at the same points
// into [5, 10); every block's writing thread folds its start and end into
// [10] (least start), [11] (greatest end), [12] (greatest start) and [13]
// (longest block), and writes its start, end and SM into
// [STAMP_HEAD + 3 row, + 3).
constexpr int GROUP_THREADS = 1024;
constexpr int GROUP_WARPS = GROUP_THREADS / 32;
constexpr int WINDOW_WORDS = 1024;  // offerings whose usable bits a block holds: 32,768
constexpr int UNROLL = 4;           // offerings a thread tests at once in a window
constexpr int STAMP_HEAD = 16;
constexpr int MODE_FINALIZE = 0, MODE_CORE = 1, MODE_SCATTER = 2, MODE_PASS = 3;
// the most dynamic shared memory a block may take on sm_90 (227 KB), less
// the static arrays
constexpr size_t MAX_DYNAMIC_SMEM = 232448 - 1024 - WINDOW_WORDS * sizeof(uint32_t);

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

__device__ __forceinline__ void stamp(unsigned long long* stamps, bool timer, int k) {
  if (timer) {
    stamps[k] = global_ns();
    stamps[5 + k] = static_cast<unsigned long long>(clock64());
  }
}

// Any set bit of bits[a, e), a bitmask of 32-bit words
__device__ __forceinline__ bool any_bit(const uint32_t* bits, int a, int e) {
  for (int k = a; k < e;) {
    const int sh = k & 31, take = min(32 - sh, e - k);
    uint32_t v = bits[k >> 5] >> sh;
    if (take < 32) v &= (1u << take) - 1u;
    if (v) return true;
    k += take;
  }
  return false;
}

// MODE_PASS's tail, run by the block that counted last: fout[j] =
// finalize(core[order[j]], counts[j]) over every core row, the other
// blocks' included, read past L1.
__device__ void pass_finalize(const int32_t* core, const int32_t* __restrict__ order,
                                           const int32_t* __restrict__ counts,
                                           int32_t* __restrict__ fout, int n_out, int cap) {
  __threadfence();
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    int o = order[j];
    if (o < 0) o += cap;
    o = o < 0 ? 0 : (o > cap - 1 ? cap - 1 : o);
    const int32_t* c = core + static_cast<size_t>(o) * 3;
    finalize_row(__ldcg(c), __ldcg(c + 1) != 0, __ldcg(c + 2), counts[j],
                 fout + static_cast<size_t>(j) * 4);
  }
}

// PASS: the instance MODE_PASS launches; the other modes' instance holds
// no code of the pass's tail, so the solve keeps its register allocation
// (at the 32-register cap two blocks of 1024 a SM allow, the tail's
// presence alone added spills and ~1.5 us a block, PERF.md).
template <bool PASS>
__global__ void __launch_bounds__(GROUP_THREADS, 2) group_solve_kernel(
    const uint8_t* __restrict__ group_bools, const int32_t* __restrict__ group_ints,
    const uint32_t* __restrict__ req_words, const uint32_t* __restrict__ offer_words,
    const uint32_t* __restrict__ need_words, const uint8_t* __restrict__ available,
    const int32_t* __restrict__ type_start, const int32_t* __restrict__ alloc_q,
    const float* __restrict__ price, int32_t* __restrict__ out, const int32_t* __restrict__ slots,
    int cap, int mode, const SlabTable slabs, int R, int K, int O, int I, int D,
    unsigned long long* __restrict__ stamps, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, int32_t* __restrict__ fout, int n_out,
    unsigned int* __restrict__ counter) {
  extern __shared__ int32_t smem[];
  __shared__ uint32_t bits[WINDOW_WORDS];  // usable offerings of the window
  __shared__ float s_v[GROUP_WARPS];
  __shared__ int s_i[GROUP_WARPS], s_p[GROUP_WARPS], s_any[GROUP_WARPS];
  __shared__ bool s_last;  // MODE_PASS: this block counted last
  const int z = blockIdx.z;
  if (static_cast<int>(blockIdx.x) >= slabs.rows[z]) return;  // the whole block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ unsigned long long s_start;  // the block's start, for the stamps (not a live register)
  const bool timer = stamps != nullptr && blockIdx.x == 0 && z == 0 && tid == 0;
  if (stamps != nullptr && tid == 0) s_start = global_ns();
  stamp(stamps, timer, 0);
  const size_t g = static_cast<size_t>(slabs.src[z]) + blockIdx.x;
  const int WR = (R + 31) / 32, WK = (K + 31) / 32;
  uint32_t* memw = reinterpret_cast<uint32_t*>(smem);  // [WR] the group's rows
  uint32_t* absw = memw + WR;                          // [WK] the keys it leaves undefined
  int32_t* req = smem + WR + WK;                       // [D + 1] requests_q, then the count

  // 1. pack
  const uint8_t* row = group_bools + g * (R + K);
  for (int w = warp; w < WR + WK; w += GROUP_WARPS) {  // warp-uniform: the ballot's mask is full
    const bool is_row = w < WR;
    const int col = is_row ? w * 32 + lane : R + (w - WR) * 32 + lane;
    const bool bit = col < (is_row ? R : R + K) && ((row[col] != 0) == is_row);
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) {
      if (is_row) memw[w] = word;
      else absw[w - WR] = word;
    }
  }
  for (int d = tid; d <= D; d += GROUP_THREADS) req[d] = group_ints[g * (D + 1) + d];
  __syncthreads();
  stamp(stamps, timer, 1);

  float best_v = __int_as_float(0x7f800000);  // +inf: every real type beats it on index
  int best_i = INT32_MAX_V, best_p = 0, any = 0;
  for (int c0 = 0; c0 < I; c0 += GROUP_THREADS) {
    // 2. the usable offerings of the chunk's offering range
    const int lo = type_start[c0], hi = type_start[min(c0 + GROUP_THREADS, I)];
    const int t = c0 + tid;
    const bool valid = t < I;
    const int my_lo = valid ? type_start[t] : 0, my_hi = valid ? type_start[t + 1] : 0;
    bool has = false;
    for (int w0 = lo; w0 < hi; w0 += WINDOW_WORDS * 32) {
      const int wend = min(w0 + WINDOW_WORDS * 32, hi);
      __syncthreads();  // the last window's bits are read
      // UNROLL offerings a thread at a time, every load of them issued
      // before any is tested (no test waits on another's load)
      for (int ob = w0 + warp * 32; ob < wend; ob += GROUP_THREADS * UNROLL) {  // warp-uniform
        bool ok[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int o = ob + u * GROUP_THREADS + lane;
          ok[u] = o < wend && available[o] != 0;
        }
        for (int w = 0; w < WR; ++w) {
          const uint32_t mw = memw[w];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int o = ob + u * GROUP_THREADS + lane;
            if (o < wend) ok[u] &= (mw & ~offer_words[static_cast<size_t>(w) * O + o]) == 0;
          }
        }
        for (int w = 0; w < WK; ++w) {
          const uint32_t aw = absw[w];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int o = ob + u * GROUP_THREADS + lane;
            if (o < wend) ok[u] &= (aw & need_words[static_cast<size_t>(w) * O + o]) == 0;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const uint32_t word = __ballot_sync(0xffffffffu, ok[u]);
          const int base = ob + u * GROUP_THREADS;  // the warp's first offering of this step
          if (lane == 0 && base < wend) bits[(base - w0) >> 5] = word;
        }
      }
      __syncthreads();
      if (c0 == 0 && w0 == lo) stamp(stamps, timer, 2);
      if (!has) has = any_bit(bits, max(my_lo, w0) - w0, min(my_hi, wend) - w0);
    }
    // 3. the type: compat, the fit, pods-per-node, then its price
    if (valid) {
      const float pr = price[t];  // loaded with the type's other loads, not after its tests
      bool f = has;
      for (int w = 0; w < WR; ++w)  // compat: every row of the group
        f &= (memw[w] & ~req_words[static_cast<size_t>(w) * I + t]) == 0;
      int m = INT32_MAX_V;  // pods-per-node: the least floor(alloc / request) over requested dims
      for (int d = 0; d < D; ++d) {
        const int a = alloc_q[static_cast<size_t>(t) * D + d], r = req[d];
        f &= r <= a;
        const int per = r > 0 ? floor_div(a, r) : INT32_MAX_V;
        m = per < m ? per : m;
      }
      any |= f;
      better(best_v, best_i, best_p, f ? pr : INF_PRICE, t, m > 0 ? m : 0);
    }
  }
  if (stamps != nullptr) __syncthreads();
  stamp(stamps, timer, 3);

  // 4. reduction
  warp_choice(best_v, best_i, best_p, any);
  if (lane == 0) {
    s_v[warp] = best_v;
    s_i[warp] = best_i;
    s_p[warp] = best_p;
    s_any[warp] = any;
  }
  __syncthreads();
  if constexpr (!PASS) {
    if (warp != 0) return;
  }
  if (warp == 0) {
    best_v = lane < GROUP_WARPS ? s_v[lane] : __int_as_float(0x7f800000);
    best_i = lane < GROUP_WARPS ? s_i[lane] : INT32_MAX_V;
    best_p = lane < GROUP_WARPS ? s_p[lane] : 0;
    any = lane < GROUP_WARPS ? s_any[lane] : 0;
    warp_choice(best_v, best_i, best_p, any);
    if (lane == 0) {
      stamp(stamps, timer, 4);
      const int choice = best_i, ppn = best_p;
      const bool feasible = any != 0;
      const size_t r = static_cast<size_t>(slabs.dst[z]) + blockIdx.x;
      if (mode == MODE_FINALIZE) {
        finalize_row(choice, feasible, ppn, req[D], out + r * 4);
      } else {
        int32_t* o3 = out + r * 3;
        if (mode != MODE_CORE) {
          int slot = slots[r];
          if (slot < 0) slot += cap;
          o3 = (slot >= 0 && slot < cap) ? out + static_cast<size_t>(slot) * 3 : nullptr;
        }
        if (o3 != nullptr) {
          o3[0] = choice;
          o3[1] = feasible ? 1 : 0;
          o3[2] = ppn;
        }
      }
      if constexpr (PASS) {
        __threadfence();  // the row is visible to every block before it is counted
        s_last = atomicAdd(counter, 1u) == static_cast<unsigned>(slabs.rows[0]) - 1u;
      }
      if (stamps != nullptr) {
        const unsigned long long t_start = s_start, t_end = global_ns();
        atomicMin(&stamps[10], t_start);
        atomicMax(&stamps[11], t_end);
        atomicMax(&stamps[12], t_start);
        atomicMax(&stamps[13], t_end - t_start);
        unsigned long long* mine = stamps + STAMP_HEAD + 3 * r;
        mine[0] = t_start;
        mine[1] = t_end;
        mine[2] = sm_id();
      }
    }
  }
  if constexpr (PASS) {
    __syncthreads();
    if (s_last) pass_finalize(out, order, counts, fout, n_out, cap);  // the whole block
  }
}

// Dynamic shared memory of one group_solve_kernel block: the group's row
// and absent-key words, its requests and count.
size_t group_smem_bytes(int R, int K, int D) {
  return (static_cast<size_t>((R + 31) / 32) + (K + 31) / 32 + D + 1) * sizeof(int32_t);
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

// group_bools [*, R+K] bool and group_ints [*, D+1] int32 group rows
// (membership | key_present, requests_q | counts); the packed catalog:
// req_words [WR, I], offer_words [WR, O], need_words [WK, O] uint32 (held
// in int32), available [O] bool, type_start [I+1] int32 (non-decreasing,
// type_start[I] <= O); alloc_q [I, D] int32; price [I] float32. mode 0: out
// [*, 4] finalized rows; mode 1: out [*, 3] core rows; mode 2: out the
// [cap, 3] core matrix, row j written at slots[j]; mode 3: as mode 2, then
// fout [n_out, 4] = the finalized core rows order [n_out] gathers, against
// counts [n_out] int32, `counter` one uint32 of the caller's (zeroed here,
// on `stream`, before the launch), one slab of at least one row. `slabs`
// holds n_slabs (src, rows, dst) triples. stamps: null, or STAMP_HEAD + 3
// * (rows written) uint64 (see group_solve_kernel). order, counts, fout
// and counter are null outside mode 3. Returns the launch's cudaError_t.
int kt_group_solve(const void* group_bools, const void* group_ints, const void* req_words,
                   const void* offer_words, const void* need_words, const void* available,
                   const void* type_start, const void* alloc_q, const void* price, void* out,
                   const void* slots, int cap, int mode, const int* slabs, int n_slabs, int R,
                   int K, int O, int I, int D, void* stamps, const void* order,
                   const void* counts, void* fout, int n_out, void* counter, void* stream) {
  if (I <= 0 || D < 0 || R < 0 || K < 0 || O < 0 || mode < MODE_FINALIZE || mode > MODE_PASS ||
      (mode >= MODE_SCATTER && (slots == nullptr || cap < 0)) ||
      (mode == MODE_PASS && (n_slabs != 1 || cap <= 0 || n_out < 0 || counter == nullptr ||
                             (n_out > 0 && (order == nullptr || counts == nullptr || fout == nullptr)))))
    return static_cast<int>(cudaErrorInvalidValue);
  SlabTable table;
  int max_rows;
  if (!read_slabs(slabs, n_slabs, table, max_rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (max_rows == 0) return mode == MODE_PASS ? static_cast<int>(cudaErrorInvalidValue) : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_PASS) {
    const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t shmem = group_smem_bytes(R, K, D);
  if (shmem > MAX_DYNAMIC_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = mode == MODE_PASS ? group_solve_kernel<true> : group_solve_kernel<false>;
  if (shmem > 48 * 1024 - WINDOW_WORDS * sizeof(uint32_t) - 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(max_rows, 1, n_slabs);
  kernel<<<grid, GROUP_THREADS, shmem, s>>>(
      static_cast<const uint8_t*>(group_bools), static_cast<const int32_t*>(group_ints),
      static_cast<const uint32_t*>(req_words), static_cast<const uint32_t*>(offer_words),
      static_cast<const uint32_t*>(need_words), static_cast<const uint8_t*>(available),
      static_cast<const int32_t*>(type_start), static_cast<const int32_t*>(alloc_q),
      static_cast<const float*>(price), static_cast<int32_t*>(out),
      static_cast<const int32_t*>(slots), cap, mode, table, R, K, O, I, D,
      static_cast<unsigned long long*>(stamps), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(fout), n_out,
      static_cast<unsigned int*>(counter));
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
