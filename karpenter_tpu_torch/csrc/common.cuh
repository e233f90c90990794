// What the mesh kernels of csrc/feasibility.cu (kt_cube_fused) and
// csrc/packer.cu (kt_group_solve) share: the slab table. A header, not a
// source: karpenter_tpu_torch/device.py compiles each *.cu on its own and
// hashes the headers into every library's build key.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The shards one launch covers on one card (blockIdx.z indexes them): each
// shard's first row in the card's entity operands, its row count, and its
// first row in the output (card 0's output is the gathered result, so its
// shards write at their own rows; another card's shards write one after
// the other, for one copy back). Passed by value, as a kernel parameter.
constexpr int MAX_SLABS = 64;

struct SlabTable {
  int n;
  int src[MAX_SLABS];
  int rows[MAX_SLABS];
  int dst[MAX_SLABS];
};

// The table from the C entry point's flat (src, rows, dst) triples; false
// when there are none or more than MAX_SLABS. max_rows: the most rows of a
// shard, the grid's extent over the rows.
inline bool read_slabs(const int* flat, int n, SlabTable& table, int& max_rows) {
  if (n <= 0 || n > MAX_SLABS) return false;
  table.n = n;
  max_rows = 0;
  for (int z = 0; z < n; ++z) {
    table.src[z] = flat[3 * z];
    table.rows[z] = flat[3 * z + 1];
    table.dst[z] = flat[3 * z + 2];
    max_rows = table.rows[z] > max_rows ? table.rows[z] : max_rows;
  }
  return true;
}

}  // namespace
