// HK11 shard_merge: the psum / pmin / pmax of the mesh tier's partial
// tables.
//
// Replaces the cross-shard merges of tinysql_tpu/ops/kernels.py:1474
// fused_segment_aggregate_sharded (K11: presence psum, first-row pmin,
// per-lane psum / pmin / pmax over the "shard" axis) and
// tinysql_tpu/ops/shardops.py:480 fused_scalar_aggregate_sharded (K25's
// scalar aggregate: n_valid psum, first valid row pmin, per-lane psum /
// pmin / pmax).  The port's mesh is N virtual shards on one card, so
// the per-shard partial tables (HK2 or HK1 over each shard's row range)
// lie side by side in one int64 tensor parts[n][rows][width], and one
// launch folds them into out[rows][width].
//
// Per row r, ops[r] says how its column folds over the shards:
//   SUM_I / SUM_F   int64 sum with wrap / float64 sum
//   MIN_I / MAX_I   int64 min / max
//   MIN_F / MAX_F   float64 min / max, NaN if any shard's partial is NaN
//                   (jnp.min / jnp.max over all rows; XLA:CPU's pmin
//                   drops NaN partials, ROADMAP R10)
//   FIRST_SEG       K11's first row: a shard's local first >= shard_rows
//                   (HK2's "no row" sentinel) becomes nb - 1, else
//                   local + s * shard_rows; then min
//   FIRST_SCALAR    K25's first valid row: a shard whose row 0 (n_valid)
//                   is 0 gives nb, else local + s * shard_rows; min; a
//                   merged value >= nb becomes 0
//
// Design: one thread per output element loops over the shards in
// ascending order, so every fold is the same left fold on every run (no
// atomics): float sums are bit-identical from run to run, and the plain
// version (kernels.shard_merge_plain), folding in the same order, agrees
// byte for byte.  Neighbouring threads read neighbouring columns of one
// shard's row, so each shard's table streams once, coalesced.
//
// Bound: bytes.  Every partial is read once (n * rows * width * 8 B) and
// every output written once (rows * width * 8 B); a few operations per
// 8-byte word.
#include "common.cuh"

namespace {

enum MergeOp {
  M_SUM_I = 0, M_SUM_F = 1, M_MIN_I = 2, M_MAX_I = 3, M_MIN_F = 4,
  M_MAX_F = 5, M_FIRST_SEG = 6, M_FIRST_SCALAR = 7
};

constexpr int kMaxMergeRows = 64;  // kernels._MERGE_ROWS
constexpr int kThreads = 256;

struct MergeOps {
  int op[kMaxMergeRows];
};

__global__ void sm_merge(const int64_t* __restrict__ parts, int n, int rows,
                         int64_t width, int row0, int nrows, MergeOps ops,
                         int64_t shard_rows, int64_t nb,
                         int64_t* __restrict__ out) {
  const int64_t plane = (int64_t)rows * width;  // one shard's table
  const int64_t total = (int64_t)nrows * width;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       k < total; k += stride) {
    const int rr = (int)(k / width);
    const int64_t w = k - (int64_t)rr * width;
    const int op = ops.op[rr];
    const int64_t e = (int64_t)(row0 + rr) * width + w;
    const int64_t* p = parts + e;
    int64_t acc;
    if (op == M_FIRST_SEG || op == M_FIRST_SCALAR) {
      acc = kI64Max;
      for (int s = 0; s < n; ++s) {
        const int64_t loc = p[s * plane];
        int64_t g;
        if (op == M_FIRST_SEG) {
          g = loc >= shard_rows ? nb - 1 : loc + (int64_t)s * shard_rows;
        } else {  // row 0 of the shard's table is its n_valid
          g = parts[s * plane + w] == 0 ? nb
                                        : loc + (int64_t)s * shard_rows;
        }
        acc = g < acc ? g : acc;
      }
      if (op == M_FIRST_SCALAR && acc >= nb) acc = 0;
    } else if (op == M_SUM_F || op == M_MIN_F || op == M_MAX_F) {
      double a = bits_to_f64(p[0]);
      for (int s = 1; s < n; ++s) {
        const double x = bits_to_f64(p[s * plane]);
        if (op == M_SUM_F) {
          a = a + x;
        } else {
          const bool better = op == M_MIN_F ? x < a : x > a;
          if (!is_nan_f64(a) && (is_nan_f64(x) || better)) a = x;
        }
      }
      acc = f64_to_bits(a);
    } else {
      acc = p[0];
      for (int s = 1; s < n; ++s) {
        const int64_t x = p[s * plane];
        if (op == M_SUM_I) acc = wrap_add(acc, x);
        else if (op == M_MIN_I) acc = x < acc ? x : acc;
        else acc = x > acc ? x : acc;
      }
    }
    out[e] = acc;
  }
}

}  // namespace

// parts: int64 [n][rows][width]; out: int64 [rows][width].  One launch
// folds rows [row0, row0 + nrows) (nrows <= kMaxMergeRows); ops: int32
// [nrows] in host memory, copied into the launch's parameters.
TS_API int hk11_shard_merge(const int64_t* parts, int n, int rows,
                            int64_t width, int row0, int nrows,
                            const int* ops, int64_t shard_rows, int64_t nb,
                            int64_t* out, cudaStream_t st) {
  if (n < 1 || rows < 1 || width < 1 || nrows < 1 || nrows > kMaxMergeRows
      || row0 < 0 || row0 + nrows > rows)
    return -1;
  MergeOps m;
  for (int r = 0; r < kMaxMergeRows; ++r) m.op[r] = r < nrows ? ops[r] : 0;
  const int64_t total = (int64_t)nrows * width;
  LAUNCH(sm_merge, grid_for(total, kThreads, 1 << 20), kThreads, 0, st,
         parts, n, rows, width, row0, nrows, m, shard_rows, nb, out);
  return (int)cudaGetLastError();
}
