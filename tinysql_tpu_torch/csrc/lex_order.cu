// HK4 lex_order: the ORDER BY permutation and the ORDER BY ... LIMIT top-k.
//
// Replaces tinysql_tpu/ops/kernels.py:2126 sort_permutation (K9, a
// jnp.lexsort program) and :2165-2310 top_k (K10, lax.top_k over a
// total-order score plus a host threshold selection for several keys).
// The caller (ops/kernels.py) order-normalises each sort key into uint64
// lanes: the NULL rank (NULL first ascending, last descending; invalid
// rows ranked after everything), then the value with DESC through ~v for
// integers and -v for floats, and float bits made monotone.  The row index
// is the last lane, which gives lexsort's stability and lax.top_k's
// lowest-index tie-break.
//
// Bound: bytes.  Each key lane read once and the permutation written
// once: one key at 2^23 rows is 64 MB + 64 MB, ~0.04 ms on an H100 at
// 3.35 TB/s; for the main path's small shapes (Q1's 16-row ORDER BY,
// the top 10 of some ten thousand rows) launch latency.
//
// Design (lex_sort.cuh): one tile sorts in shared memory in one launch; a
// top-k of at most a quarter tile keeps the best k of each tile in
// rounds; up to 2^16 rows (a crossover measured on the card) sorted tiles
// and merge passes; every other sort is a stable LSD radix sort over
// 8-bit digits that skips the digits equal in every row (found by one
// histogram pass), so it moves each element once per digit that orders
// something, in one sweep per digit with a decoupled look-back.
#include "lex_sort.cuh"

TS_API int64_t hk4_scratch_bytes(int m, int64_t n, int64_t k) {
  return lex_sort_scratch_bytes(m, n, k);
}

// lanes: m device pointers (uint64 order-normalised lanes of n rows);
// scratch: hk4_scratch_bytes(m, n, k) bytes;
// out_pos: int64[min(k, n)] (k < 0: n) row indices in ascending order.
TS_API int hk4_lex_order(const SortIn* in, int m, int64_t n, int64_t k,
                         void* scratch, int64_t* out_pos, cudaStream_t st) {
  if (m < 1 || m > kMaxSortLanes) return -1;
  int rc = lex_sort_host(*in, m, n, k, scratch, out_pos, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
