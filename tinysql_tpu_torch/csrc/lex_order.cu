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
// Bound: for the shapes of the main path (six rows for Q1's ORDER BY, some
// ten thousand for Q3's top 10) launch latency; at large n the merge
// passes are bound by the bytes they move: each pass reads and writes
// every lane once, plus a binary search per element.
//
// Design: bitonic sort of shared-memory tiles, then merge passes that
// place each element by its rank (own index + binary search in the other
// run).  A top-k keeps the best k of each tile and re-sorts the survivors
// until one tile holds them all.
#include "lex_sort.cuh"

// lanes: m device pointers (uint64 order-normalised lanes of n rows);
// bufA/bufB: scratch, each m*n uint64 then n int64 positions;
// out_pos: int64[min(k, n)] (k < 0: n) row indices in ascending order.
TS_API int hk4_lex_order(const SortIn* in, int m, int64_t n, int64_t k,
                         uint64_t* bufA, uint64_t* bufB, int64_t* out_pos,
                         cudaStream_t st) {
  if (m < 1 || m > kMaxSortLanes) return -1;
  SortOut a, b;
  for (int l = 0; l < kMaxSortLanes; ++l) {
    a.lanes[l] = l < m ? bufA + (size_t)l * n : nullptr;
    b.lanes[l] = l < m ? bufB + (size_t)l * n : nullptr;
  }
  a.pos = (int64_t*)(bufA + (size_t)m * n);
  b.pos = (int64_t*)(bufB + (size_t)m * n);
  int rc = lex_sort_host(*in, m, n, k, a, b, out_pos, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
