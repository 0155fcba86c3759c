// HK5 csr_reduce: the per-group reduction of the pipeline tier's GROUP BY
// over the memoized group index.
//
// Replaces tinysql_tpu/executor/devpipe.py:757-963 (K17, _AggIndexNode
// over GroupIndex at :296), whose XLA program gathered each lane into the
// index's sorted order, took a cumsum and differenced it at the group
// boundaries (sums and counts), and ran segment_min / segment_max over a
// per-position group id lane.  Here the group index itself is the layout:
// group g owns the sorted positions [ends[g - 1] + 1, ends[g]], and a
// thread (or, for a long group, a set of blocks) reduces that run.
//
// Inputs: order int64[nb] (sorted position -> row; positions at or past
// n_rows are padding and are never read), ends int64[ngb] (last sorted
// position of each group; groups at or past ng are padding and stay
// empty), valid bool in row space, and up to kMaxLanes - 1 lanes in row
// space (the presence pseudo-lane takes the last slot).
//
// Output: HK2's table layout, int64[(2 + 2 * L.n) * ngb]: presence (valid
// rows per group), first valid row (sentinel n_rows when none), then per
// lane the value bits and the live count; empty groups hold the identity.
//
// Bound: bytes.  order and valid are read once over the live rows (sorted
// positions below n_rows), each lane's values and NULL mask once over them,
// ends once over the ng real groups; the table is written once.
//
// Design, in two routes chosen on the host by the group count:
// - ng <= kSmallSeg (TPC-H Q1: 4 live groups, each a quarter of lineitem
//   spread over it): reduce in row order, not through the sorted order.
//   One pass reads `order` once over the live positions, with `ends` in
//   shared memory, and writes each named row's group as a byte into a
//   row -> group map in the scratch (rows no live position names, and
//   rows at or past n_rows, keep "no group"); then few_reduce.cuh, the
//   body of HK2's few-segment regime, reduces the rows in row order over
//   that map: every lane read coalesced and once, each group summing its
//   own rows.  The live positions must name distinct rows, as a group
//   index (a stable argsort of the rows) does.
// - more groups: one thread per group walks its run in sorted order;
//   rows ascend within a group (the index comes from a stable sort), so
//   the first valid row met is the group's first.  A group of more than
//   kLongRun rows (a skewed key) goes to run_reduce.cuh's long-run queue:
//   kChunk-row chunks, a block each, folded in chunk order, with presence
//   and first row as a pseudo-lane.
// Float sums therefore have a fixed order and the result is bit-identical
// from run to run; the reference instead folded a running prefix sum's
// rounding into each group, within its 1e-6 relative bound.  Float
// min/max compare order keys (-0.0 < +0.0), as HK2 does.
//
// Bound of the few-group route's extra traffic: the map's byte a row,
// written once and read once.
#include "few_reduce.cuh"
#include "run_reduce.cuh"

namespace {

// sorted position -> row, -1 for an invalid row
struct CsrRows {
  const int64_t* order;
  const uint8_t* valid;
  __device__ int64_t operator()(int64_t q) const {
    const int64_t r = order[q];
    return valid[r] ? r : -1;
  }
};

__global__ void cr_groups(const int64_t* __restrict__ order,
                          const int64_t* __restrict__ ends,
                          const uint8_t* __restrict__ valid, int64_t n_rows,
                          int64_t ng, int64_t ngb, Lanes L,
                          int64_t* __restrict__ out, LongQueue Q) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < ng;
       g += stride) {
    int64_t s = g > 0 ? ends[g - 1] + 1 : 0;
    int64_t e = ends[g] + 1;
    if (s < 0) s = 0;
    if (e > n_rows) e = n_rows;  // padding positions map to row 0
    if (e <= s) continue;
    if (e - s > kLongRun) {
      queue_long_run(Q, g, s, e);
      continue;
    }
    int64_t cnt = 0, first = n_rows;
    for (int64_t q = s; q < e; ++q) {
      const int64_t r = order[q];
      if (!valid[r]) continue;
      first = r < first ? r : first;
      ++cnt;
    }
    out[g] = cnt;
    out[ngb + g] = first;
    for (int j = 0; j < L.n; ++j) {
      const uint8_t* nm = L.nulls[j];
      const int kind = L.kind[j], op = L.op[j];
      Acc a = acc_init(op);
      for (int64_t q = s; q < e; ++q) {
        const int64_t r = order[q];
        if (!valid[r] || (nm && nm[r])) continue;
        acc_row(a, kind, op, L.vals[j], r);
      }
      acc_store(a, kind, op, j, g, ngb, out);
    }
  }
}

// The few-group route's row -> group map: map[order[q]] = the group of
// sorted position q (the first g < ng with ends[g] >= q) for the live
// positions q < n_rows whose row lies in [0, n_rows); every other byte
// keeps kNone from the memset before.
__global__ void cr_map(const int64_t* __restrict__ order,
                       const int64_t* __restrict__ ends, int64_t n_rows,
                       int ng, uint8_t* __restrict__ map) {
  __shared__ int64_t s_ends[kSmallSeg];
  for (int g = threadIdx.x; g < ng; g += blockDim.x) s_ends[g] = ends[g];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < n_rows; q += stride) {
    int lo = 0, hi = ng;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_ends[mid] >= q) hi = mid;
      else lo = mid + 1;
    }
    if (lo == ng) continue;
    const int64_t r = order[q];
    if (r >= 0 && r < n_rows) map[r] = (uint8_t)lo;
  }
}

}  // namespace

// the larger of the two routes' scratch: the long-run queue, or the map
// (16-byte aligned) and the tile partials at kSmallSeg groups
TS_API int64_t hk5_scratch_bytes(int64_t n_rows, int nlanes) {
  const int64_t few =
      align16(n_rows) + few_part_bytes(1, n_rows, kSmallSeg, nlanes);
  const int64_t runs = long_queue_bytes(n_rows, nlanes + 1);
  return few > runs ? few : runs;
}

TS_API int hk5_csr_reduce(const int64_t* order, const int64_t* ends,
                          const uint8_t* valid, int64_t n_rows, int64_t ng,
                          int64_t ngb, const Lanes* lanes, void* scratch,
                          int64_t* out, cudaStream_t st) {
  if (lanes->n < 0 || lanes->n >= kMaxLanes || ngb < 1 || ng < 0 ||
      ng > ngb || n_rows < 0)
    return -1;
  if (ng > 0 && ng <= kSmallSeg) {
    uint8_t* map = (uint8_t*)scratch;
    if (n_rows > 0) {
      cudaMemsetAsync(map, (int)kNone, n_rows, st);
      LAUNCH(cr_map, grid_for(n_rows, 256, 4096), 256, 0, st, order, ends,
             n_rows, (int)ng, map);
    }
    const LaneStrides none = {};
    return few_reduce(MapKeys{map}, valid, 0, 1, n_rows, (int)ng, ngb,
                      *lanes, none, (FewPart*)(map + align16(n_rows)), out,
                      n_rows, st);
  }
  const LongQueue q = long_queue_at(scratch, n_rows);
  LAUNCH(run_init, grid_for((2 + 2 * lanes->n) * ngb, 256, 1 << 16), 256, 0,
         st, *lanes, ngb, n_rows, out, q.runs);
  if (ng > 0 && n_rows > 0) {
    LAUNCH(cr_groups, grid_for(ng, 256, 1 << 16), 256, 0, st, order, ends,
           valid, n_rows, ng, ngb, *lanes, out, q);
    if (n_rows > kLongRun) {
      LAUNCH(run_chunk_partials<CsrRows>, kLBlocks, kLThreads, 0, st,
             CsrRows{order, valid}, *lanes, 1, q);
      LAUNCH(run_long_fold,
             grid_for(long_cap_runs(n_rows) * (lanes->n + 1), 256, 1024), 256,
             0, st, *lanes, 1, ngb, n_rows, q, out);
    }
  }
  return (int)cudaGetLastError();
}
