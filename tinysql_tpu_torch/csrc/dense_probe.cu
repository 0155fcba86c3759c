// HK6 dense_probe: the pipeline tier's join probe through a dense
// key -> build-row table.
//
// Replaces tinysql_tpu/executor/devpipe.py:1420-1500 (K18, _JoinNode's
// unique mode: table probe, validity checks and one gather per build
// lane) and :1099-1137 (its semi / anti membership test), whose XLA
// programs did the same per probe row.  The table is memoized per
// replica version on the host (a planner-proven unique column, or the
// group index's key -> group table) and uploaded once.
//
// Per probe row i (the reference's closures; dense_table.cuh takes each
// offset only for keys inside their range, so nothing relies on a wrap):
//   key   = the key lane, or (multi-key, K18's composite mode, devpipe.py
//           :1162-1213) sum((k_j - lo_j) * stride_j) with every k_j inside
//           [lo_j, hi_j]; none when a part is NULL or out of range
//   pos   = tbl[min(key - lo, tbl_len - 1)] for a key inside [lo, hi], else -1
//   match = pos >= 0 and bvalid[clip(pos, 0, nbb - 1)]
//   valid_out = pvalid (left), pvalid and match (inner, semi),
//               pvalid and not match (anti: a NULL key survives)
// and, for inner and left, each build lane gathered at clip(pos) with its
// NULL flag or-ed with (not match).  The composite table is indexed by the
// composite lane itself (lo = 0, hi = its size - 1).
//
// Bound: bytes.  The probe keys, their NULL flags and validity are read
// once, the valid mask written once; per build lane one gathered value and
// flag read and one written per probe row.  One thread per probe row,
// grid-stride, the lanes looped inside: no atomics, no order to fix.
#include "dense_table.cuh"

namespace {

enum ProbeMode { MODE_INNER = 0, MODE_LEFT = 1, MODE_SEMI = 2, MODE_ANTI = 3 };

__global__ void dp_probe(KeySet K, const uint8_t* __restrict__ pvalid,
                         int64_t nb, int64_t lo, int64_t hi,
                         const int32_t* __restrict__ tbl, int64_t tbl_len,
                         const uint8_t* __restrict__ bvalid, int64_t nbb,
                         int mode, GatherLanes G,
                         uint8_t* __restrict__ valid_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nb;
       i += stride) {
    int64_t key = 0;
    const int64_t pos =
        probe_key(K, i, &key) ? table_lookup(tbl, tbl_len, lo, hi, key) : -1;
    const int64_t ps = pos < 0 ? 0 : (pos > nbb - 1 ? nbb - 1 : pos);
    const bool match = pos >= 0 && bvalid[ps];
    const bool pv = pvalid[i] != 0;
    bool v;
    if (mode == MODE_LEFT) v = pv;
    else if (mode == MODE_ANTI) v = pv && !match;
    else v = pv && match;
    valid_out[i] = v ? 1 : 0;
    if (mode == MODE_INNER || mode == MODE_LEFT)
      gather_lanes(G, i, ps, ps, !match);
  }
}

}  // namespace

TS_API int hk6_dense_probe(const KeySet* keys, const uint8_t* pvalid,
                           int64_t nb, int64_t lo, int64_t hi,
                           const int32_t* tbl, int64_t tbl_len,
                           const uint8_t* bvalid, int64_t nbb, int mode,
                           const GatherLanes* lanes, uint8_t* valid_out,
                           cudaStream_t st) {
  if (mode < MODE_INNER || mode > MODE_ANTI || !gather_ok(lanes) ||
      nbb < 1 || nb < 0 || keys->n < 1 || keys->n > kMaxKeys)
    return -1;
  if (nb > 0)
    LAUNCH(dp_probe, grid_for(nb, 256, 1 << 16), 256, 0, st, *keys, pvalid,
           nb, lo, hi, tbl, tbl_len, bvalid, nbb, mode, *lanes, valid_out);
  return (int)cudaGetLastError();
}
