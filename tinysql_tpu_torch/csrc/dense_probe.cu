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
// Per probe row i (the reference's closures, with the offset k - lo taken
// only for keys inside [lo, hi], so nothing relies on a wrap):
//   inr   = lo <= k <= hi and k not NULL
//   pos   = inr ? tbl[min(k - lo, tbl_len - 1)] : -1
//   match = pos >= 0 and bvalid[clip(pos, 0, nbb - 1)]
//   valid_out = pvalid (left), pvalid and match (inner, semi),
//               pvalid and not match (anti: a NULL key survives)
// and, for inner and left, each build lane gathered at clip(pos) with its
// NULL flag or-ed with (not match).
//
// Bound: bytes.  The probe key, its NULL flag and validity are read once,
// the valid mask written once; per build lane one gathered value and flag
// read and one written per probe row.  One thread per probe row,
// grid-stride, the lanes looped inside: no atomics, no order to fix.
#include "common.cuh"

namespace {

enum ProbeMode { MODE_INNER = 0, MODE_LEFT = 1, MODE_SEMI = 2, MODE_ANTI = 3 };

}  // namespace

// Build lanes to gather, passed by value; width is the element size in
// bytes (1, 2, 4 or 8).
struct GatherLanes {
  const void* vals[kMaxLanes];
  const uint8_t* nulls[kMaxLanes];  // null = the lane has no NULLs
  void* out_vals[kMaxLanes];
  uint8_t* out_nulls[kMaxLanes];
  int width[kMaxLanes];
  int n;
};

namespace {

__device__ __forceinline__ void copy_elem(void* dst, const void* src,
                                          int64_t i, int64_t p, int w) {
  if (w == 8) ((int64_t*)dst)[i] = ((const int64_t*)src)[p];
  else if (w == 4) ((int32_t*)dst)[i] = ((const int32_t*)src)[p];
  else if (w == 2) ((int16_t*)dst)[i] = ((const int16_t*)src)[p];
  else ((uint8_t*)dst)[i] = ((const uint8_t*)src)[p];
}

__global__ void dp_probe(const int64_t* __restrict__ kp,
                         const uint8_t* __restrict__ knull,
                         const uint8_t* __restrict__ pvalid, int64_t nb,
                         int64_t lo, int64_t hi,
                         const int32_t* __restrict__ tbl, int64_t tbl_len,
                         const uint8_t* __restrict__ bvalid, int64_t nbb,
                         int mode, GatherLanes G,
                         uint8_t* __restrict__ valid_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nb;
       i += stride) {
    const int64_t k = kp[i];
    int64_t pos = -1;
    if (!knull[i] && k >= lo && k <= hi && tbl_len > 0) {
      unsigned long long off =
          (unsigned long long)k - (unsigned long long)lo;
      if (off > (unsigned long long)(tbl_len - 1))
        off = (unsigned long long)(tbl_len - 1);
      pos = tbl[off];
    }
    const int64_t ps = pos < 0 ? 0 : (pos > nbb - 1 ? nbb - 1 : pos);
    const bool match = pos >= 0 && bvalid[ps];
    const bool pv = pvalid[i] != 0;
    bool v;
    if (mode == MODE_LEFT) v = pv;
    else if (mode == MODE_ANTI) v = pv && !match;
    else v = pv && match;
    valid_out[i] = v ? 1 : 0;
    if (mode == MODE_INNER || mode == MODE_LEFT) {
      for (int j = 0; j < G.n; ++j) {
        copy_elem(G.out_vals[j], G.vals[j], i, ps, G.width[j]);
        const uint8_t bn = G.nulls[j] ? G.nulls[j][ps] : 0;
        G.out_nulls[j][i] = (bn || !match) ? 1 : 0;
      }
    }
  }
}

}  // namespace

TS_API int hk6_dense_probe(const int64_t* kp, const uint8_t* knull,
                           const uint8_t* pvalid, int64_t nb, int64_t lo,
                           int64_t hi, const int32_t* tbl, int64_t tbl_len,
                           const uint8_t* bvalid, int64_t nbb, int mode,
                           const GatherLanes* lanes, uint8_t* valid_out,
                           cudaStream_t st) {
  if (mode < MODE_INNER || mode > MODE_ANTI || lanes->n < 0 ||
      lanes->n > kMaxLanes || nbb < 1 || nb < 0)
    return -1;
  for (int j = 0; j < lanes->n; ++j) {
    const int w = lanes->width[j];
    if (w != 1 && w != 2 && w != 4 && w != 8) return -1;
  }
  if (nb > 0)
    LAUNCH(dp_probe, grid_for(nb, 256, 1 << 16), 256, 0, st, kp, knull,
           pvalid, nb, lo, hi, tbl, tbl_len, bvalid, nbb, mode, *lanes,
           valid_out);
  return (int)cudaGetLastError();
}
