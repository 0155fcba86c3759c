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
// flag read and one written per probe row.  No atomics, no order to fix.
//
// Design.  A probe row is a chain of dependent loads (key, table entry,
// build validity, each lane's value and NULL flag), and each random read
// costs a 32-byte sector of L2 (or HBM) traffic whatever its width: at
// Q3's join 1 six such sectors a row.  Two measures:
//
// - Rows in flight: a thread takes kDpRows consecutive probe rows and
//   issues each level of loads for all of them before the next level
//   starts (keys with 16-byte loads, NULL flags and validity 8 bytes at a
//   time, then the table entries, then the build side).  A lane's width
//   is decided once a lane, outside the row loop; the valid mask, the
//   gathered values and their NULL flags are stored packed (8 or 16
//   bytes a store).  The lane table is a __grid_constant__ parameter
//   copied once a block into shared memory, so the lane loop indexes it
//   there and nothing goes to local memory.
// - Records: when they pay (the wrapper's rule, kernels._dense_records,
//   on nb, nbb, the table's length and the lanes), `dp_pack` first writes
//   one record a table slot, and one more for keys with no slot: a flag
//   word (bit 0 "the slot names a valid build row", bit 1 + l lane l's
//   NULL flag), then each lane's value zero-extended to 8 bytes, of the
//   build row the slot names (clipped as the probe clips it), padded to
//   a multiple of 16 bytes.  A probe row then reads its record 16 bytes
//   a load (flags and lane 0, then two lanes a load) and nothing else of
//   the build side or the table: each random load is one request to L2
//   whatever its width, so at Q3's join 1 (two lanes with NULL masks) a
//   row makes 2 requests instead of 6.  Records indexed by build row (the
//   table entry, then the record) were measured too and lost to these
//   at every shape where either paid.
#include "dense_table.cuh"

namespace {

enum ProbeMode { MODE_INNER = 0, MODE_LEFT = 1, MODE_SEMI = 2, MODE_ANTI = 3 };

constexpr int kDpThreads = 256;
constexpr int kDpRows = 4;  // probe rows a thread, their loads in flight

// One build lane of W-byte values gathered at ps for rows [i0, i0 + nr):
// the values, then the NULL flags (or-ed with "unmatched"), each level's
// loads issued for every row before the stores.
template <int W>
__device__ __forceinline__ void gather_rows(
    const void* vals, const uint8_t* nulls, void* out_vals,
    uint8_t* out_nulls, int64_t i0, int nr, const int64_t (&ps)[kDpRows],
    const bool (&match)[kDpRows]) {
  using T = typename Elem<W>::T;
  const T* src = (const T*)vals;
  T v[kDpRows];
  uint8_t nl[kDpRows];
#pragma unroll
  for (int r = 0; r < kDpRows; ++r) v[r] = r < nr ? __ldg(src + ps[r]) : T(0);
#pragma unroll
  for (int r = 0; r < kDpRows; ++r)
    nl[r] = nulls && r < nr ? __ldg(nulls + ps[r]) : 0;
#pragma unroll
  for (int r = 0; r < kDpRows; ++r) nl[r] = (nl[r] || !match[r]) ? 1 : 0;
  put_rows<kDpRows>((T*)out_vals, i0, nr, v);
  put_rows<kDpRows>(out_nulls, i0, nr, nl);
}

// One lane's values out of the records (8-byte slots) as W-byte values.
template <int W>
__device__ __forceinline__ void put_record_rows(
    void* out_vals, int64_t i0, int nr,
    const unsigned long long (&v)[kDpRows]) {
  using T = typename Elem<W>::T;
  T w[kDpRows];
#pragma unroll
  for (int r = 0; r < kDpRows; ++r) w[r] = (T)v[r];
  put_rows<kDpRows>((T*)out_vals, i0, nr, w);
}

// One record a table slot, then one for keys with no slot: [flags, lane
// 0, ..., lane n - 1, pad], sw (even) words, of the build row the slot
// names clipped to [0, nbb - 1] (row 0 for none, as the probe clips -1);
// flag bit 0 = the slot names a row and that row is valid.  Thread k of
// the grid writes 16 bytes: words 2q and 2q + 1 of slot k / (sw / 2), so
// a warp's stores are contiguous.
__global__ void __launch_bounds__(kDpThreads)
    dp_pack(const __grid_constant__ GatherLanes G,
            const int32_t* __restrict__ tbl, int64_t tbl_len,
            const uint8_t* __restrict__ bvalid, int64_t nbb, int sw,
            unsigned long long* __restrict__ rec) {
  __shared__ BlockLanes L;
  load_lanes(L, G);
  const int n = G.n, nq = sw / 2;
  const int64_t total = (tbl_len + 1) * nq;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < total;
       k += stride) {
    const int64_t e = k / nq;
    const int q = (int)(k - e * nq);
    const int64_t p = e < tbl_len ? tbl[e] : -1;
    const bool hit = p >= 0;
    const int64_t b = !hit ? 0 : (p > nbb - 1 ? nbb - 1 : p);
    unsigned long long w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int word = 2 * q + h;
      unsigned long long x = 0;
      if (word == 0) {
        x = hit && bvalid[b] != 0;
        for (int l = 0; l < n; ++l)
          if (L.nulls[l] && L.nulls[l][b]) x |= 2ULL << l;
      } else if (word - 1 < n) {
        const void* v = L.vals[word - 1];
        switch (L.width[word - 1]) {
          case 8: x = ((const unsigned long long*)v)[b]; break;
          case 4: x = ((const unsigned int*)v)[b]; break;
          case 2: x = ((const unsigned short*)v)[b]; break;
          default: x = ((const unsigned char*)v)[b]; break;
        }
      }
      w[h] = x;
    }
    reinterpret_cast<ulonglong2*>(rec)[k] = make_ulonglong2(w[0], w[1]);
  }
}

// Lane l's values v (8-byte slots of the records) and NULL flags (bit 1 +
// l of the flag words, or-ed with "unmatched") for rows [i0, i0 + nr).
__device__ __forceinline__ void record_lane(
    const BlockLanes& L, int l, int64_t i0, int nr,
    const unsigned long long (&v)[kDpRows],
    const unsigned long long (&flags)[kDpRows],
    const bool (&match)[kDpRows]) {
  uint8_t nl[kDpRows];
#pragma unroll
  for (int r = 0; r < kDpRows; ++r)
    nl[r] = (((flags[r] >> (1 + l)) & 1) || !match[r]) ? 1 : 0;
  void* ov = L.out_vals[l];
  switch (L.width[l]) {
    case 8: put_record_rows<8>(ov, i0, nr, v); break;
    case 4: put_record_rows<4>(ov, i0, nr, v); break;
    case 2: put_record_rows<2>(ov, i0, nr, v); break;
    default: put_record_rows<1>(ov, i0, nr, v); break;
  }
  put_rows<kDpRows>(L.out_nulls[l], i0, nr, nl);
}

// kRec: read the records (dp_pack's) instead of the table and the build
// side
template <bool kRec>
__global__ void __launch_bounds__(kDpThreads)
    dp_probe(const __grid_constant__ KeySet K,
             const uint8_t* __restrict__ pvalid, int64_t nb, int64_t lo,
             int64_t hi, const int32_t* __restrict__ tbl, int64_t tbl_len,
             const uint8_t* __restrict__ bvalid, int64_t nbb, int mode,
             const __grid_constant__ GatherLanes G,
             const unsigned long long* __restrict__ rec, int sw,
             uint8_t* __restrict__ valid_out) {
  constexpr int R = kDpRows;
  __shared__ BlockLanes L;
  const int n_lanes = (mode == MODE_INNER || mode == MODE_LEFT) ? G.n : 0;
  load_lanes(L, G);
  const int64_t groups = (nb + R - 1) / R;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i0 = g * R;
    const int nr = nb - i0 < R ? (int)(nb - i0) : R;
    int64_t key[R];
    bool ok[R];
    uint8_t pv[R];
    probe_rows<R>(K, i0, nr, key, ok);
    get_rows<R>(pvalid, i0, nr, pv);
    int64_t ps[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kRec) {  // the slot table_lookup reads, tbl_len for none
        ps[r] = tbl_len;
        if (ok[r] && key[r] >= lo && key[r] <= hi && tbl_len > 0) {
          const unsigned long long off =
              (unsigned long long)key[r] - (unsigned long long)lo;
          ps[r] = off > (unsigned long long)(tbl_len - 1) ? tbl_len - 1
                                                          : (int64_t)off;
        }
      } else {
        ps[r] = ok[r] ? table_lookup(tbl, tbl_len, lo, hi, key[r]) : -1;
      }
    }
    bool match[R];
    // records: the first 16 bytes of each row's record (flags, lane 0)
    const ulonglong2* rq = (const ulonglong2*)rec;
    const int nq = sw / 2;
    unsigned long long flags[R], lane0[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kRec) {
        const ulonglong2 x = __ldg(rq + ps[r] * nq);
        flags[r] = x.x;
        lane0[r] = x.y;
        match[r] = flags[r] & 1;
      } else {
        const bool hit = ps[r] >= 0;
        ps[r] = !hit ? 0 : (ps[r] > nbb - 1 ? nbb - 1 : ps[r]);
        match[r] = hit && __ldg(bvalid + ps[r]) != 0;
      }
    }
    if (valid_out) {
      uint8_t vo[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool p = pv[r] != 0;
        vo[r] = (mode == MODE_LEFT ? p
                 : mode == MODE_ANTI ? p && !match[r] : p && match[r]) ? 1
                                                                      : 0;
      }
      put_rows<R>(valid_out, i0, nr, vo);
    }
    if (kRec) {
      // 16 bytes of every row's record a level: lanes 2q - 1 and 2q
      if (n_lanes > 0) record_lane(L, 0, i0, nr, lane0, flags, match);
      for (int q = 1; 2 * q - 1 < n_lanes; ++q) {
        unsigned long long a[R], b[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const ulonglong2 x = __ldg(rq + ps[r] * nq + q);
          a[r] = x.x;
          b[r] = x.y;
        }
        record_lane(L, 2 * q - 1, i0, nr, a, flags, match);
        if (2 * q < n_lanes) record_lane(L, 2 * q, i0, nr, b, flags, match);
      }
      continue;
    }
    for (int l = 0; l < n_lanes; ++l) {
      void* ov = L.out_vals[l];
      uint8_t* on = L.out_nulls[l];
      const int w = L.width[l];
      const void* v = L.vals[l];
      const uint8_t* n = L.nulls[l];
      switch (w) {
        case 8: gather_rows<8>(v, n, ov, on, i0, nr, ps, match); break;
        case 4: gather_rows<4>(v, n, ov, on, i0, nr, ps, match); break;
        case 2: gather_rows<2>(v, n, ov, on, i0, nr, ps, match); break;
        default: gather_rows<1>(v, n, ov, on, i0, nr, ps, match); break;
      }
    }
  }
}

}  // namespace

// valid_out may be null: a launch for lanes past the first kMaxLanes
// (the wrapper's second chunk) writes the gathered lanes alone.  rec:
// null, or tbl_len + 1 records of sw words (even, at least 1 +
// lanes->n) at a 16-byte boundary, which this call packs first.
TS_API int hk6_dense_probe(const KeySet* keys, const uint8_t* pvalid,
                           int64_t nb, int64_t lo, int64_t hi,
                           const int32_t* tbl, int64_t tbl_len,
                           const uint8_t* bvalid, int64_t nbb, int mode,
                           const GatherLanes* lanes, uint64_t* rec, int sw,
                           uint8_t* valid_out, cudaStream_t st) {
  if (mode < MODE_INNER || mode > MODE_ANTI || !gather_ok(lanes) ||
      nbb < 1 || nb < 0 || keys->n < 1 || keys->n > kMaxKeys)
    return -1;
  if (rec && (sw < 1 + lanes->n || sw % 2 ||
              (reinterpret_cast<uintptr_t>(rec) & 15)))
    return -1;
  if (nb == 0) return (int)cudaGetLastError();
  const unsigned grid =
      grid_for((nb + kDpRows - 1) / kDpRows, kDpThreads, 1 << 16);
  unsigned long long* r = (unsigned long long*)rec;
  if (r) {
    LAUNCH(dp_pack, grid_for((tbl_len + 1) * (sw / 2), kDpThreads, 1 << 16),
           kDpThreads, 0, st, *lanes, tbl, tbl_len, bvalid, nbb, sw, r);
    LAUNCH(dp_probe<true>, grid, kDpThreads, 0, st, *keys, pvalid, nb, lo,
           hi, tbl, tbl_len, bvalid, nbb, mode, *lanes,
           (const unsigned long long*)r, sw, valid_out);
  } else {
    LAUNCH(dp_probe<false>, grid, kDpThreads, 0, st, *keys, pvalid, nb, lo,
           hi, tbl, tbl_len, bvalid, nbb, mode, *lanes,
           (const unsigned long long*)nullptr, 0, valid_out);
  }
  return (int)cudaGetLastError();
}
