// HK8 csr_expand: the pipeline tier's join with a non-unique build side,
// expanded over the build replica's group index (a CSR layout).
//
// Replaces tinysql_tpu/executor/devpipe.py:1502-1748 (K18's multiplicity
// mode, _prepare_mult's kernel), whose XLA program took a cumsum over the
// sorted build validity, compacted the sorted order with nonzero, mapped
// each probe key to its group through the dense table, scanned the
// per-probe multiplicities and filled the static output bucket by a
// scatter of starts and a running max; also its multi-key variant, whose
// probe key is the composite lane (dense_table.cuh).
//
// Inputs: the group index over the build key (order int64[nbb]: sorted
// position -> row, positions at or past n_rows padding; ends int64[ngb]:
// each group's last sorted position, groups at or past ng padding), the
// build validity bvalid (row space), the key -> group table tbl over
// [lo, hi] (dense_table.cuh's format), the probe keys and validity, LEFT's
// flag, and the static bucket ob, which the host bounds at prepare time
// from the pre-filter group sizes, so no count ever travels to the host.
//
// Per probe row i: g = the group of its key (-1 when invalid, NULL, out
// of range or absent), m = the valid build rows of g, cnt = m (inner) or
// max(m, 1) for a valid row (LEFT).  Output slot j < total (the sum of
// cnt) belongs to the probe row p whose run holds it, at k = j - start(p);
// it is matched when k < m[p], and then names the build row at place
// start_c[g] + k of the compacted sorted order.  Slots are probe-major,
// and each probe row's build rows come in group-index order (ascending
// rows): the reference's order.  Slots past the total are invalid and
// name probe row 0 and build row 0, as do unmatched ones on the build
// side (whose NULL flags are then set).
//
// Bound: bytes.  The build's order, validity and lanes are read once over
// its rows, its group ends once; the probe validity once over the
// bucket, the probe keys, one table entry and each probe lane once per
// valid probe row; the valid flag is written per output slot and the
// gathered lanes per live slot.
//
// Design: two scans (common.cuh), a probe pass and expand.cuh's fill:
//   1. valid build rows in sorted order: the exclusive prefix cx (so a
//      group's valid rows are cx[e + 1] - cx[s], with no float and no
//      cancellation) and the compacted order comp;
//   2. one thread per probe row: g and m;
//   3. the inclusive ends of cnt, and the total, on the card;
//   4. one thread per output slot: a binary search for its probe row
//      among its shard's rows.
// Then one launch per 16 lanes gathers the probe and build lanes.  All
// integer, no atomics: the output is the same bytes from run to run.
#include "dense_table.cuh"
#include "expand.cuh"

namespace {

constexpr int kThreads = 256;

// valid build rows in sorted order
struct BuildScan {
  const int64_t* order;
  const uint8_t* bvalid;
  int64_t n_rows;
  int64_t* cx;
  int64_t* comp;
  __device__ int64_t count(int64_t q) const {
    return (q < n_rows && bvalid[order[q]]) ? 1 : 0;
  }
  __device__ void write(int64_t q, int64_t excl, int64_t v) const {
    cx[q] = excl;
    if (v) comp[excl] = order[q];
  }
};

__device__ __forceinline__ int64_t group_start(const int64_t* ends,
                                               int64_t g) {
  return g > 0 ? ends[g - 1] + 1 : 0;
}

__global__ void ce_probe(KeySet K, const uint8_t* __restrict__ pvalid,
                         int64_t nb, const int32_t* __restrict__ tbl,
                         int64_t tbl_len, int64_t lo, int64_t hi, int64_t ng,
                         const int64_t* __restrict__ ends,
                         const int64_t* __restrict__ cx,
                         int64_t* __restrict__ gout,
                         int64_t* __restrict__ mout) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nb;
       i += stride) {
    int64_t key = 0, g = -1, m = 0;
    if (pvalid[i] && probe_key(K, i, &key)) {
      g = table_lookup(tbl, tbl_len, lo, hi, key);
      if (g >= ng) g = -1;
    }
    if (g >= 0) m = cx[ends[g] + 1] - cx[group_start(ends, g)];
    gout[i] = g;
    mout[i] = m;
  }
}

// output slots of probe row i
struct ProbeCount {
  const uint8_t* pvalid;
  const int64_t* m;
  int outer;
  __device__ int64_t operator()(int64_t i) const {
    if (!outer) return m[i];
    return pvalid[i] ? (m[i] > 1 ? m[i] : 1) : 0;
  }
};

__global__ void ce_fill(ProbeCount pc, const int64_t* __restrict__ incl,
                        int64_t nbl, const int64_t* __restrict__ g,
                        const int64_t* __restrict__ ends,
                        const int64_t* __restrict__ cx,
                        const int64_t* __restrict__ comp, int64_t ob,
                        int64_t n_out, int64_t* __restrict__ prow,
                        int64_t* __restrict__ brow,
                        uint8_t* __restrict__ matched,
                        uint8_t* __restrict__ valid_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j < n_out; j += stride) {
    // shard s's bucket [s * ob, (s + 1) * ob) holds its rows
    // [s * nbl, (s + 1) * nbl): their slots restart at the bucket
    const int64_t s = j / ob, jj = j - s * ob, r0 = s * nbl;
    const int64_t base = r0 > 0 ? incl[r0 - 1] : 0;
    const int64_t tot = incl[r0 + nbl - 1] - base;
    int64_t p = r0, b = 0;
    bool mt = false;
    if (jj < tot) {
      p = r0 + owner_of(incl + r0, nbl, jj + base);
      const int64_t k = jj + base - (incl[p] - pc(p));
      const int64_t gp = g[p];
      mt = gp >= 0 && k < pc.m[p];
      if (mt) b = comp[cx[group_start(ends, gp)] + k];
    }
    prow[j] = p;
    brow[j] = b;
    matched[j] = mt ? 1 : 0;
    valid_out[j] = jj < tot ? 1 : 0;
  }
}

__global__ void ce_gather(const int64_t* __restrict__ prow,
                          const int64_t* __restrict__ brow,
                          const uint8_t* __restrict__ matched, int64_t ob,
                          GatherLanes G) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < ob;
       j += stride)
    gather_lanes(G, j, prow[j], brow[j], !matched[j]);
}

}  // namespace

// int64 scratch: cx[nbb + 1], comp[nbb], g[nb], m[nb], incl[nb], the two
// scans' block totals and the output total.
TS_API int64_t hk8_scratch_words(int64_t nbb, int64_t nb) {
  return (nbb + 1) + nbb + 3 * nb + scan_nblocks(nbb) + scan_nblocks(nb) + 1;
}

// Expansion indices: prow / brow int64[n_shards * ob], matched / valid_out
// uint8[n_shards * ob] (ob per shard; n_shards divides nb); *total (the
// last scratch word) holds the output size of all shards on the card.
TS_API int hk8_csr_expand(const int64_t* order, int64_t nbb, int64_t n_rows,
                          const int64_t* ends, int64_t ng,
                          const uint8_t* bvalid, const int32_t* tbl,
                          int64_t tbl_len, int64_t lo, int64_t hi,
                          const KeySet* keys, const uint8_t* pvalid,
                          int64_t nb, int outer, int64_t ob, int n_shards,
                          int64_t* scratch, int64_t* prow, int64_t* brow,
                          uint8_t* matched, uint8_t* valid_out,
                          cudaStream_t st) {
  if (nbb < 1 || nb < 1 || ob < 1 || n_rows < 0 || n_rows > nbb || ng < 0 ||
      keys->n < 1 || keys->n > kMaxKeys || n_shards < 1 || nb % n_shards)
    return -1;
  int64_t* cx = scratch;
  int64_t* comp = cx + nbb + 1;
  int64_t* g = comp + nbb;
  int64_t* m = g + nb;
  int64_t* incl = m + nb;
  int64_t* btot_b = incl + nb;
  int64_t* btot_p = btot_b + scan_nblocks(nbb);
  int64_t* total = btot_p + scan_nblocks(nb);
  launch_scan(BuildScan{order, bvalid, n_rows, cx, comp}, nbb, btot_b,
              cx + nbb, st);
  LAUNCH(ce_probe, grid_for(nb, kThreads, 1 << 16), kThreads, 0, st, *keys,
         pvalid, nb, tbl, tbl_len, lo, hi, ng, ends, (const int64_t*)cx, g,
         m);
  const ProbeCount pc{pvalid, m, outer};
  launch_scan(InclusiveEnds<ProbeCount>{pc, incl}, nb, btot_p, total, st);
  const int64_t n_out = ob * n_shards;
  LAUNCH(ce_fill, grid_for(n_out, kThreads, 1 << 16), kThreads, 0, st, pc,
         (const int64_t*)incl, nb / n_shards, (const int64_t*)g, ends,
         (const int64_t*)cx, (const int64_t*)comp, ob, n_out, prow, brow,
         matched, valid_out);
  return (int)cudaGetLastError();
}

// Gathers up to kMaxLanes lanes at the expansion's rows.
TS_API int hk8_gather(const int64_t* prow, const int64_t* brow,
                      const uint8_t* matched, int64_t ob,
                      const GatherLanes* lanes, cudaStream_t st) {
  if (!gather_ok(lanes) || ob < 0) return -1;
  if (ob > 0 && lanes->n > 0)
    LAUNCH(ce_gather, grid_for(ob, kThreads, 1 << 16), kThreads, 0, st, prow,
           brow, matched, ob, *lanes);
  return (int)cudaGetLastError();
}
