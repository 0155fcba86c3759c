// HK2 segment_reduce: the grouped aggregate of the fused device path.
//
// Replaces tinysql_tpu/ops/kernels.py:1007-1386 (K2: _SegReduce,
// _fused_agg_outs, _fused_segment_raw behind fused_segment_aggregate and
// fused_segment_aggregate_keep), whose XLA programs reduced per-segment
// count / sum / min / max, presence and first row over int64 group ids,
// and the present-segment compaction of :709 _present_pack and :954
// _present_extract.
//
// Output table, int64[(2 + 2 * L.n) * ns], row-major:
//   row 0 presence (valid rows per segment), row 1 first valid row
//   (sentinel n when the segment is empty), then per lane j: row 2 + 2j the
//   value bits (float64 lanes bit-cast), row 3 + 2j the live count.
// Empty segments hold the reduction identity (0, +-inf, int64 max/min),
// as the reference's segment ops do.
//
// Bound: bytes.  The valid mask is read over every row, gid and each
// lane's values and NULL mask over the valid rows, and the table written
// once (Q3's shape: 0.039 ms on an H100 at 3.35 TB/s); at many segments
// the stable sort of the row ids by group moves the ids and the row
// positions once per digit of the largest id (three 8-bit digits below
// 2^21 segments: ~0.6 GB at 2^23 rows).
//
// Design, in two regimes chosen by the segment count:
// - ns <= kSmallSeg (TPC-H Q1: 4 live groups of 16): few_reduce.cuh, shared
//   with HK5's few groups.  One pass in row order over tiles of a
//   constant size: each tile's group ids and valid mask are read once,
//   then lane by lane its values and NULL mask, into per-thread slots in
//   shared memory (one writer each, no atomics), folded by fixed trees in
//   the tile, then the tiles in tile order.
// - more segments (Q3: ~1.5M orders at SF=1): a stable sort of the row ids
//   by group id (lex_sort.cuh: above 2^16 rows a radix sort that skips
//   the digits equal in every row, so ids below ns take only the digits
//   of ns, one sweep each, and no merge passes; the ids are clamped to
//   [0, ns], ns the key of the rows no segment takes), then a stable
//   compaction keeps the valid
//   rows of that order; one thread per run head finds its run's end
//   by a galloping search over the sorted ids and reduces a run of at most
//   kLongRun rows itself, in row order.  A longer run (a skewed or
//   low-cardinality key: millions of rows in one group) is cut into chunks
//   of kChunk rows; a block reduces each chunk (its threads take the rows
//   in a fixed stride and fold their partials in a fixed tree), then one
//   thread per long run folds its chunks' partials in chunk order.  So one
//   group spreads over the whole card.  No atomics but the queue slots,
//   whose order changes which block reduces a chunk and not how.  The
//   accumulators and the long-run queue live in run_reduce.cuh, shared
//   with HK5 csr_reduce.
// Either way float sums have a fixed order: bit-identical run to run.
// Float min/max compare order keys in every regime (-0.0 < +0.0), so the
// result does not depend on the regime or on the order of the rows.
//
// HK2b, the batched entry point (K12, tinysql_tpu/ops/kernels.py:1197-1266
// stacked_variant over this program): B members of a stacked round share
// the group ids and each brings its own valid mask and lanes
// (LaneStrides); one call writes B tables, and a solo launch is HK2b at
// B = 1 with zero strides.  In the few-segment regime the members run in
// turn inside each tile's block, over its group ids loaded once and each
// lane the members share loaded once; member b's arithmetic is a solo
// launch's.  In the sort regime the member is a grid axis, and the row
// ids are sorted by group id once (the ids are shared); each member then
// keeps its live rows of that order by a stable compaction (a scan per
// member) and reduces the runs of what it kept.  Same block partition,
// same runs, same merge order: every member's table is bit-identical to
// a solo launch's.
// Bound: bytes, gid once over the rows valid in any member, then per
// member its mask over every row, its lanes over its valid rows and its
// table written once.
#include "few_reduce.cuh"
#include "lex_sort.cuh"
#include "run_reduce.cuh"

namespace {

// ---- many segments: stable sort by group, then a thread or block per run -

__device__ __forceinline__ int64_t seg_key(const int64_t* gid,
                                           const uint8_t* valid, int64_t ns,
                                           int64_t r) {
  if (!valid[r]) return ns;
  int64_t g = gid[r];
  return (g < 0 || g >= ns) ? ns : g;
}

// First q in (s, n] whose key differs from g = key(s); the keys ascend
// along spos, so gallop from s, then bisect.
__device__ int64_t run_end(const int64_t* gid, const uint8_t* valid,
                           int64_t ns, const int64_t* spos, int64_t n,
                           int64_t s, int64_t g) {
  int64_t lo = s, hi = n, step = 1;  // key(lo) == g; hi == n or key(hi) > g
  while (true) {
    const int64_t q = lo + step;
    if (q >= n) break;
    if (seg_key(gid, valid, ns, spos[q]) != g) {
      hi = q;
      break;
    }
    lo = q;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (seg_key(gid, valid, ns, spos[mid]) == g) lo = mid;
    else hi = mid;
  }
  return hi;
}

__device__ void runs_body(const int64_t* __restrict__ gid,
                          const uint8_t* __restrict__ valid, int64_t n,
                          int64_t ns, const int64_t* __restrict__ spos,
                          const Lanes& L, int64_t* __restrict__ out,
                          const LongQueue& Q) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += stride) {
    const int64_t g = seg_key(gid, valid, ns, spos[s]);
    if (g >= ns) continue;
    if (s > 0 && seg_key(gid, valid, ns, spos[s - 1]) == g) continue;
    const int64_t e = run_end(gid, valid, ns, spos, n, s, g);
    out[g] = e - s;
    out[ns + g] = spos[s];  // rows ascend within a run: the first row
    if (e - s > kLongRun) {
      queue_long_run(Q, g, s, e);
      continue;
    }
    for (int j = 0; j < L.n; ++j) {
      const uint8_t* nl = L.nulls[j];
      const int kind = L.kind[j], op = L.op[j];
      Acc a = acc_init(op);
      for (int64_t q = s; q < e; ++q) {
        const int64_t r = spos[q];
        if (nl && nl[r]) continue;
        acc_row(a, kind, op, L.vals[j], r);
      }
      acc_store(a, kind, op, j, g, ns, out);
    }
  }
}

// kept position -> row for the long-run queue (every kept row is live)
struct SortedRows {
  const int64_t* spos;
  __device__ int64_t operator()(int64_t q) const { return spos[q]; }
};

// ---- the sort regime: one sort by group id, a compaction per member ----

__global__ void sr_keys_gid(const int64_t* __restrict__ gid, int64_t n,
                            int64_t ns, uint64_t* __restrict__ keys) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t g = gid[i];
    keys[i] = (uint64_t)((g < 0 || g >= ns) ? ns : g);
  }
}

// The per-member state of the sort regime: member b's live positions
// of the shared order at mpos + b * n, their count at counts[b], its
// block totals at btot + b * nblk, its table and long-run queue.
struct Members {
  const uint8_t* valid;  // uint8[B * n]
  int64_t* mpos;         // int64[B * n]
  int64_t* counts;       // int64[B]
  int64_t* btot;         // int64[B * nblk]
  int64_t nblk;
  char* queues;          // B long-run queues of qbytes each
  int64_t qbytes;
  int64_t* out;          // B tables of (2 + 2 * L.n) * ns
};

__device__ __forceinline__ bool member_live(const int64_t* gid,
                                            const uint8_t* valid, int64_t ns,
                                            int64_t r) {
  const int64_t g = gid[r];
  return valid[r] && g >= 0 && g < ns;
}

// block totals of member b = blockIdx.y's live positions
__global__ void mc_totals(const int64_t* __restrict__ gid, int64_t n,
                          int64_t ns, const int64_t* __restrict__ spos,
                          Members M) {
  __shared__ int64_t s[kScanThreads];
  const int64_t b = blockIdx.y;
  const uint8_t* valid = M.valid + b * n;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  s[threadIdx.x] = (i < n && member_live(gid, valid, ns, spos[i])) ? 1 : 0;
  __syncthreads();
  for (int st = blockDim.x >> 1; st > 0; st >>= 1) {
    if ((int)threadIdx.x < st) s[threadIdx.x] += s[threadIdx.x + st];
    __syncthreads();
  }
  if (threadIdx.x == 0) M.btot[b * M.nblk + blockIdx.x] = s[0];
}

// exclusive scan of member blockIdx.x's block totals; its count
__global__ void mc_scan(Members M) {
  const int64_t b = blockIdx.x;
  const int64_t run = block_scan_totals(M.btot + b * M.nblk, M.nblk);
  if (threadIdx.x == 0) M.counts[b] = run;
}

// member b = blockIdx.y keeps its live positions, in order
__global__ void mc_apply(const int64_t* __restrict__ gid, int64_t n,
                         int64_t ns, const int64_t* __restrict__ spos,
                         Members M) {
  __shared__ int64_t s[2][kScanThreads];
  const int64_t b = blockIdx.y;
  const uint8_t* valid = M.valid + b * n;
  const int t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + t;
  const int64_t v =
      (i < n && member_live(gid, valid, ns, spos[i])) ? 1 : 0;
  int cur = 0;
  s[cur][t] = v;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    int64_t x = s[cur][t];
    if (t >= off) x += s[cur][t - off];
    s[cur ^ 1][t] = x;
    cur ^= 1;
    __syncthreads();
  }
  if (v)
    M.mpos[b * n + M.btot[b * M.nblk + blockIdx.x] + s[cur][t] - v] =
        spos[i];
}

__device__ __forceinline__ LongQueue member_queue(const Members& M,
                                                  int64_t n, int64_t b) {
  return long_queue_at(M.queues + b * M.qbytes, n);
}

// Member blockIdx.y's lanes, built once per block in shared memory (a
// per-thread copy would cost every thread the struct's bytes in local
// memory); every thread of the block calls it.
__device__ __forceinline__ void load_member_lanes(Lanes& sl, const Lanes& L,
                                                  const LaneStrides& S) {
  if (threadIdx.x == 0) sl = member_lanes(L, S, blockIdx.y);
  __syncthreads();
}

__global__ void mc_init(Lanes L, LaneStrides S, int64_t ns, int64_t n,
                        Members M) {
  __shared__ Lanes Lb;
  load_member_lanes(Lb, L, S);
  const int64_t b = blockIdx.y;
  init_table(Lb, ns, n, M.out + b * (2 + 2 * L.n) * ns,
             member_queue(M, n, b).runs);
}

__global__ void mc_runs(const int64_t* __restrict__ gid, int64_t n,
                        int64_t ns, Lanes L, LaneStrides S, Members M) {
  __shared__ Lanes Lb;
  load_member_lanes(Lb, L, S);
  const int64_t b = blockIdx.y;
  runs_body(gid, M.valid + b * n, M.counts[b], ns, M.mpos + b * n, Lb,
            M.out + b * (2 + 2 * L.n) * ns, member_queue(M, n, b));
}

__global__ void mc_chunks(int64_t n, Lanes L, LaneStrides S, Members M) {
  __shared__ Lanes Lb;
  load_member_lanes(Lb, L, S);
  const int64_t b = blockIdx.y;
  chunk_partials(SortedRows{M.mpos + b * n}, Lb, 0, member_queue(M, n, b));
}

__global__ void mc_fold(int64_t n, int64_t ns, Lanes L, LaneStrides S,
                        Members M) {
  __shared__ Lanes Lb;
  load_member_lanes(Lb, L, S);
  const int64_t b = blockIdx.y;
  long_fold(Lb, 0, ns, n, member_queue(M, n, b),
            M.out + b * (2 + 2 * L.n) * ns);
}

// ---- present-segment compaction -----------------------------------------
//
// One pass over the presence row (row 0 of the table) in tiles of
// kPcTile segments, taken in launch order from an atomic counter: each
// thread loads its 2 * kPcRounds presence words with 16-byte loads (a
// warp reads 512 contiguous bytes a round), warp ballots rank the present
// segments of a round, one warp scans the tile's 32 (round, warp) counts,
// and a decoupled look-back (common.cuh) gives the tile its first output
// column.  In the same pass every present segment writes its column: its
// id (when asked) and the table rows [lo, rows) gathered at that id, a
// row at a time with every gather of the row in flight (four rows at a
// time measured no faster: fewer blocks an SM).  A tile's present ids
// ascend, so a warp's loads of one row fall into few sectors.  The last
// tile writes the count.  Column k's word c lands at body[c * ns +
// k] (the layout [w, ns]) and, for k < hb, also at head[c * hb + k]: the
// count word sits just before the head, so a host pulls the count and
// the first hb columns in one transfer, the rest from the body.
constexpr int kPcThreads = 256;
constexpr int kPcWarps = kPcThreads / 32;
constexpr int kPcRounds = 4;  // 16-byte loads (2 segments) a thread a tile
constexpr int64_t kPcTile = (int64_t)kPcThreads * 2 * kPcRounds;
static_assert(kPcRounds * kPcWarps == 32, "one warp scans a tile's counts");

__global__ void __launch_bounds__(kPcThreads)
    present_pass(const int64_t* __restrict__ table, int rows, int64_t ns,
                 int lo, int ids, int64_t hb, int64_t* zero,
                 int64_t* __restrict__ count, int64_t* __restrict__ head,
                 int64_t* __restrict__ body) {
  __shared__ int64_t s_tile;
  __shared__ unsigned s_cnt[32];
  __shared__ int64_t s_off[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0)
    s_tile = (int64_t)atomicAdd((unsigned long long*)&zero[0], 1ULL);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kPcTile;
  // rows of a table whose base is 16-byte aligned and ns even take
  // 16-byte loads; any other view two 8-byte loads
  const bool vec =
      (reinterpret_cast<uintptr_t>(table) & 15) == 0 && (ns & 1) == 0;
  int64_t p[kPcRounds][2];
#pragma unroll
  for (int r = 0; r < kPcRounds; ++r) {
    const int64_t g = base + (int64_t)r * 2 * kPcThreads + 2 * t;
    if (vec && g + 1 < ns) {
      const longlong2 w = *reinterpret_cast<const longlong2*>(table + g);
      p[r][0] = w.x;
      p[r][1] = w.y;
    } else {
      p[r][0] = g < ns ? table[g] : 0;
      p[r][1] = g + 1 < ns ? table[g + 1] : 0;
    }
  }
  unsigned b0[kPcRounds], b1[kPcRounds];
#pragma unroll
  for (int r = 0; r < kPcRounds; ++r) {
    b0[r] = __ballot_sync(kFull, p[r][0] > 0);
    b1[r] = __ballot_sync(kFull, p[r][1] > 0);
    if (lane == 0) s_cnt[r * kPcWarps + warp] = __popc(b0[r]) + __popc(b1[r]);
  }
  __syncthreads();
  if (warp == 0) {
    // the tile's segments in order: (round, warp, lane, pair element)
    const unsigned c = s_cnt[lane];
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int64_t agg = __shfl_sync(kFull, incl, 31);
    const int64_t prefix =
        look_back((unsigned long long*)(zero + 1), tile, agg);
    s_off[lane] = prefix + (incl - c);
    if (lane == 0 && tile == (int64_t)gridDim.x - 1) *count = prefix + agg;
  }
  __syncthreads();
  // each segment's output column, -1 when it is absent
  const unsigned lt = (1u << lane) - 1u;
  int64_t col[kPcRounds][2];
#pragma unroll
  for (int r = 0; r < kPcRounds; ++r) {
    const unsigned h0 = (b0[r] >> lane) & 1u, h1 = (b1[r] >> lane) & 1u;
    const int64_t k0 = s_off[r * kPcWarps + warp] + __popc(b0[r] & lt) +
                       __popc(b1[r] & lt);
    col[r][0] = h0 ? k0 : -1;
    col[r][1] = h1 ? k0 + h0 : -1;
  }
  if (ids) {
#pragma unroll
    for (int r = 0; r < kPcRounds; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t k = col[r][e];
        const int64_t g = base + (int64_t)r * 2 * kPcThreads + 2 * t + e;
        if (k >= 0) body[k] = g;
        if (k >= 0 && k < hb) head[k] = g;
      }
  }
  // a row at a time: every gather of the row in flight, then the stores
  for (int row = lo; row < rows; ++row) {
    const int64_t c = ids + row - lo;
    int64_t v[kPcRounds][2];
#pragma unroll
    for (int r = 0; r < kPcRounds; ++r) {
      const int64_t g = base + (int64_t)r * 2 * kPcThreads + 2 * t;
      const int64_t* src = table + row * ns + g;
      if (row == 0) {
        v[r][0] = p[r][0];
        v[r][1] = p[r][1];
      } else if (vec && col[r][0] >= 0 && col[r][1] >= 0) {
        const longlong2 w = *reinterpret_cast<const longlong2*>(src);
        v[r][0] = w.x;
        v[r][1] = w.y;
      } else {
        v[r][0] = col[r][0] >= 0 ? src[0] : 0;
        v[r][1] = col[r][1] >= 0 ? src[1] : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kPcRounds; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t k = col[r][e];
        if (k >= 0) body[c * ns + k] = v[r][e];
        if (k >= 0 && k < hb) head[c * hb + k] = v[r][e];
      }
  }
}

// Columns [from, to) of the layout [1 + rows, ns] past the count: id ns,
// every row gathered at ns - 1.
__global__ void present_pad(const int64_t* __restrict__ table, int64_t ns,
                            int64_t from, int64_t to,
                            int64_t* __restrict__ out) {
  const int c = blockIdx.y;
  const int64_t v = c == 0 ? ns : table[(int64_t)(c - 1) * ns + ns - 1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = from + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       k < to; k += stride)
    out[(int64_t)c * ns + k] = v;
}

}  // namespace

// bytes of the sort regime's Members region (nmem members' kept
// positions, counts, block totals and long-run queues), rounded up to 16
// so that the sort's scratch after it stays aligned
static int64_t members_bytes(int64_t nmem, int64_t n, int nlanes) {
  return align16(nmem * (8 * n + 8 + 8 * scan_nblocks(n) +
                         long_queue_bytes(n, nlanes)));
}

// nmem members: per member the few-segment regime's tile partials, or
// the sort regime's keys and sorted order, once, then per member its kept
// positions, count, block totals and long-run queue with its chunk
// partials, then the sort's own scratch
TS_API int64_t hk2b_scratch_bytes(int64_t nmem, int64_t n, int64_t ns,
                                  int nlanes) {
  if (ns <= kSmallSeg)
    return few_part_bytes(nmem, n, ns, nlanes);
  return 8 * n + 8 * n + members_bytes(nmem, n, nlanes) +
         lex_sort_scratch_bytes(1, n, -1);
}

TS_API int64_t hk2_scratch_bytes(int64_t n, int64_t ns, int nlanes) {
  return hk2b_scratch_bytes(1, n, ns, nlanes);
}

// HK2b: nmem members over one gid int64[n]; valid uint8[nmem * n] (member
// b at b * n); each lane's member stride in `strides`; out int64[nmem *
// (2 + 2 * L.n) * ns], member b's table at b * (2 + 2 * L.n) * ns.
TS_API int hk2b_segment_reduce(const int64_t* gid, const uint8_t* valid,
                               int64_t nmem, int64_t n, int64_t ns,
                               const Lanes* lanes, const LaneStrides* strides,
                               void* scratch, int64_t* out, cudaStream_t st) {
  if (lanes->n < 0 || lanes->n > kMaxLanes || ns < 1 || nmem < 1 ||
      nmem > 65535)
    return -1;
  if (ns <= kSmallSeg)
    return few_reduce(GidKeys{gid, ns}, valid, n, nmem, n, (int)ns, ns,
                      *lanes, *strides, (FewPart*)scratch, out, n, st);
  uint64_t* keys = (uint64_t*)scratch;
  int64_t* spos = (int64_t*)(keys + n);
  Members M;
  M.valid = valid;
  M.mpos = spos + n;
  M.counts = M.mpos + nmem * n;
  M.nblk = scan_nblocks(n);
  M.btot = M.counts + nmem;
  M.qbytes = long_queue_bytes(n, lanes->n);
  M.queues = (char*)(M.btot + nmem * M.nblk);
  M.out = out;
  void* sort_scratch =
      (char*)spos + 8 * n + members_bytes(nmem, n, lanes->n);
  const unsigned mem = (unsigned)nmem;
  dim3 gi(grid_for((2 + 2 * lanes->n) * ns, 256, 1 << 16), mem);
  LAUNCH(mc_init, gi, 256, 0, st, *lanes, *strides, ns, n, M);
  if (n > 0) {
    LAUNCH(sr_keys_gid, grid_for(n, 256, 1 << 16), 256, 0, st, gid, n, ns,
           keys);
    SortIn in;
    for (int l = 0; l < kMaxSortLanes; ++l) in.lanes[l] = nullptr;
    in.lanes[0] = keys;
    in.pos = nullptr;
    int rc = lex_sort_host(in, 1, n, -1, sort_scratch, spos, st);
    if (rc != 0) return rc;
    dim3 gs((unsigned)M.nblk, mem);
    LAUNCH(mc_totals, gs, kScanThreads, 0, st, gid, n, ns,
           (const int64_t*)spos, M);
    LAUNCH(mc_scan, mem, kScanThreads, 0, st, M);
    LAUNCH(mc_apply, gs, kScanThreads, 0, st, gid, n, ns,
           (const int64_t*)spos, M);
    dim3 gr(grid_for(n, 256, 1 << 16), mem);
    LAUNCH(mc_runs, gr, 256, 0, st, gid, n, ns, *lanes, *strides, M);
    if (n > kLongRun && lanes->n > 0) {
      dim3 gc(kLBlocks, mem);
      LAUNCH(mc_chunks, gc, kLThreads, 0, st, n, *lanes, *strides, M);
      dim3 gf(grid_for(long_cap_runs(n) * lanes->n, 256, 1024), mem);
      LAUNCH(mc_fold, gf, 256, 0, st, n, ns, *lanes, *strides, M);
    }
  }
  return (int)cudaGetLastError();
}

// HK2: one member, HK2b at nmem = 1 with zero strides.
TS_API int hk2_segment_reduce(const int64_t* gid, const uint8_t* valid,
                              int64_t n, int64_t ns, const Lanes* lanes,
                              void* scratch, int64_t* out, cudaStream_t st) {
  LaneStrides none = {};
  return hk2b_segment_reduce(gid, valid, 1, n, ns, lanes, &none, scratch, out,
                             st);
}

// The present-segment compaction, one pass (present_pass above).  zero:
// int64[1 + ceil(ns / kPcTile)] (the tile counter, a look-back word a
// tile), zeroed here by one memset; *count: the number of present
// segments; a column of w = ids + rows - lo words a present segment (its
// id when ids != 0, then the table rows [lo, rows)), in body [w, ns] and,
// for the first hb columns, in head [w, hb].
TS_API int hk2_present_pass(const int64_t* table, int rows, int64_t ns,
                            int lo, int ids, int64_t hb, int64_t* zero,
                            int64_t* count, int64_t* head, int64_t* body,
                            cudaStream_t st) {
  if (rows < 1 || lo < 0 || lo > rows || ns < 1 || hb < 0 || hb > ns)
    return -1;
  const int64_t tiles = (ns + kPcTile - 1) / kPcTile;
  cudaMemsetAsync(zero, 0, 8 * (1 + tiles), st);
  LAUNCH(present_pass, (unsigned)tiles, kPcThreads, 0, st, table, rows, ns,
         lo, ids, hb, zero, count, head, body);
  return (int)cudaGetLastError();
}

// Columns [from, to) of the body [1 + rows, ns] past the count: the fill
// of present_compact's bucket.
TS_API int hk2_present_pad(const int64_t* table, int rows, int64_t ns,
                           int64_t from, int64_t to, int64_t* out,
                           cudaStream_t st) {
  if (rows < 1 || from < 0 || to > ns) return -1;
  if (to > from) {
    dim3 g(grid_for(to - from, 256, 1024), (unsigned)(1 + rows));
    LAUNCH(present_pad, g, 256, 0, st, table, ns, from, to, out);
  }
  return (int)cudaGetLastError();
}
