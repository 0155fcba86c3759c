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
// once; at many segments the stable sort of the row ids by group moves
// several times the gid column.
//
// Design, in two regimes chosen by the segment count:
// - ns <= 64 (TPC-H Q1: 6 groups): every block privatises its partials in
//   shared memory.  Float sums accumulate in a per-(segment, thread) slot,
//   so each slot sums its rows in row order and the slots fold in thread
//   order; integer counts and order-mapped min/max use shared-memory
//   integer atomics, whose result does not depend on their order.  A
//   second pass folds the block partials in block order.
// - more segments (Q3: ~1.5M orders at SF=1): a stable sort of the row ids
//   by group id (lex_sort.cuh), then a stable compaction keeps the valid
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
// (LaneStrides); one call writes B tables.  In both regimes the member is
// a grid axis of the same kernels, and a solo launch is HK2b at B = 1 with
// zero strides.  In the sort regime the row ids are sorted by group id
// once (the ids are shared); each member then keeps its live rows of that
// order by a stable compaction (a scan per member) and reduces the runs
// of what it kept.  Same block partition, same runs, same merge order:
// every member's table is bit-identical to a solo launch's.
// Bound: bytes, gid once over the rows valid in any member, then per
// member its mask over every row, its lanes over its valid rows and its
// table written once.
#include "lex_sort.cuh"
#include "run_reduce.cuh"

namespace {

constexpr int kSmallSeg = 64;
constexpr int kSThreads = 64;
constexpr int kSMaxBlocks = 256;

struct Part {
  int64_t v;
  int64_t cnt;
  int64_t nan;
};

// member b = blockIdx.z: valid + b * vstride, its lanes by S, its
// partials at part + b * (L.n + 1) * gridDim.x * ns
__global__ void sr_small_partial(const int64_t* __restrict__ gid,
                                 const uint8_t* __restrict__ valid_all,
                                 int64_t n, int64_t vstride, int ns, Lanes L,
                                 LaneStrides S, Part* __restrict__ part_all) {
  __shared__ int64_t s_acc[kSmallSeg * kSThreads];  // [segment][thread]
  __shared__ int64_t s_cnt[kSmallSeg];
  __shared__ int64_t s_mm[kSmallSeg];
  __shared__ int s_nan[kSmallSeg];
  const int lane = blockIdx.y;  // == L.n: presence / first row
  const int64_t b = blockIdx.z;
  const uint8_t* __restrict__ valid = valid_all + b * vstride;
  Part* __restrict__ part =
      part_all + b * (L.n + 1) * (int64_t)gridDim.x * ns;
  const int t = threadIdx.x;
  const bool pres = lane == L.n;
  const int kind = pres ? KIND_I64 : L.kind[lane];
  const int op = pres ? OP_MIN : L.op[lane];
  for (int g = t; g < ns; g += blockDim.x) {
    s_cnt[g] = 0;
    s_nan[g] = 0;
    s_mm[g] = mm_key_identity(op == OP_MAX ? OP_MAX : OP_MIN);
  }
  for (int g = 0; g < ns; ++g) s_acc[g * kSThreads + t] = 0;
  __syncthreads();
  const uint8_t* nl = pres ? nullptr : member_nulls(L, S, lane, b);
  const void* xv = pres ? nullptr : member_vals(L, S, lane, b);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + t; i < n; i += stride) {
    if (!valid[i]) continue;
    const int64_t g = gid[i];
    if (g < 0 || g >= ns) continue;
    if (pres) {
      atomic_add_i64(&s_cnt[g], 1);
      atomic_min_i64(&s_mm[g], i);
      continue;
    }
    if (nl && nl[i]) continue;
    atomic_add_i64(&s_cnt[g], 1);
    if (op == OP_COUNT) continue;
    int64_t* slot = &s_acc[g * kSThreads + t];
    if (kind == KIND_I64) {
      int64_t x = ((const int64_t*)xv)[i];
      if (op == OP_SUM) *slot = wrap_add(*slot, x);
      else if (op == OP_MIN) atomic_min_i64(&s_mm[g], x);
      else atomic_max_i64(&s_mm[g], x);
    } else {
      double x = ((const double*)xv)[i];
      if (op == OP_SUM) *slot = f64_to_bits(bits_to_f64(*slot) + x);
      else if (is_nan_f64(x)) atomicOr(&s_nan[g], 1);
      else if (op == OP_MIN) atomic_min_i64(&s_mm[g], f64_order_key(x));
      else atomic_max_i64(&s_mm[g], f64_order_key(x));
    }
  }
  __syncthreads();
  for (int g = t; g < ns; g += blockDim.x) {
    Part r;
    r.cnt = s_cnt[g];
    r.nan = s_nan[g];
    if (op == OP_SUM) {
      const int64_t* a = &s_acc[g * kSThreads];
      if (kind == KIND_I64) {
        int64_t v = 0;
        for (int k = 0; k < kSThreads; ++k) v = wrap_add(v, a[k]);
        r.v = v;
      } else {
        double v = 0.0;
        for (int k = 0; k < kSThreads; ++k) v += bits_to_f64(a[k]);
        r.v = f64_to_bits(v);
      }
    } else {
      r.v = s_mm[g];
    }
    part[((int64_t)lane * gridDim.x + blockIdx.x) * ns + g] = r;
  }
}

// member b = blockIdx.y: its partials, its table at out + b * rows * ns
__global__ void sr_small_merge(Lanes L, const Part* __restrict__ part_all,
                               int nblk, int ns, int64_t n,
                               int64_t* __restrict__ out_all) {
  const int lane = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int g = threadIdx.x;
  if (g >= ns) return;
  const Part* __restrict__ part = part_all + b * (L.n + 1) * nblk * ns;
  int64_t* __restrict__ out = out_all + b * (2 + 2 * L.n) * ns;
  const bool pres = lane == L.n;
  const int kind = pres ? KIND_I64 : L.kind[lane];
  const int op = pres ? OP_MIN : L.op[lane];
  int64_t cnt = 0, nan = 0;
  int64_t v = op == OP_SUM ? 0 : mm_key_identity(op == OP_MAX ? OP_MAX : OP_MIN);
  double fv = 0.0;
  for (int b = 0; b < nblk; ++b) {
    const Part p = part[((int64_t)lane * nblk + b) * ns + g];
    cnt += p.cnt;
    nan |= p.nan;
    if (op == OP_SUM) {
      if (kind == KIND_I64) v = wrap_add(v, p.v);
      else fv += bits_to_f64(p.v);
    } else if (op == OP_MIN) {
      v = p.v < v ? p.v : v;
    } else if (op == OP_MAX) {
      v = p.v > v ? p.v : v;
    }
  }
  if (pres) {
    out[g] = cnt;
    out[ns + g] = cnt ? v : n;
    return;
  }
  if (op == OP_SUM && kind == KIND_F64) v = f64_to_bits(fv);
  out[(int64_t)(2 + 2 * lane) * ns + g] = finish_value(kind, op, v, cnt, nan);
  out[(int64_t)(3 + 2 * lane) * ns + g] = cnt;
}

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

int64_t small_blocks(int64_t n) {
  int64_t b = (n + kSThreads * 16 - 1) / (kSThreads * 16);
  if (b < 1) b = 1;
  if (b > kSMaxBlocks) b = kSMaxBlocks;
  return b;
}

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

struct PresentScan {
  const int64_t* pres;
  int64_t* ids;
  int64_t ob;
  __device__ int64_t count(int64_t g) const { return pres[g] > 0 ? 1 : 0; }
  __device__ void write(int64_t g, int64_t excl, int64_t v) const {
    if (v && excl < ob) ids[excl] = g;
  }
};

__global__ void present_gather(const int64_t* __restrict__ table, int rows,
                               int64_t ns, int64_t ob,
                               int64_t* __restrict__ packed) {
  const int64_t total = (int64_t)rows * ob;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / ob, j = i % ob;
    int64_t id = packed[j];
    int64_t safe = id < ns - 1 ? id : ns - 1;
    packed[(1 + r) * ob + j] = table[r * ns + safe];
  }
}

// the shared-memory regime for nmem members (member b's mask at
// valid + b * vstride, its table at out + b * (2 + 2 * L.n) * ns)
int launch_small(const int64_t* gid, const uint8_t* valid, int64_t nmem,
                 int64_t n, int64_t vstride, int64_t ns, const Lanes* lanes,
                 const LaneStrides* S, void* scratch, int64_t* out,
                 cudaStream_t st) {
  const int nblk = (int)small_blocks(n);
  Part* part = (Part*)scratch;
  dim3 g1((unsigned)nblk, (unsigned)(lanes->n + 1), (unsigned)nmem);
  LAUNCH(sr_small_partial, g1, kSThreads, 0, st, gid, valid, n, vstride,
         (int)ns, *lanes, *S, part);
  dim3 g2((unsigned)(lanes->n + 1), (unsigned)nmem);
  LAUNCH(sr_small_merge, g2, kSmallSeg, 0, st, *lanes, (const Part*)part,
         nblk, (int)ns, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// nmem members: per member the shared-memory regime's block partials, or
// the sort regime's keys, two ping-pong buffers (one lane + positions) and
// the sorted order, once, then per member its kept positions, count,
// block totals and long-run queue with its chunk partials
TS_API int64_t hk2b_scratch_bytes(int64_t nmem, int64_t n, int64_t ns,
                                  int nlanes) {
  if (ns <= kSmallSeg)
    return nmem * (int64_t)sizeof(Part) * (nlanes + 1) * small_blocks(n) * ns;
  return 8 * n + 2 * 16 * n + 8 * n +
         nmem * (8 * n + 8 + 8 * scan_nblocks(n) +
                 long_queue_bytes(n, nlanes));
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
    return launch_small(gid, valid, nmem, n, n, ns, lanes, strides, scratch,
                        out, st);
  uint64_t* keys = (uint64_t*)scratch;
  uint64_t* bufA = keys + n;
  uint64_t* bufB = bufA + 2 * n;
  int64_t* spos = (int64_t*)(bufB + 2 * n);
  Members M;
  M.valid = valid;
  M.mpos = spos + n;
  M.counts = M.mpos + nmem * n;
  M.nblk = scan_nblocks(n);
  M.btot = M.counts + nmem;
  M.qbytes = long_queue_bytes(n, lanes->n);
  M.queues = (char*)(M.btot + nmem * M.nblk);
  M.out = out;
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
    SortOut a, b;
    for (int l = 0; l < kMaxSortLanes; ++l) a.lanes[l] = b.lanes[l] = nullptr;
    a.lanes[0] = bufA;
    a.pos = (int64_t*)(bufA + n);
    b.lanes[0] = bufB;
    b.pos = (int64_t*)(bufB + n);
    int rc = lex_sort_host(in, 1, n, -1, a, b, spos, st);
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

// Phase 1 of the compaction: number of present segments -> *total.
// btot: int64[ceil(ns / 1024)].
TS_API int hk2_present_count(const int64_t* pres, int64_t ns, int64_t* btot,
                             int64_t* total, cudaStream_t st) {
  PresentScan sc{pres, nullptr, 0};
  int64_t nb = scan_nblocks(ns);
  LAUNCH(scan_block_totals<PresentScan>, (unsigned)nb, kScanThreads, 0, st,
         sc, ns, btot);
  LAUNCH(scan_totals, 1, kScanThreads, 0, st, btot, nb, total);
  return (int)cudaGetLastError();
}

// Phase 2 (btot as phase 1 left it): packed int64[(1 + rows) * ob] =
// present segment ids ascending (fill ns past the count), then each of the
// table's `rows` rows gathered at min(id, ns - 1).
TS_API int hk2_present_pack(const int64_t* table, int rows, int64_t ns,
                            int64_t ob, const int64_t* btot, int64_t* packed,
                            cudaStream_t st) {
  launch_fill(packed, ob, ns, st);
  PresentScan sc{table, packed, ob};  // row 0 of the table is presence
  LAUNCH(scan_apply<PresentScan>, (unsigned)scan_nblocks(ns), kScanThreads, 0,
         st, sc, ns, btot);
  LAUNCH(present_gather, grid_for((int64_t)rows * ob, 256, 1 << 16), 256, 0,
         st, table, rows, ns, ob, packed);
  return (int)cudaGetLastError();
}
