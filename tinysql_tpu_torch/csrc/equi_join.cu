// HK3 equi_join: (li, ri) match pairs of a single-key int64 equi-join.
//
// Replaces tinysql_tpu/ops/kernels.py:1803-1960 unique_join_match (K6:
// lexsort of the build side, searchsorted probe, live-candidate check,
// nonzero compaction) and :1641-1800 join_match (K7: per-probe live match
// counts, exclusive scan, expansion with ri = -1 for unmatched outer rows).
//
// Keys arrive as int64 whose signed order is the key order: integer keys
// as they are, float keys as order keys with -0.0 folded into +0.0 and NaN
// moved into the NULL mask (ops/kernels.py does that in torch).  A probe
// row is live when valid and not NULL; a build row when valid and not
// NULL.  Dead build rows are simply never inserted, so a live key equal to
// any sentinel (int64 max) is found like any other (the collision of
// tests/test_tpu_ops.py:384 cannot happen).
//
// Bound: bytes for the probe (key, NULL and valid of every probe row, one
// table read, the outputs), random table accesses for the build.
//
// Unique build side (K6):
// - dense: when the live key range is small enough (the host twin's rule,
//   card <= max(2^22, 4 * live rows)), a key -> row table indexed by
//   key - kmin, in dense_table.cuh's format (int32, -1 absent) and probed
//   by its in-range lookup, as HK6 and HK8 probe theirs; the index is
//   computed only for probe keys inside [kmin, kmax], so key - kmin never
//   wraps (R4);
// - hash: otherwise, open addressing with linear probing over slots that
//   hold row + 1; keys are compared through the build key column, so no key
//   value is reserved as "empty".
//   Either way equal live keys keep the LOWEST row (atomicMin), which is
//   the row the reference's stable lexsort finds first.
//   The table is built from the live rows alone and never assumes a sorted
//   build side, so no "build keys ascend" claim exists to be broken by a
//   validity mask with holes mid-array (the reference's R3).
// - compaction: an exclusive scan over the kept probe rows (matched rows,
//   or every valid row for an outer join) writes li ascending and ri.
// Any multiplicity (K7): the build side is sorted by HK4 (live rows first,
// then key, then row); every probe row binary-searches its run of equal
// keys, and expand.cuh (shared with HK8) places the expansion in
// probe-major order with build rows in stable key order: an inclusive scan
// of the per-row output counts, then one thread per output slot.
#include "dense_table.cuh"
#include "expand.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStatBlocks = 512;

__device__ __forceinline__ bool live_row(const uint8_t* v, const uint8_t* nl,
                                         int64_t i) {
  return v[i] && !nl[i];
}

__global__ void ej_stats_partial(const int64_t* __restrict__ k,
                                 const uint8_t* __restrict__ nl,
                                 const uint8_t* __restrict__ v, int64_t n,
                                 int64_t* __restrict__ part) {
  __shared__ int64_t s_cnt[kThreads], s_min[kThreads], s_max[kThreads];
  const int t = threadIdx.x;
  int64_t cnt = 0, mn = kI64Max, mx = kI64Min;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + t; i < n; i += stride) {
    if (!live_row(v, nl, i)) continue;
    ++cnt;
    int64_t x = k[i];
    mn = x < mn ? x : mn;
    mx = x > mx ? x : mx;
  }
  s_cnt[t] = cnt;
  s_min[t] = mn;
  s_max[t] = mx;
  __syncthreads();
  for (int st = blockDim.x >> 1; st > 0; st >>= 1) {
    if (t < st) {
      s_cnt[t] += s_cnt[t + st];
      s_min[t] = s_min[t + st] < s_min[t] ? s_min[t + st] : s_min[t];
      s_max[t] = s_max[t + st] > s_max[t] ? s_max[t + st] : s_max[t];
    }
    __syncthreads();
  }
  if (t == 0) {
    part[3 * blockIdx.x] = s_cnt[0];
    part[3 * blockIdx.x + 1] = s_min[0];
    part[3 * blockIdx.x + 2] = s_max[0];
  }
}

__global__ void ej_stats_merge(const int64_t* __restrict__ part, int nblk,
                               int64_t* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int64_t cnt = 0, mn = kI64Max, mx = kI64Min;
  for (int b = 0; b < nblk; ++b) {
    cnt += part[3 * b];
    mn = part[3 * b + 1] < mn ? part[3 * b + 1] : mn;
    mx = part[3 * b + 2] > mx ? part[3 * b + 2] : mx;
  }
  out[0] = cnt;
  out[1] = mn;
  out[2] = mx;
}

__global__ void ej_dense_build(const int64_t* __restrict__ k,
                               const uint8_t* __restrict__ nl,
                               const uint8_t* __restrict__ v, int64_t n,
                               int64_t kmin, int32_t* __restrict__ table) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // live keys lie in [kmin, kmax]: the difference is the table index
    if (live_row(v, nl, i)) table_insert_min(table, kmin, k[i], i);
  }
}

__global__ void ej_dense_probe(const int64_t* __restrict__ k,
                               const uint8_t* __restrict__ nl,
                               const uint8_t* __restrict__ v, int64_t n,
                               int64_t kmin, int64_t kmax,
                               const int32_t* __restrict__ table,
                               int64_t card, int64_t* __restrict__ cand,
                               uint8_t* __restrict__ match) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // R4: the lookup takes key - kmin only for keys inside [kmin, kmax]
    const int64_t c =
        live_row(v, nl, i) ? table_lookup(table, card, kmin, kmax, k[i]) : -1;
    cand[i] = c;
    match[i] = c >= 0;
  }
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

// slots hold row + 1 (0 = empty); cap is a power of two
__global__ void ej_hash_build(const int64_t* __restrict__ k,
                              const uint8_t* __restrict__ nl,
                              const uint8_t* __restrict__ v, int64_t n,
                              int64_t* __restrict__ slots, int64_t cap) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const unsigned long long mask = (unsigned long long)cap - 1;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!live_row(v, nl, i)) continue;
    const int64_t x = k[i];
    unsigned long long s = mix64((unsigned long long)x) & mask;
    for (;;) {
      unsigned long long old = atomicCAS((unsigned long long*)&slots[s], 0ULL,
                                         (unsigned long long)(i + 1));
      if (old == 0ULL) break;
      if (k[(int64_t)old - 1] == x) {  // same key: keep the lowest row
        atomic_min_i64(&slots[s], i + 1);
        break;
      }
      s = (s + 1) & mask;
    }
  }
}

__global__ void ej_hash_probe(const int64_t* __restrict__ lk,
                              const uint8_t* __restrict__ ln,
                              const uint8_t* __restrict__ lv, int64_t n,
                              const int64_t* __restrict__ rk,
                              const int64_t* __restrict__ slots, int64_t cap,
                              int64_t* __restrict__ cand,
                              uint8_t* __restrict__ match) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const unsigned long long mask = (unsigned long long)cap - 1;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t c = -1;
    if (live_row(lv, ln, i)) {
      const int64_t x = lk[i];
      unsigned long long s = mix64((unsigned long long)x) & mask;
      for (;;) {
        int64_t r1 = slots[s];
        if (r1 == 0) break;
        if (rk[r1 - 1] == x) {
          c = r1 - 1;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    cand[i] = c;
    match[i] = c >= 0;
  }
}

// kept probe rows -> (li, ri); kept = match (inner) or valid (outer)
struct PickScan {
  const uint8_t* keep;
  const uint8_t* match;
  const int64_t* cand;
  int64_t* li;
  int64_t* ri;
  __device__ int64_t count(int64_t i) const { return keep[i] ? 1 : 0; }
  __device__ void write(int64_t i, int64_t excl, int64_t v) const {
    if (!v) return;
    li[excl] = i;
    ri[excl] = match[i] ? cand[i] : -1;
  }
};

// any multiplicity: per probe row, the run of equal live build keys
__global__ void ej_mult_count(const int64_t* __restrict__ lk,
                              const uint8_t* __restrict__ ln,
                              const uint8_t* __restrict__ lv, int64_t n,
                              const int64_t* __restrict__ rk,
                              const int64_t* __restrict__ perm,
                              int64_t n_live, int64_t* __restrict__ lo,
                              int64_t* __restrict__ cnt) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t a = 0, c = 0;
    if (live_row(lv, ln, i)) {
      const int64_t x = lk[i];
      int64_t b = n_live;
      while (a < b) {  // lower bound
        int64_t m = a + ((b - a) >> 1);
        if (rk[perm[m]] < x) a = m + 1;
        else b = m;
      }
      int64_t e = a;
      b = n_live;
      while (e < b) {  // upper bound
        int64_t m = e + ((b - e) >> 1);
        if (rk[perm[m]] <= x) e = m + 1;
        else b = m;
      }
      c = e - a;
    }
    lo[i] = a;
    cnt[i] = c;
  }
}

// output rows of probe row i: its matches, or one for an unmatched valid
// row of an outer join
struct MultCount {
  const uint8_t* lv;
  const int64_t* cnt;
  int outer;
  __device__ int64_t operator()(int64_t i) const {
    return (outer && lv[i] && cnt[i] == 0) ? 1 : cnt[i];
  }
};

__global__ void ej_mult_fill(MultCount mc, const int64_t* __restrict__ incl,
                             int64_t n_l, const int64_t* __restrict__ lo,
                             const int64_t* __restrict__ perm, int64_t total,
                             int64_t* __restrict__ li,
                             int64_t* __restrict__ ri) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    const int64_t p = owner_of(incl, n_l, j);
    const int64_t t = j - (incl[p] - mc(p));
    li[j] = p;
    ri[j] = mc.cnt[p] > 0 ? perm[lo[p] + t] : -1;
  }
}

}  // namespace

// out3 = [live rows, kmin, kmax] of the build side; part: 3 * 512 int64.
TS_API int hk3_build_stats(const int64_t* k, const uint8_t* nl,
                           const uint8_t* v, int64_t n, int64_t* part,
                           int64_t* out3, cudaStream_t st) {
  int nblk = (int)grid_for(n, kThreads, kStatBlocks);
  LAUNCH(ej_stats_partial, nblk, kThreads, 0, st, k, nl, v, n, part);
  LAUNCH(ej_stats_merge, 1, 1, 0, st, (const int64_t*)part, nblk, out3);
  return (int)cudaGetLastError();
}

// Unique build side.  dense != 0: tbuf is the table, int32[tsize] (tsize
// the key range card, dense_table.cuh's format; n_r < 2^31); else the hash
// slots, int64[tsize] (a power of two).  Writes cand int64[n_l] (-1 =
// none) and match.
TS_API int hk3_unique_match(const int64_t* lk, const uint8_t* ln,
                            const uint8_t* lv, int64_t n_l, const int64_t* rk,
                            const uint8_t* rn, const uint8_t* rv, int64_t n_r,
                            int dense, int64_t kmin, int64_t kmax,
                            void* tbuf, int64_t tsize, int64_t* cand,
                            uint8_t* match, cudaStream_t st) {
  if (dense) {
    if (n_r >= (1LL << 31)) return -1;
    int32_t* table = (int32_t*)tbuf;
    cudaMemsetAsync(table, 0xff, (size_t)tsize * sizeof(int32_t), st);
    if (n_r > 0)
      LAUNCH(ej_dense_build, grid_for(n_r, kThreads), kThreads, 0, st, rk, rn,
             rv, n_r, kmin, table);
    if (n_l > 0)
      LAUNCH(ej_dense_probe, grid_for(n_l, kThreads), kThreads, 0, st, lk, ln,
             lv, n_l, kmin, kmax, (const int32_t*)table, tsize, cand, match);
  } else {
    int64_t* table = (int64_t*)tbuf;
    launch_fill(table, tsize, 0, st);
    if (n_r > 0)
      LAUNCH(ej_hash_build, grid_for(n_r, kThreads), kThreads, 0, st, rk, rn,
             rv, n_r, table, tsize);
    if (n_l > 0)
      LAUNCH(ej_hash_probe, grid_for(n_l, kThreads), kThreads, 0, st, lk, ln,
             lv, n_l, rk, (const int64_t*)table, tsize, cand, match);
  }
  return (int)cudaGetLastError();
}

// Compaction phase 1: kept rows -> *total.  btot: int64[ceil(n / 1024)].
TS_API int hk3_pick_count(const uint8_t* keep, int64_t n, int64_t* btot,
                          int64_t* total, cudaStream_t st) {
  PickScan sc{keep, nullptr, nullptr, nullptr, nullptr};
  int64_t nb = scan_nblocks(n);
  LAUNCH(scan_block_totals<PickScan>, (unsigned)nb, kScanThreads, 0, st, sc,
         n, btot);
  LAUNCH(scan_totals, 1, kScanThreads, 0, st, btot, nb, total);
  return (int)cudaGetLastError();
}

// Compaction phase 2 (btot as phase 1 left it): li/ri int64[total].
TS_API int hk3_pick(const uint8_t* keep, const uint8_t* match,
                    const int64_t* cand, int64_t n, const int64_t* btot,
                    int64_t* li, int64_t* ri, cudaStream_t st) {
  PickScan sc{keep, match, cand, li, ri};
  LAUNCH(scan_apply<PickScan>, (unsigned)scan_nblocks(n), kScanThreads, 0, st,
         sc, n, btot);
  return (int)cudaGetLastError();
}

// Any multiplicity, phase 1: per-row run (lo, cnt), the inclusive ends of
// the per-row output counts (incl int64[n_l]) and the output size.
// perm: build rows sorted (live first, then key, then row); n_live of them
// live.  btot: int64[ceil(n_l / 1024)].
TS_API int hk3_mult_count(const int64_t* lk, const uint8_t* ln,
                          const uint8_t* lv, int64_t n_l, const int64_t* rk,
                          const int64_t* perm, int64_t n_live, int outer,
                          int64_t* lo, int64_t* cnt, int64_t* incl,
                          int64_t* btot, int64_t* total, cudaStream_t st) {
  if (n_l > 0)
    LAUNCH(ej_mult_count, grid_for(n_l, kThreads), kThreads, 0, st, lk, ln,
           lv, n_l, rk, perm, n_live, lo, cnt);
  launch_scan(InclusiveEnds<MultCount>{MultCount{lv, cnt, outer}, incl}, n_l,
              btot, total, st);
  return (int)cudaGetLastError();
}

// Any multiplicity, phase 2: li/ri int64[total] in probe-major order.
TS_API int hk3_mult_expand(const uint8_t* lv, int64_t n_l, const int64_t* lo,
                           const int64_t* cnt, const int64_t* incl,
                           const int64_t* perm, int outer, int64_t total,
                           int64_t* li, int64_t* ri, cudaStream_t st) {
  if (total > 0)
    LAUNCH(ej_mult_fill, grid_for(total, kThreads, 1 << 16), kThreads, 0, st,
           MultCount{lv, cnt, outer}, incl, n_l, lo, perm, total, li, ri);
  return (int)cudaGetLastError();
}
