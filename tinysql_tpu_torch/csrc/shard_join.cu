// HK12 shard_probe: the per-partition probe of the mesh tier's unique
// join.
//
// Replaces the body of tinysql_tpu/ops/shardops.py:271
// _local_unique_join_kernel, run per shard under shard_map: sort the
// shard's build block by (key with dead slots at the sentinel, liveness,
// slot) and searchsorted every probe slot of the shard's probe block.
// The host scatter (shardops._Partitioned) lays both sides out as
// [n][cap] blocks; the sort is HK4 (lex_order.cu) over
// (shard, key order, dead, slot) in one launch, so perm[s * cap_b + r] is
// the r-th slot of shard s's sorted run.  This kernel finishes the join:
// per probe slot i of shard s = i / cap_p, a binary search for the first
// slot of shard s's run whose key order is >= the probe key's, then
//   hit  = pid[i] >= 0 && found && that slot's key == the probe key
//          && that slot is live (bid >= 0) && the key is not NaN
//   brow = hit ? bid[that slot] : -1
// exactly the reference's (hit, where(hit, bid[sperm[loc]], -1)).
//
// Keys are int64 or float64 (is_float), compared as the uint64 order
// keys HK4 sorted on: int64 through the sign-bit flip, float64 through
// its monotone bits after -0.0 folds into +0.0; dead build slots carry
// the sentinel of int64 max / +inf.  bord is that build order lane.
//
// Member mode (brow null): hit only, the membership bit of K25's
// partitioned semi / anti join (tinysql_tpu/ops/shardops.py:380
// _local_member_kernel); the host applies the NOT IN ladder.
//
// Count mode (hk12_shard_count): the match count of every probe row
// against ONE replicated build run sorted ascending, hi - lo of the two
// searchsorted bounds (0 for an invalid row), and each shard's sum of
// them as a partial table [n][1][1] for HK11: K26's broadcast join
// counts (tinysql_tpu/parallel/dist.py:197 make_broadcast_join_counts).
//
// Bound: bytes.  Each probe slot reads its key and id and writes hit and
// brow (25 B); the search touches log2(cap_b) build slots through perm
// (8 + 8 B each), which the L2 cache mostly serves.  Count mode reads a
// key and a valid byte and writes a count (17 B) per probe row, the
// build run once.  Integer compares only (the partial sums are integer
// atomics, exact in any order): the result is the same bytes on every
// run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long probe_order(int64_t raw,
                                                          int is_float) {
  if (!is_float) return (unsigned long long)raw ^ kSign;
  const double x = bits_to_f64(raw) + 0.0;  // -0.0 -> +0.0
  const long long b = f64_to_bits(x);
  return b < 0 ? ~(unsigned long long)b : (unsigned long long)b ^ kSign;
}

__global__ void sp_probe(const int64_t* __restrict__ pk,
                         const int64_t* __restrict__ pid, int64_t cap_p,
                         const int64_t* __restrict__ bord,
                         const int64_t* __restrict__ bid,
                         const int64_t* __restrict__ perm, int64_t cap_b,
                         int64_t n_slots, int is_float,
                         uint8_t* __restrict__ hit,
                         int64_t* __restrict__ brow) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_slots; i += stride) {
    const int64_t s = i / cap_p;
    const int64_t* run = perm + s * cap_b;
    const int64_t raw = pk[i];
    const unsigned long long key = probe_order(raw, is_float);
    int64_t lo = 0, hi = cap_b;  // first r with bord[run[r]] >= key
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if ((unsigned long long)bord[run[mid]] < key) lo = mid + 1;
      else hi = mid;
    }
    const int64_t loc = lo < cap_b ? lo : cap_b - 1;
    const int64_t j = run[loc];
    const bool h = pid[i] >= 0 && lo < cap_b &&
                   (unsigned long long)bord[j] == key && bid[j] >= 0 &&
                   !(is_float && is_nan_f64(bits_to_f64(raw)));
    hit[i] = h ? 1 : 0;
    if (brow) brow[i] = h ? bid[j] : -1;
  }
}

// block (x, shard): rows of shard blockIdx.y; each block adds its sum to
// the shard's partial once
__global__ void sp_count(const int64_t* __restrict__ lk,
                         const uint8_t* __restrict__ lvalid, int64_t rows,
                         const int64_t* __restrict__ rs, int64_t nr,
                         int64_t* __restrict__ counts,
                         int64_t* __restrict__ partial) {
  __shared__ int64_t red[kThreads];
  const int64_t s = blockIdx.y;
  int64_t acc = 0;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = s * rows + r;
    int64_t c = 0;
    if (lvalid[i]) {
      const int64_t x = lk[i];
      int64_t lo = 0, hi = nr;
      while (lo < hi) {  // first >= x
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (rs[mid] < x) lo = mid + 1;
        else hi = mid;
      }
      int64_t a = lo, b = nr;
      while (a < b) {  // first > x
        const int64_t mid = a + ((b - a) >> 1);
        if (rs[mid] <= x) a = mid + 1;
        else b = mid;
      }
      c = a - lo;
    }
    counts[i] = c;
    acc += c;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int st = blockDim.x >> 1; st > 0; st >>= 1) {
    if ((int)threadIdx.x < st) red[threadIdx.x] += red[threadIdx.x + st];
    __syncthreads();
  }
  if (threadIdx.x == 0 && red[0]) atomic_add_i64(&partial[s], red[0]);
}

}  // namespace

// pk, pid: int64 [n * cap_p] (pk holds float64 bits when is_float);
// bord, bid, perm: int64 [n * cap_b]; hit: bool, brow: int64 [n * cap_p]
// (brow null: member mode)
TS_API int hk12_shard_probe(const int64_t* pk, const int64_t* pid,
                            int64_t cap_p, const int64_t* bord,
                            const int64_t* bid, const int64_t* perm,
                            int64_t cap_b, int n, int is_float, uint8_t* hit,
                            int64_t* brow, cudaStream_t st) {
  if (n < 1 || cap_p < 1 || cap_b < 1) return -1;
  const int64_t n_slots = (int64_t)n * cap_p;
  LAUNCH(sp_probe, grid_for(n_slots, kThreads, 1 << 20), kThreads, 0, st,
         pk, pid, cap_p, bord, bid, perm, cap_b, n_slots, is_float, hit,
         brow);
  return (int)cudaGetLastError();
}

// lk: int64 [n * rows], lvalid: bool [n * rows], rs: int64 [nr] sorted
// ascending; counts: int64 [n * rows], partial: int64 [n] (zeroed here)
TS_API int hk12_shard_count(const int64_t* lk, const uint8_t* lvalid,
                            int64_t rows, int n, const int64_t* rs,
                            int64_t nr, int64_t* counts, int64_t* partial,
                            cudaStream_t st) {
  if (n < 1 || n > 65535 || rows < 1 || nr < 0) return -1;
  cudaMemsetAsync(partial, 0, (size_t)n * sizeof(int64_t), st);
  dim3 grid(grid_for(rows, kThreads, 4096), (unsigned)n);
  LAUNCH(sp_count, grid, kThreads, 0, st, lk, lvalid, rows, rs, nr, counts,
         partial);
  return (int)cudaGetLastError();
}
