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
// Bound: bytes.  Each probe slot reads its key and id and writes hit and
// brow (25 B); the search touches log2(cap_b) build slots through perm
// (8 + 8 B each), which the L2 cache mostly serves.  Integer compares
// only: the result is the same bytes on every run.
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
    brow[i] = h ? bid[j] : -1;
  }
}

}  // namespace

// pk, pid: int64 [n * cap_p] (pk holds float64 bits when is_float);
// bord, bid, perm: int64 [n * cap_b]; hit: bool, brow: int64 [n * cap_p]
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
