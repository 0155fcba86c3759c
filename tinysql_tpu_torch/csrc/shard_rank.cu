// HK14 shard_rank: the exact global rank of n sorted runs, written as the
// merged order.
//
// Replaces the merge of tinysql_tpu/ops/shardops.py:618 _sort_rank_kernel
// (K25 sort: all_gather of every shard's sorted run and a searchsorted
// count per run) and :685 _topk_merge_kernel (K25 top-k: lax.top_k over
// the n * kb shard-major candidates, lowest index among ties).  HK4 sorts
// each shard's rows first (the shard id as the leading lane, stable); this
// kernel finishes both: element r of run s, key x, has the global rank
//   r + sum over t < s of #{run t <= x} + sum over t > s of #{run t < x}
// (ties go to the lower shard, whose rows have the lower global index,
// and inside a run to the lower position, which HK4's stability gave the
// lower row), and out[rank] = its row id where rank < k_out: the full
// permutation (k_out = n * run) or the first k of a top-k.
//
// Keys are the uint64 order lane in row space (ord, as HK4 sorted it;
// ops/kernels.py _u64_lane of the negated score), compared unsigned.  The
// runs are given as row ids: element (s, r) is row ids[s * stride + r],
// r < run, so a top-k passes the first kb places of per-shard orders.
//
// Bound: latency.  Pass 1 gathers the keys of the runs into sk (read the
// ids and keys once, write sk once); pass 2 gives each element n - 1
// binary searches of log2(run) dependent steps in sk, which the L2 cache
// serves, and one write.  Integer compares only, each out slot written by
// exactly one element: the same bytes on every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rk_gather(const int64_t* __restrict__ ord,
                          const int64_t* __restrict__ ids, int64_t stride,
                          int64_t run, int64_t total,
                          unsigned long long* __restrict__ sk) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int64_t s = i / run, r = i - s * run;
    sk[i] = (unsigned long long)ord[ids[s * stride + r]];
  }
}

// first place in a[0, len) whose key is > x (upper) or >= x (lower)
__device__ __forceinline__ int64_t bound_in(
    const unsigned long long* __restrict__ a, int64_t len,
    unsigned long long x, bool upper) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const unsigned long long v = a[mid];
    if (upper ? v <= x : v < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void rk_rank(const unsigned long long* __restrict__ sk,
                        const int64_t* __restrict__ ids, int64_t stride,
                        int64_t run, int n, int64_t k_out,
                        int64_t* __restrict__ out) {
  const int64_t total = (int64_t)n * run;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int64_t s = i / run, r = i - s * run;
    const unsigned long long x = sk[i];
    int64_t rank = r;
    for (int t = 0; t < n && rank < k_out; ++t) {
      if (t == s) continue;
      rank += bound_in(sk + (int64_t)t * run, run, x, t < s);
    }
    if (rank < k_out) out[rank] = ids[s * stride + r];
  }
}

}  // namespace

// ord: int64[*] (uint64 order keys in row space); ids: int64, element
// (s, r) at ids[s * stride + r]; sk: scratch int64[n * run]; out:
// int64[k_out], k_out <= n * run.
TS_API int hk14_shard_rank(const int64_t* ord, const int64_t* ids,
                           int64_t stride, int64_t run, int n, int64_t k_out,
                           int64_t* sk, int64_t* out, cudaStream_t st) {
  if (n < 1 || run < 1 || stride < run || k_out < 1 ||
      k_out > (int64_t)n * run)
    return -1;
  const int64_t total = (int64_t)n * run;
  LAUNCH(rk_gather, grid_for(total, kThreads, 1 << 16), kThreads, 0, st, ord,
         ids, stride, run, total, (unsigned long long*)sk);
  LAUNCH(rk_rank, grid_for(total, kThreads, 1 << 16), kThreads, 0, st,
         (const unsigned long long*)sk, ids, stride, run, n, k_out, out);
  return (int)cudaGetLastError();
}
