// HK14 shard_rank: n sorted runs merged into their global stable order.
//
// Replaces the merge of tinysql_tpu/ops/shardops.py:618 _sort_rank_kernel
// (K25 sort: all_gather of every shard's sorted run and a searchsorted
// count per run) and :685 _topk_merge_kernel (K25 top-k: lax.top_k over
// the n * kb shard-major candidates, lowest index among ties).  HK4 sorts
// each shard's rows first (the shard id as the leading lane, stable); this
// kernel finishes both.  Element r of run s, key x, has the global rank
//   r + sum over t < s of #{run t <= x} + sum over t > s of #{run t < x}
// (ties go to the lower run, whose rows have the lower global index, and
// inside a run to the lower position, which HK4's stability gave the
// lower row), and out[rank] = its row id where rank < k_out: the full
// permutation (k_out = n * run) or the first k of a top-k.
//
// Keys are the uint64 order lane in row space (ord, as HK4 sorted it;
// ops/kernels.py _u64_lane of the negated score), compared unsigned.  The
// runs are given as row ids: element (s, r) is row ids[s * stride + r],
// r < run, so a top-k passes the first kb places of per-shard orders.
//
// Design: merge-path rounds.  Round j merges runs 2p and 2p + 1 of width
// run * 2^j into one run, ceil(log2 n) rounds in all, each reading every
// element once.  A block owns an output tile of kTile = 1,024 elements
// (four a thread): the block's two merge-path searches on the tile's
// diagonals in device memory (128 threads each, 128 probes a step) find
// where the tile starts and ends in each input; the block loads those
// two ranges (1,024 (key, id) pairs together) into shared memory, each
// thread finds its own diagonal there and merges its four outputs in
// sequence; the tile goes back through shared memory so that the stores
// are coalesced.  A tie always takes the left input, which holds the
// lower runs, so after every round each run is in the global stable
// order of the runs it merged, and the last round's one run is the order
// the rank formula above gives.  An odd run at the end of a round has an
// empty partner and is copied through by the same code.  Round 0 reads
// its keys through the ids (the gather is fused into it); the rounds
// between carry (key, id) pairs in two ping-pong buffers; the last round
// writes ids only, and only its tiles below k_out run.  When n * run fits
// kSmall elements (the top-k's n * 16 candidates) one block gathers every
// key into shared memory and runs all rounds there, placing each element
// by a binary search in its partner run, in one launch; n = 1 is a copy
// of the first k_out ids.
//
// Bound: bytes.  The least the function must move is each id and key read
// once and each out slot written once, 16 B an element plus 8 B an out
// slot (0.01502 ms for 8 runs of 2^18 at 3.35 TB/s).  The rounds move
// more: round 0 reads 16 B and writes 16 B an element, a middle round
// reads and writes 32 B, the last reads 16 B and writes 8 B an out slot:
// 3 rounds at 2^21 elements about 0.18 GB, about 0.055 ms at 3.35 TB/s.
// On the H100 (bench/expr_bench.py) the three rounds take 0.130 ms of
// device time at that shape (round 0 0.051, the others 0.033 and 0.032:
// a round sweeps at about half the HBM rate, its blocks' search, load,
// merge and store in series; eight outputs a thread took 0.135); the old
// design (n - 1 binary searches of log2(run) dependent steps for every
// element, 2.6 * 10^8 scattered loads) took 0.451.  Integer compares
// only, each out slot written once: the same bytes on every run.
#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kItems = 4;  // outputs a thread merges in a round
constexpr int kTile = kThreads * kItems;
constexpr int kSmall = 1024;

// one input of a merge: the ids of a run (round 0: keys through ord) or
// (key, id) pairs
template <bool kGather>
struct Side {
  const int64_t* p;
  const int64_t* ord;
  __device__ __forceinline__ u64 key(int64_t i) const {
    if (kGather) return (u64)ord[p[i]];
    return (u64)p[2 * i];
  }
  __device__ __forceinline__ void load(int64_t i, u64* k, int64_t* id) const {
    if (kGather) {
      const int64_t r = p[i];
      *id = r;
      *k = (u64)ord[r];
    } else {
      const longlong2 v = ((const longlong2*)p)[i];
      *k = (u64)v.x;
      *id = v.y;
    }
  }
};

// The number of left elements among the first d outputs of the merge of
// A[0, la) and B[0, lb), a tie taking A: A[i] comes before B[j] iff
// A[i] <= B[j].  In shared memory, by one thread.
__device__ __forceinline__ int split_in(const u64* __restrict__ sk, int na,
                                        int nb, int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] <= sk[na + d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The same split in device memory for the tile's two diagonals d0 and
// d1 at once, by the whole block: each half of it narrows one
// diagonal's range with kProbes probes a step (about four steps of one
// load each, where one thread's binary search takes about twenty), the
// last probe that holds and the first that does not bounding the next
// range.  The split of d0 lands in cut[0], of d1 in cut[1].
constexpr int kProbes = kThreads / 2;

template <class SA, class SB>
__device__ __forceinline__ void tile_cuts(const SA& a, int64_t la,
                                          const SB& b, int64_t lb,
                                          int64_t d0, int64_t d1,
                                          int64_t* cut, int64_t* top,
                                          bool* flag) {
  const int e = threadIdx.x / kProbes, l = threadIdx.x % kProbes;
  const int64_t d = e ? d1 : d0;
  if (l == 0) {
    cut[e] = d > lb ? d - lb : 0;
    top[e] = d < la ? d : la;
  }
  __syncthreads();
  while (cut[0] < top[0] || cut[1] < top[1]) {
    const int64_t lo = cut[e], len = top[e] - lo;
    const bool act = l < len;
    const int64_t p = len > kProbes ? lo + l * len / kProbes : lo + l;
    const bool t = act && a.key(p) <= b.key(d - 1 - p);
    flag[threadIdx.x] = t;
    __syncthreads();
    if (len > 0) {
      if (t && !(l + 1 < kProbes && flag[threadIdx.x + 1])) cut[e] = p + 1;
      if (act && !t && (l == 0 || flag[threadIdx.x - 1])) top[e] = p;
    }
    __syncthreads();
  }
}

// One round: block q * tpp + t writes outputs [t * kTile, ...) of merged
// run q (input runs 2q and 2q + 1 of width w).  kFinal: write ids to
// out[0, lim) (one merged run); else (key, id) pairs at the run's place.
template <bool kGather, bool kFinal>
__global__ void __launch_bounds__(kThreads)
    rk_merge(const int64_t* __restrict__ src, const int64_t* __restrict__ ord,
             int64_t stride, int64_t w, int64_t total, int64_t lim,
             int64_t tpp, int64_t* __restrict__ dst) {
  __shared__ u64 sk[kTile];
  __shared__ int64_t si[kTile];
  __shared__ int64_t cut[2], top[2];
  __shared__ bool flag[kThreads];
  const int64_t q = blockIdx.x / tpp, t = blockIdx.x - q * tpp;
  const int64_t base = q * 2 * w;
  const int64_t la = total - base < w ? total - base : w;
  const int64_t rest = total - base - w;
  const int64_t lb = rest < 0 ? 0 : (rest < w ? rest : w);
  const int64_t d0 = t * kTile;
  const int64_t dend = la + lb < lim ? la + lb : lim;
  if (d0 >= dend) return;
  const int64_t d1 = d0 + kTile < dend ? d0 + kTile : dend;
  Side<kGather> A, B;
  A.ord = B.ord = ord;
  if (kGather) {
    A.p = src + 2 * q * stride;
    B.p = A.p + stride;
  } else {
    A.p = src + 2 * base;
    B.p = A.p + 2 * w;
  }
  tile_cuts(A, la, B, lb, d0, d1, cut, top, flag);
  const int64_t i0 = cut[0], j0 = d0 - i0;
  const int na = (int)(cut[1] - i0);
  const int cnt = (int)(d1 - d0), nb = cnt - na;
  for (int e = threadIdx.x; e < cnt; e += kThreads) {
    if (e < na) A.load(i0 + e, &sk[e], &si[e]);
    else B.load(j0 + e - na, &sk[e], &si[e]);
  }
  __syncthreads();
  // this thread's outputs [o0, o1) of the tile; its split in shared
  const int o0 = (int)threadIdx.x * kItems < cnt ? (int)threadIdx.x * kItems
                                                 : cnt;
  const int o1 = o0 + kItems < cnt ? o0 + kItems : cnt;
  int a = split_in(sk, na, nb, o0), b = o0 - a;
  u64 rk[kItems];
  int64_t ri[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (o0 + k < o1) {
      const bool take_a = b >= nb || (a < na && sk[a] <= sk[na + b]);
      const int s = take_a ? a++ : na + b++;
      rk[k] = sk[s];
      ri[k] = si[s];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (o0 + k < o1) {
      sk[o0 + k] = rk[k];
      si[o0 + k] = ri[k];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cnt; e += kThreads) {
    if (kFinal) {
      dst[base + d0 + e] = si[e];
    } else {
      longlong2 v;
      v.x = (long long)sk[e];
      v.y = si[e];
      ((longlong2*)dst)[base + d0 + e] = v;
    }
  }
}

// n * run <= kSmall: every round in shared memory, one block.
__global__ void __launch_bounds__(kThreads)
    rk_small(const int64_t* __restrict__ ord, const int64_t* __restrict__ ids,
             int64_t stride, int run, int total, int rounds, int k_out,
             int64_t* __restrict__ out) {
  __shared__ u64 sk[2][kSmall];
  __shared__ int64_t si[2][kSmall];
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int s = e / run, r = e - s * run;
    const int64_t id = ids[s * stride + r];
    si[0][e] = id;
    sk[0][e] = (u64)ord[id];
  }
  __syncthreads();
  int cur = 0;
  for (int j = 0; j < rounds; ++j) {
    const int w = run << j;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int p = e / w, r = e - p * w;
      const int ob = (p ^ 1) * w;
      const int ol = total - ob < 0 ? 0 : (total - ob < w ? total - ob : w);
      const u64 x = sk[cur][e];
      const bool left = (p & 1) == 0;
      // a left element follows the partner's smaller keys, a right one
      // the partner's keys <= its own (ties to the left run)
      int lo = 0, hi = ol;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const u64 y = sk[cur][ob + mid];
        if (left ? y < x : y <= x) lo = mid + 1;
        else hi = mid;
      }
      const int to = (p & ~1) * w + r + lo;
      sk[cur ^ 1][to] = x;
      si[cur ^ 1][to] = si[cur][e];
    }
    cur ^= 1;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < k_out; e += kThreads) out[e] = si[cur][e];
}

__global__ void rk_copy(const int64_t* __restrict__ ids, int64_t k_out,
                        int64_t* __restrict__ out) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k_out;
       i += step)
    out[i] = ids[i];
}

typedef void (*MergeFn)(const int64_t*, const int64_t*, int64_t, int64_t,
                        int64_t, int64_t, int64_t, int64_t*);

}  // namespace

// ord: int64[*] (uint64 order keys in row space); ids: int64, element
// (s, r) at ids[s * stride + r]; kv0, kv1: scratch int64[2 * n * run]
// each, the (key, id) pairs of the rounds between the first and the last
// (kv0 needed from 3 runs up, kv1 from 5, neither when n * run <=
// kSmall); out: int64[k_out], k_out <= n * run.
TS_API int hk14_shard_rank(const int64_t* ord, const int64_t* ids,
                           int64_t stride, int64_t run, int n, int64_t k_out,
                           int64_t* kv0, int64_t* kv1, int64_t* out,
                           cudaStream_t st) {
  if (n < 1 || run < 1 || stride < run || k_out < 1 ||
      k_out > (int64_t)n * run)
    return -1;
  const int64_t total = (int64_t)n * run;
  int rounds = 0;
  while ((1LL << rounds) < n) ++rounds;
  if (n == 1) {
    LAUNCH(rk_copy, grid_for(k_out, kThreads, 1 << 16), kThreads, 0, st, ids,
           k_out, out);
  } else if (total <= kSmall) {
    LAUNCH(rk_small, 1, kThreads, 0, st, ord, ids, stride, (int)run,
           (int)total, rounds, (int)k_out, out);
  } else {
    if ((rounds > 1 && kv0 == nullptr) || (rounds > 2 && kv1 == nullptr))
      return -1;
    const int64_t* src = ids;
    int64_t* bufs[2] = {kv0, kv1};
    for (int j = 0; j < rounds; ++j) {
      const int64_t w = run << j;
      const int64_t n_runs = (n + (1LL << j) - 1) >> j;
      const int64_t pairs = (n_runs + 1) / 2;
      const bool last = j == rounds - 1;
      const int64_t span = 2 * w < total ? 2 * w : total;
      const int64_t lim = last ? k_out : total;
      const int64_t tpp = ((span < lim ? span : lim) + kTile - 1) / kTile;
      const unsigned grid = (unsigned)(pairs * tpp);
      int64_t* dst = last ? out : bufs[j & 1];
      MergeFn k = j == 0 ? (last ? rk_merge<true, true> : rk_merge<true, false>)
                         : (last ? rk_merge<false, true>
                                 : rk_merge<false, false>);
      LAUNCH(k, grid, kThreads, 0, st, src, ord, stride, w, total, lim, tpp,
             dst);
      src = dst;
    }
  }
  return (int)cudaGetLastError();
}
