// Lexicographic sort of rows by up to kMaxSortLanes uint64 key lanes, with
// a unique int64 position as the last lane (the row index, or the row's
// place in an earlier order).  Shared by HK4 lex_order and the
// many-segment path of HK2 segment_reduce.
//
// Because the position breaks every tie, all elements are distinct: the
// sort is a STABLE lexsort, and a top-k keeps the lowest-index row among
// equal keys (lax.top_k's tie-break).
//
// Two kernels:
// - lex_tile: a block loads T elements into shared memory, sorts them with
//   a bitonic network, and writes the first `keep` of them (keep = T for a
//   full sort, keep = k for a top-k round);
// - lex_merge: merges neighbouring sorted runs of length `run`; every
//   element finds its output rank as its index in its own run plus a binary
//   search (lower bound) in the other run.
#pragma once

#include "common.cuh"

constexpr int kMaxSortLanes = 8;

struct SortIn {
  const uint64_t* lanes[kMaxSortLanes];
  const int64_t* pos;  // null = identity (pos = index)
};
struct SortOut {
  uint64_t* lanes[kMaxSortLanes];
  int64_t* pos;
};

namespace {

inline int lex_tile_size(int m) { return m <= 2 ? 1024 : (m <= 5 ? 512 : 256); }

// shared-memory element a < element b
__device__ __forceinline__ bool lex_less_sm(const uint64_t* sl,
                                            const int64_t* sp, int m, int T,
                                            int a, int b) {
  for (int l = 0; l < m; ++l) {
    uint64_t x = sl[l * T + a], y = sl[l * T + b];
    if (x != y) return x < y;
  }
  return sp[a] < sp[b];
}

__global__ void lex_tile(SortIn in, int m, int64_t n, int T, int64_t keep,
                         SortOut out) {
  DYN_SMEM(sm);
  uint64_t* sl = (uint64_t*)sm;                    // [m][T]
  int64_t* sp = (int64_t*)(sl + (size_t)m * T);    // [T]
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * T;
  const int64_t i = base + t;
  if (i < n) {
    for (int l = 0; l < m; ++l) sl[l * T + t] = in.lanes[l][i];
    sp[t] = in.pos ? in.pos[i] : i;
  } else {  // padding sorts after every real element
    for (int l = 0; l < m; ++l) sl[l * T + t] = ~0ULL;
    sp[t] = kI64Max;
  }
  __syncthreads();
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      int p = t ^ j;
      if (p > t) {
        bool asc = (t & k) == 0;
        bool gt = lex_less_sm(sl, sp, m, T, p, t);
        if (gt == asc) {
          for (int l = 0; l < m; ++l) {
            uint64_t x = sl[l * T + t];
            sl[l * T + t] = sl[l * T + p];
            sl[l * T + p] = x;
          }
          int64_t q = sp[t];
          sp[t] = sp[p];
          sp[p] = q;
        }
      }
      __syncthreads();
    }
  }
  int64_t valid = n - base;
  if (valid > T) valid = T;
  int64_t kk = keep < valid ? keep : valid;
  if (t < kk) {
    int64_t o = (int64_t)blockIdx.x * keep + t;
    for (int l = 0; l < m; ++l) out.lanes[l][o] = sl[l * T + t];
    out.pos[o] = sp[t];
  }
}

// element idx of `in` < (key, p)
__device__ __forceinline__ bool lex_less_global(const SortIn& in, int m,
                                                int64_t idx,
                                                const uint64_t* key,
                                                int64_t p) {
  for (int l = 0; l < m; ++l) {
    uint64_t x = in.lanes[l][idx];
    if (x != key[l]) return x < key[l];
  }
  return in.pos[idx] < p;
}

__global__ void lex_merge(SortIn in, int m, int64_t n, int64_t run,
                          SortOut out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t key[kMaxSortLanes];
    for (int l = 0; l < m; ++l) key[l] = in.lanes[l][i];
    const int64_t p = in.pos[i];
    const int64_t r = i / run;
    const int64_t base = (r >> 1) * 2 * run;
    int64_t own, lo, hi;
    if ((r & 1) == 0) {
      own = i - base;
      lo = base + run;
      hi = base + 2 * run;
    } else {
      own = i - base - run;
      lo = base;
      hi = base + run;
    }
    if (hi > n) hi = n;
    if (hi < lo) hi = lo;
    int64_t a = lo, b = hi;
    while (a < b) {
      int64_t mid = a + ((b - a) >> 1);
      if (lex_less_global(in, m, mid, key, p)) a = mid + 1;
      else b = mid;
    }
    const int64_t o = base + own + (a - lo);
    for (int l = 0; l < m; ++l) out.lanes[l][o] = key[l];
    out.pos[o] = p;
  }
}

__global__ void copy_pos(const int64_t* __restrict__ src, int64_t n,
                         int64_t* __restrict__ dst) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = src[i];
}

inline SortIn as_in(const SortOut& o, int m) {
  SortIn r;
  for (int l = 0; l < kMaxSortLanes; ++l) r.lanes[l] = l < m ? o.lanes[l] : nullptr;
  r.pos = o.pos;
  return r;
}

// Sort n elements of `in` (m lanes) ascending; write the positions of the
// first min(k, n) of them (k < 0: all n) to out_pos.  bufA/bufB hold m
// lanes of n uint64 each plus n positions (ping-pong scratch).
inline int lex_sort_host(const SortIn& in, int m, int64_t n, int64_t k,
                         SortOut bufA, SortOut bufB, int64_t* out_pos,
                         cudaStream_t st) {
  if (m < 1 || m > kMaxSortLanes) return -1;
  if (n <= 0) return 0;
  const int T = lex_tile_size(m);
  const size_t smem = (size_t)T * (8 * m + 8);
  int64_t want = (k < 0 || k > n) ? n : k;
  SortOut* cur = &bufA;
  SortOut* nxt = &bufB;
  if (want < T && want < n) {
    // top-k rounds: each tile keeps its best `want`, until one tile holds
    // every candidate
    int64_t cnt = n;
    SortIn src = in;
    for (;;) {
      int64_t tiles = (cnt + T - 1) / T;
      LAUNCH(lex_tile, (unsigned)tiles, T, smem, st, src, m, cnt, T, want,
             *cur);
      int64_t last = cnt - (tiles - 1) * T;
      cnt = (tiles - 1) * want + (last < want ? last : want);
      if (tiles == 1) break;
      src = as_in(*cur, m);
      SortOut* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  } else {
    int64_t tiles = (n + T - 1) / T;
    LAUNCH(lex_tile, (unsigned)tiles, T, smem, st, in, m, n, T, (int64_t)T,
           *cur);
    for (int64_t run = T; run < n; run *= 2) {
      LAUNCH(lex_merge, grid_for(n, 256, 1 << 20), 256, 0, st,
             as_in(*cur, m), m, n, run, *nxt);
      SortOut* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  LAUNCH(copy_pos, grid_for(want, 256, 4096), 256, 0, st,
         (const int64_t*)cur->pos, want, out_pos);
  return 0;
}

}  // namespace
