// Run reduction shared by HK2 segment_reduce and HK5 csr_reduce: both
// reduce contiguous runs of a sorted order (a segment's rows after HK2's
// sort, a group's rows in the memoized group index for HK5).
//
// - Acc and acc_init / acc_row / acc_merge / acc_store: one lane's running
//   count / sum / min / max.  Integer and order-key min/max do not depend
//   on the order of the rows; sums fold in the caller's fixed order.
// - The long-run queue: a run longer than kLongRun rows is cut into
//   kChunk-row chunks, a block reduces each chunk (threads take rows in a
//   fixed stride, partials fold in a fixed tree), then one thread per
//   (run, lane) folds the chunk partials in chunk order.  So one huge group
//   spreads over the whole card and still reduces in a fixed order.
// - OP_PRES is a pseudo-lane of the long-run path (HK5 only): its count is
//   the run's valid rows and its value the first (lowest) valid row.
// - Each kernel is a __device__ body plus a __global__ wrapper, so HK2's
//   batched entry point (one member per grid row) runs the very code of a
//   solo launch on each member's lanes, table and queue.
#pragma once

#include "common.cuh"

namespace {

constexpr int OP_PRES = 4;          // presence pseudo-lane (j == L.n)
constexpr int64_t kLongRun = 1024;  // longer runs are cut into chunks
constexpr int64_t kChunk = 16384;   // rows of a long run per block
constexpr int kLThreads = 256;
constexpr int kLBlocks = 264;       // two per SM of an H100 SXM

__device__ __forceinline__ int64_t value_identity(int kind, int op) {
  if (op == OP_MIN) return kind == KIND_I64 ? kI64Max : f64_to_bits(INFINITY);
  if (op == OP_MAX) return kind == KIND_I64 ? kI64Min : f64_to_bits(-INFINITY);
  return 0;  // int 0 and the bits of +0.0
}

// min/max of float lanes run over order keys; their identity
__device__ __forceinline__ int64_t mm_key_identity(int op) {
  return op == OP_MAX ? kI64Min : kI64Max;
}

__device__ __forceinline__ int64_t finish_value(int kind, int op, int64_t v,
                                                int64_t cnt, int64_t nan) {
  if (op == OP_SUM || op == OP_COUNT) return op == OP_COUNT ? 0 : v;
  if (kind == KIND_F64 && nan) return f64_to_bits(NAN);
  if (cnt == 0) return value_identity(kind, op);
  if (kind == KIND_F64) return f64_to_bits(f64_from_order_key(v));
  return v;
}

// Kind and op of lane j; j == L.n is the presence pseudo-lane.
__device__ __forceinline__ void lane_of(const Lanes& L, int j, int& kind,
                                        int& op) {
  if (j == L.n) {
    kind = KIND_I64;
    op = OP_PRES;
  } else {
    kind = L.kind[j];
    op = L.op[j];
  }
}

struct Acc {
  int64_t v;    // int sum, int / order-key min / max, or the first row
  double f;     // float sum
  int64_t cnt;  // live rows
  int64_t nan;  // a float min/max lane saw NaN
};

__device__ __forceinline__ Acc acc_init(int op) {
  Acc a;
  a.v = op == OP_SUM ? 0 : mm_key_identity(op);
  a.f = 0.0;
  a.cnt = 0;
  a.nan = 0;
  return a;
}

__device__ __forceinline__ void acc_row(Acc& a, int kind, int op,
                                        const void* xv, int64_t r) {
  ++a.cnt;
  if (op == OP_PRES) {
    a.v = r < a.v ? r : a.v;
    return;
  }
  if (op == OP_COUNT) return;
  if (kind == KIND_I64) {
    const int64_t x = ((const int64_t*)xv)[r];
    if (op == OP_SUM) a.v = wrap_add(a.v, x);
    else if (op == OP_MIN) a.v = x < a.v ? x : a.v;
    else a.v = x > a.v ? x : a.v;
    return;
  }
  const double x = ((const double*)xv)[r];
  if (op == OP_SUM) {
    a.f += x;
  } else if (is_nan_f64(x)) {
    a.nan = 1;
  } else {
    const int64_t k = f64_order_key(x);
    if (op == OP_MIN) a.v = k < a.v ? k : a.v;
    else a.v = k > a.v ? k : a.v;
  }
}

// a then b, in that order
__device__ __forceinline__ void acc_merge(Acc& a, const Acc& b, int kind,
                                          int op) {
  a.cnt += b.cnt;
  a.nan |= b.nan;
  if (op == OP_SUM) {
    if (kind == KIND_I64) a.v = wrap_add(a.v, b.v);
    else a.f += b.f;
  } else if (op == OP_MIN || op == OP_PRES) {
    a.v = b.v < a.v ? b.v : a.v;
  } else if (op == OP_MAX) {
    a.v = b.v > a.v ? b.v : a.v;
  }
}

__device__ __forceinline__ void acc_store(const Acc& a, int kind, int op,
                                          int j, int64_t g, int64_t ns,
                                          int64_t* out) {
  const int64_t v =
      op == OP_SUM && kind == KIND_F64 ? f64_to_bits(a.f) : a.v;
  out[(2 + 2 * (int64_t)j) * ns + g] = finish_value(kind, op, v, a.cnt, a.nan);
  out[(3 + 2 * (int64_t)j) * ns + g] = a.cnt;
}

// The output table, int64[(2 + 2 * L.n) * ns], set to its empty state:
// presence 0, first row `sentinel`, identities and zero counts; also
// resets the two queue counters.
__device__ void init_table(const Lanes& L, int64_t ns, int64_t sentinel,
                           int64_t* __restrict__ out,
                           int64_t* __restrict__ runs) {
  if (blockIdx.x == 0 && threadIdx.x == 0) runs[0] = runs[1] = 0;  // queues
  const int64_t rows = 2 + 2 * (int64_t)L.n;
  const int64_t total = rows * ns;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / ns;
    int64_t v = 0;
    if (r == 1) v = sentinel;
    else if (r >= 2 && (r & 1) == 0) {
      int j = (int)((r - 2) / 2);
      v = L.op[j] == OP_COUNT ? 0 : value_identity(L.kind[j], L.op[j]);
    }
    out[i] = v;
  }
}

__global__ void run_init(Lanes L, int64_t ns, int64_t sentinel,
                         int64_t* __restrict__ out,
                         int64_t* __restrict__ runs) {
  init_table(L, ns, sentinel, out, runs);
}

// The long-run queues, in scratch: runs[0] long runs queued, runs[1]
// chunks queued; then per long run k (segment, first chunk, chunk count)
// at runs[2 + 3k]; then per chunk c its [start, end) in sorted order at
// chunks[2c]; then the chunk partials, part[c * nl + lane] with nl the
// lanes of the launch (plus the presence pseudo-lane where there is one).
struct LongQueue {
  int64_t* runs;
  int64_t* chunks;
  Acc* part;
};

__host__ __device__ inline int64_t long_cap_runs(int64_t n) {
  return n / kLongRun + 1;
}
__host__ __device__ inline int64_t long_cap_chunks(int64_t n) {
  return n / kChunk + long_cap_runs(n);
}
__host__ __device__ inline int64_t long_queue_bytes(int64_t n, int nl) {
  return 8 * (2 + 3 * long_cap_runs(n) + 2 * long_cap_chunks(n)) +
         (int64_t)sizeof(Acc) * long_cap_chunks(n) * (nl > 0 ? nl : 1);
}
__host__ __device__ inline LongQueue long_queue_at(void* scratch, int64_t n) {
  LongQueue q;
  q.runs = (int64_t*)scratch;
  q.chunks = q.runs + 2 + 3 * long_cap_runs(n);
  q.part = (Acc*)(q.chunks + 2 * long_cap_chunks(n));
  return q;
}

// Queue the run [s, e) of segment g (one thread).
__device__ void queue_long_run(const LongQueue& Q, int64_t g, int64_t s,
                               int64_t e) {
  const int64_t nc = (e - s + kChunk - 1) / kChunk;
  const int64_t k = (int64_t)atomicAdd((unsigned long long*)&Q.runs[0], 1ULL);
  const int64_t c0 = (int64_t)atomicAdd((unsigned long long*)&Q.runs[1],
                                        (unsigned long long)nc);
  Q.runs[2 + 3 * k] = g;
  Q.runs[3 + 3 * k] = c0;
  Q.runs[4 + 3 * k] = nc;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t cs = s + c * kChunk;
    Q.chunks[2 * (c0 + c)] = cs;
    Q.chunks[2 * (c0 + c) + 1] = cs + kChunk < e ? cs + kChunk : e;
  }
}

// One block per queued chunk: thread t takes sorted positions cs + t,
// cs + t + T, ... in order, then the partials fold in a fixed tree.
// Rows maps a sorted position to its row, or to -1 for a row to skip.
// pres = 1 adds the presence pseudo-lane at j == L.n.
template <class Rows>
__device__ void chunk_partials(const Rows& rows, const Lanes& L, int pres,
                               const LongQueue& Q) {
  __shared__ Acc s_acc[kLThreads];
  const int t = threadIdx.x;
  const int nl = L.n + pres;
  const int64_t nchunk = Q.runs[1];
  for (int64_t c = blockIdx.x; c < nchunk; c += gridDim.x) {
    const int64_t cs = Q.chunks[2 * c], ce = Q.chunks[2 * c + 1];
    for (int j = 0; j < nl; ++j) {
      int kind, op;
      lane_of(L, j, kind, op);
      const uint8_t* nm = j < L.n ? L.nulls[j] : nullptr;
      const void* xv = j < L.n ? L.vals[j] : nullptr;
      Acc a = acc_init(op);
      for (int64_t q = cs + t; q < ce; q += kLThreads) {
        const int64_t r = rows(q);
        if (r < 0 || (nm && nm[r])) continue;
        acc_row(a, kind, op, xv, r);
      }
      s_acc[t] = a;
      __syncthreads();
      for (int st = kLThreads / 2; st > 0; st >>= 1) {
        if (t < st) {
          Acc x = s_acc[t];
          acc_merge(x, s_acc[t + st], kind, op);
          s_acc[t] = x;
        }
        __syncthreads();
      }
      if (t == 0) Q.part[c * nl + j] = s_acc[0];
      __syncthreads();
    }
  }
}

template <class Rows>
__global__ void run_chunk_partials(Rows rows, Lanes L, int pres,
                                   LongQueue Q) {
  chunk_partials(rows, L, pres, Q);
}

// One thread per (long run, lane): fold the run's chunk partials in chunk
// order.  The presence pseudo-lane writes rows 0 and 1 (first row
// `sentinel` when the run has no valid row).
__device__ void long_fold(const Lanes& L, int pres, int64_t ns,
                          int64_t sentinel, const LongQueue& Q,
                          int64_t* __restrict__ out) {
  const int nl = L.n + pres;
  const int64_t total = Q.runs[0] * nl;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t k = i / nl;
    const int j = (int)(i % nl);
    const int64_t g = Q.runs[2 + 3 * k], c0 = Q.runs[3 + 3 * k];
    const int64_t nc = Q.runs[4 + 3 * k];
    int kind, op;
    lane_of(L, j, kind, op);
    Acc a = Q.part[c0 * nl + j];
    for (int64_t c = 1; c < nc; ++c)
      acc_merge(a, Q.part[(c0 + c) * nl + j], kind, op);
    if (j == L.n) {
      out[g] = a.cnt;
      out[ns + g] = a.cnt ? a.v : sentinel;
    } else {
      acc_store(a, kind, op, j, g, ns, out);
    }
  }
}

__global__ void run_long_fold(Lanes L, int pres, int64_t ns,
                              int64_t sentinel, LongQueue Q,
                              int64_t* __restrict__ out) {
  long_fold(L, pres, ns, sentinel, Q, out);
}

}  // namespace
