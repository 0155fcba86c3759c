// HK1 masked_reduce: the global (no GROUP BY) aggregate of the fused
// device path.
//
// Replaces tinysql_tpu/ops/kernels.py:1388 fused_scalar_aggregate (K1),
// whose XLA program AND-ed the filter mask into masked count / sum / min /
// max reductions.  Here the filter mask arrives already evaluated (the
// expression tree runs as torch tensor ops in this slice) and one launch
// reduces every aggregate lane, plus the valid-row count and the first
// valid row.
//
// Bound: bytes.  Each lane reads its values (8 B/row), its NULL mask
// (1 B/row) and the valid mask (1 B/row) once; the arithmetic is a handful
// of operations per byte, far below the card's compute roofline.
//
// Design: pass 1 gives every (block, lane) pair a fixed, strided set of
// rows (a grid-stride loop whose grid depends only on n), reduces it per
// thread in row order and then across the block in a fixed shared-memory
// tree; pass 2 folds the per-block partials of each lane in block order on
// one thread.  No float atomics, so sums are bit-identical from run to run.
// min/max propagate NaN like jnp.min/jnp.max.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

// partial record per (lane, block): value bits, live count, NaN flag
struct Part {
  int64_t v;
  int64_t cnt;
  int64_t nan;
};

__device__ __forceinline__ int64_t lane_identity(int kind, int op) {
  if (op == OP_MIN) return kind == KIND_I64 ? kI64Max : f64_to_bits(INFINITY);
  if (op == OP_MAX) return kind == KIND_I64 ? kI64Min : f64_to_bits(-INFINITY);
  return kind == KIND_I64 ? 0 : f64_to_bits(0.0);
}

// fold b into a (same lane kind/op); order of the calls is fixed
__device__ __forceinline__ Part lane_combine(Part a, Part b, int kind,
                                              int op) {
  Part r;
  r.cnt = a.cnt + b.cnt;
  r.nan = a.nan | b.nan;
  if (kind == KIND_I64) {
    if (op == OP_MIN) r.v = a.v < b.v ? a.v : b.v;
    else if (op == OP_MAX) r.v = a.v > b.v ? a.v : b.v;
    else r.v = wrap_add(a.v, b.v);
  } else {
    double x = bits_to_f64(a.v), y = bits_to_f64(b.v);
    double z;
    if (op == OP_MIN) z = y < x ? y : x;
    else if (op == OP_MAX) z = y > x ? y : x;
    else z = x + y;
    r.v = f64_to_bits(z);
  }
  return r;
}

__global__ void mr_partial(const uint8_t* __restrict__ valid, int64_t n,
                           Lanes L, Part* __restrict__ part) {
  __shared__ Part s[kThreads];
  const int lane = blockIdx.y;  // == L.n: the valid-count/first lane
  const int t = threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + t;
  Part acc;
  int kind = KIND_I64, op = OP_COUNT;
  if (lane == L.n) {
    // valid rows: count, and the first one (sentinel n when none)
    acc.v = n;
    acc.cnt = 0;
    acc.nan = 0;
    for (; i < n; i += stride) {
      if (valid[i]) {
        acc.cnt += 1;
        if (i < acc.v) acc.v = i;
      }
    }
  } else {
    kind = L.kind[lane];
    op = L.op[lane];
    const uint8_t* nl = L.nulls[lane];
    acc.v = lane_identity(kind, op);
    acc.cnt = 0;
    acc.nan = 0;
    if (kind == KIND_I64) {
      const int64_t* x = (const int64_t*)L.vals[lane];
      for (; i < n; i += stride) {
        if (!valid[i] || (nl && nl[i])) continue;
        acc.cnt += 1;
        if (op == OP_COUNT) continue;
        int64_t v = x[i];
        if (op == OP_SUM) acc.v = wrap_add(acc.v, v);
        else if (op == OP_MIN) acc.v = v < acc.v ? v : acc.v;
        else acc.v = v > acc.v ? v : acc.v;
      }
    } else {
      const double* x = (const double*)L.vals[lane];
      double a = bits_to_f64(acc.v);
      for (; i < n; i += stride) {
        if (!valid[i] || (nl && nl[i])) continue;
        acc.cnt += 1;
        if (op == OP_COUNT) continue;
        double v = x[i];
        if (op == OP_SUM) a += v;
        else if (is_nan_f64(v)) acc.nan = 1;
        else if (op == OP_MIN) a = v < a ? v : a;
        else a = v > a ? v : a;
      }
      acc.v = f64_to_bits(a);
    }
  }
  s[t] = acc;
  __syncthreads();
  for (int st = blockDim.x >> 1; st > 0; st >>= 1) {
    if (t < st) {
      if (lane == L.n) {
        Part a = s[t], b = s[t + st];
        a.cnt += b.cnt;
        a.v = b.v < a.v ? b.v : a.v;
        s[t] = a;
      } else {
        s[t] = lane_combine(s[t], s[t + st], kind, op);
      }
    }
    __syncthreads();
  }
  if (t == 0) part[(int64_t)lane * gridDim.x + blockIdx.x] = s[0];
}

// one thread per lane: fold the block partials in block order
__global__ void mr_merge(Lanes L, const Part* __restrict__ part, int nblk,
                         int64_t n, int64_t* __restrict__ out) {
  const int lane = blockIdx.x;
  if (threadIdx.x != 0) return;
  const Part* p = part + (int64_t)lane * nblk;
  if (lane == L.n) {
    int64_t cnt = 0, first = n;
    for (int b = 0; b < nblk; ++b) {
      cnt += p[b].cnt;
      if (p[b].v < first) first = p[b].v;
    }
    out[0] = cnt;
    out[1] = first < n ? first : 0;  // argmax(valid) of an all-false mask
    return;
  }
  int kind = L.kind[lane], op = L.op[lane];
  Part acc = p[0];
  for (int b = 1; b < nblk; ++b) acc = lane_combine(acc, p[b], kind, op);
  if (acc.nan && kind == KIND_F64 && (op == OP_MIN || op == OP_MAX))
    acc.v = f64_to_bits(NAN);
  out[2 + 2 * lane] = acc.v;
  out[3 + 2 * lane] = acc.cnt;
}

}  // namespace

// out: int64[2 + 2 * L.n] = [n_valid, first_valid, (value bits, live
// count) per lane]; part: scratch of hk1_scratch_bytes(n, L.n) bytes.
TS_API int64_t hk1_blocks(int64_t n) {
  int64_t b = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b;
}

TS_API int64_t hk1_scratch_bytes(int64_t n, int nlanes) {
  return (int64_t)sizeof(Part) * (nlanes + 1) * hk1_blocks(n);
}

TS_API int hk1_masked_reduce(const uint8_t* valid, int64_t n,
                             const Lanes* lanes, void* scratch,
                             int64_t* out, cudaStream_t st) {
  if (lanes->n < 0 || lanes->n > kMaxLanes) return -1;
  int nblk = (int)hk1_blocks(n);
  Part* part = (Part*)scratch;
  dim3 g1((unsigned)nblk, (unsigned)(lanes->n + 1));
  LAUNCH(mr_partial, g1, kThreads, 0, st, valid, n, *lanes, part);
  LAUNCH(mr_merge, (unsigned)(lanes->n + 1), 1, 0, st, *lanes,
         (const Part*)part, nblk, n, out);
  return (int)cudaGetLastError();
}
