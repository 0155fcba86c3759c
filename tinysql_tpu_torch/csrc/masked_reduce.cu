// HK1 masked_reduce: the global (no GROUP BY) aggregate of the fused
// device path.
//
// Replaces tinysql_tpu/ops/kernels.py:1388 fused_scalar_aggregate (K1),
// whose XLA program AND-ed the filter mask into masked count / sum / min /
// max reductions.  Here the filter mask arrives already evaluated (HK7,
// csrc/expr_eval.cu, runs the expression program) and one launch
// reduces every aggregate lane, plus the valid-row count and the first
// valid row.
//
// Bound: bytes.  The valid mask (1 B/row) is read over every row, each
// lane's NULL mask (1 B) and values (8 B) only over the valid rows (Q6
// keeps 2%); the arithmetic is a handful of operations per byte, far
// below the card's compute roofline.  At Q6's 2^23 rows the bound (about
// 3 us) is below a launch's own latency, so the design counts launches
// and serial latencies first.
//
// Design: ONE launch reads each byte once.
// - The rows are cut into tiles of kTile = kThreads * kWord rows; a
//   block owns a contiguous run of tiles (tiles_per_block, then the
//   block count, depend on n alone); in a tile thread t owns the kWord
//   rows tile + kWord * t .. + kWord - 1 and reads their valid bytes as
//   one 16-byte word (coalesced), kBatch tiles' words issued together,
//   the next batch's before the current one is folded.  At most
//   kMaxBlocks blocks: at Q6's 2^23 rows one wave of 256 blocks of 8
//   tiles (1,024 blocks of 2 took three waves, and 1.6x the time).
// - A word with no valid row touches no lane (at Q6's 2% about 72% of
//   the words).  Otherwise every lane runs over the word already in
//   registers: its NULL bytes as one more word and the values of the
//   valid rows by predicated loads, all issued together; the live rows
//   (valid, not NULL) are added in row order.
//   So the valid mask is read once whatever the lane count, and the
//   lanes and NULL masks only where a row is valid.
// - Each thread's partial folds across the block in a fixed tree (a
//   shuffle tree a warp, then one over the kWarps warp results); the
//   block writes its partial, and the LAST block to finish (an atomic
//   ticket after __threadfence) folds the partials with all its threads:
//   thread t the partials t, t + kThreads, ... in block order, then the
//   same block tree.  No float atomics: sums are bit-identical from run to
//   run.  min/max propagate NaN like jnp.min/jnp.max.
// - The ticket and the partials live in the call's scratch; the ticket
//   is zeroed by one small memset on the caller's stream before the
//   launch (no static device state: two host threads may launch at once).
//
// HK1b, the batched entry point (K12, tinysql_tpu/ops/kernels.py:1197-1266
// stacked_variant over this program): B members of a stacked round, each
// with its own valid mask and lanes (LaneStrides), in one launch; the
// member is the grid's second axis, with its own ticket and partials.
// The block ranges depend on n alone and the trees are the same, so every
// member folds its rows in the order of a solo launch: its row of the
// output is bit-identical to one.  Bound: bytes, the B masks read once
// and each member's lanes over its valid rows (shared lanes once in all).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWord = 16;  // rows a thread owns in a tile (one uint4)
constexpr int64_t kTile = (int64_t)kThreads * kWord;
constexpr int kMaxBlocks = 256;
constexpr int kBatch = 4;  // tiles whose words a thread loads together

// a partial: value bits, live count, NaN flag (float min/max)
struct Acc {
  int64_t v;
  int64_t c;
  int64_t nan;
};

// kind -1: the valid-row lane (c = count, v = first valid row)
constexpr int KIND_VALID = -1;

__device__ __forceinline__ int64_t lane_identity(int kind, int op) {
  if (op == OP_MIN) return kind == KIND_I64 ? kI64Max : f64_to_bits(INFINITY);
  if (op == OP_MAX) return kind == KIND_I64 ? kI64Min : f64_to_bits(-INFINITY);
  return kind == KIND_I64 ? 0 : f64_to_bits(0.0);
}

// fold b into a (same lane); the order of the calls is fixed
__device__ __forceinline__ Acc combine(Acc a, Acc b, int kind, int op) {
  Acc r;
  r.c = a.c + b.c;
  r.nan = a.nan | b.nan;
  if (kind == KIND_VALID) {
    r.v = b.v < a.v ? b.v : a.v;
  } else if (kind == KIND_I64) {
    if (op == OP_MIN) r.v = b.v < a.v ? b.v : a.v;
    else if (op == OP_MAX) r.v = b.v > a.v ? b.v : a.v;
    else r.v = wrap_add(a.v, b.v);
  } else {
    const double x = bits_to_f64(a.v), y = bits_to_f64(b.v);
    double z;
    if (op == OP_MIN) z = y < x ? y : x;
    else if (op == OP_MAX) z = y > x ? y : x;
    else z = x + y;
    r.v = f64_to_bits(z);
  }
  return r;
}

__device__ __forceinline__ Acc shfl_down(Acc a, int o) {
  Acc b;
  b.v = (int64_t)__shfl_down_sync(kFull, (long long)a.v, o);
  b.c = (int64_t)__shfl_down_sync(kFull, (long long)a.c, o);
  b.nan = (int64_t)__shfl_down_sync(kFull, (long long)a.nan, o);
  return b;
}

// The block's fixed tree: each warp's shuffle tree (offsets 16 .. 1),
// then warp 0's over the kWarps warp results (offsets 4, 2, 1).  The
// result is valid in thread 0.  sh: kWarps slots of shared memory.
__device__ Acc block_fold(Acc a, int kind, int op, Acc* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = combine(a, shfl_down(a, o), kind, op);
  if (lane == 0) sh[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = sh[lane < kWarps ? lane : 0];
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1)
      a = combine(a, shfl_down(a, o), kind, op);
  }
  __syncthreads();  // sh is reused by the next fold
  return a;
}

// bit k (k < 4): byte k of c is nonzero.  The first line sets 0x80 in
// each nonzero byte (no carry crosses a byte); the multiply moves the
// bits at 0, 8, 16, 24 to 21, 22, 23, 24 (every partial product lands on
// its own bit, so nothing carries).
__device__ __forceinline__ unsigned nz4(unsigned c) {
  const unsigned m = (((c & 0x7f7f7f7fu) + 0x7f7f7f7fu) | c) & 0x80808080u;
  return (((m >> 7) * 0x00204081u) >> 21) & 0xfu;
}

__device__ __forceinline__ unsigned word_bits(uint4 w) {
  return nz4(w.x) | (nz4(w.y) << 4) | (nz4(w.z) << 8) | (nz4(w.w) << 12);
}

// bit k: p[base + k] != 0 (rows base + k < n only).  One 16-byte load when
// the word is whole and aligned (a member of HK1b, or a solo call over a
// row of one, may start anywhere), else byte loads: the bits, and so the
// order of work, are the same either way.
__device__ __forceinline__ unsigned byte_bits(const uint8_t* __restrict__ p,
                                              int64_t base, int64_t n) {
  if (base + kWord <= n && ((uintptr_t)(p + base) & 15) == 0)
    return word_bits(__ldg((const uint4*)(p + base)));
  unsigned bits = 0;
  for (int k = 0; k < kWord; ++k)
    if (base + k < n && p[base + k]) bits |= 1u << k;
  return bits;
}

// Fold the live rows of one word into a lane's partial, in row order.
// The values of every VALID row are loaded (predicated, all issued
// together), so these loads and the NULL word's go out at once; the
// NULL rows among them are then left out of the fold.  The fold stays
// unrolled over the word's rows: walking the set bits instead put x in
// local memory and took 1.9x the time at Q6 (it built in 28 s, not 42).
__device__ __forceinline__ void fold_word(Acc& a, const void* xv,
                                          const uint8_t* nm, int kind,
                                          int op, int64_t base, int64_t n,
                                          unsigned bits) {
  int64_t x[kWord];
  if (op != OP_COUNT) {
    const long long* __restrict__ xi = (const long long*)xv + base;
#pragma unroll
    for (int k = 0; k < kWord; ++k)
      x[k] = (bits >> k) & 1u ? (int64_t)__ldg(xi + k) : 0;
  }
  if (nm) bits &= ~byte_bits(nm, base, n);
  a.c += __popc(bits);
  if (op == OP_COUNT || bits == 0) return;
  if (kind == KIND_I64) {
#pragma unroll
    for (int k = 0; k < kWord; ++k) {
      if (!((bits >> k) & 1u)) continue;
      if (op == OP_SUM) a.v = wrap_add(a.v, x[k]);
      else if (op == OP_MIN) a.v = x[k] < a.v ? x[k] : a.v;
      else a.v = x[k] > a.v ? x[k] : a.v;
    }
  } else {
    double s = bits_to_f64(a.v);
#pragma unroll
    for (int k = 0; k < kWord; ++k) {
      if (!((bits >> k) & 1u)) continue;
      const double v = bits_to_f64(x[k]);
      if (op == OP_SUM) s += v;
      else if (is_nan_f64(v)) a.nan = 1;
      else if (op == OP_MIN) s = v < s ? v : s;
      else s = v > s ? v : s;
    }
    a.v = f64_to_bits(s);
  }
}

struct Plan {
  int64_t n;
  int64_t tpb;  // tiles per block
  int nblk;
};

// The last block's fold of one lane: thread t folds the partials t,
// t + kThreads, ... in block order (read through L2: other blocks wrote
// them), then the block tree; the result is valid in thread 0.
__device__ __forceinline__ Acc fold_partials(const Acc* p, int nblk, Acc a,
                                             int kind, int op, Acc* sh) {
  for (int q = threadIdx.x; q < nblk; q += kThreads) {
    const long long* w = (const long long*)&p[q];
    const Acc x = {__ldcg(w), __ldcg(w + 1), __ldcg(w + 2)};
    a = combine(a, x, kind, op);
  }
  return block_fold(a, kind, op, sh);
}

// Member b = blockIdx.y: valid + b * vstride, its lanes by S, its
// partials at part + b * (L.n + 1) * nblk (lane L.n: the valid rows), its
// ticket at ticket[b], its output at out + b * (2 + 2 * L.n).  NL: the
// lanes held in registers (L.n <= NL); every lane index below is a
// compile-time constant, so L and S stay in the parameter space.
template <int NL>
__global__ void __launch_bounds__(kThreads)
    mr_reduce(const uint8_t* __restrict__ valid_all, int64_t vstride,
              Lanes L, LaneStrides S, Plan P, Acc* __restrict__ part_all,
              unsigned* __restrict__ ticket, int64_t* __restrict__ out_all) {
  __shared__ Acc sh[kWarps];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t n = P.n;
  const int nl = L.n;
  const uint8_t* __restrict__ valid = valid_all + b * vstride;
  Acc* __restrict__ part = part_all + b * (nl + 1) * (int64_t)P.nblk;

  Acc v0 = {n, 0, 0};  // the valid-row lane
  Acc acc[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j)
    acc[j] = {j < nl ? lane_identity(L.kind[j], L.op[j]) : 0, 0, 0};

  const int64_t t0 = (int64_t)blockIdx.x * P.tpb;
  int64_t t1 = t0 + P.tpb;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (t1 > ntiles) t1 = ntiles;
  // the valid words of kBatch tiles at a time; the next batch's are
  // loaded before the current one is folded
  unsigned cur[kBatch], nxt[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q)
    cur[q] = t0 + q < t1 ? byte_bits(valid, (t0 + q) * kTile + kWord * t, n)
                         : 0u;
  for (int64_t k0 = t0; k0 < t1; k0 += kBatch) {
    const int64_t k1 = k0 + kBatch;
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      nxt[q] = k1 + q < t1 ? byte_bits(valid, (k1 + q) * kTile + kWord * t, n)
                           : 0u;
    // one copy of the lanes' code: each step folds cur[0] and shifts the
    // batch down (the words stay in registers, and the code does not
    // grow with kBatch)
#pragma unroll 1
    for (int q = 0; q < kBatch; ++q) {
      const unsigned w = cur[0];
#pragma unroll
      for (int r = 0; r + 1 < kBatch; ++r) cur[r] = cur[r + 1];
      if (w == 0) continue;
      const int64_t base = (k0 + q) * kTile + kWord * t;
      if (v0.c == 0) v0.v = base + __ffs(w) - 1;
      v0.c += __popc(w);
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        if (j >= nl) break;
        fold_word(acc[j], member_vals(L, S, j, b), member_nulls(L, S, j, b),
                  L.kind[j], L.op[j], base, n, w);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) cur[q] = nxt[q];
  }

  // the block's partials
  Acc r = block_fold(v0, KIND_VALID, OP_SUM, sh);
  if (t == 0) part[(int64_t)nl * P.nblk + blockIdx.x] = r;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    if (j >= nl) break;
    r = block_fold(acc[j], L.kind[j], L.op[j], sh);
    if (t == 0) part[(int64_t)j * P.nblk + blockIdx.x] = r;
  }
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&ticket[b], 1u) == (unsigned)P.nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block folds every block's partials
  int64_t* __restrict__ out = out_all + b * (2 + 2 * nl);
  r = fold_partials(part + (int64_t)nl * P.nblk, P.nblk, Acc{n, 0, 0},
                    KIND_VALID, OP_SUM, sh);
  if (t == 0) {
    out[0] = r.c;
    out[1] = r.v < n ? r.v : 0;  // argmax(valid) of an all-false mask
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    if (j >= nl) break;
    const int kind = L.kind[j], op = L.op[j];
    r = fold_partials(part + (int64_t)j * P.nblk, P.nblk,
                      Acc{lane_identity(kind, op), 0, 0}, kind, op, sh);
    if (t == 0) {
      if (r.nan && kind == KIND_F64 && (op == OP_MIN || op == OP_MAX))
        r.v = f64_to_bits(NAN);
      out[2 + 2 * j] = r.v;
      out[3 + 2 * j] = r.c;
    }
  }
}

Plan plan_of(int64_t n) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  int64_t tpb = (ntiles + kMaxBlocks - 1) / kMaxBlocks;
  if (tpb < 1) tpb = 1;
  int64_t nblk = (ntiles + tpb - 1) / tpb;
  if (nblk < 1) nblk = 1;
  return Plan{n, tpb, (int)nblk};
}

template <int NL>
void launch_nl(dim3 g, cudaStream_t st, const uint8_t* valid,
               int64_t vstride, const Lanes& L, const LaneStrides& S,
               const Plan& P, Acc* part, unsigned* ticket, int64_t* out) {
  LAUNCH(mr_reduce<NL>, g, kThreads, 0, st, valid, vstride, L, S, P, part,
         ticket, out);
}

// scratch: nmem * (L.n + 1) * nblk partials (24 bytes each), then nmem
// uint32 tickets (the Python wrapper sizes it from the same constants)
int launch_hk1(const uint8_t* valid, int64_t nmem, int64_t n,
               int64_t vstride, const Lanes* lanes, const LaneStrides* S,
               void* scratch, int64_t* out, cudaStream_t st) {
  if (lanes->n < 0 || lanes->n > kMaxLanes || nmem < 1 || nmem > 65535 ||
      n < 0)
    return -1;
  const Plan P = plan_of(n);
  Acc* part = (Acc*)scratch;
  unsigned* ticket =
      (unsigned*)(part + nmem * (int64_t)(lanes->n + 1) * P.nblk);
  cudaMemsetAsync(ticket, 0, (size_t)nmem * sizeof(unsigned), st);
  const dim3 g((unsigned)P.nblk, (unsigned)nmem);
  const int nl = lanes->n;
  if (nl <= 1) launch_nl<1>(g, st, valid, vstride, *lanes, *S, P, part, ticket, out);
  else if (nl <= 2) launch_nl<2>(g, st, valid, vstride, *lanes, *S, P, part, ticket, out);
  else if (nl <= 4) launch_nl<4>(g, st, valid, vstride, *lanes, *S, P, part, ticket, out);
  else if (nl <= 8) launch_nl<8>(g, st, valid, vstride, *lanes, *S, P, part, ticket, out);
  else launch_nl<16>(g, st, valid, vstride, *lanes, *S, P, part, ticket, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out: int64[2 + 2 * L.n] = [n_valid, first_valid, (value bits, live
// count) per lane].
TS_API int hk1_masked_reduce(const uint8_t* valid, int64_t n,
                             const Lanes* lanes, void* scratch,
                             int64_t* out, cudaStream_t st) {
  LaneStrides none = {};
  return launch_hk1(valid, 1, n, 0, lanes, &none, scratch, out, st);
}

// HK1b: nmem members; valid is uint8[nmem * n] (member b at b * n), each
// lane's member stride in `strides`; out int64[nmem * (2 + 2 * L.n)].
TS_API int hk1b_masked_reduce(const uint8_t* valid, int64_t nmem, int64_t n,
                              const Lanes* lanes, const LaneStrides* strides,
                              void* scratch, int64_t* out, cudaStream_t st) {
  return launch_hk1(valid, nmem, n, n, lanes, strides, scratch, out, st);
}
