// HK10 semi_pick: the semi / anti / NOT IN keep ladder over a membership
// flag per probe row, and the compaction of the kept probe rows.
//
// Replaces tinysql_tpu/ops/kernels.py:1987 _semi_kernel(anti, null_aware)
// (the build side's shape scalars, the three-valued NOT IN ladder and the
// keep count) and :2030 _semi_pick_kernel (nonzero of the keep mask into
// an index list).  Membership itself is HK3's unique probe
// (equi_join.cu, hk3_unique_match): its `match` flag arrives here.
//
// The ladder, per probe row i:
//   semi                         keep = match & valid & !null
//   anti, no valid build row     keep = valid     (NOT IN () is TRUE, so
//                                                  NULL probe keys stay)
//   null-aware anti, a valid     keep = false     (x NOT IN (.., NULL)
//     build row has a NULL key                     is never TRUE)
//   null-aware anti otherwise    keep = valid & !null & !match
//   plain anti (NOT EXISTS)      keep = valid & !match
// out[0] = the keep count, out[1 + j] = the j-th kept row, ascending;
// entries past the count are not written.
//
// The build side only ever answers two yes / no questions: is any build
// row valid, and is any valid build row's key NULL.  `sp_flags` reads rv
// and rn with 16-byte loads and a warp that finds one stores 1 into its
// flag word: every store writes the same value, so no atomic and no
// order.  Semi mode never reads the build side and skips it.
//
// The probe side is one pass (`sp_pass`, in the manner of HK2's
// present_pass): tiles of kSpTile rows taken in launch order from an
// atomic counter; a thread loads 16 bytes each of match, ln and lv a
// round and forms 16 keep flags (one bit a row); a warp's shuffle scan of
// the per-thread counts ranks them, one warp scans the tile's (round,
// warp) totals, and
// common.cuh's decoupled look-back gives the tile its first output slot.
// The kept rows are staged in shared memory in row order, then the block
// writes them out as contiguous int64s.  The last tile writes the count.
// The tile counter, the flags and the look-back words live in the call's
// scratch, zeroed by one memset: memset, flags, pass (semi: memset, pass).
//
// Bound: bytes.  The probe's three flag bytes a row read once, the build
// side's two flag bytes a row read at most once (anti, NOT IN), 8 bytes
// written a kept row.  Integer counts only: the same bytes on every run.
#include "common.cuh"

namespace {

constexpr int kSpThreads = 256;
constexpr int kSpWarps = kSpThreads / 32;
constexpr int kSpRounds = 2;  // 16-byte loads of each flag a thread a tile
constexpr int64_t kSpTile = (int64_t)kSpThreads * 16 * kSpRounds;
static_assert(kSpRounds * kSpWarps <= 32, "one warp scans a tile's counts");
constexpr int kFlagBlocks = 264;  // two blocks an SM

// scratch words: [0] the tile counter, [1] a valid build row exists,
// [2] a valid build row has a NULL key, [3, 3 + tiles) the look-back
constexpr int kScratchHead = 3;

__global__ void __launch_bounds__(kSpThreads)
    sp_flags(const uint8_t* __restrict__ rn, const uint8_t* __restrict__ rv,
             int64_t n, int64_t* flags) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool any_valid = false, any_null = false;
  const bool vec = ((reinterpret_cast<uintptr_t>(rn) |
                     reinterpret_cast<uintptr_t>(rv)) & 15) == 0;
  const int64_t nvec = vec ? n / 16 : 0;
  for (int64_t c = t0; c < nvec; c += stride) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(rv) + c);
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(rn) + c);
    any_valid |= (v.x | v.y | v.z | v.w) != 0;
    any_null |= ((v.x & u.x) | (v.y & u.y) | (v.z & u.z) | (v.w & u.w)) != 0;
  }
  for (int64_t i = 16 * nvec + t0; i < n; i += stride) {
    any_valid |= rv[i] != 0;
    any_null |= (rv[i] & rn[i]) != 0;
  }
  // one store a warp that found one (the same value from every warp)
  const bool wv = __any_sync(kFull, any_valid);
  const bool wn = __any_sync(kFull, any_null);
  if ((threadIdx.x & 31) == 0) {
    if (wv) flags[0] = 1;
    if (wn) flags[1] = 1;
  }
}

// 16 keep flags of one thread's 16 rows (one bit a row, row order) from
// four words each of match, NULL and valid bytes (each byte 0 or 1).
__device__ __forceinline__ unsigned keep_bits(const uint4& m, const uint4& n,
                                              const uint4& v, int rule) {
  const unsigned mw[4] = {m.x, m.y, m.z, m.w};
  const unsigned nw[4] = {n.x, n.y, n.z, n.w};
  const unsigned vw[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned k;
    switch (rule) {
      case 0: k = mw[q] & vw[q] & ~nw[q]; break;   // semi
      case 1: k = vw[q]; break;                    // anti, empty build
      case 2: k = 0; break;                        // NOT IN, a NULL key
      case 3: k = vw[q] & ~nw[q] & ~mw[q]; break;  // NOT IN
      default: k = vw[q] & ~mw[q]; break;          // anti (NOT EXISTS)
    }
    k &= 0x01010101u;
#pragma unroll
    for (int b = 0; b < 4; ++b) bits |= ((k >> (8 * b)) & 1u) << (4 * q + b);
  }
  return bits;
}

// 16 flag bytes from row g on (zero past n): one 16-byte load when the
// run lies inside and the pointer is aligned, bytes otherwise.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int64_t g, int64_t n, bool vec) {
  if (vec && g + 16 <= n) return *reinterpret_cast<const uint4*>(p + g);
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (g + b < n) w[b >> 2] |= (unsigned)(p[g + b] != 0) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kSpThreads)
    sp_pass(const uint8_t* __restrict__ match, const uint8_t* __restrict__ ln,
            const uint8_t* __restrict__ lv, int64_t n, int anti,
            int null_aware, int64_t* scratch, int64_t* __restrict__ out) {
  __shared__ int64_t s_tile, s_prefix;
  __shared__ int s_kept;
  __shared__ unsigned s_cnt[32];
  __shared__ unsigned s_off[32];
  __shared__ uint16_t s_rows[kSpTile];  // kept rows, tile offsets in order
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0)
    s_tile = (int64_t)atomicAdd((unsigned long long*)&scratch[0], 1ULL);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kSpTile;
  int rule = 0;
  if (anti) {
    // sp_flags ran before this launch on the same stream
    const bool any_valid = scratch[1] != 0, any_null = scratch[2] != 0;
    rule = !any_valid ? 1 : !null_aware ? 4 : any_null ? 2 : 3;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(match) |
                     reinterpret_cast<uintptr_t>(ln) |
                     reinterpret_cast<uintptr_t>(lv)) & 15) == 0;
  uint4 m[kSpRounds], nl[kSpRounds], v[kSpRounds];
#pragma unroll
  for (int r = 0; r < kSpRounds; ++r) {  // every load first
    const int64_t g = base + ((int64_t)r * kSpThreads + t) * 16;
    v[r] = load16(lv, g, n, vec);
    m[r] = rule == 1 || rule == 2 ? make_uint4(0, 0, 0, 0)
                                  : load16(match, g, n, vec);
    nl[r] = rule == 0 || rule == 3 ? load16(ln, g, n, vec)
                                   : make_uint4(0, 0, 0, 0);
  }
  unsigned bits[kSpRounds], excl[kSpRounds];
#pragma unroll
  for (int r = 0; r < kSpRounds; ++r) {
    bits[r] = keep_bits(m[r], nl[r], v[r], rule);
    const unsigned c = __popc(bits[r]);
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    excl[r] = incl - c;
    if (lane == 31) s_cnt[r * kSpWarps + warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    // the tile's rows in order: (round, warp, lane, byte)
    const unsigned c = lane < kSpRounds * kSpWarps ? s_cnt[lane] : 0;
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int64_t agg = __shfl_sync(kFull, incl, 31);
    const int64_t prefix = look_back(
        (unsigned long long*)(scratch + kScratchHead), tile, agg);
    s_off[lane] = incl - c;
    if (lane == 0) {
      s_prefix = prefix;
      s_kept = (int)agg;
      if (tile == (int64_t)gridDim.x - 1) out[0] = prefix + agg;
    }
  }
  __syncthreads();
  const int64_t prefix = s_prefix;
  const int kept = s_kept;
#pragma unroll
  for (int r = 0; r < kSpRounds; ++r) {
    unsigned b = bits[r];
    int k = (int)(s_off[r * kSpWarps + warp] + excl[r]);
    const int row = (r * kSpThreads + t) * 16;
    while (b) {
      const int j = __ffs(b) - 1;
      b &= b - 1;
      s_rows[k++] = (uint16_t)(row + j);
    }
  }
  __syncthreads();
  int64_t* dst = out + 1 + prefix;
  for (int k = t; k < kept; k += kSpThreads) dst[k] = base + s_rows[k];
}

}  // namespace

// match, ln, lv: uint8[n_l]; rn, rv: uint8[n_r]; scratch: int64[3 +
// max(1, ceil(n_l / kSpTile))] (the wrapper mirrors kSpTile as
// kernels._HK10_TILE), zeroed here; out: int64[1 + n_l].
TS_API int hk10_semi_pick(const uint8_t* match, const uint8_t* ln,
                          const uint8_t* lv, int64_t n_l, const uint8_t* rn,
                          const uint8_t* rv, int64_t n_r, int anti,
                          int null_aware, int64_t* scratch, int64_t* out,
                          cudaStream_t st) {
  if (n_l < 0 || n_r < 0) return -1;
  const int64_t tiles = n_l > 0 ? (n_l + kSpTile - 1) / kSpTile : 1;
  cudaMemsetAsync(scratch, 0, 8 * (kScratchHead + tiles), st);
  if (anti && n_r > 0)
    LAUNCH(sp_flags, grid_for((n_r + 15) / 16, kSpThreads, kFlagBlocks),
           kSpThreads, 0, st, rn, rv, n_r, scratch + 1);
  LAUNCH(sp_pass, (unsigned)tiles, kSpThreads, 0, st, match,
         ln, lv, n_l, anti, null_aware, scratch, out);
  return (int)cudaGetLastError();
}
