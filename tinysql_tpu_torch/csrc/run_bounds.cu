// HK9 run_bounds: the runs of equal keys in a sorted order (group
// boundaries after a sort).
//
// Replaces the boundary scan of tinysql_tpu/executor/devpipe.py:1829-1851
// (K19, _SortGroupNode: a diff of the sorted key lanes, the group leaders,
// a cumsum for the group numbers and a reverse cummin for each group's
// end) and the one of tinysql_tpu/ops/kernels.py:737-870 (K4,
// group_aggregate), whose XLA programs ran those passes one by one.
//
// Inputs: perm int64[n] (sorted position -> row; valid rows first, as
// kernels.sort_lanes orders them), valid (row space) and up to kMaxKeys
// key lanes in row space, int64 or float64, each with an optional NULL
// mask.  Two neighbouring rows hold the same key when, for every lane,
// both are NULL, or neither is and the values are equal (floats compare
// as floats: -0.0 equals +0.0, NaN equals nothing) — the reference's
// NULL-aware equality.  A leader is a valid row at position 0, after an
// invalid row or after a row of another key.
//
// Outputs, all on the card (the group count never goes to the host):
//   lead int64[n]   sorted position of group g's leader, 0 from the count on;
//   ends int64[n]   group g's last sorted position; from the count on, the
//                   last group's (-1 when there is none), so HK5 sees the
//                   padding groups as empty runs;
//   count int64[1]  the number of groups;
//   gid  int64[n]   (optional) each row's group number, n for an invalid row.
//
// Bound: bytes.  perm and valid are read at each position and the key
// lanes at each valid one; lead and the padded ends are written at every
// position, gid at every row, the count once.  The reads of valid and of
// the keys are gathers through perm: each costs a 32-byte sector, so the
// design gathers each position's once.
//
// Design: one pass (rb_pass) over tiles of kRbTile sorted positions,
// taken in launch order from an atomic counter.  A thread owns kRbRows
// positions, a warp 32 consecutive ones a round: it loads their perm
// entries (coalesced) and gathers each one's valid byte, then, for a valid
// position only (valid rows sort first), every key lane's value and NULL
// flag, once, into shared memory; two threads do the same for the halo,
// the position before the tile and the one after it.  Lead and end flags
// come from the neighbours in shared memory.  Warp ballots count the
// leaders of a round, one warp scans the tile's 32 (round, warp) counts,
// and the decoupled look-back of common.cuh gives the tile its first group
// number; lead, ends and gid are written from there, and the last tile
// writes the count.  A second launch (rb_pad) reads the count on the card
// and pads lead and ends past it.  The tile counter and the look-back
// words live in the caller's scratch, zeroed by one memset: one memset and
// two launches a call, no host sync.
#include "common.cuh"

constexpr int kMaxRunKeys = 8;

struct RunKeys {
  const int64_t* vals[kMaxRunKeys];  // float64 lanes as their bits
  const uint8_t* nulls[kMaxRunKeys];  // null = the lane has no NULLs
  int is_f64[kMaxRunKeys];
  int n;
};

namespace {

constexpr int kRbThreads = 256;
constexpr int kRbWarps = kRbThreads / 32;
constexpr int kRbRows = 4;  // sorted positions a thread owns in a tile
constexpr int64_t kRbTile = (int64_t)kRbThreads * kRbRows;
constexpr int kRbSpan = (int)kRbTile + 2;  // the tile and its halo
static_assert(kRbRows * kRbWarps == 32, "one warp scans a tile's counts");
static_assert(kMaxRunKeys <= 8, "a position's NULL flags fit one byte");

// shared memory of a tile: each lane's values (kRbSpan int64 a lane), then
// a valid byte and a byte of NULL flags (bit j: lane j) a position
constexpr int smem_bytes(int nkeys) { return kRbSpan * (8 * nkeys + 2); }
constexpr int kRbMaxSmem = smem_bytes(kMaxRunKeys);

struct Tile {
  int64_t* val;  // [lane][entry]
  uint8_t* valid;
  uint8_t* null;
};

// The reference's NULL-aware equality of entries a and b (both valid).
__device__ __forceinline__ bool same(const Tile& T, const RunKeys& K, int a,
                                     int b) {
  const unsigned na = T.null[a];
  if (na != T.null[b]) return false;
  for (int j = 0; j < K.n; ++j) {
    if ((na >> j) & 1u) continue;
    const int64_t x = T.val[j * kRbSpan + a], y = T.val[j * kRbSpan + b];
    if (K.is_f64[j] ? bits_to_f64(x) != bits_to_f64(y) : x != y)
      return false;
  }
  return true;
}

// zero = [tile counter, a look-back word a tile].
__global__ void __launch_bounds__(kRbThreads)
    rb_pass(const int64_t* __restrict__ perm, int64_t n,
            const uint8_t* __restrict__ valid, RunKeys K, int64_t* zero,
            int64_t* __restrict__ count, int64_t* __restrict__ lead,
            int64_t* __restrict__ ends, int64_t* __restrict__ gid) {
  DYN_SMEM(smem);
  __shared__ int64_t s_tile;
  __shared__ unsigned s_cnt[32];
  __shared__ int64_t s_off[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  Tile T;
  T.val = (int64_t*)smem;
  T.valid = smem + 8 * K.n * kRbSpan;
  T.null = T.valid + kRbSpan;
  if (t == 0)
    s_tile = (int64_t)atomicAdd((unsigned long long*)&zero[0], 1ULL);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kRbTile;
  // the tile's positions: round r, thread t holds base + r * kRbThreads +
  // t (entry 1 + r * kRbThreads + t); thread 0 also the halo before the
  // tile, thread 32 the halo after it (slot kRbRows).  Each level of
  // loads is issued for every slot before the next level needs it.
  constexpr int kSlots = kRbRows + 1;
  int64_t row[kSlots];
  int ent[kSlots];
#pragma unroll
  for (int r = 0; r < kRbRows; ++r) {
    const int64_t q = base + r * kRbThreads + t;
    ent[r] = 1 + r * kRbThreads + t;
    row[r] = q < n ? perm[q] : -1;
  }
  {
    const int64_t q = t == 0 ? base - 1 : base + kRbTile;
    ent[kRbRows] = t == 0 ? 0 : t == 32 ? kRbSpan - 1 : -1;
    row[kRbRows] = ent[kRbRows] >= 0 && q >= 0 && q < n ? perm[q] : -1;
  }
  uint8_t v[kSlots], nb[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    v[s] = row[s] >= 0 ? valid[row[s]] : 0;
    nb[s] = 0;
  }
  for (int j = 0; j < K.n; ++j) {
    const int64_t* __restrict__ vals = K.vals[j];
    const uint8_t* __restrict__ nl = K.nulls[j];
    int64_t x[kSlots];
    uint8_t m[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      x[s] = v[s] ? vals[row[s]] : 0;
      m[s] = v[s] && nl ? nl[row[s]] : 0;
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (ent[s] >= 0) T.val[j * kRbSpan + ent[s]] = x[s];
      nb[s] |= (uint8_t)((m[s] != 0) << j);
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (ent[s] < 0) continue;
    T.valid[ent[s]] = v[s];
    T.null[ent[s]] = nb[s];
  }
  __syncthreads();
  unsigned ball[kRbRows];
  bool end[kRbRows];
#pragma unroll
  for (int r = 0; r < kRbRows; ++r) {
    const int e = ent[r];
    const bool ld = v[r] && (!T.valid[e - 1] || !same(T, K, e - 1, e));
    end[r] = v[r] && (!T.valid[e + 1] || !same(T, K, e, e + 1));
    ball[r] = __ballot_sync(kFull, ld);
    if (lane == 0) s_cnt[r * kRbWarps + warp] = __popc(ball[r]);
  }
  __syncthreads();
  if (warp == 0) {
    // the tile's positions in order: (round, warp, lane)
    const unsigned c = s_cnt[lane];
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int64_t agg = __shfl_sync(kFull, incl, 31);
    const int64_t prefix =
        look_back((unsigned long long*)(zero + 1), tile, agg);
    s_off[lane] = prefix + (incl - c);
    if (lane == 0 && tile == (int64_t)gridDim.x - 1) *count = prefix + agg;
  }
  __syncthreads();
  const unsigned le = (2u << lane) - 1u;  // lanes 0..lane
#pragma unroll
  for (int r = 0; r < kRbRows; ++r) {
    const int64_t q = base + r * kRbThreads + t;
    if (q >= n) continue;
    // groups led at or before q
    const int64_t g =
        s_off[r * kRbWarps + warp] + __popc(ball[r] & le) - 1;
    if ((ball[r] >> lane) & 1u) lead[g] = q;
    if (end[r]) ends[g] = q;
    if (gid) gid[row[r]] = v[r] ? g : n;
  }
}

__global__ void rb_pad(const int64_t* __restrict__ count, int64_t n,
                       int64_t* __restrict__ lead,
                       int64_t* __restrict__ ends) {
  const int64_t ng = *count;
  const int64_t last = ng > 0 ? ends[ng - 1] : -1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = ng + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += stride) {
    lead[g] = 0;
    ends[g] = last;
  }
}

}  // namespace

// zero: int64[1 + ceil(n / kRbTile)] (the tile counter, a look-back word
// a tile), zeroed here by one memset; count: int64[1]; gid may be null.
TS_API int hk9_run_bounds(const int64_t* perm, int64_t n, const uint8_t* valid,
                          const RunKeys* keys, int64_t* zero, int64_t* count,
                          int64_t* lead, int64_t* ends, int64_t* gid,
                          cudaStream_t st) {
  if (n < 1 || keys->n < 0 || keys->n > kMaxRunKeys) return -1;
  const int64_t tiles = (n + kRbTile - 1) / kRbTile;
  // the largest tile any call asks for, so that calls from several
  // threads never race on a smaller limit
  cudaFuncSetAttribute(rb_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kRbMaxSmem);
  cudaMemsetAsync(zero, 0, 8 * (1 + tiles), st);
  LAUNCH(rb_pass, (unsigned)tiles, kRbThreads, smem_bytes(keys->n), st, perm,
         n, valid, *keys, zero, count, lead, ends, gid);
  LAUNCH(rb_pad, grid_for(n, 256, 1 << 12), 256, 0, st, (const int64_t*)count,
         n, lead, ends);
  return (int)cudaGetLastError();
}
