// Few-segment reduction shared by HK2 segment_reduce (ns <= kSmallSeg),
// its batched entry point HK2b and HK5 csr_reduce (ng <= kSmallSeg, over
// a row -> group map): one pass over the rows in row order that reads
// each input byte once (TPC-H Q1: 4 live groups of lineitem, 7 float
// SUM lanes and 3 counts).
//
// Bound: bytes.  The group of every row once (HK2's int64 ids, HK5's map
// byte), each member's valid mask once, each lane's values and NULL mask
// once over the live rows (a lane the members share once for all of
// them), the table written once.
//
// Tiles.  The rows are cut into tiles of kFTile = kFThreads * kFRows
// rows, one block each, so the partition depends on n alone: not on the
// grid, the card or the member count.  Thread t of a tile owns the row
// pairs base + 2 * (k * kFThreads + t) + {0, 1}, k < kFPairs: a warp's
// 16-byte loads (two int64 / float64 values) are coalesced, and a
// thread's rows ascend.  The block loads each row's group once (a byte:
// its segment, or kNone), each member's valid mask once (as bits in
// shared memory), then pass by pass (presence, then each lane; members
// in turn inside each) the pass's values and NULL mask: a lane the
// members share (stride 0) once, held in registers while the members run
// over it.  Nothing is read again per lane or per member, and a pass's
// loads are issued as soon as the pass before has added its rows, so
// they fly while that pass folds.
//
// Slots.  A pass adds its live rows into per-thread slots in shared
// memory, slot [segment][thread]: one writer each, no atomics, and a
// thread adds its rows in row order.  The block then folds the slots of
// each segment the tile holds in a fixed order (few_fold_tile) into the
// tile's partial.  A lane without a NULL mask counts the presence
// pseudo-lane's rows, so it keeps no count slots (a float MIN/MAX lane
// still keeps its NaN flag there), and a COUNT lane without one costs
// nothing at all.
//
// Fold.  One block of kFFold threads per (member, lane, column): thread
// c folds the c-th run of ceil(T / kFFold) tile partials in tile order,
// a shuffle tree each warp's runs, thread 0 the warps in order, and
// writes the table.  Every float sum has one order, fixed by n and the
// rows' groups: bit-identical from run to run, and HK2b's member b
// bit-identical to a solo launch over member b.  Float min/max compare
// order keys (-0.0 < +0.0; NaN wins), as everywhere.
//
// kSmallSeg, measured (bench/reduce_bench.py, H100 80GB HBM3, 700 W,
// Q1's ten lanes): at 64 segments this regime beats the sort regime at
// 65 from 2^16 rows up, 0.2719 ms against 0.8251 at 2^20 rows and
// 1.5846 against 2.9680 at 2^23; above 64 its slots would outgrow a
// block's shared memory.
#pragma once

#include "run_reduce.cuh"

namespace {

// The few-segment regime's limit (HK2's segment count, HK5's group
// count): per-thread slots of 12 bytes a segment take ns * 3 KB of shared
// memory a block, 196 KB at 64.
constexpr int kSmallSeg = 64;
constexpr int kFThreads = 256;
constexpr int kFPairs = 8;
constexpr int kFRows = 2 * kFPairs;  // rows a thread holds
constexpr int64_t kFTile = (int64_t)kFThreads * kFRows;
constexpr int kFWarps = kFThreads / 32;
constexpr int kFMem = 16;   // members whose valid bits a block keeps at once
constexpr int kFFold = 256;  // threads of a fold block
constexpr uint32_t kNone = 0xFF;
constexpr int kNanBit = 1 << 30;  // in a count slot: a float MIN/MAX saw NaN
constexpr int64_t kPartNan = 1LL << 62;  // the same in a partial's count

// A tile's (or a run of tiles') partial of one (member, lane, segment):
// the value bits and the live count, kPartNan or-ed in for a NaN.
struct FewPart {
  int64_t v;
  int64_t c;
};

__host__ __device__ inline int64_t few_tiles_of(int64_t n) {
  return n > 0 ? (n + kFTile - 1) / kFTile : 0;
}

__host__ __device__ inline int64_t few_part_bytes(int64_t nmem, int64_t n,
                                                  int64_t ns, int nlanes) {
  return nmem * (nlanes + 1) * ns * few_tiles_of(n) *
         (int64_t)sizeof(FewPart);
}

__device__ __forceinline__ int64_t few_row(int64_t base, int t, int i) {
  return base + 2 * ((int64_t)(i >> 1) * kFThreads + t) + (i & 1);
}

__device__ __forceinline__ int few_key(const uint32_t* kw, int i) {
  return (int)((kw[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

__device__ __forceinline__ void few_set_keys(uint32_t* kw, int k, uint32_t k0,
                                             uint32_t k1) {
  const int i = 2 * k;
  kw[i >> 2] |= (k0 | (k1 << 8)) << (8 * (i & 3));
}

// HK2's keys: int64 group ids, outside [0, ns) no group.
struct GidKeys {
  const int64_t* gid;
  int64_t ns;
  __device__ __forceinline__ uint32_t key(int64_t g) const {
    return (g >= 0 && g < ns) ? (uint32_t)g : kNone;
  }
  __device__ __forceinline__ void load(int64_t base, int t, int64_t n,
                                       uint32_t* kw) const {
    const bool vec = ((uintptr_t)gid & 15) == 0;
#pragma unroll
    for (int k = 0; k < kFPairs; ++k) {
      const int64_t r = few_row(base, t, 2 * k);
      uint32_t k0 = kNone, k1 = kNone;
      if (vec && r + 1 < n) {
        const longlong2 p = __ldg((const longlong2*)(gid + r));
        k0 = key(p.x);
        k1 = key(p.y);
      } else {
        if (r < n) k0 = key(gid[r]);
        if (r + 1 < n) k1 = key(gid[r + 1]);
      }
      few_set_keys(kw, k, k0, k1);
    }
  }
};

// HK5's keys: the row -> group map, a byte a row (kNone: no group);
// the map is 16-byte aligned scratch.
struct MapKeys {
  const uint8_t* map;
  __device__ __forceinline__ void load(int64_t base, int t, int64_t n,
                                       uint32_t* kw) const {
#pragma unroll
    for (int k = 0; k < kFPairs; ++k) {
      const int64_t r = few_row(base, t, 2 * k);
      uint32_t k0 = kNone, k1 = kNone;
      if (r + 1 < n) {
        const uint32_t p = *(const uint16_t*)(map + r);
        k0 = p & 0xFFu;
        k1 = p >> 8;
      } else if (r < n) {
        k0 = map[r];
      }
      few_set_keys(kw, k, k0, k1);
    }
  }
};

// bit i: row i of the thread holds a group
__device__ __forceinline__ uint32_t few_keyed(const uint32_t* kw) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < kFRows; ++i)
    bits |= (uint32_t)(few_key(kw, i) != (int)kNone) << i;
  return bits;
}

// raw[k]: the two mask bytes of the thread's pair k (low byte the first
// row); loads issued now, combined later by few_bits
__device__ __forceinline__ void few_mask(const uint8_t* m, int64_t base,
                                         int t, int64_t n, uint32_t* raw) {
  const bool vec = ((uintptr_t)m & 1) == 0;
#pragma unroll
  for (int k = 0; k < kFPairs; ++k) {
    const int64_t r = few_row(base, t, 2 * k);
    if (vec && r + 1 < n) {
      raw[k] = __ldg((const unsigned short*)(m + r));
    } else {
      raw[k] = (r < n ? (uint32_t)m[r] : 0u) |
               (r + 1 < n ? (uint32_t)m[r + 1] << 8 : 0u);
    }
  }
}

// bit i: row i of the thread has a nonzero mask byte
__device__ __forceinline__ uint32_t few_bits(const uint32_t* raw) {
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kFPairs; ++k)
    bits |= ((uint32_t)((raw[k] & 0xFFu) != 0) |
             ((uint32_t)((raw[k] >> 8) != 0) << 1))
            << (2 * k);
  return bits;
}

// v[i] = x[row i] (as int64 bits) for the pairs with a row in `need`
__device__ __forceinline__ void few_vals(const int64_t* x, int64_t base,
                                         int t, int64_t n, uint32_t need,
                                         int64_t* v) {
  const bool vec = ((uintptr_t)x & 15) == 0;
#pragma unroll
  for (int k = 0; k < kFPairs; ++k) {
    if (!((need >> (2 * k)) & 3u)) continue;
    const int64_t r = few_row(base, t, 2 * k);
    if (vec && r + 1 < n) {
      const longlong2 p = __ldg((const longlong2*)(x + r));
      v[2 * k] = p.x;
      v[2 * k + 1] = p.y;
    } else {
      if (r < n) v[2 * k] = x[r];
      if (r + 1 < n) v[2 * k + 1] = x[r + 1];
    }
  }
}

// The live rows of one (lane, member) into the thread's slots.
template <int OP, int KIND, bool CNT>
__device__ __forceinline__ void few_rows(int64_t* __restrict__ sv,
                                         int* __restrict__ sc, int t,
                                         const uint32_t* kw, uint32_t live,
                                         const int64_t* v, int64_t base) {
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    if (!((live >> i) & 1u)) continue;
    const int at = few_key(kw, i) * kFThreads + t;
    if (OP == OP_PRES) {
      const int64_t r = few_row(base, t, i);
      if (r < sv[at]) sv[at] = r;
    } else if (OP == OP_SUM) {
      sv[at] = KIND == KIND_F64
                   ? f64_to_bits(bits_to_f64(sv[at]) + bits_to_f64(v[i]))
                   : wrap_add(sv[at], v[i]);
    } else if (OP == OP_MIN || OP == OP_MAX) {
      int64_t x = v[i];
      bool nan = false;
      if (KIND == KIND_F64) {
        nan = is_nan_f64(bits_to_f64(x));
        x = f64_order_key(bits_to_f64(x));
      }
      if (nan) sc[at] |= kNanBit;
      else if (OP == OP_MIN ? x < sv[at] : x > sv[at]) sv[at] = x;
    }
    if (CNT) sc[at] += 1;
  }
}

// a then b
template <int OP, int KIND>
__device__ __forceinline__ void few_merge(FewPart& a, const FewPart& b) {
  a.c = ((a.c & ~kPartNan) + (b.c & ~kPartNan)) | ((a.c | b.c) & kPartNan);
  if (OP == OP_SUM) {
    a.v = KIND == KIND_F64 ? f64_to_bits(bits_to_f64(a.v) + bits_to_f64(b.v))
                           : wrap_add(a.v, b.v);
  } else if (OP == OP_MIN || OP == OP_PRES) {
    a.v = b.v < a.v ? b.v : a.v;
  } else if (OP == OP_MAX) {
    a.v = b.v > a.v ? b.v : a.v;
  }
}

// few_merge with the lane's kind and op known at run time (the folds
// outside the rows' loop)
__device__ __forceinline__ void few_merge(FewPart& a, const FewPart& b,
                                          int kind, int op) {
  const bool f = kind == KIND_F64;
  switch (op) {
    case OP_SUM:
      if (f) few_merge<OP_SUM, KIND_F64>(a, b);
      else few_merge<OP_SUM, KIND_I64>(a, b);
      break;
    case OP_MIN: case OP_PRES: few_merge<OP_MIN, KIND_I64>(a, b); break;
    case OP_MAX: few_merge<OP_MAX, KIND_I64>(a, b); break;
    default: few_merge<OP_COUNT, KIND_I64>(a, b);
  }
}

__device__ __forceinline__ FewPart few_empty(int op) {
  return FewPart{acc_init(op).v, 0};
}

// The segments a tile's rows hold (any member's, valid or not), in
// ascending order, in shared memory: seg[d] for d < np, dense[g] = d or
// -1 when segment g has no row in the tile, P = np rounded up to a power
// of two (the fold's width).
struct FewSegs {
  int np, P;
  int seg[kSmallSeg];
  int dense[kSmallSeg];
};

// One (lane, member) pass over the tile, in two halves.  few_add resets
// the thread's slots of the tile's segments and adds its live rows;
// few_fold_tile folds the slots of each segment into the tile's partial
// at part[g * T] (the empty partial for a segment the tile lacks).  The
// fold spreads over the block: with C = kFThreads / P, thread t takes
// chunk c = t % C of the tile's d-th segment, d = t / C, the slots of
// threads c, c + C, c + 2C, ... in that order; a shuffle tree over each
// group of G = min(C, 32) lanes folds the chunks (lane c + o into lane
// c, o = G / 2 .. 1), and the segment's C / G groups fold in order.
// Slots keep counts when CNT (and the NaN flag of a float MIN/MAX).
template <int OP, int KIND, bool CNT>
__device__ __forceinline__ void few_add(int64_t* __restrict__ sv,
                                        int* __restrict__ sc,
                                        const FewSegs& sg,
                                        const uint32_t* kw, uint32_t live,
                                        const int64_t* v, int64_t base) {
  constexpr bool kSlotsC =
      CNT || (KIND == KIND_F64 && (OP == OP_MIN || OP == OP_MAX));
  const int t = threadIdx.x;
  const int64_t ident = OP == OP_SUM ? 0 : OP == OP_MAX ? kI64Min : kI64Max;
  for (int d = 0; d < sg.np; ++d) {
    const int g = sg.seg[d];
    sv[g * kFThreads + t] = ident;
    if (kSlotsC) sc[g * kFThreads + t] = 0;
  }
  few_rows<OP, KIND, CNT>(sv, sc, t, kw, live, v, base);
}

__device__ __forceinline__ int few_cnt_merge(int a, int b) {
  return ((a & (kNanBit - 1)) + (b & (kNanBit - 1))) | ((a | b) & kNanBit);
}

template <int OP, int KIND, bool CNT>
__device__ __forceinline__ void few_fold_tile(const int64_t* __restrict__ sv,
                                              const int* __restrict__ sc,
                                              FewPart* __restrict__ sw,
                                              int ns, const FewSegs& sg,
                                              FewPart* __restrict__ part,
                                              int64_t T) {
  constexpr bool kSlotsC =
      CNT || (KIND == KIND_F64 && (OP == OP_MIN || OP == OP_MAX));
  const int t = threadIdx.x;
  const int64_t ident = OP == OP_SUM ? 0 : OP == OP_MAX ? kI64Min : kI64Max;
  __syncthreads();
  const int P = sg.P, C = kFThreads / P, G = C < 32 ? C : 32;
  const int d = t / C, c = t % C;
  FewPart a{ident, 0};
  int cnt = 0;
  if (d < sg.np) {
    const int g = sg.seg[d];
#pragma unroll 4
    for (int i = 0; i < P; ++i) {
      const int at = g * kFThreads + c + C * i;
      few_merge<OP, KIND>(a, FewPart{sv[at], 0});
      if (kSlotsC) cnt = few_cnt_merge(cnt, sc[at]);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    const int64_t x = __shfl_down_sync(0xffffffffu, (long long)a.v, o, G);
    few_merge<OP, KIND>(a, FewPart{x, 0});
    if (kSlotsC) cnt = few_cnt_merge(cnt, __shfl_down_sync(0xffffffffu, cnt, o, G));
  }
  if (c % G == 0)
    sw[t / G] = FewPart{a.v, (cnt & (kNanBit - 1)) |
                                 (cnt & kNanBit ? kPartNan : 0)};
  __syncthreads();
  if (t < ns) {
    FewPart r{ident, 0};
    const int k = sg.dense[t];
    if (k >= 0) {
      const int per = C / G;
      r = sw[k * per];
      for (int q = 1; q < per; ++q) few_merge<OP, KIND>(r, sw[k * per + q]);
    }
    part[t * T] = r;
  }
}

// F(O, K, C) for the lane's op, kind and count flag
#define FEW_SWITCH(op, kind, cnt, F)                                     \
  do {                                                                   \
    const bool f_ = (kind) == KIND_F64, c_ = (cnt);                      \
    switch (op) {                                                        \
      case OP_PRES: F(OP_PRES, KIND_I64, true); break;                   \
      case OP_COUNT: F(OP_COUNT, KIND_I64, true); break;                 \
      case OP_SUM:                                                       \
        if (f_) { if (c_) F(OP_SUM, KIND_F64, true);                     \
                  else F(OP_SUM, KIND_F64, false); }                     \
        else if (c_) F(OP_SUM, KIND_I64, true);                          \
        else F(OP_SUM, KIND_I64, false);                                 \
        break;                                                           \
      case OP_MIN:                                                       \
        if (f_) { if (c_) F(OP_MIN, KIND_F64, true);                     \
                  else F(OP_MIN, KIND_F64, false); }                     \
        else if (c_) F(OP_MIN, KIND_I64, true);                          \
        else F(OP_MIN, KIND_I64, false);                                 \
        break;                                                           \
      default:                                                           \
        if (f_) { if (c_) F(OP_MAX, KIND_F64, true);                     \
                  else F(OP_MAX, KIND_F64, false); }                     \
        else if (c_) F(OP_MAX, KIND_I64, true);                          \
        else F(OP_MAX, KIND_I64, false);                                 \
    }                                                                    \
  } while (0)

// The passes of a member chunk, in order: presence (jj = 0), then lane
// jj - 1 for jj = 1 .. L.n, each for members m = 0 .. nm - 1; a COUNT
// lane without a NULL mask has none.  Advances (jj, m) to the next pass;
// false after the last.
__device__ __forceinline__ bool few_next(const Lanes& L, int nm, int& jj,
                                         int& m) {
  if (++m < nm) return true;
  m = 0;
  while (++jj <= L.n)
    if (L.op[jj - 1] != OP_COUNT || L.nulls[jj - 1] != nullptr) return true;
  return false;
}

// dynamic shared memory of a tile block: value slots, count slots, the
// fold groups' partials (at most max(2 * ns, kFWarps) of them), the valid
// bits of up to kFMem members
inline size_t few_smem_bytes(int ns, int64_t nmem) {
  const int64_t nm = nmem < kFMem ? nmem : kFMem;
  return (size_t)ns * kFThreads * 12 + (size_t)kFWarps * ns * sizeof(FewPart) +
         (size_t)nm * kFThreads * 4;
}

// One tile per block: every member's (lane, member) partials of its rows
// at part[((b * (L.n + 1) + j) * ns + g) * T + tile], j == L.n presence
// (count, first row).  Member b's valid mask at valid + b * vstride, its
// lanes by S.  The loads of each pass are issued as soon as the pass
// before has added its rows, so they fly while that pass folds.
template <class Keys>
__global__ void __launch_bounds__(kFThreads, 2)
few_tiles(Keys keys, const uint8_t* __restrict__ valid, int64_t vstride,
          int64_t nmem, int64_t n, int ns, Lanes L, LaneStrides S,
          FewPart* __restrict__ part) {
  DYN_SMEM(smem);
  int64_t* sv = (int64_t*)smem;               // [ns][kFThreads]
  int* sc = (int*)(sv + ns * kFThreads);      // [ns][kFThreads]
  FewPart* sw = (FewPart*)(sc + ns * kFThreads);  // fold groups' partials
  uint32_t* svb = (uint32_t*)(sw + kFWarps * ns);  // [kFMem][kFThreads]
  const int t = threadIdx.x;
  const int64_t T = few_tiles_of(n);
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kFTile;
  const int nl = L.n + 1;
  __shared__ FewSegs sg;
  __shared__ unsigned long long s_has[kFWarps];
  uint32_t kw[kFRows / 4] = {};
  keys.load(base, t, n, kw);
  const uint32_t keyed = few_keyed(kw);
  {
    unsigned long long has = 0;
#pragma unroll
    for (int i = 0; i < kFRows; ++i)
      if ((keyed >> i) & 1u) has |= 1ULL << few_key(kw, i);
    has = (unsigned long long)__reduce_or_sync(0xffffffffu, (unsigned)has) |
          (unsigned long long)__reduce_or_sync(0xffffffffu,
                                               (unsigned)(has >> 32)) << 32;
    if ((t & 31) == 0) s_has[t >> 5] = has;
    __syncthreads();
    if (t == 0) {
      unsigned long long all = 0;
      for (int w = 0; w < kFWarps; ++w) all |= s_has[w];
      int np = 0;
      for (int g = 0; g < ns; ++g) {
        sg.dense[g] = (all >> g) & 1 ? np : -1;
        if ((all >> g) & 1) sg.seg[np++] = g;
      }
      sg.np = np;
      sg.P = np <= 1 ? 1 : 1 << (32 - __clz(np - 1));
    }
    __syncthreads();
  }
  int64_t v[kFRows] = {};
  uint32_t raw[kFPairs];
  for (int64_t b0 = 0; b0 < nmem; b0 += kFMem) {
    const int nm = (int)(nmem - b0 < kFMem ? nmem - b0 : kFMem);
    uint32_t any = 0;
    for (int m = 0; m < nm; ++m) {
      few_mask(valid + (b0 + m) * vstride, base, t, n, raw);
      const uint32_t vb = few_bits(raw) & keyed;
      svb[m * kFThreads + t] = vb;
      any |= vb;
    }
    uint32_t nb = 0;
    bool fresh = false;  // raw holds the pass's NULL mask, just loaded
    for (int jj = 0, m = 0;;) {
      const int j = jj == 0 ? L.n : jj - 1;
      int kind, op;
      lane_of(L, j, kind, op);
      const bool cnt = jj == 0 || L.nulls[j] != nullptr;
      if (fresh) nb = few_bits(raw);
      else if (jj == 0 || L.nulls[j] == nullptr) nb = 0;
      const uint32_t live = svb[m * kFThreads + t] & ~nb;
#define FEW_ADD(O, K, C) few_add<O, K, C>(sv, sc, sg, kw, live, v, base)
      FEW_SWITCH(op, kind, cnt, FEW_ADD);
#undef FEW_ADD
      // issue the next pass's loads: its values and NULL mask (a lane the
      // members share only for the chunk's first member)
      int jn = jj, mn = m;
      const bool more = few_next(L, nm, jn, mn);
      fresh = false;
      if (more && jn > 0) {
        const int j2 = jn - 1;
        const int64_t b = b0 + mn;
        const bool own_v = S.v[j2] != 0;
        if (L.op[j2] != OP_COUNT && (own_v || mn == 0))
          few_vals((const int64_t*)member_vals(L, S, j2, b), base, t, n,
                   own_v ? svb[mn * kFThreads + t] : any, v);
        if (L.nulls[j2] != nullptr && (S.nl[j2] != 0 || mn == 0)) {
          few_mask(member_nulls(L, S, j2, b), base, t, n, raw);
          fresh = true;
        }
      }
      FewPart* pp = part + ((b0 + m) * nl + j) * ns * T + tile;
#define FEW_FOLD(O, K, C) few_fold_tile<O, K, C>(sv, sc, sw, ns, sg, pp, T)
      FEW_SWITCH(op, kind, cnt, FEW_FOLD);
#undef FEW_FOLD
      if (!more) break;
      jj = jn;
      m = mn;
    }
  }
}

// One block of kFFold threads per (member b, lane j, column g < ld):
// thread c folds the c-th run of ceil(T / kFFold) tile partials of
// segment g < ns in tile order, a shuffle tree folds each warp's runs
// (lane c + o into lane c, o = 16 .. 1), thread 0 folds the warps in
// order and writes the table's rows (presence: count and first row,
// `sentinel` when empty; a lane without a NULL mask takes the presence
// count); columns past ns hold the empty state.  Member b's table at out
// + b * (2 + 2 * L.n) * ld.
__global__ void __launch_bounds__(kFFold)
few_fold(Lanes L, const FewPart* __restrict__ part, int64_t T, int ns,
         int64_t ld, int64_t sentinel, int64_t* __restrict__ out) {
  __shared__ FewPart s[kFFold / 32];
  const int nl = L.n + 1;
  const int64_t id = blockIdx.x;
  const int64_t g = id % ld;
  const int j = (int)(id / ld % nl);
  const int64_t b = id / ld / nl;
  int kind, op;
  lane_of(L, j, kind, op);
  const bool own_c = j == L.n || L.nulls[j] != nullptr;
  const bool own_v = op != OP_COUNT || own_c;  // its partials were written
  const int c = threadIdx.x;
  FewPart a = few_empty(op);
  if (g < ns) {
    const FewPart* p = part + ((b * nl + j) * ns + g) * T;
    const FewPart* pc = part + ((b * nl + L.n) * ns + g) * T;
    const int64_t per = (T + kFFold - 1) / kFFold;
    const int64_t q1 = (c + 1) * per < T ? (c + 1) * per : T;
#pragma unroll 4
    for (int64_t q = c * per; q < q1; ++q) {
      FewPart x = own_v ? p[q] : few_empty(op);
      if (!own_c) x.c = (x.c & kPartNan) | pc[q].c;
      few_merge(a, x, kind, op);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const FewPart x{__shfl_down_sync(0xffffffffu, (long long)a.v, o),
                    __shfl_down_sync(0xffffffffu, (long long)a.c, o)};
    few_merge(a, x, kind, op);
  }
  if ((c & 31) == 0) s[c >> 5] = a;
  __syncthreads();
  if (c != 0) return;
  for (int k = 1; k < kFFold / 32; ++k) few_merge(a, s[k], kind, op);
  const int64_t cnt = a.c & ~kPartNan;
  int64_t* o = out + b * (2 + 2 * (int64_t)L.n) * ld;
  if (j == L.n) {
    o[g] = cnt;
    o[ld + g] = cnt ? a.v : sentinel;
  } else {
    o[(2 + 2 * (int64_t)j) * ld + g] =
        finish_value(kind, op, a.v, cnt, (a.c & kPartNan) != 0);
    o[(3 + 2 * (int64_t)j) * ld + g] = cnt;
  }
}

// Launch the regime for nmem members over rows [0, n) whose groups
// `keys` gives: member b's table of ns segments, row stride ld >= ns,
// at out + b * (2 + 2 * L.n) * ld; part: few_part_bytes(nmem, n, ns,
// L.n) of scratch.
template <class Keys>
int few_reduce(const Keys& keys, const uint8_t* valid, int64_t vstride,
               int64_t nmem, int64_t n, int ns, int64_t ld, const Lanes& L,
               const LaneStrides& S, FewPart* part, int64_t* out,
               int64_t sentinel, cudaStream_t st) {
  const int64_t T = few_tiles_of(n);
  if (T > 0) {
    // the largest block's shared memory, on every launch (the attribute
    // is per device, and the pool's threads launch concurrently); the
    // launch's own size sets the occupancy
    cudaFuncSetAttribute(few_tiles<Keys>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)few_smem_bytes(kSmallSeg, kFMem));
    const size_t smem = few_smem_bytes(ns, nmem);
    LAUNCH(few_tiles<Keys>, (unsigned)T, kFThreads, smem, st, keys, valid,
           vstride, nmem, n, ns, L, S, part);
  }
  LAUNCH(few_fold, (unsigned)(nmem * (L.n + 1) * ld), kFFold, 0, st, L,
         (const FewPart*)part, T, ns, ld, sentinel, out);
  return (int)cudaGetLastError();
}

}  // namespace
