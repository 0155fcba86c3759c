// The dense key table shared by HK3 equi_join, HK6 dense_probe and HK8
// csr_expand: one table format, one in-range probe, one composite lane.
//
// Table format: int32 entries indexed by key - lo over [lo, hi], -1 where
// no row (or group) has the key.  HK6's and HK8's tables come from the
// host (a unique column's key -> row table, a group index's key -> group
// table), HK3 builds its own on the card by an unsigned atomicMin, under
// which -1 is the largest value, so the lowest row of a key wins.
//
// Keys: a probe key is one int64 lane (n == 1), or the composite lane of
// several (the reference's _composite_spec, devpipe.py:2037):
//   comp = sum((k_j - lo_j) * stride_j)
// taken only when every k_j lies in [lo_j, hi_j] and is not NULL, so no
// offset wraps.  key - lo is likewise taken only for keys inside [lo, hi]
// (R4: nothing relies on a wrap at the ends of int64).
#pragma once

#include <cstring>

#include "common.cuh"

constexpr int kMaxKeys = 8;

// The key lanes of a probe, passed by value.  For n == 1 lo / hi /
// stride are unused: the key is the lane itself.
struct KeySet {
  const int64_t* vals[kMaxKeys];
  const uint8_t* nulls[kMaxKeys];  // null = the lane has no NULLs
  int64_t lo[kMaxKeys];
  int64_t hi[kMaxKeys];
  int64_t stride[kMaxKeys];
  int n;
};

// Lanes to gather, passed by value; width is the element size in bytes
// (1, 2, 4 or 8).  side 0 reads at the probe row, side 1 at the build row,
// whose NULL flag is or-ed with "unmatched" (HK6 gathers build lanes
// only, HK8 both sides).
struct GatherLanes {
  const void* vals[kMaxLanes];
  const uint8_t* nulls[kMaxLanes];  // null = the lane has no NULLs
  void* out_vals[kMaxLanes];
  uint8_t* out_nulls[kMaxLanes];
  int width[kMaxLanes];
  int side[kMaxLanes];
  int n;
};

namespace {

__device__ __forceinline__ void copy_elem(void* dst, const void* src,
                                          int64_t i, int64_t p, int w) {
  if (w == 8) ((int64_t*)dst)[i] = ((const int64_t*)src)[p];
  else if (w == 4) ((int32_t*)dst)[i] = ((const int32_t*)src)[p];
  else if (w == 2) ((int16_t*)dst)[i] = ((const int16_t*)src)[p];
  else ((uint8_t*)dst)[i] = ((const uint8_t*)src)[p];
}

// Output slot j of every lane: probe row p or build row b (side), the
// build side NULL where the slot is unmatched (miss).
__device__ __forceinline__ void gather_lanes(const GatherLanes& G, int64_t j,
                                             int64_t p, int64_t b,
                                             bool miss) {
  for (int l = 0; l < G.n; ++l) {
    const int64_t r = G.side[l] ? b : p;
    copy_elem(G.out_vals[l], G.vals[l], j, r, G.width[l]);
    const bool nl = G.nulls[l] ? G.nulls[l][r] != 0 : false;
    G.out_nulls[l][j] = (nl || (G.side[l] && miss)) ? 1 : 0;
  }
}

// A gather's lane count and widths are ones the kernels take.
inline bool gather_ok(const GatherLanes* G) {
  if (G->n < 0 || G->n > kMaxLanes) return false;
  for (int l = 0; l < G->n; ++l) {
    const int w = G->width[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return false;
  }
  return true;
}

// The probe key of row i: the lane's value (n == 1) or the composite lane
// (n > 1).  False when a part is NULL or (composite) outside its range.
__device__ __forceinline__ bool probe_key(const KeySet& K, int64_t i,
                                          int64_t* key) {
  if (K.n == 1) {
    if (K.nulls[0] && K.nulls[0][i]) return false;
    *key = K.vals[0][i];
    return true;
  }
  unsigned long long comp = 0;
  for (int j = 0; j < K.n; ++j) {
    if (K.nulls[j] && K.nulls[j][i]) return false;
    const int64_t k = K.vals[j][i];
    if (k < K.lo[j] || k > K.hi[j]) return false;
    comp += ((unsigned long long)k - (unsigned long long)K.lo[j]) *
            (unsigned long long)K.stride[j];
  }
  *key = (int64_t)comp;
  return true;
}

// The table entry of a key inside [lo, hi] (offset clamped to the table,
// as the reference's clip), else -1.
__device__ __forceinline__ int64_t table_lookup(
    const int32_t* __restrict__ tbl, int64_t len, int64_t lo, int64_t hi,
    int64_t key) {
  if (key < lo || key > hi || len <= 0) return -1;
  unsigned long long off = (unsigned long long)key - (unsigned long long)lo;
  if (off > (unsigned long long)(len - 1)) off = (unsigned long long)(len - 1);
  return tbl[off];
}

// HK3's build: the lowest live row of each key (keys inside [lo, lo + len)).
__device__ __forceinline__ void table_insert_min(int32_t* tbl, int64_t lo,
                                                 int64_t key, int64_t row) {
  const unsigned long long off =
      (unsigned long long)key - (unsigned long long)lo;
  atomicMin((unsigned int*)&tbl[off], (unsigned int)row);
}

// ---- a launch's lanes in shared memory (HK6, HK8) ---------------------

template <int W> struct Elem;
template <> struct Elem<1> { using T = unsigned char; };
template <> struct Elem<2> { using T = unsigned short; };
template <> struct Elem<4> { using T = unsigned int; };
template <> struct Elem<8> { using T = unsigned long long; };

// The lanes of a launch, as a block keeps them in shared memory.
struct BlockLanes {
  const void* vals[kMaxLanes];
  const uint8_t* nulls[kMaxLanes];
  void* out_vals[kMaxLanes];
  uint8_t* out_nulls[kMaxLanes];
  int width[kMaxLanes];
  int side[kMaxLanes];
};

__device__ __forceinline__ void load_lanes(BlockLanes& L,
                                           const GatherLanes& G) {
  const int l = threadIdx.x;
  if (l < G.n) {
    L.vals[l] = G.vals[l];
    L.nulls[l] = G.nulls[l];
    L.out_vals[l] = G.out_vals[l];
    L.out_nulls[l] = G.out_nulls[l];
    L.width[l] = G.width[l];
    L.side[l] = G.side[l];
  }
  __syncthreads();
}

// ---- a thread's R consecutive rows at once (HK6) ----------------------
//
// Rows [i0, i0 + nr) of a lane, nr <= R.  A full group whose address is
// aligned to its size (16 bytes at most) moves in 16-, 8- or 4-byte
// words; a short group (the last of a lane) or an unaligned view moves
// element by element.  R * sizeof(T) is 4, 8 or a multiple of 16.

template <int R, class T>
__device__ __forceinline__ bool rows_vec(const T* p, int nr) {
  constexpr int B = R * (int)sizeof(T);
  constexpr int A = B < 16 ? B : 16;
  static_assert(B == 4 || B == 8 || B % 16 == 0, "a group is whole words");
  return nr == R && (reinterpret_cast<uintptr_t>(p) % A) == 0;
}

template <int R, class T>
__device__ __forceinline__ void get_rows(const T* __restrict__ src,
                                         int64_t i0, int nr, T (&v)[R]) {
  const T* p = src + i0;
  constexpr int B = R * (int)sizeof(T);
  if (rows_vec<R>(p, nr)) {
    if constexpr (B >= 16) {
#pragma unroll
      for (int q = 0; q < B / 16; ++q) {
        const uint4 w = reinterpret_cast<const uint4*>(p)[q];
        memcpy(reinterpret_cast<char*>(v) + 16 * q, &w, 16);
      }
    } else if constexpr (B == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      memcpy(v, &w, 8);
    } else {
      const unsigned w = *reinterpret_cast<const unsigned*>(p);
      memcpy(v, &w, 4);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = r < nr ? p[r] : T(0);
}

template <int R, class T>
__device__ __forceinline__ void put_rows(T* __restrict__ dst, int64_t i0,
                                         int nr, const T (&v)[R]) {
  T* p = dst + i0;
  constexpr int B = R * (int)sizeof(T);
  if (rows_vec<R>(p, nr)) {
    if constexpr (B >= 16) {
#pragma unroll
      for (int q = 0; q < B / 16; ++q) {
        uint4 w;
        memcpy(&w, reinterpret_cast<const char*>(v) + 16 * q, 16);
        reinterpret_cast<uint4*>(p)[q] = w;
      }
    } else if constexpr (B == 8) {
      uint2 w;
      memcpy(&w, v, 8);
      *reinterpret_cast<uint2*>(p) = w;
    } else {
      unsigned w;
      memcpy(&w, v, 4);
      *reinterpret_cast<unsigned*>(p) = w;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < nr) p[r] = v[r];
}

// The probe keys of rows [i0, i0 + nr): probe_key's contract for each
// row, every lane's loads issued for all R rows together.  The key lanes
// are read through K's fields at indices known at compile time (the
// composite loop is unrolled over kMaxKeys), so K stays in the parameter
// space.
template <int R>
__device__ __forceinline__ void probe_rows(const KeySet& K, int64_t i0,
                                           int nr, int64_t (&key)[R],
                                           bool (&ok)[R]) {
  uint8_t kn[R];
  if (K.n == 1) {
    get_rows<R>(K.vals[0], i0, nr, key);
    if (K.nulls[0]) get_rows<R>(K.nulls[0], i0, nr, kn);
#pragma unroll
    for (int r = 0; r < R; ++r) ok[r] = r < nr && !(K.nulls[0] && kn[r]);
    return;
  }
  unsigned long long comp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    comp[r] = 0;
    ok[r] = r < nr;
  }
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    if (j >= K.n) break;
    int64_t k[R];
    get_rows<R>(K.vals[j], i0, nr, k);
    if (K.nulls[j]) get_rows<R>(K.nulls[j], i0, nr, kn);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool part = !(K.nulls[j] && kn[r]) && k[r] >= K.lo[j] &&
                        k[r] <= K.hi[j];
      ok[r] = ok[r] && part;
      comp[r] += ((unsigned long long)k[r] - (unsigned long long)K.lo[j]) *
                 (unsigned long long)K.stride[j];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) key[r] = (int64_t)comp[r];
}

}  // namespace
