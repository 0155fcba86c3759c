// Expansion of per-row output counts into consecutive output slots, for
// HK3's multiplicity mode (HK8 csr_expand fills its bucket by tiles of
// slots instead: csr_expand.cu): an inclusive scan of the
// counts (common.cuh's three-launch scan), then one thread per output slot
// finds the row that owns it by a binary search over the inclusive ends.
// Every slot costs O(log n) whatever the skew, so one probe row with a
// million matches spreads over the card like a million rows with one; the
// output is probe-major by construction and integer-only, hence
// deterministic.
#pragma once

#include "common.cuh"

namespace {

// C: a functor struct with __device__ `int64_t operator()(int64_t i)`, the
// output count of row i.  incl[i] = counts of rows 0..i.
template <class C>
struct InclusiveEnds {
  C c;
  int64_t* incl;
  __device__ int64_t count(int64_t i) const { return c(i); }
  __device__ void write(int64_t i, int64_t excl, int64_t v) const {
    incl[i] = excl + v;
  }
};

// The row whose slots hold output slot j: the first i with incl[i] > j
// (n when j is past the total).
__device__ __forceinline__ int64_t owner_of(const int64_t* __restrict__ incl,
                                            int64_t n, int64_t j) {
  int64_t a = 0, b = n;
  while (a < b) {
    const int64_t m = a + ((b - a) >> 1);
    if (incl[m] <= j) a = m + 1;
    else b = m;
  }
  return a;
}

}  // namespace
