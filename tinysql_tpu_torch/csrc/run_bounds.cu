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
// lanes at each valid one; the leaders are written per group, the padded
// ends per position and the count once.  Design: common.cuh's
// three-launch scan of the leader flags (integers, fixed order) writes
// every output from each position's own flags and its prefix, then one
// launch pads past the count.
#include "common.cuh"

constexpr int kMaxRunKeys = 8;

struct RunKeys {
  const int64_t* vals[kMaxRunKeys];  // float64 lanes as their bits
  const uint8_t* nulls[kMaxRunKeys];  // null = the lane has no NULLs
  int is_f64[kMaxRunKeys];
  int n;
};

namespace {

struct RunScan {
  const int64_t* perm;
  const uint8_t* valid;
  RunKeys K;
  int64_t n;
  int64_t* lead;
  int64_t* ends;
  int64_t* gid;

  __device__ bool same(int64_t a, int64_t b) const {
    for (int j = 0; j < K.n; ++j) {
      const bool na = K.nulls[j] ? K.nulls[j][a] != 0 : false;
      const bool nb = K.nulls[j] ? K.nulls[j][b] != 0 : false;
      if (na != nb) return false;
      if (na) continue;
      const int64_t x = K.vals[j][a], y = K.vals[j][b];
      if (K.is_f64[j]) {
        if (bits_to_f64(x) != bits_to_f64(y)) return false;
      } else if (x != y) {
        return false;
      }
    }
    return true;
  }
  __device__ bool is_lead(int64_t q) const {
    const int64_t r = perm[q];
    if (!valid[r]) return false;
    if (q == 0) return true;
    const int64_t r0 = perm[q - 1];
    return !valid[r0] || !same(r0, r);
  }
  __device__ int64_t count(int64_t q) const { return is_lead(q) ? 1 : 0; }
  __device__ void write(int64_t q, int64_t excl, int64_t v) const {
    if (v) lead[excl] = q;
    const int64_t r = perm[q];
    const bool vq = valid[r] != 0;
    if (gid) gid[r] = vq ? excl + v - 1 : n;
    if (!vq) return;
    bool end = q == n - 1;
    if (!end) {
      const int64_t r1 = perm[q + 1];
      end = !valid[r1] || !same(r, r1);
    }
    if (end) ends[excl + v - 1] = q;
  }
};

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

// btot: int64[ceil(n / 1024)]; gid may be null.
TS_API int hk9_run_bounds(const int64_t* perm, int64_t n, const uint8_t* valid,
                          const RunKeys* keys, int64_t* btot, int64_t* count,
                          int64_t* lead, int64_t* ends, int64_t* gid,
                          cudaStream_t st) {
  if (n < 1 || keys->n < 0 || keys->n > kMaxRunKeys) return -1;
  launch_scan(RunScan{perm, valid, *keys, n, lead, ends, gid}, n, btot, count,
              st);
  LAUNCH(rb_pad, grid_for(n, 256, 1 << 16), 256, 0, st,
         (const int64_t*)count, n, lead, ends);
  return (int)cudaGetLastError();
}
