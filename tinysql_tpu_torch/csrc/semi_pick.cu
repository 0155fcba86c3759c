// HK10 semi_pick: the semi / anti / NOT IN keep ladder over a membership
// flag per probe row, and the compaction of the kept probe rows.
//
// Replaces tinysql_tpu/ops/kernels.py:1987 _semi_kernel(anti, null_aware)
// (the build side's shape scalars, the three-valued NOT IN ladder and the
// keep count) and :2030 _semi_pick_kernel (nonzero of the keep mask into
// an index list).  Membership itself is HK3's unique probe
// (equi_join.cu, hk3_unique_match): its `match` flag arrives here.
//
// Pass 1 (build side): a block reduction over the build rows gives
// n_build, the count of valid build rows NULL keys included, and the
// count of valid build rows whose key IS NULL (has_null = count > 0):
// the reference's traced scalars.  They stay on the card; pass 2 reads
// them, so no scalar crosses to the host between the passes.
//
// Pass 2 (probe side), per probe row i:
//   semi                         keep = match & valid & !null
//   anti, n_build == 0           keep = valid     (NOT IN () is TRUE, so
//                                                  NULL probe keys stay)
//   null-aware anti, has_null    keep = false     (x NOT IN (.., NULL)
//                                                  is never TRUE)
//   null-aware anti otherwise    keep = valid & !null & !match
//   plain anti (NOT EXISTS)      keep = valid & !match
// then common.cuh's three-launch exclusive scan over the keep flags writes
// the kept probe rows in ascending order: out[0] = the keep count,
// out[1 + j] = the j-th kept row; entries past the count are not written.
//
// Bound: bytes.  Pass 1 reads two bytes per build row, pass 2 three bytes
// per probe row (twice: the scan's count pass and its apply pass each
// recompute the flag rather than store it) and writes 8 bytes per kept
// row.  Integer counts only, so the result is the same bytes on every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStatBlocks = 512;

// per block: [valid build rows, valid build rows with a NULL key]
__global__ void sp_build_partial(const uint8_t* __restrict__ rn,
                                 const uint8_t* __restrict__ rv, int64_t n,
                                 int64_t* __restrict__ part) {
  __shared__ int64_t s_cnt[kThreads], s_nul[kThreads];
  const int t = threadIdx.x;
  int64_t cnt = 0, nul = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + t; i < n; i += stride) {
    if (!rv[i]) continue;
    ++cnt;
    if (rn[i]) ++nul;
  }
  s_cnt[t] = cnt;
  s_nul[t] = nul;
  __syncthreads();
  for (int st = blockDim.x >> 1; st > 0; st >>= 1) {
    if (t < st) {
      s_cnt[t] += s_cnt[t + st];
      s_nul[t] += s_nul[t + st];
    }
    __syncthreads();
  }
  if (t == 0) {
    part[2 * blockIdx.x] = s_cnt[0];
    part[2 * blockIdx.x + 1] = s_nul[0];
  }
}

// one block of kThreads: stats = [n_build, NULL-key build rows]
__global__ void sp_build_merge(const int64_t* __restrict__ part, int nblk,
                               int64_t* __restrict__ stats) {
  __shared__ int64_t s_cnt[kThreads], s_nul[kThreads];
  const int t = threadIdx.x;
  int64_t cnt = 0, nul = 0;
  for (int b = t; b < nblk; b += blockDim.x) {
    cnt += part[2 * b];
    nul += part[2 * b + 1];
  }
  s_cnt[t] = cnt;
  s_nul[t] = nul;
  __syncthreads();
  for (int st = blockDim.x >> 1; st > 0; st >>= 1) {
    if (t < st) {
      s_cnt[t] += s_cnt[t + st];
      s_nul[t] += s_nul[t + st];
    }
    __syncthreads();
  }
  if (t == 0) {
    stats[0] = s_cnt[0];
    stats[1] = s_nul[0];
  }
}

// the ladder as a scan functor (common.cuh): count = the keep flag,
// write = the kept row's index at its exclusive prefix
struct SemiKeep {
  const uint8_t* match;
  const uint8_t* ln;
  const uint8_t* lv;
  const int64_t* stats;
  int anti;
  int null_aware;
  int64_t* out;
  __device__ int64_t count(int64_t i) const {
    const bool valid = lv[i] != 0;
    const bool member = match[i] != 0;
    const bool null_key = ln[i] != 0;
    bool keep;
    if (!anti) {
      keep = member && valid && !null_key;
    } else if (stats[0] == 0) {
      keep = valid;
    } else if (null_aware) {
      keep = stats[1] == 0 && valid && !null_key && !member;
    } else {
      keep = valid && !member;
    }
    return keep ? 1 : 0;
  }
  __device__ void write(int64_t i, int64_t excl, int64_t v) const {
    if (v) out[1 + excl] = i;
  }
};

}  // namespace

// match, ln, lv: uint8[n_l]; rn, rv: uint8[n_r]; part: int64[2 * 512];
// stats: int64[2]; btot: int64[ceil(n_l / 1024)]; out: int64[1 + n_l].
TS_API int hk10_semi_pick(const uint8_t* match, const uint8_t* ln,
                          const uint8_t* lv, int64_t n_l, const uint8_t* rn,
                          const uint8_t* rv, int64_t n_r, int anti,
                          int null_aware, int64_t* part, int64_t* stats,
                          int64_t* btot, int64_t* out, cudaStream_t st) {
  const int nblk = (int)grid_for(n_r, kThreads, kStatBlocks);
  LAUNCH(sp_build_partial, nblk, kThreads, 0, st, rn, rv, n_r, part);
  LAUNCH(sp_build_merge, 1, kThreads, 0, st, (const int64_t*)part, nblk,
         stats);
  launch_scan(SemiKeep{match, ln, lv, (const int64_t*)stats, anti,
                       null_aware, out},
              n_l, btot, out, st);
  return (int)cudaGetLastError();
}
