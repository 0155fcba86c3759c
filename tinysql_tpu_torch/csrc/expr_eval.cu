// HK7 expr_eval: an interpreter for compiled expression programs.
//
// Replaces the XLA programs the JAX package jit-compiled per expression
// shape: tinysql_tpu/ops/exprjit.py:123-420 (K13, compile_expr_params /
// _apply: filter and argument expression trees with MySQL three-valued
// NULL logic), tinysql_tpu/executor/tpu_executors.py:277-400 (K14, string
// compares on dictionary codes), :1425-1452 (K15, the HashAgg device
// output layout), :2215-2330 (K16, projection / selection programs) and
// the expressions of tinysql_tpu/executor/devpipe.py:2071,2112 (K22,
// _SelNode / _ProjNode).
//
// ops/exprjit.py lowers a list of conditions (AND-ed into the mask) and
// output expressions into one linear register program; constants are
// slots of the int64 / float64 parameter arrays, so one program serves
// every query of a shape.  Each instruction is eight int32 words
// {op, dst, a, b, c, flags, p0, p1}.  A longer program than kMaxProg
// instructions or kMaxRegs live registers is cut by the compiler into
// several launches that pass their live registers through global lanes.
//
// Design (a tile-walking interpreter).  A block takes tiles of
// R * 256 rows (R = kRows = 4), thread t the R
// contiguous rows t * R .. t * R + R - 1, and walks the program once per
// tile: each instruction is read out of shared memory and decoded once,
// then applied to the thread's R rows in an unrolled loop, so the decode
// is spread over R rows and an LD has R independent loads in flight.  An
// 8-byte lane loads and stores as 16-byte vectors, a bool or NULL lane
// as one R-byte word, where the lane is aligned and all R rows are live
// (else row by row).  The VM registers live in dynamic shared memory,
// laid out [register][row of the tile] with a warp's 32 threads on 32
// consecutive 8-byte words (no bank conflict), sized by the program's
// own register count (the wrapper passes it): a register index known
// only at run time costs a shared-memory address.  Each row's NULL bits
// (one 32-bit word) and its mask stay in hardware registers.  The lane
// tables are __grid_constant__ parameters, copied into shared memory
// (with the member's offsets applied) once per block.  Every thread of a
// warp runs the same opcode, so the switch never diverges.
// A register is one 8-byte value (int64, or float64 bits) and a NULL bit.
// Rows at or past n_rows are neither read nor kept: mask 0, and each
// program output value 0 with its NULL flag set.
//
// What held the old design back (one row a thread, the program decoded
// for every row, the registers a per-thread array indexed at run time),
// from bench/expr_bench.py --ptxas on the H100: its kernel kept the
// register array in a 136-byte stack frame (63 LDL and 63 STL in its
// SASS; 44 registers, no spills) and took 0.389 ms of device time at
// Q6's shape.  This design has no stack frame and no local memory (62
// registers) and takes 0.196 ms there, against 0.082 ms for the bytes:
// what is left is the walk's serial latency (each LD's consumer comes
// next) at four blocks an SM, and the shared-memory traffic of the
// register file.  Tried and slower there: 2 or 8 rows a thread; the
// registers of programs of at most 2 or 4 registers in hardware
// registers (selected by compares: 78 registers a thread, three blocks
// an SM); an L1 prefetch of a tile's lanes; a persistent grid.
//
// Bound: bytes.  Each input lane is read once per row (repeated reads of
// one lane hit L1), each output written once; a handful of integer and
// float operations per byte.
//
// Exactness against the plain torch version (kernels.expr_eval_plain,
// which runs ops/exprjit.py's _apply instruction by instruction):
// - built with -fmad=false, so a*b+c rounds twice, as torch does;
// - int64 + - * and negation wrap through uint64_t (no signed-overflow
//   UB), as torch's do; abs(INT64_MIN) stays INT64_MIN;
// - signed DIV / MOD reproduce _int_div_j: floor(|a| / |b|) with torch's
//   wrapping abs and its floor division, then the sign fix;
// - unsigned int64 -> float64 is double(v) + 2^64 for a negative word:
//   two roundings, as _to_real_u.
//
// HK7b, the batched entry point (K12, tinysql_tpu/ops/kernels.py:1197-1266
// stacked_variant): B members of a stacked round run ONE program over the
// shared input lanes, each with its own row of the int64 / float64
// parameter arrays, in one launch per program segment; the member is the
// grid's second axis.  Member b writes its mask and outputs at b * n of
// [B, n] lanes, and a lane passed between segments (a temporary, the mask
// of the segment before) has a per-member stride.  Each member's rows run
// the solo interpreter: bit-identical to a solo launch with its
// parameters.  Bound: bytes, the shared lanes read once and B masks and
// output lanes written once; the simple version reads the shared lanes
// once per member.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxProg = 64;
constexpr int kMaxRegs = 16;

enum Op {
  OP_LD, OP_LDC, OP_ST, OP_MASK, OP_MOV, OP_CVT,
  OP_ADD, OP_SUB, OP_MUL, OP_FDIV, OP_DIV, OP_MOD,
  OP_NEG, OP_ABS, OP_CMP, OP_AND, OP_OR, OP_XOR, OP_NOT, OP_ISNULL,
  OP_ISTRUE, OP_ISFALSE, OP_IF, OP_IFNULL, OP_CASE_INIT, OP_CASE_ARM,
  OP_CASE_ELSE, OP_IN_INIT, OP_IN_ITEM, OP_IN_END, OP_CAST_INT,
  OP_CODECMP, OP_KEYDEC, OP_AVG
};
enum Conv { CV_NONE = 0, CV_S2F = 1, CV_U2F = 2 };
enum LaneKind { LANE_W8 = 0, LANE_BOOL = 2, LANE_NULL = 3 };

}  // namespace

struct Ins {
  int op, dst, a, b, c, flags, p0, p1;
};

constexpr int kMaxIn = 32;
constexpr int kMaxOut = 32;

// Lanes of one launch, passed by value.  A value pointer is 8-byte values
// (int64 or float64 bits) or bytes (a bool lane), as the LD instruction
// says; a null pointer of a NULL mask means no NULLs.
struct InLanes {
  const void* vals[kMaxIn];
  const uint8_t* nulls[kMaxIn];
  int n;
};
struct OutLanes {
  int64_t* vals[kMaxOut];   // null for a NULL-mask-only output
  uint8_t* nulls[kMaxOut];
  int guard[kMaxOut];       // 1: a program output (written past n_rows)
  int n;
};
// Bytes between two members' values and NULL masks of each input lane
// (0: the lane is shared by every member), for the batched entry point.
struct InStrides {
  int64_t vals[kMaxIn];
  int64_t nulls[kMaxIn];
};

namespace {

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((unsigned long long)a * (unsigned long long)b);
}
__device__ __forceinline__ int64_t wneg(int64_t a) {
  return (int64_t)(0ULL - (unsigned long long)a);
}
__device__ __forceinline__ int64_t wabs(int64_t a) {
  return a < 0 ? wneg(a) : a;
}
// torch's integer floor division (b != 0; never INT64_MIN / -1 here,
// and wrapping if it were)
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  if (b == -1) return wneg(a);
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
// torch.remainder on int64: the sign of the divisor
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  if (b == -1) return 0;
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ double as_f(int64_t bits) {
  return __longlong_as_double(bits);
}
__device__ __forceinline__ int64_t f_bits(double d) {
  return __double_as_longlong(d);
}

// an int64 register as float64 under a conversion (a float register when
// cv is CV_NONE)
__device__ __forceinline__ double to_f(int64_t v, int cv) {
  if (cv == CV_NONE) return as_f(v);
  double r = (double)v;
  if (cv == CV_U2F && v < 0) r = r + 18446744073709551616.0;
  return r;
}

__device__ __forceinline__ bool truthy(int64_t v, bool is_f) {
  return is_f ? (as_f(v) != 0.0) : (v != 0);
}

// _cast_int: half away from zero, saturating, NaN -> 0
__device__ __forceinline__ int64_t cast_int(double v) {
  double r = v >= 0 ? floor(v + 0.5) : -floor(-v + 0.5);
  const bool hi = r >= 9223372036854775808.0;
  const bool lo = r <= -9223372036854775808.0;
  if (hi) return kI64Max;
  if (lo) return kI64Min;
  if (r != r) return 0;
  return (int64_t)r;
}
// _cast_trunc: toward zero, saturating, NaN -> 0
__device__ __forceinline__ int64_t cast_trunc(double x) {
  double t = trunc(x);
  const bool hi = t >= 9223372036854775808.0;
  const bool lo = t < -9223372036854775808.0;
  if (hi) return kI64Max;
  if (lo) return kI64Min;
  if (t != t) return 0;
  return (int64_t)t;
}

// _int_lt_eq_j: (lt, eq) under per-side unsignedness
__device__ __forceinline__ void int_lt_eq(int64_t a, bool ua, int64_t b,
                                          bool ub, bool* lt, bool* eq) {
  if (ua == ub) {
    if (ua) {
      a = (int64_t)((unsigned long long)a ^ kSign);
      b = (int64_t)((unsigned long long)b ^ kSign);
    }
    *lt = a < b;
    *eq = a == b;
    return;
  }
  const bool ok = a >= 0 && b >= 0;
  if (ua) {
    *lt = ok && a < b;
  } else {
    *lt = a < 0 || b < 0 || a < b;
  }
  *eq = ok && a == b;
}

template <class T>
__device__ __forceinline__ bool cmp_code(int code, T a, T b) {
  switch (code) {
    case 0: case 6: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

// The lanes of one member (blockIdx.y), copied into shared memory once
// per block: input lane j at iv[j] / inl[j], output lane j at ov[j] /
// onl[j], its member's offsets applied.
struct BlockLanes {
  const char* iv[kMaxIn];
  const uint8_t* inl[kMaxIn];
  int64_t* ov[kMaxOut];
  uint8_t* onl[kMaxOut];
  int guard[kMaxOut];
  int nout;
};

// R bytes at p (aligned to R) as one word, byte k for row k
template <int R>
__device__ __forceinline__ unsigned long long ld_bytes(const uint8_t* p) {
  if constexpr (R == 8) return *(const unsigned long long*)p;
  else if constexpr (R == 4) return *(const unsigned*)p;
  else return *(const unsigned short*)p;
}
template <int R>
__device__ __forceinline__ void st_bytes(uint8_t* p, unsigned long long w) {
  if constexpr (R == 8) *(unsigned long long*)p = w;
  else if constexpr (R == 4) *(unsigned*)p = (unsigned)w;
  else *(unsigned short*)p = (unsigned short)w;
}
__device__ __forceinline__ bool aligned(const void* p, int a) {
  return ((unsigned long long)p & (unsigned long long)(a - 1)) == 0;
}
__device__ __forceinline__ bool byte_of(unsigned long long w, int k) {
  return ((w >> (8 * k)) & 0xffu) != 0;
}

#define EACH_ROW _Pragma("unroll") for (int k = 0; k < R; ++k)

// One thread's R rows of a tile: rows row0 .. row0 + R - 1, the first
// `live` of them below n_rows.  Register g of row k is the 8-byte word
// v[(g * R + k) * kThreads] of the block's shared register file (a warp's
// 32 threads on 32 consecutive words: no bank conflict), so a register
// index known only at run time costs one shared-memory address; its NULL
// bit is bit g of nl[k], and m[k] is the row's mask, both in hardware
// registers (k is a compile-time index under the unrolled row loops).
template <int R>
struct Tile {
  int64_t* v;
  uint32_t nl[R];
  bool m[R];
  int64_t row0;
  int live;
  __device__ __forceinline__ int64_t r(int g, int k) const {
    return v[(g * R + k) * kThreads];
  }
  __device__ __forceinline__ bool n(int g, int k) const {
    return (nl[k] >> g) & 1u;
  }
  __device__ __forceinline__ void set(int g, int k, int64_t x, bool isnull) {
    v[(g * R + k) * kThreads] = x;
    nl[k] = isnull ? (nl[k] | (1u << g)) : (nl[k] & ~(1u << g));
  }
};

// One instruction, decoded once, over the thread's R rows.  The per-row
// arithmetic is the solo interpreter's, row by row.
template <int R>
__device__ __forceinline__ void run_ins(const Ins& in, Tile<R>& T,
                                        const BlockLanes& L,
                                        const int64_t* __restrict__ pi,
                                        const int64_t* __restrict__ pf) {
  const int fl = in.flags;
  const bool full = T.live == R;
  switch (in.op) {
    case OP_LD: {
      const uint8_t* np = L.inl[in.a];
      unsigned long long nw = 0;  // NULL bytes of the R rows
      if (np) {
        np += T.row0;
        if (full && aligned(np, R)) nw = ld_bytes<R>(np);
        else EACH_ROW if (k < T.live) nw |= (unsigned long long)np[k] << (8 * k);
      }
      if (fl == LANE_W8) {
        const int64_t* p = (const int64_t*)L.iv[in.a] + T.row0;
        if (full && aligned(p, 16)) {
#pragma unroll
          for (int h = 0; h < R / 2; ++h) {
            const longlong2 x = ((const longlong2*)p)[h];
            T.set(in.dst, 2 * h, x.x, byte_of(nw, 2 * h));
            T.set(in.dst, 2 * h + 1, x.y, byte_of(nw, 2 * h + 1));
          }
        } else {
          EACH_ROW if (k < T.live) T.set(in.dst, k, p[k], byte_of(nw, k));
        }
      } else if (fl == LANE_BOOL) {
        const uint8_t* p = (const uint8_t*)L.iv[in.a] + T.row0;
        unsigned long long bw = 0;
        if (full && aligned(p, R)) bw = ld_bytes<R>(p);
        else EACH_ROW if (k < T.live) bw |= (unsigned long long)p[k] << (8 * k);
        EACH_ROW T.set(in.dst, k, byte_of(bw, k) ? 1 : 0, byte_of(nw, k));
      } else {
        EACH_ROW T.set(in.dst, k, 0, byte_of(nw, k));
      }
      break;
    }
    case OP_LDC: {
      const int64_t x = (fl & 1) ? pf[in.p0] : pi[in.p0];
      EACH_ROW T.set(in.dst, k, x, (fl & 2) != 0);
      break;
    }
    case OP_ST: {
      if (!(fl & 1)) {
        int64_t* p = L.ov[in.b] + T.row0;
        if (full && aligned(p, 16)) {
#pragma unroll
          for (int h = 0; h < R / 2; ++h) {
            longlong2 x;
            x.x = T.r(in.a, 2 * h);
            x.y = T.r(in.a, 2 * h + 1);
            ((longlong2*)p)[h] = x;
          }
        } else {
          EACH_ROW if (k < T.live) p[k] = T.r(in.a, k);
        }
      }
      uint8_t* q = L.onl[in.b] + T.row0;
      if (full && aligned(q, R)) {
        unsigned long long w = 0;
        EACH_ROW w |= (unsigned long long)T.n(in.a, k) << (8 * k);
        st_bytes<R>(q, w);
      } else {
        EACH_ROW if (k < T.live) q[k] = T.n(in.a, k) ? 1 : 0;
      }
      break;
    }
    case OP_MASK:
      EACH_ROW T.m[k] = T.m[k] && truthy(T.r(in.a, k), fl & 1) &&
                        !T.n(in.a, k);
      break;
    case OP_MOV:
      EACH_ROW T.set(in.dst, k, T.r(in.a, k), T.n(in.a, k));
      break;
    case OP_CVT:
      EACH_ROW T.set(in.dst, k, f_bits(to_f(T.r(in.a, k), fl)),
                     T.n(in.a, k));
      break;
    case OP_ADD: case OP_SUB: case OP_MUL: case OP_FDIV: case OP_DIV:
    case OP_MOD: {
      const bool is_f = (fl >> 4) & 1;
      if (is_f) {
        EACH_ROW {
          const int64_t x = T.r(in.a, k), y = T.r(in.b, k);
          bool isnull = T.n(in.a, k) || T.n(in.b, k);
          const double a = to_f(x, fl & 3), b = to_f(y, (fl >> 2) & 3);
          double r;
          if (in.op == OP_ADD) r = a + b;
          else if (in.op == OP_SUB) r = a - b;
          else if (in.op == OP_MUL) r = a * b;
          else {
            const bool zero = b == 0.0;
            const double sb = zero ? 1.0 : b;
            isnull = isnull || zero;
            if (in.op == OP_FDIV) {
              r = a / sb;
            } else if (in.op == OP_DIV) {
              T.set(in.dst, k, cast_trunc(a / sb), isnull);
              continue;
            } else {
              const double mm = fmod(fabs(a), fabs(sb));
              r = zero ? 0.0 : (a < 0 ? -mm : mm);
            }
          }
          T.set(in.dst, k, f_bits(r), isnull);
        }
        break;
      }
      EACH_ROW {
        const int64_t x = T.r(in.a, k), y = T.r(in.b, k);
        bool isnull = T.n(in.a, k) || T.n(in.b, k);
        int64_t r;
        if (in.op == OP_ADD) r = wadd(x, y);
        else if (in.op == OP_SUB) r = wsub(x, y);
        else if (in.op == OP_MUL) r = wmul(x, y);
        else {
          const bool zero = y == 0;
          const int64_t sb = zero ? 1 : y;
          isnull = isnull || zero;
          int64_t q, rem;
          if ((fl >> 5) & 1) {  // both unsigned
            const unsigned long long ua = (unsigned long long)x,
                                     ub = (unsigned long long)sb;
            q = (int64_t)(ua / ub);
            rem = (int64_t)(ua % ub);
          } else {
            q = floor_div(wabs(x), wabs(sb));
            if ((x < 0) != (sb < 0)) q = wneg(q);
            rem = wsub(x, wmul(sb, q));
          }
          r = in.op == OP_DIV ? q : rem;
        }
        T.set(in.dst, k, r, isnull);
      }
      break;
    }
    case OP_NEG:
      EACH_ROW {
        const int64_t x = T.r(in.a, k);
        T.set(in.dst, k, (fl & 1) ? f_bits(-as_f(x)) : wneg(x), T.n(in.a, k));
      }
      break;
    case OP_ABS:
      EACH_ROW {
        const int64_t x = T.r(in.a, k);
        T.set(in.dst, k, (fl & 1) ? f_bits(fabs(as_f(x))) : wabs(x),
              T.n(in.a, k));
      }
      break;
    case OP_CMP: {
      const int mode = (fl >> 4) & 3;
      EACH_ROW {
        const int64_t x = T.r(in.a, k), y = T.r(in.b, k);
        const bool na = T.n(in.a, k), nb = T.n(in.b, k);
        bool r;
        if (mode == 1) {
          r = cmp_code<double>(in.c, to_f(x, fl & 3), to_f(y, (fl >> 2) & 3));
        } else if (mode == 2) {
          bool lt, eq;
          int_lt_eq(x, (fl >> 6) & 1, y, (fl >> 7) & 1, &lt, &eq);
          switch (in.c) {
            case 0: case 6: r = eq; break;
            case 1: r = !eq; break;
            case 2: r = lt; break;
            case 3: r = lt || eq; break;
            case 4: r = !(lt || eq); break;
            default: r = !lt; break;
          }
        } else {
          r = cmp_code<int64_t>(in.c, x, y);
        }
        if (in.c == 6) T.set(in.dst, k, (na || nb) ? (na && nb) : r, false);
        else T.set(in.dst, k, r ? 1 : 0, na || nb);
      }
      break;
    }
    case OP_AND: case OP_OR: case OP_XOR:
      EACH_ROW {
        const bool a = truthy(T.r(in.a, k), fl & 1),
                   b = truthy(T.r(in.b, k), (fl >> 1) & 1);
        const bool na = T.n(in.a, k), nb = T.n(in.b, k);
        if (in.op == OP_AND) {
          const bool fa = !a && !na, fb = !b && !nb;
          T.set(in.dst, k, (a && b && !(na || nb)) ? 1 : 0,
                (na || nb) && !(fa || fb));
        } else if (in.op == OP_OR) {
          const bool v = (a && !na) || (b && !nb);
          T.set(in.dst, k, v ? 1 : 0, (na || nb) && !v);
        } else {
          T.set(in.dst, k, a != b ? 1 : 0, na || nb);
        }
      }
      break;
    case OP_NOT:
      EACH_ROW T.set(in.dst, k, truthy(T.r(in.a, k), fl & 1) ? 0 : 1,
                     T.n(in.a, k));
      break;
    case OP_ISNULL:
      EACH_ROW T.set(in.dst, k, T.n(in.a, k) ? 1 : 0, false);
      break;
    case OP_ISTRUE: case OP_ISFALSE: {
      const bool want = in.op == OP_ISTRUE;
      EACH_ROW {
        const bool a = truthy(T.r(in.a, k), fl & 1);
        T.set(in.dst, k, (!T.n(in.a, k) && a == want) ? 1 : 0, false);
      }
      break;
    }
    case OP_IF:
      EACH_ROW {
        const bool take = truthy(T.r(in.a, k), fl & 1) && !T.n(in.a, k);
        const int src = take ? in.b : in.c;
        const int cv = take ? (fl >> 2) & 3 : (fl >> 4) & 3;
        const int64_t x = T.r(src, k);
        T.set(in.dst, k, cv ? f_bits(to_f(x, cv)) : x, T.n(src, k));
      }
      break;
    case OP_IFNULL:
      EACH_ROW {
        const bool na = T.n(in.a, k);
        const int src = na ? in.b : in.a;
        const int cv = na ? (fl >> 4) & 3 : (fl >> 2) & 3;
        const int64_t x = T.r(src, k);
        T.set(in.dst, k, cv ? f_bits(to_f(x, cv)) : x, na && T.n(in.b, k));
      }
      break;
    case OP_CASE_INIT:
      EACH_ROW {
        T.set(in.dst, k, 0, true);
        T.set(in.c, k, 0, false);
      }
      break;
    case OP_CASE_ARM: {
      const int cv = (fl >> 2) & 3;
      EACH_ROW {
        const bool take = truthy(T.r(in.a, k), fl & 1) && !T.n(in.a, k) &&
                          T.r(in.c, k) == 0;
        if (take) {
          const int64_t x = T.r(in.b, k);
          T.set(in.dst, k, cv ? f_bits(to_f(x, cv)) : x, T.n(in.b, k));
          T.set(in.c, k, 1, false);
        }
      }
      break;
    }
    case OP_CASE_ELSE: {
      const int cv = (fl >> 2) & 3;
      EACH_ROW {
        if (T.r(in.c, k) == 0) {
          const int64_t x = T.r(in.a, k);
          T.set(in.dst, k, cv ? f_bits(to_f(x, cv)) : x, T.n(in.a, k));
        }
      }
      break;
    }
    case OP_IN_INIT:
      // value: hit, NULL bit: a NULL item seen
      EACH_ROW T.set(in.dst, k, 0, false);
      break;
    case OP_IN_ITEM: {
      const int mode = fl & 3;
      EACH_ROW {
        const int64_t x = T.r(in.a, k), y = T.r(in.b, k);
        bool eq;
        if (mode == 1) {
          eq = to_f(x, (fl >> 2) & 3) == to_f(y, (fl >> 4) & 3);
        } else if (mode == 2) {
          bool lt;
          int_lt_eq(x, (fl >> 6) & 1, y, (fl >> 7) & 1, &lt, &eq);
        } else {
          eq = x == y;
        }
        const bool hit = T.r(in.dst, k) != 0 ||
                         (eq && !T.n(in.b, k) && !T.n(in.a, k));
        T.set(in.dst, k, hit ? 1 : 0, T.n(in.dst, k) || T.n(in.b, k));
      }
      break;
    }
    case OP_IN_END:
      EACH_ROW {
        const bool hit = T.r(in.dst, k) != 0;
        T.set(in.dst, k, hit ? 1 : 0,
              !hit && (T.n(in.dst, k) || T.n(in.a, k)));
      }
      break;
    case OP_CAST_INT:
      EACH_ROW T.set(in.dst, k, cast_int(as_f(T.r(in.a, k))), T.n(in.a, k));
      break;
    case OP_CODECMP: {
      // [lo, hi) = pi[p0], pi[p1]; the NULL code = pi[b]
      const int64_t lo = pi[in.p0], hi = pi[in.p1], card = pi[in.b];
      EACH_ROW {
        const int64_t code = T.r(in.a, k);
        const bool live = code != card && !T.n(in.a, k);
        bool r;
        switch (in.c) {
          case 0: r = code >= lo && code < hi; break;
          case 1: r = code < lo || code >= hi; break;
          case 2: r = code < lo; break;
          case 3: r = code < hi; break;
          case 4: r = code >= hi; break;
          default: r = code >= lo; break;
        }
        T.set(in.dst, k, (r && live) ? 1 : 0, false);
      }
      break;
    }
    case OP_KEYDEC: {
      // stride = pi[p0], card = pi[p1], base = pi[c]
      const int64_t stride = pi[in.p0], card = pi[in.p1], base = pi[in.c];
      EACH_ROW {
        const int64_t code =
            floor_mod(floor_div(T.r(in.a, k), stride), wadd(card, 1));
        const bool isnull = code == card || T.r(in.b, k) == 0;
        T.set(in.dst, k, isnull ? 0 : wadd(code, base), isnull);
      }
      break;
    }
    case OP_AVG:
      EACH_ROW {
        const int64_t s = T.r(in.a, k), c = T.r(in.b, k);
        const double sd = (fl & 1) ? as_f(s) : (double)s;
        const double den = (double)(c < 1 ? 1 : c);
        T.set(in.dst, k, f_bits(sd / den), T.n(in.a, k) || c == 0);
      }
      break;
    default:
      break;
  }
}

// member b = blockIdx.y: parameters pi + b * ni, pf + b * nf, incoming
// mask at b * mstride (0: shared), outputs and the mask at b * n.  Block
// tiles of R * kThreads rows, thread t of a tile owning rows t * R ..
// t * R + R - 1; dynamic shared memory holds n_regs registers of every
// row of the tile.
template <int R>
__global__ void __launch_bounds__(kThreads)
    ee_tile(const Ins* __restrict__ prog, int n_ins,
            const __grid_constant__ InLanes I,
            const __grid_constant__ OutLanes O,
            const __grid_constant__ InStrides IS,
            const int64_t* __restrict__ pi_all, int64_t ni,
            const int64_t* __restrict__ pf_all, int64_t nf,
            const uint8_t* __restrict__ mask_in_all, int64_t mstride,
            uint8_t* __restrict__ mask_out_all, int64_t n_rows, int64_t n) {
  __shared__ Ins sp[kMaxProg];
  __shared__ BlockLanes L;
  DYN_SMEM(smem);
  const int tx = threadIdx.x;
  const int64_t b = blockIdx.y;
  for (int k = tx; k < n_ins; k += kThreads) sp[k] = prog[k];
  if (tx < I.n) {
    L.iv[tx] = I.vals[tx] ? (const char*)I.vals[tx] + b * IS.vals[tx]
                          : nullptr;
    L.inl[tx] = I.nulls[tx] ? I.nulls[tx] + b * IS.nulls[tx] : nullptr;
  }
  if (tx < O.n) {
    L.ov[tx] = O.vals[tx] ? O.vals[tx] + b * n : nullptr;
    L.onl[tx] = O.nulls[tx] + b * n;
    L.guard[tx] = O.guard[tx];
  }
  if (tx == 0) L.nout = O.n;
  __syncthreads();
  const int64_t* __restrict__ pi = pi_all + b * ni;
  const int64_t* __restrict__ pf = pf_all + b * nf;
  const uint8_t* __restrict__ mask_in =
      mask_in_all ? mask_in_all + b * mstride : nullptr;
  uint8_t* __restrict__ mask_out =
      mask_out_all ? mask_out_all + b * n : nullptr;
  Tile<R> T;
  T.v = (int64_t*)smem + tx;
  const int64_t tile = (int64_t)R * kThreads;
  for (int64_t t0 = (int64_t)blockIdx.x * tile; t0 < n;
       t0 += (int64_t)gridDim.x * tile) {
    T.row0 = t0 + (int64_t)tx * R;
    const int64_t left = n - T.row0, live = n_rows - T.row0;
    const int nin = left <= 0 ? 0 : (left < R ? (int)left : R);
    T.live = live <= 0 ? 0 : (live < nin ? (int)live : nin);
    if (nin == 0) continue;
    if (T.live > 0) {
      unsigned long long mw = 0;
      if (mask_in) {
        const uint8_t* p = mask_in + T.row0;
        if (T.live == R && aligned(p, R)) mw = ld_bytes<R>(p);
        else EACH_ROW if (k < T.live) mw |= (unsigned long long)p[k] << (8 * k);
      }
      EACH_ROW {
        T.nl[k] = 0;
        T.m[k] = mask_in ? byte_of(mw, k) : true;
      }
      for (int j = 0; j < n_ins; ++j) run_ins(sp[j], T, L, pi, pf);
    }
    // rows at or past n_rows: mask 0, each program output 0 and NULL
    if (mask_out) {
      unsigned long long w = 0;
      EACH_ROW if (k < T.live && T.m[k]) w |= 1ull << (8 * k);
      uint8_t* p = mask_out + T.row0;
      if (nin == R && aligned(p, R)) st_bytes<R>(p, w);
      else EACH_ROW if (k < nin) p[k] = byte_of(w, k) ? 1 : 0;
    }
    if (T.live < nin) {
      const bool whole = T.live == 0 && nin == R;
      for (int j = 0; j < L.nout; ++j) {
        if (!L.guard[j]) continue;
        int64_t* vp = L.ov[j] ? L.ov[j] + T.row0 : nullptr;
        uint8_t* np = L.onl[j] + T.row0;
        if (vp && whole && aligned(vp, 16)) {
#pragma unroll
          for (int h = 0; h < R / 2; ++h) {
            longlong2 z;
            z.x = 0;
            z.y = 0;
            ((longlong2*)vp)[h] = z;
          }
        } else if (vp) {
          EACH_ROW if (k >= T.live && k < nin) vp[k] = 0;
        }
        if (whole && aligned(np, R)) st_bytes<R>(np, 0x0101010101010101ull);
        else EACH_ROW if (k >= T.live && k < nin) np[k] = 1;
      }
    }
  }
}

#undef EACH_ROW

}  // namespace

namespace {

constexpr int kRows = 4;  // rows a thread (2 and 8 measured slower)
// the register file of a program of kMaxRegs registers
constexpr int kMaxSmem = kMaxRegs * kRows * kThreads * (int)sizeof(int64_t);

int launch_hk7(const Ins* prog, int n_ins, int n_regs, const InLanes* in,
               const InStrides* is, const OutLanes* out, const int64_t* pi,
               int64_t ni, const int64_t* pf_bits, int64_t nf,
               const uint8_t* mask_in, int64_t mstride, uint8_t* mask_out,
               int64_t nmem, int64_t n_rows, int64_t n, cudaStream_t st) {
  if (n_ins < 0 || n_ins > kMaxProg || n_regs < 0 || n_regs > kMaxRegs ||
      in->n < 0 || in->n > kMaxIn || out->n < 0 || out->n > kMaxOut ||
      n < 0 || nmem < 1 || nmem > 65535)
    return -1;
  if (n > 0) {
    // allow the largest register file on every launch (the attribute is
    // per device; no state is kept between callers' threads); the size
    // passed at launch sets the occupancy
    cudaFuncSetAttribute(ee_tile<kRows>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    const size_t smem = (size_t)n_regs * kRows * kThreads * sizeof(int64_t);
    const int64_t tiles = (n + (int64_t)kRows * kThreads - 1) /
                          ((int64_t)kRows * kThreads);
    dim3 g((unsigned)(tiles < (1 << 16) ? tiles : (1 << 16)), (unsigned)nmem);
    LAUNCH(ee_tile<kRows>, g, kThreads, smem, st, prog, n_ins, *in, *out,
           *is, pi, ni, pf_bits, nf, mask_in, mstride, mask_out, n_rows, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// n_regs: the registers the program uses (1 + its highest register
// index; at most kMaxRegs), which size the block's shared register file.
TS_API int hk7_expr_eval(const Ins* prog, int n_ins, int n_regs,
                         const InLanes* in, const OutLanes* out,
                         const int64_t* pi, const int64_t* pf_bits,
                         const uint8_t* mask_in, uint8_t* mask_out,
                         int64_t n_rows, int64_t n, cudaStream_t st) {
  InStrides none = {};
  return launch_hk7(prog, n_ins, n_regs, in, &none, out, pi, 0, pf_bits, 0,
                    mask_in, 0, mask_out, 1, n_rows, n, st);
}

// HK7b: nmem members.  pi int64[nmem * ni], pf_bits int64[nmem * nf]
// (member b's row at b * ni, b * nf); `is` the per-member byte strides of
// the input lanes; every output lane and mask_out hold nmem * n entries
// (member b at b * n); mask_in member b at b * mstride.
TS_API int hk7b_expr_eval(const Ins* prog, int n_ins, int n_regs,
                          const InLanes* in, const InStrides* is,
                          const OutLanes* out, const int64_t* pi, int64_t ni,
                          const int64_t* pf_bits, int64_t nf,
                          const uint8_t* mask_in, int64_t mstride,
                          uint8_t* mask_out, int64_t nmem, int64_t n_rows,
                          int64_t n, cudaStream_t st) {
  return launch_hk7(prog, n_ins, n_regs, in, is, out, pi, ni, pf_bits, nf,
                    mask_in, mstride, mask_out, nmem, n_rows, n, st);
}
