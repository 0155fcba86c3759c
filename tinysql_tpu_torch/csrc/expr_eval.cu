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
// Per row, a thread walks the whole program out of shared memory: every
// thread of a warp runs the same opcode, so the switch never diverges.
// A register is one 8-byte value (int64, or float64 bits) and a NULL bit.
// Rows at or past n_rows are neither read nor kept: mask 0, and each
// program output value 0 with its NULL flag set.
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

struct Row {
  int64_t v[kMaxRegs];
  uint32_t nl;
  __device__ __forceinline__ bool n(int r) const { return (nl >> r) & 1u; }
  __device__ __forceinline__ void set(int r, int64_t x, bool isnull) {
    v[r] = x;
    nl = isnull ? (nl | (1u << r)) : (nl & ~(1u << r));
  }
};

// member b's rows: input lane k at I + b * IS (bytes), output lane k at
// O + b * on (elements)
__device__ __forceinline__ void run_ins(const Ins& in, Row& R, bool& m,
                                        const InLanes& I, const OutLanes& O,
                                        const InStrides& IS, int64_t b,
                                        int64_t on,
                                        const int64_t* __restrict__ pi,
                                        const int64_t* __restrict__ pf,
                                        int64_t i) {
  const int fl = in.flags;
  switch (in.op) {
    case OP_LD: {
      const uint8_t* np = I.nulls[in.a];
      const bool isnull = np ? np[b * IS.nulls[in.a] + i] != 0 : false;
      const char* vp = (const char*)I.vals[in.a] + b * IS.vals[in.a];
      int64_t x = 0;
      if (fl == LANE_W8) x = ((const int64_t*)vp)[i];
      else if (fl == LANE_BOOL) x = ((const uint8_t*)vp)[i] ? 1 : 0;
      R.set(in.dst, x, isnull);
      break;
    }
    case OP_LDC:
      R.set(in.dst, (fl & 1) ? pf[in.p0] : pi[in.p0], (fl & 2) != 0);
      break;
    case OP_ST:
      if (!(fl & 1)) O.vals[in.b][b * on + i] = R.v[in.a];
      O.nulls[in.b][b * on + i] = R.n(in.a) ? 1 : 0;
      break;
    case OP_MASK:
      m = m && truthy(R.v[in.a], fl & 1) && !R.n(in.a);
      break;
    case OP_MOV:
      R.set(in.dst, R.v[in.a], R.n(in.a));
      break;
    case OP_CVT:
      R.set(in.dst, f_bits(to_f(R.v[in.a], fl)), R.n(in.a));
      break;
    case OP_ADD: case OP_SUB: case OP_MUL: case OP_FDIV: case OP_DIV:
    case OP_MOD: {
      const int64_t x = R.v[in.a], y = R.v[in.b];
      bool isnull = R.n(in.a) || R.n(in.b);
      const bool is_f = (fl >> 4) & 1;
      if (is_f) {
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
            R.set(in.dst, cast_trunc(a / sb), isnull);
            break;
          } else {
            const double mm = fmod(fabs(a), fabs(sb));
            r = zero ? 0.0 : (a < 0 ? -mm : mm);
          }
        }
        R.set(in.dst, f_bits(r), isnull);
        break;
      }
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
      R.set(in.dst, r, isnull);
      break;
    }
    case OP_NEG: {
      const int64_t x = R.v[in.a];
      R.set(in.dst, (fl & 1) ? f_bits(-as_f(x)) : wneg(x), R.n(in.a));
      break;
    }
    case OP_ABS: {
      const int64_t x = R.v[in.a];
      R.set(in.dst, (fl & 1) ? f_bits(fabs(as_f(x))) : wabs(x), R.n(in.a));
      break;
    }
    case OP_CMP: {
      const int64_t x = R.v[in.a], y = R.v[in.b];
      const bool na = R.n(in.a), nb = R.n(in.b);
      const int mode = (fl >> 4) & 3;
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
      if (in.c == 6) R.set(in.dst, (na || nb) ? (na && nb) : r, false);
      else R.set(in.dst, r ? 1 : 0, na || nb);
      break;
    }
    case OP_AND: case OP_OR: case OP_XOR: {
      const bool a = truthy(R.v[in.a], fl & 1),
                 b = truthy(R.v[in.b], (fl >> 1) & 1);
      const bool na = R.n(in.a), nb = R.n(in.b);
      if (in.op == OP_AND) {
        const bool fa = !a && !na, fb = !b && !nb;
        R.set(in.dst, (a && b && !(na || nb)) ? 1 : 0,
              (na || nb) && !(fa || fb));
      } else if (in.op == OP_OR) {
        const bool v = (a && !na) || (b && !nb);
        R.set(in.dst, v ? 1 : 0, (na || nb) && !v);
      } else {
        R.set(in.dst, a != b ? 1 : 0, na || nb);
      }
      break;
    }
    case OP_NOT:
      R.set(in.dst, truthy(R.v[in.a], fl & 1) ? 0 : 1, R.n(in.a));
      break;
    case OP_ISNULL:
      R.set(in.dst, R.n(in.a) ? 1 : 0, false);
      break;
    case OP_ISTRUE: case OP_ISFALSE: {
      const bool a = truthy(R.v[in.a], fl & 1);
      const bool want = in.op == OP_ISTRUE;
      R.set(in.dst, (!R.n(in.a) && a == want) ? 1 : 0, false);
      break;
    }
    case OP_IF: {
      const bool take = truthy(R.v[in.a], fl & 1) && !R.n(in.a);
      const int src = take ? in.b : in.c;
      const int cv = take ? (fl >> 2) & 3 : (fl >> 4) & 3;
      const int64_t x = R.v[src];
      R.set(in.dst, cv ? f_bits(to_f(x, cv)) : x, R.n(src));
      break;
    }
    case OP_IFNULL: {
      const bool na = R.n(in.a);
      const int src = na ? in.b : in.a;
      const int cv = na ? (fl >> 4) & 3 : (fl >> 2) & 3;
      const int64_t x = R.v[src];
      R.set(in.dst, cv ? f_bits(to_f(x, cv)) : x, na && R.n(in.b));
      break;
    }
    case OP_CASE_INIT:
      R.set(in.dst, 0, true);
      R.set(in.c, 0, false);
      break;
    case OP_CASE_ARM: {
      const bool take = truthy(R.v[in.a], fl & 1) && !R.n(in.a) &&
                        R.v[in.c] == 0;
      if (take) {
        const int cv = (fl >> 2) & 3;
        const int64_t x = R.v[in.b];
        R.set(in.dst, cv ? f_bits(to_f(x, cv)) : x, R.n(in.b));
        R.set(in.c, 1, false);
      }
      break;
    }
    case OP_CASE_ELSE:
      if (R.v[in.c] == 0) {
        const int cv = (fl >> 2) & 3;
        const int64_t x = R.v[in.a];
        R.set(in.dst, cv ? f_bits(to_f(x, cv)) : x, R.n(in.a));
      }
      break;
    case OP_IN_INIT:
      R.set(in.dst, 0, false);  // value: hit, NULL bit: a NULL item seen
      break;
    case OP_IN_ITEM: {
      const int64_t x = R.v[in.a], y = R.v[in.b];
      const int mode = fl & 3;
      bool eq;
      if (mode == 1) {
        eq = to_f(x, (fl >> 2) & 3) == to_f(y, (fl >> 4) & 3);
      } else if (mode == 2) {
        bool lt;
        int_lt_eq(x, (fl >> 6) & 1, y, (fl >> 7) & 1, &lt, &eq);
      } else {
        eq = x == y;
      }
      const bool hit = R.v[in.dst] != 0 || (eq && !R.n(in.b) && !R.n(in.a));
      R.set(in.dst, hit ? 1 : 0, R.n(in.dst) || R.n(in.b));
      break;
    }
    case OP_IN_END: {
      const bool hit = R.v[in.dst] != 0;
      R.set(in.dst, hit ? 1 : 0, !hit && (R.n(in.dst) || R.n(in.a)));
      break;
    }
    case OP_CAST_INT:
      R.set(in.dst, cast_int(as_f(R.v[in.a])), R.n(in.a));
      break;
    case OP_CODECMP: {
      // [lo, hi) = pi[p0], pi[p1]; the NULL code = pi[b]
      const int64_t code = R.v[in.a];
      const int64_t lo = pi[in.p0], hi = pi[in.p1], card = pi[in.b];
      const bool live = code != card && !R.n(in.a);
      bool r;
      switch (in.c) {
        case 0: r = code >= lo && code < hi; break;
        case 1: r = code < lo || code >= hi; break;
        case 2: r = code < lo; break;
        case 3: r = code < hi; break;
        case 4: r = code >= hi; break;
        default: r = code >= lo; break;
      }
      R.set(in.dst, (r && live) ? 1 : 0, false);
      break;
    }
    case OP_KEYDEC: {
      // stride = pi[p0], card = pi[p1], base = pi[c]
      const int64_t card = pi[in.p1];
      const int64_t code =
          floor_mod(floor_div(R.v[in.a], pi[in.p0]), wadd(card, 1));
      const bool isnull = code == card || R.v[in.b] == 0;
      R.set(in.dst, isnull ? 0 : wadd(code, pi[in.c]), isnull);
      break;
    }
    case OP_AVG: {
      const int64_t s = R.v[in.a], c = R.v[in.b];
      const double sd = (fl & 1) ? as_f(s) : (double)s;
      const double den = (double)(c < 1 ? 1 : c);
      R.set(in.dst, f_bits(sd / den), R.n(in.a) || c == 0);
      break;
    }
    default:
      break;
  }
}

// member b = blockIdx.y: parameters pi + b * ni, pf + b * nf, incoming
// mask at b * mstride (0: shared), outputs and the mask at b * n
__global__ void ee_run(const Ins* __restrict__ prog, int n_ins, InLanes I,
                       OutLanes O, InStrides IS,
                       const int64_t* __restrict__ pi_all, int64_t ni,
                       const int64_t* __restrict__ pf_all, int64_t nf,
                       const uint8_t* __restrict__ mask_in_all,
                       int64_t mstride, uint8_t* __restrict__ mask_out_all,
                       int64_t n_rows, int64_t n) {
  __shared__ Ins sp[kMaxProg];
  for (int k = threadIdx.x; k < n_ins; k += blockDim.x) sp[k] = prog[k];
  __syncthreads();
  const int64_t b = blockIdx.y;
  const int64_t* __restrict__ pi = pi_all + b * ni;
  const int64_t* __restrict__ pf = pf_all + b * nf;
  const uint8_t* __restrict__ mask_in =
      mask_in_all ? mask_in_all + b * mstride : nullptr;
  uint8_t* __restrict__ mask_out =
      mask_out_all ? mask_out_all + b * n : nullptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (i >= n_rows) {
      for (int j = 0; j < O.n; ++j) {
        if (!O.guard[j]) continue;
        if (O.vals[j]) O.vals[j][b * n + i] = 0;
        O.nulls[j][b * n + i] = 1;
      }
      if (mask_out) mask_out[i] = 0;
      continue;
    }
    Row R;
    R.nl = 0;
    bool m = mask_in ? mask_in[i] != 0 : true;
    for (int k = 0; k < n_ins; ++k)
      run_ins(sp[k], R, m, I, O, IS, b, n, pi, pf, i);
    if (mask_out) mask_out[i] = m ? 1 : 0;
  }
}

}  // namespace

namespace {

int launch_hk7(const Ins* prog, int n_ins, const InLanes* in,
               const InStrides* is, const OutLanes* out, const int64_t* pi,
               int64_t ni, const int64_t* pf_bits, int64_t nf,
               const uint8_t* mask_in, int64_t mstride, uint8_t* mask_out,
               int64_t nmem, int64_t n_rows, int64_t n, cudaStream_t st) {
  if (n_ins < 0 || n_ins > kMaxProg || in->n < 0 || in->n > kMaxIn ||
      out->n < 0 || out->n > kMaxOut || n < 0 || nmem < 1 || nmem > 65535)
    return -1;
  if (n > 0) {
    dim3 g(grid_for(n, kThreads, 1 << 16), (unsigned)nmem);
    LAUNCH(ee_run, g, kThreads, 0, st, prog, n_ins, *in, *out, *is, pi, ni,
           pf_bits, nf, mask_in, mstride, mask_out, n_rows, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

TS_API int hk7_expr_eval(const Ins* prog, int n_ins, const InLanes* in,
                         const OutLanes* out, const int64_t* pi,
                         const int64_t* pf_bits, const uint8_t* mask_in,
                         uint8_t* mask_out, int64_t n_rows, int64_t n,
                         cudaStream_t st) {
  InStrides none = {};
  return launch_hk7(prog, n_ins, in, &none, out, pi, 0, pf_bits, 0, mask_in,
                    0, mask_out, 1, n_rows, n, st);
}

// HK7b: nmem members.  pi int64[nmem * ni], pf_bits int64[nmem * nf]
// (member b's row at b * ni, b * nf); `is` the per-member byte strides of
// the input lanes; every output lane and mask_out hold nmem * n entries
// (member b at b * n); mask_in member b at b * mstride.
TS_API int hk7b_expr_eval(const Ins* prog, int n_ins, const InLanes* in,
                          const InStrides* is, const OutLanes* out,
                          const int64_t* pi, int64_t ni,
                          const int64_t* pf_bits, int64_t nf,
                          const uint8_t* mask_in, int64_t mstride,
                          uint8_t* mask_out, int64_t nmem, int64_t n_rows,
                          int64_t n, cudaStream_t st) {
  return launch_hk7(prog, n_ins, in, is, out, pi, ni, pf_bits, nf, mask_in,
                    mstride, mask_out, nmem, n_rows, n, st);
}
