// §IV/§V (jobs × sites) cost plane for Hopper (sm_90a), three entries.
//
// Replaces the TPU kernel src/repro/kernels/cost_matrix/cost_matrix.py
// (cost_matrix_pallas, _kernel) and carries the float64 plane that the
// placement decisions of src/repro/core/batch.py are made from.
//
//   repro_cost_matrix_f32  Pallas order, float32:
//       net = (loss/bw)·1e6, eff = loss>0 ? min(bw, mss/(rtt·√max(loss,1e-12))) : bw
//       comp = (wq·queue + ww·work)/cap + wl·load + jw/cap
//       cost = net + wc·comp + wd·dtc, dead columns 3e38
//   repro_cost_matrix_f64  batch.py's class_total order, float64, equal to
//       NumPy bit for bit: comp_site = (wq·q)/cap + (ww·w)/cap + wl·load,
//       comp = comp_site + work/cap, DATA dtc+net, COMPUTE comp+net,
//       BOTH (net+comp)+dtc, dead columns +inf when mask_dead.
//   repro_cost_argmin_f64  the same f64 arithmetic, reduced per job row to
//       (first index of the minimum, its cost) without writing the plane;
//       a NaN counts as the minimum, as np.argmin and torch.argmin do.
//
// Exactness: built with -fmad=false so no a*b+c is contracted into an FMA;
// IEEE division and sqrt are correctly rounded in both types, as NumPy's
// and PyTorch's are;
// min propagates NaN like np.minimum (not fmin).
//
// Bound on an H100. Both planes are bound by the bytes they write (the
// f32 plane 409.6 MB at 100k × 1024, 0.122 ms at 3.35 TB/s; the f64 plane
// twice that). Each entry launches a pre-pass that computes every site's
// terms once into the wrapper's scratch, so no block recomputes a square
// root or a division per site, and a persistent grid whose threads hold
// their columns' terms in registers across the rows they write and store
// 16-byte vectors, 512 contiguous bytes a warp, with no barrier on the
// row path. A cell's quotients are exact divisions without a divide: a
// multiplication by the site's correctly rounded reciprocal and two FMA
// corrections (div_rn_f32, div_rn), exact by Markstein's theorem inside a
// window of the operands; cells outside it take IEEE division.
//   * f32 plane (site_terms_f32_kernel, cost_matrix_f32_kernel): four
//     adjacent columns a thread, one float4 a row; a warp loads the job
//     columns of 32 consecutive rows in one coalesced load and hands
//     each row out by shuffles. Out-of-window cells branch to IEEE
//     division in the same kernel (see cost_matrix_f32_kernel).
//   * f64 plane (site_terms_f64_kernel, cost_matrix_f64_kernel): double2
//     pairs; out-of-window cells are rewritten by a fix-up kernel.
//   * the fused argmin writes 16 bytes a row and is bound by the FP64 pipe:
//     a correctly rounded division is some eight FP64 instructions, two a
//     BOTH cell. An estimate with multiplications by the sites' reciprocals
//     screens each cell, and only cells within a guard of the row's best
//     take the exact divisions, under a gate that makes the screen's error
//     bound sound (cost_argmin_f64_kernel).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kTermsThreads = 256;       // the site pre-passes
constexpr int kPlaneThreads = 256;       // both planes

enum JobClass : int8_t { kCompute = 0, kData = 1, kBoth = 2 };

template <typename T>
__device__ __forceinline__ T np_minimum(T a, T b) {
  // np.minimum: NaN in either operand gives NaN.
  return (a <= b || a != a) ? a : b;
}

// ---- float32, Pallas order -------------------------------------------------

// Per-site terms of the f32 plane, written once a launch by
// site_terms_f32_kernel into the wrapper's scratch: kF32Fields arrays of S
// floats. kFlags32 holds int bits: kAlive (alive > 0.5) and kFastCol (dead,
// or eff and cap both inside div32_window).
enum F32Field { kNet32, kEff32, kComp32, kCap32, kYEff32, kYCap32, kFlags32, kF32Fields };
constexpr int kAlive = 1, kFastCol = 2;

// The window of div_rn_f32: x is a normal float with biased exponent in
// [kDiv32ExpLo, kDiv32ExpHi], i.e. |x| in [2^-62, 2^63) (not 0, subnormal,
// inf or NaN). With a and b in it:
//   * 1/b lies in (2^-63, 2^62], so y = RN(1/b) is a normal number;
//   * a/b lies in (2^-125, 2^125), so every q is normal and finite, as is
//     r·y (about 2^-23·q) inside the FMA;
//   * the remainder a - b·q of a faithful q is a multiple of
//     2^(e_b + e_q - 46) ≥ 2^(e_a - 47) ≥ 2^-109 below 2^24 such units in
//     size, so the FMA computes it exactly, above the subnormal range.
// These are the hypotheses of Markstein's theorem (no under- or overflow,
// y within half an ulp of 1/b, q faithful). Outside the window, a cell
// takes IEEE division: zero or subnormal bytes or work, eff 0 (mss 0),
// cap at FLT_MIN (its reciprocal overflows), inf and NaN.
constexpr unsigned kDiv32ExpLo = 65, kDiv32ExpHi = 189;

__device__ __forceinline__ bool div32_window(float x) {
  const unsigned e = (__float_as_uint(x) >> 23) & 0xffu;
  return e - kDiv32ExpLo <= kDiv32ExpHi - kDiv32ExpLo;
}

// a / b correctly rounded, for a and b in div32_window, from y = RN(1/b):
// q0 = RN(a·y) is within 1.5 ulp of a/b; one FMA correction makes it
// faithful, and the second is the exact rounding of a/b by Markstein's
// theorem. Explicit __fmaf_rn and __fmul_rn, so -fmad=false does not
// touch them and nothing else is contracted.
__device__ __forceinline__ float div_rn_f32(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  float r = __fmaf_rn(-b, q, a);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-b, q, a);
  return __fmaf_rn(r, y, q);
}

// The Pallas body's site half, in its order (IEEE sqrtf and divisions),
// and the reciprocals of eff and cap. A column outside S is never read.
__global__ void __launch_bounds__(kTermsThreads) site_terms_f32_kernel(
    const float* __restrict__ rows,  // (9, S): cap queue work load bw loss rtt alive mss
    int64_t S, float wq, float ww, float wl, float* __restrict__ terms) {
  const int64_t stride = (int64_t)gridDim.x * kTermsThreads;
  for (int64_t s = (int64_t)blockIdx.x * kTermsThreads + threadIdx.x; s < S; s += stride) {
    const float cap = rows[s], queue = rows[S + s], work = rows[2 * S + s];
    const float load = rows[3 * S + s], bw = rows[4 * S + s];
    const float loss = rows[5 * S + s], rtt = rows[6 * S + s];
    const float mss = rows[8 * S + s];
    const float mathis = mss / (rtt * sqrtf(fmaxf(loss, 1e-12f)));
    const float eff = loss > 0.0f ? np_minimum(bw, mathis) : bw;
    const bool alive = rows[7 * S + s] > 0.5f;
    const bool fast = !alive || (div32_window(eff) && div32_window(cap));
    terms[kNet32 * S + s] = (loss / bw) * 1e6f;
    terms[kEff32 * S + s] = eff;
    terms[kComp32 * S + s] = (wq * queue + ww * work) / cap + wl * load;
    terms[kCap32 * S + s] = cap;
    terms[kYEff32 * S + s] = __frcp_rn(eff);
    terms[kYCap32 * S + s] = __frcp_rn(cap);
    terms[kFlags32 * S + s] = __int_as_float((alive ? kAlive : 0) | (fast ? kFastCol : 0));
  }
}

struct Site32 {
  float net, eff, comp, cap, yeff, ycap;
  bool alive;
};

// One cell: net + wc·comp + wd·dtc with comp = comp_site + jw/cap and
// dtc = jb/eff, 3e38 in a dead column. kFast: both quotients by div_rn_f32.
template <bool kFast>
__device__ __forceinline__ float cell_f32(const Site32& t, float jb, float jw, float wc, float wd) {
  const float comp = t.comp + (kFast ? div_rn_f32(jw, t.cap, t.ycap) : jw / t.cap);
  const float dtc = kFast ? div_rn_f32(jb, t.eff, t.yeff) : jb / t.eff;
  const float cost = t.net + wc * comp + wd * dtc;
  return t.alive ? cost : 3.0e38f;
}

// The f32 plane. Bound by the bytes it writes (J·S·4). A persistent grid:
// each block keeps one tile of 4·ct columns (ct quad slots, a power of two
// from 32 to 256) and walks rows; each thread owns four adjacent columns,
// holds their terms in registers for every row it writes and stores one
// float4 a row (kVec, S % 4 == 0: every row starts 16-byte aligned), so a
// warp writes 512 contiguous bytes. With S % 4 != 0 the rows start
// misaligned and each thread stores its four cells one by one, up to the
// row's last, partial quad. A warp takes 32 consecutive rows at a time: it
// loads their job columns in one coalesced load each and hands every row
// out by shuffles, so no row waits on its own load. No barrier on the row
// path.
//
// Out-of-window cells take IEEE division in this kernel, by a branch and
// not by a fix-up pass: a row's flag (jb and jw in the window) is the same
// in every lane of the warp, and a thread's column flag (its four columns
// fast) is fixed for the launch, so the branch diverges only in a warp
// that holds a flagged column; a fix-up pass would cost a third launch and
// a J-long flag array on every call, a quarter of the time at 10k × 256.
template <bool kVec>
__global__ void __launch_bounds__(kPlaneThreads) cost_matrix_f32_kernel(
    const float* __restrict__ jb, const float* __restrict__ jw,
    const float* __restrict__ wc, const float* __restrict__ wd,
    const float* __restrict__ terms, float* __restrict__ out, int64_t J, int64_t S, int ct) {
  const int64_t tiles = (S + 4 * ct - 1) / (4 * ct);
  const int64_t c0 = (int64_t)(blockIdx.x % tiles) * 4 * ct + 4 * (threadIdx.x % ct);
  const int lane = threadIdx.x % kLanes;
  const int rows_per_pass = kPlaneThreads / ct;
  const int64_t slots = (int64_t)(gridDim.x / tiles) * rows_per_pass;
  const int64_t slot = (int64_t)(blockIdx.x / tiles) * rows_per_pass + threadIdx.x / ct;
  Site32 t[4];
  bool fast_cols = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t c = c0 + k;
    t[k] = Site32{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
    if (c < S) {
      const int flags = __float_as_int(__ldg(terms + kFlags32 * S + c));
      t[k] = Site32{__ldg(terms + kNet32 * S + c), __ldg(terms + kEff32 * S + c),
                    __ldg(terms + kComp32 * S + c), __ldg(terms + kCap32 * S + c),
                    __ldg(terms + kYEff32 * S + c), __ldg(terms + kYCap32 * S + c),
                    (flags & kAlive) != 0};
      fast_cols = fast_cols && (flags & kFastCol) != 0;
    }
  }
  for (int64_t j0 = slot * kLanes; j0 < J; j0 += slots * kLanes) {
    const int64_t jl = j0 + lane;       // this lane loads row jl
    const bool in = jl < J;
    const float bl = in ? jb[jl] : 0.0f, wl = in ? jw[jl] : 0.0f;
    const float cl = in ? wc[jl] : 0.0f, dl = in ? wd[jl] : 0.0f;
    const unsigned fast_rows = __ballot_sync(0xffffffffu, div32_window(bl) && div32_window(wl));
    const int n = J - j0 < kLanes ? (int)(J - j0) : kLanes;   // the same in every lane
#pragma unroll 4
    for (int i = 0; i < kLanes; ++i) {
      const float b = __shfl_sync(0xffffffffu, bl, i), w = __shfl_sync(0xffffffffu, wl, i);
      const float c = __shfl_sync(0xffffffffu, cl, i), d = __shfl_sync(0xffffffffu, dl, i);
      if (i >= n) break;
      float v[4];
      if (fast_cols && (fast_rows >> i & 1u)) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = cell_f32<true>(t[k], b, w, c, d);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = cell_f32<false>(t[k], b, w, c, d);
      }
      float* row = out + (j0 + i) * S + c0;
      if (kVec) {
        if (c0 < S) __stcs(reinterpret_cast<float4*>(row), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c0 + k < S) __stcs(row + k, v[k]);
      }
    }
  }
}

// ---- float64, class_total order ----------------------------------------------

// Per-site terms, written once a launch by site_terms_f64_kernel into the
// wrapper's scratch: kTermFields arrays of Sp doubles (Sp = S rounded up to
// a warp's 32 lanes; the pad columns are dead), then kGateSlots ints, one
// partial gate per block of the pre-pass, kGateSlots ints, one per block
// that met a live column outside div_range, then J ints, one per job row,
// set when the row holds a cell outside div_range (the fix-up's rows).
enum TermField {
  kNet, kEff, kComp, kCap, kDead,        // class_total's operands, exact
  kDivEff, kDivCap,                      // RN(1/eff), RN(1/cap) for div_rn
  kScrNet, kScrBase, kRecEff, kRecCap,   // the argmin's screen
  kTermFields
};
constexpr int kGateSlots = 256;
constexpr int kArgminThreads = 256;      // 8 warps
constexpr int kArgminWarps = kArgminThreads / kLanes;
constexpr int kRows = 4;                 // R: job rows a warp carries in registers
// The screen: a cell is evaluated exactly unless its estimate exceeds the
// row's threshold, kGuard² times the row's least estimate, or +inf (every
// cell exact) outside [kScreenLo, kScreenHi] or with the gate off.
constexpr double kGuard = 1.0 + 0x1p-40;
constexpr double kScreenLo = 0x1p-960;
constexpr double kScreenHi = 0x1p1000;
constexpr double kMinNormal = 0x1p-1022;

__host__ __device__ __forceinline__ int64_t padded_sites(int64_t S) {
  return (S + kLanes - 1) / kLanes * kLanes;
}

// True when x is a normal number with |x| in [2^-500, 2^501): the
// domain of div_rn (exponent field 523 … 1523; not 0, subnormal, inf, NaN).
__device__ __forceinline__ bool div_range(double x) {
  const unsigned e = (unsigned)((__double_as_longlong(x) >> 52) & 0x7ff);
  return e - 523u <= 1000u;
}

// Site terms in repro.core.batch's cost_components/comp_site_column order,
// and the screen's: the correctly rounded reciprocals of eff and cap where
// both are normal numbers (else NaN terms, so the site is always evaluated
// exactly), +inf for a dead or pad column. Each block also ANDs the gate of
// its share of sites and jobs: every term the estimate adds nonnegative,
// cap positive and finite (the reference's _f32_gate, repro/core/batch.py);
// ORs whether a live column's eff or cap leaves div_range; and, for the
// plane, flags the rows whose bytes or work (as the class uses them) do.
__global__ void __launch_bounds__(kTermsThreads) site_terms_f64_kernel(
    const double* __restrict__ rows,  // (8, S) PACK_FIELDS: cap queue work load bw loss rtt mss
    const uint8_t* __restrict__ alive, int64_t S, int64_t Sp,
    const double* __restrict__ bytes, const double* __restrict__ work,
    const int8_t* __restrict__ cls, int64_t J, double wq, double ww, double wl, int mask_dead,
    int plane, double* __restrict__ terms, int* __restrict__ gate,
    int* __restrict__ bad_cols, int* __restrict__ slow_rows) {
  bool ok = true, bad = false;
  const int64_t stride = (int64_t)gridDim.x * kTermsThreads;
  const int64_t first = (int64_t)blockIdx.x * kTermsThreads + threadIdx.x;
  for (int64_t s = first; s < Sp; s += stride) {
    double net = 0.0, eff = 0.0, comp = 0.0, cap = 0.0;
    bool dead = true, screenable = false;
    if (s < S) {
      cap = rows[s];
      const double queue = rows[S + s], swork = rows[2 * S + s];
      const double load = rows[3 * S + s], bw = rows[4 * S + s];
      const double loss = rows[5 * S + s], rtt = rows[6 * S + s];
      const double mss = rows[7 * S + s];
      net = (loss / bw) * 1.0e6;
      const double mathis = mss / (rtt * sqrt(loss));
      eff = loss > 0.0 ? np_minimum(bw, mathis) : bw;
      comp = wq * queue / cap + ww * swork / cap + wl * load;
      dead = alive[s] == 0;
      ok = ok && net >= 0.0 && eff >= 0.0 && queue >= 0.0 && swork >= 0.0 &&
           load >= 0.0 && cap > 0.0 && cap < INFINITY;
    }
    const double reff = 1.0 / eff, rcap = 1.0 / cap;
    screenable = fabs(reff) >= kMinNormal && fabs(reff) < INFINITY &&
                 fabs(rcap) >= kMinNormal && fabs(rcap) < INFINITY;
    const bool dead_col = s >= S || (dead && mask_dead);
    bad = bad || (!dead_col && !(div_range(eff) && div_range(cap)));
    terms[kNet * Sp + s] = net;
    terms[kEff * Sp + s] = eff;
    terms[kComp * Sp + s] = comp;
    terms[kCap * Sp + s] = cap;
    terms[kDead * Sp + s] = dead_col ? 1.0 : 0.0;
    terms[kDivEff * Sp + s] = reff;
    terms[kDivCap * Sp + s] = rcap;
    terms[kScrNet * Sp + s] = dead_col ? INFINITY : screenable ? net : NAN;
    terms[kScrBase * Sp + s] = dead_col ? INFINITY : screenable ? net + comp : NAN;
    terms[kRecEff * Sp + s] = dead_col || !screenable ? 0.0 : reff;
    terms[kRecCap * Sp + s] = dead_col || !screenable ? 0.0 : rcap;
  }
  for (int64_t j = first; j < J; j += stride) {
    const double b = bytes[j], w = work[j];
    const int k = cls[j];
    ok = ok && b >= 0.0 && w >= 0.0;
    slow_rows[j] = plane && ((k != kCompute && !div_range(b)) || (k != kData && !div_range(w)));
  }
  ok = __syncthreads_and(ok);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    gate[blockIdx.x] = ok;
    bad_cols[blockIdx.x] = bad;
  }
}

// a / b correctly rounded, for a and b in div_range, from y = RN(1/b):
// q0 = RN(a·y) is within 1.5 ulp of a/b; one FMA correction makes it
// faithful; with y within half an ulp of 1/b, Markstein's theorem makes
// the second correction RN(q + (a − b·q)·y) the exact rounding of a/b
// (the remainder a − b·q is exact; the ranges rule out under- and
// overflow). Five FP64 instructions in place of a full division, whose
// reciprocal iteration the pre-pass has done once per site.
__device__ __forceinline__ double div_rn(double a, double b, double y) {
  double q = a * y;
  double r = __fma_rn(-b, q, a);
  q = __fma_rn(r, y, q);
  r = __fma_rn(-b, q, a);
  return __fma_rn(r, y, q);
}

struct Site {
  double net, eff, comp, cap, yeff, ycap;
  bool dead, fast_eff, fast_cap;
};

__device__ __forceinline__ Site load_site(const double* __restrict__ terms, int64_t Sp,
                                          int64_t s) {
  Site t;
  t.net = __ldg(terms + kNet * Sp + s);
  t.eff = __ldg(terms + kEff * Sp + s);
  t.comp = __ldg(terms + kComp * Sp + s);
  t.cap = __ldg(terms + kCap * Sp + s);
  t.yeff = __ldg(terms + kDivEff * Sp + s);
  t.ycap = __ldg(terms + kDivCap * Sp + s);
  t.dead = __ldg(terms + kDead * Sp + s) != 0.0;
  t.fast_eff = div_range(t.eff);
  t.fast_cap = div_range(t.cap);
  return t;
}

// class_total's value of one cell (DATA dtc+net, COMPUTE comp+net, BOTH
// (net+comp)+dtc, comp = comp_site + work/cap); +inf in a dead column.
// Straight-line: both quotients by div_rn, the class by selects. Exact
// when cell_slow is false; a slow cell is left to the fix-up pass.
__device__ __forceinline__ double cell_f64(const Site& t, int cls, double bytes, double work) {
  const double dtc = div_rn(bytes, t.eff, t.yeff);
  const double comp = t.comp + div_rn(work, t.cap, t.ycap);
  const double v = cls == kData ? dtc + t.net : cls == kCompute ? comp + t.net : (t.net + comp) + dtc;
  return t.dead ? INFINITY : v;
}

// A live cell whose class uses a quotient with an operand outside
// div_range (fast_b / fast_w: the job's bytes / work lie in it).
__device__ __forceinline__ bool cell_slow(const Site& t, int cls, bool fast_b, bool fast_w) {
  return !t.dead && ((cls != kCompute && !(fast_b && t.fast_eff)) ||
                     (cls != kData && !(fast_w && t.fast_cap)));
}

// The same cell with IEEE division, for the fix-up pass.
__device__ __forceinline__ double cell_ieee(const double* __restrict__ terms, int64_t Sp,
                                            int64_t s, int cls, double bytes, double work) {
  if (__ldg(terms + kDead * Sp + s) != 0.0) return INFINITY;
  const double net = __ldg(terms + kNet * Sp + s);
  const double dtc = bytes / __ldg(terms + kEff * Sp + s);
  if (cls == kData) return dtc + net;
  const double comp = __ldg(terms + kComp * Sp + s) + work / __ldg(terms + kCap * Sp + s);
  return cls == kCompute ? comp + net : (net + comp) + dtc;
}

// The f64 plane. Bound by the bytes it writes (J·S·8). A persistent grid:
// each block keeps one tile of 2·ct columns and walks rows; each thread
// owns one 16-byte-aligned pair slot of a row, holds the site terms of its
// columns in registers for every row it writes, and stores one double2,
// so a warp writes 512 contiguous bytes. A warp loads the job columns of
// its next 32 rows in one coalesced load and hands each row out with
// shuffles, so no row waits on its own load. With S odd a row starts on
// an odd element every other row, so a slot's two columns shift by one
// there, and the row's unpaired first or last column is a single 8-byte
// store. No barrier on the row path. Cells outside div_range (flagged by
// the pre-pass by row and by column) are rewritten by the fix-up kernel
// with IEEE division, so no division subroutine, call or conditional
// store sits in this kernel.
template <bool kOdd>
__global__ void __launch_bounds__(kPlaneThreads) cost_matrix_f64_kernel(
    const double* __restrict__ bytes, const double* __restrict__ work,
    const int8_t* __restrict__ cls, const double* __restrict__ terms,
    double* __restrict__ out, int64_t J, int64_t S, int64_t Sp, int ct) {
  const int64_t slots = (S + 1) / 2;  // pair slots of a row
  const int64_t tiles = (slots + ct - 1) / ct;
  const int64_t p = (int64_t)(blockIdx.x % tiles) * ct + threadIdx.x % ct;
  const int lane = threadIdx.x % kLanes;
  const bool active = p < slots;       // inactive lanes still hand out rows
  const int rows_per_pass = kPlaneThreads / ct;
  const int64_t row_step = (int64_t)(gridDim.x / tiles) * rows_per_pass;
  const int64_t first = (int64_t)(blockIdx.x / tiles) * rows_per_pass + threadIdx.x / ct;
  const int64_t c0 = 2 * p;
  // Columns c0 and c0 + 1 in registers; with S odd an odd row's slot is
  // columns c0 - 1 and c0, and column c0 - 1 comes from L1. A column
  // outside [0, S) is never stored, its terms are a pad's.
  Site mid{}, right{};
  if (active && c0 < Sp) mid = load_site(terms, Sp, c0);
  if (active && c0 + 1 < Sp) right = load_site(terms, Sp, c0 + 1);
  for (int64_t j0 = first; j0 < J; j0 += kLanes * row_step) {
    const int64_t jl = j0 + lane * row_step;   // this lane loads row jl
    const double bl = jl < J ? bytes[jl] : 0.0, wl = jl < J ? work[jl] : 0.0;
    const int kl = jl < J ? cls[jl] : kCompute;
    const int n = (int)((J - j0 + row_step - 1) / row_step);
#pragma unroll (kOdd ? 1 : 4)  // odd rows load a column: unrolled, 182 registers, no faster
    for (int i = 0; i < kLanes; ++i) {
      const double b = __shfl_sync(0xffffffffu, bl, i), w = __shfl_sync(0xffffffffu, wl, i);
      const int k = __shfl_sync(0xffffffffu, kl, i);
      if (i >= n || !active) continue;
      const int64_t j = j0 + i * row_step;
      const int a = kOdd ? (int)(j & 1) : 0;  // (j·S) & 1 with S odd
      const int64_t lo = c0 - a;               // the slot's first column
      Site s0 = mid, s1 = right;               // columns lo and lo + 1
      if (a) {
        s1 = mid;
        if (lo >= 0) s0 = load_site(terms, Sp, lo);
      }
      const bool has0 = lo >= 0 && lo < S, has1 = lo + 1 >= 0 && lo + 1 < S;
      const double v0 = cell_f64(s0, k, b, w), v1 = cell_f64(s1, k, b, w);
      double* row = out + j * S;
      if (has0 && has1)
        __stcs(reinterpret_cast<double2*>(row + lo), make_double2(v0, v1));
      else if (has0)
        __stcs(row + lo, v0);          // the row's last column (S odd)
      else if (has1)
        __stcs(row, v1);               // an odd row's first column (S odd)
    }
  }
}

// The plane's cells outside div_range, again with IEEE division: a warp a
// row; a flagged row in full, else, when some live column's eff or cap
// leaves div_range, that column's cells. Reads J flags when none is set.
__global__ void __launch_bounds__(kPlaneThreads) cost_matrix_f64_fixup_kernel(
    const double* __restrict__ bytes, const double* __restrict__ work,
    const int8_t* __restrict__ cls, const double* __restrict__ terms,
    const int* __restrict__ bad_cols, int n_gate, const int* __restrict__ slow_rows,
    double* __restrict__ out, int64_t J, int64_t S, int64_t Sp) {
  const int lane = threadIdx.x % kLanes;
  bool any = false;
  for (int i = lane; i < n_gate; i += kLanes) any = any || bad_cols[i] != 0;
  any = __any_sync(0xffffffffu, any);
  const int64_t warps = (int64_t)gridDim.x * (kPlaneThreads / kLanes);
  for (int64_t j = (int64_t)blockIdx.x * (kPlaneThreads / kLanes) + threadIdx.x / kLanes; j < J;
       j += warps) {
    const bool row = slow_rows[j] != 0;
    if (!row && !any) continue;
    const double b = bytes[j], w = work[j];
    const int k = cls[j];
    for (int64_t c = lane; c < S; c += kLanes) {
      if (row || (__ldg(terms + kDead * Sp + c) == 0.0 &&
                  !(div_range(__ldg(terms + kEff * Sp + c)) &&
                    div_range(__ldg(terms + kCap * Sp + c)))))
        out[j * S + c] = cell_ieee(terms, Sp, c, k, b, w);
    }
  }
}

// (value, index) order of np.argmin: a NaN beats any number, then the
// smaller value, then the smaller index; index < 0 marks "nothing yet".
__device__ __forceinline__ bool argmin_better(double v, int i, double bv, int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = v != v, bn = bv != bv;
  if (vn != bn) return vn;
  if (vn) return i < bi;
  return v < bv || (v == bv && i < bi);
}

// The threshold from a bound m on the row's least estimate: cells whose
// estimate exceeds t = m·kGuard² are worse than the cell that gave the
// least estimate. +inf (every cell exact) when the gate is off or t is out
// of the range where the estimates' relative error bound holds.
__device__ __forceinline__ double threshold(double m, bool screen) {
  const double x = m * kGuard * kGuard;
  return screen && x <= kScreenHi ? fmax(x, kScreenLo) : INFINITY;
}

// The screen tracks estimates by a 32-bit key, the high word of the
// double with the sign cleared: for numbers ≥ +0 its order is theirs, a
// key stands for the values in [lower(k), lower(k + 1)), and every NaN's
// key lies above +inf's, so a minimum of keys ignores NaNs.
constexpr unsigned kInfKey = 0x7ff00000u;

__device__ __forceinline__ unsigned screen_key(double e) {
  return (unsigned)__double2hiint(e) & 0x7fffffffu;
}

__device__ __forceinline__ double key_lower(unsigned k) { return __hiloint2double((int)k, 0); }

__device__ __forceinline__ double warp_min(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmin(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The screen's estimate of a cell, with multiplications by the site's
// reciprocals in place of the divisions: (base + work·(1/cap)) + bytes·(1/eff),
// base = net + comp_site (net alone for DATA). The job's bytes are 0 in a
// COMPUTE row and its work 0 in a DATA row. All terms are nonnegative under
// the gate, so every operation adds at most half an ulp of relative error:
// e and the exact value are within 2^-49 of each other relative to either,
// far inside kGuard, once e ≥ kScreenLo (below it subnormal terms break
// relative bounds; t never falls below it). A dead column gives +inf and a
// site without a normal reciprocal NaN, which is always evaluated exactly.
__device__ __forceinline__ double estimate(int cls, double snet, double sbase, double reff,
                                           double rcap, double bb, double wa) {
  return ((cls == kData ? snet : sbase) + wa * rcap) + bb * reff;
}

// Merge one exactly evaluated cell into a lane's best.
__device__ __forceinline__ void merge_exact(double v, int c, double& bv, int& bi) {
  if (argmin_better(v, c, bv, bi)) {
    bv = v;
    bi = c;
  }
}

// The fused row argmin. Bound by the FP64 pipe: a BOTH cell's two divisions
// are some ten FP64 instructions even as div_rn, the estimate four. Site
// terms come once a launch from the pre-pass (L1/L2). A warp carries kRows
// job rows in registers; its lanes stride the columns (lane l: l, l + 32,
// ...), so each site's terms are loaded once per kRows rows and each column
// gives kRows independent cells. The walk over the columns only estimates,
// branch-free: each lane keeps, per row, the screen key of its least
// estimate and that cell's column, the least key of its other cells, and
// whether it met a NaN (four FP64 instructions and a few integer ones a
// cell). The least estimate M of the lanes' least cells gives the
// threshold t = M·kGuard², and only cells within it take the exact
// divisions: a lane evaluates its own least cell when its other cells all
// exceed t, and walks its columns again only when they may not (a near
// tie, a NaN estimate, or the gate off, which makes t = +inf and every
// cell exact: the kernel is bit-identical to class_total on any input).
// A row whose exact path meets a cell outside div_range is flagged for the
// fix-up kernel, which redoes it with IEEE division. Persistent grid of
// three blocks an SM: at 64 registers (four blocks) ptxas spills the
// exact path's state; at 72 it spills nothing and runs as fast.
__global__ void __launch_bounds__(kArgminThreads, 3) cost_argmin_f64_kernel(
    const double* __restrict__ bytes, const double* __restrict__ work,
    const int8_t* __restrict__ cls, const double* __restrict__ terms,
    const int* __restrict__ gate, int n_gate, int weights_ok,
    int* __restrict__ slow_rows, int64_t* __restrict__ best, double* __restrict__ best_cost,
    int64_t J, int64_t Sp) {
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  bool g = weights_ok != 0;
  for (int i = lane; i < n_gate; i += kLanes) g = g && gate[i] != 0;
  const bool screen = __all_sync(0xffffffffu, g);
  const double* snet = terms + kScrNet * Sp;
  const double* sbase = terms + kScrBase * Sp;
  const double* reff = terms + kRecEff * Sp;
  const double* rcap = terms + kRecCap * Sp;
  const int64_t groups = (J + kRows - 1) / kRows;

  for (int64_t grp = (int64_t)blockIdx.x * kArgminWarps + warp; grp < groups;
       grp += (int64_t)gridDim.x * kArgminWarps) {
    const int64_t row0 = grp * kRows;
    double bb[kRows], wa[kRows];
    unsigned emin[kRows], e2[kRows];  // screen keys: least estimate, least of the others
    int kc[kRows], imin[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t j = row0 + r;
      const bool in = j < J;
      kc[r] = in ? cls[j] : kCompute;
      bb[r] = in && kc[r] != kCompute ? bytes[j] : 0.0;
      wa[r] = in && kc[r] != kData ? work[j] : 0.0;
      emin[r] = e2[r] = kInfKey;
      imin[r] = -1;
    }
    unsigned nan = 0;  // bit r: row r met a NaN estimate
#pragma unroll 2
    for (int c = lane; c < Sp; c += kLanes) {
      const double sn = __ldg(snet + c), sb = __ldg(sbase + c);
      const double re = __ldg(reff + c), rc = __ldg(rcap + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const double e = estimate(kc[r], sn, sb, re, rc, bb[r], wa[r]);
        const unsigned key = screen_key(e);
        imin[r] = key < emin[r] ? c : imin[r];
        e2[r] = min(e2[r], max(key, emin[r]));
        emin[r] = min(emin[r], key);
        nan |= (unsigned)(e != e) << r;
      }
    }
    // The thresholds, from a real cell's estimate each: the least of the
    // lanes' least cells.
    double t[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ci = imin[r] < 0 ? 0 : imin[r];
      const double ey = estimate(kc[r], __ldg(snet + ci), __ldg(sbase + ci), __ldg(reff + ci),
                                 __ldg(rcap + ci), bb[r], wa[r]);
      t[r] = imin[r] < 0 ? INFINITY : ey;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) t[r] = threshold(warp_min(t[r]), screen);
    // Cells to evaluate exactly, per row: none, the lane's least (imin), or
    // every lane column whose estimate is not above t (NaN included): the
    // lane walks the row again (bit r of again).
    unsigned again = 0, slow = 0;  // slow bit r: a cell outside div_range
    double bv[kRows];
    int bi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool rescan = (nan >> r & 1u) || !(key_lower(e2[r]) > t[r]);
      const bool own = !rescan && !(key_lower(emin[r]) > t[r]);
      again |= (unsigned)rescan << r;
      const int ci = own ? imin[r] : 0;
      const Site st = load_site(terms, Sp, ci);
      const double v = cell_f64(st, kc[r], bb[r], wa[r]);
      bv[r] = own ? v : 0.0;
      bi[r] = own ? ci : -1;
      slow |= (unsigned)(own && cell_slow(st, kc[r], div_range(bb[r]), div_range(wa[r]))) << r;
    }
    if (__any_sync(0xffffffffu, again)) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!(again >> r & 1u)) continue;
        const bool fb = div_range(bb[r]), fw = div_range(wa[r]);
        for (int c = lane; c < Sp; c += kLanes) {
          if (estimate(kc[r], __ldg(snet + c), __ldg(sbase + c), __ldg(reff + c), __ldg(rcap + c),
                       bb[r], wa[r]) > t[r])
            continue;
          const Site st = load_site(terms, Sp, c);
          slow |= (unsigned)cell_slow(st, kc[r], fb, fw) << r;
          merge_exact(cell_f64(st, kc[r], bb[r], wa[r]), c, bv[r], bi[r]);
        }
      }
    }
    slow = __reduce_or_sync(0xffffffffu, slow);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const double ov = __shfl_down_sync(0xffffffffu, bv[r], off);
        const int oi = __shfl_down_sync(0xffffffffu, bi[r], off);
        if (argmin_better(ov, oi, bv[r], bi[r])) {
          bv[r] = ov;
          bi[r] = oi;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t j = row0 + r;
        if (j < J) {
          best[j] = bi[r];
          best_cost[j] = bv[r];
          if (slow >> r & 1u) slow_rows[j] = 1;
        }
      }
    }
  }
}

// Rows whose exact path met a cell outside div_range, again over every
// column with IEEE division: a warp a flagged row.
__global__ void __launch_bounds__(kArgminThreads) cost_argmin_f64_fixup_kernel(
    const double* __restrict__ bytes, const double* __restrict__ work,
    const int8_t* __restrict__ cls, const double* __restrict__ terms,
    const int* __restrict__ slow_rows, int64_t* __restrict__ best,
    double* __restrict__ best_cost, int64_t J, int64_t Sp) {
  const int lane = threadIdx.x % kLanes;
  const int64_t warps = (int64_t)gridDim.x * kArgminWarps;
  for (int64_t j = (int64_t)blockIdx.x * kArgminWarps + threadIdx.x / kLanes; j < J; j += warps) {
    if (!slow_rows[j]) continue;
    const double b = bytes[j], w = work[j];
    const int k = cls[j];
    double bv = 0.0;
    int bi = -1;
    for (int c = lane; c < Sp; c += kLanes) merge_exact(cell_ieee(terms, Sp, c, k, b, w), c, bv, bi);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (argmin_better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      best[j] = bi;
      best_cost[j] = bv;
    }
  }
}

// One cell's exact evaluation and merge, for the SASS probes below.
template <int kClass>
__device__ __forceinline__ void probe_exact(const double* in, double* out) {
  double bv = in[7];
  int bi = (int)in[9];
  const Site s{in[0], in[1], in[2], in[3], in[11], in[12], in[4] != 0.0, true, true};
  merge_exact(cell_f64(s, kClass, in[5], in[6]), 3, bv, bi);
  out[0] = bv;
  out[2] = bi;
}

// Resident blocks of a kernel on this device, for the persistent grids.
struct Residency {
  int sms = 0, plane32 = 0, plane = 0, argmin = 0;
};

cudaError_t residency(Residency* out) {
  static Residency cache[64];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  Residency& r = cache[dev & 63];
  if (r.sms == 0) {
    Residency n;
    if ((rc = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n.plane32, cost_matrix_f32_kernel<true>, kPlaneThreads, 0)) ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n.plane, cost_matrix_f64_kernel<false>, kPlaneThreads, 0)) ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n.argmin, cost_argmin_f64_kernel, kArgminThreads, 0)))
      return rc;
    r = n;
  }
  *out = r;
  return cudaSuccess;
}

// The scratch's parts (see TermField).
struct Scratch {
  double* terms;
  int* gate;
  int* bad_cols;
  int* slow_rows;
};

Scratch scratch_parts(void* scratch, int64_t Sp) {
  double* terms = static_cast<double*>(scratch);
  int* gate = reinterpret_cast<int*>(terms + kTermFields * Sp);
  return Scratch{terms, gate, gate + kGateSlots, gate + 2 * kGateSlots};
}

// Launch the pre-pass; returns its block count (the gate's slots) in *n_gate.
cudaError_t launch_site_terms(const double* rows, const uint8_t* alive, int64_t S,
                              const double* bytes, const double* work, const int8_t* cls,
                              int64_t J, double wq, double ww, double wl, int mask_dead,
                              int plane, const Scratch& sc, int* n_gate, cudaStream_t stream) {
  const int64_t Sp = padded_sites(S);
  const int64_t n = Sp > J ? Sp : J;
  int blocks = (int)((n + kTermsThreads - 1) / kTermsThreads);
  blocks = blocks < kGateSlots ? blocks : kGateSlots;
  site_terms_f64_kernel<<<blocks, kTermsThreads, 0, stream>>>(
      rows, alive, S, Sp, bytes, work, cls, J, wq, ww, wl, mask_dead, plane, sc.terms, sc.gate,
      sc.bad_cols, sc.slow_rows);
  *n_gate = blocks;
  return cudaGetLastError();
}

// Blocks of a fix-up kernel: a warp a row, at most the card's resident warps.
unsigned fixup_blocks(int64_t J, int sms) {
  const int64_t want = (J + 7) / 8, most = (int64_t)sms * 8;
  return (unsigned)(want < most ? want : most);
}

}  // namespace

extern "C" {

// Launch errors (too many threads, a bad configuration) never run and are
// not reported by a later synchronize: every entry returns
// cudaGetLastError() right after its launch.

int repro_cost_matrix_f32(const float* jb, const float* jw, const float* wc,
                          const float* wd, const float* site_rows, float* out,
                          int64_t J, int64_t S, float wq, float ww, float wl,
                          void* scratch, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  float* terms = static_cast<float*>(scratch);
  Residency res;
  cudaError_t rc = residency(&res);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t pre = (S + kTermsThreads - 1) / kTermsThreads;
  site_terms_f32_kernel<<<(unsigned)(pre < 1024 ? pre : 1024), kTermsThreads, 0, st>>>(
      site_rows, S, wq, ww, wl, terms);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  // Column tile: ct quad slots (a power of two from 32 to 256), the rest
  // of the block's threads on rows; a warp takes 32 rows at a time.
  int ct = kLanes;
  while (4 * ct < S && ct < kPlaneThreads) ct *= 2;
  const int64_t tiles = (S + 4 * ct - 1) / (4 * ct);
  const int64_t rows_per_pass = kPlaneThreads / ct;
  int64_t row_groups = ((int64_t)res.sms * res.plane32) / tiles;
  const int64_t needed = ((J + kLanes - 1) / kLanes + rows_per_pass - 1) / rows_per_pass;
  row_groups = row_groups < 1 ? 1 : row_groups > needed ? needed : row_groups;
  const dim3 grid((unsigned)(tiles * row_groups));
  if (S % 4)
    cost_matrix_f32_kernel<false><<<grid, kPlaneThreads, 0, st>>>(jb, jw, wc, wd, terms, out, J, S, ct);
  else
    cost_matrix_f32_kernel<true><<<grid, kPlaneThreads, 0, st>>>(jb, jw, wc, wd, terms, out, J, S, ct);
  return (int)cudaGetLastError();
}

int repro_cost_matrix_f64(const double* bytes, const double* work,
                          const int8_t* cls, const double* site_rows,
                          const uint8_t* alive, double* out, int64_t J,
                          int64_t S, double wq, double ww, double wl,
                          int mask_dead, void* scratch, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t Sp = padded_sites(S);
  const Scratch sc = scratch_parts(scratch, Sp);
  Residency res;
  int n_gate = 0;
  cudaError_t rc = residency(&res);
  if (rc == cudaSuccess)
    rc = launch_site_terms(site_rows, alive, S, bytes, work, cls, J, wq, ww, wl, mask_dead, 1,
                           sc, &n_gate, st);
  if (rc != cudaSuccess) return (int)rc;
  // Column tile: ct pair slots (a power of two from 32 to 256), the rest
  // of the block's threads on rows.
  const int64_t slots = (S + 1) / 2;
  int ct = kLanes;
  while (ct < slots && ct < kPlaneThreads) ct *= 2;
  const int64_t tiles = (slots + ct - 1) / ct;
  const int64_t rows_per_pass = kPlaneThreads / ct;
  int64_t row_groups = ((int64_t)res.sms * res.plane) / tiles;
  const int64_t needed = (J + rows_per_pass - 1) / rows_per_pass;
  row_groups = row_groups < 1 ? 1 : row_groups > needed ? needed : row_groups;
  const dim3 grid((unsigned)(tiles * row_groups));
  if (S % 2)
    cost_matrix_f64_kernel<true><<<grid, kPlaneThreads, 0, st>>>(
        bytes, work, cls, sc.terms, out, J, S, Sp, ct);
  else
    cost_matrix_f64_kernel<false><<<grid, kPlaneThreads, 0, st>>>(
        bytes, work, cls, sc.terms, out, J, S, Sp, ct);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  cost_matrix_f64_fixup_kernel<<<fixup_blocks(J, res.sms), kPlaneThreads, 0, st>>>(
      bytes, work, cls, sc.terms, sc.bad_cols, n_gate, sc.slow_rows, out, J, S, Sp);
  return (int)cudaGetLastError();
}

int repro_cost_argmin_f64(const double* bytes, const double* work,
                          const int8_t* cls, const double* site_rows,
                          const uint8_t* alive, int64_t* best,
                          double* best_cost, int64_t J, int64_t S, double wq,
                          double ww, double wl, void* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t Sp = padded_sites(S);
  const Scratch sc = scratch_parts(scratch, Sp);
  Residency res;
  int n_gate = 0;
  cudaError_t rc = residency(&res);
  if (rc == cudaSuccess)
    rc = launch_site_terms(site_rows, alive, S, bytes, work, cls, J, wq, ww, wl, 1, 0, sc,
                           &n_gate, st);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t groups = (J + kRows * kArgminWarps - 1) / (kRows * kArgminWarps);
  const int64_t resident = (int64_t)res.sms * res.argmin;
  const dim3 grid((unsigned)(groups < resident ? groups : resident));
  const int weights_ok = wq >= 0.0 && ww >= 0.0 && wl >= 0.0;
  cost_argmin_f64_kernel<<<grid, kArgminThreads, 0, st>>>(
      bytes, work, cls, sc.terms, sc.gate, n_gate, weights_ok, sc.slow_rows, best, best_cost, J,
      Sp);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  cost_argmin_f64_fixup_kernel<<<fixup_blocks(J, res.sms), kArgminThreads, 0, st>>>(
      bytes, work, cls, sc.terms, sc.slow_rows, best, best_cost, J, Sp);
  return (int)cudaGetLastError();
}

// Never launched: one cell of cost_argmin_f64_kernel's walk each, built
// from the same device functions, so that `cuobjdump -sass` of the library
// shows the FP64 instructions a cell costs: its screen, and its exact
// evaluation and merge for each job class (chip_smoke.py's pipe floor).
__global__ void repro_probe_screen_f64(const double* in, const int8_t* cls, unsigned* out) {
  const double e = estimate(cls[0], in[0], in[1], in[2], in[3], in[4], in[5]);
  const unsigned key = screen_key(e);
  unsigned emin = out[0], e2 = out[1];
  out[2] = key < emin ? 7u : out[2];
  out[1] = min(e2, max(key, emin));
  out[0] = min(emin, key);
  out[3] |= (unsigned)(e != e);
}

__global__ void repro_probe_exact_f64_compute(const double* in, double* out) {
  probe_exact<kCompute>(in, out);
}
__global__ void repro_probe_exact_f64_data(const double* in, double* out) {
  probe_exact<kData>(in, out);
}
__global__ void repro_probe_exact_f64_both(const double* in, double* out) {
  probe_exact<kBoth>(in, out);
}

// Shared by every kernel of the library: the text of a CUDA error code.
const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
