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
// IEEE double division and sqrt are correctly rounded, as NumPy's are;
// min propagates NaN like np.minimum (not fmin).
//
// Bound on an H100: the planes are bound by the bytes they write (100k ×
// 1024 f64 = 819 MB, ~0.25 ms at 3.35 TB/s; half that in f32). The job
// columns and the (rows × S) site block are read once per tile, site terms
// (the sqrt and three divisions per site) are computed once per tile into
// shared memory, and a warp writes 32 consecutive sites of one row, so the
// stores coalesce. The fused argmin writes 16 bytes a row and is bound by
// the two f64 divisions per cell; its site terms are staged in shared
// memory in chunks of 256 columns shared by the block's 32 rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileSites = 32;      // threadIdx.x: one warp across sites
constexpr int kTileRows = 8;        // threadIdx.y
constexpr int kRowsPerThread = 8;   // a block covers 64 jobs × 32 sites
constexpr int kTileJobs = kTileRows * kRowsPerThread;

constexpr int kArgminThreads = 256;                 // 8 warps
constexpr int kArgminRowsPerWarp = 4;
constexpr int kArgminRows = (kArgminThreads / 32) * kArgminRowsPerWarp;
constexpr int kArgminChunk = kArgminThreads;        // site columns per stage

enum JobClass : int8_t { kCompute = 0, kData = 1, kBoth = 2 };

template <typename T>
__device__ __forceinline__ T np_minimum(T a, T b) {
  // np.minimum: NaN in either operand gives NaN.
  return (a <= b || a != a) ? a : b;
}

// ---- float32, Pallas order -------------------------------------------------

__global__ void cost_matrix_f32_kernel(
    const float* __restrict__ jb, const float* __restrict__ jw,
    const float* __restrict__ wc, const float* __restrict__ wd,
    const float* __restrict__ rows,  // (9, S): cap queue work load bw loss rtt alive mss
    float* __restrict__ out, int64_t J, int64_t S,
    float wq, float ww, float wl) {
  __shared__ float s_net[kTileSites], s_eff[kTileSites], s_comp[kTileSites];
  __shared__ float s_cap[kTileSites], s_alive[kTileSites];
  const int64_t s = (int64_t)blockIdx.y * kTileSites + threadIdx.x;
  if (threadIdx.y == 0 && s < S) {
    const float cap = rows[s], queue = rows[S + s], work = rows[2 * S + s];
    const float load = rows[3 * S + s], bw = rows[4 * S + s];
    const float loss = rows[5 * S + s], rtt = rows[6 * S + s];
    const float mss = rows[8 * S + s];
    const float mathis = mss / (rtt * sqrtf(fmaxf(loss, 1e-12f)));
    s_eff[threadIdx.x] = loss > 0.0f ? np_minimum(bw, mathis) : bw;
    s_net[threadIdx.x] = (loss / bw) * 1e6f;
    s_comp[threadIdx.x] = (wq * queue + ww * work) / cap + wl * load;
    s_cap[threadIdx.x] = cap;
    s_alive[threadIdx.x] = rows[7 * S + s];
  }
  __syncthreads();
  if (s >= S) return;
  const float net = s_net[threadIdx.x], eff = s_eff[threadIdx.x];
  const float comp_site = s_comp[threadIdx.x], cap = s_cap[threadIdx.x];
  const bool alive = s_alive[threadIdx.x] > 0.5f;
  const int64_t j0 = (int64_t)blockIdx.x * kTileJobs + threadIdx.y;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t j = j0 + (int64_t)r * kTileRows;
    if (j < J) {
      const float comp = comp_site + jw[j] / cap;
      const float dtc = jb[j] / eff;
      const float cost = net + wc[j] * comp + wd[j] * dtc;
      out[j * S + s] = alive ? cost : 3.0e38f;
    }
  }
}

// ---- float64, class_total order ----------------------------------------------

struct SiteTerms {
  double net, eff, comp, cap;
  bool dead;
};

__device__ __forceinline__ SiteTerms site_terms_f64(
    const double* __restrict__ rows,  // (8, S) PACK_FIELDS: cap queue work load bw loss rtt mss
    const uint8_t* __restrict__ alive, int64_t S, int64_t s,
    double wq, double ww, double wl) {
  const double cap = rows[s], queue = rows[S + s], work = rows[2 * S + s];
  const double load = rows[3 * S + s], bw = rows[4 * S + s];
  const double loss = rows[5 * S + s], rtt = rows[6 * S + s];
  const double mss = rows[7 * S + s];
  SiteTerms t;
  t.net = (loss / bw) * 1.0e6;
  const double mathis = mss / (rtt * sqrt(loss));
  t.eff = loss > 0.0 ? np_minimum(bw, mathis) : bw;
  t.comp = wq * queue / cap + ww * work / cap + wl * load;
  t.cap = cap;
  t.dead = alive[s] == 0;
  return t;
}

__device__ __forceinline__ double class_total_f64(
    int8_t cls, double net, double eff, double comp_site, double cap,
    double bytes, double work) {
  if (cls == kData) return bytes / eff + net;
  const double comp = comp_site + work / cap;
  if (cls == kCompute) return comp + net;
  return (net + comp) + bytes / eff;
}

__global__ void cost_matrix_f64_kernel(
    const double* __restrict__ bytes, const double* __restrict__ work,
    const int8_t* __restrict__ cls, const double* __restrict__ rows,
    const uint8_t* __restrict__ alive, double* __restrict__ out,
    int64_t J, int64_t S, double wq, double ww, double wl, int mask_dead) {
  __shared__ double s_net[kTileSites], s_eff[kTileSites], s_comp[kTileSites];
  __shared__ double s_cap[kTileSites];
  __shared__ bool s_dead[kTileSites];
  const int64_t s = (int64_t)blockIdx.y * kTileSites + threadIdx.x;
  if (threadIdx.y == 0 && s < S) {
    const SiteTerms t = site_terms_f64(rows, alive, S, s, wq, ww, wl);
    s_net[threadIdx.x] = t.net;
    s_eff[threadIdx.x] = t.eff;
    s_comp[threadIdx.x] = t.comp;
    s_cap[threadIdx.x] = t.cap;
    s_dead[threadIdx.x] = t.dead && mask_dead;
  }
  __syncthreads();
  if (s >= S) return;
  const double net = s_net[threadIdx.x], eff = s_eff[threadIdx.x];
  const double comp_site = s_comp[threadIdx.x], cap = s_cap[threadIdx.x];
  const bool dead = s_dead[threadIdx.x];
  const int64_t j0 = (int64_t)blockIdx.x * kTileJobs + threadIdx.y;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t j = j0 + (int64_t)r * kTileRows;
    if (j < J) {
      out[j * S + s] = dead ? INFINITY
                            : class_total_f64(cls[j], net, eff, comp_site, cap,
                                              bytes[j], work[j]);
    }
  }
}

// (value, index) order of np.argmin: a NaN beats any number, then the
// smaller value, then the smaller index; index < 0 marks "nothing yet".
__device__ __forceinline__ bool argmin_better(double v, long long i,
                                              double bv, long long bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = v != v, bn = bv != bv;
  if (vn != bn) return vn;
  if (vn) return i < bi;
  return v < bv || (v == bv && i < bi);
}

__global__ void cost_argmin_f64_kernel(
    const double* __restrict__ bytes, const double* __restrict__ work,
    const int8_t* __restrict__ cls, const double* __restrict__ rows,
    const uint8_t* __restrict__ alive, int64_t* __restrict__ best,
    double* __restrict__ best_cost, int64_t J, int64_t S,
    double wq, double ww, double wl) {
  __shared__ double s_net[kArgminChunk], s_eff[kArgminChunk];
  __shared__ double s_comp[kArgminChunk], s_cap[kArgminChunk];
  __shared__ bool s_dead[kArgminChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = (int64_t)blockIdx.x * kArgminRows + warp * kArgminRowsPerWarp;

  double jb[kArgminRowsPerWarp], jw[kArgminRowsPerWarp];
  int8_t jc[kArgminRowsPerWarp];
  double bv[kArgminRowsPerWarp];
  long long bi[kArgminRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kArgminRowsPerWarp; ++r) {
    const int64_t j = row0 + r;
    const bool ok = j < J;
    jb[r] = ok ? bytes[j] : 0.0;
    jw[r] = ok ? work[j] : 0.0;
    jc[r] = ok ? cls[j] : kCompute;
    bv[r] = 0.0;
    bi[r] = -1;
  }

  for (int64_t c0 = 0; c0 < S; c0 += kArgminChunk) {
    __syncthreads();
    const int64_t s = c0 + threadIdx.x;
    if (s < S) {
      const SiteTerms t = site_terms_f64(rows, alive, S, s, wq, ww, wl);
      s_net[threadIdx.x] = t.net;
      s_eff[threadIdx.x] = t.eff;
      s_comp[threadIdx.x] = t.comp;
      s_cap[threadIdx.x] = t.cap;
      s_dead[threadIdx.x] = t.dead;
    }
    __syncthreads();
    const int n = (int)(S - c0 < kArgminChunk ? S - c0 : kArgminChunk);
#pragma unroll
    for (int r = 0; r < kArgminRowsPerWarp; ++r) {
      if (row0 + r >= J) continue;
      for (int k = lane; k < n; k += 32) {
        const double v = s_dead[k] ? INFINITY
                                   : class_total_f64(jc[r], s_net[k], s_eff[k],
                                                     s_comp[k], s_cap[k], jb[r], jw[r]);
        if (argmin_better(v, c0 + k, bv[r], bi[r])) {
          bv[r] = v;
          bi[r] = c0 + k;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kArgminRowsPerWarp; ++r) {
    double v = bv[r];
    long long i = bi[r];
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_down_sync(0xffffffffu, v, off);
      const long long oi = __shfl_down_sync(0xffffffffu, i, off);
      if (argmin_better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    const int64_t j = row0 + r;
    if (lane == 0 && j < J) {
      best[j] = i;
      best_cost[j] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launch errors (too many threads, a bad configuration) never run and are
// not reported by a later synchronize: every entry returns
// cudaGetLastError() right after its launch.

int repro_cost_matrix_f32(const float* jb, const float* jw, const float* wc,
                          const float* wd, const float* site_rows, float* out,
                          int64_t J, int64_t S, float wq, float ww, float wl,
                          void* stream) {
  const dim3 block(kTileSites, kTileRows);
  const dim3 grid((unsigned)((J + kTileJobs - 1) / kTileJobs),
                  (unsigned)((S + kTileSites - 1) / kTileSites));
  cost_matrix_f32_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      jb, jw, wc, wd, site_rows, out, J, S, wq, ww, wl);
  return (int)cudaGetLastError();
}

int repro_cost_matrix_f64(const double* bytes, const double* work,
                          const int8_t* cls, const double* site_rows,
                          const uint8_t* alive, double* out, int64_t J,
                          int64_t S, double wq, double ww, double wl,
                          int mask_dead, void* stream) {
  const dim3 block(kTileSites, kTileRows);
  const dim3 grid((unsigned)((J + kTileJobs - 1) / kTileJobs),
                  (unsigned)((S + kTileSites - 1) / kTileSites));
  cost_matrix_f64_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      bytes, work, cls, site_rows, alive, out, J, S, wq, ww, wl, mask_dead);
  return (int)cudaGetLastError();
}

int repro_cost_argmin_f64(const double* bytes, const double* work,
                          const int8_t* cls, const double* site_rows,
                          const uint8_t* alive, int64_t* best,
                          double* best_cost, int64_t J, int64_t S, double wq,
                          double ww, double wl, void* stream) {
  const dim3 grid((unsigned)((J + kArgminRows - 1) / kArgminRows));
  cost_argmin_f64_kernel<<<grid, kArgminThreads, 0, (cudaStream_t)stream>>>(
      bytes, work, cls, site_rows, alive, best, best_cost, J, S, wq, ww, wl);
  return (int)cudaGetLastError();
}

// Shared by every kernel of the library: the text of a CUDA error code.
const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
