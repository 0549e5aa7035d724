// Blocked flash attention, backward, for Hopper (sm_90a).
//
// No Pallas twin: the reference differentiates its jnp attention
// (src/repro/models/attention.py) and has no backward kernel. This is the
// gradient of the forward kernel flash_attention.cu, which replaces the
// TPU kernel src/repro/kernels/flash_attention/flash_attention.py:72
// (flash_attention_pallas): causal / sliding-window GQA attention with a
// tanh soft-cap and scale DQK^-0.5. Given q, k, v, the forward's output o
// and its gradient dO it returns
//   s = q k^T scale, t = cap tanh(s / cap) (t = s without a cap),
//   P = softmax(mask(t)), Delta_i = sum_d dO_i o_i, dP = dO v^T,
//   dT = P (dP - Delta), dS = dT (1 - (t / cap)^2) (dS = dT without a cap),
//   dq = dS k scale, dk = dS^T q scale, dv = P^T dO,
// with dk and dv summed over the rep = H / KV query heads of each kv head
// (query head h reads kv head h / rep). Every sum is in float32; inputs
// and outputs are the model's type (float32 or bfloat16).
//
// Layout: q (B, Sq, H, DQK) and k, v (B, Sk, KV, DQK / DV) are read
// through their strides, as the forward reads them (k and v share theirs:
// MLA's are two column ranges of one buffer); o and dO are contiguous
// (B, Sq, H, DV); dq (B, Sq, H, DQK), dk (B, Sk, KV, DQK) and
// dv (B, Sk, KV, DV) are written contiguous. lse and delta are float32
// scratch (B, H, Sq) that kernel A writes and kernel B reads.
//
// Bound on an H100: operations. The backward does five products a
// (query, key) pair and head (S, dP, dV, dQ, dK): 2 (3 DQK + 2 DV)
// operations, 2.5x the forward's. gemma2-9b's global training layer
// (B 1, S 8192, H 16 / KV 8, D 256, bf16, causal) needs 1.3745e12 of
// them, 1.39 ms at 989 TFLOP/s, against 0.2 GB of inputs and outputs
// (0.06 ms at 3.35 TB/s).
//
// The design is the simple one: right first, fast later (ROADMAP B10).
//  * Kernel A, one block per (b, h, query tile of 32 rows), walks the
//    key tiles the tile can see twice: first for the row max and sum of
//    the masked, capped scores (an online softmax, as the forward runs
//    it; the forward keeps no statistics) and Delta, which give the row
//    log-sum-exp lse; then again for dq, with P = exp(t - lse) recomputed
//    from q and k. It writes lse and Delta for kernel B.
//  * Kernel B, one block per (b, kv head, key tile of 32 keys), keeps its
//    K and V tiles in shared memory and walks the rep query heads and,
//    for each, the query tiles that can see the key tile, recomputing S,
//    P and dP, and sums dk and dv in registers. No atomics: each output
//    element has one writer, so the gradients are the same bits on every
//    run.
//  * Both run on the CUDA cores in float32 with explicit fmaf (the
//    library is built with -fmad=false): tiles are 32 x 32, a thread owns
//    a 2 x 2 block of scores (rows ty, ty + 16; keys tx, tx + 16) and a
//    row slice of its output tile (row tid / 8, columns tid % 8 + 8 n).
//    Tiles are held as float32 rows padded by one against bank conflicts:
//    at D 256 kernel A takes 136 KB of shared memory and kernel B 140 KB
//    (the 227 KB opt-in), one block an SM. The recomputed S in kernel A's
//    first pass and kernel B make eight products a pair where five would
//    do, and the products run at most at the shared-memory rate: tensor
//    cores (wgmma), TMA loads and reusing a forward log-sum-exp are the
//    redesign's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int BQ = 32, BK = 32;
constexpr int LDS = BK + 1;  // rows of the score tiles, padded
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  float* delta;
  int B, H, KV, Sq, Sk;
  int64_t q_sb, q_ss, q_sh;     // q strides (elements): batch, sequence, head
  int64_t kv_sb, kv_ss, kv_sh;  // k and v strides (the same for both)
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  return qp < p.Sq && kp < p.Sk && (!p.causal || kp <= qp) &&
         (p.window <= 0 || qp - kp < p.window);
}

// The scaled, capped score of a dot product, and the tanh it took (0
// without a cap).
__device__ __forceinline__ float capped(float dot, const Params& p, float* u) {
  const float s = dot * p.scale;
  if (p.softcap > 0.f) {
    *u = tanhf(s / p.softcap);
    return p.softcap * *u;
  }
  *u = 0.f;
  return s;
}

// Rows [r0, r0 + rows) of a strided (B, S, heads, W) view, head fixed, into
// shared float rows of stride ldd; rows past S read as zeros.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int ldd, const T* src, int64_t row_stride,
                                          int r0, int rows, int S) {
  for (int idx = threadIdx.x; idx < rows * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    dst[r * ldd + c] = r0 + r < S ? ld(src + (int64_t)(r0 + r) * row_stride + c) : 0.f;
  }
}

// The 2 x 2 dot products of rows (ty, ty + 16) of a against rows
// (tx, tx + 16) of b, each W wide with row stride ldw.
template <int W>
__device__ __forceinline__ void dots(const float* a, const float* b, int ldw, int ty, int tx,
                                     float out[2][2]) {
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
  const float* a0 = a + ty * ldw;
  const float* a1 = a + (ty + 16) * ldw;
  const float* b0 = b + tx * ldw;
  const float* b1 = b + (tx + 16) * ldw;
#pragma unroll 8
  for (int d = 0; d < W; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    s00 = fmaf(x0, y0, s00);
    s01 = fmaf(x0, y1, s01);
    s10 = fmaf(x1, y0, s10);
    s11 = fmaf(x1, y1, s11);
  }
  out[0][0] = s00; out[0][1] = s01; out[1][0] = s10; out[1][1] = s11;
}

// Reductions over the 16 lanes (tx) that share a row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <int DQK, int DV>
struct Tiles {
  static constexpr int LD = DQK + 1, LDV = DV + 1;
  // kernel A: Q, dO, K, V, dS, then lse and Delta of each row
  static constexpr size_t bytes_a() {
    return ((size_t)(BQ + BK) * LD + (size_t)(BQ + BK) * LDV + (size_t)BQ * LDS + 2 * BQ) * 4;
  }
  // kernel B: K, V, Q, dO, P, dS, then lse and Delta of each query row
  static constexpr size_t bytes_b() {
    return ((size_t)(BQ + BK) * LD + (size_t)(BQ + BK) * LDV + 2 * (size_t)BQ * LDS + 2 * BQ) * 4;
  }
};

// ---------------------------------------------------------------------------
// Kernel A: lse, Delta and dq of one (b, h, query tile)
// ---------------------------------------------------------------------------

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = Tiles<DQK, DV>::LD, LDV = Tiles<DQK, DV>::LDV;
  constexpr int NQ = DQK / 8;  // dq columns a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LDV;
  float* Vs = Ks + BK * LD;
  float* Ss = Vs + BK * LDV;
  float* lse_s = Ss + BQ * LDS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kv_sb + g * p.kv_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.kv_sb + g * p.kv_sh;
  const int64_t o_row = (int64_t)p.H * DV;  // o and dO are contiguous
  const T* og = static_cast<const T*>(p.o) + (int64_t)b * p.Sq * o_row + h * DV;
  const T* dog = static_cast<const T*>(p.dout) + (int64_t)b * p.Sq * o_row + h * DV;
  float* lse_g = p.lse + ((int64_t)b * p.H + h) * p.Sq;
  float* delta_g = p.delta + ((int64_t)b * p.H + h) * p.Sq;

  load_rows<T, DQK>(Qs, LD, qg, p.q_ss, q0, BQ, p.Sq);
  load_rows<T, DV>(dOs, LDV, dog, o_row, q0, BQ, p.Sq);
  __syncthreads();

  // Delta of row i = tid / 8, over eight lanes.
  const int i = tid >> 3, lane8 = tid & 7;
  {
    float d = 0.f;
    if (q0 + i < p.Sq) {
      const T* orow = og + (int64_t)(q0 + i) * o_row;
      for (int c = lane8; c < DV; c += 8) d = fmaf(dOs[i * LDV + c], ld(orow + c), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (lane8 == 0) {
      delta_s[i] = d;
      if (q0 + i < p.Sq) delta_g[q0 + i] = d;
    }
  }

  // The key tiles some row of [q0, q0 + BQ) can see.
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;

  // Pass 1: row max m and sum l of exp(t - m) over the visible keys.
  const int ty = tid >> 4, tx = tid & 15;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<T, DQK>(Ks, LD, kg, p.kv_ss, k0, BK, p.Sk);
    __syncthreads();
    float s[2][2];
    dots<DQK>(Qs, Ks, LD, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q0 + ty + 16 * r;
      float t[2], u;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        t[c] = capped(s[r][c], p, &u);
        ok[c] = visible(qp, k0 + tx + 16 * c, p);
        if (ok[c]) mx = fmaxf(mx, t[c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (ok[c]) e += expf(t[c] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + row_sum(e);
      m[r] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ty + 16 * r;
      const float v = m[r] + logf(l[r]);  // -inf for a padded row, which nothing reads
      lse_s[row] = v;
      if (q0 + row < p.Sq) lse_g[q0 + row] = v;
    }
  }

  // Pass 2: dS of every visible pair, then dq += dS K scale.
  float acc[NQ];
#pragma unroll
  for (int n = 0; n < NQ; ++n) acc[n] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<T, DQK>(Ks, LD, kg, p.kv_ss, k0, BK, p.Sk);
    load_rows<T, DV>(Vs, LDV, vg, p.kv_ss, k0, BK, p.Sk);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots<DQK>(Qs, Ks, LD, ty, tx, s);
    dots<DV>(dOs, Vs, LDV, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tx + 16 * c;
        float u;
        const float t = capped(s[r][c], p, &u);
        float ds = 0.f;
        if (visible(q0 + row, k0 + col, p)) {
          ds = expf(t - lse_s[row]) * (dp[r][c] - delta_s[row]);
          if (p.softcap > 0.f) ds *= 1.f - u * u;
        }
        Ss[row * LDS + col] = ds * p.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float x = Ss[i * LDS + j];
#pragma unroll
      for (int n = 0; n < NQ; ++n) acc[n] = fmaf(x, Ks[j * LD + lane8 + 8 * n], acc[n]);
    }
  }
  if (q0 + i < p.Sq) {
    T* dqg = static_cast<T*>(p.dq) + (((int64_t)b * p.Sq + q0 + i) * p.H + h) * DQK;
#pragma unroll
    for (int n = 0; n < NQ; ++n) st(dqg + lane8 + 8 * n, acc[n]);
  }
}

// ---------------------------------------------------------------------------
// Kernel B: dk and dv of one (b, kv head, key tile)
// ---------------------------------------------------------------------------

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = Tiles<DQK, DV>::LD, LDV = Tiles<DQK, DV>::LDV;
  constexpr int NK = DQK / 8, NV = DV / 8;  // dk and dv columns a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LDV;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LDV;
  float* Ss = Ps + BQ * LDS;
  float* lse_s = Ss + BQ * LDS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int k0 = (int)blockIdx.x * BK;  // causal: the first key tiles see the most rows
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.KV;
  const T* kg = static_cast<const T*>(p.k) + b * p.kv_sb + g * p.kv_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.kv_sb + g * p.kv_sh;
  const int64_t o_row = (int64_t)p.H * DV;

  load_rows<T, DQK>(Ks, LD, kg, p.kv_ss, k0, BK, p.Sk);
  load_rows<T, DV>(Vs, LDV, vg, p.kv_ss, k0, BK, p.Sk);

  // The query rows that can see some key of [k0, k0 + BK).
  const int k_last = min(k0 + BK, p.Sk) - 1;
  const int q_begin = p.causal ? k0 / BQ * BQ : 0;
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;

  const int j = tid >> 3, lane8 = tid & 7;  // this thread's key row of dk and dv
  const int ty = tid >> 4, tx = tid & 15;
  float dk[NK], dv[NV];
#pragma unroll
  for (int n = 0; n < NK; ++n) dk[n] = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n) dv[n] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + (int64_t)b * p.Sq * o_row + h * DV;
    const float* lse_g = p.lse + ((int64_t)b * p.H + h) * p.Sq;
    const float* delta_g = p.delta + ((int64_t)b * p.H + h) * p.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();
      load_rows<T, DQK>(Qs, LD, qg, p.q_ss, q0, BQ, p.Sq);
      load_rows<T, DV>(dOs, LDV, dog, o_row, q0, BQ, p.Sq);
      if (tid < BQ) {
        const bool in = q0 + tid < p.Sq;
        lse_s[tid] = in ? lse_g[q0 + tid] : 0.f;
        delta_s[tid] = in ? delta_g[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      dots<DQK>(Qs, Ks, LD, ty, tx, s);
      dots<DV>(dOs, Vs, LDV, ty, tx, dp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = tx + 16 * c;
          float u;
          const float t = capped(s[r][c], p, &u);
          float pr = 0.f, ds = 0.f;
          if (visible(q0 + row, k0 + col, p)) {
            pr = expf(t - lse_s[row]);
            ds = pr * (dp[r][c] - delta_s[row]);
            if (p.softcap > 0.f) ds *= 1.f - u * u;
          }
          Ps[row * LDS + col] = pr;
          Ss[row * LDS + col] = ds * p.scale;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float x = Ps[i * LDS + j], y = Ss[i * LDS + j];
#pragma unroll
        for (int n = 0; n < NV; ++n) dv[n] = fmaf(x, dOs[i * LDV + lane8 + 8 * n], dv[n]);
#pragma unroll
        for (int n = 0; n < NK; ++n) dk[n] = fmaf(y, Qs[i * LD + lane8 + 8 * n], dk[n]);
      }
    }
  }
  if (k0 + j < p.Sk) {
    const int64_t row = ((int64_t)b * p.Sk + k0 + j) * p.KV + g;
    T* dkg = static_cast<T*>(p.dk) + row * DQK;
    T* dvg = static_cast<T*>(p.dv) + row * DV;
#pragma unroll
    for (int n = 0; n < NK; ++n) st(dkg + lane8 + 8 * n, dk[n]);
#pragma unroll
    for (int n = 0; n < NV; ++n) st(dvg + lane8 + 8 * n, dv[n]);
  }
}

template <typename T, int DQK, int DV>
int launch(const Params& p, void* stream) {
  using Tl = Tiles<DQK, DV>;
  auto ka = flash_bwd_dq_kernel<T, DQK, DV>;
  auto kb = flash_bwd_dkv_kernel<T, DQK, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::bytes_a());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::bytes_b());
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid_a((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.H, (unsigned)p.B);
  ka<<<grid_a, kThreads, Tl::bytes_a(), s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((unsigned)((p.Sk + BK - 1) / BK), (unsigned)p.KV, (unsigned)p.B);
  kb<<<grid_b, kThreads, Tl::bytes_b(), s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int64_t D, int64_t Dv, void* stream) {
  if (D == 192 && Dv == 128) return launch<T, 192, 128>(p, stream);
  if (D != Dv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<T, 32, 32>(p, stream);
    case 64: return launch<T, 64, 64>(p, stream);
    case 128: return launch<T, 128, 128>(p, stream);
    case 256: return launch<T, 256, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, void* lse, void* delta, int64_t B, int64_t H,
                   int64_t KV, int64_t Sq, int64_t Sk, int64_t D, int64_t q_sb, int64_t q_ss,
                   int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int causal,
                   int64_t window, float softcap) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = (int)B; p.H = (int)H; p.KV = (int)KV; p.Sq = (int)Sq; p.Sk = (int)Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.causal = causal; p.window = (int)window;
  p.softcap = softcap;
  p.scale = (float)(1.0 / sqrt((double)D));  // D = DQK, as in the forward
  return p;
}

}  // namespace

extern "C" {

// D is q's and k's width (DQK), Dv v's, o's and dO's. Returns
// cudaErrorInvalidValue for a pair other than (32, 32), (64, 64),
// (128, 128), (256, 256) and (192, 128) (the wrapper checks it first).
// Launches kernel A, then kernel B on the same stream.
int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv, void* lse,
                                  void* delta, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                  int64_t Sk, int64_t D, int64_t Dv, int64_t q_sb, int64_t q_ss,
                                  int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                                  int causal, int64_t window, float softcap, void* stream) {
  const Params p = make_params(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, Sq, Sk, D, q_sb,
                               q_ss, q_sh, kv_sb, kv_ss, kv_sh, causal, window, softcap);
  return dispatch<float>(p, D, Dv, stream);
}

int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                   int64_t Sk, int64_t D, int64_t Dv, int64_t q_sb, int64_t q_ss,
                                   int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                                   int causal, int64_t window, float softcap, void* stream) {
  const Params p = make_params(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, Sq, Sk, D, q_sb,
                               q_ss, q_sh, kv_sb, kv_ss, kv_sh, causal, window, softcap);
  return dispatch<bf16>(p, D, Dv, stream);
}

}  // extern "C"
