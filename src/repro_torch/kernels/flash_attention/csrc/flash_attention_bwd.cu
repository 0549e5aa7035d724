// Blocked flash attention, backward, for Hopper (sm_90a).
//
// No Pallas twin: the reference differentiates its jnp attention
// (src/repro/models/attention.py) and has no backward kernel. This is the
// gradient of the forward kernel flash_attention.cu, which replaces the
// TPU kernel src/repro/kernels/flash_attention/flash_attention.py:72
// (flash_attention_pallas): causal / sliding-window GQA attention with a
// tanh soft-cap and the caller's scale. Given q, k, v, the forward's
// output o, its row log-sum-exp lse and the output's gradient dO it returns
//   s = q k^T scale, t = cap tanh(s / cap) (t = s without a cap),
//   P = exp(mask(t) - lse), Delta_i = sum_d dO_i o_i, dP = dO v^T,
//   dT = P (dP - Delta), dS = dT (1 - (t / cap)^2) (dS = dT without a cap),
//   dq = dS k scale, dk = dS^T q scale, dv = P^T dO,
// with dk and dv summed over the rep = H / KV query heads of each kv head
// (query head h reads kv head h / rep). Every sum is in float32; inputs
// and outputs are the model's type (float32 or bfloat16).
//
// Layout: q (B, Sq, H, DQK) and k, v (B, Sk, KV, DQK / DV) are read
// through their strides, as the forward reads them (k and v share theirs:
// MLA's are two column ranges of one buffer, the wrapper's padded route
// builds them so); o and dO are contiguous (B, Sq, H, DV); dq
// (B, Sq, H, DQK), dk (B, Sk, KV, DQK) and dv (B, Sk, KV, DV) are written
// contiguous. lse is the forward's (B, H, Sq) float32 output and delta a
// float32 scratch of the same shape, both with row stride Sq rounded up
// to 4 (lse_stride).
//
// Bound on an H100: operations. The function needs five products a
// (query, key) pair and head (S, dP, dV, dQ, dK): 2 (3 DQK + 2 DV)
// operations. gemma2-9b's global training layer (B 1, S 8192, H 16 /
// KV 8, D 256, bf16, causal) needs 1.3745e12 of them, 1.39 ms at 989
// TFLOP/s, against 0.2 GB of inputs and outputs (0.06 ms at 3.35 TB/s).
// Only wgmma reaches that rate.
//
// bfloat16 (the training type): three kernels on one stream, no atomics
// (every output element has one writer and a fixed order of sums, so the
// gradients are the same bits on every call).
//  * Delta: one warp a row of o and dO.
//  * Kernel A (dq), a block per (b, h, 128 query rows), is the forward's
//    shape: a producer warpgroup loads the query tile and its dO rows once
//    and then each visible tile of 64 keys (K and V) by TMA into a ring;
//    two consumer warpgroups of 64 rows each run S = Q K^T and
//    dP = dO V^T as one group of shared-memory wgmmas, rebuild
//    P = exp2(t2 - lse2) in registers with the forward's own fold (t2 =
//    tanh.approx(s · scale / cap) · cap · log2 e, or s · scale · log2 e)
//    from the forward's lse, so a row of P sums to 1 as the forward's
//    did, form dS · scale, round it to bf16 as the register A operand
//    (the accumulator layout is the A-fragment layout) and add dS K to
//    the float32 dq accumulator (K's tile is the MN-major B operand).
//  * Kernel B (dk, dv), a block per (b, kv head, 64 keys), holds its K
//    and V tiles in shared memory; the producer walks the rep query heads
//    and the query tiles of 64 rows that can see the keys, loading Q, dO
//    and their rows of lse and Delta by TMA into a two-stage ring. It
//    computes transposed tiles (S^T = K Q^T, dP^T = V dO^T), so P^T and
//    dS^T come out in registers, rows = keys, as the A operand of
//    dV += P^T dO and dK += dS^T Q with Q and dO as MN-major B operands:
//    nothing is transposed through shared memory. dK and dV for 64 keys
//    at D 256 are 2 x 64 KB of float32 accumulators, more than one
//    warpgroup holds, so consumer warpgroup 1 owns dV and warpgroup 2 dK,
//    128 accumulator registers a thread each at D 256, two products each:
//    warpgroup 1 runs S^T, rebuilds P^T (tanh and exp2 on the SFU), hands
//    P^T · (1 - (t/cap)^2) in float32 to warpgroup 2 through one of two
//    64 x 64 shared buffers (named barriers: written, read) and adds
//    P^T dO; warpgroup 2 runs dP^T, forms dS^T · scale from the handed P
//    and adds dS^T Q. S^T is computed once and the SFU work is done once.
//    That is 3 + 4 = 7 products a pair where 5 would do with atomics;
//    kernel A's S and dP are the two recomputed.
//  * Budget: kernel A at D 256: Q and dO 64 + 64 KB and one stage of K
//    and V, 64 KB (two stages of 64 keys do not fit the 227 KB opt-in; a
//    two-stage ring of 32-key tiles was no faster on the H100; two stages
//    at every other width); kernel B at D 256: K and V 64 KB, two stages
//    of Q and dO 128 KB and the P buffers 32 KB, 226 KB. setmaxnreg gives
//    the consumers 240 registers and the producer 24; ptxas reports 168
//    registers a thread at launch for every bf16 instance and 0 bytes of
//    spills.
//
// float32 (the oracle's type) stays on the CUDA cores (explicit fmaf; the
// library is built with -fmad=false): kernel A, one block per (b, h,
// query tile of 32 rows), computes Delta and walks the key tiles the tile
// can see once for dq with P = exp(t - lse) from the forward's lse; kernel
// B, one block per (b, kv head, key tile of 32 keys), keeps K and V in
// shared memory and walks the rep query heads and the query tiles that
// see it. A thread owns a 2 x 2 block of scores (rows ty, ty + 16; keys
// tx, tx + 16) and a row slice of its output tile.

#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // the forward's, (B, H, lse_stride(Sq))
  float* delta;      // scratch, the same shape
  int B, H, KV, Sq, Sk;
  int64_t q_sb, q_ss, q_sh;     // q strides (elements): batch, sequence, head
  int64_t kv_sb, kv_ss, kv_sh;  // k and v strides (the same for both)
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int BQ = 32, BK = 32;
constexpr int LDS = BK + 1;  // rows of the score tiles, padded

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

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

// Kernel A: Delta and dq of one (b, h, query tile).
template <int DQK, int DV>
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
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kv_sb + g * p.kv_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.kv_sb + g * p.kv_sh;
  const int64_t o_row = (int64_t)p.H * DV;  // o and dO are contiguous
  const float* og = static_cast<const float*>(p.o) + (int64_t)b * p.Sq * o_row + h * DV;
  const float* dog = static_cast<const float*>(p.dout) + (int64_t)b * p.Sq * o_row + h * DV;
  const int64_t row_base = ((int64_t)b * p.H + h) * lse_stride(p.Sq);

  load_rows<float, DQK>(Qs, LD, qg, p.q_ss, q0, BQ, p.Sq);
  load_rows<float, DV>(dOs, LDV, dog, o_row, q0, BQ, p.Sq);
  __syncthreads();

  // Delta of row i = tid / 8, over eight lanes; lse of the row.
  const int i = tid >> 3, lane8 = tid & 7;
  {
    float d = 0.f;
    if (q0 + i < p.Sq) {
      const float* orow = og + (int64_t)(q0 + i) * o_row;
      for (int c = lane8; c < DV; c += 8) d = fmaf(dOs[i * LDV + c], orow[c], d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (lane8 == 0) {
      const bool in = q0 + i < p.Sq;
      delta_s[i] = d;
      lse_s[i] = in ? p.lse[row_base + q0 + i] : 0.f;
      if (in) p.delta[row_base + q0 + i] = d;
    }
  }

  // The key tiles some row of [q0, q0 + BQ) can see.
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;

  // dS of every visible pair, then dq += dS K scale.
  const int ty = tid >> 4, tx = tid & 15;
  float acc[NQ];
#pragma unroll
  for (int n = 0; n < NQ; ++n) acc[n] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<float, DQK>(Ks, LD, kg, p.kv_ss, k0, BK, p.Sk);
    load_rows<float, DV>(Vs, LDV, vg, p.kv_ss, k0, BK, p.Sk);
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
        if (visible(q0 + row, k0 + col, p.Sq, p.Sk, p.causal, p.window)) {
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
    float* dqg = static_cast<float*>(p.dq) + (((int64_t)b * p.Sq + q0 + i) * p.H + h) * DQK;
#pragma unroll
    for (int n = 0; n < NQ; ++n) st(dqg + lane8 + 8 * n, acc[n]);
  }
}

// Kernel B: dk and dv of one (b, kv head, key tile).
template <int DQK, int DV>
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
  const float* kg = static_cast<const float*>(p.k) + b * p.kv_sb + g * p.kv_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.kv_sb + g * p.kv_sh;
  const int64_t o_row = (int64_t)p.H * DV;

  load_rows<float, DQK>(Ks, LD, kg, p.kv_ss, k0, BK, p.Sk);
  load_rows<float, DV>(Vs, LDV, vg, p.kv_ss, k0, BK, p.Sk);

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
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dog = static_cast<const float*>(p.dout) + (int64_t)b * p.Sq * o_row + h * DV;
    const int64_t row_base = ((int64_t)b * p.H + h) * lse_stride(p.Sq);
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();
      load_rows<float, DQK>(Qs, LD, qg, p.q_ss, q0, BQ, p.Sq);
      load_rows<float, DV>(dOs, LDV, dog, o_row, q0, BQ, p.Sq);
      if (tid < BQ) {
        const bool in = q0 + tid < p.Sq;
        lse_s[tid] = in ? p.lse[row_base + q0 + tid] : 0.f;
        delta_s[tid] = in ? p.delta[row_base + q0 + tid] : 0.f;
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
          if (visible(q0 + row, k0 + col, p.Sq, p.Sk, p.causal, p.window)) {
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
    float* dkg = static_cast<float*>(p.dk) + row * DQK;
    float* dvg = static_cast<float*>(p.dv) + row * DV;
#pragma unroll
    for (int n = 0; n < NK; ++n) st(dkg + lane8 + 8 * n, dk[n]);
#pragma unroll
    for (int n = 0; n < NV; ++n) st(dvg + lane8 + 8 * n, dv[n]);
  }
}

template <int DQK, int DV>
int launch_f32(const Params& p, void* stream) {
  using Tl = Tiles<DQK, DV>;
  auto ka = flash_bwd_dq_kernel<DQK, DV>;
  auto kb = flash_bwd_dkv_kernel<DQK, DV>;
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma with TMA rings
// ---------------------------------------------------------------------------

struct BwdTma {
  CUtensorMap tq, tdo, tk, tv;  // rank 4: (DQK or DV, S, heads, B), innermost first
  CUtensorMap tlse, tdl;        // rank 3: (Sq, H, B), float32 (kernel B)
  void* dq;
  void* dk;
  void* dv;
  const float* lse;
  const float* delta;
  int H, KV, rep, Sq, Sk, causal, window;
  float qk_scale;  // scale · log2 e, or scale / softcap with a soft-cap (the forward's fold)
  float cap_log2;  // softcap · log2 e, or 0 without one
  float scale;
};

// Delta = rowsum(dO o) of every (b, q, h) row: one warp a row.
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const bf16* o, const bf16* dout,
                                                              float* delta, int B, int Sq, int H,
                                                              int DV) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)B * Sq * H) return;
  const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(o + row * DV);
  const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(dout + row * DV);
  float d = 0.f;
  for (int c = lane; c < DV / 2; c += 32) {
    const float2 a = __bfloat1622float2(orow[c]), g = __bfloat1622float2(drow[c]);
    d = fmaf(a.x, g.x, d);
    d = fmaf(a.y, g.y, d);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) d += __shfl_xor_sync(0xffffffffu, d, m);
  if (lane == 0) {
    const int h = (int)(row % H), qp = (int)((row / H) % Sq), b = (int)(row / ((int64_t)H * Sq));
    delta[((int64_t)b * H + h) * lse_stride(Sq) + qp] = d;
  }
}

// Kernel A's tiles: 128 query rows (two consumer warpgroups of 64) with
// their dO rows, and a ring of 64-key K and V tiles.
template <int DQK, int DV>
struct TilesA {
  using X = Boxes<DQK>;
  static_assert(DV % X::BW == 0 && DV <= DQK, "unsupported (DQK, DV)");
  static constexpr int BQ = 128, BK = 64, THREADS = 384;
  static constexpr int STAGES = DQK + DV > 320 ? 1 : 2;
  static constexpr int NBQ = DQK / X::BW, NBV = DV / X::BW;
  static constexpr int Q_BYTES = BQ * DQK * 2, DO_BYTES = BQ * DV * 2;
  static constexpr int K_BYTES = BK * DQK * 2, V_BYTES = BK * DV * 2;
  static constexpr int Q_OFF = 0, DO_OFF = Q_BYTES, K_OFF = DO_OFF + DO_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES, BAR_OFF = V_OFF + STAGES * V_BYTES;
  // + the barriers (q_full, full[STAGES], empty[STAGES]) + slack to align
  // the base to the 1024-byte swizzle period
  static constexpr size_t bytes() { return (size_t)BAR_OFF + 8 * (1 + 2 * STAGES) + 1024; }
};

// Kernel B's tiles: 64 keys of K and V, a ring of 64-row Q and dO tiles
// with their rows of lse and Delta, and two float32 64 x 64 buffers
// through which the dV warpgroup hands P (times the soft-cap's
// 1 - (t / cap)^2) to the dK warpgroup.
template <int DQK, int DV>
struct TilesB {
  using X = Boxes<DQK>;
  static_assert(DV % X::BW == 0 && DV <= DQK, "unsupported (DQK, DV)");
  static constexpr int BK = 64, BQ = 64, THREADS = 384, STAGES = 2;
  static constexpr int NBQ = DQK / X::BW, NBV = DV / X::BW;
  static constexpr int K_BYTES = BK * DQK * 2, V_BYTES = BK * DV * 2;
  static constexpr int Q_BYTES = BQ * DQK * 2, DO_BYTES = BQ * DV * 2, ROW_BYTES = BQ * 4;
  static constexpr int PC_BYTES = BK * BQ * 4;
  static constexpr int K_OFF = 0, V_OFF = K_BYTES, Q_OFF = V_OFF + V_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES, PC_OFF = DO_OFF + STAGES * DO_BYTES;
  static constexpr int L_OFF = PC_OFF + 2 * PC_BYTES, D_OFF = L_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = D_OFF + STAGES * ROW_BYTES;
  // + the barriers (kv_full, full[STAGES], empty[STAGES]) + slack
  static constexpr size_t bytes() { return (size_t)BAR_OFF + 8 * (1 + 2 * STAGES) + 1024; }
};

// Named barriers (0 is __syncthreads) between kernel B's two consumer
// warpgroups: P buffer b written (PC_FULL + b), read (PC_EMPTY + b).
constexpr int PC_FULL = 1, PC_EMPTY = 3;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int DQK, int DV>
__global__ void __launch_bounds__(384, 1) flash_bwd_dq_bf16_kernel(const __grid_constant__ BwdTma p) {
  using T = TilesA<DQK, DV>;
  using X = Boxes<DQK>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES, BW = X::BW, RB = X::RB;
  constexpr int NBQ = T::NBQ, NBV = T::NBV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + T::Q_OFF, sDO = base + T::DO_OFF;
  const uint32_t sK = base + T::K_OFF, sV = base + T::V_OFF;
  const uint32_t q_full = base + T::BAR_OFF;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + ST + s); };

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.rep;
  // The key range [kb, ke) some row of the tile can see, kb on a key tile.
  const int ke = p.causal ? min(p.Sk, min(q0 + BQ, p.Sq)) : p.Sk;
  const int kb = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const int nt = (ke - kb + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES + T::DO_BYTES);
      for (int j = 0; j < NBQ; ++j) tma_load_4d(sQ + j * BQ * RB, &p.tq, q_full, j * BW, q0, h, b);
      for (int j = 0; j < NBV; ++j) tma_load_4d(sDO + j * BQ * RB, &p.tdo, q_full, j * BW, q0, h, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, k0 = kb + t * BK;
        mbar_wait(empty(s), ((t / ST) & 1) ^ 1);  // the first pass over the ring finds it free
        mbar_expect_tx(full(s), T::K_BYTES + T::V_BYTES);
        for (int j = 0; j < NBQ; ++j)
          tma_load_4d(sK + s * T::K_BYTES + j * BK * RB, &p.tk, full(s), j * BW, k0, g, b);
        for (int j = 0; j < NBV; ++j)
          tma_load_4d(sV + s * T::V_BYTES + j * BK * RB, &p.tv, full(s), j * BW, k0, g, b);
      }
    }
  } else {
    // Consumer warpgroup c: query rows qw0 … qw0 + 63. Thread (warp,
    // lane) holds rows row0 and row0 + 8 and, in each 8-column block of
    // an accumulator, columns col and col + 1 (the wgmma m64nN layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    constexpr int NO = DQK < 64 ? 1 : DQK / 64;  // dq chunks of 64 columns (one of 32 at DQK 32)
    constexpr int OW = DQK < 64 ? 16 : 32;       // accumulator registers a chunk
    const int c = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int qw0 = q0 + 64 * c;
    const int row0 = qw0 + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);
    const uint32_t qa = sQ + 64 * c * RB, da = sDO + 64 * c * RB;  // this warpgroup's rows
    const bool capped = p.cap_log2 > 0.f;
    const int64_t row_base = ((int64_t)b * p.H + h) * lse_stride(p.Sq);
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      lse2[r] = qp < p.Sq ? p.lse[row_base + qp] * kLog2e : 0.f;
      dl[r] = qp < p.Sq ? p.delta[row_base + qp] : 0.f;
    }
    float dq[NO][OW];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < OW; ++i) dq[n][i] = 0.f;

    // The visible tiles are [t_lo, t_hi): a window hides a prefix of the
    // block's tiles from this warpgroup, the diagonal a suffix.
    int t_lo = 0, t_hi = 0;
    if (qw0 < p.Sq) {
      t_hi = p.causal ? min(nt, (qw0 + 63 - kb) / BK + 1) : nt;
      const int x = qw0 - p.window + 2 - BK - kb;  // first t with its last key ≥ qw0 − window + 1
      if (p.window > 0 && x > 0) t_lo = min(t_hi, (x + BK - 1) / BK);
    }
    // A tile none of this warpgroup's rows can see: released unread.
    auto release = [&](int t) {
      mbar_wait(full(t % ST), (t / ST) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(t % ST));
    };

    mbar_wait(q_full, 0);
    for (int t = 0; t < t_lo; ++t) release(t);
    for (int t = t_lo; t < t_hi; ++t) {
      const int st = t % ST;
      mbar_wait(full(st), (t / ST) & 1);
      const uint32_t ks = sK + st * T::K_BYTES, vs = sV + st * T::V_BYTES;
      // S = Q K^T and dP = dO V^T, both operands K-major in shared memory.
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int j = 0; j < NBQ; ++j)
#pragma unroll
        for (int kk = 0; kk < BW / 16; ++kk)
          wgmma_ss_n64(s, gmma_desc(qa + j * BQ * RB + kk * 32, 16, X::ATOM, X::SWIZZLE),
                       gmma_desc(ks + j * BK * RB + kk * 32, 16, X::ATOM, X::SWIZZLE), j + kk);
#pragma unroll
      for (int j = 0; j < NBV; ++j)
#pragma unroll
        for (int kk = 0; kk < BW / 16; ++kk)
          wgmma_ss_n64(dp, gmma_desc(da + j * BQ * RB + kk * 32, 16, X::ATOM, X::SWIZZLE),
                       gmma_desc(vs + j * BK * RB + kk * 32, 16, X::ATOM, X::SWIZZLE), j + kk);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);
      // dS · scale in bf16 A fragments of the four 16-key steps.
      const int k0 = kb + t * BK;
      const bool edge = k0 + BK > p.Sk || qw0 + 63 >= p.Sq || (p.causal && k0 + BK - 1 > qw0) ||
                        (p.window > 0 && k0 <= qw0 + 63 - p.window);
      uint32_t fa[BK / 16][4];
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jb + 2 * r + e;
            const float x = s[i] * p.qk_scale;
            const float u = capped ? tanh_approx(x) : 0.f;
            float pr = ex2((capped ? u * p.cap_log2 : x) - lse2[r]);
            if (edge && !visible(row0 + 8 * r, k0 + 8 * jb + col + e, p.Sq, p.Sk, p.causal, p.window))
              pr = 0.f;
            float ds = pr * (dp[i] - dl[r]);
            if (capped) ds *= 1.f - u * u;
            v2[e] = ds * p.scale;
          }
          fa[jb / 2][(jb % 2) * 2 + r] = pack_bf16(v2[0], v2[1]);
        }
      // dq += dS K: K's tile is the MN-major B operand.
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs(dq[n]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const uint64_t dk = gmma_desc(ks + n * BK * RB + kk * 16 * RB, BK * RB, X::ATOM, X::SWIZZLE);
          if constexpr (DQK < 64) {
            wgmma_rs_n32(dq[n], fa[kk], dk);
          } else {
            wgmma_rs_n64(dq[n], fa[kk], dk);
          }
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs(dq[n]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_frags(fa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    for (int t = t_hi; t < nt; ++t) release(t);

    bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < OW; i += 2) {
        const int qp = row0 + 8 * ((i >> 1) & 1);
        if (qp < p.Sq)
          *reinterpret_cast<uint32_t*>(dqg + (((int64_t)b * p.Sq + qp) * p.H + h) * DQK + n * 64 +
                                       8 * (i >> 2) + col) = pack_bf16(dq[n][i], dq[n][i + 1]);
      }
  }
}

// One consumer warpgroup of kernel B, for the block's 64 keys. DK false:
// S^T = K Q^T, P^T from the forward's lse, P^T · (1 - (t/cap)^2) handed
// to the other warpgroup through shared memory, dV += P^T dO. DK true:
// dP^T = V dO^T, dS^T · scale from the handed P, dK += dS^T Q. Two
// products each.
template <int DQK, int DV, bool DK>
__device__ __forceinline__ void dkv_consumer(const BwdTma& p, uint32_t base, unsigned char* sgen,
                                             int k0, int g, int b, int q_begin, int nqt) {
  using T = TilesB<DQK, DV>;
  using X = Boxes<DQK>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES, BW = X::BW, RB = X::RB;
  constexpr int NB = DK ? T::NBV : T::NBQ;    // boxes of the first product's K dimension
  constexpr int W = DK ? DQK : DV;            // the output's width
  constexpr int NO = W < 64 ? 1 : W / 64;     // chunks of 64 columns (one of 32 at 32)
  constexpr int OW = W < 64 ? 16 : 32;        // accumulator registers a chunk
  const uint32_t full0 = base + T::BAR_OFF + 8, empty0 = full0 + 8 * ST;
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const int r0 = 16 * warp + lane / 4;        // this thread's tile rows r0, r0 + 8 (keys k0 + r0, …)
  const int col = 2 * (lane % 4);
  const bool capped = p.cap_log2 > 0.f;
  // The P hand-over buffers: row r, column 8 jb + c at r · 64 + 8 (jb ^ (r % 8)) + c
  // (the XOR keeps a half-warp's float2 stores and loads off each other's banks).
  float* pc_all = reinterpret_cast<float*>(sgen + T::PC_OFF);
  auto pc_at = [&](float* pc, int r, int jb) { return pc + r * BQ + ((jb ^ (r & 7)) << 3) + col; };

  float acc[NO][OW];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < OW; ++i) acc[n][i] = 0.f;

  const int T_all = p.rep * nqt;
  for (int t = 0; t < T_all; ++t) {
    const int st = t % ST;
    const int q0 = q_begin + (t % nqt) * BQ;
    mbar_wait(full0 + 8 * st, (t / ST) & 1);
    const uint32_t qs = base + T::Q_OFF + st * T::Q_BYTES, dos = base + T::DO_OFF + st * T::DO_BYTES;
    // S^T = K Q^T or dP^T = V dO^T, both operands K-major in shared memory.
    const uint32_t sa = base + (DK ? T::V_OFF : T::K_OFF), sb = DK ? dos : qs;
    float s[32];
    wg_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int kk = 0; kk < BW / 16; ++kk)
        wgmma_ss_n64(s, gmma_desc(sa + j * BK * RB + kk * 32, 16, X::ATOM, X::SWIZZLE),
                     gmma_desc(sb + j * BQ * RB + kk * 32, 16, X::ATOM, X::SWIZZLE), j + kk);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    // P^T (DK false) or dS^T · scale (DK true) in bf16 A fragments of the
    // four 16-row steps; columns are query rows.
    float* pc = pc_all + (t & 1) * (BK * BQ);
    uint32_t fa[BQ / 16][4];
    if constexpr (!DK) {
      const float* lse_s = reinterpret_cast<const float*>(sgen + T::L_OFF + st * T::ROW_BYTES);
      const bool edge = q0 + BQ > p.Sq || k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0) ||
                        (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
      if (t >= 2) named_sync(PC_EMPTY + (t & 1));  // the dK warpgroup has read this buffer's last P
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * jb + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pr[2], pcv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jb + 2 * r + e;
            const float x = s[i] * p.qk_scale;
            const float u = capped ? tanh_approx(x) : 0.f;
            pr[e] = ex2((capped ? u * p.cap_log2 : x) - (e ? l2.y : l2.x) * kLog2e);
            if (edge && !visible(q0 + 8 * jb + col + e, k0 + r0 + 8 * r, p.Sq, p.Sk, p.causal, p.window))
              pr[e] = 0.f;
            pcv[e] = capped ? pr[e] * (1.f - u * u) : pr[e];
          }
          *reinterpret_cast<float2*>(pc_at(pc, r0 + 8 * r, jb)) = make_float2(pcv[0], pcv[1]);
          fa[jb / 2][(jb % 2) * 2 + r] = pack_bf16(pr[0], pr[1]);
        }
      }
      named_arrive(PC_FULL + (t & 1));
    } else {
      const float* dl_s = reinterpret_cast<const float*>(sgen + T::D_OFF + st * T::ROW_BYTES);
      named_sync(PC_FULL + (t & 1));  // the dV warpgroup has written this tile's P
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * jb + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pcv = *reinterpret_cast<const float2*>(pc_at(pc, r0 + 8 * r, jb));
          const int i = 4 * jb + 2 * r;
          fa[jb / 2][(jb % 2) * 2 + r] = pack_bf16(pcv.x * (s[i] - d2.x) * p.scale,
                                                   pcv.y * (s[i + 1] - d2.y) * p.scale);
        }
      }
      if (t + 2 < T_all) named_arrive(PC_EMPTY + (t & 1));  // a later tile reuses the buffer
    }
    // dK += dS^T Q or dV += P^T dO: Q's or dO's tile is the MN-major B operand.
    const uint32_t bs = DK ? qs : dos;
#pragma unroll
    for (int n = 0; n < NO; ++n) fence_regs(acc[n]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const uint64_t db = gmma_desc(bs + n * BQ * RB + kk * 16 * RB, BQ * RB, X::ATOM, X::SWIZZLE);
        if constexpr (W < 64) {
          wgmma_rs_n32(acc[n], fa[kk], db);
        } else {
          wgmma_rs_n64(acc[n], fa[kk], db);
        }
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int n = 0; n < NO; ++n) fence_regs(acc[n]);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) fence_frags(fa[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  bf16* out = static_cast<bf16*>(DK ? p.dk : p.dv);
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < OW; i += 2) {
      const int kp = k0 + r0 + 8 * ((i >> 1) & 1);
      if (kp < p.Sk)
        *reinterpret_cast<uint32_t*>(out + (((int64_t)b * p.Sk + kp) * p.KV + g) * W + n * 64 +
                                     8 * (i >> 2) + col) = pack_bf16(acc[n][i], acc[n][i + 1]);
    }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(384, 1) flash_bwd_dkv_bf16_kernel(const __grid_constant__ BwdTma p) {
  using T = TilesB<DQK, DV>;
  using X = Boxes<DQK>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES, BW = X::BW, RB = X::RB;
  constexpr int NBQ = T::NBQ, NBV = T::NBV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sgen = smem_raw + (base - raw);
  const uint32_t kv_full = base + T::BAR_OFF;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + ST + s); };

  const int k0 = (int)blockIdx.x * BK;  // causal: the first key tiles see the most rows
  const int g = blockIdx.y, b = blockIdx.z;
  // The query tiles that can see some key of [k0, k0 + BK): causal rows
  // start at k0 (BQ = BK, so on a tile), a window ends them.
  const int k_last = min(k0 + BK, p.Sk) - 1;
  const int q_begin = p.causal ? k0 : 0;
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  const int nqt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, T::K_BYTES + T::V_BYTES);
      for (int j = 0; j < NBQ; ++j)
        tma_load_4d(base + T::K_OFF + j * BK * RB, &p.tk, kv_full, j * BW, k0, g, b);
      for (int j = 0; j < NBV; ++j)
        tma_load_4d(base + T::V_OFF + j * BK * RB, &p.tv, kv_full, j * BW, k0, g, b);
      for (int t = 0; t < p.rep * nqt; ++t) {
        const int s = t % ST, h = g * p.rep + t / nqt, q0 = q_begin + (t % nqt) * BQ;
        mbar_wait(empty(s), ((t / ST) & 1) ^ 1);  // the first pass over the ring finds it free
        mbar_expect_tx(full(s), T::Q_BYTES + T::DO_BYTES + 2 * T::ROW_BYTES);
        for (int j = 0; j < NBQ; ++j)
          tma_load_4d(base + T::Q_OFF + s * T::Q_BYTES + j * BQ * RB, &p.tq, full(s), j * BW, q0, h, b);
        for (int j = 0; j < NBV; ++j)
          tma_load_4d(base + T::DO_OFF + s * T::DO_BYTES + j * BQ * RB, &p.tdo, full(s), j * BW, q0, h,
                      b);
        tma_load_3d(base + T::L_OFF + s * T::ROW_BYTES, &p.tlse, full(s), q0, h, b);
        tma_load_3d(base + T::D_OFF + s * T::ROW_BYTES, &p.tdl, full(s), q0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    mbar_wait(kv_full, 0);
    if (threadIdx.x < 256)
      dkv_consumer<DQK, DV, false>(p, base, sgen, k0, g, b, q_begin, nqt);
    else
      dkv_consumer<DQK, DV, true>(p, base, sgen, k0, g, b, q_begin, nqt);
  }
}

template <int DQK, int DV>
int launch_bf16(const Params& p, void* stream) {
  using TA = TilesA<DQK, DV>;
  using TB = TilesB<DQK, DV>;
  constexpr int BW = Boxes<DQK>::BW;
  // Runtime calls first: they make the device's primary context current
  // in a host thread that has made none yet (an autograd worker whose
  // first operation this is), which the driver's tensor-map encoder needs.
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TA::bytes());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TB::bytes());
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int64_t o_ss = (int64_t)p.H * DV, o_sb = (int64_t)p.Sq * o_ss;  // o and dO contiguous
  BwdTma a, kb;
  if (!encode(fn, &a.tq, p.q, DQK, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, BW, TA::BQ) ||
      !encode(fn, &a.tdo, p.dout, DV, p.Sq, p.H, p.B, o_ss, DV, o_sb, BW, TA::BQ) ||
      !encode(fn, &a.tk, p.k, DQK, p.Sk, p.KV, p.B, p.kv_ss, p.kv_sh, p.kv_sb, BW, TA::BK) ||
      !encode(fn, &a.tv, p.v, DV, p.Sk, p.KV, p.B, p.kv_ss, p.kv_sh, p.kv_sb, BW, TA::BK) ||
      !encode(fn, &kb.tq, p.q, DQK, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, BW, TB::BQ) ||
      !encode(fn, &kb.tdo, p.dout, DV, p.Sq, p.H, p.B, o_ss, DV, o_sb, BW, TB::BQ) ||
      !encode(fn, &kb.tk, p.k, DQK, p.Sk, p.KV, p.B, p.kv_ss, p.kv_sh, p.kv_sb, BW, TB::BK) ||
      !encode(fn, &kb.tv, p.v, DV, p.Sk, p.KV, p.B, p.kv_ss, p.kv_sh, p.kv_sb, BW, TB::BK) ||
      !encode_rows_f32(fn, &kb.tlse, p.lse, p.Sq, p.H, p.B, TB::BQ) ||
      !encode_rows_f32(fn, &kb.tdl, p.delta, p.Sq, p.H, p.B, TB::BQ))
    return (int)cudaErrorInvalidValue;
  a.tlse = kb.tlse;
  a.tdl = kb.tdl;
  auto fill = [&](BwdTma& t) {
    t.dq = p.dq; t.dk = p.dk; t.dv = p.dv;
    t.lse = p.lse; t.delta = p.delta;
    t.H = p.H; t.KV = p.KV; t.rep = p.H / p.KV; t.Sq = p.Sq; t.Sk = p.Sk;
    t.causal = p.causal; t.window = p.window;
    t.qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * kLog2e;
    t.cap_log2 = p.softcap > 0.f ? p.softcap * kLog2e : 0.f;
    t.scale = p.scale;
  };
  fill(a);
  fill(kb);
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = (int64_t)p.B * p.Sq * p.H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(p.o), static_cast<const bf16*>(p.dout), p.delta, p.B, p.Sq, p.H, DV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a((unsigned)((p.Sq + TA::BQ - 1) / TA::BQ), (unsigned)p.H, (unsigned)p.B);
  flash_bwd_dq_bf16_kernel<DQK, DV><<<grid_a, TA::THREADS, TA::bytes(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((unsigned)((p.Sk + TB::BK - 1) / TB::BK), (unsigned)p.KV, (unsigned)p.B);
  flash_bwd_dkv_bf16_kernel<DQK, DV><<<grid_b, TB::THREADS, TB::bytes(), s>>>(kb);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const Params& p, int64_t D, int64_t Dv, void* stream) {
#define REPRO_BWD_CASE(DQ, DVV) \
  return BF16 ? launch_bf16<DQ, DVV>(p, stream) : launch_f32<DQ, DVV>(p, stream)
  if (D == 192 && Dv == 128) REPRO_BWD_CASE(192, 128);
  if (D != Dv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: REPRO_BWD_CASE(32, 32);
    case 64: REPRO_BWD_CASE(64, 64);
    case 128: REPRO_BWD_CASE(128, 128);
    case 256: REPRO_BWD_CASE(256, 256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

Params make_params(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, const void* lse, void* delta, int64_t B, int64_t H,
                   int64_t KV, int64_t Sq, int64_t Sk, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int causal, int64_t window,
                   float softcap, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = (int)B; p.H = (int)H; p.KV = (int)KV; p.Sq = (int)Sq; p.Sk = (int)Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.causal = causal; p.window = (int)window;
  p.softcap = softcap;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// D is q's and k's width (DQK), Dv v's, o's and dO's; scale is the
// forward's (the true head width's D^-0.5); lse the forward's row
// log-sum-exp and delta a scratch, both float32 (B, H, Sq) with row
// stride Sq rounded up to 4. Returns cudaErrorInvalidValue for a pair
// other than (32, 32), (64, 64), (128, 128), (256, 256) and (192, 128)
// (the wrapper checks it first) or views a tensor map cannot describe.
int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv, const void* lse,
                                  void* delta, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                  int64_t Sk, int64_t D, int64_t Dv, int64_t q_sb, int64_t q_ss,
                                  int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                                  int causal, int64_t window, float softcap, float scale,
                                  void* stream) {
  const Params p = make_params(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, Sq, Sk, q_sb,
                               q_ss, q_sh, kv_sb, kv_ss, kv_sh, causal, window, softcap, scale);
  return dispatch<false>(p, D, Dv, stream);
}

int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, const void* lse,
                                   void* delta, int64_t B, int64_t H, int64_t KV, int64_t Sq,
                                   int64_t Sk, int64_t D, int64_t Dv, int64_t q_sb, int64_t q_ss,
                                   int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                                   int causal, int64_t window, float softcap, float scale,
                                   void* stream) {
  const Params p = make_params(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, Sq, Sk, q_sb,
                               q_ss, q_sh, kv_sb, kv_ss, kv_sh, causal, window, softcap, scale);
  return dispatch<true>(p, D, Dv, stream);
}

}  // extern "C"
