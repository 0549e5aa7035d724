// Blocked flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas, _kernel): causal / sliding-window GQA
// attention with an online softmax (running max m, sum l and output
// accumulator in float32), tanh soft-cap, scale D^-0.5 and output
// acc / max(l, 1e-30). Query head h reads kv head h / (H / KV).
//
// Layout: q (B, Sq, H, D) and k, v (B, Sk, KV, D) are read through their
// strides (batch, sequence, head; the head dimension D contiguous), so
// the model's projections go in without a transpose; o is a contiguous
// (B, Sq, H, D). One block computes one (batch, head, query tile): it
// keeps its query tile, the current key and value tiles and the output
// accumulator in shared memory and walks the key tiles in a loop (the
// TPU kernel's sequential innermost grid axis). Key tiles that the
// causal or window mask hides from every row of the query tile are
// skipped; inside a visited tile masked scores are NEG_INF = -2e38, a
// finite value, so a row whose first visited tile is fully masked gets
// p = 1 there and the first unmasked tile wipes it (corr = 0), exactly
// as in the TPU kernel. The wrapper rejects inputs where a query row has
// no visible key at all.
//
// Two bodies:
//  * bfloat16 (the model's type): 64 x 64 tiles, QK^T and PV on the
//    tensor cores through WMMA (16x16x16 bf16 -> f32). Scores and the
//    accumulator stay float32; p is rounded to bf16 before the PV
//    product, as the TPU kernel does (p.astype(v.dtype)).
//  * float32: 32 x 32 tiles on the CUDA cores (explicit fmaf), each
//    thread owning a row slice of the accumulator in registers.
//
// Bound on an H100: operations. Causal prefill of gemma2-9b (B 1,
// S 8192, H 16, D 256, bf16) needs 2·2·B·H·S²·D/2 = 5.5e11 FLOP, 0.56 ms
// at 989 TFLOP/s, against 0.1 GB of q, k, v and o (0.03 ms at
// 3.35 TB/s). This first kernel is simple, not fast: WMMA through
// shared memory, synchronous loads, one block of 190 KB per SM; wgmma,
// TMA and a pipelined ring of tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  int64_t q_sb, q_ss, q_sh;     // q strides (elements): batch, sequence, head
  int64_t kv_sb, kv_ss, kv_sh;  // k and v strides (the same for both)
  int causal, window;
  float softcap, scale;
};

// Scaled, soft-capped, masked score of query position qp, key kp.
__device__ __forceinline__ float score(float dot, int qp, int kp, const Params& p) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  const bool ok = kp < p.Sk && (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
  return ok ? s : kNegInf;
}

// The key range [begin, end) that some row of query tile [q0, q0 + bq)
// can see; begin is rounded down to a key tile.
__device__ __forceinline__ void key_range(const Params& p, int q0, int bq, int bk, int* begin,
                                          int* end) {
  const int q_last = min(q0 + bq, p.Sq) - 1;
  int e = p.Sk;
  if (p.causal) e = min(e, q_last + 1);
  int b = 0;
  if (p.window > 0) b = max(0, q0 - p.window + 1);
  *begin = (b / bk) * bk;
  *end = e;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through WMMA
// ---------------------------------------------------------------------------

template <int D>
struct Bf16Tiles {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int LDH = D + 8;   // bf16 q/k/v rows
  static constexpr int LDS = BK + 4;  // f32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 accumulator
  static constexpr size_t bytes() {
    return (size_t)(BQ + 2 * BK) * LDH * 2 + (size_t)BQ * LDS * 4 + (size_t)BQ * LDP * 2 +
           (size_t)BQ * LDO * 4 + (size_t)BQ * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(Params p) {
  using T = Bf16Tiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LDH = T::LDH, LDS = T::LDS, LDP = T::LDP, LDO = T::LDO;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDH);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* Ls = Os + BQ * LDO;

  const int tid = threadIdx.x, warp = tid / 32;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.kv_sb + g * p.kv_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.kv_sb + g * p.kv_sh;

  for (int idx = tid; idx < BQ * VPR; idx += kThreads) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Sq) val = *reinterpret_cast<const uint4*>(qg + (int64_t)(q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * LDH + c) = val;
  }
  for (int idx = tid; idx < BQ * LDO; idx += kThreads) Os[idx] = 0.f;

  // Softmax ownership: row i, columns quarter + 4c (bank-conflict free).
  const int i = tid >> 2, quarter = tid & 3;
  const int qp = q0 + i;
  float m_i = kNegInf, l_i = 0.f;

  int k_begin, k_end;
  key_range(p, q0, BQ, BK, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's PV is done with Ks, Vs, Ps, Os
    for (int idx = tid; idx < BK * VPR; idx += kThreads) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.Sk) {
        const int64_t off = (int64_t)(k0 + r) * p.kv_ss + c;
        kv = *reinterpret_cast<const uint4*>(kg + off);
        vv = *reinterpret_cast<const uint4*>(vg + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDH + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDH + c) = vv;
    }
    __syncthreads();

    // S = Q K^T: 4 x 4 fragments of 16 x 16, two per warp.
    for (int f = warp; f < (BQ / 16) * (BK / 16); f += kThreads / 32) {
      const int rb = f / (BK / 16), cb = f % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + rb * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(fb, Ks + cb * 16 * LDH + kk, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + rb * 16 * LDS + cb * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // Online softmax over this tile for row i (four threads a row).
    float sv[BK / 4];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) {
      const int j = quarter + 4 * c;
      sv[c] = score(Ss[i * LDS + j], qp, k0 + j, p);
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) {
      const float e = expf(sv[c] - m_new);
      sum += e;
      Ps[i * LDP + quarter + 4 * c] = __float2bfloat16(e);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_i = l_i * corr + sum;
    m_i = m_new;
    for (int d = quarter; d < D; d += 4) Os[i * LDO + d] *= corr;
    __syncthreads();

    // O += P V: 4 x (D/16) fragments, spread over the warps.
    for (int f = warp; f < (BQ / 16) * (D / 16); f += kThreads / 32) {
      const int rb = f / (D / 16), cb = f % (D / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + rb * 16 * LDO + cb * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + rb * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(fb, Vs + kk * LDH + cb * 16, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + rb * 16 * LDO + cb * 16, acc, LDO, wmma::mem_row_major);
    }
  }
  if (quarter == 0) Ls[i] = l_i;
  __syncthreads();

  bf16* og = static_cast<bf16*>(p.o);
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    if (q0 + r < p.Sq) {
      const int64_t row = ((int64_t)b * p.Sq + q0 + r) * p.H + h;
      og[row * D + d] = __float2bfloat16(Os[r * LDO + d] / fmaxf(Ls[r], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct F32Tiles {
  static constexpr int BQ = 32, BK = 32;
  static constexpr int LD = D + 1;   // q/k/v rows, padded against bank conflicts
  static constexpr int LDP = BK + 1;
  static constexpr size_t bytes() { return ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * LDP) * 4; }
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Params p) {
  using T = F32Tiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, LDP = T::LDP;
  constexpr int NC = D / 8;  // accumulator columns a thread owns
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kv_sb + g * p.kv_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.kv_sb + g * p.kv_sh;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * LD + c] = q0 + r < p.Sq ? qg[(int64_t)(q0 + r) * p.q_ss + c] : 0.f;
  }

  // Row i = tid / 8 (eight lanes a row); this lane's keys and output
  // columns are lane8 + 8c.
  const int i = tid >> 3, lane8 = tid & 7;
  const int qp = q0 + i;
  float o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = 0.f;
  float m_i = kNegInf, l_i = 0.f;

  int k_begin, k_end;
  key_range(p, q0, BQ, BK, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < p.Sk;
      const int64_t off = (int64_t)(k0 + r) * p.kv_ss + c;
      Ks[r * LD + c] = in ? kg[off] : 0.f;
      Vs[r * LD + c] = in ? vg[off] : 0.f;
    }
    __syncthreads();

    float sv[BK / 8];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      const int j = lane8 + 8 * c;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[i * LD + d], Ks[j * LD + d], dot);
      sv[c] = score(dot, qp, k0 + j, p);
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      const float e = expf(sv[c] - m_new);
      sum += e;
      Ps[i * LDP + lane8 + 8 * c] = e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    l_i = l_i * corr + sum;
    m_i = m_new;
    __syncwarp();  // row i's probabilities come from the eight lanes of this warp
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float pj = Ps[i * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c] = fmaf(pj, Vs[j * LD + lane8 + 8 * c], o[c]);
    }
  }

  if (qp < p.Sq) {
    float* og = static_cast<float*>(p.o) + (((int64_t)b * p.Sq + qp) * p.H + h) * D;
    const float den = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) og[lane8 + 8 * c] = o[c] / den;
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Params& p, int bq, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + bq - 1) / bq), (unsigned)p.H, (unsigned)p.B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t H,
                   int64_t KV, int64_t Sq, int64_t Sk, int64_t D, int64_t q_sb, int64_t q_ss,
                   int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int causal,
                   int64_t window, float softcap) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = (int)B; p.H = (int)H; p.KV = (int)KV; p.Sq = (int)Sq; p.Sk = (int)Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.causal = causal; p.window = (int)window;
  p.softcap = softcap;
  p.scale = (float)(1.0 / sqrt((double)D));
  return p;
}

}  // namespace

extern "C" {

// Returns cudaErrorInvalidValue for a head dimension other than 32, 64,
// 128 or 256 (the wrapper checks it first).
int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int64_t B,
                              int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t D,
                              int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t kv_sb,
                              int64_t kv_ss, int64_t kv_sh, int causal, int64_t window,
                              float softcap, void* stream) {
  const Params p = make_params(q, k, v, o, B, H, KV, Sq, Sk, D, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                               kv_sh, causal, window, softcap);
  switch (D) {
    case 32: return launch(flash_f32_kernel<32>, F32Tiles<32>::bytes(), p, 32, stream);
    case 64: return launch(flash_f32_kernel<64>, F32Tiles<64>::bytes(), p, 32, stream);
    case 128: return launch(flash_f32_kernel<128>, F32Tiles<128>::bytes(), p, 32, stream);
    case 256: return launch(flash_f32_kernel<256>, F32Tiles<256>::bytes(), p, 32, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int64_t B,
                               int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t D,
                               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t kv_sb,
                               int64_t kv_ss, int64_t kv_sh, int causal, int64_t window,
                               float softcap, void* stream) {
  const Params p = make_params(q, k, v, o, B, H, KV, Sq, Sk, D, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                               kv_sh, causal, window, softcap);
  switch (D) {
    case 32: return launch(flash_bf16_kernel<32>, Bf16Tiles<32>::bytes(), p, 64, stream);
    case 64: return launch(flash_bf16_kernel<64>, Bf16Tiles<64>::bytes(), p, 64, stream);
    case 128: return launch(flash_bf16_kernel<128>, Bf16Tiles<128>::bytes(), p, 64, stream);
    case 256: return launch(flash_bf16_kernel<256>, Bf16Tiles<256>::bytes(), p, 64, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
