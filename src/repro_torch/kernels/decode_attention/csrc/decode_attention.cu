// One-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py:65
// (decode_attention_pallas, _kernel): the rep = H / KV query heads of
// one kv group against the group's cache, keys masked by kp <= pos and,
// with a window, pos - kp < window; the caller's scale (D^-0.5 of the
// true head width), tanh soft-cap, online
// softmax in float32, p rounded to the value type before the PV product,
// output acc / max(l, 1e-30).
//
// Layout: q is a contiguous (B, H, D); k and v are read through their
// strides (batch, sequence, head; D contiguous), so the model's
// (B, S, KV, D) cache goes in without the transposed copy the TPU
// wrapper makes on every call; o is a contiguous (B, H, D).
//
// The TPU kernel walks the S blocks of one (batch, group) in order. Here
// that walk is split (flash-decoding): block (split, group, batch) takes
// `split` keys (chosen by the wrapper from B, KV and S), skips the keys
// no mask lets through, and writes its partial softmax state (m and l
// in the exp2 domain, and the unnormalised accumulator, per query head)
// to a float32 workspace; a second kernel combines the splits,
// rescaling each by 2^(m_split - m). Each key row is read once for the
// whole head group. A split with no visible key writes m = NEG_INF,
// l = 0 and acc = 0, and drops out of the combine. Ring caches use the
// same kernel: the caller passes pos' = min(pos, W - 1) and no window.
//
// Key ranges (the sharded decode): key j of the given k and v sits at
// position key0 + j, visible iff key0 + j <= pos and, with a window,
// pos - (key0 + j) < window; pos may lie before the range (no key
// visible) or past its end. Asked for the log-sum-exp (lse != NULL),
// the combine writes the normalised output in float32 and the natural
// log-sum-exp of the range's visible scores per query head, so that
// ranges held by different ranks combine exactly: with M the largest
// lse, out = sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M). A range
// with no visible key gives out = 0 and lse = -inf. Without lse the
// output is cast to q's type, as before; key0 = 0 there is the whole
// cache.
//
// Bound on an H100: bytes. gemma2-9b serving (B 4, KV 8, S 8192, D 256,
// bf16) reads 2·4·8·8192·256·2 B = 268 MB of K and V, 0.080 ms at
// 3.35 TB/s; its 2·2·B·H·S·D = 0.54 GFLOP are far below the card's rate.
// So the split pass keeps the memory busy: it streams its keys through
// shared memory in chunks of 32 rows, three stages deep, with cp.async
// (16 bytes a thread), K and V of a chunk in separate copy groups, so
// that V of chunk c and both later chunks are in flight while K of
// chunk c is scored (32-96 KB a block in flight at D 256). QK gives each
// key a group of 8 lanes (4 at 64-byte rows), each lane 16-byte vectors
// of the row, and reduces the per-head partial dots by a transposed
// butterfly: the lanes exchange halves of their head sums, so with rep
// heads a key costs log2(8) + rep - 1 shuffles in place of 5 a head, and
// each lane ends up with one head's full dot. The softmax state of a
// head lives in the registers of one warp (exp2, scale · log2 e folded).
// PV gives each thread 8 consecutive output columns (one 16-byte load
// of a V row) over a subset of the chunk's keys; the partial sums of
// the key groups are reduced once per split, in a fixed tree order in
// shared memory. The wrapper sizes the splits so that the grid fills
// whole waves of resident blocks (ops.split_size: 8 splits of 1,024 keys
// at B 4, KV 8, S 8192, 256 blocks). Budget at bf16, D 256, rep 2: 96 KB
// of stages and 2 KB of q a block, two blocks an SM; ptxas (CUDA 12.9):
// 86 registers, at most 208 in any instance (rep 16), 0 bytes of spills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;
constexpr int kChunk = 32;  // keys a stage (one a lane in the softmax)
constexpr int kStages = 3;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws_m;    // (B, KV, nsplit, rep), exp2 domain
  float* ws_l;    // (B, KV, nsplit, rep)
  float* ws_acc;  // (B, KV, nsplit, rep, D)
  float* lse;     // (B, KV, rep) natural log-sum-exp, or NULL: o cast to T
  int B, KV, rep, S, pos, key0, window, split, nsplit;
  int64_t kv_sb, kv_ss, kv_sh;  // k and v strides (elements): batch, sequence, head
  float qk_scale;  // scale · log2 e, or scale / softcap with a soft-cap
  float cap_log2;  // softcap · log2 e, or 0 without one
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// One 16-byte vector of T from shared memory, as floats.
template <typename T>
__device__ __forceinline__ void load16(const unsigned char* src, float* dst) {
  constexpr int N = 16 / (int)sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int t = 0; t < N; ++t) dst[t] = to_float(e[t]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Transposed butterfly over a group of 2·O lanes holding N partial sums
// each: at every step the lanes whose bit O is set keep the upper half of
// the sums and send the lower half, so after log2(N) steps a lane holds
// the group's full sum of entry lg / (2·O / N), and the remaining steps
// add plain halves.
template <int N, int O>
__device__ __forceinline__ float treduce(float* v, int lg) {
  if constexpr (N == 1) {
    float x = v[0];
#pragma unroll
    for (int o = O; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  } else {
    const bool up = (lg & O) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return treduce<N / 2, O / 2>(v, lg);
  }
}

template <typename T, int D>
struct Split {
  static constexpr int VEC = 16 / (int)sizeof(T);           // elements of a 16-byte vector
  static constexpr int ROW = D * (int)sizeof(T);            // bytes of a key row
  static constexpr int G = ROW / 16 < 8 ? ROW / 16 : 8;     // QK: lanes a key
  static constexpr int NV = ROW / 16 / G;                   // QK: vectors a lane a key
  static constexpr int KPW = 32 / G;                        // QK: keys a warp at once
  static constexpr int CG = D / VEC;                        // PV: 16-byte column groups
  static constexpr int KG = kThreads / CG;                  // PV: key groups
  static constexpr int STAGE = 2 * kChunk * ROW;            // K and V rows of one chunk
  template <int REPB>
  __host__ __device__ static constexpr size_t region() {  // the ring, later the key-group sums
    const size_t ring = (size_t)kStages * STAGE, red = (size_t)(KG / 2) * REPB * D * 4;
    return ring > red ? ring : red;
  }
  template <int REPB>
  __host__ __device__ static constexpr size_t bytes() {
    return region<REPB>() + sizeof(float) * ((size_t)REPB * D + (size_t)REPB * kChunk + REPB);
  }
};

template <typename T, int D, int REPB>
__global__ void __launch_bounds__(kThreads, REPB <= 4 ? 2 : 1) decode_split_kernel(Params p) {
  using L = Split<T, D>;
  constexpr int VEC = L::VEC, G = L::G;
  constexpr size_t kRegion = L::template region<REPB>();
  static_assert(kChunk == 32, "the softmax gives each key of a chunk one lane");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + kRegion);                    // REPB x D
  float* sc = qs + REPB * D;                                               // REPB x kChunk
  float* corr_s = sc + REPB * kChunk;                                      // REPB
  float* red = reinterpret_cast<float*>(smem);  // after the loop: (KG / 2) x REPB x D

  const int rep = p.rep;
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t ws_row = ((int64_t)(b * p.KV + g) * p.nsplit + sp) * rep;

  // Keys of this split that some mask lets through: [a, e] (key j at
  // position key0 + j).
  const int j0 = sp * p.split;
  const int j1 = min(p.S, j0 + p.split) - 1;
  const int last = p.pos - p.key0;
  const int lo = p.window > 0 ? max(0, last - p.window + 1) : 0;
  const int a = max(j0, lo), e = min(j1, last);
  if (a > e) {
    for (int idx = tid; idx < rep * D; idx += kThreads) p.ws_acc[ws_row * D + idx] = 0.f;
    if (tid < rep) {
      p.ws_m[ws_row + tid] = kNegInf;
      p.ws_l[ws_row + tid] = 0.f;
    }
    return;
  }
  const int n = e - a + 1;
  const int nchunks = (n + kChunk - 1) / kChunk;

  const T* kg = static_cast<const T*>(p.k) + b * p.kv_sb + g * p.kv_sh + (int64_t)a * p.kv_ss;
  const T* vg = static_cast<const T*>(p.v) + b * p.kv_sb + g * p.kv_sh + (int64_t)a * p.kv_ss;

  // Chunk ci's K rows, then its V rows, into stage ci % kStages: two
  // copy groups (empty ones past the last chunk keep the count fixed).
  auto issue = [&](int ci) {
    if (ci < nchunks) {
      constexpr int PPR = L::ROW / 16;
      const int rows = min(kChunk, n - ci * kChunk);
      unsigned char* ks = smem + (ci % kStages) * L::STAGE;
      unsigned char* vs = ks + kChunk * L::ROW;
      for (int idx = tid; idx < rows * PPR; idx += kThreads) {
        const int r = idx / PPR, pc = idx % PPR;
        cp_async16(ks + r * L::ROW + pc * 16, kg + (int64_t)(ci * kChunk + r) * p.kv_ss + pc * VEC);
      }
      cp_commit();
      for (int idx = tid; idx < rows * PPR; idx += kThreads) {
        const int r = idx / PPR, pc = idx % PPR;
        cp_async16(vs + r * L::ROW + pc * 16, vg + (int64_t)(ci * kChunk + r) * p.kv_ss + pc * VEC);
      }
      cp_commit();
    } else {
      cp_commit();
      cp_commit();
    }
  };
#pragma unroll
  for (int ci = 0; ci < kStages - 1; ++ci) issue(ci);

  const T* qg = static_cast<const T*>(p.q) + ((int64_t)b * p.KV + g) * rep * D;
  for (int idx = tid; idx < rep * D; idx += kThreads) qs[idx] = to_float(qg[idx]);

  // Softmax state of heads warp and warp + 8 (l: this lane's share).
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // PV: 16-byte column group cg, keys kq, kq + KG, … of each chunk.
  const int cg = tid % L::CG, kq = tid / L::CG;
  float acc[REPB][VEC];
#pragma unroll
  for (int r = 0; r < REPB; ++r)
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[r][t] = 0.f;
  // QK: key group grp of G lanes, lane lg of it.
  const int grp = lane / G, lg = lane % G;

  for (int ci = 0; ci < nchunks; ++ci) {
    issue(ci + kStages - 1);        // into the stage chunk ci - 1 has released
    cp_wait<2 * kStages - 1>();     // K of chunk ci has landed
    __syncthreads();
    const unsigned char* ks = smem + (ci % kStages) * L::STAGE;
    const unsigned char* vs = ks + kChunk * L::ROW;
    const int rows = min(kChunk, n - ci * kChunk);

    // Scores of the chunk, exp2 domain; rows past the split are masked.
    for (int j = warp * L::KPW + grp; j < kChunk; j += kWarps * L::KPW) {
      constexpr int N = REPB < G ? REPB : G;
#pragma unroll
      for (int r0 = 0; r0 < REPB; r0 += N) {
        float part[N];
#pragma unroll
        for (int h = 0; h < N; ++h) part[h] = 0.f;
#pragma unroll
        for (int i = 0; i < L::NV; ++i) {
          const int e0 = (lg + G * i) * VEC;
          float kv[VEC];
          load16<T>(ks + j * L::ROW + e0 * (int)sizeof(T), kv);
#pragma unroll
          for (int h = 0; h < N; ++h)
            if (r0 + h < rep) {
              const float* qr = qs + (r0 + h) * D + e0;
#pragma unroll
              for (int t = 0; t < VEC; ++t) part[h] = fmaf(qr[t], kv[t], part[h]);
            }
        }
        const float dot = treduce<N, G / 2>(part, lg);
        const int r = r0 + lg / (G / N);
        if (lg % (G / N) == 0 && r < rep) {
          const float s = p.cap_log2 > 0.f ? tanhf(dot * p.qk_scale) * p.cap_log2 : dot * p.qk_scale;
          sc[r * kChunk + j] = j < rows ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp a head, one lane a key; p rounded to T
    // for the PV product, l sums the unrounded p.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp + kWarps * i;
      if (r < rep) {
        const float x = sc[r * kChunk + lane];
        const float m_new = fmaxf(m_run[i], warp_max(x));
        const float corr = ex2(m_run[i] - m_new);
        const float pe = ex2(x - m_new);
        l_run[i] = l_run[i] * corr + pe;
        sc[r * kChunk + lane] = to_float(from_float<T>(pe));
        if (lane == 0) corr_s[r] = corr;
        m_run[i] = m_new;
      }
    }
    cp_wait<2 * kStages - 2>();     // V of chunk ci has landed
    __syncthreads();

    // PV over this thread's keys of the chunk.
#pragma unroll
    for (int r = 0; r < REPB; ++r)
      if (r < rep) {
        const float cr = corr_s[r];
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[r][t] *= cr;
      }
    for (int j = kq; j < rows; j += L::KG) {
      float vv[VEC];
      load16<T>(vs + j * L::ROW + cg * 16, vv);
#pragma unroll
      for (int r = 0; r < REPB; ++r)
        if (r < rep) {
          const float pr = sc[r * kChunk + j];
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[r][t] = fmaf(pr, vv[t], acc[r][t]);
        }
    }
    __syncthreads();                // the stage and the scores are free again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp + kWarps * i;
    if (r < rep) {
      const float l = warp_sum(l_run[i]);
      if (lane == 0) {
        p.ws_m[ws_row + r] = m_run[i];
        p.ws_l[ws_row + r] = l;
      }
    }
  }
  // Sum the key groups' partial accumulators, in a fixed tree order.
  cp_wait<0>();
#pragma unroll
  for (int half = L::KG / 2; half > 0; half /= 2) {
    if (kq >= half && kq < 2 * half) {
#pragma unroll
      for (int r = 0; r < REPB; ++r)
        if (r < rep) {
          float* dst = red + ((kq - half) * REPB + r) * D + cg * VEC;
#pragma unroll
          for (int t = 0; t < VEC; t += 4)
            *reinterpret_cast<float4*>(dst + t) =
                make_float4(acc[r][t], acc[r][t + 1], acc[r][t + 2], acc[r][t + 3]);
        }
    }
    __syncthreads();
    if (kq < half) {
#pragma unroll
      for (int r = 0; r < REPB; ++r)
        if (r < rep) {
          const float* src = red + (kq * REPB + r) * D + cg * VEC;
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[r][t] += src[t];
        }
    }
    __syncthreads();
  }
  if (kq == 0) {
#pragma unroll
    for (int r = 0; r < REPB; ++r)
      if (r < rep) {
        float* dst = p.ws_acc + (ws_row + r) * D + cg * VEC;  // 4-byte aligned only
#pragma unroll
        for (int t = 0; t < VEC; ++t) dst[t] = acc[r][t];
      }
  }
}

// Combine the splits of one (batch, group): block (g, b), D threads.
// With lse, o is float32 and a head with no visible key gets 0 and -inf.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(Params p) {
  const int g = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int rep = p.rep;
  const int64_t base = (int64_t)(b * p.KV + g) * p.nsplit * rep;
  const int64_t row0 = ((int64_t)b * p.KV + g) * rep;
  T* og = static_cast<T*>(p.o) + row0 * D;
  float* of = static_cast<float*>(p.o) + row0 * D;
  for (int r = 0; r < rep; ++r) {
    float m = kNegInf;
    for (int s = 0; s < p.nsplit; ++s) m = fmaxf(m, p.ws_m[base + (int64_t)s * rep + r]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const int64_t row = base + (int64_t)s * rep + r;
      const float w = ex2(p.ws_m[row] - m);
      l += p.ws_l[row] * w;
      acc += p.ws_acc[row * D + d] * w;
    }
    if (p.lse == nullptr) {
      og[r * D + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
    } else {
      of[r * D + d] = l > 0.f ? acc / l : 0.f;
      if (d == 0) p.lse[row0 + r] = l > 0.f ? (m + log2f(l)) * kLn2 : -__int_as_float(0x7f800000);
    }
  }
}

template <typename T, int D, int REPB>
int launch(const Params& p, void* stream) {
  const size_t smem = Split<T, D>::template bytes<REPB>();
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, D, REPB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.nsplit, (unsigned)p.KV, (unsigned)p.B);
  decode_split_kernel<T, D, REPB><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<dim3((unsigned)p.KV, (unsigned)p.B), D, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_rep(const Params& p, void* stream) {
  if (p.rep <= 2) return launch<T, D, 2>(p, stream);
  if (p.rep <= 4) return launch<T, D, 4>(p, stream);
  if (p.rep <= 8) return launch<T, D, 8>(p, stream);
  return launch<T, D, 16>(p, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* ws_m, float* ws_l,
             float* ws_acc, float* lse, int64_t B, int64_t KV, int64_t rep, int64_t S, int64_t D,
             int64_t pos, int64_t key0, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int64_t window,
             float softcap, float scale, int64_t split, void* stream) {
  if (rep < 1 || rep > kMaxRep || split < 1 || pos < 0 || key0 < 0 || pos > 2147483647 ||
      key0 > 2147483647)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.ws_m = ws_m; p.ws_l = ws_l; p.ws_acc = ws_acc; p.lse = lse;
  p.B = (int)B; p.KV = (int)KV; p.rep = (int)rep; p.S = (int)S; p.pos = (int)pos;
  p.key0 = (int)key0;
  p.window = (int)window; p.split = (int)split;
  p.nsplit = (int)((S + split - 1) / split);
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.qk_scale = softcap > 0.f ? scale / softcap : scale * kLog2e;
  p.cap_log2 = softcap > 0.f ? softcap * kLog2e : 0.f;
  switch (D) {
    case 32: return launch_rep<T, 32>(p, stream);
    case 64: return launch_rep<T, 64>(p, stream);
    case 128: return launch_rep<T, 128>(p, stream);
    case 256: return launch_rep<T, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The workspace holds B·KV·ceil(S/split)·rep floats for m and for l, and
// D times that for acc; the wrapper allocates it. scale multiplies q·k:
// the wrapper passes the true head width's D^-0.5, which differs from
// this instance's where it pads q and the cache with zero columns. key j
// of k and v sits at position key0 + j. lse NULL: o (B, H, D) in q's
// type; else o (B, H, D) float32 and lse (B, H) float32.
int repro_decode_attention_f32(const void* q, const void* k, const void* v, void* o, float* ws_m,
                               float* ws_l, float* ws_acc, float* lse, int64_t B, int64_t KV,
                               int64_t rep, int64_t S, int64_t D, int64_t pos, int64_t key0,
                               int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int64_t window,
                               float softcap, float scale, int64_t split, void* stream) {
  return dispatch<float>(q, k, v, o, ws_m, ws_l, ws_acc, lse, B, KV, rep, S, D, pos, key0, kv_sb,
                         kv_ss, kv_sh, window, softcap, scale, split, stream);
}

int repro_decode_attention_bf16(const void* q, const void* k, const void* v, void* o, float* ws_m,
                                float* ws_l, float* ws_acc, float* lse, int64_t B, int64_t KV,
                                int64_t rep, int64_t S, int64_t D, int64_t pos, int64_t key0,
                                int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int64_t window,
                                float softcap, float scale, int64_t split, void* stream) {
  return dispatch<bf16>(q, k, v, o, ws_m, ws_l, ws_acc, lse, B, KV, rep, S, D, pos, key0, kv_sb,
                        kv_ss, kv_sh, window, softcap, scale, split, stream);
}

}  // extern "C"
