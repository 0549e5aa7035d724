// One-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py
// (decode_attention_pallas, _kernel): the rep = H / KV query heads of
// one kv group against the group's cache, keys masked by kp <= pos and,
// with a window, pos - kp < window; scale D^-0.5, tanh soft-cap, online
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
// `split` keys, skips the keys no mask lets through, and writes its
// partial softmax state (m, l and the unnormalised accumulator, per query
// head) to a float32 workspace; a second kernel combines the splits,
// rescaling each by exp(m_split - m). Each key row is read once for the
// whole head group. A split with no visible key writes m = NEG_INF, l = 0
// and acc = 0, and drops out of the combine. Ring caches use the same
// kernel: the caller passes pos' = min(pos, W - 1) and no window.
//
// Bound on an H100: bytes. gemma2-9b serving (B 4, KV 8, S 8192, D 256,
// bf16) reads 2·4·8·8192·256·2 B = 268 MB of K and V, 0.080 ms at
// 3.35 TB/s; its 2·2·B·H·S·D = 0.54 GFLOP are far below the card's rate.
// This first kernel is simple: one warp per key for QK (16-byte loads),
// one thread per output column for PV (2-byte loads), no cp.async.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws_m;    // (B, KV, nsplit, rep)
  float* ws_l;    // (B, KV, nsplit, rep)
  float* ws_acc;  // (B, KV, nsplit, rep, D)
  int B, KV, rep, S, pos, window, split, nsplit;
  int64_t kv_sb, kv_ss, kv_sh;  // k and v strides (elements): batch, sequence, head
  float softcap, scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// VEC consecutive elements (VEC·sizeof(T) ∈ {4, 8, 16, 32} bytes) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int BYTES = VEC * (int)sizeof(T);
  constexpr int PER16 = 16 / (int)sizeof(T);
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < PER16; ++t) dst[c * PER16 + t] = to_float(e[t]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < VEC; ++t) dst[t] = to_float(e[t]);
  } else if constexpr (BYTES == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < VEC; ++t) dst[t] = to_float(e[t]);
  } else {
    static_assert(VEC == 1, "rows of 2, 4, 8, 16 or 32 bytes a lane");
    dst[0] = to_float(src[0]);
  }
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

template <int D>
__host__ __device__ constexpr int key_groups() { return kThreads / D; }  // PV: threads a column

template <int D>
size_t split_smem_bytes(int rep, int split) {
  const int groups = key_groups<D>();
  return sizeof(float) *
         ((size_t)rep * D + (size_t)rep * split + (groups > 1 ? (size_t)groups * rep * D : 0) +
          2 * (size_t)rep);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Params p) {
  constexpr int VEC = D / 32;
  constexpr int G = key_groups<D>();
  extern __shared__ float sm[];
  const int rep = p.rep;
  float* qs = sm;                                  // rep x D
  float* ss = qs + rep * D;                        // rep x split: scores, then p
  float* red = ss + rep * p.split;                 // G x rep x D (G > 1)
  float* stat = red + (G > 1 ? G * rep * D : 0);   // m[rep], l[rep]

  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t ws_row = ((int64_t)(b * p.KV + g) * p.nsplit + sp) * rep;

  // Keys of this split that some mask lets through: [a, e].
  const int j0 = sp * p.split;
  const int j1 = min(p.S, j0 + p.split) - 1;
  const int lo = p.window > 0 ? max(0, p.pos - p.window + 1) : 0;
  const int a = max(j0, lo), e = min(j1, p.pos);
  if (a > e) {
    for (int idx = tid; idx < rep * D; idx += kThreads) p.ws_acc[ws_row * D + idx] = 0.f;
    if (tid < rep) {
      p.ws_m[ws_row + tid] = kNegInf;
      p.ws_l[ws_row + tid] = 0.f;
    }
    return;
  }
  const int n = e - a + 1;

  const T* qg = static_cast<const T*>(p.q) + ((int64_t)b * p.KV + g) * rep * D;
  for (int idx = tid; idx < rep * D; idx += kThreads) qs[idx] = to_float(qg[idx]);
  __syncthreads();

  const T* kg = static_cast<const T*>(p.k) + b * p.kv_sb + g * p.kv_sh + (int64_t)a * p.kv_ss;
  const T* vg = static_cast<const T*>(p.v) + b * p.kv_sb + g * p.kv_sh + (int64_t)a * p.kv_ss;

  // Scores: one warp per key, each lane VEC consecutive elements.
  for (int j = warp; j < n; j += kWarps) {
    float kv[VEC];
    load_vec<T, VEC>(kg + (int64_t)j * p.kv_ss + lane * VEC, kv);
    for (int r = 0; r < rep; ++r) {
      const float* qr = qs + r * D + lane * VEC;
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < VEC; ++t) dot = fmaf(qr[t], kv[t], dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        float s = dot * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        ss[r * p.split + j] = s;
      }
    }
  }
  __syncthreads();

  // Softmax state of each head row over this split: p = exp(s - m),
  // rounded to T for the PV product; l sums the unrounded p.
  for (int r = warp; r < rep; r += kWarps) {
    float* row = ss + r * p.split;
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float pe = expf(row[j] - mx);
      sum += pe;
      row[j] = to_float(from_float<T>(pe));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      stat[r] = mx;
      stat[rep + r] = sum;
    }
  }
  __syncthreads();

  // PV: thread (group, column d) sums keys group, group + G, ...
  const int d = tid % D, grp = tid / D;
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;
  for (int j = grp; j < n; j += G) {
    const float vv = to_float(vg[(int64_t)j * p.kv_ss + d]);
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) acc[r] = fmaf(ss[r * p.split + j], vv, acc[r]);
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) red[(grp * rep + r) * D + d] = acc[r];
    __syncthreads();
    if (grp == 0) {
      for (int gg = 1; gg < G; ++gg) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) acc[r] += red[(gg * rep + r) * D + d];
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) p.ws_acc[(ws_row + r) * D + d] = acc[r];
  }
  if (tid < rep) {
    p.ws_m[ws_row + tid] = stat[tid];
    p.ws_l[ws_row + tid] = stat[rep + tid];
  }
}

// Combine the splits of one (batch, group): block (g, b), D threads.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(Params p) {
  const int g = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int rep = p.rep;
  const int64_t base = (int64_t)(b * p.KV + g) * p.nsplit * rep;
  T* og = static_cast<T*>(p.o) + ((int64_t)b * p.KV + g) * rep * D;
  for (int r = 0; r < rep; ++r) {
    float m = kNegInf;
    for (int s = 0; s < p.nsplit; ++s) m = fmaxf(m, p.ws_m[base + (int64_t)s * rep + r]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const int64_t row = base + (int64_t)s * rep + r;
      const float w = expf(p.ws_m[row] - m);
      l += p.ws_l[row] * w;
      acc += p.ws_acc[row * D + d] * w;
    }
    og[r * D + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch(const Params& p, void* stream) {
  const size_t smem = split_smem_bytes<D>(p.rep, p.split);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.nsplit, (unsigned)p.KV, (unsigned)p.B);
  decode_split_kernel<T, D><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<dim3((unsigned)p.KV, (unsigned)p.B), D, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* ws_m, float* ws_l,
             float* ws_acc, int64_t B, int64_t KV, int64_t rep, int64_t S, int64_t D, int64_t pos,
             int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int64_t window, float softcap,
             int64_t split, void* stream) {
  if (rep < 1 || rep > kMaxRep || split < 1 || pos < 0 || pos >= S) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.ws_m = ws_m; p.ws_l = ws_l; p.ws_acc = ws_acc;
  p.B = (int)B; p.KV = (int)KV; p.rep = (int)rep; p.S = (int)S; p.pos = (int)pos;
  p.window = (int)window; p.split = (int)split;
  p.nsplit = (int)((S + split - 1) / split);
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.softcap = softcap;
  p.scale = (float)(1.0 / sqrt((double)D));
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The workspace holds B·KV·ceil(S/split)·rep floats for m and for l, and
// D times that for acc; the wrapper allocates it.
int repro_decode_attention_f32(const void* q, const void* k, const void* v, void* o, float* ws_m,
                               float* ws_l, float* ws_acc, int64_t B, int64_t KV, int64_t rep,
                               int64_t S, int64_t D, int64_t pos, int64_t kv_sb, int64_t kv_ss,
                               int64_t kv_sh, int64_t window, float softcap, int64_t split,
                               void* stream) {
  return dispatch<float>(q, k, v, o, ws_m, ws_l, ws_acc, B, KV, rep, S, D, pos, kv_sb, kv_ss,
                         kv_sh, window, softcap, split, stream);
}

int repro_decode_attention_bf16(const void* q, const void* k, const void* v, void* o, float* ws_m,
                                float* ws_l, float* ws_acc, int64_t B, int64_t KV, int64_t rep,
                                int64_t S, int64_t D, int64_t pos, int64_t kv_sb, int64_t kv_ss,
                                int64_t kv_sh, int64_t window, float softcap, int64_t split,
                                void* stream) {
  return dispatch<bf16>(q, k, v, o, ws_m, ws_l, ws_acc, B, KV, rep, S, D, pos, kv_sb, kv_ss,
                        kv_sh, window, softcap, split, stream);
}

}  // extern "C"
