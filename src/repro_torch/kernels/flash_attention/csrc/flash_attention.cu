// Blocked flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:72
// (flash_attention_pallas, _kernel): causal / sliding-window GQA
// attention with an online softmax (running max m, sum l and output
// accumulator in float32), tanh soft-cap, scale D^-0.5 and output
// acc / max(l, 1e-30). Query head h reads kv head h / (H / KV).
//
// Layout: q (B, Sq, H, D) and k, v (B, Sk, KV, D) are read through their
// strides (batch, sequence, head; the head dimension D contiguous), so
// the model's projections go in without a transpose; o is a contiguous
// (B, Sq, H, D). Every body is templated on <DQK, DV>: q and k are DQK
// wide and v and o DV wide; the scale is the caller's (D^-0.5 of the
// true head width, which the wrapper may have padded). The <D, D> instances
// (D 32, 64, 128, 256) serve the GQA families; <192, 128> serves MLA's
// prefill (src/repro/models/mla.py:63, nope 128 + rope 64 against values
// of 128), where k and v are two column ranges of one (B, S, H, 320)
// buffer and so share their strides. A block walks the key tiles of one (batch, head, query
// tile) in a loop (the TPU kernel's sequential innermost grid axis).
// Key tiles that the causal or window mask hides from every row are
// skipped; inside a visited tile masked scores are NEG_INF = -2e38, a
// finite value, so a row whose first visited tile is fully masked gets
// p = 1 there and the first unmasked tile wipes it (corr = 0), exactly
// as in the TPU kernel. The wrapper rejects inputs where a query row has
// no visible key at all. Given an lse buffer, each body also writes every
// row's log-sum-exp of its scaled, capped, masked scores (float32, natural
// units, from the row max and sum it already keeps) for the backward
// (flash_attention_bwd.cu); the serving path passes none.
//
// Bound on an H100: operations. Causal prefill of gemma2-9b (B 1,
// S 8192, H 16, D 256, bf16) needs 2·2·B·H·S²·D/2 = 5.5e11 FLOP, 0.56 ms
// at 989 TFLOP/s, against 0.1 GB of q, k, v and o (0.03 ms at 3.35 TB/s).
// Only wgmma reaches that rate, and only if the tiles it reads are in
// shared memory when it wants them and the softmax between the two
// products does not leave the tensor cores idle.
//
// Two bodies:
//  * bfloat16 (the model's type), warp-specialised. A block of three
//    warpgroups owns 128 query rows of one head: warpgroup 0 is the
//    producer, warpgroups 1 and 2 each compute 64 of the rows. (The
//    other choice, 64 rows of each of the rep heads of a kv group, would
//    share K/V tiles across heads but ties the block to rep = 2; here the
//    two consumers share every K/V tile of their head instead.) One
//    producer thread loads the query tile once and then K and V tiles of
//    64 keys by TMA (rank-4 tensor maps over the strided (B, S, heads, D)
//    views, 128-byte swizzle, 64-byte at D 32) into a ring of two stages,
//    each with a full barrier for K, one for V and an empty barrier that
//    the eight consumer warps arrive on; the next stage's loads are in
//    flight while the consumers compute on the current one. S = Q K^T is
//    wgmma m64n64k16 with both operands in shared memory (K's rows are
//    already the K-major B operand); the scores stay in registers, where
//    the softmax runs in the exp2 domain (scale · log2 e folded into one
//    multiply) with row max and sum over the quad of lanes that shares a
//    row. A warpgroup reads only the tiles some row of it can see (a
//    window hides a prefix, the diagonal a suffix) and runs the mask test
//    only on tiles that cross the diagonal, the window edge or the end of
//    the keys. The soft-cap's tanh is tanh.approx.f32 on the SFU. P is
//    rounded to bf16 in registers and is the register A operand of the
//    PV wgmma (the m64n64 accumulator layout is the A-fragment layout),
//    so it never goes to shared memory; V's tile is the MN-major B
//    operand. The f32 O accumulator (64 x D, 128 registers a thread at
//    D 256) stays in registers and is rescaled by corr there; setmaxnreg
//    gives the consumers 240 registers and the producer 24. The epilogue
//    stages O / max(l, 1e-30) as bf16 in the warpgroup's own rows of the
//    query tile and writes 16-byte rows. The two consumer warpgroups of
//    a block overlap one's softmax with the other's products; a software
//    pipeline inside a warpgroup (S of tile t issued before P V of tile
//    t - 1) measured slower on the H100 and was left out.
//    Budget at D 256: Q 64 KB + 2 x (32 + 32) KB ring = 192 KB of shared
//    memory, one block an SM; ptxas (CUDA 12.9): 168 registers a thread
//    at launch for every D (the consumers then raise theirs to 240),
//    0 bytes of spills. At <192, 128>: Q 48 KB + 2 x (24 + 16) KB = 128 KB;
//    three boxes a q/k row, two a v/o row.
//  * float32: 32 x 32 tiles on the CUDA cores (explicit fmaf), each
//    thread owning a row slice of the accumulator in registers. It
//    serves the float32 model, not the bf16 serving path.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // the float32 body

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, lse_stride(Sq)) row log-sum-exp, or null
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
__device__ __forceinline__ void key_range(int Sq, int Sk, int causal, int window, int q0, int bq,
                                          int bk, int* begin, int* end) {
  const int q_last = min(q0 + bq, Sq) - 1;
  int e = Sk;
  if (causal) e = min(e, q_last + 1);
  int b = 0;
  if (window > 0) b = max(0, q0 - window + 1);
  *begin = (b / bk) * bk;
  *end = e;
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma with a TMA ring
// ---------------------------------------------------------------------------

template <int DQK, int DV>
struct HopTiles {
  // One box width for q, k and v; the epilogue stages O in the query
  // tile's own boxes, so DV ≤ DQK.
  static_assert(DQK == DV || (DQK % 64 == 0 && DV % 64 == 0 && DV < DQK), "unsupported (DQK, DV)");
  static constexpr int BQ = 128, BK = 64, STAGES = 2, THREADS = 384;
  static constexpr int BW = DQK < 64 ? DQK : 64;       // columns of one TMA box (one swizzled row)
  static constexpr int NBQ = DQK / BW, NBV = DV / BW;  // boxes a q/k row, a v/o row
  static constexpr int RB = BW * 2;                    // bytes of a box row
  static constexpr uint32_t SWIZZLE = RB == 128 ? 1 : 2;  // wgmma layout: 128- or 64-byte swizzle
  static constexpr int ATOM = 8 * RB;                  // bytes of eight swizzled rows
  static constexpr int Q_BYTES = BQ * DQK * 2, K_BYTES = BK * DQK * 2, V_BYTES = BK * DV * 2;
  static constexpr int Q_OFF = 0, K_OFF = Q_BYTES, V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  // + the barriers (q_full, k_full[STAGES], v_full[STAGES], empty[STAGES])
  // + slack to align the base to the 1024-byte swizzle period
  static constexpr size_t bytes() { return (size_t)BAR_OFF + 8 * (1 + 3 * STAGES) + 1024; }
};

struct TmaParams {
  CUtensorMap tq, tk, tv;  // rank 4: (DQK or DV, S, heads, B), innermost first
  void* o;
  float* lse;  // (B, H, lse_stride(Sq)) row log-sum-exp, or null
  int H, rep, Sq, Sk, causal, window;
  float qk_scale;  // scale · log2 e, or scale / softcap with a soft-cap
  float cap_log2;  // softcap · log2 e, or 0 without one
};

template <int DQK, int DV>
__global__ void __launch_bounds__(384, 1) flash_bf16_kernel(const __grid_constant__ TmaParams p) {
  using T = HopTiles<DQK, DV>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES, BW = T::BW, RB = T::RB;
  constexpr int NBQ = T::NBQ, NBV = T::NBV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sgen = smem_raw + (base - raw);
  const uint32_t sQ = base + T::Q_OFF, sK = base + T::K_OFF, sV = base + T::V_OFF;
  const uint32_t q_full = base + T::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * ST + s); };

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.rep;
  int kb, ke;
  key_range(p.Sq, p.Sk, p.causal, p.window, q0, BQ, BK, &kb, &ke);
  const int nt = (ke - kb + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int j = 0; j < NBQ; ++j) tma_load_4d(sQ + j * BQ * RB, &p.tq, q_full, j * BW, q0, h, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, k0 = kb + t * BK;
        mbar_wait(empty(s), ((t / ST) & 1) ^ 1);  // the first pass over the ring finds it free
        mbar_expect_tx(k_full(s), T::K_BYTES);
        for (int j = 0; j < NBQ; ++j)
          tma_load_4d(sK + s * T::K_BYTES + j * BK * RB, &p.tk, k_full(s), j * BW, k0, g, b);
        mbar_expect_tx(v_full(s), T::V_BYTES);
        for (int j = 0; j < NBV; ++j)
          tma_load_4d(sV + s * T::V_BYTES + j * BK * RB, &p.tv, v_full(s), j * BW, k0, g, b);
      }
    }
  } else {
    // Consumer warpgroup c: query rows qw0 … qw0 + 63. Thread (warp,
    // lane) holds rows row0 and row0 + 8 and, in each 8-column block of
    // an accumulator, columns col and col + 1 (the wgmma m64nN layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    constexpr int NO = DV < 64 ? 1 : DV / 64;  // output chunks of 64 columns (one of 32 at DV 32)
    constexpr int OW = DV < 64 ? 16 : 32;      // accumulator registers a chunk
    const int c = threadIdx.x / 128 - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int qw0 = q0 + 64 * c;
    const int row0 = qw0 + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);
    const uint32_t qa = sQ + 64 * c * RB;  // this warpgroup's rows of the first box
    const bool capped = p.cap_log2 > 0.f;

    float o[NO][OW];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < OW; ++i) o[n][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

    // S = Q K^T (64 x 64) of the tile in stage st, both operands K-major
    // in shared memory; one wgmma group.
    auto qk_issue = [&](float (&sc)[32], int st) {
      const uint32_t ks = sK + st * T::K_BYTES;
      wg_fence();
#pragma unroll
      for (int j = 0; j < NBQ; ++j)
#pragma unroll
        for (int kk = 0; kk < BW / 16; ++kk)
          wgmma_ss_n64(sc, gmma_desc(qa + j * BQ * RB + kk * 32, 16, T::ATOM, T::SWIZZLE),
                       gmma_desc(ks + j * BK * RB + kk * 32, 16, T::ATOM, T::SWIZZLE), j + kk);
      wg_commit();
    };
    // O += P V of the tile in stage st: P from registers, V's tile
    // MN-major in shared memory; one wgmma group.
    auto pv_issue = [&](uint32_t (&pa)[BK / 16][4], int st) {
      const uint32_t vs = sV + st * T::V_BYTES;
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs(o[n]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const uint64_t dv = gmma_desc(vs + n * BK * RB + kk * 16 * RB, BK * RB, T::ATOM, T::SWIZZLE);
          if constexpr (DV < 64) {
            wgmma_rs_n32(o[n], pa[kk], dv);
          } else {
            wgmma_rs_n64(o[n], pa[kk], dv);
          }
        }
      wg_commit();
    };
    // After the PV group has completed: keep its operands' registers
    // until here, and hand the stage back to the producer.
    auto pv_done = [&](uint32_t (&pa)[BK / 16][4], int st) {
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs(o[n]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_frags(pa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };
    // Scores of the tile at key k0 in the exp2 domain (the mask only where
    // the tile crosses the diagonal, the window edge or the end of the
    // keys), the online softmax over the quad of lanes that shares a row,
    // p rounded to bf16 into the A fragments of the four 16-key steps (l
    // sums the unrounded p), and the rescale factor of the older O.
    auto softmax = [&](float (&sc)[32], int k0, uint32_t (&pa)[BK / 16][4], float (&corr)[2]) {
      if (capped) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = tanh_approx(sc[i] * p.qk_scale) * p.cap_log2;
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= p.qk_scale;
      }
      const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qw0) ||
                        (p.window > 0 && k0 <= qw0 + 63 - p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qp = row0 + 8 * ((i >> 1) & 1);
          const int kp = k0 + 8 * (i >> 2) + col + (i & 1);
          const bool ok =
              kp < p.Sk && (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
          if (!ok) sc[i] = kNegInf;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[r] = ex2(m[r] - mx);
        m[r] = mx;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = ex2(sc[4 * j + 2 * r] - m[r]), p1 = ex2(sc[4 * j + 2 * r + 1] - m[r]);
          rs[r] += p0 + p1;
          pa[j / 2][(j % 2) * 2 + r] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
    };
    // A tile none of this warpgroup's rows can see: released unread.
    auto release = [&](int t) {
      const int st = t % ST;
      const uint32_t ph = (t / ST) & 1;
      mbar_wait(k_full(st), ph);
      mbar_wait(v_full(st), ph);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };

    // The visible tiles are [t_lo, t_hi): a window hides a prefix of the
    // block's tiles from this warpgroup, the diagonal a suffix.
    int t_lo = 0, t_hi = 0;
    if (qw0 < p.Sq) {
      t_hi = p.causal ? min(nt, (qw0 + 63 - kb) / BK + 1) : nt;
      const int x = qw0 - p.window + 2 - BK - kb;  // first t with its last key ≥ qw0 − window + 1
      if (p.window > 0 && x > 0) t_lo = min(t_hi, (x + BK - 1) / BK);
    }

    mbar_wait(q_full, 0);
    for (int t = 0; t < t_lo; ++t) release(t);
    for (int t = t_lo; t < t_hi; ++t) {
      const int st = t % ST;
      const uint32_t ph = (t / ST) & 1;
      mbar_wait(k_full(st), ph);
      float sc[32];
      qk_issue(sc, st);
      wg_wait_all();
      fence_regs(sc);
      uint32_t pa[BK / 16][4];
      float corr[2];
      softmax(sc, kb + t * BK, pa, corr);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < OW; ++i) o[n][i] *= corr[(i >> 1) & 1];
      mbar_wait(v_full(st), ph);
      pv_issue(pa, st);
      wg_wait_all();
      pv_done(pa, st);
    }
    for (int t = t_hi; t < nt; ++t) release(t);

    // Epilogue: O / max(l, 1e-30) as bf16 into this warpgroup's own rows
    // of the query tile (16-byte chunks XOR-swizzled by row), then 16-byte
    // rows to o.
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      den[r] = fmaxf(sum, 1e-30f);
      // The row's log-sum-exp of the scores t (natural units): m and the
      // sum live in the exp2 domain.
      const int qp = row0 + 8 * r;
      if (p.lse != nullptr && (lane & 3) == 0 && qp < p.Sq)
        p.lse[((int64_t)b * p.H + h) * lse_stride(p.Sq) + qp] = (m[r] + log2f(sum)) * kLn2;
    }
    constexpr int CPB = BW / 8;  // 16-byte chunks a box row (O takes NBV ≤ NBQ boxes)
    static_assert(NBV <= NBQ, "O is staged in the query tile");
    auto stage_at = [&](int rr, int ch) -> unsigned char* {
      const int j = ch / CPB, ic = ch % CPB;
      return sgen + T::Q_OFF + j * BQ * RB + (64 * c + rr) * RB + ((ic ^ (rr % CPB)) * 16);
    };
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < OW; i += 2) {
        const int r = (i >> 1) & 1;
        const int rr = 16 * warp + lane / 4 + 8 * r;
        const int ch = n * (BW / 8) + (i >> 2);
        *reinterpret_cast<uint32_t*>(stage_at(rr, ch) + 2 * col) =
            pack_bf16(o[n][i] / den[r], o[n][i + 1] / den[r]);
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    bf16* og = static_cast<bf16*>(p.o);
    for (int idx = tw; idx < 64 * (DV / 8); idx += 128) {
      const int rr = idx / (DV / 8), ch = idx % (DV / 8);
      const int qp = qw0 + rr;
      if (qp < p.Sq)
        *reinterpret_cast<uint4*>(og + (((int64_t)b * p.Sq + qp) * p.H + h) * DV + ch * 8) =
            *reinterpret_cast<const uint4*>(stage_at(rr, ch));
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int DQK, int DV>
struct F32Tiles {
  static constexpr int BQ = 32, BK = 32;
  static constexpr int LD = DQK + 1, LDV = DV + 1;  // q/k and v rows, padded against bank conflicts
  static constexpr int LDP = BK + 1;
  static constexpr size_t bytes() {
    return ((size_t)(BQ + BK) * LD + (size_t)BK * LDV + (size_t)BQ * LDP) * 4;
  }
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Params p) {
  using T = F32Tiles<DQK, DV>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, LDV = T::LDV, LDP = T::LDP;
  constexpr int NC = DV / 8;  // accumulator columns a thread owns
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LDV;

  const int tid = threadIdx.x;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kv_sb + g * p.kv_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.kv_sb + g * p.kv_sh;

  for (int idx = tid; idx < BQ * DQK; idx += kThreads) {
    const int r = idx / DQK, c = idx % DQK;
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
  key_range(p.Sq, p.Sk, p.causal, p.window, q0, BQ, BK, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * DQK; idx += kThreads) {
      const int r = idx / DQK, c = idx % DQK;
      Ks[r * LD + c] = k0 + r < p.Sk ? kg[(int64_t)(k0 + r) * p.kv_ss + c] : 0.f;
    }
    for (int idx = tid; idx < BK * DV; idx += kThreads) {
      const int r = idx / DV, c = idx % DV;
      Vs[r * LDV + c] = k0 + r < p.Sk ? vg[(int64_t)(k0 + r) * p.kv_ss + c] : 0.f;
    }
    __syncthreads();

    float sv[BK / 8];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      const int j = lane8 + 8 * c;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DQK; ++d) dot = fmaf(Qs[i * LD + d], Ks[j * LD + d], dot);
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
      for (int c = 0; c < NC; ++c) o[c] = fmaf(pj, Vs[j * LDV + lane8 + 8 * c], o[c]);
    }
  }

  if (qp < p.Sq) {
    float* og = static_cast<float*>(p.o) + (((int64_t)b * p.Sq + qp) * p.H + h) * DV;
    if (p.lse != nullptr && lane8 == 0)
      p.lse[((int64_t)b * p.H + h) * lse_stride(p.Sq) + qp] = m_i + logf(l_i);
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

template <int DQK, int DV>
int launch_bf16(const Params& p, void* stream) {
  using T = HopTiles<DQK, DV>;
  const size_t smem = T::bytes();
  // A runtime call first: it makes the device's primary context current in
  // a host thread that has made none yet (an autograd worker whose first
  // operation this is), which the driver's tensor-map encoder needs.
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  TmaParams t;
  if (!encode(fn, &t.tq, p.q, DQK, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, T::BW, T::BQ) ||
      !encode(fn, &t.tk, p.k, DQK, p.Sk, p.KV, p.B, p.kv_ss, p.kv_sh, p.kv_sb, T::BW, T::BK) ||
      !encode(fn, &t.tv, p.v, DV, p.Sk, p.KV, p.B, p.kv_ss, p.kv_sh, p.kv_sb, T::BW, T::BK))
    return (int)cudaErrorInvalidValue;
  t.o = p.o;
  t.lse = p.lse;
  t.H = p.H; t.rep = p.H / p.KV; t.Sq = p.Sq; t.Sk = p.Sk;
  t.causal = p.causal; t.window = p.window;
  t.qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * kLog2e;
  t.cap_log2 = p.softcap > 0.f ? p.softcap * kLog2e : 0.f;
  const dim3 grid((unsigned)((p.Sq + T::BQ - 1) / T::BQ), (unsigned)p.H, (unsigned)p.B);
  flash_bf16_kernel<DQK, DV><<<grid, T::THREADS, smem, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o, void* lse, int64_t B,
                   int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t q_sb, int64_t q_ss,
                   int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int causal,
                   int64_t window, float softcap, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
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

// D is q's and k's width (DQK), Dv v's and o's. scale multiplies q·k
// (the wrapper passes the true head width's D^-0.5, which differs from
// DQK^-0.5 where it pads q and k with zero columns). lse, when not null,
// receives each row's log-sum-exp of its scaled, capped, masked scores
// (float32, (B, H, Sq) with row stride Sq rounded up to 4). Returns
// cudaErrorInvalidValue for a pair other than (32, 32), (64, 64),
// (128, 128), (256, 256) and (192, 128) (the wrapper checks it first).
int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                              int64_t B,
                              int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t D, int64_t Dv,
                              int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t kv_sb,
                              int64_t kv_ss, int64_t kv_sh, int causal, int64_t window,
                              float softcap, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, lse, B, H, KV, Sq, Sk, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                               kv_sh, causal, window, softcap, scale);
  if (D == 192 && Dv == 128)
    return launch(flash_f32_kernel<192, 128>, F32Tiles<192, 128>::bytes(), p, 32, stream);
  if (D != Dv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch(flash_f32_kernel<32, 32>, F32Tiles<32, 32>::bytes(), p, 32, stream);
    case 64: return launch(flash_f32_kernel<64, 64>, F32Tiles<64, 64>::bytes(), p, 32, stream);
    case 128: return launch(flash_f32_kernel<128, 128>, F32Tiles<128, 128>::bytes(), p, 32, stream);
    case 256: return launch(flash_f32_kernel<256, 256>, F32Tiles<256, 256>::bytes(), p, 32, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Also returns cudaErrorInvalidValue when a tensor map cannot describe
// the views (cuTensorMapEncodeTiled refused them).
int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                               int64_t B,
                               int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t D, int64_t Dv,
                               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t kv_sb,
                               int64_t kv_ss, int64_t kv_sh, int causal, int64_t window,
                               float softcap, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, lse, B, H, KV, Sq, Sk, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                               kv_sh, causal, window, softcap, scale);
  if (D == 192 && Dv == 128) return launch_bf16<192, 128>(p, stream);
  if (D != Dv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_bf16<32, 32>(p, stream);
    case 64: return launch_bf16<64, 64>(p, stream);
    case 128: return launch_bf16<128, 128>(p, stream);
    case 256: return launch_bf16<256, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
