// §X re-prioritization of every queued job, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/priority_requeue/priority_requeue.py
// (priority_requeue_pallas, _kernel). Per queued job:
//
//   N    = (q·T) / (Q·t)
//   pr   = n <= N ? (N − n)/N : (N − n)/n
//   band = [pr < 0.5] + [pr < 0] + [pr < −0.5]        (0 → Q1 … 3 → Q4)
//
// Q and T arrive as kernel arguments (the TPU kernel's SMEM scalars).
// Instantiated for float (the TPU kernel's type, behind
// repro_torch.core.priority.reprioritize) and double (held bit-identical
// to reprioritize_np, the host control plane's twin); built with
// -fmad=false, and IEEE division, so both equal their plain versions.
//
// Bound on an H100: bytes. 10^7 jobs in f32 read 120 MB and write 80 MB,
// ~0.06 ms at 3.35 TB/s; the arithmetic (two divisions a job) is far
// below the card's rate. One thread a job with neighbouring threads on
// neighbouring addresses, so every load and store coalesces; the tail is
// masked, so no lane padding is needed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void priority_requeue_kernel(const T* __restrict__ n,
                                        const T* __restrict__ q,
                                        const T* __restrict__ t, T quota_sum,
                                        T proc_sum, T* __restrict__ pr,
                                        int32_t* __restrict__ band, int64_t L) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const T ni = n[i];
  const T N = (q[i] * proc_sum) / (quota_sum * t[i]);
  const T p = ni <= N ? (N - ni) / N : (N - ni) / ni;
  pr[i] = p;
  band[i] = (int32_t)(p < T(0.5)) + (int32_t)(p < T(0)) + (int32_t)(p < T(-0.5));
}

template <typename T>
int launch(const T* n, const T* q, const T* t, T quota_sum, T proc_sum, T* pr,
           int32_t* band, int64_t L, void* stream) {
  const unsigned blocks = (unsigned)((L + kThreads - 1) / kThreads);
  priority_requeue_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, q, t, quota_sum, proc_sum, pr, band, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_priority_requeue_f32(const float* n, const float* q, const float* t,
                               float quota_sum, float proc_sum, float* pr,
                               int32_t* band, int64_t L, void* stream) {
  return launch<float>(n, q, t, quota_sum, proc_sum, pr, band, L, stream);
}

int repro_priority_requeue_f64(const double* n, const double* q,
                               const double* t, double quota_sum,
                               double proc_sum, double* pr, int32_t* band,
                               int64_t L, void* stream) {
  return launch<double>(n, q, t, quota_sum, proc_sum, pr, band, L, stream);
}

}  // extern "C"
