// Kernel B1: Generalized Advantage Estimation over [T, B] panels.
//
// Replaces the TPU kernel `_gae_kernel` / `gae_pallas` in
// imitation_tpu/ops/gae_pallas.py, which streamed the five panels into VMEM
// and walked time in reverse with all B lanes vectorised.
//
// Here one thread owns one env column b and walks t from T-1 down to 0,
// carrying the advantage in a register:
//   delta_t = r_t + gamma * V'_t * (1 - term_t) - V_t
//   A_t     = delta_t + gamma*lam * (1 - done_t) * A_{t+1}
// and writes A_t and A_t + V_t in the same pass. Loads of row t are
// coalesced across neighbouring threads (neighbouring b).
//
// Bound: it moves 7 * T * B * 4 bytes (five panels in, two out), 3.7 MB at
// the GAIL CartPole shape T=128, B=1024, about 1 us at 3.35 TB/s. At that
// shape it is bound by the T-long dependent chain and launch latency, not by
// bytes, and only B/128 blocks are busy. That is enough for now: GAE runs
// once per round and is a small share of it. A faster design would split T
// into segments (the affine maps compose) to put more threads on the card.
//
// Each multiply and add is rounded on its own (no FMA contraction), in the
// order of the plain PyTorch version in ops/gae.py, so the two agree to the
// last bit or close to it.

#include <cuda_runtime.h>

namespace {

__global__ void gae_kernel(const float* __restrict__ rews,
                           const float* __restrict__ values,
                           const float* __restrict__ next_values,
                           const float* __restrict__ terminated,
                           const float* __restrict__ dones,
                           float* __restrict__ adv,
                           float* __restrict__ ret,
                           int T, int B, float gamma, float gamma_lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float a = 0.f;
#pragma unroll 4
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    const float v = values[i];
    const float boot = __fmul_rn(__fmul_rn(gamma, next_values[i]),
                                 __fsub_rn(1.f, terminated[i]));
    const float delta = __fsub_rn(__fadd_rn(rews[i], boot), v);
    const float m = __fmul_rn(gamma_lam, __fsub_rn(1.f, dones[i]));
    a = __fadd_rn(delta, __fmul_rn(m, a));
    adv[i] = a;
    ret[i] = __fadd_rn(a, v);
  }
}

}  // namespace

extern "C" int itt_gae_forward(const void* rews, const void* values,
                               const void* next_values, const void* terminated,
                               const void* dones, void* adv, void* ret,
                               int T, int B, float gamma, float lam,
                               void* stream) {
  if (T <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  const float gamma_lam = gamma * lam;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  gae_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rews), static_cast<const float*>(values),
      static_cast<const float*>(next_values),
      static_cast<const float*>(terminated), static_cast<const float*>(dones),
      static_cast<float*>(adv), static_cast<float*>(ret), T, B, gamma,
      gamma_lam);
  return static_cast<int>(cudaGetLastError());
}

// Message for a CUDA error code returned by any entry of this library.
extern "C" const char* itt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
