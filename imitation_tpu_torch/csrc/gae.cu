// Kernel B1: Generalized Advantage Estimation over [T, B] panels.
//
// Replaces the TPU kernel `_gae_kernel` / `gae_pallas` in
// imitation_tpu/ops/gae_pallas.py, which streamed the five panels into VMEM
// and walked time in reverse with all B lanes vectorised.
//
// The recurrence, in reverse time:
//   delta_t = r_t + gamma * V'_t * (1 - term_t) - V_t
//   A_t     = delta_t + gamma*lam * (1 - done_t) * A_{t+1}
// returns A and A + V.
//
// One step A <- d_t + m_t * A (d_t = delta_t, m_t = gamma*lam*(1 - done_t))
// is an affine map, and maps compose, so a run of steps reduces to one pair
// (M, D) with A_in = D + M * A_out. The kernel splits each column's time into
// segments and works on them in parallel:
//
//   A CTA owns COLS neighbouring columns and 128 threads: thread
//   (segment s, column c), tid = s * COLS + c, SEGS = 128 / COLS segments of
//   seg_len rows each. Time is cut into chunks of SEGS * seg_len rows (at most
//   2048 / COLS, 40 KB of the five panels), walked from the last chunk back.
//   For each chunk:
//   1. its tile of the five panels lands in shared memory by cp.async
//      (16-byte copies where B % 4 == 0 and the panels are 16-byte aligned,
//      else 4-byte copies); the next chunk's copies are started into a second
//      buffer before this one is worked on, so loads overlap the walks;
//   2. each thread walks its segment once with carry 0, giving (M, D);
//   3. each thread composes the maps of the segments after its own, from the
//      last one back, onto the chunk's carry-in (A at the first row of the
//      chunk after it), which gives its segment's true carry-in;
//   4. each thread walks its segment again from that carry and writes A and
//      A + V to device memory; segment 0 leaves A for the next chunk.
//
// COLS is the largest of 32, 16, 8, 4 that still gives 128 CTAs, else 4, so
// [128, 1024] runs as 128 CTAs (8 columns x 16 segments of 8 rows), [64, 64]
// as 16 CTAs (4 columns x 32 segments of 2 rows) and [2048, 4096] as 128 CTAs
// (32 columns x 4 segments of 16 rows, 32 chunks through a double buffer).
// `itt_gae_launch_shape` reports the shape chosen.
//
// Bound: it moves 7 * T * B * 4 bytes (five panels in, two out); every input
// byte is read from device memory once and every output byte written once,
// at every T, since the chunks of a column do not overlap. The dependent
// chain per chunk is 2 * seg_len + SEGS - 1 steps at shared-memory latency
// instead of T steps at device-memory latency.
//
// Rounding: inside a segment each multiply and add is rounded on its own
// (no FMA contraction), in the order of the plain PyTorch version in
// ops/gae.py. The carry into a segment comes from the composed maps, which
// sums in another order, so the kernel agrees with the plain version to
// float32 rounding (held at rtol = atol = 1e-5), not bit for bit.
//
// In shared memory a panel's segments sit seg_len * COLS words apart, plus
// COLS words of padding when seg_len is even, so that the segments a warp
// reads at once fall on different banks. Each thread starts five copies per
// row it takes, with one division per row and the panel pointers indexed by
// constants: with four warps per SM, instructions spent on copy addresses
// are not hidden.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPanels = 5;
constexpr int kChunkWords = 2048;  // rows x columns of one panel in one chunk
constexpr int kMinCtas = 128;      // COLS is the widest that still gives this many CTAs

struct Panels {
  const float* p[kPanels];  // rews, values, next_values, terminated, dones
};

struct Shape {
  int ctas, cols, segs, seg_len, seg_stride, chunk_rows, chunks, stages;
  size_t smem;
};

Shape launch_shape(int T, int B) {
  Shape s;
  s.cols = 4;
  for (int c = 32; c >= 4; c /= 2) {
    if ((B + c - 1) / c >= kMinCtas) {
      s.cols = c;
      break;
    }
  }
  s.segs = kThreads / s.cols;
  const int max_rows = kChunkWords / s.cols;
  const int rows = T < max_rows ? T : max_rows;
  s.seg_len = (rows + s.segs - 1) / s.segs;
  s.chunk_rows = s.seg_len * s.segs;
  s.chunks = (T + s.chunk_rows - 1) / s.chunk_rows;
  s.stages = s.chunks > 1 ? 2 : 1;
  const int pad = (s.cols < 32 && s.seg_len % 2 == 0) ? s.cols : 0;
  s.seg_stride = s.seg_len * s.cols + pad;
  s.ctas = (B + s.cols - 1) / s.cols;
  s.smem = sizeof(float) * (static_cast<size_t>(s.stages) * kPanels * s.segs * s.seg_stride +
                            2 * s.segs * s.cols + 2 * s.cols);
  return s;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// delta and m of one step, rounded as the plain version rounds them.
__device__ __forceinline__ void step_terms(const float* tile, int i, int panel_words,
                                           float gamma, float gamma_lam, float* delta,
                                           float* m, float* v) {
  const float r = tile[i];
  *v = tile[i + panel_words];
  const float nv = tile[i + 2 * panel_words];
  const float term = tile[i + 3 * panel_words];
  const float done = tile[i + 4 * panel_words];
  const float boot = __fmul_rn(__fmul_rn(gamma, nv), __fsub_rn(1.f, term));
  *delta = __fsub_rn(__fadd_rn(r, boot), *v);
  *m = __fmul_rn(gamma_lam, __fsub_rn(1.f, done));
}

template <int COLS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gae_kernel(const Panels in, float* __restrict__ adv, float* __restrict__ ret, int T, int B,
               float gamma, float gamma_lam, int seg_len, int seg_stride, int chunk_rows,
               int chunks) {
  constexpr int SEGS = kThreads / COLS;
  constexpr int UNITS = VEC ? COLS / 4 : COLS;  // copies per row of a panel
  extern __shared__ __align__(16) float smem[];
  const int panel_words = SEGS * seg_stride;
  const int stage_words = kPanels * panel_words;
  float* seg_m = smem + (chunks > 1 ? 2 : 1) * stage_words;  // [SEGS][COLS]
  float* seg_d = seg_m + SEGS * COLS;                         // [SEGS][COLS]
  float* carry = seg_d + SEGS * COLS;                         // [2][COLS]

  const int tid = threadIdx.x;
  const int c = tid % COLS;
  const int s = tid / COLS;
  const int c0 = blockIdx.x * COLS;
  const int b = c0 + c;
  if (tid < COLS) carry[tid] = 0.f;

  // Thread tid copies unit tid % UNITS of rows tid / UNITS, + 128 / UNITS, ...
  // of all five panels. With VEC, B % 4 == 0, so a vector is all in or all out.
  const int copy_col = (tid % UNITS) * (VEC ? 4 : 1);
  const bool copies = c0 + copy_col < B;
  auto load_chunk = [&](int chunk, float* stage) {
    const int t0 = chunk * chunk_rows;
    const int rows = min(chunk_rows, T - t0);
    if (copies) {
      for (int r = tid / UNITS; r < rows; r += kThreads / UNITS) {
        const size_t src = static_cast<size_t>(t0 + r) * B + c0 + copy_col;
        float* dst = stage + (r / seg_len) * seg_stride + (r % seg_len) * COLS + copy_col;
#pragma unroll
        for (int q = 0; q < kPanels; ++q) cp_async<VEC ? 16 : 4>(dst + q * panel_words, in.p[q] + src);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  load_chunk(chunks - 1, smem);
  for (int k = 0; k < chunks; ++k) {
    const int chunk = chunks - 1 - k;
    const float* tile = smem + (k & 1) * stage_words;
    if (k + 1 < chunks) {
      load_chunk(chunk - 1, smem + ((k + 1) & 1) * stage_words);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's tile and the carry into it are visible

    const int t0 = chunk * chunk_rows;
    const int rows = min(chunk_rows, T - t0);
    const int lo = s * seg_len;
    const int hi = b < B ? min(lo + seg_len, rows) : lo;  // empty: identity map
    const int base = s * seg_stride - lo * COLS + c;       // tile index of row r: base + r * COLS

    // Walk 1: this segment's map, A_lo = D + M * A_hi.
    float M = 1.f, D = 0.f;
#pragma unroll 4
    for (int r = hi - 1; r >= lo; --r) {
      float delta, m, v;
      step_terms(tile, base + r * COLS, panel_words, gamma, gamma_lam, &delta, &m, &v);
      D = __fadd_rn(delta, __fmul_rn(m, D));
      M = __fmul_rn(m, M);
    }
    seg_m[s * COLS + c] = M;
    seg_d[s * COLS + c] = D;
    __syncthreads();

    // The true carry into this segment: the later segments' maps, from the
    // last one back, applied to the carry into the chunk.
    float a = carry[(k & 1) * COLS + c];
    for (int j = SEGS - 1; j > s; --j) {
      a = __fadd_rn(seg_d[j * COLS + c], __fmul_rn(seg_m[j * COLS + c], a));
    }

    // Walk 2: the plain recurrence from the true carry.
#pragma unroll 4
    for (int r = hi - 1; r >= lo; --r) {
      float delta, m, v;
      step_terms(tile, base + r * COLS, panel_words, gamma, gamma_lam, &delta, &m, &v);
      a = __fadd_rn(delta, __fmul_rn(m, a));
      const size_t o = static_cast<size_t>(t0 + r) * B + b;
      adv[o] = a;
      ret[o] = __fadd_rn(a, v);
    }
    if (s == 0) carry[((k + 1) & 1) * COLS + c] = a;  // A at the chunk's first row
    __syncthreads();  // the tile is read; the next load_chunk may overwrite it
  }
}

template <int COLS, bool VEC>
cudaError_t launch(const Panels& in, float* adv, float* ret, int T, int B, float gamma,
                   float gamma_lam, const Shape& sh, cudaStream_t stream) {
  auto kernel = gae_kernel<COLS, VEC>;
  if (sh.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sh.smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<sh.ctas, kThreads, sh.smem, stream>>>(in, adv, ret, T, B, gamma, gamma_lam,
                                                 sh.seg_len, sh.seg_stride, sh.chunk_rows,
                                                 sh.chunks);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(const Panels& in, float* adv, float* ret, int T, int B, float gamma,
                     float gamma_lam, const Shape& sh, cudaStream_t stream) {
  switch (sh.cols) {
    case 32: return launch<32, VEC>(in, adv, ret, T, B, gamma, gamma_lam, sh, stream);
    case 16: return launch<16, VEC>(in, adv, ret, T, B, gamma, gamma_lam, sh, stream);
    case 8: return launch<8, VEC>(in, adv, ret, T, B, gamma, gamma_lam, sh, stream);
    default: return launch<4, VEC>(in, adv, ret, T, B, gamma, gamma_lam, sh, stream);
  }
}

}  // namespace

extern "C" int itt_gae_forward(const void* rews, const void* values,
                               const void* next_values, const void* terminated,
                               const void* dones, void* adv, void* ret,
                               int T, int B, float gamma, float lam,
                               void* stream) {
  if (T <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  const Panels in{{static_cast<const float*>(rews), static_cast<const float*>(values),
                   static_cast<const float*>(next_values), static_cast<const float*>(terminated),
                   static_cast<const float*>(dones)}};
  bool vec = B % 4 == 0;
  for (const float* p : in.p) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const Shape sh = launch_shape(T, B);
  const float gamma_lam = gamma * lam;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      vec ? dispatch<true>(in, static_cast<float*>(adv), static_cast<float*>(ret), T, B, gamma,
                           gamma_lam, sh, st)
          : dispatch<false>(in, static_cast<float*>(adv), static_cast<float*>(ret), T, B, gamma,
                            gamma_lam, sh, st);
  return static_cast<int>(e);
}

// The launch shape itt_gae_forward takes for [T, B]: CTAs, threads per CTA,
// columns per CTA, segments per column, rows per segment, chunks of time,
// dynamic shared memory in bytes.
extern "C" void itt_gae_launch_shape(int T, int B, int* out) {
  const Shape sh = launch_shape(T, B);
  const int vals[7] = {sh.ctas, kThreads, sh.cols, sh.segs, sh.seg_len, sh.chunks,
                       static_cast<int>(sh.smem)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
}

// Message for a CUDA error code returned by any entry of this library.
extern "C" const char* itt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
