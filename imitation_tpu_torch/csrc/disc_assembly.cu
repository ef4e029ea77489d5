// Kernel B2: discriminator-batch assembly, out = concat([demo[e_idx], gen[g_idx]]).
//
// Replaces the TPU kernel `_kernel` / `assemble_rows_pallas` in
// imitation_tpu/ops/disc_assembly.py, which prefetched the row indices into
// SMEM and issued one row DMA per output row from a semaphore ring.
//
// Here one kernel works on 4-byte words, so float32 and int32 fields share
// it: demo is [N, F] words, gen is [C, F] words, e_idx and g_idx are [B]
// int32, out is [2B, F] words (a [N] field is F = 1). Each thread copies one
// output word: it loads its row's index itself (there is no scalar
// prefetch), takes demo for rows below B and gen otherwise, and reads the
// word. Neighbouring threads write neighbouring words, so stores coalesce.
// An index is handled as JAX's x[idx] does: a negative one counts from the
// end, then it is clamped to [0, rows - 1].
//
// Bound: it moves 2B*4 index bytes plus 2 * 2B*F*4 row bytes, 0.15 MB for
// the obs field of the GAIL CartPole disc step (B=2048, F=4), far below a
// microsecond at 3.35 TB/s, so at these sizes it is bound by launch latency.
// That is why a simple design is enough: one launch per field, four per
// disc step. Fusing the fields into one launch is the next step if it shows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void assemble_rows_kernel(const uint32_t* __restrict__ demo,
                                     const uint32_t* __restrict__ gen,
                                     const int32_t* __restrict__ e_idx,
                                     const int32_t* __restrict__ g_idx,
                                     uint32_t* __restrict__ out,
                                     long long n_demo, long long n_gen, int B,
                                     int F) {
  const long long total = 2LL * B * F;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / F;
    const int col = static_cast<int>(i - row * F);
    const bool from_demo = row < B;
    const uint32_t* src = from_demo ? demo : gen;
    const long long rows = from_demo ? n_demo : n_gen;
    long long idx = from_demo ? e_idx[row] : g_idx[row - B];
    if (idx < 0) idx += rows;
    idx = idx < 0 ? 0 : (idx >= rows ? rows - 1 : idx);
    out[i] = src[idx * F + col];
  }
}

}  // namespace

extern "C" int itt_assemble_rows(const void* demo, const void* gen,
                                 const void* e_idx, const void* g_idx,
                                 void* out, long long n_demo, long long n_gen,
                                 int B, int F, void* stream) {
  const long long total = 2LL * B * F;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride loop covers the rest
  assemble_rows_kernel<<<static_cast<int>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(demo), static_cast<const uint32_t*>(gen),
      static_cast<const int32_t*>(e_idx), static_cast<const int32_t*>(g_idx),
      static_cast<uint32_t*>(out), n_demo, n_gen, B, F);
  return static_cast<int>(cudaGetLastError());
}
