// Kernel B2: discriminator-batch assembly, out = concat([demo[e_idx], gen[g_idx]]),
// for several fields in one launch.
//
// Replaces the TPU kernel `_kernel` / `assemble_rows_pallas` in
// imitation_tpu/ops/disc_assembly.py, which prefetched the row indices into
// SMEM and issued one row DMA per output row from a semaphore ring.
//
// A discriminator step gathers four fields (obs, acts, next_obs, dones) with
// the same two index arrays, so one launch assembles up to kMaxFields fields.
// A field is rows of bytes, whatever its dtype and rank: demo is [N, R]
// bytes, gen is [C, R] bytes, out is [2B, R] bytes (R is the row's size, the
// element size times the trailing dims); e_idx and g_idx are [B] int32 and
// N, C are the same for every field.
//
// A warp owns a run of 32 output rows. Each lane loads its row's index once
// and reads it as JAX's x[idx] does (a negative index counts from the end,
// then it is clamped to [0, rows - 1]); the warp then moves the 32 rows of
// every field together, each lane getting a row's source index from its
// owner by __shfl_sync, so the index is loaded and clamped once for all
// fields and the stores of a run are contiguous. Each field moves in the
// widest unit that its row size and its three bases allow: 16 bytes (uint4)
// where R % 16 == 0 and the bases are 16-byte aligned (CartPole obs and
// next_obs: one uint4 per row), else 4-byte words where R % 4 == 0 and the
// bases are 4-byte aligned (Pendulum's 12-byte obs rows, 4-byte acts and
// dones, 8-byte float64 or int64 elements), else single bytes (bool dones,
// 6-byte float16 rows, any base that is not 4-byte aligned). Every field's
// loads of a round are started before its stores, so up to kMaxFields
// gathers are in flight at once.
//
// Bound: the four fields of a GAIL CartPole disc step (B = 2048) move about
// 344 KB (indices 2 * B * 4 bytes; obs and next_obs 2 * 2B * 16 each; acts
// and dones 2 * 2B * 4 each), about 0.1 us at 3.35 TB/s; an AIRL Pendulum
// disc step (obs and next_obs 12 bytes a row) about 0.28 MB. At that size a
// launch takes longer than its bytes, so the design's gain is one launch per
// disc step in place of four.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 8;
constexpr int kThreads = 128;

struct Fields {
  const void* demo[kMaxFields];
  const void* gen[kMaxFields];
  void* out[kMaxFields];
  int units[kMaxFields];  // per row, in units of unit_bytes
  int unit_bytes[kMaxFields];  // 16, 4 or 1
  int n;
  int max_units;
};

__global__ void __launch_bounds__(kThreads)
    assemble_fields_kernel(const Fields f, const int32_t* __restrict__ e_idx,
                           const int32_t* __restrict__ g_idx, long long n_demo,
                           long long n_gen, int B) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long run = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32 * 32;
  const long long n_out = 2LL * B;

  long long src = 0;  // this lane's row of demo or gen
  if (run + lane < n_out) {
    const long long row = run + lane;
    const bool from_demo = row < B;
    const long long rows = from_demo ? n_demo : n_gen;
    long long i = from_demo ? e_idx[row] : g_idx[row - B];
    if (i < 0) i += rows;
    src = i < 0 ? 0 : (i >= rows ? rows - 1 : i);
  }

  // Round r moves unit lane + 32 r of the run's rows x units of each field.
  // r < units is the same for the whole warp, so the shuffles stay uniform.
  for (int r = 0; r < f.max_units; ++r) {
    uint4 v[kMaxFields];
    long long dst[kMaxFields];
#pragma unroll
    for (int k = 0; k < kMaxFields; ++k) {
      dst[k] = -1;
      if (k >= f.n || r >= f.units[k]) continue;
      const int u = lane + 32 * r;
      const int owner = u / f.units[k];
      const int unit = u - owner * f.units[k];
      const long long s_row = __shfl_sync(full, src, owner);
      const long long row = run + owner;
      if (row >= n_out) continue;
      const void* base = row < B ? f.demo[k] : f.gen[k];
      const long long at = s_row * f.units[k] + unit;
      if (f.unit_bytes[k] == 16) {
        v[k] = static_cast<const uint4*>(base)[at];
      } else if (f.unit_bytes[k] == 4) {
        v[k].x = static_cast<const uint32_t*>(base)[at];
      } else {
        v[k].x = static_cast<const uint8_t*>(base)[at];
      }
      dst[k] = row * f.units[k] + unit;
    }
#pragma unroll
    for (int k = 0; k < kMaxFields; ++k) {
      if (dst[k] < 0) continue;
      if (f.unit_bytes[k] == 16) {
        static_cast<uint4*>(f.out[k])[dst[k]] = v[k];
      } else if (f.unit_bytes[k] == 4) {
        static_cast<uint32_t*>(f.out[k])[dst[k]] = v[k].x;
      } else {
        static_cast<uint8_t*>(f.out[k])[dst[k]] = static_cast<uint8_t>(v[k].x);
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// The widest unit (16, 4 or 1 bytes) that divides a row of row_bytes and
// all three bases.
int unit_for(int row_bytes, const void* demo, const void* gen, const void* out) {
  const int widths[2] = {16, 4};
  for (int u : widths) {
    if (row_bytes % u == 0 && aligned(demo, u) && aligned(gen, u) && aligned(out, u)) return u;
  }
  return 1;
}

}  // namespace

// Assembles n fields in one launch. demo[k], gen[k] and out[k] are field k's
// bases and row_bytes[k] the bytes of one of its rows (0 for empty rows,
// which move nothing); every field has n_demo demo rows and n_gen gen rows.
// Returns cudaErrorInvalidValue for n outside [1, kMaxFields] or a negative
// row size.
extern "C" int itt_assemble_fields(const void* const* demo, const void* const* gen,
                                   void* const* out, const int* row_bytes, int n,
                                   const void* e_idx, const void* g_idx, long long n_demo,
                                   long long n_gen, int B, void* stream) {
  if (n < 1 || n > kMaxFields) return static_cast<int>(cudaErrorInvalidValue);
  Fields f{};
  f.n = n;
  for (int k = 0; k < n; ++k) {
    if (row_bytes[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int unit = unit_for(row_bytes[k], demo[k], gen[k], out[k]);
    f.demo[k] = demo[k];
    f.gen[k] = gen[k];
    f.out[k] = out[k];
    f.unit_bytes[k] = unit;
    f.units[k] = row_bytes[k] / unit;
    f.max_units = f.units[k] > f.max_units ? f.units[k] : f.max_units;
  }
  const long long n_out = 2LL * B;
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  const long long ctas = (n_out + kThreads - 1) / kThreads;
  assemble_fields_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<const int32_t*>(e_idx), static_cast<const int32_t*>(g_idx), n_demo, n_gen,
      B);
  return static_cast<int>(cudaGetLastError());
}
