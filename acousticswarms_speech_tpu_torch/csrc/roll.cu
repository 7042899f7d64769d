// Batched per-channel circular roll: out[b, m, i] = mix[m, (i - s[b, m]) mod T].
//
// Replaces the Pallas TPU kernel acousticswarms_speech_tpu/ops/pallas_shift.py:
// pallas_roll_channels_batch, which the spotforming sweep uses to align the
// mixture to every candidate's TDoA before the SpotNet forward.
//
// Bound: bytes written.  The kernel reads the (M, T) mixture (4 MB at M = 7,
// T = 144000), which stays in the 50 MB L2 for the whole launch, and writes
// B * M * T floats to device memory.  So the design only has to keep the
// stores coalesced and wide: each thread writes 4 consecutive samples with
// one 16-byte store (when T is a multiple of 4), neighbouring threads write
// neighbouring 16-byte words, and the unaligned reads at (i - s) mod T hit L2.
// Grid: x over T-tiles of 4 * blockDim samples, y over the B * M rows.  The
// grid's y extent is at most 65535, so more rows go in several launches of
// whole mic groups (a multiple of M rows each), every launch given the
// shifts and output from its first row on: row % M, and with it the body,
// stays that of a single launch.  (A loop over rows with a stride of
// gridDim.y cost 6-8% at (336, 7, 72000) and (1124, 10, 72000) on an H100,
// scripts/roll_ab.py.)
//
// Fusing the roll with normalize_input (acousticswarms_speech_tpu/models/
// common.py:13-20: 16-bit rounding, mean over mics, per-candidate mean and
// Bessel std) so the normalized block is written once is left for a later
// change.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kMaxGridY = 65535;  // CUDA's limit on gridDim.y

__global__ void roll_channels_kernel(const float* __restrict__ mix,
                                     const int* __restrict__ shifts,
                                     float* __restrict__ out, int M, int T) {
  const int row = blockIdx.y;  // b * M + m
  const int m = row % M;
  int s = shifts[row] % T;     // C remainder keeps the sign of the shift
  if (s < 0) s += T;
  const float* src = mix + static_cast<size_t>(m) * T;
  float* dst = out + static_cast<size_t>(row) * T;

  const int i0 = (blockIdx.x * kThreads + threadIdx.x) * kItems;
  if (i0 >= T) return;
  int j = i0 - s;
  if (j < 0) j += T;

  float v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = src[j];
    if (++j == T) j = 0;
  }
  if ((T % kItems) == 0) {
    // rows start at multiples of T floats, so i0 is 16-byte aligned here
    *reinterpret_cast<float4*>(dst + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (i0 + k < T) dst[i0 + k] = v[k];
    }
  }
}

}  // namespace

// mix: (M, T) float32, shifts: (B, M) int32, out: (B, M, T) float32, all
// contiguous on the current device.  Launches on `stream` without
// synchronizing (once per 65535 rows, rounded down to whole mic groups) and
// returns the first launch error, else cudaSuccess.
extern "C" int roll_channels_batch_launch(const void* mix, const void* shifts,
                                          void* out, int B, int M, int T,
                                          void* stream) {
  const int tile = kThreads * kItems;
  const int rows = B * M;
  const int per_launch = (kMaxGridY / M) * M;
  if (per_launch == 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int row0 = 0; row0 < rows; row0 += per_launch) {
    const int n = rows - row0 < per_launch ? rows - row0 : per_launch;
    dim3 grid((T + tile - 1) / tile, n);
    roll_channels_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mix),
        static_cast<const int*>(shifts) + row0,
        static_cast<float*>(out) + static_cast<size_t>(row0) * T, M, T);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

