// Fused epilogue of a dilated residual layer (K5):
//   out[b, :, t] = LN_C(relu(z[b, :, t] + conv_bias) + x[b, :, t]) * w + beta
// where z is the layer's convolution without its bias, x the layer's input,
// and LN_C the normalisation over the C channels of one time step (population
// variance, statistics in float32): models/modules.py DilatedResidualLayer,
// whose plain version is ops/residual_epilogue.py residual_epilogue_plain.
//
// It replaces no TPU kernel.  It was added because the composition of
// PyTorch operations it replaces makes eight passes over device memory on a
// (B, C, T) float32 activation (the convolution's bias add, ReLU, the
// residual add, the strided reduction over C, subtract, scale, weight and
// bias: 64 bytes an element), and SpotNet runs it on 30 layers of every
// sweep chunk.
//
// Bound: bytes.  The function needs 12 bytes an element: z and x read once,
// out written once; the few operations per element are far below what the
// card computes in that time.  So the design moves those 12 bytes and no
// more: a block owns one item b and a tile of `tile` time steps, stages
// relu(z + conv_bias) + x for its whole C x tile block in shared memory
// (read from device memory once, 16-byte loads, neighbouring threads on
// neighbouring addresses, several loads in flight per thread), takes each
// column's mean and variance from shared memory, and writes the normalised
// block once with 16-byte stores.  The tile is chosen from C so that a block
// stages at most 32 KB (64 KB at C = 512), which keeps at least two blocks
// resident on an SM for every C it takes and every row access at least 128
// contiguous bytes.
//
// Same bits as the composition.  SpotNet's output moves by a few 1e-6 when
// one layer sums in another order, which the search's heads amplify past
// what the port may differ from its reference.  So every rounding is the
// composition's: the statistics are torch.var_mean's Welford sums, taken
// over the same channels in the same order and combined in the same tree as
// PyTorch's CUDA reduction (ATen/native/cuda/Reduce.cuh with WelfordOps, two
// accumulators a thread, its block_y_reduce; the split of C over threads
// that its setReduceConfig picks for an aligned (B, C, T) input is computed
// by the launcher; copied from torch 2.11.0's sources, and held to the
// installed torch's bits by the card's tests), and the affine step rounds after each operation as the
// composition's separate kernels do (rsqrtf as torch.rsqrt, no fused
// multiply-add).  No atomics and no scratch in device memory: the result is
// deterministic.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStageFloats = 8192;  // C * tile staged by a block, at most
constexpr int kMinTile = 32;        // 128 bytes of a row
constexpr int kMaxTile = 256;
constexpr int kMaxChannels = 512;   // 64 KB staged at the smallest tile
constexpr int kMaxStates = 1024;    // Welford states of a block: tile x split
constexpr int kBatch = 4;           // loads a thread keeps in flight, per tensor
constexpr int kAccumulators = 2;    // running states a thread of the reduction keeps

// torch.var_mean's running state (ATen/native/SharedReduceOps.h WelfordData)
// and its two steps, written as WelfordOps writes them so that nvcc rounds
// and contracts them alike.
struct Welford {
  float mean, m2, nf;
  int n;
};

__device__ __forceinline__ Welford welford_reduce(Welford acc, float data) {
  const int new_n = acc.n + 1;
  const float new_nf = static_cast<float>(new_n);
  const float delta = data - acc.mean;
  const float new_mean = acc.mean + delta / new_nf;
  const float new_delta = data - new_mean;
  return {new_mean, acc.m2 + delta * new_delta, new_nf, new_n};
}

__device__ __forceinline__ Welford welford_combine(Welford a, Welford b) {
  if (a.nf == 0) return b;
  if (b.nf == 0) return a;
  const float delta = b.mean - a.mean;
  const float new_count = a.nf + b.nf;
  const float nb_over_n = b.nf / new_count;
  return {a.mean + delta * nb_over_n,
          a.m2 + b.m2 + delta * delta * a.nf * nb_over_n, new_count, -1};
}

__device__ __forceinline__ float relu_add(float z, float bias, float x) {
  const float v = z + bias;
  return (isnan(v) ? v : fmaxf(v, 0.f)) + x;  // torch.relu: clamp_min(v, 0)
}

// (y - mean) * rstd * weight + beta, rounded after each operation
__device__ __forceinline__ float affine(float y, float mean, float rstd,
                                        float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y, mean), rstd), w), b);
}

// kVec: T % 4 == 0 and every pointer 16-byte aligned, so that each float4 of
// a row lies wholly inside or wholly past its end.  `split`: the threads
// PyTorch's reduction splits C over (channel c goes to thread c % split).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
residual_epilogue_kernel(const float* __restrict__ z,
                         const float* __restrict__ x,
                         const float* __restrict__ conv_bias,
                         const float* __restrict__ weight,
                         const float* __restrict__ beta,
                         float* __restrict__ out, int C, int T, int tile,
                         int tiles, int split, float eps) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);  // [C][tile]
  float* state_mean = stage + C * tile;             // [split][tile] each
  float* state_m2 = state_mean + split * tile;
  float* state_nf = state_m2 + split * tile;
  __shared__ __align__(16) float mean_s[kMaxTile];
  __shared__ __align__(16) float rstd_s[kMaxTile];

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int valid = min(tile, T - t0);
  const size_t base = static_cast<size_t>(b) * C * T + t0;
  const int tid = threadIdx.x;
  constexpr int kWidth = kVec ? 4 : 1;
  const int per_row = tile / kWidth;  // tile and per_row: powers of two
  const int row_shift = __ffs(per_row) - 1;
  const int col_shift = __ffs(tile) - 1;
  const int items = C * per_row;

  // 1. stage y = relu(z + conv_bias) + x; columns past T stage 0
  for (int i0 = tid; i0 < items; i0 += kThreads * kBatch) {
    float4 zv[kBatch], xv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      const int c = i >> row_shift, j = (i & (per_row - 1)) * kWidth;
      zv[k] = xv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < items && j < valid) {
        const size_t off = base + static_cast<size_t>(c) * T + j;
        if (kVec) {
          zv[k] = __ldg(reinterpret_cast<const float4*>(z + off));
          xv[k] = __ldg(reinterpret_cast<const float4*>(x + off));
        } else {
          zv[k].x = __ldg(z + off);
          xv[k].x = __ldg(x + off);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      if (i >= items) break;
      const int c = i >> row_shift, j = (i & (per_row - 1)) * kWidth;
      float* dst = stage + c * tile + j;
      if (j >= valid) {
        if (kVec) *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        else *dst = 0.f;
        continue;
      }
      const float bc = __ldg(conv_bias + c);
      if (kVec) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            relu_add(zv[k].x, bc, xv[k].x), relu_add(zv[k].y, bc, xv[k].y),
            relu_add(zv[k].z, bc, xv[k].z), relu_add(zv[k].w, bc, xv[k].w));
      } else {
        *dst = relu_add(zv[k].x, bc, xv[k].x);
      }
    }
  }
  __syncthreads();

  // 2. per column, torch.var_mean's Welford sums in its order.  Part p of a
  // column takes channels p, p + split, p + 2 split, ... into kAccumulators
  // running states in turn, then combines them (Reduce.cuh
  // thread_reduce_impl); the parts are combined in the reduction's tree
  // (block_y_reduce).  A warp takes 32 neighbouring columns of one part: no
  // bank conflicts.
  for (int s = tid; s < split * tile; s += kThreads) {
    const int col = s & (tile - 1), part = s >> col_shift;
    Welford acc[kAccumulators];
#pragma unroll
    for (int k = 0; k < kAccumulators; ++k) acc[k] = {0.f, 0.f, 0.f, 0};
    int c = part;
    for (; c + (kAccumulators - 1) * split < C; c += kAccumulators * split) {
#pragma unroll
      for (int k = 0; k < kAccumulators; ++k)
        acc[k] = welford_reduce(acc[k], stage[(c + k * split) * tile + col]);
    }
#pragma unroll
    for (int k = 0; k < kAccumulators; ++k, c += split) {
      if (c >= C) break;
      acc[k] = welford_reduce(acc[k], stage[c * tile + col]);
    }
#pragma unroll
    for (int k = 1; k < kAccumulators; ++k) acc[0] = welford_combine(acc[0], acc[k]);
    state_mean[s] = acc[0].mean;
    state_m2[s] = acc[0].m2;
    state_nf[s] = acc[0].nf;
  }
  for (int offset = split / 2; offset > 0; offset /= 2) {
    __syncthreads();
    for (int s = tid; s < offset * tile; s += kThreads) {
      const int o = s + offset * tile;
      const Welford a = welford_combine(
          {state_mean[s], state_m2[s], state_nf[s], -1},
          {state_mean[o], state_m2[o], state_nf[o], -1});
      state_mean[s] = a.mean;
      state_m2[s] = a.m2;
      state_nf[s] = a.nf;
    }
  }
  __syncthreads();
  for (int col = tid; col < tile; col += kThreads) {
    const float var = state_m2[col] / state_nf[col];  // correction 0
    mean_s[col] = state_mean[col];
    rstd_s[col] = rsqrtf(var + eps);
  }
  __syncthreads();

  // 3. out = (y - mean) * rstd * weight + beta, written once
  for (int i = tid; i < items; i += kThreads) {
    const int c = i >> row_shift, j = (i & (per_row - 1)) * kWidth;
    if (j >= valid) continue;
    const float wc = __ldg(weight + c), bc = __ldg(beta + c);
    const size_t off = base + static_cast<size_t>(c) * T + j;
    const float* src = stage + c * tile + j;
    if (kVec) {
      const float4 y = *reinterpret_cast<const float4*>(src);
      const float4 m = *reinterpret_cast<const float4*>(mean_s + j);
      const float4 r = *reinterpret_cast<const float4*>(rstd_s + j);
      *reinterpret_cast<float4*>(out + off) = make_float4(
          affine(y.x, m.x, r.x, wc, bc), affine(y.y, m.y, r.y, wc, bc),
          affine(y.z, m.z, r.z, wc, bc), affine(y.w, m.w, r.w, wc, bc));
    } else {
      out[off] = affine(*src, mean_s[j], rstd_s[j], wc, bc);
    }
  }
}

int last_pow2(int n) {  // as Reduce.cuh's
  n |= (n >> 1);
  n |= (n >> 2);
  n |= (n >> 4);
  n |= (n >> 8);
  n |= (n >> 16);
  return n - (n >> 1) > 1 ? n - (n >> 1) : 1;
}

// The threads over which torch.var_mean(y, dim=1) on a fresh (so aligned)
// contiguous (B, C, T) float32 tensor splits each output's C inputs:
// Reduce.cuh setReduceConfig's block_height when it splits across warps,
// else 1.  The reduction vectorizes along T by 4, 2 or 1 outputs a thread,
// whatever divides T, and runs 512 / that threads a block; it splits C once
// it gives each thread at least min(16 x block_height, 256) values.  With
// C <= kMaxChannels no thread keeps 256 values, so it never splits C across
// blocks.
int welford_split(long long outputs, int C, int T) {
  const int vec = T % 4 == 0 ? 4 : T % 2 == 0 ? 2 : 1;
  const int max_threads = 512 / vec;
  const long long dim0 = outputs / vec;
  const int dim0_pow2 = dim0 < max_threads ? last_pow2(static_cast<int>(dim0))
                                           : max_threads;
  const int dim1_pow2 = C < max_threads ? last_pow2(C) : max_threads;
  const int width = dim0_pow2 < 32 ? dim0_pow2 : 32;
  const int height = dim1_pow2 < max_threads / width ? dim1_pow2
                                                     : max_threads / width;
  const int threshold = 16 * height < 256 ? 16 * height : 256;
  return C >= threshold ? height : 1;
}

int tile_for(int C, int split) {
  int tile = kMaxTile;
  while (tile > kMinTile && C * tile > kStageFloats) tile >>= 1;
  while (tile > 4 && tile * split > kMaxStates) tile >>= 1;
  return tile;
}

template <bool kVec>
cudaError_t launch(const float* z, const float* x, const float* conv_bias,
                   const float* weight, const float* beta, float* out, int B,
                   int C, int T, float eps, cudaStream_t stream) {
  const int split = welford_split(static_cast<long long>(B) * T, C, T);
  const int tile = tile_for(C, split);
  const int tiles = (T + tile - 1) / tile;
  const size_t smem_bytes =
      static_cast<size_t>(C + 3 * split) * tile * sizeof(float);
  residual_epilogue_kernel<kVec><<<B * tiles, kThreads, smem_bytes, stream>>>(
      z, x, conv_bias, weight, beta, out, C, T, tile, tiles, split, eps);
  return cudaGetLastError();
}

// The largest stage any C takes, and the SM's memory given to shared memory
// first (the kernel reuses nothing through L1 but the three (C,) vectors).
template <bool kVec>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      residual_epilogue_kernel<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (kMaxChannels * kMinTile + 3 * kMaxStates) * static_cast<int>(sizeof(float)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(residual_epilogue_kernel<kVec>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Sets the kernel's attributes on the current device; called once a device
// before its first launch.  Returns the error, else cudaSuccess.
extern "C" int residual_epilogue_init() {
  cudaError_t err = set_attributes<true>();
  if (err == cudaSuccess) err = set_attributes<false>();
  return static_cast<int>(err);
}

// z, x, out: (B, C, T) float32; conv_bias, weight, beta: (C,) float32; all
// contiguous on the current device, which residual_epilogue_init has set up;
// C at most kMaxChannels.  Launches on
// `stream` without synchronizing and returns the launch error, else
// cudaSuccess.
extern "C" int residual_epilogue_launch(const void* z, const void* x,
                                        const void* conv_bias,
                                        const void* weight, const void* beta,
                                        void* out, int B, int C, int T,
                                        float eps, void* stream) {
  if (B <= 0 || C <= 0 || C > kMaxChannels || T <= 0 ||
      static_cast<long long>(B) * T > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = T % 4 == 0 && aligned16(z) && aligned16(x) && aligned16(out);
  auto s = static_cast<cudaStream_t>(stream);
  auto zf = static_cast<const float*>(z), xf = static_cast<const float*>(x);
  auto cb = static_cast<const float*>(conv_bias);
  auto w = static_cast<const float*>(weight), bt = static_cast<const float*>(beta);
  auto o = static_cast<float*>(out);
  const cudaError_t err =
      vec ? launch<true>(zf, xf, cb, w, bt, o, B, C, T, eps, s)
          : launch<false>(zf, xf, cb, w, bt, o, B, C, T, eps, s);
  return static_cast<int>(err);
}
