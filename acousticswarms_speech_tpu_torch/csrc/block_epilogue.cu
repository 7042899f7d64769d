// Fused epilogue of a U-Net block (K6):
//   e   = z + conv_bias[c]          (encoders: z the strided conv1 without bias)
//       | gate[b, c] * z            (SpotNet's decoders: z the upsampling)
//       | z                         (SepNet's decoders)
//   y   = GroupNorm(2)(e) with its affine step (statistics in float32)
//   out = y[:, :C] * sigmoid(y[:, C:])            (GLU over the channels)
// on a (B, 2C, T) float32 input, out (B, C, T): models/modules.py
// EncoderBlock and DecoderBlock, whose plain version is
// ops/block_epilogue.py block_epilogue_plain.
//
// It replaces no TPU kernel.  It was added because the composition of
// PyTorch operations it replaces moves about 30 bytes for each element of e
// (the bias add or gate multiply 8, GroupNorm's statistics 4 and its apply
// 8, sigmoid on half the channels 4, the product 6), and GroupNorm's
// statistics kernel runs one block of 512 threads for each (item, group)
// row: 128 blocks at a sweep chunk of 64, 2S in SepNet, each thread a
// chain of dependent loads and divisions, so that kernel is bound by
// latency at about a tenth of the card's bandwidth.
//
// Bound: bytes.  The function needs 10 bytes an element of e: e read by a
// statistics pass (4) and by an apply pass (4), out written (2).
//
// Same bits as the composition.  SpotNet's output moves by a few 1e-6 when
// one layer sums in another order, which the search's heads amplify past
// what the port may differ from its reference.  So every rounding is the
// composition's (torch 2.11.0's group_norm_kernel.cu, held to the installed
// torch's bits by the card's tests):
//  - statistics: RowwiseMomentsCUDAKernel gives row r = (b, g), of
//    N = C * T elements, to `chains` = 512 threads (32 if N < 512); thread
//    j runs torch.var_mean's Welford step over elements j, j + chains, ...
//    in order, then the threads are combined by block_reduce.cuh's
//    BlockReduce: a shuffle-down tree in each warp, then the same tree over
//    the warps' results (lanes past the last warp hold the identity);
//  - mean and rstd = rsqrtf(m2 / n + eps); ComputeFusedParamsCUDAKernel's
//    scale = rstd * gamma[c] and shift = -scale * mean + beta[c], each
//    operation rounded alone, and the apply step scale * e + shift as one
//    fused multiply-add, as torch's kernels round them;
//  - sigmoid as 1 / (1 + expf(-y)), the product rounded alone.
// The bias add and the gate multiply round alone, as the separate kernels.
//
// The parallelism comes back in how the chains are laid out, not in their
// order: the chains of a row are independent until the final combine, so
// the statistics pass gives each chain one thread but spreads a row's
// chains over `chains / width` blocks of `width` threads (128, or down to
// one warp where the rows are few), and each thread keeps the next `depth`
// elements of its chain in flight (double-buffered in registers) while it
// runs the current ones.  Each warp reduces its 32 chains with the
// shuffle tree and writes one partial; the apply pass starts each block by
// combining its item's 16 partials a group in the cross-warp tree (one
// warp a group), so no atomics and no third kernel: the result is
// deterministic.  The apply pass reads the two halves of e with 16-byte
// loads where T % 4 == 0 and the pointers are aligned.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowThreads = 512;  // RowwiseMomentsCUDAKernel's block
constexpr int kWarp = 32;
constexpr int kMaxWidth = 128;    // statistics threads a block, at most
constexpr int kApplyThreads = 256;
// chains on the card at or above which 16 elements in flight a chain cover
// the memory's latency; below it a chain keeps 32
constexpr int kManyChains = 32768;

enum Mode { kPlain = 0, kBias = 1, kGate = 2 };

// torch.var_mean's running state (ATen/native/SharedReduceOps.h WelfordData)
// and its two steps, written as WelfordOps writes them so that nvcc rounds
// and contracts them alike (as csrc/residual_epilogue.cu's).  The count is
// kept as a float alone: a chain's count stays below 2^24, where adding 1
// gives what WelfordOps's conversion of its integer count gives.
struct Welford {
  float mean, m2, nf;
};

__device__ __forceinline__ Welford welford_reduce(Welford acc, float data) {
  const float new_nf = acc.nf + 1.f;
  const float delta = data - acc.mean;
  const float new_mean = acc.mean + delta / new_nf;
  const float new_delta = data - new_mean;
  return {new_mean, acc.m2 + delta * new_delta, new_nf};
}

__device__ __forceinline__ Welford welford_combine(Welford a, Welford b) {
  if (a.nf == 0) return b;
  if (b.nf == 0) return a;
  const float delta = b.mean - a.mean;
  const float new_count = a.nf + b.nf;
  const float nb_over_n = b.nf / new_count;
  return {a.mean + delta * nb_over_n,
          a.m2 + b.m2 + delta * delta * a.nf * nb_over_n, new_count};
}

// block_reduce.cuh WarpReduce: lane 0 ends with the warp's tree
__device__ __forceinline__ Welford warp_reduce(Welford v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    const Welford o = {__shfl_down_sync(0xffffffffu, v.mean, offset),
                       __shfl_down_sync(0xffffffffu, v.m2, offset),
                       __shfl_down_sync(0xffffffffu, v.nf, offset)};
    v = welford_combine(v, o);
  }
  return v;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (d fixed a launch)
struct Divider {
  unsigned int magic;
  int shift;
  __device__ __forceinline__ int div(int n) const {
    const unsigned int u = static_cast<unsigned int>(n);
    return static_cast<int>((__umulhi(u, magic) + u) >> shift);
  }
};

Divider divider_for(int d) {
  int shift = 0;
  while ((1u << shift) < static_cast<unsigned int>(d)) ++shift;
  const uint64_t magic =
      ((uint64_t{1} << 32) * ((uint64_t{1} << shift) - d)) / d + 1;
  return {static_cast<unsigned int>(magic), shift};
}

// e's value as the composition has it before GroupNorm, p the channel's
// bias or gate
template <int kMode>
__device__ __forceinline__ float pre(float z, float p) {
  if (kMode == kBias) return __fadd_rn(z, p);
  if (kMode == kGate) return __fmul_rn(p, z);
  return z;
}

// Row r = blockIdx.x / (chains / width) of e (B * 2 rows of N = C * T
// contiguous elements); thread j of the row's chains runs elements j,
// j + chains, ... with `kDepth` loads in flight, then each warp's tree goes
// to partials[r][j / 32] as (mean, m2, nf).  `vec`: the bias (2C,) or the
// gate (B, 2C); the row's C values start at (r % 2) C or r C.
template <int kMode, int kDepth>
__global__ void __launch_bounds__(kMaxWidth)
block_epilogue_stats_kernel(const float* __restrict__ e,
                            const float* __restrict__ vec,
                            float* __restrict__ partials, int C, int T,
                            int chains, int width, Divider by_t) {
  const int per_row = chains / width;
  const int r = blockIdx.x / per_row;
  const int j = (blockIdx.x - r * per_row) * width + threadIdx.x;
  const int N = C * T;
  const float* x = e + static_cast<size_t>(r) * N;
  const float* p = kMode == kPlain ? nullptr
                                   : vec + (kMode == kGate ? r : (r & 1)) * C;
  const int len = j < N ? (N - 1 - j) / chains + 1 : 0;  // the chain's elements

  float cur[kDepth], nxt[kDepth], pcur[kDepth], pnxt[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    cur[d] = pcur[d] = 0.f;
    if (d < len) {
      const int i = j + d * chains;
      cur[d] = __ldg(x + i);
      if (kMode != kPlain) pcur[d] = __ldg(p + by_t.div(i));
    }
  }
  Welford acc = {0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < len; k0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {  // the next elements, in flight
      nxt[d] = pnxt[d] = 0.f;
      const int k = k0 + kDepth + d;
      if (k < len) {
        const int i = j + k * chains;
        nxt[d] = __ldg(x + i);
        if (kMode != kPlain) pnxt[d] = __ldg(p + by_t.div(i));
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (k0 + d < len) acc = welford_reduce(acc, pre<kMode>(cur[d], pcur[d]));
      cur[d] = nxt[d];
      pcur[d] = pnxt[d];
    }
  }
  acc = warp_reduce(acc);
  if ((threadIdx.x & (kWarp - 1)) == 0) {
    float* out = partials + (static_cast<size_t>(r) * (chains / kWarp) + j / kWarp) * 3;
    out[0] = acc.mean;
    out[1] = acc.m2;
    out[2] = acc.nf;
  }
}

// (y_a, y_b) -> y_a * sigmoid(y_b), each operation rounded as its kernel's
__device__ __forceinline__ float glu(float ya, float yb) {
  return __fmul_rn(ya, 1.f / (1.f + expf(-yb)));
}

// Item b = blockIdx.y of e: warps 0 and 1 combine groups 0 and 1's
// `parts` partials in BlockReduce's cross-warp tree, then the block's
// threads take elements i of out's C * T, kWidth at a time (kVec: T % 4 == 0
// and 16-byte aligned pointers), with channel c = i / T.
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kApplyThreads)
block_epilogue_apply_kernel(const float* __restrict__ e,
                            const float* __restrict__ vec,
                            const float* __restrict__ partials,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            float* __restrict__ out, int C, int T, int parts,
                            float eps, Divider by_t) {
  __shared__ float mean_s[2], rstd_s[2];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  if (warp < 2) {
    Welford v = {0.f, 0.f, 0.f};  // the identity
    if (lane < parts) {
      const float* q = partials + (static_cast<size_t>(2 * b + warp) * parts + lane) * 3;
      v = {q[0], q[1], q[2]};
    }
    v = warp_reduce(v);
    if (lane == 0) {
      const float var = v.m2 / v.nf;  // correction 0
      mean_s[warp] = v.mean;
      rstd_s[warp] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean_a = mean_s[0], rstd_a = rstd_s[0];
  const float mean_b = mean_s[1], rstd_b = rstd_s[1];

  const int N = C * T;
  const float* ea = e + static_cast<size_t>(b) * 2 * N;
  const float* eb = ea + N;
  float* o = out + static_cast<size_t>(b) * N;
  const float* pa = kMode == kPlain ? nullptr : vec + (kMode == kGate ? 2 * b : 0) * C;
  const float* pb = kMode == kPlain ? nullptr : pa + C;
  constexpr int kWidth = kVec ? 4 : 1;
  for (int i = (blockIdx.x * kApplyThreads + threadIdx.x) * kWidth; i < N;
       i += gridDim.x * kApplyThreads * kWidth) {
    const int c = by_t.div(i);
    // ComputeFusedParamsCUDAKernel's (scale, shift) of channels c and C + c
    const float sa = __fmul_rn(rstd_a, __ldg(gamma + c));
    const float ta = __fadd_rn(__fmul_rn(-sa, mean_a), __ldg(beta + c));
    const float sb = __fmul_rn(rstd_b, __ldg(gamma + C + c));
    const float tb = __fadd_rn(__fmul_rn(-sb, mean_b), __ldg(beta + C + c));
    const float qa = kMode == kPlain ? 0.f : __ldg(pa + c);
    const float qb = kMode == kPlain ? 0.f : __ldg(pb + c);
    if (kVec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(ea + i));
      const float4 v = __ldg(reinterpret_cast<const float4*>(eb + i));
      *reinterpret_cast<float4*>(o + i) = make_float4(
          glu(__fmaf_rn(sa, pre<kMode>(a.x, qa), ta),
              __fmaf_rn(sb, pre<kMode>(v.x, qb), tb)),
          glu(__fmaf_rn(sa, pre<kMode>(a.y, qa), ta),
              __fmaf_rn(sb, pre<kMode>(v.y, qb), tb)),
          glu(__fmaf_rn(sa, pre<kMode>(a.z, qa), ta),
              __fmaf_rn(sb, pre<kMode>(v.z, qb), tb)),
          glu(__fmaf_rn(sa, pre<kMode>(a.w, qa), ta),
              __fmaf_rn(sb, pre<kMode>(v.w, qb), tb)));
    } else {
      o[i] = glu(__fmaf_rn(sa, pre<kMode>(__ldg(ea + i), qa), ta),
                 __fmaf_rn(sb, pre<kMode>(__ldg(eb + i), qb), tb));
    }
  }
}

template <int kMode, int kDepth>
void launch_stats(const float* e, const float* vec, float* partials, int rows,
                  int C, int T, int chains, int width, Divider by_t,
                  cudaStream_t stream) {
  block_epilogue_stats_kernel<kMode, kDepth>
      <<<rows * (chains / width), width, 0, stream>>>(e, vec, partials, C, T,
                                                      chains, width, by_t);
}

// As many blocks an item as the SMs hold at once over all items (at least
// one), each running through its share of the item: no second wave.
template <int kMode, bool kVec>
cudaError_t launch_apply(const float* e, const float* vec,
                         const float* partials, const float* gamma,
                         const float* beta, float* out, int B, int C, int T,
                         int parts, float eps, Divider by_t, int sms,
                         cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, block_epilogue_apply_kernel<kMode, kVec>, kApplyThreads, 0);
  if (err != cudaSuccess) return err;
  constexpr int kWidth = kVec ? 4 : 1;
  const long long work = (static_cast<long long>(C) * T + kWidth - 1) / kWidth;
  long long blocks = (work + kApplyThreads - 1) / kApplyThreads;
  const long long fill = static_cast<long long>(per_sm) * sms / B;
  if (blocks > fill) blocks = fill > 0 ? fill : 1;
  block_epilogue_apply_kernel<kMode, kVec>
      <<<dim3(static_cast<unsigned int>(blocks), B), kApplyThreads, 0,
         stream>>>(e, vec, partials, gamma, beta, out, C, T, parts, eps, by_t);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch(const float* e, const float* vec, const float* gamma,
                   const float* beta, float* partials, float* out, int B,
                   int C, int T, float eps, bool vec4, cudaStream_t stream) {
  const int rows = 2 * B;
  const int N = C * T;
  const int chains = N < kRowThreads ? kWarp : kRowThreads;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // one block a row's `width` chains; narrower blocks where the rows are
  // too few to give every SM two blocks
  int width = chains < kMaxWidth ? chains : kMaxWidth;
  while (width > kWarp && rows * (chains / width) < 2 * sms) width /= 2;
  const Divider by_t = divider_for(T);
  if (static_cast<long long>(rows) * chains >= kManyChains)
    launch_stats<kMode, 16>(e, vec, partials, rows, C, T, chains, width, by_t, stream);
  else
    launch_stats<kMode, 32>(e, vec, partials, rows, C, T, chains, width, by_t, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int parts = chains / kWarp;
  return vec4 ? launch_apply<kMode, true>(e, vec, partials, gamma, beta, out,
                                          B, C, T, parts, eps, by_t, sms, stream)
              : launch_apply<kMode, false>(e, vec, partials, gamma, beta, out,
                                           B, C, T, parts, eps, by_t, sms, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// e: (B, 2C, T) float32; vec: null (mode 0), the bias (2C,) (mode 1) or
// the gate (B, 2C) (mode 2); gamma, beta: (2C,); partials: B * 2 * 16 * 3
// floats of scratch (a row's 512 / 32 warps); out: (B, C, T); all
// float32, contiguous, on the current device; T > 1.  Launches both passes
// on `stream` without synchronizing and returns the launch error, else
// cudaSuccess.
extern "C" int block_epilogue_launch(const void* e, const void* vec, int mode,
                                     const void* gamma, const void* beta,
                                     void* partials, void* out, int B, int C,
                                     int T, float eps, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || T <= 1 || mode < kPlain ||
      mode > kGate || (mode != kPlain) != (vec != nullptr) ||
      static_cast<long long>(C) * T >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = T % 4 == 0 && aligned16(e) && aligned16(out);
  auto s = static_cast<cudaStream_t>(stream);
  auto ef = static_cast<const float*>(e), vf = static_cast<const float*>(vec);
  auto g = static_cast<const float*>(gamma), bt = static_cast<const float*>(beta);
  auto pf = static_cast<float*>(partials);
  auto o = static_cast<float*>(out);
  cudaError_t err;
  if (mode == kBias)
    err = launch<kBias>(ef, vf, g, bt, pf, o, B, C, T, eps, vec4, s);
  else if (mode == kGate)
    err = launch<kGate>(ef, vf, g, bt, pf, o, B, C, T, eps, vec4, s);
  else
    err = launch<kPlain>(ef, vf, g, bt, pf, o, B, C, T, eps, vec4, s);
  return static_cast<int>(err);
}
