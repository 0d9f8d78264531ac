// One epoch's Early/Prompt/Late correlations of every channel, for Hopper
// (sm_90a): kernel B5.
//
// Replaces the Pallas TPU kernel epl_correlate_pallas
// (gnss_sdr_tpu/ops/pallas/epl_correlator.py:104; body _kernel :36). The
// plain PyTorch version of the same arithmetic is epl_correlate_one_shift
// in gnss_sdr_tpu_torch/ops/correlator.py; the wrapper is
// gnss_sdr_tpu_torch/ops/cuda/epl_correlator.py.
//
// Per channel c and window lane i < W, the window being the block's
// samples [start[c], start[c] + W):
//   phase  = carr_acc + i * carr_step            (uint32, wrapping)
//   theta  = float(phase) * f32(2 pi / 2^32)
//   wre    = re * cos + im * sin,  wim = im * cos - re * sin
//            (zero for i >= n_valid, the epoch mask)
//   chip j = code[(chip_int * os + floor(x)) mod L*os],
//            x = fma(j, cps, chip_frac) * os, at ramp index j = i - shift
//            (late), i (prompt), i + shift (early); with interp the chip
//            blends into the next one by x - floor(x) (an fma)
//   out[c] = the six sums wre*E, wim*E, wre*P, wim*P, wre*L, wim*L.
//
// What bounds it on the H100: per launch at the operating point (C = 32,
// W = 2054) the windows, codes and sums are 658,560 bytes, 0.196 us at
// 3.35 TB/s; its ~24 f32 operations per lane are ~1.6 MFLOP, 0.024 us at
// 67 TFLOP/s. So the bound is bytes, and what a launch really costs is
// its latency: the launch itself, one round of dependent loads and the
// reduction.
//
// The design against that:
//  * The windows are read straight from the block at each channel's
//    start, so the tracker builds no [C, W] copies (two gathers and an
//    index tensor per epoch before). The [C, W] entry point is this
//    kernel over the flattened windows with starts c * W.
//  * A cluster of S blocks per channel (the wrapper picks S: C * S within
//    two blocks per SM, 8 at C = 32, so every SM works instead of 32 of
//    them): block rank r takes lanes [r * part, (r + 1) * part). Each
//    block reduces its six sums by warp shuffles and then across warps in
//    a fixed order; rank 0 adds the S block sums in rank order through
//    distributed shared memory. No atomics: the same inputs give the
//    same bits on every run, which the tracker's closed loop and the
//    graph-versus-eager check rely on.
//  * The per-lane body (wipe-off, chip ramp, code-index wrap without a
//    modulo, six products) is epl_lane.cuh, shared with kernel B7 (the
//    scanned tracker's block of epochs in one launch). The index wrap
//    equals torch.remainder on the ramps a tracked channel makes
//    (wrap_code_index in the wrapper module is the same rule in torch, and
//    the tests hold the two to torch.remainder); a ledger outside that
//    range (a corrupt state) is clamped into the row, so no lane reads
//    outside it.
//  * Each thread issues its first window loads before it waits for the
//    code row, which is staged in shared memory with cp.async (faster at
//    every cluster size on the H100 than reading the row through __ldg,
//    PERF.md).
//
// Built with --fmad=false: the mix rounds each product and sum as the
// plain version's separate ops do; the chip ramp is an explicit fmaf, as
// XLA fuses it in the JAX package. The six sums run in another order than
// the plain version's, so the two differ by ulps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epl_lane.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;          // window lanes a thread loads ahead
constexpr int kMaxCluster = 8;     // the portable cluster size
struct Params {
  const float* re;         // the block, [n_block]
  const float* im;
  const int* start;        // [C] each window's first sample
  const int* n_valid;
  const long long* carr_acc;
  const long long* carr_step;
  const int* chip_int;
  const float* chip_frac;
  const float* cps;
  const float* codes;      // [C, n_code]
  float* out;              // [C, 6]
  int n_block, w, n_code, shift, oversample, interp;
  int cluster, part;        // blocks per channel, lanes per block
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__global__ void __launch_bounds__(kThreads)
    epl_correlator_kernel(Params p) {
  extern __shared__ float staged[];
  __shared__ float warp_sum[6][kWarps];
  __shared__ float block_sum[6];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = p.cluster;
  const int c = blockIdx.x / cs;
  const int tid = threadIdx.x;

  const float* row = p.codes + (size_t)c * p.n_code;
  for (int k = tid; k < p.n_code; k += kThreads)
    cp_async4(staged + k, row + k);
  asm volatile("cp.async.commit_group;\n" ::);

  const int n_valid = min(p.n_valid[c], p.w);
  const int lo = rank * p.part;
  const int hi = min(lo + p.part, n_valid);
  epl::LaneNco q;
  q.acc = (uint32_t)p.carr_acc[c];
  q.step = (uint32_t)p.carr_step[c];
  q.base_idx = p.chip_int[c] * p.oversample;
  q.frac = p.chip_frac[c];
  q.cps = p.cps[c];
  q.os = (float)p.oversample;
  // the wrapper checks the starts against the block on the host; the
  // clamp keeps every read inside it whatever the card holds
  const int start = min(max(p.start[c], 0), p.n_block - p.w);
  const float* re = p.re + start;
  const float* im = p.im + start;

  float xr[kBatch] = {}, xi[kBatch] = {};
  int i = lo + tid;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    int li = i + b * kThreads;
    if (li < hi) {
      xr[b] = __ldg(re + li);
      xi[b] = __ldg(im + li);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  while (i < hi) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      int li = i + b * kThreads;
      if (li < hi)
        epl::accumulate(xr[b], xi[b], li, q, staged, p.n_code, p.shift,
                        p.interp, s);
    }
    i += kBatch * kThreads;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      int li = i + b * kThreads;
      if (li < hi) {
        xr[b] = __ldg(re + li);
        xi[b] = __ldg(im + li);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = s[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) warp_sum[k][tid >> 5] = v;
  }
  __syncthreads();
  if (tid < 6) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += warp_sum[tid][w];
    block_sum[tid] = v;
  }
  // every block's sums are in its shared memory
  cluster.sync();
  if (rank == 0 && tid < 6) {
    float v = 0.f;
    for (int r = 0; r < cs; ++r)
      v += cluster.map_shared_rank(block_sum, r)[tid];
    p.out[c * 6 + tid] = v;
  }
  // no block leaves while rank 0 reads its sums
  cluster.sync();
}

cudaLaunchConfig_t launch_config(int c_channels, int cluster, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c_channels * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of `cluster` blocks, each with the staged code row of
// n_code floats, the card can hold at once (0: none fits), or a negative
// CUDA error code. Sets the kernel's shared memory limit where the row
// needs more than 48 KB. The wrapper calls it once per shape before the
// first launch, so no launch (nor a graph capture) does.
extern "C" int epl_correlator_max_clusters(int c_channels, int cluster,
                                           int n_code) {
  if (c_channels < 1 || cluster < 1 || cluster > kMaxCluster || n_code < 1)
    return -(int)cudaErrorInvalidValue;
  size_t smem = (size_t)n_code * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        epl_correlator_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return -(int)err;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(c_channels, cluster, smem, 0, attr);
  int n = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, epl_correlator_kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n;
}

extern "C" int epl_correlator_launch(
    const void* re, const void* im, const void* start, const void* n_valid,
    const void* carr_acc, const void* carr_step, const void* chip_int,
    const void* chip_frac, const void* cps, const void* codes, void* out,
    int c_channels, int n_block, int w, int n_code, int shift, int oversample,
    int interp, int cluster, void* stream) {
  if (c_channels < 1 || w < 1 || n_block < w || n_code < 1 || shift < 0 ||
      oversample < 1 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.re = static_cast<const float*>(re);
  p.im = static_cast<const float*>(im);
  p.start = static_cast<const int*>(start);
  p.n_valid = static_cast<const int*>(n_valid);
  p.carr_acc = static_cast<const long long*>(carr_acc);
  p.carr_step = static_cast<const long long*>(carr_step);
  p.chip_int = static_cast<const int*>(chip_int);
  p.chip_frac = static_cast<const float*>(chip_frac);
  p.cps = static_cast<const float*>(cps);
  p.codes = static_cast<const float*>(codes);
  p.out = static_cast<float*>(out);
  p.n_block = n_block;
  p.w = w;
  p.n_code = n_code;
  p.shift = shift;
  p.oversample = oversample;
  p.interp = interp;
  p.cluster = cluster;
  p.part = (w + cluster - 1) / cluster;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(c_channels, cluster, (size_t)n_code * sizeof(float),
                    static_cast<cudaStream_t>(stream), attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, epl_correlator_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
