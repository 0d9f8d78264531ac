// Per-channel segment gather for Hopper (sm_90a): ([C, Lseg], [C, Lseg])
// copies of one IQ stream at per-channel 128-aligned starts, the feed of
// the seg tracking layout.
//
// Replaces the Pallas TPU kernel gather_segments
// (gnss_sdr_tpu/ops/pallas/track_block_fused.py:2001: one DMA per channel
// and component). The plain PyTorch version is gather_segments_reference
// in gnss_sdr_tpu_torch/ops/cuda/track_block_epoch.py, an indexing
// expression; the wrapper checks the read bound (starts >= 0, multiples of
// 128, start + Lseg <= len(stream)) on the host before the launch.
//
// Bound on the H100: the bytes, 2 x C x Lseg x 4 read and as many written
// (66 MB per 125 ms block at 32 channels and 2.046 MHz, ~0.02 ms at
// 3.35 TB/s). Design: a grid of (chunks, channels); each thread copies
// 16-byte pieces, neighbouring threads on neighbouring addresses. The
// starts are 128 samples (512 bytes) aligned, so every source row is
// 16-byte aligned wherever the stream is; a stream that is not falls back
// to 4-byte pieces inside the kernel (a template flag), never to another
// path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    gather_segments_kernel(const float* __restrict__ re,
                           const float* __restrict__ im,
                           const int* __restrict__ starts,
                           float* __restrict__ out_re,
                           float* __restrict__ out_im, int l_seg) {
  const int c = blockIdx.y;
  const long long a = starts[c];
  const long long o = (long long)c * l_seg;
  const int stride = gridDim.x * kThreads;
  if constexpr (kVec) {
    const float4* sre = reinterpret_cast<const float4*>(re + a);
    const float4* sim = reinterpret_cast<const float4*>(im + a);
    float4* dre = reinterpret_cast<float4*>(out_re + o);
    float4* dim = reinterpret_cast<float4*>(out_im + o);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < l_seg / 4;
         i += stride) {
      dre[i] = sre[i];
      dim[i] = sim[i];
    }
  } else {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < l_seg; i += stride) {
      out_re[o + i] = re[a + i];
      out_im[o + i] = im[a + i];
    }
  }
}

}  // namespace

extern "C" int gather_segments_launch(const void* re, const void* im,
                                      const void* starts, void* out_re,
                                      void* out_im, int c_channels, int l_seg,
                                      void* stream) {
  if (c_channels < 1 || c_channels > 65535 || l_seg < 1 || l_seg % 128)
    return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)re % 16 == 0) && ((uintptr_t)im % 16 == 0) &&
                   ((uintptr_t)out_re % 16 == 0) &&
                   ((uintptr_t)out_im % 16 == 0);
  const int per_block = kThreads * (vec ? 4 : 1);
  const dim3 grid((l_seg + per_block - 1) / per_block, c_channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(re);
  const float* i = static_cast<const float*>(im);
  const int* st = static_cast<const int*>(starts);
  float* o_r = static_cast<float*>(out_re);
  float* o_i = static_cast<float*>(out_im);
  if (vec)
    gather_segments_kernel<true><<<grid, kThreads, 0, s>>>(r, i, st, o_r, o_i,
                                                           l_seg);
  else
    gather_segments_kernel<false><<<grid, kThreads, 0, s>>>(r, i, st, o_r,
                                                            o_i, l_seg);
  return (int)cudaGetLastError();
}
