// One epoch's Early/Prompt/Late correlations of every channel, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel epl_correlate_pallas
// (gnss_sdr_tpu/ops/pallas/epl_correlator.py:104; body _kernel :36). The
// plain PyTorch version of the same arithmetic is epl_correlate_one_shift
// in gnss_sdr_tpu_torch/ops/correlator.py; the wrapper is
// gnss_sdr_tpu_torch/ops/cuda/epl_correlator.py.
//
// Per channel c and window lane i < W:
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
// Design: one thread block per channel. The channel's code row (4 KB for
// GPS L1 C/A, 32 KB for Galileo E1B at two samples per chip) is staged in
// shared memory, since every lane reads it three times at data-dependent
// indices. Each thread strides over the lanes with uint32 phase
// arithmetic and precise sinf/cosf, keeps six f32 sums, and the block
// reduces them by warp shuffles and then across warps. Masked lanes add
// exactly zero, so they are skipped. Built with --fmad=false: the mix
// rounds each product and sum as the plain version's separate ops do; the
// chip ramp is an explicit fmaf, as XLA fuses it in the JAX package. The
// six sums run in another order than the plain version's, so the two
// differ by ulps.
//
// Bound on the H100: per launch at the operating point (C = 32, W = 2054)
// the windows, codes and sums are ~0.66 MB, ~0.2 us at 3.35 TB/s, and the
// ~24 f32 operations per lane are ~1.6 MFLOP, far below that; the launch
// itself (a few microseconds) dominates. Only C of 132 SMs work. Reading
// the windows straight from the block at each channel's start, or one
// kernel for the whole epoch, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// f32(2 pi / 2^32), the constant the plain version's to_radians rounds to
constexpr float kRadPerCount = (float)(6.283185307179586 / 4294967296.0);

struct Params {
  const float* re;
  const float* im;
  const int* n_valid;
  const long long* carr_acc;
  const long long* carr_step;
  const int* chip_int;
  const float* chip_frac;
  const float* cps;
  const float* codes;
  float* out;
  int w, n_code, shift, oversample, interp;
};

__device__ __forceinline__ float chip_at(const float* code, int n_code,
                                         int base_idx, float chip_frac,
                                         float cps, float os, int j,
                                         int interp) {
  float x = fmaf((float)j, cps, chip_frac) * os;
  float fl = floorf(x);
  int idx = (base_idx + (int)fl) % n_code;
  if (idx < 0) idx += n_code;  // floor-mod, as torch.remainder
  float v = code[idx];
  if (interp) {
    int nxt = idx + 1 == n_code ? 0 : idx + 1;
    v = fmaf(x - fl, code[nxt] - v, v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    epl_correlator_kernel(Params p) {
  extern __shared__ float code[];
  __shared__ float partial[6][kWarps];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* row = p.codes + (size_t)c * p.n_code;
  for (int k = tid; k < p.n_code; k += kThreads) code[k] = row[k];
  __syncthreads();

  const int n_valid = min(p.n_valid[c], p.w);
  const uint32_t acc = (uint32_t)p.carr_acc[c];
  const uint32_t step = (uint32_t)p.carr_step[c];
  const int base_idx = p.chip_int[c] * p.oversample;
  const float frac = p.chip_frac[c];
  const float cps = p.cps[c];
  const float os = (float)p.oversample;
  const float* re = p.re + (size_t)c * p.w;
  const float* im = p.im + (size_t)c * p.w;

  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < n_valid; i += kThreads) {
    uint32_t phase = acc + (uint32_t)i * step;
    float theta = (float)phase * kRadPerCount;
    float ct = cosf(theta);
    float st = sinf(theta);
    float x = re[i];
    float y = im[i];
    float wre = x * ct + y * st;
    float wim = y * ct - x * st;
    float e = chip_at(code, p.n_code, base_idx, frac, cps, os, i + p.shift,
                      p.interp);
    float pr = chip_at(code, p.n_code, base_idx, frac, cps, os, i, p.interp);
    float l = chip_at(code, p.n_code, base_idx, frac, cps, os, i - p.shift,
                      p.interp);
    s[0] += wre * e;
    s[1] += wim * e;
    s[2] += wre * pr;
    s[3] += wim * pr;
    s[4] += wre * l;
    s[5] += wim * l;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = s[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) partial[k][tid >> 5] = v;
  }
  __syncthreads();
  if (tid < 6) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += partial[tid][w];
    p.out[c * 6 + tid] = v;
  }
}

}  // namespace

extern "C" int epl_correlator_launch(
    const void* re, const void* im, const void* n_valid, const void* carr_acc,
    const void* carr_step, const void* chip_int, const void* chip_frac,
    const void* cps, const void* codes, void* out, int c_channels, int w,
    int n_code, int shift, int oversample, int interp, void* stream) {
  if (c_channels < 1 || w < 1 || n_code < 1 || shift < 0 || oversample < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.re = static_cast<const float*>(re);
  p.im = static_cast<const float*>(im);
  p.n_valid = static_cast<const int*>(n_valid);
  p.carr_acc = static_cast<const long long*>(carr_acc);
  p.carr_step = static_cast<const long long*>(carr_step);
  p.chip_int = static_cast<const int*>(chip_int);
  p.chip_frac = static_cast<const float*>(chip_frac);
  p.cps = static_cast<const float*>(cps);
  p.codes = static_cast<const float*>(codes);
  p.out = static_cast<float*>(out);
  p.w = w;
  p.n_code = n_code;
  p.shift = shift;
  p.oversample = oversample;
  p.interp = interp;
  size_t smem = (size_t)n_code * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        epl_correlator_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  epl_correlator_kernel<<<c_channels, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
