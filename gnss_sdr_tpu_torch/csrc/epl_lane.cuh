// One window lane of the Early/Prompt/Late correlation: the per-lane body
// shared by kernel B5 (epl_correlator.cu, one epoch a launch) and kernel
// B7 (track_block_scan.cu, a block of epochs a launch), so the two compute
// the same products in the same order.
//
// Per lane i of a channel's window, with the channel's epoch NCO q:
//   phase  = acc + i * step                      (uint32, wrapping)
//   theta  = float(phase) * f32(2 pi / 2^32)
//   wre    = re * cos + im * sin,  wim = im * cos - re * sin
//   chip j = code[(base_idx + floor(x)) mod n_code],
//            x = fma(j, cps, frac) * os, at ramp index j = i + shift
//            (early), i (prompt), i - shift (late); with interp the chip
//            blends into the next one by x - floor(x) (an fma)
//   s[0..5] += wre*E, wim*E, wre*P, wim*P, wre*L, wim*L.
//
// The plain PyTorch version is epl_correlate_one_shift in
// gnss_sdr_tpu_torch/ops/correlator.py. Built with --fmad=false: the mix
// rounds each product and sum as the plain version's separate ops do; the
// chip ramp is an explicit fmaf, as XLA fuses it in the JAX package. One
// precise sincosf per lane (not __sincosf, whose error would move the
// sums' ulps).
#pragma once

#include <stdint.h>

namespace epl {

// f32(2 pi / 2^32), the constant the plain version's to_radians rounds to
constexpr float kRadPerCount = (float)(6.283185307179586 / 4294967296.0);

// one channel's epoch as the lanes see it
struct LaneNco {
  uint32_t acc;   // carrier phase at lane 0 (cycle fraction)
  uint32_t step;  // carrier phase step a lane
  int base_idx;   // chip_int * oversample, in [0, n_code)
  float frac;     // fractional chip at lane 0
  float cps;      // chips a sample
  float os;       // oversample, as a float
};

// (base_idx + fl) mod n for base_idx in [0, n) and fl in [-n, 2n), by at
// most two conditional adds or subtracts; outside that, clamped into the
// row (wrap_code_index in ops/cuda/epl_correlator.py is this rule). No
// integer modulo: floor(x) is in [-n, 2n) for any code rate below twice
// the nominal (the ramp spans about one code period).
__device__ __forceinline__ int wrap_index(int base_idx, float fl, int n) {
  const float nf = (float)n;
  int idx = base_idx + (int)fminf(fmaxf(fl, -nf), 3.0f * nf);
  if (idx < 0) {
    idx += n;
  } else {
    if (idx >= n) idx -= n;
    if (idx >= n) idx -= n;
  }
  return min(max(idx, 0), n - 1);
}

__device__ __forceinline__ float chip_at(const float* code, int n_code,
                                         const LaneNco& q, int j,
                                         int interp) {
  float x = fmaf((float)j, q.cps, q.frac) * q.os;
  float fl = floorf(x);
  int idx = wrap_index(q.base_idx, fl, n_code);
  float v = code[idx];
  if (interp) {
    int nxt = idx + 1 == n_code ? 0 : idx + 1;
    v = fmaf(x - fl, code[nxt] - v, v);
  }
  return v;
}

// lane li's six products, added into s
__device__ __forceinline__ void accumulate(float xr, float xi, int li,
                                           const LaneNco& q,
                                           const float* code, int n_code,
                                           int shift, int interp,
                                           float s[6]) {
  uint32_t phase = q.acc + (uint32_t)li * q.step;
  float theta = (float)phase * kRadPerCount;
  float st, ct;
  sincosf(theta, &st, &ct);
  float wre = xr * ct + xi * st;
  float wim = xi * ct - xr * st;
  float e = chip_at(code, n_code, q, li + shift, interp);
  float pr = chip_at(code, n_code, q, li, interp);
  float l = chip_at(code, n_code, q, li - shift, interp);
  s[0] += wre * e;
  s[1] += wim * e;
  s[2] += wre * pr;
  s[3] += wim * pr;
  s[4] += wre * l;
  s[5] += wim * l;
}

}  // namespace epl
