// One tracking epoch of one channel, for the per-epoch fused tracking
// kernels on Hopper (sm_90a): B3 (track_block_direct.cu) and B4a, B4b and
// B6 (track_block_epoch.cu).
//
// The counterpart of _epoch_core (gnss_sdr_tpu/ops/pallas/
// track_block_fused.py:76), whose plain PyTorch version is
// _epoch_core_reference in gnss_sdr_tpu_torch/ops/cuda/
// track_block_epoch.py (the contract: carrier trig factors, mask, prompt
// select, rolls, discriminators, loop filters, state and telemetry
// columns). A kernel runs one thread block per channel: load_channel puts
// the channel's state (and its replica rows, where they fit) in shared
// memory, run_epoch runs one epoch from the window the kernel's feed
// points at, with the epoch's start lane and prompt roll, and
// store_channel writes the end state. The feeds differ only in where an
// epoch's window lies.
//
// Per epoch:
//   1. every thread derives the epoch's NCO quantities from the state in
//      shared memory; threads build the carrier's outer-product trig
//      factors (B per lane mod 128, A per 128-lane group) in shared memory;
//   2. each thread mixes its lanes straight from the window in global
//      memory; lanes outside the epoch's mask add exactly zero, so they
//      are not read. The prompt at lane l is the selected row at
//      (l - rem_i) mod wp (the TPU kernel's right roll), early and late at
//      l +- el_shift of that (its E/L rolls, with the wrap the mask
//      zeroes);
//   3. a block reduction forms the six f32 correlations;
//   4. thread 0 runs the discriminators, lock, loop filters and death,
//      writes the telemetry row and the new state to shared memory.
// Built with --fmad=false so every scalar step rounds as the plain
// version's separate ops do; the carrier phase and chip ledger advances
// are explicit fmaf, as XLA fuses them in the TPU kernel. The
// correlations' f32 sums run in another order than the plain version's,
// so the two differ by ulps there.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace epoch {

constexpr int kFields = 128;
constexpr int kTelem = 17;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDrift = 8;
// carrier A factors: one thread each beside the 128 B-factor threads, so
// wp <= 128 * 128 (the JAX kernel's limit, ROADMAP C6)
constexpr int kMaxW128 = kThreads - 128;
// replica rows larger than this are read from global memory (through
// L1/L2) instead of shared memory
constexpr size_t kMaxSmemReps = 192 * 1024;

// constants rounded double -> float, as torch.tensor(x, float32) does
constexpr float kTwoPi = (float)6.283185307179586;
constexpr float kInvTwoPi = (float)(1.0 / 6.283185307179586);
constexpr float kHalfPi = (float)(3.141592653589793 / 2.0);

struct Params {  // what every feed shares
  const float* replicas;  // [C, n_drift, wp] f32
  const float* state_in;  // [C, 128]
  float* telem;           // [T, C, 17]
  float* state_out;       // [C, 128]
  int c_channels, t_epochs, n0, wp, n_drift, el_shift;
  float fs_code_len, inv_fs, code_len, lock_threshold, max_lost_f;
  float pll_c1, pll_c2, dll_c1, dll_c2;
  float aiding_scale, if_freq, costas_thr;
  int aiding, costas, interp, reps_in_smem;
};

// Params from a launch's arguments; returns a CUDA error code (0 when the
// arguments are usable).
inline int make_params(Params& p, const void* replicas, const void* state_in,
                       void* telem, void* state_out, int c_channels,
                       int t_epochs, int n0, int wp, int n_drift, float fs,
                       float code_len, float lock_threshold, int max_lost,
                       float pll_c1, float pll_c2, float dll_c1, float dll_c2,
                       int el_shift, float aiding_scale, float if_freq,
                       int costas, float costas_thr, int interp) {
  if (n_drift < 1 || n_drift > kMaxDrift || wp <= 0 || wp % 128 ||
      wp / 128 > kMaxW128 || c_channels < 1 || t_epochs < 1 || n0 < 1 ||
      el_shift < 0 || el_shift >= wp)
    return (int)cudaErrorInvalidValue;
  p.replicas = static_cast<const float*>(replicas);
  p.state_in = static_cast<const float*>(state_in);
  p.telem = static_cast<float*>(telem);
  p.state_out = static_cast<float*>(state_out);
  p.c_channels = c_channels;
  p.t_epochs = t_epochs;
  p.n0 = n0;
  p.wp = wp;
  p.n_drift = n_drift;
  p.el_shift = el_shift;
  // f32(fs) * f32(L) rounded once, as the plain version's constant
  p.fs_code_len = fs * code_len;
  p.inv_fs = 1.0f / fs;
  p.code_len = code_len;
  p.lock_threshold = lock_threshold;
  p.max_lost_f = (float)max_lost;
  p.pll_c1 = pll_c1;
  p.pll_c2 = pll_c2;
  p.dll_c1 = dll_c1;
  p.dll_c2 = dll_c2;
  p.aiding_scale = aiding_scale;
  p.if_freq = if_freq;
  p.costas_thr = costas_thr;
  p.aiding = aiding_scale != 0.0f;
  p.costas = costas;
  p.interp = interp;
  p.reps_in_smem =
      (size_t)n_drift * (size_t)wp * sizeof(float) <= kMaxSmemReps;
  return 0;
}

// dynamic shared memory of one thread block
inline size_t smem_bytes(const Params& p) {
  const int w128 = p.wp / 128;
  const size_t reps = p.reps_in_smem ? (size_t)p.n_drift * p.wp : 0;
  return (reps + 256 + 2 * w128 + 6 * kWarps + 12) * sizeof(float);
}

// set the kernel's shared-memory ceiling, launch one thread block per
// channel, and return the launch's error code
template <class Feed>
inline int launch(void (*kernel)(Params, Feed), const Params& p,
                  const Feed& f, void* stream) {
  const size_t smem = smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.c_channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, f);
  return (int)cudaGetLastError();
}

__device__ inline float atan_poly(float x) {
  // Abramowitz-Stegun 4.4.49 (max error ~1e-5 rad): the TPU kernel's
  // PLL discriminator, kept as is
  float ax = fabsf(x);
  bool inv = ax > 1.0f;
  float z = inv ? 1.0f / fmaxf(ax, (float)1e-20) : ax;
  float t = z * z;
  float p = z * ((float)0.9998660 +
                 t * ((float)-0.3302995 +
                      t * ((float)0.1801410 +
                           t * ((float)-0.0851330 + (float)0.0208351 * t))));
  float r = inv ? kHalfPi - p : p;
  return x < 0.0f ? -r : r;
}

struct Epoch {  // one epoch's NCO quantities (every thread derives them)
  float dc, n_t, step, start_lane, phi0;
  float w_lo, w_hi;  // prompt weights of rows lo = hi - 1 and hi
  int lo, hi;        // selected rows (or -1)
  int rem_i;
};

__device__ inline Epoch epoch_nco(const Params& p, const float* st,
                                  float start_lane, int rem_i) {
  Epoch q;
  const float carr_freq = st[0], carr_phase = st[1], code_rate = st[3];
  const float chip_res = st[4], drift = st[8], frac0 = st[10];
  float rate_eff = p.aiding
                       ? code_rate + (carr_freq - p.if_freq) * p.aiding_scale
                       : code_rate;
  q.dc = rate_eff * p.inv_fs;
  q.n_t = rintf(p.fs_code_len / rate_eff);
  q.start_lane = start_lane;
  q.step = carr_freq * p.inv_fs;
  q.phi0 = carr_phase - q.start_lane * q.step;
  q.rem_i = rem_i;
  // prompt select: the row whose drift shift matches, and with interp
  // the row below it weighted by the fractional sample
  const int half = (p.n_drift - 1) / 2;
  float qq = (chip_res + frac0) / q.dc;
  float qf = floorf(qq);
  float shift = drift - qf;
  q.hi = -1;
  q.lo = -1;
  for (int d = 0; d < p.n_drift; ++d) {
    if (shift == (float)(d - half)) q.hi = d;
    if (p.interp && shift == (float)(d - half + 1)) q.lo = d;
  }
  if (p.interp) {
    float f_sub = qq - qf;
    q.w_hi = 1.0f - f_sub;
    q.w_lo = f_sub;
  } else {
    q.w_hi = 1.0f;
    q.w_lo = 0.0f;
  }
  return q;
}

// the (rolled) prompt replica at window lane x (any integer in
// (-wp, 2wp)); the sum over rows in row order, as the TPU kernel's
__device__ __forceinline__ float prompt_at(const float* reps, const Epoch& q,
                                           int wp, int x) {
  int i = x % wp;
  if (i < 0) i += wp;
  float v = 0.0f;
  if (q.lo >= 0) v = q.w_lo * reps[q.lo * wp + i];
  if (q.hi >= 0) v = v + q.w_hi * reps[q.hi * wp + i];
  return v;
}

struct Smem {  // one channel's working set
  const float* reps;  // [n_drift, wp]: shared memory, or global memory
  float* b_cos;       // [128]
  float* b_sin;
  float* a_cos;       // [w128]
  float* a_sin;
  float* red;         // [6, kWarps]
  float* st;          // [12] state columns
};

// lay out the shared memory, load channel c's state and (where they fit)
// its replica rows
__device__ inline Smem load_channel(const Params& p, float* smem, int c) {
  const int tid = threadIdx.x, w128 = p.wp / 128;
  const float* g_reps = p.replicas + (long long)c * p.n_drift * p.wp;
  Smem s;
  float* cur = smem;
  if (p.reps_in_smem) {
    const float4* src = reinterpret_cast<const float4*>(g_reps);
    float4* dst = reinterpret_cast<float4*>(cur);
    for (int i = tid; i < p.n_drift * p.wp / 4; i += kThreads) dst[i] = src[i];
    s.reps = cur;
    cur += p.n_drift * p.wp;
  } else {
    s.reps = g_reps;
  }
  s.b_cos = cur;
  s.b_sin = s.b_cos + 128;
  s.a_cos = s.b_sin + 128;
  s.a_sin = s.a_cos + w128;
  s.red = s.a_sin + w128;
  s.st = s.red + 6 * kWarps;
  if (tid < 12) s.st[tid] = p.state_in[c * kFields + tid];
  __syncthreads();
  return s;
}

__device__ inline void store_channel(const Params& p, const Smem& s, int c) {
  const int tid = threadIdx.x;
  if (tid < kFields)
    p.state_out[c * kFields + tid] = tid < 12 ? s.st[tid] : 0.0f;
}

// epoch t of channel c: the epoch's window starts at wre/wim (lane 0), its
// first sample sits at start_lane, and the prompt rolls right by rem_i
__device__ inline void run_epoch(const Params& p, const Smem& s,
                                 const float* __restrict__ wre,
                                 const float* __restrict__ wim,
                                 float start_lane, int rem_i, int t, int c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = p.wp, w128 = wp / 128;
  const Epoch q = epoch_nco(p, s.st, start_lane, rem_i);

  // ---- stage 1: carrier trig factors --------------------------------
  if (tid < 128) {
    float th = q.step * (float)tid;
    th = (th - floorf(th)) * kTwoPi;
    s.b_cos[tid] = cosf(th);
    s.b_sin[tid] = sinf(th);
  } else if (tid - 128 < w128) {
    int qd = tid - 128;
    float th = q.phi0 + (q.step * 128.0f) * (float)qd;
    th = (th - floorf(th)) * kTwoPi;
    s.a_cos[qd] = cosf(th);
    s.a_sin[qd] = sinf(th);
  }
  __syncthreads();

  // ---- stage 2: mix the in-mask lanes, six correlations ---------------
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const float end = q.start_lane + q.n_t;
  for (int l = tid; l < wp; l += kThreads) {
    const float lf = (float)l;
    if (!(lf >= q.start_lane && lf < end)) continue;  // mask: adds 0
    const int qd = l >> 7, r = l & 127;
    const float ac = s.a_cos[qd], as = s.a_sin[qd];
    const float cth = ac * s.b_cos[r] - as * s.b_sin[r];
    const float sth = as * s.b_cos[r] + ac * s.b_sin[r];
    const float xre = wre[l], xim = wim[l];
    const float m_re = xre * cth + xim * sth;
    const float m_im = xim * cth - xre * sth;
    const int x = l - q.rem_i;
    const float pe = prompt_at(s.reps, q, wp, x + p.el_shift);
    const float pp = prompt_at(s.reps, q, wp, x);
    const float pl = prompt_at(s.reps, q, wp, x - p.el_shift);
    acc[0] += m_re * pe;
    acc[1] += m_im * pe;
    acc[2] += m_re * pp;
    acc[3] += m_im * pp;
    acc[4] += m_re * pl;
    acc[5] += m_im * pl;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s.red[k * kWarps + warp] = v;
  }
  __syncthreads();

  // ---- stage 3: discriminators, lock, loop filters (thread 0) ---------
  if (tid == 0) {
    float corr[6];
    for (int k = 0; k < 6; ++k) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += s.red[k * kWarps + w];
      corr[k] = v;
    }
    float* st = s.st;
    const float i_e = corr[0], q_e = corr[1], i_p = corr[2];
    const float q_p = corr[3], i_l = corr[4], q_l = corr[5];
    const float carr_freq = st[0], carr_phase = st[1], carr_err = st[2];
    const float code_rate = st[3], chip_res = st[4], code_err = st[5];
    const float lost = st[6], active = st[7], drift = st[8];
    const float lock_ema = st[11];

    const float power = i_p * i_p + q_p * q_p;
    float new_le;
    bool locked;
    if (p.costas) {
      const float alpha = (float)0.1;
      float metric = (i_p * i_p - q_p * q_p) / fmaxf(power, (float)1e-12);
      new_le = active > 0.5f ? (1.0f - alpha) * lock_ema + alpha * metric
                             : lock_ema;
      locked = new_le > p.costas_thr;
    } else {
      new_le = lock_ema;
      locked = power > p.lock_threshold;
    }
    float safe_ip = fabsf(i_p) < (float)1e-12 ? (float)1e-12 : i_p;
    float pll = atan_poly(q_p / safe_ip) * kInvTwoPi;
    float carr_nco = pll * p.pll_c1 + (pll - carr_err) * p.pll_c2;
    float pe = sqrtf(i_e * i_e + q_e * q_e);
    float pl = sqrtf(i_l * i_l + q_l * q_l);
    float el_sum = pe + pl;
    float dll = el_sum > 0.0f ? (pe - pl) / fmaxf(el_sum, (float)1e-12)
                              : 0.0f;
    float code_nco = dll * p.dll_c1 + (dll - code_err) * p.dll_c2;

    const bool act = active > 0.5f;
    const bool upd = act && locked;
    float new_cf = upd ? carr_freq + carr_nco : carr_freq;
    float new_ce = upd ? pll : carr_err;
    float new_cr = upd ? code_rate + code_nco : code_rate;
    float new_de = upd ? dll : code_err;
    float new_lost = act ? (locked ? 0.0f : lost + 1.0f) : lost;
    bool died = new_lost >= p.max_lost_f;
    float new_active = died ? 0.0f : active;
    float ncp = fmaf(q.step, q.n_t, carr_phase);
    float new_cp = ncp - floorf(ncp);
    float new_chip = fmaf(q.dc, q.n_t, chip_res) - p.code_len;
    float new_drift = (drift + q.n_t) - (float)p.n0;

    const float wr = act ? 1.0f : 0.0f;
    float* out = p.telem + ((long long)t * p.c_channels + c) * kTelem;
    out[0] = i_e * wr;  out[1] = q_e * wr;
    out[2] = i_p * wr;  out[3] = q_p * wr;
    out[4] = i_l * wr;  out[5] = q_l * wr;
    out[6] = power * wr;
    out[7] = upd ? 1.0f : 0.0f;
    out[8] = pll * wr;  out[9] = dll * wr;
    out[10] = act ? new_cf : carr_freq;
    out[11] = act ? new_cr : code_rate;
    out[12] = q.n_t;    out[13] = drift;
    out[14] = chip_res * wr;
    out[15] = (died && act) ? 1.0f : 0.0f;
    out[16] = wr;

    if (act) {
      st[0] = new_cf; st[1] = new_cp; st[2] = new_ce; st[3] = new_cr;
      st[4] = new_chip; st[5] = new_de; st[6] = new_lost;
      st[8] = new_drift;
    }
    st[7] = new_active;
    st[11] = died ? 0.0f : new_le;  // 9 and 10 carry through
  }
  __syncthreads();
}

}  // namespace epoch
