// Fused whole-block GNSS tracking, mxu layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel track_block_fused_mxu
// (gnss_sdr_tpu/ops/pallas/track_block_fused.py:1872; body _mxu_kernel
// :1603 driving _mxu_run_k :969). The plain PyTorch version of the same
// arithmetic is track_block_fused_mxu_reference in
// gnss_sdr_tpu_torch/ops/cuda/track_block_fused.py, which also states
// the contract (state columns, telemetry columns, held-rate supersteps).
//
// Design: one thread block per channel walks the channel's T/K
// supersteps in order (GPU blocks run in no order, so the TPU's
// sequential grid becomes this loop). Per superstep:
//   1. every thread derives the held NCO rates from the block's state;
//      threads build the carrier's outer-product trig factors (B per
//      lane mod 128, A per 128-lane group and epoch) in shared memory;
//   2. threads mix the K epoch windows straight from global memory,
//      mask them to the epoch and write the bf16 [2K, wp] tile in
//      shared memory, already in the aligned lane frame (the TPU
//      kernel's left roll by rem_i becomes an indexed read);
//   3. each warp forms dot products of one or two tile rows against the
//      [R, wp] bf16 replica bank held in shared memory (bf16 in, f32
//      accumulation, as the TPU kernel's contraction);
//   4. thread 0 runs the E/P/L picks, discriminators, lock chain and
//      loop filters over the K epochs, writes telemetry and the state.
// Built with --fmad=false so the scalar steps round as the plain
// version's (and the JAX kernel's) separate ops do; fma is explicit
// where wanted. The correlations' f32 sums run in another order than
// the plain version's, so the two differ by ulps there.
//
// Shared fetch (kernel B2, replacing _mxu_kernel_shared :1713, which
// the TPU wrapper selects with spread_cap > 0): the template flag
// kShared. The TPU kernel makes one DMA of [span + spread_cap] samples
// per superstep for all channels instead of C overlapping window DMAs.
// Here the grid is still one block per channel, launched in thread-block
// clusters of `cs` blocks (cudaLaunchKernelEx with a cluster dimension);
// each cluster holds the superstep's slice [base + off_j, + span_u) of
// both components in its distributed shared memory, block rank r the
// part [r * chunk, (r + 1) * chunk), chunk a power of two (a sample's
// owner is a shift, its place a mask). Per superstep: a cluster barrier
// (the slice is staged), stage 1a, stage 1b reading sample
// dc + a_e + m of the slice (dc = starts[c] - base) from the owning
// block's shared memory, a second cluster barrier (every block is done
// with the slice), then each block stages its part of the next slice
// while it runs stages 2-4. Every block runs every superstep (idle
// channels run masked), so every block reaches every barrier, and none
// exits while another can still read its shared memory. Only where the
// samples are read from differs from B1, so the result is B1's bit for
// bit. The wrapper checks the slices' read bound on the host.
//
// Telemetry modes: the template flag kLean selects which columns the
// kernel stores (full: all 21 per epoch; lean: the slim2 wire's feed,
// see the wrapper's docstring) and nothing else, so both modes run the
// identical arithmetic and leave the identical state.
//
// Bound on the H100: a few microseconds per 500 ms block (bytes of
// stream, replicas and telemetry over 3.35 TB/s). This kernel uses C of
// the 132 SMs and a serial per-channel chain, so it sits far above it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFields = 128;
constexpr int kTelem = 21;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr int kMaxR = 16;
constexpr int kMaxCluster = 8;  // the portable cluster size

// constants rounded double -> float, as torch.tensor(x, float32) does
constexpr float kTwoPi = (float)6.283185307179586;
constexpr float kInvTwoPi = (float)(1.0 / 6.283185307179586);
constexpr float kHalfPi = (float)(3.141592653589793 / 2.0);

struct Params {
  const float* stream_re;
  const float* stream_im;
  const int* starts;
  const __nv_bfloat16* replicas;
  const float* state_in;
  float* telem;
  float* state_out;
  int c_channels, t_epochs, k_epochs, n0, wp, r_rows;
  float fs, inv_fs, code_len, lock_threshold, max_lost_f;
  float pll_c1, pll_c2, dll_c1, dll_c2, el_f;
  float aiding_scale, if_freq, costas_thr;
  int aiding, costas, interp;
  // shared fetch (B2): the cluster size, each block's part of the slice
  // (a power of two, 2^chunk_shift) and the slice's length, span +
  // spread_cap (samples)
  int cs, chunk, span_u, chunk_shift;
};

__device__ float atan_poly(float x) {
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

// one of the R correlations of a [R] row by a float index; an index
// outside [0, R) picks 0, never an out-of-bounds row
__device__ float pick(const float* row, int r_rows, float idx) {
  float v = 0.0f;
  for (int r = 0; r < r_rows; ++r)
    if ((float)r == idx) v = row[r];
  return v;
}

__device__ float pick_b(const float* row, int r_rows, float idx, bool interp,
                        float f_sub) {
  if (!interp) return pick(row, r_rows, idx);
  return (1.0f - f_sub) * pick(row, r_rows, idx) +
         f_sub * pick(row, r_rows, idx - 1.0f);
}

struct Held {  // superstep-held NCO quantities (every thread derives them)
  float n_t, step, adv, d_drift, d_chip, dc;
  int rem_j;
  long long off;
};

__device__ Held held(const Params& p, const float* st, int j) {
  Held h;
  float carr_freq = st[0], code_rate = st[3];
  float rate_eff = p.aiding
                       ? code_rate + (carr_freq - p.if_freq) * p.aiding_scale
                       : code_rate;
  h.dc = rate_eff * p.inv_fs;
  h.n_t = rintf(p.fs * p.code_len / rate_eff);
  h.step = carr_freq * p.inv_fs;
  h.adv = h.step * h.n_t;
  h.d_drift = h.n_t - (float)p.n0;
  h.d_chip = fmaf(h.dc, h.n_t, -p.code_len);
  long long kk = (long long)j * p.k_epochs * p.n0;
  h.off = (kk / 128) * 128;
  h.rem_j = (int)(kk - h.off);
  return h;
}

__device__ float epoch_sl(const float* st, const Held& h, int e, int n0,
                          int* rem_e_out) {
  int a_e = (e * n0 / 128) * 128;
  int rem_e = e * n0 - a_e;
  *rem_e_out = rem_e;
  float drift_e = st[8] + (float)e * h.d_drift;
  return st[9] + drift_e + (float)rem_e + (float)h.rem_j;
}

// thread 0: stage 3-4 over the K epochs of superstep j; updates st and
// writes telemetry rows [j*K, j*K + K) of channel c
template <bool kLean>
__device__ void chain(const Params& p, float* st, const float* corr,
                      const Held& h, int j, int c) {
  const int K = p.k_epochs, R = p.r_rows;
  const float half_r = (float)((R - 1) / 2);
  const float carr_freq = st[0], carr_phase = st[1], carr_err0 = st[2];
  const float code_rate = st[3], chip_res0 = st[4], code_err0 = st[5];
  const float lost0 = st[6], active0 = st[7], drift0 = st[8];
  const float frac0 = st[10], lock_ema0 = st[11];

  float drift_a[kMaxK], chip_a[kMaxK];
  float ie[kMaxK], qe[kMaxK], ip[kMaxK], qp[kMaxK], il[kMaxK], ql[kMaxK];
  float pw[kMaxK], pll[kMaxK], dll[kMaxK];
  for (int e = 0; e < K; ++e) {
    float ef = (float)e;
    drift_a[e] = drift0 + ef * h.d_drift;
    chip_a[e] = chip_res0 + ef * h.d_chip;
    float qq = (chip_a[e] + frac0) / h.dc;
    float qf = floorf(qq);
    float idx = half_r + (drift_a[e] - qf);
    float fsub = qq - qf;
    bool it = p.interp != 0;
    const float* cre = corr + e * R;
    const float* cim = corr + (K + e) * R;
    ip[e] = pick_b(cre, R, idx, it, fsub);
    qp[e] = pick_b(cim, R, idx, it, fsub);
    ie[e] = pick_b(cre, R, idx - p.el_f, it, fsub);
    qe[e] = pick_b(cim, R, idx - p.el_f, it, fsub);
    il[e] = pick_b(cre, R, idx + p.el_f, it, fsub);
    ql[e] = pick_b(cim, R, idx + p.el_f, it, fsub);
    pw[e] = ip[e] * ip[e] + qp[e] * qp[e];
    float safe_ip = fabsf(ip[e]) < (float)1e-12 ? (float)1e-12 : ip[e];
    pll[e] = atan_poly(qp[e] / safe_ip) * kInvTwoPi;
    float pe = sqrtf(ie[e] * ie[e] + qe[e] * qe[e]);
    float pl = sqrtf(il[e] * il[e] + ql[e] * ql[e]);
    float el_sum = pe + pl;
    dll[e] = el_sum > 0.0f ? (pe - pl) / fmaxf(el_sum, (float)1e-12) : 0.0f;
  }

  float cf_f, ce_f, cr_f, de_f, lo_f, ac_f, le_f, n_act = 0.0f;
  float row[kMaxK][kTelem];
  const bool act0 = active0 > 0.5f;
  if (!p.costas) {
    // power lock: the closed-form lifecycle chain
    bool locked[kMaxK], upd[kMaxK];
    float lo_all[kMaxK], wr[kMaxK], updf[kMaxK], emit[kMaxK];
    float nco_c[kMaxK], nco_d[kMaxK];
    int d_idx = K;
    int last_lk = -1;
    for (int e = 0; e < K; ++e) {
      locked[e] = pw[e] > p.lock_threshold;
      if (locked[e]) last_lk = e;
      lo_all[e] = last_lk >= 0 ? (float)(e - last_lk)
                               : lost0 + (float)e + 1.0f;
      if (lo_all[e] >= p.max_lost_f && d_idx == K) d_idx = e;
    }
    int last_u = -1;
    for (int e = 0; e < K; ++e) {
      bool act = act0 && e <= d_idx;
      upd[e] = act && locked[e];
      wr[e] = act ? 1.0f : 0.0f;
      updf[e] = upd[e] ? 1.0f : 0.0f;
      emit[e] = (act0 && e == d_idx) ? 1.0f : 0.0f;
      n_act += wr[e];
      // loop-filter memory at the start of epoch e: the discriminator
      // of the last update epoch strictly before e
      float ce = last_u >= 0 ? pll[last_u] : carr_err0;
      float de = last_u >= 0 ? dll[last_u] : code_err0;
      nco_c[e] = updf[e] * (pll[e] * p.pll_c1 + (pll[e] - ce) * p.pll_c2);
      nco_d[e] = updf[e] * (dll[e] * p.dll_c1 + (dll[e] - de) * p.dll_c2);
      if (upd[e]) last_u = e;
    }
    float sc = 0.0f, sd = 0.0f;
    for (int e = 0; e < K; ++e) {
      sc += nco_c[e];
      sd += nco_d[e];
      row[e][10] = carr_freq + sc;  // per-epoch post-update rates
      row[e][11] = code_rate + sd;
    }
    cf_f = carr_freq + sc;
    cr_f = code_rate + sd;
    ce_f = last_u >= 0 ? pll[last_u] : carr_err0;
    de_f = last_u >= 0 ? dll[last_u] : code_err0;
    // the lost counter freezes at its death-epoch value
    lo_f = act0 ? lo_all[d_idx < K - 1 ? d_idx : K - 1] : lost0;
    bool died_now = act0 && d_idx < K;
    ac_f = died_now ? 0.0f : active0;
    bool died_any = died_now || (!act0 && lost0 >= p.max_lost_f);
    le_f = died_any ? 0.0f : lock_ema0;
    for (int e = 0; e < K; ++e) {
      row[e][7] = updf[e];
      row[e][15] = emit[e];
      row[e][16] = wr[e];
    }
  } else {
    // Costas lock: the sequential EMA chain
    const float alpha = (float)0.1;
    cf_f = carr_freq; ce_f = carr_err0; cr_f = code_rate; de_f = code_err0;
    lo_f = lost0; ac_f = active0; le_f = lock_ema0;
    for (int e = 0; e < K; ++e) {
      float metric = (ip[e] * ip[e] - qp[e] * qp[e]) /
                     fmaxf(pw[e], (float)1e-12);
      float new_le = ac_f > 0.5f ? (1.0f - alpha) * le_f + alpha * metric
                                 : le_f;
      bool locked = new_le > p.costas_thr;
      float carr_nco = pll[e] * p.pll_c1 + (pll[e] - ce_f) * p.pll_c2;
      float code_nco = dll[e] * p.dll_c1 + (dll[e] - de_f) * p.dll_c2;
      bool act_e = ac_f > 0.5f;
      bool upd = act_e && locked;
      float new_cf = upd ? cf_f + carr_nco : cf_f;
      float new_ce = upd ? pll[e] : ce_f;
      float new_cr = upd ? cr_f + code_nco : cr_f;
      float new_de = upd ? dll[e] : de_f;
      float new_lo = act_e ? (locked ? 0.0f : lo_f + 1.0f) : lo_f;
      bool died = new_lo >= p.max_lost_f;
      float new_ac = died ? 0.0f : ac_f;
      float wr = act_e ? 1.0f : 0.0f;
      n_act = n_act + wr;
      row[e][7] = upd ? 1.0f : 0.0f;
      row[e][10] = act_e ? new_cf : cf_f;
      row[e][11] = act_e ? new_cr : cr_f;
      row[e][15] = (died && act_e) ? 1.0f : 0.0f;
      row[e][16] = wr;
      cf_f = new_cf; ce_f = new_ce; cr_f = new_cr; de_f = new_de;
      lo_f = new_lo; le_f = died ? 0.0f : new_le; ac_f = new_ac;
    }
  }

  // telemetry rows: correlator and discriminator columns gated by the
  // epoch's processed flag (col 16)
  for (int e = 0; e < K; ++e) {
    float w = row[e][16];
    float* out = p.telem + ((long long)(j * K + e) * p.c_channels + c) * kTelem;
    if (kLean) {
      // per epoch: prompt I/Q and the packed flags (processed +
      // 2 locked + 4 lost); the held rates and ledger increments on the
      // superstep's first epoch, with the E/L and loop-error diagnostics
      // there on even supersteps (every superstep under Costas lock),
      // which is where the slim2 wire reads them
      out[2] = ip[e] * w;  out[3] = qp[e] * w;
      out[16] = w + 2.0f * row[e][7] + 4.0f * row[e][15];
      if (e == 0) {
        out[17] = carr_freq; out[18] = code_rate;
        out[19] = h.d_chip;  out[20] = h.d_drift;
        if (p.costas || j % 2 == 0) {
          out[0] = ie[e] * w;  out[1] = qe[e] * w;
          out[4] = il[e] * w;  out[5] = ql[e] * w;
          out[8] = pll[e] * w; out[9] = dll[e] * w;
        }
      }
      continue;
    }
    out[0] = ie[e] * w;  out[1] = qe[e] * w;
    out[2] = ip[e] * w;  out[3] = qp[e] * w;
    out[4] = il[e] * w;  out[5] = ql[e] * w;
    out[6] = pw[e] * w;  out[7] = row[e][7];
    out[8] = pll[e] * w; out[9] = dll[e] * w;
    out[10] = row[e][10]; out[11] = row[e][11];
    out[12] = h.n_t;     out[13] = drift_a[e];
    out[14] = chip_a[e] * w; out[15] = row[e][15]; out[16] = w;
    out[17] = carr_freq; out[18] = code_rate;
    out[19] = h.d_chip;  out[20] = h.d_drift;
  }

  // superstep writeback (held-rate ledger advance)
  float ncp = carr_phase + n_act * h.adv;
  st[0] = cf_f;
  st[1] = ncp - floorf(ncp);
  st[2] = ce_f;
  st[3] = cr_f;
  st[4] = chip_res0 + n_act * h.d_chip;
  st[5] = de_f;
  st[6] = lo_f;
  st[7] = ac_f;
  st[8] = drift0 + n_act * h.d_drift;
  st[11] = le_f;  // 9 (window offset) and 10 (frac0) carry through
}

// B2: this block's part of superstep j's slice, from global memory
// into its shared memory (the cluster barrier that follows publishes it)
__device__ void stage_slice(const Params& p, long long base, int j, int rank,
                            float* slot_re, float* slot_im) {
  const long long off = ((long long)j * p.k_epochs * p.n0 / 128) * 128;
  const int lo = rank * p.chunk;
  const int n = min(p.chunk, p.span_u - lo);
  const float* sre = p.stream_re + base + off + lo;
  const float* sim = p.stream_im + base + off + lo;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    slot_re[i] = sre[i];
    slot_im[i] = sim[i];
  }
}

template <bool kLean, bool kShared>
__global__ void __launch_bounds__(kThreads)
    track_block_mxu_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // B2: every cluster block's slice part, as pointers into its shared
  // memory (distributed shared memory)
  __shared__ const float* peer_re[kMaxCluster];
  __shared__ const float* peer_im[kMaxCluster];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.k_epochs, R = p.r_rows, wp = p.wp, QK = 2 * K;
  const int w128 = wp / 128;

  __nv_bfloat16* bank = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tile = bank + R * wp;
  float* corr = reinterpret_cast<float*>(tile + QK * wp);  // [2K, R]
  float* b_cos = corr + QK * R;                              // [128]
  float* b_sin = b_cos + 128;
  float* a_cos = b_sin + 128;                                // [K, w128]
  float* a_sin = a_cos + K * w128;
  float* st = a_sin + K * w128;                              // [12]
  float* slot_re = st + 12;                                  // B2: [chunk]
  float* slot_im = slot_re + p.chunk;

  // B2: the shared base and this channel's offset from it
  long long base = 0;
  int dc = 0, rank = 0;
  if constexpr (kShared) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    base = p.starts[p.c_channels];
    dc = (int)(p.starts[c] - base);
    if (tid < p.cs) {
      peer_re[tid] = cluster.map_shared_rank(slot_re, (unsigned)tid);
      peer_im[tid] = cluster.map_shared_rank(slot_im, (unsigned)tid);
    }
    stage_slice(p, base, 0, rank, slot_re, slot_im);
  }

  // replica bank -> shared memory (16-byte copies; wp % 128 == 0)
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        p.replicas + (long long)c * R * wp);
    uint4* dst = reinterpret_cast<uint4*>(bank);
    for (int i = tid; i < R * wp / 8; i += kThreads) dst[i] = src[i];
  }
  if (tid < 12) st[tid] = p.state_in[c * kFields + tid];
  __syncthreads();

  const long long start = kShared ? 0 : p.starts[c];
  const int n_super = p.t_epochs / K;
  for (int j = 0; j < n_super; ++j) {
    // B2: every block of the cluster has staged its part of slice j
    if constexpr (kShared) cg::this_cluster().sync();
    const Held h = held(p, st, j);

    // ---- stage 1a: carrier trig factors ------------------------------
    if (tid < 128) {
      float th = h.step * (float)tid;
      th = (th - floorf(th)) * kTwoPi;
      b_cos[tid] = cosf(th);
      b_sin[tid] = sinf(th);
    }
    for (int i = tid; i < K * w128; i += kThreads) {
      int e = i / w128, q = i - e * w128, rem_e;
      float sl = epoch_sl(st, h, e, p.n0, &rem_e);
      float phi0 = st[1] + (float)e * h.adv - sl * h.step;
      float th = phi0 + (h.step * 128.0f) * (float)q;
      th = (th - floorf(th)) * kTwoPi;
      a_cos[i] = cosf(th);
      a_sin[i] = sinf(th);
    }
    __syncthreads();

    // ---- stage 1b: mix + mask + bf16 tile in the aligned lane frame --
    for (int i = tid; i < K * wp; i += kThreads) {
      int e = i / wp, l = i - e * wp, rem_e;
      float sl = epoch_sl(st, h, e, p.n0, &rem_e);
      int m = l + rem_e + h.rem_j;  // the slice lane the roll brings to l
      if (m >= wp) m -= wp;
      int q = m >> 7, r = m & 127;
      float ac = a_cos[e * w128 + q], as = a_sin[e * w128 + q];
      float cth = ac * b_cos[r] - as * b_sin[r];
      float sth = as * b_cos[r] + ac * b_sin[r];
      float wre, wim;
      if constexpr (kShared) {
        // sample dc + a_e + m of the slice, in its owner's shared memory
        int s = dc + (e * p.n0 / 128) * 128 + m;
        int owner = s >> p.chunk_shift;
        int i_own = s & (p.chunk - 1);
        wre = peer_re[owner][i_own];
        wim = peer_im[owner][i_own];
      } else {
        long long g = start + h.off + (long long)((e * p.n0 / 128) * 128) + m;
        wre = p.stream_re[g];
        wim = p.stream_im[g];
      }
      float lf = (float)m;
      float mask = (lf >= sl && lf < sl + h.n_t) ? 1.0f : 0.0f;
      float m_re = (wre * cth + wim * sth) * mask;
      float m_im = (wim * cth - wre * sth) * mask;
      tile[e * wp + l] = __float2bfloat16_rn(m_re);
      tile[(K + e) * wp + l] = __float2bfloat16_rn(m_im);
    }
    if constexpr (kShared) {
      // every block is done with slice j: refill this block's part
      cg::this_cluster().sync();
      if (j + 1 < n_super) stage_slice(p, base, j + 1, rank, slot_re, slot_im);
    } else {
      __syncthreads();
    }

    // ---- stage 2: [2K, wp] x [wp, R], bf16 in, f32 accumulation ------
    {
      const int t0 = warp, t1 = warp + kWarps;
      const bool has0 = t0 < QK, has1 = t1 < QK;
      float acc0[kMaxR], acc1[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) acc0[r] = acc1[r] = 0.0f;
      if (has0) {
        const __nv_bfloat162* x0p =
            reinterpret_cast<const __nv_bfloat162*>(tile + t0 * wp);
        const __nv_bfloat162* x1p =
            reinterpret_cast<const __nv_bfloat162*>(tile + (has1 ? t1 : t0) * wp);
        const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(bank);
        for (int l2 = lane; l2 < wp / 2; l2 += 32) {
          float2 x0 = __bfloat1622float2(x0p[l2]);
          float2 x1 = __bfloat1622float2(x1p[l2]);
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) {
            if (r < R) {
              float2 b = __bfloat1622float2(bp[r * (wp / 2) + l2]);
              acc0[r] = fmaf(x0.x, b.x, acc0[r]);
              acc0[r] = fmaf(x0.y, b.y, acc0[r]);
              acc1[r] = fmaf(x1.x, b.x, acc1[r]);
              acc1[r] = fmaf(x1.y, b.y, acc1[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
            float v0 = acc0[r], v1 = acc1[r];
            for (int o = 16; o > 0; o >>= 1) {
              v0 += __shfl_xor_sync(0xffffffffu, v0, o);
              v1 += __shfl_xor_sync(0xffffffffu, v1, o);
            }
            if (lane == 0) {
              corr[t0 * R + r] = v0;
              if (has1) corr[t1 * R + r] = v1;
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- stages 3-4: picks, discriminators, lock, loop filters --------
    if (tid == 0) chain<kLean>(p, st, corr, h, j, c);
    __syncthreads();
  }
  if (tid < kFields)
    p.state_out[c * kFields + tid] = tid < 12 ? st[tid] : 0.0f;
}

}  // namespace

extern "C" int track_block_mxu_launch(
    const void* stream_re, const void* stream_im, long long stream_len,
    const void* starts, const void* replicas, const void* state_in,
    void* telem, void* state_out, int c_channels, int t_epochs, int k_epochs,
    int n0, int wp, int r_rows, float fs, float code_len,
    float lock_threshold, int max_lost, float pll_c1, float pll_c2,
    float dll_c1, float dll_c2, int el_shift, float aiding_scale,
    float if_freq, int costas, float costas_thr, int interp, int lean,
    int spread_cap, int cluster, void* stream) {
  // returns a CUDA error code, or -1 when no cluster of `cluster` blocks
  // fits on the card, -2 when the launch needs more shared memory than a
  // block can have (found before anything is launched: the wrapper then
  // tries its next cluster size, whose part of the slice is smaller)
  (void)stream_len;  // the wrapper checks the read bounds before launch
  const bool shared = spread_cap > 0;
  if (k_epochs < 1 || k_epochs > kMaxK || r_rows < 1 || r_rows > kMaxR ||
      wp % 128 || t_epochs % k_epochs || c_channels < 1 ||
      (shared && (spread_cap % 128 || cluster < 1 || cluster > kMaxCluster ||
                  c_channels % cluster)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.stream_re = static_cast<const float*>(stream_re);
  p.stream_im = static_cast<const float*>(stream_im);
  p.starts = static_cast<const int*>(starts);
  p.replicas = static_cast<const __nv_bfloat16*>(replicas);
  p.state_in = static_cast<const float*>(state_in);
  p.telem = static_cast<float*>(telem);
  p.state_out = static_cast<float*>(state_out);
  p.c_channels = c_channels;
  p.t_epochs = t_epochs;
  p.k_epochs = k_epochs;
  p.n0 = n0;
  p.wp = wp;
  p.r_rows = r_rows;
  p.fs = fs;
  p.inv_fs = 1.0f / fs;
  p.code_len = code_len;
  p.lock_threshold = lock_threshold;
  p.max_lost_f = (float)max_lost;
  p.pll_c1 = pll_c1;
  p.pll_c2 = pll_c2;
  p.dll_c1 = dll_c1;
  p.dll_c2 = dll_c2;
  p.el_f = (float)el_shift;
  p.aiding_scale = aiding_scale;
  p.if_freq = if_freq;
  p.costas_thr = costas_thr;
  p.aiding = aiding_scale != 0.0f;
  p.costas = costas;
  p.interp = interp;
  // B2's slice: span + spread_cap samples, cut into `cluster` parts of
  // a power of two each, so stage 1b finds a sample's owner by a shift
  // and not by a division (the parts of the highest ranks may be empty)
  const int span = ((k_epochs - 1) * n0 / 128) * 128 + wp;
  p.cs = shared ? cluster : 1;
  p.span_u = shared ? span + spread_cap : 0;
  p.chunk = 0;
  p.chunk_shift = 0;
  if (shared) {
    const int need = (p.span_u + p.cs - 1) / p.cs;
    p.chunk = 128;
    p.chunk_shift = 7;
    while (p.chunk < need) {
      p.chunk *= 2;
      ++p.chunk_shift;
    }
  }
  const int qk = 2 * k_epochs, w128 = wp / 128;
  size_t smem = (size_t)(r_rows + qk) * wp * sizeof(__nv_bfloat16) +
                (size_t)(qk * r_rows + 256 + 2 * k_epochs * w128 + 12 +
                         2 * p.chunk) *
                    sizeof(float);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the static peer pointer tables sit beside the dynamic memory
  if (smem + 2 * kMaxCluster * sizeof(void*) > (size_t)smem_max) return -2;
  auto kernel = shared ? (lean ? track_block_mxu_kernel<true, true>
                               : track_block_mxu_kernel<false, true>)
                       : (lean ? track_block_mxu_kernel<true, false>
                               : track_block_mxu_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shared) {
    kernel<<<c_channels, kThreads, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c_channels, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n_clusters < 1) return -1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
