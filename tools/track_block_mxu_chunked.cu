// Kernel B1/B2 as it was before the lane clusters (csrc/track_block_mxu.cu
// now runs them): kept only to time its lane-chunk layout (the template
// flag kChunk) in turns against the current kernel; tools/b1_chunked.py
// builds and launches it. Not part of the port.
//
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
// sequential grid becomes this loop). The addresses a superstep reads
// do not depend on the channel's state (only the mask and the carrier
// do), so superstep j + 1's window span is staged into shared memory
// while superstep j computes. Per superstep:
//   1a. every thread derives the held NCO rates from the block's state;
//       threads build the carrier's outer-product trig factors (B per
//       lane mod 128, A per 128-lane group and epoch) in shared memory;
//   1b. each warp mixes its own slice of the wp lanes for the K epochs
//       from the staged window, masks them to the epoch and writes them
//       as bf16 into its columns of the [2K, wp] tile, already in the
//       aligned lane frame (the TPU kernel's left roll by rem_i becomes
//       an indexed read);
//   2.  the same warp contracts its columns of the tile with the [R, wp]
//       bf16 replica bank on the tensor cores (mma.sync m16n8k16, bf16
//       in, f32 accumulation, as the TPU kernel's contraction; the 2K
//       tile rows padded to 16 with a zero row); warp 0 adds the warps'
//       [16, 8] partial sums in warp order;
//   3-4. warp 0 runs the E/P/L picks and discriminators, lane e for
//       epoch e; lane 0 runs the lock and loop-filter recurrences over
//       the K epochs in registers; lane e stores epoch e's telemetry
//       row; meanwhile warp 1 issues the next superstep's window copy.
// 16 warps, so that the mix has four warps per scheduler to switch
// between (8 warps took 10% longer).
// Staging: a 1-D cp.async.bulk (TMA) of each component from global to
// shared memory, completing on an mbarrier (expect-tx of the span's
// bytes, one phase per superstep), issued as soon as every warp is done
// with the window (after stage 2's barrier), so it lands during the
// chain and stage 1a. A bulk copy takes 16-byte-aligned addresses and
// lengths, so it starts at the 4-sample floor of starts[c] + off_j and
// ends at the 4-sample floor of the span's end; the last 0-3 samples go
// by plain loads. The copy thus reads no sample past the channel's
// windows, and the wrapper's read bound stays the plain version's.
// Where the windows do not fit in shared memory beside the bank and the
// tile (wider windows, e.g. 4.092 MHz's wp = 4608, or a bank of more
// than 8 rows beside B2's slice), the launcher clears Params::staged and
// the mix reads the same samples from global memory, as it did before
// the staging; the result is the same. Only the mix's source and whether
// copies are issued and waited for differ. No smaller staging
// unit covers those geometries either: at 4.092 MHz B2's slice for one
// epoch (wp + spread_cap = 9,216 samples, 74 KB) does not fit beside a
// 9-row bank (83 KB) and the tile (92 KB) in the 227 KB a block may have.
// Tile and bank rows are padded by 8 bf16 (16 bytes), so the ldmatrix
// rows of one 8x8 matrix fall on distinct banks and the mix's tile
// stores on consecutive ones.
//
// Lane chunks (the template flag kChunk; ROADMAP C15): where the whole
// bank [R, wp] and tile [2K, wp] do not fit in shared memory (every
// system at 8.184 MHz: GPS wp 8,704 at R 13 and K 8 needs ~498 KB,
// Galileo E1B wp 33,280 ~1.4 MB), the contraction walks wp in chunks of
// Params::chunk lanes (a multiple of 128, the wrapper's plan,
// mxu_smem_plan). Each chunk's bank rows [R, chunk] are staged by TMA
// (one cp.async.bulk per row) into one of two buffers, two chunks ahead,
// so the copy of chunk g + 2 runs while chunks g + 1 and g compute; the
// chunk sequence runs on across supersteps, since the bank is the same
// for every superstep of the block. Per chunk every warp mixes its
// k-steps of the chunk's lanes of the K windows (read from global
// memory, as the unstaged whole-width mix) into a [2K, chunk] tile and
// contracts them with the staged bank rows into the same f32 fragments,
// which thus accumulate across the chunks; one block barrier per chunk
// frees the tile and the bank buffer. The cross-warp sums and warp 0's
// chain are the whole-width layout's. Only the order of the f32 sums
// differs from it (and from the plain version), so the result differs
// by ulps.
//
// Why not wgmma: it multiplies 64-row tiles per warpgroup, and the tile
// here has 2K <= 16 rows, so at least 75% of its rows would be padding;
// the contraction is ~0.3 MFLOP per superstep, and mma.sync takes less
// of a superstep than the mix or the chain (PERF.md section 6).
//
// Shared fetch (kernel B2, replacing _mxu_kernel_shared :1713, which
// the TPU wrapper selects with spread_cap > 0): the template flag
// kShared. The TPU kernel makes one DMA of [span + spread_cap] samples
// per superstep for all channels instead of C overlapping window DMAs.
// Here the blocks (one per channel) launch in thread-block clusters of
// `cs`; each block holds the cluster's whole slice [base + off_j,
// + span_u) in its own shared memory, and each block issues its part
// of the slice (1/cs of it) as one cp.async.bulk .multicast::cluster
// into every block of the cluster; each block's mbarrier expects the
// whole slice's bytes. Stage 1b reads sample dc + a_e + m of its own
// copy (dc = starts[c] - base). A cluster barrier per superstep (every
// thread arrives after stage 1b and waits after stage 2) keeps a block
// from multicasting the next slice into a block that still reads the
// current one. Every block runs every superstep (idle channels run
// masked), so every block reaches every barrier. Only where the samples
// are read from differs from B1, so the result is B1's bit for bit. The
// wrapper checks the slices' read bound on the host.
// In lane chunks (every system at 8.184 MHz) B2 launches B1's chunked
// kernel on starts[:C], without a cluster: base + dc is starts[c], so
// its windows are B1's samples and the result is B1's bit for bit at the
// same chunk width. The TPU kernel's one shared fetch has no counterpart
// there. A slice does not fit beside a chunk's bank buffers and tile; a
// (chunk, epoch) sub-slice [base + off_j + a_e + l0, + w + spread_cap)
// multicast within a cluster is >= 70.7 KB for GPS, BeiDou and GLONASS
// (>= 267 KB for Galileo E1B, more than a block may have), and a double
// buffer of it fits only beside chunks of <= 512 lanes (GPS) or <= 256
// (GLONASS). That design is not built and its time not measured
// (ROADMAP queue B).
//
// Telemetry modes: the template flag kLean selects which columns the
// kernel stores (full: all 21 per epoch; lean: the slim2 wire's feed,
// see the wrapper's docstring) and nothing else, so both modes run the
// identical arithmetic and leave the identical state.
//
// Built with --fmad=false so the scalar steps round as the plain
// version's (and the JAX kernel's) separate ops do; fma is explicit
// where wanted. The correlations' f32 sums run in another order than
// the plain version's (the tensor cores' and the warps'), so the two
// differ by ulps there.
//
// Bound on the H100: a few microseconds per 500 ms block (the bf16
// products over the tensor cores, the stream, replicas and telemetry
// over 3.35 TB/s). The kernel uses C of the 132 SMs and its supersteps
// form a serial chain per channel (trig, mix, contraction, picks, loop
// filters, a few barriers), so that chain's latency bounds it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFields = 128;
constexpr int kTelem = 21;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
// bank rows: 16 in the whole-width layout (two n-tiles of 8 rows), 24
// in lane chunks (three; GLONASS at 8.184 MHz has 21), so the main path's
// static arrays and fragments stay as they were
constexpr int kMaxR = 16;
constexpr int kMaxRChunk = 24;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kPad = 8;         // bf16 pad per tile and bank row
// per-epoch results of the lock and loop-filter recurrences (rv columns)
enum { kUpd, kCf, kCr, kEmit, kWr, kRv };

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
  // the window span (samples), B2's slice (span + spread_cap), the
  // staged buffer's capacity per component, B2's cluster size and the
  // part of the slice each of its blocks copies (a multiple of 4);
  // staged: the windows go through shared memory (0: where they do not
  // fit beside the bank and the tile, the mix reads global memory)
  int span, span_u, win_cap, cs, part, staged;
  // lane chunks (kChunk): lanes per chunk (a multiple of 128; the last
  // chunk may be narrower) and chunks per superstep
  int chunk, n_chunks;
};

// ---- PTX wrappers: mbarrier, bulk copy, cluster barrier, tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> this block's shared memory, completing on its mbarrier
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// global -> the same offset of every masked block's shared memory in the
// cluster, completing on each one's mbarrier at the same offset
__device__ __forceinline__ void bulk_g2s_multicast(void* dst, const void* src,
                                                   uint32_t bytes,
                                                   uint64_t* bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// the generic proxy's reads of the window are ordered before the async
// proxy's next writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- the arithmetic of _mxu_run_k

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

// one of the R correlations of a [R] row by a float index: row[r] where
// (float)r == idx, and 0 for an index outside [0, R) or not a whole
// number, never an out-of-bounds row
__device__ float pick(const float* row, int r_rows, float idx) {
  bool hit = idx >= 0.0f && idx <= (float)(r_rows - 1) && idx == floorf(idx);
  return hit ? row[(int)idx] : 0.0f;
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

// warp 0: stages 3-4 over the K epochs of superstep j; updates st and
// writes telemetry rows [j*K, j*K + K) of channel c. Lane e computes
// epoch e's picks and discriminators; lane 0 gathers what the lock and
// loop filters need by shuffles and runs their recurrences over the K
// epochs in registers (into rv and st); lane e then stores epoch e's
// telemetry row. Each epoch's arithmetic is _mxu_run_k's, in its order.
template <bool kLean>
__device__ void chain(const Params& p, float* st, const float* corr,
                      float (*rv)[kRv], const Held& h, int j, int c,
                      int lane) {
  const int K = p.k_epochs, R = p.r_rows;
  const float half_r = (float)((R - 1) / 2);
  const float carr_freq = st[0], code_rate = st[3];
  float ie = 0.0f, qe = 0.0f, ip = 0.0f, qp = 0.0f, il = 0.0f, ql = 0.0f;
  float pw = 0.0f, pll = 0.0f, dll = 0.0f, drift_a = 0.0f, chip_a = 0.0f;
  float metric = 0.0f;
  if (lane < K) {
    const float ef = (float)lane;
    drift_a = st[8] + ef * h.d_drift;
    chip_a = st[4] + ef * h.d_chip;
    float qq = (chip_a + st[10]) / h.dc;
    float qf = floorf(qq);
    float idx = half_r + (drift_a - qf);
    float fsub = qq - qf;
    bool it = p.interp != 0;
    const float* cre = corr + lane * R;
    const float* cim = corr + (K + lane) * R;
    ip = pick_b(cre, R, idx, it, fsub);
    qp = pick_b(cim, R, idx, it, fsub);
    ie = pick_b(cre, R, idx - p.el_f, it, fsub);
    qe = pick_b(cim, R, idx - p.el_f, it, fsub);
    il = pick_b(cre, R, idx + p.el_f, it, fsub);
    ql = pick_b(cim, R, idx + p.el_f, it, fsub);
    pw = ip * ip + qp * qp;
    float safe_ip = fabsf(ip) < (float)1e-12 ? (float)1e-12 : ip;
    pll = atan_poly(qp / safe_ip) * kInvTwoPi;
    float pe = sqrtf(ie * ie + qe * qe);
    float pl = sqrtf(il * il + ql * ql);
    float el_sum = pe + pl;
    dll = el_sum > 0.0f ? (pe - pl) / fmaxf(el_sum, (float)1e-12) : 0.0f;
    metric = (ip * ip - qp * qp) / fmaxf(pw, (float)1e-12);
  }
  float pw_e[kMaxK], pll_e[kMaxK], dll_e[kMaxK], met_e[kMaxK];
#pragma unroll
  for (int e = 0; e < kMaxK; ++e) {
    pw_e[e] = __shfl_sync(0xffffffffu, pw, e);
    pll_e[e] = __shfl_sync(0xffffffffu, pll, e);
    dll_e[e] = __shfl_sync(0xffffffffu, dll, e);
    met_e[e] = __shfl_sync(0xffffffffu, metric, e);
  }

  if (lane == 0) {
    const float carr_phase = st[1], carr_err0 = st[2];
    const float chip_res0 = st[4], code_err0 = st[5];
    const float lost0 = st[6], active0 = st[7], drift0 = st[8];
    const float lock_ema0 = st[11];
    float cf_f, ce_f, cr_f, de_f, lo_f, ac_f, le_f, n_act = 0.0f;
    const bool act0 = active0 > 0.5f;
    if (!p.costas) {
      // power lock: the closed-form lifecycle chain
      int d_idx = K, last_lk = -1;
      float lo_d = 0.0f, lo_last = 0.0f;  // the lost count at d_idx, K-1
#pragma unroll
      for (int e = 0; e < kMaxK; ++e) {
        if (e < K) {
          if (pw_e[e] > p.lock_threshold) last_lk = e;
          float lo = last_lk >= 0 ? (float)(e - last_lk)
                                  : lost0 + (float)e + 1.0f;
          if (lo >= p.max_lost_f && d_idx == K) {
            d_idx = e;
            lo_d = lo;
          }
          lo_last = lo;
        }
      }
      // loop-filter memory at the start of epoch e: the discriminator of
      // the last update epoch strictly before e
      float ce = carr_err0, de = code_err0, sc = 0.0f, sd = 0.0f;
#pragma unroll
      for (int e = 0; e < kMaxK; ++e) {
        if (e < K) {
          bool act = act0 && e <= d_idx;
          bool upd = act && pw_e[e] > p.lock_threshold;
          float wr = act ? 1.0f : 0.0f;
          float updf = upd ? 1.0f : 0.0f;
          n_act += wr;
          float nco_c =
              updf * (pll_e[e] * p.pll_c1 + (pll_e[e] - ce) * p.pll_c2);
          float nco_d =
              updf * (dll_e[e] * p.dll_c1 + (dll_e[e] - de) * p.dll_c2);
          if (upd) {
            ce = pll_e[e];
            de = dll_e[e];
          }
          sc += nco_c;
          sd += nco_d;
          rv[e][kUpd] = updf;
          rv[e][kCf] = carr_freq + sc;  // per-epoch post-update rates
          rv[e][kCr] = code_rate + sd;
          rv[e][kEmit] = (act0 && e == d_idx) ? 1.0f : 0.0f;
          rv[e][kWr] = wr;
        }
      }
      cf_f = carr_freq + sc;
      cr_f = code_rate + sd;
      ce_f = ce;
      de_f = de;
      // the lost counter freezes at its death-epoch value
      lo_f = act0 ? (d_idx < K - 1 ? lo_d : lo_last) : lost0;
      bool died_now = act0 && d_idx < K;
      ac_f = died_now ? 0.0f : active0;
      bool died_any = died_now || (!act0 && lost0 >= p.max_lost_f);
      le_f = died_any ? 0.0f : lock_ema0;
    } else {
      // Costas lock: the sequential EMA chain
      const float alpha = (float)0.1;
      cf_f = carr_freq; ce_f = carr_err0; cr_f = code_rate; de_f = code_err0;
      lo_f = lost0; ac_f = active0; le_f = lock_ema0;
#pragma unroll
      for (int e = 0; e < kMaxK; ++e) {
        if (e < K) {
          float new_le = ac_f > 0.5f
                             ? (1.0f - alpha) * le_f + alpha * met_e[e]
                             : le_f;
          bool locked = new_le > p.costas_thr;
          float carr_nco =
              pll_e[e] * p.pll_c1 + (pll_e[e] - ce_f) * p.pll_c2;
          float code_nco =
              dll_e[e] * p.dll_c1 + (dll_e[e] - de_f) * p.dll_c2;
          bool act_e = ac_f > 0.5f;
          bool upd = act_e && locked;
          float new_cf = upd ? cf_f + carr_nco : cf_f;
          float new_ce = upd ? pll_e[e] : ce_f;
          float new_cr = upd ? cr_f + code_nco : cr_f;
          float new_de = upd ? dll_e[e] : de_f;
          float new_lo = act_e ? (locked ? 0.0f : lo_f + 1.0f) : lo_f;
          bool died = new_lo >= p.max_lost_f;
          float new_ac = died ? 0.0f : ac_f;
          float wr = act_e ? 1.0f : 0.0f;
          n_act = n_act + wr;
          rv[e][kUpd] = upd ? 1.0f : 0.0f;
          rv[e][kCf] = act_e ? new_cf : cf_f;
          rv[e][kCr] = act_e ? new_cr : cr_f;
          rv[e][kEmit] = (died && act_e) ? 1.0f : 0.0f;
          rv[e][kWr] = wr;
          cf_f = new_cf; ce_f = new_ce; cr_f = new_cr; de_f = new_de;
          lo_f = new_lo; le_f = died ? 0.0f : new_le; ac_f = new_ac;
        }
      }
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
  __syncwarp();

  // lane e: epoch e's telemetry row, correlator and discriminator columns
  // gated by the epoch's processed flag (16)
  if (lane < K) {
    const int e = lane;
    const float w = rv[e][kWr], updf = rv[e][kUpd], emit = rv[e][kEmit];
    float* out = p.telem + ((long long)(j * K + e) * p.c_channels + c) * kTelem;
    if (kLean) {
      // per epoch: prompt I/Q and the packed flags (processed +
      // 2 locked + 4 lost); the held rates and ledger increments on the
      // superstep's first epoch, with the E/L and loop-error diagnostics
      // there on even supersteps (every superstep under Costas lock),
      // which is where the slim2 wire reads them
      out[2] = ip * w;  out[3] = qp * w;
      out[16] = w + 2.0f * updf + 4.0f * emit;
      if (e == 0) {
        out[17] = carr_freq; out[18] = code_rate;
        out[19] = h.d_chip;  out[20] = h.d_drift;
        if (p.costas || j % 2 == 0) {
          out[0] = ie * w;  out[1] = qe * w;
          out[4] = il * w;  out[5] = ql * w;
          out[8] = pll * w; out[9] = dll * w;
        }
      }
    } else {
      out[0] = ie * w;  out[1] = qe * w;
      out[2] = ip * w;  out[3] = qp * w;
      out[4] = il * w;  out[5] = ql * w;
      out[6] = pw * w;  out[7] = updf;
      out[8] = pll * w; out[9] = dll * w;
      out[10] = rv[e][kCf]; out[11] = rv[e][kCr];
      out[12] = h.n_t;     out[13] = drift_a;
      out[14] = chip_a * w; out[15] = emit; out[16] = w;
      out[17] = carr_freq; out[18] = code_rate;
      out[19] = h.d_chip;  out[20] = h.d_drift;
    }
  }
}

// B1: issue the copy of superstep j's window span of the channel that
// starts at `start` (one thread); the last 0-3 samples of the span, past
// the last 16-byte boundary, by plain loads of lanes 1-3 of the calling
// warp. The window sits at offset (start & 3) of the buffer.
__device__ void stage_window(const Params& p, long long start, int j,
                            float* win_re, float* win_im, uint64_t* bar,
                            int lane) {
  const long long g0 = start + ((long long)j * p.k_epochs * p.n0 / 128) * 128;
  const long long org = g0 & ~3LL;
  const int o = (int)(g0 - org);
  const int n_tot = o + p.span;
  const int n_tma = n_tot & ~3;
  if (lane == 0) {
    fence_proxy_async();
    mbar_expect(bar, 2u * 4u * (uint32_t)n_tma);
    bulk_g2s(win_re, p.stream_re + org, 4u * (uint32_t)n_tma, bar);
    bulk_g2s(win_im, p.stream_im + org, 4u * (uint32_t)n_tma, bar);
  } else if (lane <= n_tot - n_tma) {
    const int i = n_tma + lane - 1;
    win_re[i] = p.stream_re[org + i];
    win_im[i] = p.stream_im[org + i];
  }
}

// B2: issue this block's part of superstep j's slice as a multicast into
// every block of the cluster, and expect the whole slice (one thread)
__device__ void stage_slice(const Params& p, long long base, int j, int rank,
                            float* win_re, float* win_im, uint64_t* bar) {
  const long long org = base + ((long long)j * p.k_epochs * p.n0 / 128) * 128;
  fence_proxy_async();
  mbar_expect(bar, 2u * 4u * (uint32_t)p.span_u);
  const int lo = rank * p.part;
  const int n = min(p.part, p.span_u - lo);
  if (n <= 0) return;
  if (p.cs == 1) {
    bulk_g2s(win_re, p.stream_re + org, 4u * (uint32_t)n, bar);
    bulk_g2s(win_im, p.stream_im + org, 4u * (uint32_t)n, bar);
    return;
  }
  const uint16_t mask = (uint16_t)((1u << p.cs) - 1u);
  bulk_g2s_multicast(win_re + lo, p.stream_re + org + lo, 4u * (uint32_t)n,
                     bar, mask);
  bulk_g2s_multicast(win_im + lo, p.stream_im + org + lo, 4u * (uint32_t)n,
                     bar, mask);
}

// stage 1b: this warp's lanes [l0, l1) of the K epochs' mix, masked,
// as bf16 into the tile (ts the row stride, lane l at column l - col0);
// epoch e's window is at win + rd + a_e, in shared memory (staged) or in
// global memory
__device__ __forceinline__ void mix(const Params& p, const float* st,
                                    const Held& h, const float* win_re,
                                    const float* win_im, int rd,
                                    const float* a_cos, const float* a_sin,
                                    const float* b_cos, const float* b_sin,
                                    __nv_bfloat16* tile, int ts, int col0,
                                    int l0, int l1, int lane) {
  const int K = p.k_epochs, wp = p.wp, w128 = wp / 128;
  // lanes in pairs (l, l + 1); where the epoch's roll and the window's
  // offset are even (n0 even and a 4-sample-aligned start: the
  // receiver's case) a pair is one 8-byte load of each window
  // component and trig factor, and one bf16x2 conversion and store
  // per tile row; otherwise its two lanes go one by one
  for (int e = 0; e < K; ++e) {
    int rem_e;
    const float sl = epoch_sl(st, h, e, p.n0, &rem_e);
    const float sl_end = sl + h.n_t;
    const int shift = rem_e + h.rem_j;
    const float* wre = win_re + rd + (e * p.n0 / 128) * 128;
    const float* wim = win_im + rd + (e * p.n0 / 128) * 128;
    const float* ac_e = a_cos + e * w128;
    const float* as_e = a_sin + e * w128;
    __nv_bfloat16* t_re = tile + e * ts - col0;
    __nv_bfloat16* t_im = tile + (K + e) * ts - col0;
    if (((shift | rd) & 1) == 0) {
#pragma unroll 2
      for (int l = l0 + 2 * lane; l < l1; l += 64) {
        int m = l + shift;  // the slice lane the roll brings to l
        if (m >= wp) m -= wp;
        const int q = m >> 7, r = m & 127;
        const float ac = ac_e[q], as = as_e[q];
        const float2 bc = *reinterpret_cast<const float2*>(b_cos + r);
        const float2 bs = *reinterpret_cast<const float2*>(b_sin + r);
        const float2 xr = *reinterpret_cast<const float2*>(wre + m);
        const float2 xi = *reinterpret_cast<const float2*>(wim + m);
        const float cth0 = ac * bc.x - as * bs.x;
        const float sth0 = as * bc.x + ac * bs.x;
        const float cth1 = ac * bc.y - as * bs.y;
        const float sth1 = as * bc.y + ac * bs.y;
        const float lf0 = (float)m, lf1 = lf0 + 1.0f;
        const float mask0 = (lf0 >= sl && lf0 < sl_end) ? 1.0f : 0.0f;
        const float mask1 = (lf1 >= sl && lf1 < sl_end) ? 1.0f : 0.0f;
        const float re0 = (xr.x * cth0 + xi.x * sth0) * mask0;
        const float im0 = (xi.x * cth0 - xr.x * sth0) * mask0;
        const float re1 = (xr.y * cth1 + xi.y * sth1) * mask1;
        const float im1 = (xi.y * cth1 - xr.y * sth1) * mask1;
        *reinterpret_cast<__nv_bfloat162*>(t_re + l) =
            __floats2bfloat162_rn(re0, re1);
        *reinterpret_cast<__nv_bfloat162*>(t_im + l) =
            __floats2bfloat162_rn(im0, im1);
      }
    } else {
      for (int l = l0 + lane; l < l1; l += 32) {
        int m = l + shift;
        if (m >= wp) m -= wp;
        const int q = m >> 7, r = m & 127;
        const float ac = ac_e[q], as = as_e[q];
        const float cth = ac * b_cos[r] - as * b_sin[r];
        const float sth = as * b_cos[r] + ac * b_sin[r];
        const float xre = wre[m], xim = wim[m];
        const float lf = (float)m;
        const float mask = (lf >= sl && lf < sl_end) ? 1.0f : 0.0f;
        t_re[l] = __float2bfloat16_rn((xre * cth + xim * sth) * mask);
        t_im[l] = __float2bfloat16_rn((xim * cth - xre * sth) * mask);
      }
    }
  }
}

// kChunk: issue chunk g's bank rows (chunk g % n_chunks of the lanes;
// g counts chunks across the supersteps) into buffer buf, [R, width] at
// row stride ts, one bulk copy per row (one thread; rows and chunks start
// on 256-byte boundaries of the bank, the buffer's rows on 16-byte ones)
__device__ void stage_bank(const Params& p, const __nv_bfloat16* bank_c,
                           __nv_bfloat16* buf, int ts, int g, uint64_t* bar) {
  const int c0 = (g % p.n_chunks) * p.chunk;
  const uint32_t row_bytes = 2u * (uint32_t)min(p.chunk, p.wp - c0);
  fence_proxy_async();
  mbar_expect(bar, row_bytes * (uint32_t)p.r_rows);
  for (int r = 0; r < p.r_rows; ++r)
    bulk_g2s(buf + r * ts, bank_c + (long long)r * p.wp + c0, row_bytes, bar);
}

// stage 2's k-steps [ks0, ks1) of 16 lanes: the tile's rows (ldmatrix at
// a_base, a_step bytes per k-step) by the bank's rows (row stride ts) on
// the tensor cores, into this warp's f32 fragments acc (kNT n-tiles)
template <int kNT>
__device__ __forceinline__ void contract(float (*acc)[4], uint32_t a_base,
                                         int a_step,
                                         const __nv_bfloat16* bank, int ts,
                                         int ks0, int ks1, int n_tiles,
                                         int r_rows, uint32_t zero_addr,
                                         int b_row, int b_kof) {
  for (int ks = ks0; ks < ks1; ++ks) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(a_base + ks * a_step, a0, a1, a2, a3);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < n_tiles) {
        const int n = nt * 8 + b_row;
        const uint32_t b_addr =
            n < r_rows ? smem_addr(bank + n * ts + ks * 16 + b_kof)
                       : zero_addr;
        uint32_t b0, b1;
        ldsm_x2(b_addr, b0, b1);
        mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
      }
    }
  }
}

template <bool kLean, bool kShared, bool kChunk>
__global__ void __launch_bounds__(kThreads, 1)
    track_block_mxu_kernel(Params p) {
  constexpr int kRcap = kChunk ? kMaxRChunk : kMaxR;
  constexpr int kNT = (kRcap + 7) / 8;  // n-tiles of 8 bank rows
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;             // the window's mbarrier
  __shared__ __align__(8) uint64_t bank_bar[2];     // kChunk: its buffers
  __shared__ float red[kWarps][2 * kMaxK * kRcap];  // stage 2 partials
  __shared__ float corr[2 * kMaxK * kRcap];          // [2K, R]
  __shared__ __align__(16) float b_cos[128];  // 8-byte pairs in the mix
  __shared__ __align__(16) float b_sin[128];
  __shared__ float st[16];
  __shared__ float rv[kMaxK][kRv];
  __shared__ __align__(16) __nv_bfloat16 zero_row[8];  // padding rows

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.k_epochs, R = p.r_rows, wp = p.wp, QK = 2 * K;
  // the tile's and bank's row stride: wp wide, or one chunk (kChunk)
  const int w128 = wp / 128, ts = (kChunk ? p.chunk : wp) + kPad;

  // kChunk: two bank buffers [R, chunk] in place of the bank
  float* win_re = reinterpret_cast<float*>(smem);
  float* win_im = win_re + p.win_cap;
  __nv_bfloat16* bank = reinterpret_cast<__nv_bfloat16*>(win_im + p.win_cap);
  __nv_bfloat16* tile = bank + (kChunk ? 2 : 1) * R * ts;
  float* a_cos = reinterpret_cast<float*>(tile + QK * ts);  // [K, w128]
  float* a_sin = a_cos + K * w128;

  // B2: the shared base, this channel's offset from it, the block's rank
  long long base = 0;
  int dc = 0, rank = 0;
  if constexpr (kShared) {
    rank = (int)cg::this_cluster().block_rank();
    base = p.starts[p.c_channels];
    dc = (int)(p.starts[c] - base);
  }
  const long long start = kShared ? base : p.starts[c];

  if (tid == 0) {
    mbar_init(&bar);
    if constexpr (kChunk) {
      mbar_init(&bank_bar[0]);
      mbar_init(&bank_bar[1]);
    }
  }
  if (tid < 8) zero_row[tid] = __float2bfloat16_rn(0.0f);
  // every block's mbarrier is initialised before any block copies into it
  if constexpr (kShared) cg::this_cluster().sync();
  else __syncthreads();
  // issue superstep jj's window copy (B1: warp 1; B2: lane 0 of warp 1)
  auto stage = [&](int jj) {
    if (!p.staged) return;
    if constexpr (kShared) {
      if (tid == 32) stage_slice(p, base, jj, rank, win_re, win_im, &bar);
    } else if (warp == 1) {
      stage_window(p, start, jj, win_re, win_im, &bar, lane);
    }
  };
  stage(0);
  // where a channel's window sits in the buffer (B1: the start's offset
  // from its 4-sample floor, the same for every superstep since off_j is
  // a 128-multiple; B2: dc)
  const int rd = kShared ? dc : (int)(start & 3LL);

  const int n_super = p.t_epochs / K;
  const __nv_bfloat16* bank_c = p.replicas + (long long)c * R * wp;
  if constexpr (kChunk) {
    // the first two chunks' bank rows
    if (tid == 32)
      for (int g = 0; g < 2 && g < n_super * p.n_chunks; ++g)
        stage_bank(p, bank_c, bank + g * R * ts, ts, g, &bank_bar[g]);
  } else {
    // replica bank -> shared memory, rows padded (16-byte copies; wp %
    // 128 == 0, the wrapper checks the bank's alignment)
    const uint4* src = reinterpret_cast<const uint4*>(bank_c);
    const int row8 = wp / 8;
    for (int i = tid; i < R * row8; i += kThreads) {
      int r = i / row8, q = i - r * row8;
      *reinterpret_cast<uint4*>(bank + r * ts + q * 8) = src[i];
    }
  }
  if (tid < 12) st[tid] = p.state_in[c * kFields + tid];
  __syncthreads();

  // this warp's lanes of the tile: k-steps [ks0, ks1) of 16 lanes
  const int n_ks = wp / 16;
  const int ks0 = warp * n_ks / kWarps, ks1 = (warp + 1) * n_ks / kWarps;
  const int l0 = ks0 * 16, l1 = ks1 * 16;
  const int n_tiles = (R + 7) / 8;  // <= kNT
  // ldmatrix row addresses: A (tile) rows 0-15 of two 8-lane halves of a
  // k-step, rows past 2K the zero row; B (bank) rows of each n-tile, rows
  // past R the zero row
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_kof = (lane >> 4) * 8;
  const uint32_t zero_addr = smem_addr(zero_row);
  const uint32_t a_base =
      a_row < QK ? smem_addr(tile + a_row * ts + a_kof) : zero_addr;
  const int a_step = a_row < QK ? 32 : 0;  // bytes per k-step
  const int b_row = lane & 7, b_kof = ((lane >> 3) & 1) * 8;

  for (int j = 0; j < n_super; ++j) {
    const Held h = held(p, st, j);

    // ---- stage 1a: carrier trig factors ------------------------------
    for (int i = tid; i < 128 + K * w128; i += kThreads) {
      if (i < 128) {
        float th = h.step * (float)i;
        th = (th - floorf(th)) * kTwoPi;
        b_cos[i] = cosf(th);
        b_sin[i] = sinf(th);
      } else {
        int ia = i - 128, e = ia / w128, q = ia - e * w128, rem_e;
        float sl = epoch_sl(st, h, e, p.n0, &rem_e);
        float phi0 = st[1] + (float)e * h.adv - sl * h.step;
        float th = phi0 + (h.step * 128.0f) * (float)q;
        th = (th - floorf(th)) * kTwoPi;
        a_cos[ia] = cosf(th);
        a_sin[ia] = sinf(th);
      }
    }
    __syncthreads();
    if (p.staged) mbar_wait(&bar, (uint32_t)(j & 1));  // window j staged

    // ---- stage 1b: mix + mask + bf16 tile, this warp's lanes ----------
    // one mix, called on the staged buffer or on global memory: with the
    // pointer chosen at run time its reads become generic loads, and the
    // staged mix took ~560 more cycles per superstep (PERF.md section 6)
    float acc[kNT][4] = {};
    if constexpr (kChunk) {
      // the windows from the 4-sample floor of the span's start, in
      // global memory; per chunk: mix, wait for the bank rows, contract,
      // free the tile and the buffer, stage chunk g + 2's rows there
      const long long g0 = (long long)p.starts[c] + h.off;
      const int r0 = (int)(g0 & 3LL);
      for (int ci = 0; ci < p.n_chunks; ++ci) {
        const int g = j * p.n_chunks + ci, buf = g & 1;
        const int c0 = ci * p.chunk, nks = min(p.chunk, wp - c0) / 16;
        const int cks0 = warp * nks / kWarps, cks1 = (warp + 1) * nks / kWarps;
        mix(p, st, h, p.stream_re + (g0 - r0), p.stream_im + (g0 - r0), r0,
            a_cos, a_sin, b_cos, b_sin, tile, ts, c0, c0 + cks0 * 16,
            c0 + cks1 * 16, lane);
        __syncwarp();
        mbar_wait(&bank_bar[buf], (uint32_t)((g >> 1) & 1));
        // ---- stage 2 (chunk): this warp's k-steps of it ---------------
        contract<kNT>(acc, a_base, a_step, bank + buf * R * ts, ts, cks0,
                      cks1, n_tiles, R, zero_addr, b_row, b_kof);
        __syncthreads();
        if (tid == 32 && g + 2 < n_super * p.n_chunks)
          stage_bank(p, bank_c, bank + buf * R * ts, ts, g + 2,
                     &bank_bar[buf]);
      }
    } else {
      if (p.staged) {
        mix(p, st, h, win_re, win_im, rd, a_cos, a_sin, b_cos, b_sin, tile,
            ts, 0, l0, l1, lane);
      } else {
        // the window span from the 4-sample floor of its start, as the
        // buffer would hold it
        const long long g0 = (long long)p.starts[c] + h.off;
        const int r0 = (int)(g0 & 3LL);
        mix(p, st, h, p.stream_re + (g0 - r0), p.stream_im + (g0 - r0), r0,
            a_cos, a_sin, b_cos, b_sin, tile, ts, 0, l0, l1, lane);
      }
      // B2: this block is done with slice j (waited on after stage 2)
      if constexpr (kShared) cluster_arrive();
      __syncwarp();

      // ---- stage 2: [2K, wp] x [wp, R] on the tensor cores, this warp's
      // k-steps; bf16 in, f32 accumulation ---------------------------
      contract<kNT>(acc, a_base, a_step, bank, ts, ks0, ks1, n_tiles, R,
                    zero_addr, b_row, b_kof);
    }
    {
      // the fragment's rows g and g + 8, columns 2t and 2t + 1, as corr's
      // [2K, R] (the padding rows and columns dropped)
      const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = g + (v >> 1) * 8, n = nt * 8 + t2 + (v & 1);
          if (nt < n_tiles && row < QK && n < R)
            red[warp][row * R + n] = acc[nt][v];
        }
      }
    }
    __syncthreads();

    if (warp == 0) {
      // the warps' partial sums, added in warp order
      for (int i = lane; i < QK * R; i += 32) {
        float v = red[0][i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v += red[w][i];
        corr[i] = v;
      }
      __syncwarp();
      // ---- stages 3-4: picks, discriminators, lock, loop filters ------
      chain<kLean>(p, st, corr, rv, h, j, c, lane);
      __syncwarp();
      if constexpr (kShared) cluster_wait();
    } else {
      if constexpr (kShared) cluster_wait();
      // every warp is done with the window: stage superstep j + 1's
      if (j + 1 < n_super) stage(j + 1);
    }
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
    int spread_cap, int cluster, void* stream, int chunk) {
  // returns a CUDA error code, or -1 when no cluster of `cluster` blocks
  // can run on the card (above the portable size of 8, or
  // cudaOccupancyMaxActiveClusters = 0), -2 when the launch needs more
  // shared memory than a block can have (both found before anything is
  // launched: the wrapper then tries its next cluster size). chunk > 0
  // runs the lane-chunked layout with chunks of that many lanes, one
  // chunk too where it covers wp, 0 the whole-width one: the wrapper's
  // plan (mxu_smem_plan), taken as given, the launcher only checking
  // that it fits. B2 in lane chunks runs B1's chunked kernel on
  // starts[:C] and ignores `cluster`.
  (void)stream_len;  // the wrapper checks the read bounds before launch
  const bool shared = spread_cap > 0;
  if (k_epochs < 1 || k_epochs > kMaxK || r_rows < 1 ||
      r_rows > (chunk ? kMaxRChunk : kMaxR) || wp % 128 ||
      t_epochs % k_epochs || c_channels < 1 ||
      (shared && (spread_cap % 128 || cluster < 1 ||
                  c_channels % cluster)) ||
      chunk < 0 || chunk % 128 || chunk > wp)
    return (int)cudaErrorInvalidValue;
  if (shared && cluster > kMaxCluster) return -1;
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
  // the window span; B2's slice (span + spread_cap, a 128-multiple) and
  // each block's part of it, a multiple of 4 samples (16 bytes; the
  // parts of the highest ranks may be empty); in lane chunks B2 has no
  // slice (B1's kernel)
  const bool slice = shared && !chunk;
  p.span = ((k_epochs - 1) * n0 / 128) * 128 + wp;
  p.cs = slice ? cluster : 1;
  p.span_u = slice ? p.span + spread_cap : 0;
  p.part = slice ? ((p.span_u + 4 * p.cs - 1) / (4 * p.cs)) * 4 : 0;
  p.chunk = chunk;
  p.n_chunks = chunk ? (wp + chunk - 1) / chunk : 1;
  // B1's buffer holds the span behind an offset of up to 3 samples
  const int qk = 2 * k_epochs, w128 = wp / 128;
  const int ts = (p.chunk ? p.chunk : wp) + kPad;
  const int win_cap = slice ? p.span_u : ((p.span + 3 + 3) / 4) * 4;
  auto kernel =
      slice ? (lean ? track_block_mxu_kernel<true, true, false>
                    : track_block_mxu_kernel<false, true, false>)
      : p.chunk ? (lean ? track_block_mxu_kernel<true, false, true>
                        : track_block_mxu_kernel<false, false, true>)
                : (lean ? track_block_mxu_kernel<true, false, false>
                        : track_block_mxu_kernel<false, false, false>);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  // the bank (kChunk: two buffers of a chunk's bank rows), the tile and
  // the trig factors; the staged windows beside them where they fit, else
  // the mix reads global memory (wide windows, e.g. 4.092 MHz, a wide
  // bank beside B2's slice, and every chunked launch); the static arrays
  // (mbarriers, partial sums, chain) sit beside it all
  const size_t base_smem =
      (size_t)((p.chunk ? 2 : 1) * r_rows + qk) * ts *
          sizeof(__nv_bfloat16) +
      (size_t)2 * k_epochs * w128 * sizeof(float);
  const size_t win_smem = (size_t)2 * win_cap * sizeof(float);
  p.staged = !p.chunk &&
             base_smem + win_smem + fa.sharedSizeBytes <= (size_t)smem_max;
  p.win_cap = p.staged ? win_cap : 0;
  const size_t smem = base_smem + (p.staged ? win_smem : 0);
  if (smem + fa.sharedSizeBytes > (size_t)smem_max) return -2;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!slice) {
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
