// One channel's tracking block, epoch by epoch, for the per-epoch fused
// tracking kernels on Hopper (sm_90a): B3 (track_block_direct.cu) and
// B4a, B4b and B6 (track_block_epoch.cu).
//
// The counterpart of _epoch_core (gnss_sdr_tpu/ops/pallas/
// track_block_fused.py:76), whose plain PyTorch version is
// _epoch_core_reference in gnss_sdr_tpu_torch/ops/cuda/
// track_block_epoch.py (the contract: carrier trig factors, mask, prompt
// select, rolls, discriminators, loop filters, state and telemetry
// columns). A kernel runs one thread block per channel (run_block) or,
// past the widths one block holds, one thread-block cluster per channel
// (run_block_lanes, below); either walks the channel's T epochs in
// order, each epoch's window where the kernel's feed says it lies. A
// feed (one per kernel) is a struct bound to its channel with three
// members: origin(t), the sample of the feed's arrays at which epoch t's
// window starts; rem(t), the epoch's prompt roll; start_lane(st, t), the
// lane of the epoch's first sample from the state. The window's address
// depends on t alone, never on the state, so every window is known
// before the chain that precedes it.
//
// One block a channel, per epoch (two block barriers):
//   1. every thread derives the epoch's NCO quantities from the state in
//      its registers; threads build the carrier's outer-product trig
//      factors (B per lane mod 128, A per 128-lane group) and the
//      epoch's prompt row (the selected replica rows blended, once per
//      lane index, with the operations and order of the plain version's
//      select) in shared memory; barrier;
//   2. every thread waits for the epoch's window in shared memory and
//      mixes its share of the lanes in the epoch's mask, the integer
//      range [ceil(start_lane), ceil(start_lane + n_t)) within [0, wp):
//      lanes outside it add exactly zero, so they are not visited. The
//      prompt at lane l is the row at (l - rem) mod wp (the TPU kernel's
//      right roll), early and late at that index +- el_shift (its E/L
//      rolls, with the wrap the mask zeroes), each wrapped by one compare
//      and add or subtract;
//   3. each warp sums its six correlations by shuffles; barrier; every
//      warp adds the eight warps' sums in the same fixed order (shuffles
//      over lanes 0-7), so every thread holds the same six sums;
//   4. every thread runs the discriminators, lock, loop filters and death
//      on them in registers, the same arithmetic on the same values, so
//      all hold the same new state and the next epoch needs no barrier
//      to read it; one thread writes the telemetry row.
//
// Staging: each epoch's window is copied into a ring of two shared-memory
// slots by a 1-D cp.async.bulk (TMA) of each component on the slot's
// mbarrier, one phase per epoch: epochs 0 and 1 before the loop, epoch
// t + 2 as soon as every warp is done with epoch t's window (after stage
// 3's barrier), so the copy lands during epoch t's chain and all of
// epoch t + 1. A bulk copy takes 16-byte-aligned addresses and lengths,
// so it starts at the 4-sample floor of the window's origin and copies
// wp samples (wp % 128 == 0); the last 0-3 samples of the window (the
// origin's residue mod 4; only B6's chunks and callers' starts off a
// 4-sample multiple have them) go by cp.async of 4 bytes each, which the
// same mbarrier tracks (cp.async.mbarrier.arrive.noinc). The copy reads
// no sample outside the window's [origin - 3, origin + wp), and never
// before sample 0, so the wrappers' read bounds stay the plain version's;
// no copy is issued past the block's last epoch. The wrappers check that
// the feed's base pointers are 16-byte aligned.
//
// Shared memory, one block a channel: the f32 replica rows (n_drift *
// wp), the ring (2 * 2 * (wp + 4)), the prompt row, the trig factors, the
// warp sums and the ring's mbarriers, 4 * (wp * (n_drift + 5) + 2 * wp /
// 128 + 324) bytes: at the main path's shapes (5 rows) 86 KB (windows,
// wp 2176), 96 KB (seg, 2432), 101 KB (direct, 2560) and 172 KB
// (resident, 4352). It fits in a block's 227 KB up to wp 5,760 at 5
// rows; the launcher refuses a wider window (the wrapper's plan,
// epoch_smem_plan, sends it to the lane clusters).
//
// Lane clusters (run_block_lanes; ROADMAP C6, e.g. Galileo E1B at 8.184
// MHz, seg wp 33,152): one channel over a thread-block cluster of cs
// blocks (grid (cs, C), cluster (cs, 1, 1); cs 16 non-portably). Block r
// owns lane part r, whole 128-lane groups [a, a + w) covering [0, wp)
// once (lane_part, as B1's). The prompt at lane l of the part reads row
// index (l - rem +- el) mod wp, rem < 256 on every feed, so the block
// builds its prompt row over [a - P, a + w + Q) mod wp, P = 255 + el and
// Q = el each rounded up to 4 samples: its n_drift replica rows over that
// range sit in shared memory for the whole block (one or two bulk copies
// a row, the wrap at rank 0 and at the last rank), and the mix indexes
// the built row without a wrap. Per epoch each block builds its part's A
// factors (and the 128 B factors) and its prompt row, one block barrier,
// and mixes the epoch's mask intersected with its part from its window
// part, staged by TMA two epochs ahead into a two-slot ring as above (the
// copy starts at the 4-sample floor of origin(t) + a and ends at origin(t)
// + a + w: inside [origin - 3, origin + wp)). The sums across the
// cluster: each warp writes its six partial sums into its row of every
// block's slots through DSMEM (two 16-byte stores a block; the slots
// double-buffered by epoch parity), one cluster barrier, then every warp
// of every block adds the cs x 8 warp sums from its own shared memory,
// each warp's across the ranks in rank order, then the eight warps' in a
// fixed tree, so every block holds the same six sums and runs stage 4
// itself: no rank-0 chain and no state round. A cluster barrier after the
// set-up comes before the first push (no block writes another's shared
// memory before every block of the cluster runs). An epoch has one block
// barrier and one cluster barrier; rank 0 writes the telemetry and the
// final state, and a last cluster barrier comes before any block leaves
// (another may still read its slots).
//
// Built with --fmad=false so every scalar step rounds as the plain
// version's separate ops do; the carrier phase and chip ledger advances
// are explicit fmaf, as XLA fuses them in the TPU kernel. The
// correlations' f32 sums run in another order than the plain version's,
// so the two differ by ulps there.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace epoch {

namespace cg = cooperative_groups;

constexpr int kFields = 128;
constexpr int kTelem = 17;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDrift = 8;
// carrier A factors: wp <= 384 * 128, where the prompt row and the trig
// factors still fit in shared memory (the JAX kernel stops at 128, ROADMAP
// C6)
constexpr int kMaxW128 = 384;
constexpr int kSlots = 2;       // the window ring's slots
constexpr int kSlotPad = 4;     // a slot holds its window (part) + 4 samples
// the thread that stages windows: lane 0 of the last warp
constexpr int kStager = kThreads - 32;
// lane clusters: the prompt roll's reach (rem < 256 on every feed), the
// largest cluster (16 non-portably) and the launcher's own error codes
constexpr int kReach = 255;
constexpr int kMaxCluster = 16;
constexpr int kErrNoCluster = -1;  // no cluster of that size can run
constexpr int kErrSmem = -2;       // more shared memory than a block has

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
  int aiding, costas, interp;
  // lane clusters (set_lane_fields): cs blocks a channel (0: one block),
  // the widest part, the prompt row's halo before and after a part, and
  // the row's length (halo_p + wmax + halo_q)
  int cs, wmax, halo_p, halo_q, lr;
  float* rank_state;  // [C, cs, 12]: every rank's final state, or null
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
  p.cs = p.wmax = p.halo_p = p.halo_q = p.lr = 0;
  p.rank_state = nullptr;
  return 0;
}

// floats of one block's dynamic shared memory, one block a channel: the
// ring's mbarriers (16 bytes), the replica rows, the ring, then the
// prompt row, the trig factors and the warp sums
inline size_t smem_floats(const Params& p) {
  const size_t wp = (size_t)p.wp, w128 = wp / 128;
  return 4 + (size_t)p.n_drift * wp + 2 * kSlots * (wp + kSlotPad) + wp +
         256 + 2 * w128 + 6 * kWarps;
}

// lane clusters: the parts' widest, the halo and the row length for
// clusters of cs blocks
inline void set_lane_fields(Params& p, int cs) {
  p.cs = cs;
  p.wmax = 128 * ((p.wp / 128 + cs - 1) / cs);
  p.halo_p = (kReach + p.el_shift + 3) & ~3;
  p.halo_q = (p.el_shift + 3) & ~3;
  p.lr = p.halo_p + p.wmax + p.halo_q;
}

// floats of a lane-cluster block's dynamic shared memory, laid out alike
// in every block of the cluster (the warp sums are written at the same
// offset in each): the mbarriers (32 bytes: two ring slots, the replica
// rows), the replica rows of the part [n_drift, lr], the ring [2][2][wmax
// + 4], the prompt row [lr], the warp sums [2][cs][kWarps][8] (six and
// two zeros a row), the B factors [2][128], the A factors [2][wmax / 128]
inline size_t lanes_smem_floats(const Params& p) {
  return 8 + (size_t)p.n_drift * p.lr + 2 * kSlots * (size_t)(p.wmax +
         kSlotPad) + p.lr + 2 * (size_t)p.cs * kWarps * 8 + 256 +
         2 * (p.wmax / 128);
}

// launch one thread block per channel, the replica rows and two window
// slots in shared memory; returns a CUDA error code, or kErrSmem where
// they do not fit (the plan sends such a width to the lane clusters)
template <class Feed>
inline int launch(void (*kernel)(Params, Feed), Params p, const Feed& f,
                  void* stream) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t room = (size_t)smem_max - fa.sharedSizeBytes;
  const size_t smem = smem_floats(p) * sizeof(float);
  if (smem > room) return kErrSmem;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.c_channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, f);
  return (int)cudaGetLastError();
}

// the lane clusters of cs blocks a channel (grid (cs, C)): launches the
// kernel, or with n_active stores how many clusters the card holds at
// once with every block on an SM of its own (cudaOccupancyMaxActiveClusters
// asked for a whole SM's shared memory a block) and launches nothing.
// Returns a CUDA error code, kErrNoCluster or kErrSmem.
template <class Feed>
inline int launch_lanes(void (*kernel)(Params, Feed), Params p,
                        const Feed& f, int cs, void* stream, int* n_active) {
  if (cs < 2 || cs > p.wp / 128) return (int)cudaErrorInvalidValue;
  if (cs > kMaxCluster) return kErrNoCluster;
  set_lane_fields(p, cs);
  // the part's row must not wrap onto itself (two runs at most)
  if (p.lr > p.wp) return kErrSmem;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = lanes_smem_floats(p) * sizeof(float);
  if (smem + fa.sharedSizeBytes > (size_t)smem_max) return kErrSmem;
  const size_t dyn = n_active ? smem_max - fa.sharedSizeBytes : smem;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
  if (err != cudaSuccess) return (int)err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) {
      (void)cudaGetLastError();
      return kErrNoCluster;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, p.c_channels, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
  if (err != cudaSuccess || n_clusters < 1) {
    (void)cudaGetLastError();
    return kErrNoCluster;
  }
  if (n_active) {
    *n_active = n_clusters;
    return 0;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p, f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- PTX wrappers: mbarrier, bulk copy, cp.async, cluster barrier ------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// an mbarrier that completes a phase on `count` arrivals (a ring slot's
// two: the stager's expect-tx and its cp.async arrival) and the bytes
// expected
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 2) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
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

// global -> shared memory, completing on the mbarrier
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one 4-byte sample global -> shared memory
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// the mbarrier's second arrival, once this thread's cp.asyncs landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the generic proxy's reads of a slot are ordered before the async
// proxy's next writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the cluster barrier in two halves: this thread's writes (and reads)
// before it are visible to (done before) every thread of the cluster
// after it
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- the arithmetic ---------------------------------------------------

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

__device__ __forceinline__ Epoch epoch_nco(const Params& p, const float* st,
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
#pragma unroll
  for (int d = 0; d < kMaxDrift; ++d) {
    if (d < p.n_drift && shift == (float)(d - half)) q.hi = d;
    if (d < p.n_drift && p.interp && shift == (float)(d - half + 1)) q.lo = d;
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

// the epoch's prompt row, [n] into shared memory from replica rows of
// `stride` floats: at each lane index the selected rows' sum in row
// order, as the TPU kernel's select (and the plain version's) forms it; 4
// lanes per step, a thread's steps' loads issued together (rows lo and hi
// both read, row 0 for a row not selected, so no load waits on a branch)
__device__ __forceinline__ void build_prompt_row(const float* reps,
                                                 int stride, const Epoch& q,
                                                 int n, float* prow) {
  constexpr int kU = 4;
  const float4* lo4 =
      reinterpret_cast<const float4*>(reps + max(q.lo, 0) * stride);
  const float4* hi4 =
      reinterpret_cast<const float4*>(reps + max(q.hi, 0) * stride);
  float4* out = reinterpret_cast<float4*>(prow);
  const int n4 = n / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kU * kThreads) {
    float4 rl[kU], rh[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        rl[u] = lo4[i];
        rh[u] = hi4[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q.lo >= 0)
          v = make_float4(q.w_lo * rl[u].x, q.w_lo * rl[u].y,
                          q.w_lo * rl[u].z, q.w_lo * rl[u].w);
        if (q.hi >= 0)
          v = make_float4(v.x + q.w_hi * rh[u].x, v.y + q.w_hi * rh[u].y,
                          v.z + q.w_hi * rh[u].z, v.w + q.w_hi * rh[u].w);
        out[i] = v;
      }
    }
  }
}

// the carrier's trig factors of an epoch over the threads: the 128 B
// factors (lane mod 128) and the A factors of the 128-lane groups g0 ..
// g0 + ng - 1 (one each up to ng = kThreads - 128)
__device__ __forceinline__ void build_trig(const Epoch& q, int g0, int ng,
                                           float* b_cos, float* b_sin,
                                           float* a_cos, float* a_sin) {
  for (int i = threadIdx.x; i < 128 + ng; i += kThreads) {
    float th;
    if (i < 128) {
      th = q.step * (float)i;
    } else {
      th = q.phi0 + (q.step * 128.0f) * (float)(g0 + i - 128);
    }
    th = (th - floorf(th)) * kTwoPi;
    float sn, cs;
    sincosf(th, &sn, &cs);
    if (i < 128) {
      b_cos[i] = cs;
      b_sin[i] = sn;
    } else {
      a_cos[i - 128] = cs;
      a_sin[i - 128] = sn;
    }
  }
}

// stage 2's lanes: the integers l in [0, wp) with start_lane <= l <
// start_lane + n_t (the plain version's float mask), as [*l0, *l1)
__device__ __forceinline__ void mask_lanes(const Epoch& q, int wp, int* l0,
                                           int* l1) {
  const float end = q.start_lane + q.n_t;
  *l0 = (int)fminf(fmaxf(ceilf(q.start_lane), 0.0f), (float)wp);
  *l1 = (int)fminf(fmaxf(ceilf(end), 0.0f), (float)wp);
}

// this thread's share of the epoch's mix: lanes l0 + tid, l0 + tid +
// kThreads, ... below l1 of the window at wre / wim (lane 0), the prompt
// row at (l - rem) mod wp and its +- el_shift rolls; six partial sums
__device__ __forceinline__ void mix(const Epoch& q, int wp, int el,
                                    int l0, int l1,
                                    const float* __restrict__ wre,
                                    const float* __restrict__ wim,
                                    const float* prow, const float* b_cos,
                                    const float* b_sin, const float* a_cos,
                                    const float* a_sin, float* acc) {
  // the roll modulo wp (rem < 256 <= wp on every feed but the tiniest)
  const int rw = q.rem_i < wp ? q.rem_i : q.rem_i % wp;
  // a thread's lanes step by kThreads, a multiple of 128, so they share
  // one B factor (lane mod 128)
  static_assert(kThreads % 128 == 0, "one B factor per thread");
  const int r = (l0 + (int)threadIdx.x) & 127;
  const float bc = b_cos[r], bs = b_sin[r];
#pragma unroll 4
  for (int l = l0 + (int)threadIdx.x; l < l1; l += kThreads) {
    const int qd = l >> 7;
    const float ac = a_cos[qd], as = a_sin[qd];
    const float cth = ac * bc - as * bs;
    const float sth = as * bc + ac * bs;
    const float xre = wre[l], xim = wim[l];
    const float m_re = xre * cth + xim * sth;
    const float m_im = xim * cth - xre * sth;
    // (l - rw) lies in (-wp, wp); wrapped, +- el puts it in (-wp, 2wp)
    int ip = l - rw;
    ip += ip < 0 ? wp : 0;
    int ie = ip + el;
    ie -= ie >= wp ? wp : 0;
    int il = ip - el;
    il += il < 0 ? wp : 0;
    const float pe = prow[ie], pp = prow[ip], pl = prow[il];
    acc[0] += m_re * pe;
    acc[1] += m_im * pe;
    acc[2] += m_re * pp;
    acc[3] += m_im * pp;
    acc[4] += m_re * pl;
    acc[5] += m_im * pl;
  }
}

// a lane part's mix: lanes l0 + tid, l0 + tid + kThreads, ... below l1,
// all in the part [a, a + w): the window part at wre / wim (lane a at
// index 0), the A factors of the part's groups (group a / 128 at 0), the
// part's prompt row (row index a - halo_p at 0), where lane l's prompt
// is at (l - a) + halo_p - rem and early and late +- el from it: inside
// the row without a wrap, since rem < 256 and the halos cover the rolls.
// The same operations per lane as mix.
__device__ __forceinline__ void mix_part(const Epoch& q, int el, int a,
                                         int halo_p, int l0, int l1,
                                         const float* __restrict__ wre,
                                         const float* __restrict__ wim,
                                         const float* prow,
                                         const float* b_cos,
                                         const float* b_sin,
                                         const float* a_cos,
                                         const float* a_sin, float* acc) {
  const int r = (l0 + (int)threadIdx.x) & 127;
  const float bc = b_cos[r], bs = b_sin[r];
  const int ga = a >> 7, shift = halo_p - q.rem_i;
#pragma unroll 4
  for (int l = l0 + (int)threadIdx.x; l < l1; l += kThreads) {
    const int x = l - a;
    const int qd = (l >> 7) - ga;
    const float ac = a_cos[qd], as = a_sin[qd];
    const float cth = ac * bc - as * bs;
    const float sth = as * bc + ac * bs;
    const float xre = wre[x], xim = wim[x];
    const float m_re = xre * cth + xim * sth;
    const float m_im = xim * cth - xre * sth;
    const int ip = x + shift;
    const float pe = prow[ip + el], pp = prow[ip], pl = prow[ip - el];
    acc[0] += m_re * pe;
    acc[1] += m_im * pe;
    acc[2] += m_re * pp;
    acc[3] += m_im * pp;
    acc[4] += m_re * pl;
    acc[5] += m_im * pl;
  }
}

// stage 4: discriminators, lock, loop filters and death on the epoch's six
// correlations (every thread, the same arithmetic on the same values);
// `writer` writes channel c's telemetry row of epoch t
__device__ __forceinline__ void chain(const Params& p, const Epoch& q,
                                      const float* corr, float* st, int t,
                                      int c, bool writer) {
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

  if (writer) {
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
  }
  if (act) {
    st[0] = new_cf; st[1] = new_cp; st[2] = new_ce; st[3] = new_cr;
    st[4] = new_chip; st[5] = new_de; st[6] = new_lost;
    st[8] = new_drift;
  }
  st[7] = new_active;
  st[11] = died ? 0.0f : new_le;  // 9 and 10 carry through
}

struct Smem {  // one block's working set in shared memory
  float* reps;   // [n_drift, wp] (lane clusters: [n_drift, lr], the part)
  float* ring;   // [kSlots][2][cap]
  float* prow;   // [wp] (lane clusters: [lr])
  float* b_cos;  // [128]
  float* b_sin;
  float* a_cos;  // [w128] (lane clusters: [wmax / 128])
  float* a_sin;
  float* red;    // [6, kWarps] (lane clusters: [2][cs][kWarps][8])
  uint64_t* bar; // [kSlots] (lane clusters: and the replica rows')
  int cap;       // samples per slot component
};

// epoch t's slot of the ring, and the parity of the slot's mbarrier
// phase that lands it
__device__ __forceinline__ int ring_slot(int t) { return t & 1; }
__device__ __forceinline__ uint32_t ring_parity(int t) {
  return (uint32_t)(t >> 1) & 1u;
}

// issue the copy of lanes [a, a + w) of epoch t's window into its slot
// (the stager alone): from the 4-sample floor of origin(t) + a, w samples
// by TMA and the 0-3 past them by cp.async
template <class Feed>
__device__ __forceinline__ void stage_window(const Smem& s, const Feed& f,
                                             int t, int a, int w) {
  const long long g = f.origin(t) + a;
  const int o = (int)(g & 3LL);
  const long long org = g - o;
  const int slot = ring_slot(t);
  float* dre = s.ring + 2 * slot * s.cap;
  float* dim = dre + s.cap;
  uint64_t* bar = s.bar + slot;
  const uint32_t bytes = 4u * (uint32_t)w;
  fence_proxy_async();
  mbar_expect(bar, 2u * bytes);
  bulk_g2s(dre, f.re + org, bytes, bar);
  bulk_g2s(dim, f.im + org, bytes, bar);
  for (int i = 0; i < o; ++i) {
    cp_async4(dre + w + i, f.re + org + w + i);
    cp_async4(dim + w + i, f.im + org + w + i);
  }
  cp_async_arrive(bar);
}

// lay out the shared memory, init the ring's mbarriers, load channel c's
// replica rows and its state into every thread's registers
__device__ __forceinline__ Smem load_channel(const Params& p, float* smem,
                                             int c, float* st) {
  const int tid = threadIdx.x, wp = p.wp, w128 = wp / 128;
  Smem s;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  s.cap = wp + kSlotPad;
  s.reps = smem + 4;
  const float4* src = reinterpret_cast<const float4*>(
      p.replicas + (long long)c * p.n_drift * wp);
  float4* dst = reinterpret_cast<float4*>(s.reps);
  for (int i = tid; i < p.n_drift * wp / 4; i += kThreads) dst[i] = src[i];
  s.ring = s.reps + p.n_drift * wp;
  s.prow = s.ring + 2 * kSlots * s.cap;
  s.b_cos = s.prow + wp;
  s.b_sin = s.b_cos + 128;
  s.a_cos = s.b_sin + 128;
  s.a_sin = s.a_cos + w128;
  s.red = s.a_sin + w128;
  s.bar = bar;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) st[k] = p.state_in[c * kFields + k];
  __syncthreads();
  return s;
}

__device__ __forceinline__ void store_channel(const Params& p,
                                              const float* st, int c) {
  const int tid = threadIdx.x;
  if (tid < kFields) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < 12; ++k) v = tid == k ? st[k] : v;
    p.state_out[c * kFields + tid] = v;
  }
}

// epoch t of channel c (f bound to it), the state in st (registers)
template <class Feed>
__device__ __forceinline__ void run_epoch(const Params& p, const Smem& s,
                                          const Feed& f, float* st, int t,
                                          int c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = p.wp, w128 = wp / 128;
  // ---- stage 1: NCO quantities, carrier trig factors, prompt row -------
  const Epoch q = epoch_nco(p, st, f.start_lane(st, t), f.rem(t));
  build_trig(q, 0, w128, s.b_cos, s.b_sin, s.a_cos, s.a_sin);
  build_prompt_row(s.reps, wp, q, wp, s.prow);
  __syncthreads();
  mbar_wait(s.bar + ring_slot(t), ring_parity(t));
  // ---- stage 2: mix the window's in-mask lanes ---------------------------
  int l0, l1;
  mask_lanes(q, wp, &l0, &l1);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // the window sits in its slot behind the origin's residue mod 4
  const float* wre = s.ring + 2 * ring_slot(t) * s.cap +
                     (int)(f.origin(t) & 3LL);
  mix(q, wp, p.el_shift, l0, l1, wre, wre + s.cap, s.prow, s.b_cos,
      s.b_sin, s.a_cos, s.a_sin, acc);
  // ---- stage 3: the six correlations: warp sums, then the block's --------
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s.red[k * kWarps + warp] = v;
  }
  __syncthreads();
  // every warp is done with the window: stage epoch t + 2's into its slot
  if (tid == kStager && t + kSlots < p.t_epochs)
    stage_window(s, f, t + kSlots, 0, wp);
  float corr[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // the warps' sums in a fixed order on lanes 0-7 of every warp (the
    // butterfly's adds commute, so all eight lanes agree), then lane 0's
    float v = lane < kWarps ? s.red[k * kWarps + lane] : 0.0f;
    for (int o = kWarps / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o, kWarps);
    corr[k] = __shfl_sync(0xffffffffu, v, 0);
  }
  // ---- stage 4: discriminators, lock, loop filters (every thread) --------
  chain(p, q, corr, st, t, c, tid == 0);
}

// the whole block of channel blockIdx.x, its feed bound to it
template <class Feed>
__device__ __forceinline__ void run_block(const Params& p, const Feed& f,
                                          float* smem) {
  const int c = blockIdx.x;
  float st[12];
  const Smem s = load_channel(p, smem, c, st);
  if (threadIdx.x == kStager)
    for (int t = 0; t < kSlots && t < p.t_epochs; ++t)
      stage_window(s, f, t, 0, p.wp);
  for (int t = 0; t < p.t_epochs; ++t) run_epoch(p, s, f, st, t, c);
  store_channel(p, st, c);
}

// ---- lane clusters: one channel over a thread-block cluster ------------

// lane part `rank` of [0, wp) over cs blocks: whole 128-lane groups, the
// first (wp / 128) % cs parts one group wider; its first lane and width
// (csrc/track_block_mxu.cu lane_part; the wrapper's lane_parts)
__device__ __forceinline__ int2 lane_part(int wp, int cs, int rank) {
  const int g = wp / 128, base = g / cs, extra = g % cs;
  return make_int2(128 * (rank * base + min(rank, extra)),
                   128 * (base + (rank < extra ? 1 : 0)));
}

// issue the part's replica rows, prompt row indices [a - halo_p, a + w +
// halo_q) mod wp of channel c's n_drift rows, into the block's rows (the
// stager alone): one bulk copy a row, or two where the range wraps (at
// rank 0 the row's tail first, at the last rank its head last), on the
// mbarrier `bar`
__device__ __forceinline__ void stage_part_rows(const Params& p,
                                                const Smem& s, int c, int a,
                                                int w, uint64_t* bar) {
  const int wp = p.wp, n = p.halo_p + w + p.halo_q;
  int s0 = a - p.halo_p;
  s0 += s0 < 0 ? wp : 0;
  const int n1 = min(n, wp - s0), n2 = n - n1;
  mbar_expect(bar, 4u * (uint32_t)(n * p.n_drift));
  for (int d = 0; d < p.n_drift; ++d) {
    const float* row = p.replicas + ((long long)c * p.n_drift + d) * wp;
    float* dst = s.reps + d * p.lr;
    bulk_g2s(dst, row + s0, 4u * (uint32_t)n1, bar);
    if (n2 > 0) bulk_g2s(dst + n1, row, 4u * (uint32_t)n2, bar);
  }
}

// lay out a lane-cluster block's shared memory (lanes_smem_floats), init
// its mbarriers, load channel c's state into every thread's registers
__device__ __forceinline__ Smem load_channel_lanes(const Params& p,
                                                   float* smem, int c,
                                                   float* st) {
  const int tid = threadIdx.x;
  Smem s;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  s.cap = p.wmax + kSlotPad;
  s.reps = smem + 8;
  s.ring = s.reps + p.n_drift * p.lr;
  s.prow = s.ring + 2 * kSlots * s.cap;
  s.red = s.prow + p.lr;
  s.b_cos = s.red + 2 * p.cs * kWarps * 8;
  s.b_sin = s.b_cos + 128;
  s.a_cos = s.b_sin + 128;
  s.a_sin = s.a_cos + p.wmax / 128;
  s.bar = bar;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(bar + i);
    mbar_init(bar + kSlots, 1);  // the replica rows: the expect-tx alone
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) st[k] = p.state_in[c * kFields + k];
  __syncthreads();
  return s;
}

// rank 0 writes channel c's final state; with rank_state every rank
// writes its own into row (c, rank)
__device__ __forceinline__ void store_channel_lanes(const Params& p,
                                                    const float* st, int c,
                                                    int rank) {
  const int tid = threadIdx.x;
  if (rank == 0) store_channel(p, st, c);
  if (p.rank_state && tid < 12) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < 12; ++k) v = tid == k ? st[k] : v;
    p.rank_state[((long long)c * p.cs + rank) * 12 + tid] = v;
  }
}

// epoch t of channel c on this block's lane part [a, a + w), the state
// in st (registers; every block of the cluster holds the same)
template <class Feed>
__device__ __forceinline__ void run_epoch_lanes(const Params& p,
                                                const Smem& s, const Feed& f,
                                                float* st, int t, int c,
                                                int rank, int a, int w) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // ---- stage 1: NCO quantities, the part's trig factors and prompt row -
  const Epoch q = epoch_nco(p, st, f.start_lane(st, t), f.rem(t));
  build_trig(q, a >> 7, w >> 7, s.b_cos, s.b_sin, s.a_cos, s.a_sin);
  build_prompt_row(s.reps, p.lr, q, p.halo_p + w + p.halo_q, s.prow);
  __syncthreads();
  mbar_wait(s.bar + ring_slot(t), ring_parity(t));
  // ---- stage 2: mix the in-mask lanes of the part --------------------------
  int l0, l1;
  mask_lanes(q, p.wp, &l0, &l1);
  l0 = max(l0, a);
  l1 = min(l1, a + w);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // the window part sits in its slot behind the origin's residue mod 4
  const float* wre = s.ring + 2 * ring_slot(t) * s.cap +
                     (int)(f.origin(t) & 3LL);
  mix_part(q, p.el_shift, a, p.halo_p, l0, l1, wre, wre + s.cap, s.prow,
           s.b_cos, s.b_sin, s.a_cos, s.a_sin, acc);
  // ---- stage 3: warp sums into every block's slots, then the cluster's --
  // each warp's six sums (a butterfly: every lane holds them); lane j < cs
  // writes them, and two zeros, into row (rank, warp) of rank j's slots
  cg::cluster_group cluster = cg::this_cluster();
  float* red = s.red + ring_slot(t) * p.cs * kWarps * 8;
  float v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    v[k] = acc[k];
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  if (lane < p.cs) {
    float4* row = reinterpret_cast<float4*>(
        cluster.map_shared_rank(red, lane) + (rank * kWarps + warp) * 8);
    row[0] = make_float4(v[0], v[1], v[2], v[3]);
    row[1] = make_float4(v[4], v[5], 0.0f, 0.0f);
  }
  cluster_arrive();
  cluster_wait();
  // every warp of the block is done with the window part: stage epoch
  // t + 2's into its slot
  if (tid == kStager && t + kSlots < p.t_epochs)
    stage_window(s, f, t + kSlots, a, w);
  // lane j adds half (j / 8) % 2 of warp j % 8's row over the ranks in
  // rank order, then the eight warps' by a butterfly on eight lanes (which
  // all agree): correlations 0-3 on lanes 0-7, 4 and 5 on lanes 8-15
  static_assert(kWarps == 8, "a correlation's warp sums on 8 lanes");
  const float4* col = reinterpret_cast<const float4*>(red) +
                      (lane & 7) * 2 + ((lane >> 3) & 1);
  float4 x = col[0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) {
    if (r < p.cs) {
      const float4 y = col[r * kWarps * 2];
      x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
    }
  }
  for (int o = kWarps / 2; o > 0; o >>= 1) {
    x.x += __shfl_xor_sync(0xffffffffu, x.x, o, kWarps);
    x.y += __shfl_xor_sync(0xffffffffu, x.y, o, kWarps);
    x.z += __shfl_xor_sync(0xffffffffu, x.z, o, kWarps);
    x.w += __shfl_xor_sync(0xffffffffu, x.w, o, kWarps);
  }
  float corr[6];
  corr[0] = __shfl_sync(0xffffffffu, x.x, 0);
  corr[1] = __shfl_sync(0xffffffffu, x.y, 0);
  corr[2] = __shfl_sync(0xffffffffu, x.z, 0);
  corr[3] = __shfl_sync(0xffffffffu, x.w, 0);
  corr[4] = __shfl_sync(0xffffffffu, x.x, kWarps);
  corr[5] = __shfl_sync(0xffffffffu, x.y, kWarps);
  // ---- stage 4: discriminators, lock, loop filters (every thread) --------
  chain(p, q, corr, st, t, c, rank == 0 && tid == 0);
}

// the whole block of channel blockIdx.y on lane part blockIdx.x's rank,
// its feed bound to the channel
template <class Feed>
__device__ __forceinline__ void run_block_lanes(const Params& p,
                                                const Feed& f, float* smem) {
  const int c = blockIdx.y;
  const int rank = (int)cg::this_cluster().block_rank();
  const int2 part = lane_part(p.wp, p.cs, rank);
  const int a = part.x, w = part.y;
  float st[12];
  const Smem s = load_channel_lanes(p, smem, c, st);
  // every block of the cluster runs, its mbarriers initialised, before any
  // warp pushes its sums into another's shared memory: arrive here, wait
  // once the part's copies are under way
  cluster_arrive();
  if (threadIdx.x == kStager) {
    stage_part_rows(p, s, c, a, w, s.bar + kSlots);
    for (int t = 0; t < kSlots && t < p.t_epochs; ++t)
      stage_window(s, f, t, a, w);
  }
  mbar_wait(s.bar + kSlots, 0u);  // the part's replica rows, for good
  __syncwarp();  // the aligned wait wants whole warps
  cluster_wait();
  for (int t = 0; t < p.t_epochs; ++t)
    run_epoch_lanes(p, s, f, st, t, c, rank, a, w);
  store_channel_lanes(p, st, c, rank);
  // no block leaves while another may still read its warp sums
  cg::this_cluster().sync();
}

}  // namespace epoch
