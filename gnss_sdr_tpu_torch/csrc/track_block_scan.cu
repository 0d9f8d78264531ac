// The scanned tracker's block of epochs for every channel, in one launch,
// for Hopper (sm_90a): kernel B7.
//
// Replaces no TPU kernel. The JAX package runs this epoch as XLA ops
// around the Pallas correlator (gnss_sdr_tpu/receiver/tracking.py
// epoch_step; gnss_sdr_tpu/ops/pallas/epl_correlator.py), and XLA fuses a
// jitted scan's ops into a few kernels an epoch. The port ran it as some
// 190 PyTorch ops an epoch, captured 101-501 times into one CUDA graph a
// block: about 19,000 tiny kernels a 100 ms block, some 27 ms of the card
// for work whose bytes take under 1 us. This kernel is that block of
// epochs, the scan on the hot path as a kernel.
//
// What it computes, per channel and epoch, is epoch_step's arithmetic
// (gnss_sdr_tpu_torch/receiver/tracking.py; its plain version is that op
// loop, run_epoch_ops), in float32 throughout:
//   * the epoch length n_t from the (carrier-aided) code rate, the mask
//     `can` and the window start;
//   * the carrier and code NCO steps, and the six E/P/L sums over the
//     window as kernel B5 computes them (epl_lane.cuh, shared with B5);
//   * power or Costas lock, the atan PLL and the normalised early-late
//     DLL discriminators with both second-order loop filters;
//   * the exact uint32 carrier and code ledger with the chip carry and its
//     two wraps, the lost/lock bookkeeping and the masked selects;
// and it writes what the op loop returns: the [13, C] end state's bits,
// then the [17, T, C] telemetry's bits, as int32.
//
// What bounds it on the H100: not bytes (a 100 ms block's samples, 15
// code rows and ~100 KB of telemetry are well under 1 us at 3.35 TB/s)
// but the serial chain: T dependent epochs (101 or 501), each needing all
// of a channel's lanes reduced before the loops can set the next epoch's
// rates. So the yardstick is time an epoch against one cross-block
// barrier, about 1-3 us.
//
// The design against that:
//  * One channel over a thread-block cluster of S blocks (the wrapper
//    picks S by C and the SM count as B5 does: 8 at C = 15, 120 blocks
//    on 132 SMs, and at C = 32, two blocks an SM); block rank
//    r takes lanes [r * part, (r + 1) * part) of every epoch's window.
//    The channel's ledger lives in registers of every thread from the
//    first epoch to the last.
//  * Each block stages the channel's code row in shared memory once a
//    launch. Its lane part of each window comes from the L2-resident
//    block by cp.async into one of two slots: the next epoch's start
//    (offset + n_t) is known before this epoch's sums, so its part is
//    fetched while this one is reduced.
//  * Warp shuffles, then a sum over the warps in a fixed order; each
//    block pushes its six sums into every block's shared memory by DSMEM,
//    into a slot picked by the epoch's parity, so ONE cluster barrier an
//    epoch suffices. Every block adds the S sums in rank order, so all get
//    the same bits, and every thread runs the loop chain itself: nothing
//    is broadcast after the barrier. Rank 0 writes the telemetry.
//  * No atomics: the same inputs give the same bits on every run, which
//    the tracker's closed loop and the graph-versus-eager check rely on.
//
// Numerics: built with --fmad=false, as the other kernels; an explicit
// fmaf only where the op loop has fma (the carrier-aided rate, the chip
// ramp and the chip estimate); rintf for torch.round; the saturating
// f32 -> int32 of f32_to_i32; precise sincosf, atanf, sqrtf and IEEE
// division. The sums run in another order than the op loop's, so they
// differ from it by ulps; every step from the same sums is the op loop's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epl_lane.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kFields = 13;        // ChannelState's fields
constexpr int kTelem = 17;         // EpochTelemetry's fields
// 1 / (2 pi) as the op loop's Python factor rounds to f32
constexpr float kInvTwoPi = (float)(1.0 / (2.0 * 3.141592653589793));
constexpr float kInvU32 = 2.3283064365386963e-10f;  // 2^-32
constexpr float kTiny = 1e-12f;

// the f32 constants, in the order of the wrapper's CONSTS
enum Const {
  kInvFs, kFsL, kIfFreq, kAidingScale, kLockThreshold, kCostasThreshold,
  kPllK1, kPllK2, kDllK1, kDllK2, kNumConsts
};
// the integers, in the order of the wrapper's STATICS
enum Static {
  kNBlock, kWindow, kNCode, kShift, kOversample, kInterp, kCostas,
  kAiding, kCodeLength, kMaxLost, kNEpochs, kNumStatics
};

struct Params {
  const float* re;     // the block, [n_block]
  const float* im;
  const int* ins;      // [13 C + 1]: the ledger's bits, then the limit
  const float* codes;  // [C, n_code]
  int* out;            // [13 C + 17 T C]
  float k[kNumConsts];
  int n[kNumStatics];
  int c_channels, cluster, part;
};

// one channel's ledger (ChannelState), in registers
struct Ledger {
  bool active;
  int prn, offset, epochs, lost;
  float carr_freq;
  uint32_t carr_acc;
  float carr_err, code_rate;
  int chip_int;
  uint32_t chip_frac;
  float code_err, lock_ema;
};

// what an epoch derives from the ledger before its sums
struct Epoch {
  float n_t_f;     // the epoch length, rounded, as f32
  int n_t;         // ... saturated to int32
  bool can;        // the whole window lies in the valid samples
  int start;       // the window's first sample
  epl::LaneNco q;  // the carrier NCO and the chip ramp
};

__device__ __forceinline__ float as_f(int x) { return __int_as_float(x); }
__device__ __forceinline__ int as_i(float x) { return __float_as_int(x); }
// int32 adds that wrap, as torch's int32 ops do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

// f32 -> int32 as XLA converts (f32_to_i32 in ops/correlator.py):
// saturating, NaN to 0
__device__ __forceinline__ int f32_to_i32(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return -2147483647 - 1;
  return (int)x;
}

// nco.cycles_to_step: the uint32 step of f32 cycles a sample (the
// fraction, rounded half to even, saturated at 2^32 - 1)
__device__ __forceinline__ uint32_t cycles_to_step(float cycles) {
  float frac = cycles - floorf(cycles);
  long long s = (long long)rintf(frac * 4294967296.0f);
  return (uint32_t)min(max(s, 0LL), 4294967295LL);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ Ledger load_ledger(const int* ins, int c,
                                              int n_c) {
  Ledger L;
  L.active = ins[0 * n_c + c] != 0;
  L.prn = ins[1 * n_c + c];
  L.offset = ins[2 * n_c + c];
  L.epochs = ins[3 * n_c + c];
  L.lost = ins[4 * n_c + c];
  L.carr_freq = as_f(ins[5 * n_c + c]);
  L.carr_acc = (uint32_t)ins[6 * n_c + c];
  L.carr_err = as_f(ins[7 * n_c + c]);
  L.code_rate = as_f(ins[8 * n_c + c]);
  L.chip_int = ins[9 * n_c + c];
  L.chip_frac = (uint32_t)ins[10 * n_c + c];
  L.code_err = as_f(ins[11 * n_c + c]);
  L.lock_ema = as_f(ins[12 * n_c + c]);
  return L;
}

__device__ __forceinline__ void store_ledger(const Ledger& L, int* out,
                                             int c, int n_c) {
  out[0 * n_c + c] = L.active ? 1 : 0;
  out[1 * n_c + c] = L.prn;
  out[2 * n_c + c] = L.offset;
  out[3 * n_c + c] = L.epochs;
  out[4 * n_c + c] = L.lost;
  out[5 * n_c + c] = as_i(L.carr_freq);
  out[6 * n_c + c] = (int)L.carr_acc;
  out[7 * n_c + c] = as_i(L.carr_err);
  out[8 * n_c + c] = as_i(L.code_rate);
  out[9 * n_c + c] = L.chip_int;
  out[10 * n_c + c] = (int)L.chip_frac;
  out[11 * n_c + c] = as_i(L.code_err);
  out[12 * n_c + c] = as_i(L.lock_ema);
}

// the code rate the epoch runs at: carrier-aided where configured
__device__ __forceinline__ float code_rate_eff(const Params& p,
                                               const Ledger& L) {
  if (!p.n[kAiding]) return L.code_rate;
  return fmaf(L.carr_freq - p.k[kIfFreq], p.k[kAidingScale], L.code_rate);
}

// ---- stage 1: the epoch's length, mask, start and NCOs ------------------
__device__ __forceinline__ Epoch derive(const Params& p, const Ledger& L,
                                        int limit) {
  Epoch e;
  const int w = p.n[kWindow];
  const float cre = code_rate_eff(p, L);
  e.n_t_f = rintf(p.k[kFsL] / clamp_min(cre, 1.0f));
  // an idle channel's zero rate gives ~4e9, saturated as XLA does: its
  // (unused) sums are then over the whole window
  e.n_t = f32_to_i32(e.n_t_f);
  e.can = L.active && L.offset >= 0 && wrap_add(L.offset, w) <= limit;
  e.start = min(max(L.offset, 0), p.n[kNBlock] - w);
  e.q.acc = L.carr_acc;
  e.q.step = cycles_to_step(L.carr_freq * p.k[kInvFs]);
  e.q.base_idx = L.chip_int * p.n[kOversample];
  e.q.frac = (float)L.chip_frac * kInvU32;
  e.q.cps = cre * p.k[kInvFs];
  e.q.os = (float)p.n[kOversample];
  return e;
}

// ---- stage 4: lock, discriminators, loop filters, ledger (every thread) -
// Returns the new ledger; writes the epoch's telemetry row when `write`.
__device__ __forceinline__ Ledger chain(const Params& p, const Ledger& L,
                                        const Epoch& e, const float* s,
                                        int t, int c, bool write) {
  const float ie = s[0], qe = s[1], ip = s[2], qp = s[3], il = s[4],
              ql = s[5];
  const float power = ip * ip + qp * qp;
  float new_ema;
  bool locked;
  if (p.n[kCostas]) {
    // scale-invariant normalized lock metric, EMA-smoothed
    const float nbd = ip * ip - qp * qp;
    const float metric = nbd / clamp_min(power, kTiny);
    new_ema = e.can ? 0.9f * L.lock_ema + 0.1f * metric : L.lock_ema;
    locked = new_ema > p.k[kCostasThreshold];
  } else {
    new_ema = L.lock_ema;
    locked = power > p.k[kLockThreshold];
  }
  // PLL: Costas atan discriminator
  const float safe_ip = fabsf(ip) < kTiny ? kTiny : ip;
  const float pll_err = atanf(qp / safe_ip) * kInvTwoPi;
  const float carr_nco =
      pll_err * p.k[kPllK1] + (pll_err - L.carr_err) * p.k[kPllK2];
  const float new_carr_freq = L.carr_freq + carr_nco;
  // DLL: normalized early-late envelope
  const float pow_e = sqrtf(ie * ie + qe * qe);
  const float pow_l = sqrtf(il * il + ql * ql);
  const float el_sum = pow_e + pow_l;
  const float dll_err =
      el_sum > 0.0f ? (pow_e - pow_l) / clamp_min(el_sum, kTiny) : 0.0f;
  const float code_nco =
      dll_err * p.k[kDllK1] + (dll_err - L.code_err) * p.k[kDllK2];
  const float new_code_rate = L.code_rate + code_nco;
  // loop filters engage only on locked epochs
  const bool upd = e.can && locked;
  const float carr_freq_u = upd ? new_carr_freq : L.carr_freq;
  const float carr_err_u = upd ? pll_err : L.carr_err;
  const float code_rate_u = upd ? new_code_rate : L.code_rate;
  const float code_err_u = upd ? dll_err : L.code_err;
  // exact phase advance over n_t samples
  const uint32_t n_u = (uint32_t)e.n_t;
  const uint32_t new_acc = L.carr_acc + n_u * e.q.step;
  const uint32_t new_frac = L.chip_frac + n_u * cycles_to_step(e.q.cps);
  const float new_frac_f = (float)new_frac * kInvU32;
  const float est_total = fmaf(e.n_t_f, e.q.cps, e.q.frac);
  const int carry = (int)rintf(est_total - new_frac_f);
  const int code_length = p.n[kCodeLength];
  int chip = wrap_add(L.chip_int, carry);  // < 2L: two select-wraps
  if (chip >= code_length) chip -= code_length;
  if (chip >= code_length) chip -= code_length;
  // lock / lost bookkeeping
  const int new_lost = locked ? 0 : wrap_add(L.lost, 1);
  const bool lost_event = e.can && new_lost >= p.n[kMaxLost];
  const bool survives = e.can && !lost_event;
  auto live = [&](float nw, float old) {
    return survives ? nw : (lost_event ? 0.0f : old);
  };
  Ledger n;
  n.active = L.active && !lost_event;
  n.prn = lost_event ? -1 : L.prn;
  n.offset = e.can ? wrap_add(L.offset, e.n_t) : L.offset;
  n.epochs = e.can ? wrap_add(L.epochs, 1) : L.epochs;
  n.lost = lost_event ? 0 : (e.can ? new_lost : L.lost);
  n.carr_freq = live(carr_freq_u, L.carr_freq);
  n.carr_acc = e.can ? new_acc : L.carr_acc;
  n.carr_err = live(carr_err_u, L.carr_err);
  n.code_rate = live(code_rate_u, L.code_rate);
  n.chip_int = e.can ? chip : L.chip_int;
  n.chip_frac = e.can ? new_frac : L.chip_frac;
  n.code_err = live(code_err_u, L.code_err);
  n.lock_ema = lost_event ? 0.0f : new_ema;
  if (write) {
    // telemetry field k of epoch t, channel c, after the [13, C] state
    const int n_c = p.c_channels;
    const size_t tc = (size_t)p.n[kNEpochs] * n_c;
    int* row = p.out + (size_t)kFields * n_c + (size_t)t * n_c + c;
    const int v[kTelem] = {
        e.can ? 1 : 0, as_i(ie), as_i(qe), as_i(ip), as_i(qp), as_i(il),
        as_i(ql), as_i(power), upd ? 1 : 0, lost_event ? 1 : 0,
        as_i(pll_err), as_i(dll_err), as_i(n.carr_freq), as_i(n.code_rate),
        L.offset, L.epochs, as_i((float)L.chip_int + e.q.frac)};
#pragma unroll
    for (int k = 0; k < kTelem; ++k) row[k * tc] = v[k];
  }
  return n;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// this thread's lanes of the block's part [lo, hi) of the window at
// `start`, into a slot of `part` re then `part` im floats
__device__ __forceinline__ void stage_lanes(const Params& p, float* slot,
                                            int start, int lo, int hi) {
  for (int li = lo + (int)threadIdx.x; li < hi; li += kThreads) {
    cp_async4(slot + (li - lo), p.re + start + li);
    cp_async4(slot + p.part + (li - lo), p.im + start + li);
  }
}

// two blocks an SM (at most 128 registers a thread): 32 channels in
// clusters of 8 are 256 blocks
__global__ void __launch_bounds__(kThreads, 2)
    track_block_scan_kernel(Params p) {
  extern __shared__ float smem[];
  // each warp's six sums (and two pads), then each rank's block sums, by
  // the epoch's parity: every block of the cluster writes its row here
  __shared__ float4 warp_sum[kWarps][2];
  __shared__ float4 rank_sum[2][kMaxCluster][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = p.cluster;
  const int c = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int n_c = p.c_channels;
  const int n_code = p.n[kNCode];
  const int n_epochs = p.n[kNEpochs];
  float* code = smem;
  float* slots = smem + n_code;  // [2][re part, im part]

  // every block of the cluster runs before any pushes its sums into
  // another's shared memory: arrive here, wait before the first push
  cluster_arrive_relaxed();

  const float* row = p.codes + (size_t)c * n_code;
  for (int k = tid; k < n_code; k += kThreads) cp_async4(code + k, row + k);
  Ledger L = load_ledger(p.ins, c, n_c);
  const int limit = p.ins[kFields * n_c];
  const int lo = rank * p.part;
  const int hi = min(lo + p.part, p.n[kWindow]);
  Epoch e = derive(p, L, limit);
  stage_lanes(p, slots, e.start, lo, hi);
  cp_async_commit();

  for (int t = 0; t < n_epochs; ++t) {
    const int par = t & 1;
    // ---- stage 2: fetch the next epoch's part, mix this one's ------------
    if (t + 1 < n_epochs) {
      const int next = e.can ? wrap_add(L.offset, e.n_t) : L.offset;
      stage_lanes(p, slots + (1 - par) * 2 * p.part,
                  min(max(next, 0), p.n[kNBlock] - p.n[kWindow]), lo, hi);
    }
    cp_async_commit();
    cp_async_wait_one();
    if (t == 0) __syncthreads();  // the code row, staged by every thread
    const float* wre = slots + par * 2 * p.part;
    const float* wim = wre + p.part;
    const int hv = min(hi, min(e.n_t, p.n[kWindow]));
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int li = lo + tid; li < hv; li += kThreads)
      epl::accumulate(wre[li - lo], wim[li - lo], li, e.q, code, n_code,
                      p.n[kShift], p.n[kInterp], acc);
    // ---- stage 3: the block's sums into every block, then the cluster's --
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if ((tid & 31) == 0) {
      warp_sum[tid >> 5][0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      warp_sum[tid >> 5][1] = make_float4(acc[4], acc[5], 0.0f, 0.0f);
    }
    __syncthreads();
    if (t == 0) cluster_wait();
    if (tid < cs) {
      float4 a = warp_sum[0][0], b = warp_sum[0][1];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 x = warp_sum[w][0], y = warp_sum[w][1];
        a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
        b = make_float4(b.x + y.x, b.y + y.y, 0.0f, 0.0f);
      }
      float4* dst = cluster.map_shared_rank(&rank_sum[par][rank][0], tid);
      dst[0] = a;
      dst[1] = b;
    }
    cluster.sync();
    float sums[6];
    {
      float4 a = rank_sum[par][0][0], b = rank_sum[par][0][1];
      for (int r = 1; r < cs; ++r) {
        const float4 x = rank_sum[par][r][0], y = rank_sum[par][r][1];
        a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
        b = make_float4(b.x + y.x, b.y + y.y, 0.0f, 0.0f);
      }
      sums[0] = a.x;
      sums[1] = a.y;
      sums[2] = a.z;
      sums[3] = a.w;
      sums[4] = b.x;
      sums[5] = b.y;
    }
    L = chain(p, L, e, sums, t, c, rank == 0 && tid == 0);
    e = derive(p, L, limit);
  }
  if (rank == 0 && tid == 0) store_ledger(L, p.out, c, n_c);
  // the last pushes came before the last cluster barrier: no block reads
  // or writes another's shared memory after it
}

size_t smem_bytes(int n_code, int part) {
  return ((size_t)n_code + 4 * (size_t)part) * sizeof(float);
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

// How many clusters of `cluster` blocks, each staging a code row of n_code
// floats and two slots of `part` lanes, the card can hold at once (0:
// none fits), or a negative CUDA error code. Sets the kernel's shared
// memory limit where it needs more than 48 KB. The wrapper calls it once
// per shape before the first launch, so no launch (nor a graph capture)
// does.
extern "C" int track_block_scan_max_clusters(int c_channels, int cluster,
                                             int n_code, int part) {
  if (c_channels < 1 || cluster < 1 || cluster > kMaxCluster ||
      n_code < 1 || part < 1)
    return -(int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_code, part);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        track_block_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      (void)cudaGetLastError();
      return 0;
    }
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(c_channels, cluster, smem, 0, attr);
  int n = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, track_block_scan_kernel, &cfg);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return 0;
  }
  return n;
}

// `consts`: the wrapper's CONSTS, f32; `statics`: its STATICS.
extern "C" int track_block_scan_launch(const void* re, const void* im,
                                       const void* ins, const void* codes,
                                       void* out, const float* consts,
                                       const int* statics, int c_channels,
                                       int cluster, void* stream) {
  if (c_channels < 1 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.re = static_cast<const float*>(re);
  p.im = static_cast<const float*>(im);
  p.ins = static_cast<const int*>(ins);
  p.codes = static_cast<const float*>(codes);
  p.out = static_cast<int*>(out);
  for (int k = 0; k < kNumConsts; ++k) p.k[k] = consts[k];
  for (int k = 0; k < kNumStatics; ++k) p.n[k] = statics[k];
  const int w = p.n[kWindow];
  if (w < 1 || p.n[kNBlock] < w || p.n[kNCode] < 1 || p.n[kShift] < 0 ||
      p.n[kOversample] < 1 || p.n[kCodeLength] < 1 || p.n[kNEpochs] < 1)
    return (int)cudaErrorInvalidValue;
  p.c_channels = c_channels;
  p.cluster = cluster;
  p.part = (w + cluster - 1) / cluster;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(c_channels, cluster, smem_bytes(p.n[kNCode], p.part),
                    static_cast<cudaStream_t>(stream), attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, track_block_scan_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
