// Per-epoch fused GNSS tracking for Hopper (sm_90a): ONE kernel,
// templated on its window feed, for three Pallas TPU kernels that share
// the body _kernel (gnss_sdr_tpu/ops/pallas/track_block_fused.py:350) over
// _epoch_core (:76):
//   * B4a track_block_fused (:499), feed "windows": epoch t of channel c
//     reads row [t, c, :] of [T, C, wp] pre-sliced windows; start lane
//     drift + el_pad; no prompt roll;
//   * B4b track_block_fused_seg (:579), feed "seg": row c of [C, Lseg]
//     segments at the 128-aligned lane T128 = floor(t*n0/128)*128; start
//     lane col9 + drift + rem, rem = t*n0 - T128, the prompt rolled right
//     by rem;
//   * B6 track_block_fused_resident (:2065), feed "resident": one shared
//     stream for every channel, in chunks of k epochs (chunk i at
//     i*k*n0, its epoch t_local at the 128-floor of t_local*n0 within
//     it, as the TPU kernel's VMEM chunks lay the lanes out); start lane
//     col9 + drift + rem. One launch for the whole block.
// The plain PyTorch versions, and the contract, are in
// gnss_sdr_tpu_torch/ops/cuda/track_block_epoch.py.
//
// Design: epoch::run_block (epoch_core.cuh), shared with B3. One thread
// block per channel walks its T epochs in order; each epoch's window is
// staged into shared memory by TMA two epochs ahead (the TPU kernel's
// BlockSpec double-buffers B4a's windows the same way), and the epoch
// mixes it there with the prompt row it built once, over the lanes in
// its mask only; two block barriers per epoch. Past the widths one
// block holds (the replica rows and two window slots, to wp 5,760 at 5
// rows; e.g. Galileo E1B's seg windows at 8.184 MHz, wp 33,152), one
// channel runs over a thread-block cluster of cs blocks
// (epoch::run_block_lanes): each block holds its lane part's replica
// rows and stages its part of each window, every block adds the
// cluster's warp sums through DSMEM and runs the chain itself; one block
// barrier and one cluster barrier per epoch.
//
// Bound on the H100: the bytes. An epoch of a channel needs its ~2046
// in-mask lanes of the window once (8 bytes each) and does 24 f32
// operations on each; per block at 24 tracking channels the windows feed
// needs ~196 MB (500 ms blocks), the seg feed ~49 MB (125 ms blocks), the
// resident feed one 8 MB stream (whose bound is then the operations). With C of the 132 SMs busy and
// a serial chain per channel, the kernel sits far above it: the chain's
// latency (trig, mix, reduction, loop filters) bounds it.

#include "epoch_core.cuh"

namespace {

enum : int { kWindows = 0, kSeg = 1, kResident = 2 };

// epoch t's window of one channel, per feed
template <int F>
struct ChannelFeed {
  const float* re;  // windows [T, C, wp], seg [C, Lseg] or stream [L]
  const float* im;
  long long row;    // seg: Lseg
  int c, c_channels, wp, n0, k_chunk;
  float el_pad;     // windows: el_shift + (n_drift - 1) / 2

  // the window's lane 0 in re / im, and its 128-aligned lane's residue
  __device__ __forceinline__ long long origin(int t) const {
    if constexpr (F == kWindows) {
      return ((long long)t * c_channels + c) * wp;
    } else {
      const int tl = F == kSeg ? t : t % k_chunk;
      const long long a = ((long long)tl * n0 / 128) * 128;
      return F == kSeg ? (long long)c * row + a
                       : (long long)(t / k_chunk) * k_chunk * n0 + a;
    }
  }
  __device__ __forceinline__ int rem(int t) const {
    if constexpr (F == kWindows) {
      return 0;
    } else {
      const long long raw = (long long)(F == kSeg ? t : t % k_chunk) * n0;
      return (int)(raw - (raw / 128) * 128);
    }
  }
  __device__ __forceinline__ float start_lane(const float* st, int t) const {
    if constexpr (F == kWindows) return st[8] + el_pad;
    else return (st[9] + st[8]) + (float)rem(t);
  }
};

template <int F>
__global__ void __launch_bounds__(epoch::kThreads, 1)
    track_block_epoch_kernel(epoch::Params p, ChannelFeed<F> f) {
  extern __shared__ __align__(128) float smem[];
  f.c = blockIdx.x;
  epoch::run_block(p, f, smem);
}

// lane clusters: channel blockIdx.y over the cluster's blocks
template <int F>
__global__ void __launch_bounds__(epoch::kThreads, 1)
    track_block_epoch_lanes(epoch::Params p, ChannelFeed<F> f) {
  extern __shared__ __align__(128) float smem[];
  f.c = blockIdx.y;
  epoch::run_block_lanes(p, f, smem);
}

// one block a channel (cluster 0) or lane clusters of `cluster` blocks;
// with n_active, the clusters the card holds at once (nothing launched)
template <int F>
int launch_feed(const epoch::Params& p, const void* win_re,
                const void* win_im, long long row, int k_chunk,
                int el_pad, int cluster, void* stream, int* n_active) {
  ChannelFeed<F> f;
  f.re = static_cast<const float*>(win_re);
  f.im = static_cast<const float*>(win_im);
  f.row = row;
  f.c = 0;
  f.c_channels = p.c_channels;
  f.wp = p.wp;
  f.n0 = p.n0;
  f.k_chunk = k_chunk;
  f.el_pad = (float)el_pad;
  if (cluster == 0 && !n_active)
    return epoch::launch(track_block_epoch_kernel<F>, p, f, stream);
  return epoch::launch_lanes(track_block_epoch_lanes<F>, p, f, cluster,
                             stream, n_active);
}

int launch_any(int feed, const epoch::Params& p, const void* win_re,
               const void* win_im, long long row, int k_chunk, int cluster,
               void* stream, int* n_active) {
  const int el_pad = p.el_shift + (p.n_drift - 1) / 2;
  switch (feed) {
    case kWindows:
      return launch_feed<kWindows>(p, win_re, win_im, row, 1, el_pad,
                                   cluster, stream, n_active);
    case kSeg:
      if (row < p.wp) return (int)cudaErrorInvalidValue;
      return launch_feed<kSeg>(p, win_re, win_im, row, 1, el_pad, cluster,
                               stream, n_active);
    case kResident:
      if (k_chunk < 1 || p.t_epochs % k_chunk)
        return (int)cudaErrorInvalidValue;
      return launch_feed<kResident>(p, win_re, win_im, row, k_chunk, el_pad,
                                    cluster, stream, n_active);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int track_block_epoch_launch(
    int feed, const void* win_re, const void* win_im, long long row,
    int k_chunk, const void* replicas, const void* state_in, void* telem,
    void* state_out, int c_channels, int t_epochs, int n0, int wp,
    int n_drift, float fs, float code_len, float lock_threshold,
    int max_lost, float pll_c1, float pll_c2, float dll_c1, float dll_c2,
    int el_shift, float aiding_scale, float if_freq, int costas,
    float costas_thr, int interp, void* stream, int cluster,
    void* rank_state) {
  // the wrapper checks shapes, alignment and the read bound before launch;
  // cluster 0 runs one block a channel, else lane clusters of that size
  // (rank_state: every rank's final state, [C, cluster, 12], or null).
  // Returns a CUDA error code, or epoch::kErrNoCluster / kErrSmem.
  epoch::Params p;
  int err = epoch::make_params(
      p, replicas, state_in, telem, state_out, c_channels, t_epochs, n0, wp,
      n_drift, fs, code_len, lock_threshold, max_lost, pll_c1, pll_c2,
      dll_c1, dll_c2, el_shift, aiding_scale, if_freq, costas, costas_thr,
      interp);
  if (err) return err;
  p.rank_state = static_cast<float*>(rank_state);
  return launch_any(feed, p, win_re, win_im, row, k_chunk, cluster, stream,
                    nullptr);
}

// how many lane clusters of `cluster` blocks the card holds at once on
// feed `feed` at this width, every block on an SM of its own (>= 1), or
// the launcher's negative codes where the layout cannot run. The wrapper
// launches first the sizes whose channels' clusters all run so.
extern "C" int track_block_epoch_clusters(int feed, int wp, int n_drift,
                                          int el_shift, int cluster) {
  epoch::Params p;
  int err = epoch::make_params(p, nullptr, nullptr, nullptr, nullptr, 1,
                               1, 1, wp, n_drift,
                               1.0f, 1.0f, 0.0f, 1, 0.0f, 0.0f, 0.0f, 0.0f,
                               el_shift, 0.0f, 0.0f, 0, 0.0f, 0);
  if (err) return err;
  int n = 0;
  const int rc = launch_any(feed, p, nullptr, nullptr, (long long)wp, 1,
                            cluster, nullptr, &n);
  return rc == 0 ? n : rc;
}
