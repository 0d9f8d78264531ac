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
// Design: B3's (track_block_direct.cu). One thread block per channel walks
// its T epochs in order; the channel's f32 prompt rows sit in shared
// memory (5 x 4352 x 4 B = 87 KB at the resident layout's widest window,
// hence the dynamic shared-memory ceiling); each epoch is
// epoch::run_epoch (epoch_core.cuh), fed by the window this kernel points
// it at.
//
// Bound on the H100: the bytes. An epoch of a channel reads its ~2046
// in-mask lanes of the window once and does 24 f32 operations on each;
// per 32-channel block the windows feed moves 279 MB (500 ms blocks), the
// seg feed 66 MB (125 ms blocks), the resident feed one 8 MB stream
// (whose bound is then the operations). With C of the 132 SMs busy and a
// serial chain per channel, the kernel sits far above it.

#include "epoch_core.cuh"

namespace {

enum : int { kWindows = 0, kSeg = 1, kResident = 2 };

struct Feed {
  const float* re;  // windows [T, C, wp], seg [C, Lseg] or stream [L]
  const float* im;
  long long row;    // seg: Lseg
  int k_chunk;      // resident: epochs per chunk
  float el_pad;     // windows: el_shift + (n_drift - 1) / 2
};

template <int F>
__global__ void __launch_bounds__(epoch::kThreads)
    track_block_epoch_kernel(epoch::Params p, Feed f) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const epoch::Smem s = epoch::load_channel(p, smem, c);
  for (int t = 0; t < p.t_epochs; ++t) {
    long long off;
    int rem = 0;
    float start_lane;
    if constexpr (F == kWindows) {
      off = ((long long)t * p.c_channels + c) * p.wp;
      start_lane = s.st[8] + f.el_pad;
    } else {
      const int tl = F == kSeg ? t : t % f.k_chunk;
      const long long raw = (long long)tl * p.n0;
      const long long a = (raw / 128) * 128;
      rem = (int)(raw - a);
      off = F == kSeg ? (long long)c * f.row + a
                      : (long long)(t / f.k_chunk) * f.k_chunk * p.n0 + a;
      start_lane = (s.st[9] + s.st[8]) + (float)rem;
    }
    epoch::run_epoch(p, s, f.re + off, f.im + off, start_lane, rem, t, c);
  }
  epoch::store_channel(p, s, c);
}

}  // namespace

extern "C" int track_block_epoch_launch(
    int feed, const void* win_re, const void* win_im, long long row,
    int k_chunk, const void* replicas, const void* state_in, void* telem,
    void* state_out, int c_channels, int t_epochs, int n0, int wp,
    int n_drift, float fs, float code_len, float lock_threshold,
    int max_lost, float pll_c1, float pll_c2, float dll_c1, float dll_c2,
    int el_shift, float aiding_scale, float if_freq, int costas,
    float costas_thr, int interp, void* stream) {
  // the wrapper checks shapes and the read bound before launch
  epoch::Params p;
  int err = epoch::make_params(
      p, replicas, state_in, telem, state_out, c_channels, t_epochs, n0, wp,
      n_drift, fs, code_len, lock_threshold, max_lost, pll_c1, pll_c2,
      dll_c1, dll_c2, el_shift, aiding_scale, if_freq, costas, costas_thr,
      interp);
  if (err) return err;
  Feed f;
  f.re = static_cast<const float*>(win_re);
  f.im = static_cast<const float*>(win_im);
  f.row = row;
  f.k_chunk = k_chunk;
  f.el_pad = (float)(el_shift + (n_drift - 1) / 2);
  switch (feed) {
    case kWindows:
      return epoch::launch(track_block_epoch_kernel<kWindows>, p, f, stream);
    case kSeg:
      if (row < wp) return (int)cudaErrorInvalidValue;
      return epoch::launch(track_block_epoch_kernel<kSeg>, p, f, stream);
    case kResident:
      if (k_chunk < 1 || t_epochs % k_chunk) return (int)cudaErrorInvalidValue;
      return epoch::launch(track_block_epoch_kernel<kResident>, p, f, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
