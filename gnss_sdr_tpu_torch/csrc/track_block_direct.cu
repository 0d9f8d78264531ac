// Fused whole-block GNSS tracking, direct layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel track_block_fused_direct
// (gnss_sdr_tpu/ops/pallas/track_block_fused.py:848; body _direct_kernel
// :687 over _epoch_core :76). The plain PyTorch version of the same
// arithmetic is track_block_fused_direct_reference in
// gnss_sdr_tpu_torch/ops/cuda/track_block_fused.py, which also states the
// contract (exact per-epoch NCOs, window frames, replica select and
// rolls, state and telemetry columns).
//
// Design: one thread block per channel walks the channel's T epochs in
// order (GPU blocks run in no order, so the TPU's sequential grid becomes
// this loop); the channel's N_DRIFT f32 prompt rows (5 x 2560 x 4 B =
// 51 KB) sit in shared memory for the whole block. Epoch e of superstep j
// reads its window straight from the shared stream at the channel's
// 128-aligned start + floor(jKn0/128)*128 + floor(en0/128)*128 (a
// superstep's K = 10 windows, ~21k samples x 2 x 4 B, would not fit twice
// in shared memory, and each sample is read once per epoch); the epoch
// itself (trig factors, mix, six correlations, discriminators, loop
// filters) is epoch::run_epoch, shared with the per-epoch layouts
// (epoch_core.cuh).
//
// Bound on the H100: the 12 f32 mixing operations per in-mask lane
// (~2046 lanes per channel-epoch) over the card's f32 rate, a few
// microseconds per 500 ms block at 32 channels; the bytes (each stream
// sample of a channel's epoch, the replica rows, telemetry) are of the
// same order. This kernel uses C of the 132 SMs and a serial per-channel
// chain, so it sits far above that.

#include "epoch_core.cuh"

namespace {

struct DirectFeed {
  const float* stream_re;  // [L] shared sample stream
  const float* stream_im;
  const int* starts;       // [C] 128-aligned window starts
  int k_epochs;
};

__global__ void __launch_bounds__(epoch::kThreads)
    track_block_direct_kernel(epoch::Params p, DirectFeed f) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const epoch::Smem s = epoch::load_channel(p, smem, c);
  const long long start = f.starts[c];
  const int K = f.k_epochs;
  const long long kk = (long long)K * p.n0;
  const int n_super = p.t_epochs / K;
  for (int j = 0; j < n_super; ++j) {
    const long long off = ((long long)j * kk / 128) * 128;
    const int rem_j = (int)((long long)j * kk - off);
    for (int e = 0; e < K; ++e) {
      const int a_e = (e * p.n0 / 128) * 128;
      const int rem_e = e * p.n0 - a_e;
      const float start_lane =
          ((s.st[9] + s.st[8]) + (float)rem_e) + (float)rem_j;
      const long long base = start + off + a_e;
      epoch::run_epoch(p, s, f.stream_re + base, f.stream_im + base,
                       start_lane, rem_e + rem_j, j * K + e, c);
    }
  }
  epoch::store_channel(p, s, c);
}

}  // namespace

extern "C" int track_block_direct_launch(
    const void* stream_re, const void* stream_im, long long stream_len,
    const void* starts, const void* replicas, const void* state_in,
    void* telem, void* state_out, int c_channels, int t_epochs, int k_epochs,
    int n0, int wp, int n_drift, float fs, float code_len,
    float lock_threshold, int max_lost, float pll_c1, float pll_c2,
    float dll_c1, float dll_c2, int el_shift, float aiding_scale,
    float if_freq, int costas, float costas_thr, int interp, void* stream) {
  (void)stream_len;  // the wrapper checks the read bound before launch
  if (k_epochs < 1 || t_epochs % k_epochs) return (int)cudaErrorInvalidValue;
  epoch::Params p;
  int err = epoch::make_params(
      p, replicas, state_in, telem, state_out, c_channels, t_epochs, n0, wp,
      n_drift, fs, code_len, lock_threshold, max_lost, pll_c1, pll_c2,
      dll_c1, dll_c2, el_shift, aiding_scale, if_freq, costas, costas_thr,
      interp);
  if (err) return err;
  DirectFeed f;
  f.stream_re = static_cast<const float*>(stream_re);
  f.stream_im = static_cast<const float*>(stream_im);
  f.starts = static_cast<const int*>(starts);
  f.k_epochs = k_epochs;
  return epoch::launch(track_block_direct_kernel, p, f, stream);
}
