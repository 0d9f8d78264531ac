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
// Design: the direct feed of epoch::run_block (epoch_core.cuh), shared
// with B4a, B4b and B6. One thread block per channel walks the channel's
// T epochs in order (GPU blocks run in no order, so the TPU's sequential
// grid becomes this loop); the channel's N_DRIFT f32 prompt rows (5 x
// 2560 x 4 B = 51 KB) sit in shared memory for the whole block. Epoch e
// of superstep j reads its window from the shared stream at the
// channel's start + floor(jKn0/128)*128 + floor(en0/128)*128; the window
// is staged into shared memory by TMA two epochs ahead, as the TPU
// kernel's _direct_kernel issues and drains its copies ahead. Past the
// widths one block holds (from wp 5,888 at 5 rows; e.g. Galileo E1B at 8.184
// MHz, wp 33,280) one channel runs over a thread-block cluster
// (epoch::run_block_lanes; grid (cs, C), the channel blockIdx.y): each
// block holds its lane part's prompt rows with the roll's halo and stages
// its part of each window; the cluster's sums go through DSMEM and every
// block runs the chain.
//
// Bound on the H100: the 12 f32 mixing operations per in-mask lane
// (~2046 lanes per channel-epoch) over the card's f32 rate, a few
// microseconds per 500 ms block at 32 channels; the bytes (each stream
// sample of a channel's epoch, the replica rows, telemetry) are of the
// same order. This kernel uses C of the 132 SMs and a serial per-channel
// chain, so it sits far above that.

#include "epoch_core.cuh"

namespace {

// epoch t = j*K + e's window of one channel
struct DirectFeed {
  const float* re;  // [L] shared sample stream
  const float* im;
  const int* starts;  // [C] window starts
  long long start;    // this channel's
  int k_epochs, n0;

  __device__ __forceinline__ long long origin(int t) const {
    const int j = t / k_epochs, e = t - j * k_epochs;
    const long long kk = (long long)k_epochs * n0;
    return start + ((long long)j * kk / 128) * 128 + (e * n0 / 128) * 128;
  }
  __device__ __forceinline__ int rem(int t) const {
    const int j = t / k_epochs, e = t - j * k_epochs;
    const long long jk = (long long)j * k_epochs * n0;
    return (e * n0 - (e * n0 / 128) * 128) + (int)(jk - (jk / 128) * 128);
  }
  __device__ __forceinline__ float start_lane(const float* st, int t) const {
    const int j = t / k_epochs, e = t - j * k_epochs;
    const long long jk = (long long)j * k_epochs * n0;
    const int rem_e = e * n0 - (e * n0 / 128) * 128;
    const int rem_j = (int)(jk - (jk / 128) * 128);
    return ((st[9] + st[8]) + (float)rem_e) + (float)rem_j;
  }
};

__global__ void __launch_bounds__(epoch::kThreads, 1)
    track_block_direct_kernel(epoch::Params p, DirectFeed f) {
  extern __shared__ __align__(128) float smem[];
  f.start = f.starts[blockIdx.x];
  epoch::run_block(p, f, smem);
}

// lane clusters: channel blockIdx.y over the cluster's blocks
__global__ void __launch_bounds__(epoch::kThreads, 1)
    track_block_direct_lanes(epoch::Params p, DirectFeed f) {
  extern __shared__ __align__(128) float smem[];
  f.start = f.starts[blockIdx.y];
  epoch::run_block_lanes(p, f, smem);
}

}  // namespace

extern "C" int track_block_direct_launch(
    const void* stream_re, const void* stream_im, long long stream_len,
    const void* starts, const void* replicas, const void* state_in,
    void* telem, void* state_out, int c_channels, int t_epochs, int k_epochs,
    int n0, int wp, int n_drift, float fs, float code_len,
    float lock_threshold, int max_lost, float pll_c1, float pll_c2,
    float dll_c1, float dll_c2, int el_shift, float aiding_scale,
    float if_freq, int costas, float costas_thr, int interp, void* stream,
    int cluster, void* rank_state) {
  // the wrapper checks the read bound before launch; cluster 0 runs one
  // block a channel, else lane clusters of that size (rank_state: every
  // rank's final state, [C, cluster, 12], or null). Returns a CUDA error
  // code, or epoch::kErrNoCluster / kErrSmem.
  (void)stream_len;
  if (k_epochs < 1 || t_epochs % k_epochs) return (int)cudaErrorInvalidValue;
  epoch::Params p;
  int err = epoch::make_params(
      p, replicas, state_in, telem, state_out, c_channels, t_epochs, n0, wp,
      n_drift, fs, code_len, lock_threshold, max_lost, pll_c1, pll_c2,
      dll_c1, dll_c2, el_shift, aiding_scale, if_freq, costas, costas_thr,
      interp);
  if (err) return err;
  p.rank_state = static_cast<float*>(rank_state);
  DirectFeed f;
  f.re = static_cast<const float*>(stream_re);
  f.im = static_cast<const float*>(stream_im);
  f.starts = static_cast<const int*>(starts);
  f.start = 0;
  f.k_epochs = k_epochs;
  f.n0 = n0;
  if (cluster == 0)
    return epoch::launch(track_block_direct_kernel, p, f, stream);
  return epoch::launch_lanes(track_block_direct_lanes, p, f, cluster,
                             stream, nullptr);
}

// how many lane clusters of `cluster` blocks the card holds at once at
// this width, every block on an SM of its own (>= 1), or the launcher's
// negative codes (track_block_epoch_clusters' twin)
extern "C" int track_block_direct_clusters(int wp, int n_drift, int el_shift,
                                           int cluster) {
  epoch::Params p;
  int err = epoch::make_params(p, nullptr, nullptr, nullptr, nullptr, 1, 1,
                               1, wp, n_drift, 1.0f, 1.0f, 0.0f, 1, 0.0f,
                               0.0f, 0.0f, 0.0f, el_shift, 0.0f, 0.0f, 0,
                               0.0f, 0);
  if (err) return err;
  DirectFeed f = {};
  int n = 0;
  const int rc = epoch::launch_lanes(track_block_direct_lanes, p, f, cluster,
                                     nullptr, &n);
  return rc == 0 ? n : rc;
}
