"""The port's device mesh (gnss_sdr_tpu_torch.parallel) on the CPU, the
twin of tests/test_parallel.py at its sizes (2.048 MHz, 8 ms of
acquisition, 16 channels): the JAX side on conftest's 8-device virtual
mesh, the port's on logical shards of the one CPU device
(``make_mesh(..., devices=["cpu"] * n)``).

The determinism gate: an N-shard run of the port equals its 1-shard run
bit for bit (tracking, scanned and fused), and the sharded searches
match the port's and the JAX package's unsharded searches (detections
and code phases exact, the peak/avg ratio within rtol 1e-4). Also C20:
the port's ``pcps_power(sample_offset=s)`` against the JAX function's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gnss_sdr_tpu import parallel as j_par  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import GPS_L1CA as J_GPS  # noqa: E402
from gnss_sdr_tpu.ops import pcps as j_pcps  # noqa: E402
from gnss_sdr_tpu.receiver import tracking as j_trk  # noqa: E402

from gnss_sdr_tpu_torch import parallel  # noqa: E402
from gnss_sdr_tpu_torch.config import TrackConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops import pcps  # noqa: E402
from gnss_sdr_tpu_torch.receiver import fused_runner as fr  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402
from tests.test_torch_scan_tracking import (  # noqa: E402
    CLOSED_EXACT, _phases_close, check_against_jax)

FS = 2_048_000.0
N = GPS_L1CA.samples_per_code(FS)  # 2048
CODE_RATE = GPS_L1CA.code_rate_hz
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n_time=1, n_channel=1):
    return parallel.make_mesh(n_time, n_channel, devices=CPU)


def test_mesh_construction():
    m = _mesh(2, 4)
    assert m.shape == {"time": 2, "channel": 4} == \
        j_par.make_mesh(n_time=2, n_channel=4).shape
    assert m.axis_names == ("time", "channel")
    assert m.devices.shape == (2, 4) and m.home == CPU
    assert parallel.make_mesh(2, devices=[CPU] * 8).shape == m.shape
    with pytest.raises(ValueError, match="needs 256 devices, have 8"):
        parallel.make_mesh(n_time=16, n_channel=16, devices=[CPU] * 8)


def test_mesh_repeats_one_device():
    """A single device (not a list) stands for every grid entry."""
    assert _mesh(2, 4).devices.tolist() == \
        parallel.make_mesh(2, 4, devices=[CPU] * 8).devices.tolist()
    m = parallel.make_mesh(n_time=3, devices="cpu")
    assert m.shape == {"time": 3, "channel": 1}
    assert m.devices.reshape(-1).tolist() == [CPU] * 3


def _fake_cards(monkeypatch, count, env):
    """A host with ``count`` cards and torchrun's ``env`` (LOCAL_*),
    as far as parallel.distributed reads them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    for var in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, str(value))


@pytest.mark.parametrize("count,world,rank,env,cards,backend", [
    (4, 2, 1, {"LOCAL_WORLD_SIZE": 2, "LOCAL_RANK": 1}, [2, 3], "nccl"),
    (4, 4, 2, {}, [2], "nccl"),
    (2, 4, 3, {"LOCAL_WORLD_SIZE": 2, "LOCAL_RANK": 1}, [1], "nccl"),
    (1, 2, 1, {}, [0], "gloo"),
    (2, 4, 3, {}, [1], "gloo"),
], ids=["2-cards-each", "1-card-each", "two-hosts", "share-1", "share-2"])
def test_local_devices_and_backend(monkeypatch, count, world, rank, env,
                                   cards, backend):
    """A rank's own cards and the backend follow one rule: NCCL exactly
    where the ranks on this host hold cards no other rank holds."""
    from gnss_sdr_tpu_torch.parallel import distributed

    _fake_cards(monkeypatch, count, env)
    assert parallel.local_devices(world, rank) == \
        [torch.device("cuda", i) for i in cards]
    assert distributed._pick_backend(world, rank) == backend


def test_no_card_picks_gloo(monkeypatch):
    from gnss_sdr_tpu_torch.parallel import distributed

    _fake_cards(monkeypatch, 0, {})
    assert distributed._pick_backend(2, 0) == "gloo"
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.local_devices(2, 0)


def test_global_mesh_under_nccl_keeps_ranks_on_their_cards(monkeypatch):
    """Rank 1 of an NCCL group of 2 on a 2-card host: its mesh entries
    default to its own card, and a card of the other rank is refused."""
    _fake_cards(monkeypatch, 2, {})
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    m = parallel.global_mesh(n_time=2)
    assert m.home == torch.device("cuda", 1)
    assert m.owners[:, 0].tolist() == [0, 1] and m.rank == 1
    assert m.spans_processes and m.is_local(1, 0)
    with pytest.raises(ValueError, match="own cards"):
        parallel.global_mesh(n_time=2, devices=["cuda:0"])


def test_mesh_defaults_to_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(n_channel=2)


def _aligned_offset(code_phase_chips):
    """The sample where a satellite of this code phase starts a period."""
    return int(round((1023.0 - code_phase_chips) % 1023.0 * FS / CODE_RATE))


class TestChannelShardedTracking:
    """tests/test_parallel.py's scene (16 channels, 8 tracking, 30
    epochs), each channel started on its satellite's code boundary."""

    @pytest.fixture(scope="class")
    def scene(self):
        sats = [SatelliteScenario(prn=p, doppler_hz=300.0 * p,
                                  code_phase_chips=13.0 * p)
                for p in range(1, 9)]
        sig = synthesize(sats, 40 * N, FS, noise_std=0.5, seed=5)
        re = np.real(sig).astype(np.float32)
        im = np.imag(sig).astype(np.float32)
        jst = j_trk.init_state(16)
        for ch in range(8):
            jst = j_trk.start_channel(jst, ch, ch, 300.0 * (ch + 1),
                                      _aligned_offset(13.0 * (ch + 1)),
                                      CODE_RATE)
        state = trk.state_from_numpy(
            {k: np.asarray(v) for k, v in jst._asdict().items()})
        codes = trk.make_code_table(GPS_L1CA, 32)[
            np.maximum(state.prn_idx, 0)]
        params = trk.TrackParams.create(TrackConfig(n_channels=16),
                                        GPS_L1CA, FS)
        return params, codes, state, jst, re, im

    def test_bit_identical_to_one_shard(self, scene):
        params, codes, state, _, re, im = scene
        ref_state, ref_telem = trk.track_block(params, codes, state, re, im,
                                               30)
        for n in (1, 8):
            st, tl = parallel.sharded_track_block(
                _mesh(1, n), params, codes, state, re, im, 30)
            for a, b, f in zip(ref_telem, tl, trk.EpochTelemetry._fields):
                np.testing.assert_array_equal(a, b, err_msg=f"telem {f}")
            for a, b, f in zip(ref_state, st, trk.ChannelState._fields):
                np.testing.assert_array_equal(a, b, err_msg=f"state {f}")
        assert ref_telem.processed[:, :8].all()

    def test_matches_jax_sharded_track_block(self, scene):
        params, codes, state, jst, re, im = scene
        jparams = j_trk.TrackParams.create(JTrackConfig(n_channels=16),
                                           J_GPS, FS)
        jst2, jtl = j_par.sharded_track_block(
            j_par.make_mesh(n_time=1, n_channel=8), jparams,
            jnp.asarray(codes), jst, re, im, 30)
        st2, tl = parallel.sharded_track_block(
            _mesh(1, 8), params, codes, state, re, im, 30)
        check_against_jax(jst2, jtl, st2, tl, CLOSED_EXACT)
        _phases_close(jst2, st2)

    def test_shard_channel_state_round_trip(self, scene):
        state = scene[2]
        shards = parallel.shard_channel_state(_mesh(1, 4), state)
        assert len(shards) == 4
        assert all(len(s.active) == 4 for s in shards)
        for f, whole in zip(trk.ChannelState._fields, state):
            np.testing.assert_array_equal(
                np.concatenate([getattr(s, f) for s in shards]), whole)
            assert np.concatenate([getattr(s, f) for s in shards]).dtype \
                == whole.dtype
        with pytest.raises(ValueError, match="divisible"):
            parallel.shard_channel_state(_mesh(1, 3), state)


class TestShardedAcquisition:
    @pytest.fixture(scope="class")
    def scene(self):
        sats = [SatelliteScenario(prn=6, doppler_hz=2500.0, amplitude=0.3),
                SatelliteScenario(prn=24, doppler_hz=-4100.0, amplitude=0.25)]
        x = synthesize(sats, 8 * N, FS, noise_std=1.0, seed=9)
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = torch.from_numpy(pcps.doppler_grid(14_000.0, 500.0))
        ref = pcps.pcps_search(torch.from_numpy(x), code_ffts, grid,
                               fs_hz=FS, n_int=8)
        jref = j_pcps.pcps_search(
            jnp.asarray(x), j_pcps.code_replica_ffts(J_GPS, FS, 32),
            jnp.asarray(grid.numpy()), fs_hz=FS, n_int=8)
        return x, code_ffts, grid, ref, jref

    @staticmethod
    def _same(res, ref, rtol=1e-4):
        res = [np.asarray(f) for f in res]
        ref = [np.asarray(f) for f in ref]
        np.testing.assert_array_equal(res[0], ref[0])        # detected
        np.testing.assert_array_equal(res[3], ref[3])        # code phase
        np.testing.assert_allclose(res[1], ref[1], rtol=rtol)  # ratio
        assert set(np.where(res[0])[0] + 1) == {6, 24}

    def test_prn_sharded_matches(self, scene):
        x, code_ffts, grid, ref, jref = scene
        res = parallel.sharded_pcps_search(
            _mesh(1, 8), torch.from_numpy(x), code_ffts, grid, fs_hz=FS,
            n_int=8)
        self._same(res, ref, rtol=1e-5)
        self._same(res, jref)

    @pytest.mark.parametrize("n_time", [2, 4, 8])
    def test_time_sharded_matches(self, scene, n_time):
        x, code_ffts, grid, ref, jref = scene
        res = parallel.time_sharded_pcps_search(
            _mesh(n_time, 1), torch.from_numpy(x), code_ffts, grid,
            fs_hz=FS, n_int=8)
        self._same(res, ref)
        jres = j_par.time_sharded_pcps_search(
            j_par.make_mesh(n_time=n_time, n_channel=1), jnp.asarray(x),
            j_pcps.code_replica_ffts(J_GPS, FS, 32),
            jnp.asarray(grid.numpy()), fs_hz=FS, n_int=8)
        self._same(res, jres)
        self._same(jres, jref)

    def test_time_sharded_indivisible_raises(self, scene):
        x, code_ffts, grid, _, _ = scene
        with pytest.raises(ValueError, match="not divisible by time axis"):
            parallel.time_sharded_pcps_search(
                _mesh(3, 1), torch.from_numpy(x), code_ffts, grid,
                fs_hz=FS, n_int=8)

    def test_grid_mesh_2x4(self, scene):
        """A time x channel grid: time 2-way, the codes replicated over
        the channel axis (as the JAX function's in_specs replicate
        them)."""
        x, code_ffts, grid, ref, jref = scene
        res = parallel.time_sharded_pcps_search(
            _mesh(2, 4), torch.from_numpy(x), code_ffts, grid, fs_hz=FS,
            n_int=8)
        self._same(res, ref)
        self._same(res, jref)


@pytest.mark.parametrize("padded", [False, True], ids=["circular", "pad_fft"])
@pytest.mark.parametrize("offset", [0, 123_456_789])
def test_pcps_power_sample_offset_matches_jax(padded, offset):
    """C20: the Doppler ramp starts at ``sample_offset`` (123,456,789 is
    past 2**32 / step for every bin of the grid: the u32 product wraps,
    and the ramp's start is that product mod 2**32). The cube within rtol
    1e-4 of the JAX package's, its arg-max lag and bin exact."""
    n_int, n_prn = 4, 6
    sats = [SatelliteScenario(prn=4, doppler_hz=1750.0,
                              code_phase_chips=211.3, amplitude=0.5)]
    grid = pcps.doppler_grid(6000.0, 500.0)
    steps = pcps.nco.freq_to_step(torch.from_numpy(grid), FS)
    assert offset == 0 or (steps[steps > 0] * offset >= 2 ** 32).all()
    x = synthesize(sats, (n_int + padded) * N, FS, noise_std=0.5, seed=3,
                   start_sample=offset)
    if padded:
        codes = pcps.code_replica_ffts_padded(GPS_L1CA, FS, n_prn)
        jcodes = jnp.asarray(codes.numpy())
        kw = dict(fs_hz=FS, n_int=n_int, n_fft=N, sample_offset=offset)
        pa = pcps.pcps_power_padded(torch.from_numpy(x), codes,
                                    torch.from_numpy(grid), **kw).numpy()
        pb = np.asarray(j_pcps.pcps_power_padded(
            jnp.asarray(x), jcodes, jnp.asarray(grid), **kw))
    else:
        codes = pcps.code_replica_ffts(GPS_L1CA, FS, n_prn)
        kw = dict(fs_hz=FS, n_int=n_int, sample_offset=offset)
        pa = pcps.pcps_power(torch.from_numpy(x), codes,
                             torch.from_numpy(grid), **kw).numpy()
        pb = np.asarray(j_pcps.pcps_power(
            jnp.asarray(x), j_pcps.code_replica_ffts(J_GPS, FS, n_prn),
            jnp.asarray(grid), **kw))
    np.testing.assert_allclose(pa, pb, rtol=1e-4)
    for p in range(n_prn):
        assert np.argmax(pa[p]) == np.argmax(pb[p])   # (bin, lag) flat
    d, lag = np.unravel_index(np.argmax(pa[3]), pa[3].shape)
    assert grid[d] == 1500.0 or grid[d] == 2000.0
    # the ramp's start: the u32 product step * offset, wrapped
    want = (steps.numpy().astype(np.uint64) * np.uint64(offset)) % 2 ** 32
    np.testing.assert_array_equal(pcps._ramp_start(steps, offset).numpy(),
                                  want.astype(np.int64))


class TestShardedReceiver:
    """tests/test_parallel.py::TestShardedReceiver's scene through the
    port's Receiver on a 4-shard mesh of the CPU."""

    @staticmethod
    def _run(pkg, par):
        if pkg == "jax":
            from gnss_sdr_tpu.config import (
                ParallelConfig, ReceiverConfig, RfConfig, TrackConfig)
            from gnss_sdr_tpu.receiver import ArraySource, Receiver
            kw = {}
        else:
            from gnss_sdr_tpu_torch.config import (
                ParallelConfig, ReceiverConfig, RfConfig, TrackConfig)
            from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver
            kw = dict(device="cpu")
        sats = [SatelliteScenario(prn=3, doppler_hz=1200.0, amplitude=0.3),
                SatelliteScenario(prn=22, doppler_hz=-2600.0, amplitude=0.25,
                                  code_phase_chips=700.0)]
        stream = synthesize(sats, int(0.4 * FS), FS, noise_std=1.0, seed=2)
        cfg = ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            track=TrackConfig(n_channels=8),
            parallel=ParallelConfig(**par), block_ms=20)
        rx = Receiver(cfg, ArraySource(stream, FS), **kw)
        rx.run()
        return rx

    @staticmethod
    def _traces(rx):
        return sorted(rx.telemetry.all_traces(), key=lambda t: t.prn)

    def test_receiver_on_mesh_matches_unsharded_and_jax(self):
        rx_a = self._run("torch", {})
        rx_b = self._run("torch", dict(channel_axis=4))
        rx_j = self._run("jax", dict(channel_axis=4))
        assert rx_a.mesh is None and rx_b.mesh.shape == \
            {"time": 1, "channel": 4}
        assert rx_j.mesh is not None
        assert set(rx_a.active) == set(rx_b.active) == set(rx_j.active) \
            == {3, 22}
        assert rx_a.summary()["channels"] == rx_b.summary()["channels"]
        for ta, tb, tj in zip(self._traces(rx_a), self._traces(rx_b),
                              self._traces(rx_j)):
            for f in ("i_p", "q_p", "carr_freq", "global_sample", "locked"):
                np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f),
                                              err_msg=f)
            np.testing.assert_allclose(np.asarray(tj.carr_freq),
                                       np.asarray(tb.carr_freq), rtol=1e-6)
            np.testing.assert_array_equal(np.asarray(tj.global_sample),
                                          np.asarray(tb.global_sample))

    def test_indivisible_channels_rejected(self):
        from gnss_sdr_tpu_torch.config import (
            ParallelConfig, ReceiverConfig, TrackConfig)
        from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver

        with pytest.raises(ValueError, match="divisible"):
            Receiver(ReceiverConfig(track=TrackConfig(n_channels=15),
                                    parallel=ParallelConfig(channel_axis=4)),
                     ArraySource(np.zeros(4096, np.complex64), FS),
                     device="cpu")


class TestFusedOnMesh:
    """tests/test_parallel.py::TestFusedOnMesh through the port's
    FusedTracker on a 4-shard mesh of the CPU: the direct layout
    (B3's plain version) single-block and in the multi-block scan, and
    the mxu layout (B1's plain version) for one block, each equal to the
    one-shard run bit for bit."""

    FS = 2_046_000.0

    def _tracker(self, c, t, buf_len, layout, mesh=None):
        n0 = GPS_L1CA.samples_per_code(self.FS)
        cfg = TrackConfig(n_channels=c, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, self.FS)
        codes_s = trk.make_sampled_code_table(GPS_L1CA, self.FS, 32,
                                              window=params.window)
        rows = torch.from_numpy(codes_s[np.arange(c) % 32])
        ft = fr.FusedTracker(params, cfg, GPS_L1CA, self.FS, codes_s, t,
                             buf_len, layout=layout, mesh=mesh, device="cpu")
        return ft, rows, n0

    @staticmethod
    def _state(c, n0, f0, df, o0, do):
        st = trk.init_state(c)
        for ch in range(c):
            st = trk.start_channel(st, ch, ch % 32, f0 + df * ch,
                                   n0 + o0 + do * ch, CODE_RATE)
        return st

    @staticmethod
    def _equal(a, b):
        for x, y, f in zip(a, b, type(a)._fields):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)

    @pytest.mark.parametrize("layout", ["direct", "mxu"])
    def test_run_block_bit_identical(self, layout):
        c, t = 8, 40
        n0 = GPS_L1CA.samples_per_code(self.FS)
        buf_len = (t + 4) * n0 + 8192
        sig = synthesize([SatelliteScenario(prn=p + 1,
                                            doppler_hz=700.0 + 140.0 * p)
                          for p in range(c)], buf_len, self.FS,
                         noise_std=0.3, seed=6)
        bre = np.real(sig).astype(np.float32)
        bim = np.imag(sig).astype(np.float32)
        out = []
        for mesh in (None, _mesh(1, 4)):
            ft, rows, n0 = self._tracker(c, t, buf_len, layout, mesh)
            assert ft.mesh is mesh and ft.layout == layout
            out.append(ft.run_block(self._state(c, n0, 700.0, 140.0, 29, 83),
                                    bre, bim, rows))
        self._equal(out[0][0], out[1][0])
        self._equal(out[0][1], out[1][1])
        assert out[1][1].processed.any()

    def test_run_blocks_bit_identical(self):
        c, t, b = 4, 20, 3
        n0 = GPS_L1CA.samples_per_code(self.FS)
        block, history = t * n0, 2 * n0 + 4096
        sig = synthesize([SatelliteScenario(prn=p + 1,
                                            doppler_hz=600.0 + 170.0 * p)
                          for p in range(c)], history + b * block, self.FS,
                         noise_std=0.3, seed=8)
        sre = np.real(sig).astype(np.float32)
        sim = np.imag(sig).astype(np.float32)
        out = []
        for mesh in (None, _mesh(1, 4)):
            ft, rows, n0 = self._tracker(c, t, history + block, "direct",
                                         mesh)
            out.append(ft.run_blocks(
                self._state(c, n0, 600.0, 170.0, 41, 77), sre, sim, rows, b))
        self._equal(out[0][0], out[1][0])
        assert len(out[1][1]) == b
        for a, m in zip(out[0][1], out[1][1]):
            self._equal(a, m)

    def test_mesh_options(self):
        n0 = GPS_L1CA.samples_per_code(self.FS)
        ft, _, _ = self._tracker(4, 20, 30 * n0, "mxu", _mesh(1, 2))
        assert ft.spread_cap == 0          # no shared fetch under a mesh
        with pytest.raises(ValueError, match="divisible"):
            self._tracker(6, 20, 30 * n0, "mxu", _mesh(1, 4))


def test_partition_and_merge_equal_jax():
    for total, hosts, halo in ((1_000_000, 4, 5000), (1000, 2, 100),
                               (1000, 1, 0)):
        a = parallel.partition_stream(total, hosts, halo)
        b = j_par.partition_stream(total, hosts, halo)
        assert [vars(s) for s in a] == [vars(s) for s in b]
    for args, match in (((1001, 4, 10), "divisible"), ((1000, 4, 300),
                                                       "halo")):
        with pytest.raises(ValueError, match=match):
            parallel.partition_stream(*args)
        with pytest.raises(ValueError, match=match):
            j_par.partition_stream(*args)
    shards = parallel.partition_stream(1000, 2, halo=100)
    ev_a = [{"global_sample": 10}, {"global_sample": 520}]  # 520 in halo
    ev_b = [{"global_sample": 520}, {"global_sample": 900}, {"prn": 3}]
    merged = parallel.merge_shard_results(shards, [ev_a, ev_b])
    assert merged == j_par.merge_shard_results(
        j_par.partition_stream(1000, 2, halo=100), [ev_a, ev_b])
    # an event without a sample index counts as its shard's first sample
    # and sorts first, as in the JAX package
    assert [e.get("global_sample") for e in merged] == [None, 10, 520, 900]


def test_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not parallel.initialize_from_env()
    assert not parallel.initialize_from_env(world_size=1)
    assert not torch.distributed.is_initialized()
    m = parallel.global_mesh(n_time=2, devices=[CPU] * 2)
    assert m.shape == {"time": 2, "channel": 1} and not m.spans_processes


def test_names_match_the_jax_package():
    import gnss_sdr_tpu.parallel as jp

    names = {n for n in dir(jp) if not n.startswith("_")
             and n not in ("sharding", "distributed")}
    assert len(names) == 13
    assert names <= set(dir(parallel)), names - set(dir(parallel))


def test_dryrun_multichip_on_cpu():
    from gnss_sdr_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu")
    assert out["fused_scan"] == {"time": 1, "channel": 4}
    assert out["time_sharded"] == {"time": 4, "channel": 1}
