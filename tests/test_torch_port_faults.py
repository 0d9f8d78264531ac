"""Two faults of the PyTorch port repaired in its own copies, on the CPU:

* ROADMAP C19: the port's ``DeviceStreamWindow`` (the receiver's window
  on the card) has ``buf``, ``to_global`` and ``to_local``, as the JAX
  package's and the port's host ``StreamWindow`` have them;
* ROADMAP C2: one flipped nav bit costs at most the subframe it sits in
  (the frame decoder keeps its alignment through one parity failure, and
  the chain's anti-stuck rebuild counts the bits since the last unlock),
  held to an oracle: the clean stream's decoded subframes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu.receiver.stream import (  # noqa: E402
    DeviceStreamWindow as JDeviceStreamWindow)

from gnss_sdr_tpu_torch.nav.bits import (  # noqa: E402
    SUBFRAME_BITS, FrameDecoder, encode_frames)
from gnss_sdr_tpu_torch.receiver.navproc import GpsLnavChain  # noqa: E402
from gnss_sdr_tpu_torch.receiver.stream import (  # noqa: E402
    DeviceStreamWindow, StreamWindow)

H, B = 37, 16                       # history, block


def _blocks(seed=5):
    """Fresh blocks as the windows take them: planar f32 pairs, a
    complex block, and a short last block (zero-padded)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (B, B, B, B, 9):
        x = (rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(np.complex64)
        out.append(x if len(out) == 2 else
                   (x.real.astype(np.float32), x.imag.astype(np.float32)))
    return out


def test_device_window_buf_and_index_maps_equal_the_host_and_jax_windows():
    """C19: after each of several advances, the port's DeviceStreamWindow
    on the CPU holds the same complex ``buf`` as StreamWindow and as the
    JAX DeviceStreamWindow, and maps indices as they do."""
    dev = DeviceStreamWindow(H, B, "cpu")
    host = StreamWindow(H, B)
    ref = JDeviceStreamWindow(H, B)
    for fresh in _blocks():
        assert dev.advance(fresh) == host.advance(fresh) == \
            ref.advance(fresh)
        buf = dev.buf
        assert buf.dtype == np.complex64 and buf.shape == (H + B,)
        np.testing.assert_array_equal(buf, host.buf)
        np.testing.assert_array_equal(buf, ref.buf)
        for i in (0, 5, H, H + B - 1):
            g = ref.to_global(i)
            assert dev.to_global(i) == host.to_global(i) == g
            assert dev.to_local(g) == host.to_local(g) == ref.to_local(g) \
                == i
    assert dev.global_start == ref.global_start == 5 * B - H


# ---------------------------------------------------------------------------
# C2: one flipped bit costs its own subframe only
# ---------------------------------------------------------------------------

N_SF = 9


def _lnav_stream(seed=3):
    """N_SF consecutive LNAV subframes (ids 1-5 cycling, TOW counting) as
    a +/-1 bit stream, behind two lead-in bits of 0 (the first word's
    D29* and D30*)."""
    rng = np.random.default_rng(seed)
    frames = [(1 + i % 5, 1000 + i,
               rng.integers(0, 2, (8, 24)).astype(np.uint8))
              for i in range(N_SF)]
    return np.concatenate([[-1, -1], encode_frames(frames)]).astype(np.int8)


def _flip(bits, subframe, bit=97):
    """The stream with one bit of ``subframe`` flipped (word 4, past the
    preamble and the HOW)."""
    out = bits.copy()
    out[2 + subframe * SUBFRAME_BITS + bit] *= -1
    return out


def _decoded_by_frames(bits):
    dec = FrameDecoder()
    return [sf.tow_counts for sf in (dec.feed(int(b)) for b in bits)
            if sf is not None]


def _decoded_by_chain(bits, per_call=500):
    """The subframes GpsLnavChain decodes from 1 ms prompts (20 per bit,
    one amplitude, the receiver's epoch indices), fed ``per_call``
    prompts at a time as blocks arrive."""
    prompts = np.repeat(bits.astype(np.float64), 20) * 40.0
    epochs = np.arange(prompts.size)
    chain = GpsLnavChain(prn=7)
    out = []
    for i in range(0, prompts.size, per_call):
        events = chain.feed_array(prompts[i:i + per_call],
                                  epochs[i:i + per_call])
        out += [e.payload.tow_counts for e in events]
    return out


@pytest.mark.parametrize("decode", [_decoded_by_frames, _decoded_by_chain],
                         ids=["frame_decoder", "lnav_chain"])
@pytest.mark.parametrize("subframe", [2, 5])
def test_one_flipped_bit_costs_at_most_its_subframe(decode, subframe):
    """The oracle: the clean stream's decoded subframes. With one bit of
    a subframe flipped, every other subframe still decodes (the frame
    decoder keeps its alignment through one parity failure; the chain
    does not rebuild its bit sync on the buffered bits)."""
    bits = _lnav_stream()
    clean = decode(bits)
    # consecutive from the first subframe after bit sync and frame lock
    assert clean == list(range(clean[0], clean[0] + len(clean)))
    assert clean[0] <= 1001 and clean[-1] == 1000 + N_SF - 1
    got = decode(_flip(bits, subframe))
    assert got == [t for t in clean if t != 1000 + subframe], got


def test_a_bit_slip_still_unlocks_and_relocks():
    """Two parity failures in a row (a bit slip shifts every later
    subframe) drop the lock, and the preamble search re-acquires the new
    alignment from the bits that follow: the subframes after the slip
    decode again."""
    bits = _lnav_stream()
    cut = 2 + 3 * SUBFRAME_BITS + 150
    slipped = np.concatenate([bits[:cut], bits[cut + 1:]])
    dec = FrameDecoder()
    got = []
    for b in slipped:
        sf = dec.feed(int(b))
        if sf is not None:
            got.append(sf.tow_counts)
    assert dec.unlocked_at > cut
    assert got[:3] == [1000, 1001, 1002]
    assert got[-1] == 1000 + N_SF - 1
    assert 1003 not in got
