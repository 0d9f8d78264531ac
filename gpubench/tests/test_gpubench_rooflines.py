"""The roofline files count what chip_smoke.py counted at the 2.046 MHz
main path (PERF.md's table of kernels): B4a 198,581,248 B (windows,
500 ms blocks), B4b 50,576,128 B (seg, 125 ms), B4c 67,811,312 B and
B5 658,560 B per launch; 24 of 32 channels tracking, n_t = 2046."""
import torch

from gpubench.harness import spec

C, N0, ACTIVE = 32, 2046, 24


def _epoch_case(t_epochs, wp):
    telem = torch.zeros((t_epochs, C, 17))
    telem[:, :ACTIVE, 12] = N0
    telem[:, :ACTIVE, 16] = 1.0
    reps = torch.zeros((C, 5, wp))
    state = torch.zeros((C, 128))
    seg = torch.zeros((C, 8))
    return (seg, seg, reps, state), (telem, state.clone())


def _bytes(kernel, args, out):
    return float(spec.roofline(kernel).cost(args, {}, out)["bytes"])


def test_b4a_windows_500ms():
    args, out = _epoch_case(500, 2176)
    assert _bytes("b4a", args, out) == 198_581_248


def test_b4b_seg_125ms():
    args, out = _epoch_case(125, 2432)
    assert _bytes("b4b", args, out) == 50_576_128


def test_b4c_gather_125ms():
    n = 24_552 + 125 * N0                      # history + block
    block = torch.zeros(n)
    starts = torch.zeros(C, dtype=torch.int32)
    seg = torch.zeros((C, 256_128))
    assert _bytes("b4c", (block, block, starts), (seg, seg)) == 67_811_312


def test_b5_one_epoch():
    w = N0 + 8
    f = torch.zeros((C, w))
    i32 = torch.zeros(C, dtype=torch.int32)
    u32 = torch.zeros(C, dtype=torch.int64)
    args = (f, f, i32, u32, u32, i32, torch.zeros(C), torch.zeros(C),
            torch.zeros((C, 1023)))
    assert _bytes("b5", args, None) == 658_560


def test_b1_counts_every_input_once():
    """Two of four channels active, two supersteps of five epochs: the
    union of their windows [0, 1034) of the stream (span 640, superstep
    offsets 0 and 384; channel 1 starts 10 later), their replica rows,
    and the starts, state and telemetry whole."""
    stream = torch.zeros(4000)
    starts = torch.tensor([0, 10, 500, 700], dtype=torch.int32)
    bank = torch.zeros((4, 8, 256), dtype=torch.bfloat16)
    state = torch.zeros((4, 128))
    telem = torch.zeros((10, 4, 21))
    telem[:, :2, 12] = 100
    telem[:, :2, 16] = 1.0
    kw = dict(t_epochs=10, k_epochs=5, n0=100, wp=256)
    c = spec.roofline("b1").cost((stream, stream, starts, bank, state), kw,
                                 (telem, state))
    assert float(c["bytes"]) == 1034 * 8 + 2 * 8 * 256 * 2 + 16 \
        + 2048 * 2 + 3360
    assert float(c["bf16_ops"]) == 2 * 2 * 8 * 2000
    assert float(c["f32_ops"]) == 12 * 2000
    # a channel whose windows lie apart adds all of them
    starts[1] = 3000
    c = spec.roofline("b1").cost((stream, stream, starts, bank, state), kw,
                                 (telem, state))
    assert float(c["bytes"]) == (1024 + 1024) * 8 + 2 * 8 * 256 * 2 + 16 \
        + 2048 * 2 + 3360


def test_b1_lean_telemetry_counts_the_same_lanes():
    """The multi-block scan's lean telemetry (processed in bit 0 of col
    16 beside the lock and loss bits, the held code rate on each
    superstep's first epoch) gives the full telemetry's lane count."""
    stream = torch.zeros(4000)
    starts = torch.tensor([0, 10, 500, 700], dtype=torch.int32)
    bank = torch.zeros((4, 8, 256), dtype=torch.bfloat16)
    state = torch.zeros((4, 128))
    telem = torch.zeros((10, 4, 21))
    telem[:, :2, 16] = 3.0                   # processed + 2 locked
    telem[::5, :2, 18] = 100.0               # fs * code_len / 100 lanes
    kw = dict(t_epochs=10, k_epochs=5, n0=100, wp=256, fs=1000.0,
              code_len=10.0, telem_mode="lean")
    c = spec.roofline("b1").cost((stream, stream, starts, bank, state), kw,
                                 (telem, state))
    assert float(c["bf16_ops"]) == 2 * 2 * 8 * 2000
    assert float(c["f32_ops"]) == 12 * 2000
