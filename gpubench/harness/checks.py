"""What decides ``correct``: the program's answers in the run held to
the benchmark's plain reference (``gpubench/reference``), which gets the
same int8 samples (rendered again from the seed) and works out again
whatever the program derived from them.

  acq_gap      each branch's first search and a seeded sample of its
               others: the detected PRNs and each one's code phase the
               same as the reference's, and the largest relative gap of
               the peak/average ratios (a differing detection reads 1);
               an in-scan search (searched inside a span) compares the
               ratio of every PRN it searched
  acq_freq_gap_hz  in the same searches: the largest gap of a detection's
               fine carrier, Hz
  track_gap    a sample of the window's blocks, drawn from the seed,
               tracked by the reference from the ledger the program's
               tracking started from: the largest gap of the six
               correlator sums over the channel's median prompt
               magnitude (a differing processed, lock or loss flag,
               start sample or epoch count reads 1, and so does a block
               of the run whose ledger does not carry on from the one
               before: ``carries_on``)
  loop_gap_hz  in the same blocks: the largest gap of the carrier
               frequency and of the code rate after each epoch's loop
               filters
  carrier_truth_hz  in the same blocks: the largest gap between the
               mean carrier frequency the program reports over a
               channel's processed epochs of the block and the carrier
               of that PRN's satellite in the sky
               (``Satellite.carrier_hz``), over the channels tracked for
               at least the traffic's ``check.truth_after_s`` at the
               block's first of them (2 s where it names none: the
               pull-in after a handoff left out); a PRN that is not in
               the sky is left out (a false alarm is the acquisition's,
               and ``acq_gap`` judges it). The mean, not one epoch: a
               sound loop's single epochs stray by up to some 50 Hz
  nav_wrong    every message unit the nav layer decoded (LNAV subframe
               and ephemeris, I/NAV word, D1 subframe, GLONASS string)
               that differs from what the satellite broadcast
  nav_missing  channels tracked for the traffic's ``nav_min_s`` of signal
               with nothing decoded (but for the branches that the
               configuration's ``nav_missing_skip`` names)

In spans (a traffic whose drive runs ``scan_blocks`` > 1) the tracking
numbers compare every block of a sample of the window's spans, drawn
from the seed: the reference starts each span from the ledger the
program started it from and carries its own ledger from block to block
(``reference/span.py``), each superstep after the span's first at the
rates the program held in it; ``loop_gap_hz`` is then the gap between
the rates its own loop update gave and the program's. The sums compare
as the program's download carries them (in bfloat16 on the slim2 wire:
the gap beyond half a bfloat16 step). Every pair of blocks, inside
spans and across them, carries on (the next block's first epoch one
code period, or as many as the offset walk skipped, past this block's
last); the span's last ledger equals the reference's in its integer
fields; and between two spans the program started exactly the
handoffs of the searches in between, in order, into idle channels, and
nothing else in the ledger changed.

The tracking reference is the module ``reference/<name>.py`` that the
configuration's ``reference.tracker`` names (``spec.reference``).

A configuration compares the numbers its ``limits`` name; the others are
printed beside them, as readings.

The control (``control=True``) puts the reference at the control's
precision in the program's place for the acquisition and tracking
numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import acquisition as ref_acq
from ..reference import conv_acquisition as conv_acq
from ..reference import ledger, lnav, span
from ..signals import SIGNALS, beidou_b1i, glonass_l1of
from . import spec

NUMBERS = ("acq_gap", "acq_freq_gap_hz", "track_gap", "loop_gap_hz",
           "carrier_truth_hz", "nav_wrong", "nav_missing")
TRUTH_AFTER_S = 2.0       # check.truth_after_s where a traffic names none
SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")
FLAGS = ("processed", "locked", "lost_event")
LEDGER = ("start_offset", "epoch_index")
FLAG_GAP_HZ = 1e9         # loop_gap_hz where flags or the ledger differ


class Layout:
    """A branch's sample layout, worked out from its configuration: the
    samples per code period, per block, of the acquisition's chunk and
    of the window's history."""

    def __init__(self, d: dict, fs_hz: float, code_period_ms: int):
        acq = d["acq"]
        self.n0 = int(round(fs_hz * code_period_ms / 1000.0))
        self.epochs = d["block_ms"] // code_period_ms
        self.block = self.epochs * self.n0
        self.n_int = acq["non_coherent_ms"] // code_period_ms
        extra = 1 if (acq["pad_fft"] or acq["engine"] == "conv") else 0
        self.acq_len = (self.n_int + extra) * self.n0
        self.history = self.acq_len + 2 * self.n0


def samples(stream, a: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stream samples [a, a + n) as float32 host tensors (the int8 over
    the stream's scale, as the receiver reads them)."""
    re8, im8 = stream.int8_range(a, a + n)
    inv = 1.0 / stream.scale
    return (re8.cpu().to(torch.float32) * inv,
            im8.cpu().to(torch.float32) * inv)


def _squaring(name: str) -> bool:
    """Whether the signal's modulation flips inside a search (secondary
    code, or symbols shorter than 20 ms): its fine search squares."""
    sig = SIGNALS[name]
    symbol_ms = sig.units_per_symbol // sig.units_per_code * \
        sig.code_period_ms
    return sig.secondary is not None or symbol_ms < 20


# -- acquisition --------------------------------------------------------

def acq_gaps(prog: dict, ref: dict) -> tuple[float, float, int | None]:
    """(the largest gap of one search, the largest carrier gap in Hz,
    the PRN of the first): ``prog`` {PRN: (lag, Hz, ratio)} of the
    detected PRNs, ``ref`` {PRN: (detected, ratio, lag, Hz)}. A PRN
    detected on one side only, or at another code phase, reads 1."""
    worst, hz, at = 0.0, 0.0, None
    for prn, (det, ratio, lag, freq) in ref.items():
        if det != (prn in prog):
            return 1.0, hz, prn
        if not det:
            continue
        p_lag, p_freq, p_ratio = prog[prn]
        if p_lag != lag:
            return 1.0, hz, prn
        hz = max(hz, abs(p_freq - freq))
        gap = abs(p_ratio - ratio) / ratio
        if gap > worst:
            worst, at = gap, prn
    return worst, hz, at


def _search_ref(x, name, d, fs, allowed, rnd):
    """The reference's verdicts on one search's chunk, by the PRN the
    receiver reports (FDMA: the channel's pseudo-PRN)."""
    sig, acq = SIGNALS[name], d["acq"]
    n_int = acq["non_coherent_ms"] // sig.code_period_ms
    sq = _squaring(name)
    if acq["fdma_spacing_hz"]:
        code = {1: sig.sample_code(1, fs)}
        out = {}
        for i, k in enumerate(acq["fdma_channels"]):
            if i + 1 not in allowed:
                continue
            r = ref_acq.search(x, code, fs, acq, n_int,
                               f_offset_hz=float(np.float32(
                                   k * acq["fdma_spacing_hz"])),
                               squaring=sq, rnd=rnd)
            out[i + 1] = r[1]
        return out
    codes = {p: sig.sample_code(p, fs) for p in allowed}
    return ref_acq.search(x, codes, fs, acq, n_int, squaring=sq, rnd=rnd)


def _conv_decim(acq: dict, sig, n_fft: int) -> int:
    """The conv engine's coarse decimation (its configuration's
    ``coarse_decim``, or the largest power of two that divides the
    period's samples and keeps a sample a chip, two for BOC)."""
    if acq["coarse_decim"]:
        return int(acq["coarse_decim"])
    floor = sig.code_length * (2 if sig.boc else 1)
    r, k = 1, 2
    while n_fft % k == 0 and n_fft // k >= floor:
        r, k = k, k * 2
    return r


def _conv_ref(re8, im8, scale, name, d, fs, prns, rnd):
    sig, acq = SIGNALS[name], d["acq"]
    inv = 1.0 / scale
    codes = {p: sig.sample_code(p, fs) for p in prns}
    n_fft = int(round(fs * sig.code_period_ms / 1000.0))
    return conv_acq.search(re8.double() * inv, im8.double() * inv, codes,
                           fs, acq, acq["non_coherent_ms"]
                           // sig.code_period_ms,
                           _conv_decim(acq, sig, n_fft),
                           float(acq["detection_threshold"]), rnd=rnd)


def row_gaps(prog: dict, ref: dict) -> tuple[float, float, int | None]:
    """``acq_gaps`` over every searched PRN of an in-scan search, ``prog``
    {PRN: (detected, ratio, lag, Hz)} as ``ref``: the detections equal,
    a detection's code phase equal (else 1), the largest relative gap of
    the ratios of every PRN, detected or not."""
    worst, hz, at = 0.0, 0.0, None
    for prn, (det, ratio, lag, freq) in ref.items():
        p_det, p_ratio, p_lag, p_freq = prog[prn]
        if bool(p_det) != bool(det) or (det and int(p_lag) != lag):
            return 1.0, hz, prn
        if det:
            hz = max(hz, abs(float(p_freq) - freq))
        gap = abs(float(p_ratio) - ratio) / ratio
        if gap > worst:
            worst, at = gap, prn
    return worst, hz, at


def check_acq(run, n_searches: int, control=False, log=None
              ) -> tuple[float, float, int]:
    """(acq_gap, acq_freq_gap_hz, searches compared) over each branch's
    first search and a sample, drawn from the seed, of its others:
    ``n_searches`` a branch in all. The reference runs on the run's
    device."""
    worst, worst_hz, n, where = 0.0, 0.0, 0, None
    fs = float(run.config["stream"]["fs_hz"])
    for bi, (name, br) in enumerate(run.branches.items()):
        d = run.config["branches"][name]
        lay = Layout(d, fs, SIGNALS[name].code_period_ms)
        rng = np.random.default_rng([run.seed, 5, bi])
        searches = br.searches
        if len(searches) > n_searches:
            # the first search (the cold start) and a sample of the rest
            rest = rng.choice(np.arange(1, len(searches)), n_searches - 1,
                              replace=False)
            searches = [searches[0]] + [searches[i] for i in sorted(rest)]
        conv = d["acq"]["engine"] == "conv"
        for s in searches:
            a = s["gs"] + s["w0"] - lay.block
            re8, im8 = run.stream.int8_range(a, a + lay.acq_len)
            in_scan = s.get("kind") == "span"
            prns = ([p for p in s["rowmap"] if p is not None] if in_scan
                    else s["allowed"])

            def search(low):
                """The reference's verdicts, at the configuration's
                precision or (``low``) the control's."""
                if conv:
                    return _conv_ref(re8, im8, run.stream.scale, name, d, fs,
                                     prns, conv_acq.f8 if low
                                     else conv_acq.bf16)
                inv = 1.0 / run.stream.scale
                x = torch.complex(re8.double() * inv, im8.double() * inv)
                return _search_ref(x, name, d, fs, prns,
                                   ref_acq.bf16 if low else ref_acq.as_is)
            ref = search(False)
            if in_scan:
                # an in-scan search: every row it searched
                prog = search(True) if control else {
                    p: (s["detected"][i], s["ratio"][i], s["lag"][i],
                        s["freq"][i]) for i, p in enumerate(s["rowmap"])
                    if p is not None}
                gap, hz, prn = row_gaps(prog, ref)
            else:
                prog = ({p: (lag, f, r) for p, (det, r, lag, f)
                         in search(True).items() if det} if control
                        else {p: (lag, f, r) for p, lag, f, r in s["cands"]})
                gap, hz, prn = acq_gaps(prog, ref)
            worst_hz = max(worst_hz, hz)
            if gap >= worst:
                worst = gap
                where = (name, s["block"], prn, prog.get(prn), ref.get(prn))
            n += 1
    if log is not None:
        log(f"largest acq_gap {worst!r} at (branch, block, PRN, program "
            f"(lag, Hz, ratio), reference (detected, ratio, lag, Hz)) "
            f"{where}; largest carrier gap {worst_hz!r} Hz")
    return worst, worst_hz, n


# -- tracking -----------------------------------------------------------

def track_gaps(prog: dict, ref: dict) -> tuple[float, float]:
    """(track gap, loop gap Hz) of one block's [T, C] telemetry."""
    for f in FLAGS:
        if not np.array_equal(np.asarray(prog[f], bool), ref[f]):
            return 1.0, FLAG_GAP_HZ
    proc = ref["processed"]
    if not proc.any():
        return 0.0, 0.0
    for f in LEDGER:
        if not np.array_equal(np.asarray(prog[f])[proc], ref[f][proc]):
            return 1.0, FLAG_GAP_HZ
    mag = np.sqrt(ref["i_p"].astype(np.float64) ** 2
                  + ref["q_p"].astype(np.float64) ** 2)
    gap, loop = 0.0, 0.0
    for c in np.nonzero(proc.any(axis=0))[0]:
        rows = proc[:, c]
        scale = float(np.median(mag[rows, c]))
        for f in SUMS:
            d = np.abs(np.asarray(prog[f], np.float64)[rows, c]
                       - ref[f][rows, c].astype(np.float64))
            gap = max(gap, float(d.max()) / max(scale, 1e-30))
        for f in ("carr_freq", "code_rate"):
            d = np.abs(np.asarray(prog[f], np.float64)[rows, c]
                       - ref[f][rows, c].astype(np.float64))
            loop = max(loop, float(d.max()))
    return gap, loop


def carries_on(telem, gs: int, nxt_state, nxt_gs: int, n0: int) -> bool:
    """Whether the next block's ledger carries on from this block's
    telemetry for every channel this block processed and did not lose:
    still active under the same PRN, its epoch count one past the last
    processed epoch's, its next start about one code period (+-2
    samples) past that epoch's start, and that epoch's carrier
    frequency."""
    proc = np.asarray(telem.processed)
    lost = np.asarray(telem.lost_event).any(axis=0)
    for c in np.nonzero(proc.any(axis=0) & ~lost)[0]:
        last = np.nonzero(proc[:, c])[0][-1]
        if not nxt_state.active[c]:
            return False
        if int(nxt_state.epochs[c]) != int(telem.epoch_index[last, c]) + 1:
            return False
        step = (nxt_gs + int(nxt_state.offset[c])) - (
            gs + int(telem.start_offset[last, c]))
        if abs(step - n0) > 2:
            return False
        if np.float32(nxt_state.carr_freq[c]) != np.float32(
                telem.carr_freq[last, c]):
            return False
    return True


def truth_gap(prog: dict, prn_idx, truth: dict, period_s: float,
              after_s: float) -> tuple[float, int | None]:
    """(Hz, PRN): the largest gap of one block's telemetry ``prog``
    between a channel's mean carrier frequency over the epochs it
    processed and ``truth`` {PRN: the satellite's carrier, Hz}, over the
    channels whose epoch count at the first of them spans ``after_s``;
    ``prn_idx`` [C] each channel's PRN row; PRNs not in ``truth`` are
    left out."""
    proc = np.asarray(prog["processed"], bool)
    epochs = np.asarray(prog["epoch_index"])
    freq = np.asarray(prog["carr_freq"], np.float64)
    worst, at = 0.0, None
    for c in np.nonzero(proc.any(axis=0))[0]:
        rows = proc[:, c]
        first = np.nonzero(rows)[0][0]
        prn = int(prn_idx[c]) + 1
        hz = truth.get(prn)
        if hz is None or int(epochs[first, c]) * period_s < after_s:
            continue
        gap = abs(float(freq[rows, c].mean()) - hz)
        if gap > worst:
            worst, at = gap, prn
    return worst, at


def _truth(run, name: str) -> dict:
    """{PRN: carrier Hz} of the branch's satellites in the run's sky."""
    return {s.prn: float(s.carrier_hz) for s in run.sky if s.system == name}


def _tracker(run, name: str, d: dict, fs: float, lay: Layout):
    """The branch's reference tracker, from the module the configuration
    names; with that module."""
    ref = spec.reference(run.config["reference"]["tracker"])
    return ref, ref.Tracker(SIGNALS[name], d, fs, lay)


def check_track(run, n_blocks: int, control=False
                ) -> tuple[float, float, float, list]:
    """(track_gap, loop_gap_hz, carrier_truth_hz, [(branch, block, gap,
    loop gap, truth gap, its PRN)]) over ``n_blocks`` of the window's
    blocks per branch, drawn from the seed, every epoch of each. The
    reference starts each block from the ledger the program's step
    started from, with the block's handoffs made again from the
    acquisition's verdicts; where the configuration's reference says
    ``follow``, each superstep after a block's first starts from the
    loops as the program's telemetry left them. The truth gap is the
    program's (the control's in its place)."""
    follow = bool(run.config["reference"].get("follow"))
    fs = float(run.config["stream"]["fs_hz"])
    after = float(run.traffic["check"].get("truth_after_s", TRUTH_AFTER_S))
    ids = list(run.window_block_ids())
    rng = np.random.default_rng([run.seed, 4])
    pick = sorted(rng.choice(ids, min(n_blocks, len(ids)), replace=False))
    gap, loop, truth, seen = 0.0, 0.0, 0.0, []
    for name, br in run.branches.items():
        d = run.config["branches"][name]
        sig = SIGNALS[name]
        lay = Layout(d, fs, sig.code_period_ms)
        sky = _truth(run, name)
        if not control:
            # every block of the run hands its ledger on to the next
            for b, (telem, gs) in br.telem.items():
                nxt = br.track_in.get(b + 1)
                if nxt is not None and not carries_on(telem, gs, nxt[0],
                                                      nxt[1], lay.n0):
                    gap, loop = 1.0, FLAG_GAP_HZ
                    seen.append((name, int(b), 1.0, FLAG_GAP_HZ, 0.0, None))
                    break
        _, trk = _tracker(run, name, d, fs, lay)
        for b in pick:
            state, gs, events = br.track_in[int(b)]
            telem, gs2 = br.telem[int(b)]
            if gs != gs2:
                raise RuntimeError(f"{name} block {b}: the tracking input "
                                   f"and the telemetry name other windows")
            re, im = samples(run.stream, gs - lay.block,
                             lay.history + lay.block)
            st = ledger.handoff(state._asdict(), events, sig.code_rate_hz)
            # the judge follows the loops of what it judges
            cand = (trk.run(st, re, im, True) if control
                    else telem._asdict())
            ref = trk.run(st, re, im, False, cand if follow else None)
            g, lp = track_gaps(cand, ref)
            hz, prn = truth_gap(cand, st["prn_idx"], sky,
                                sig.code_period_ms * 1e-3, after)
            gap, loop, truth = max(gap, g), max(loop, lp), max(truth, hz)
            seen.append((name, int(b), g, lp, hz, prn))
    return gap, loop, truth, seen


# -- tracking in spans --------------------------------------------------

def block_summary(telem, gs: int) -> tuple:
    """What ``carries_on_blocks`` reads of a block: its window's global
    start, and per channel whether it processed an epoch, whether it
    lost lock, and the start sample and epoch count of its first and
    last processed epochs."""
    proc = np.asarray(telem.processed)
    cols = np.arange(proc.shape[1])
    first = np.argmax(proc, axis=0)
    last = proc.shape[0] - 1 - np.argmax(proc[::-1], axis=0)
    so = np.asarray(telem.start_offset)
    ei = np.asarray(telem.epoch_index)
    return (int(gs), proc.any(axis=0),
            np.asarray(telem.lost_event).any(axis=0), so[first, cols],
            so[last, cols], ei[first, cols], ei[last, cols])


def carries_on_blocks(a: tuple, b: tuple, n0: int) -> bool:
    """Whether block ``b`` carries on from block ``a`` (summaries) for
    every channel ``a`` processed and did not lose: ``b`` processes it,
    its first epoch count past ``a``'s last by the code periods between
    them (one, or more where the offset walk skipped), and its first
    start that many periods (+-2 samples) past ``a``'s last."""
    gs_a, any_a, lost_a, _, so_last, _, ei_last = a
    gs_b, any_b, _, so_first, _, ei_first, _ = b
    for c in np.nonzero(any_a & ~lost_a)[0]:
        if not any_b[c]:
            return False
        periods = int(ei_first[c]) - int(ei_last[c])
        step = (gs_b + int(so_first[c])) - (gs_a + int(so_last[c]))
        if periods < 1 or abs(step - periods * n0) > 2:
            return False
    return True


def _led(x, code_rate_hz: float) -> tuple:
    """A span's ledger on the host: from a ChannelState, or from the
    card's ledger tensors."""
    if hasattr(x, "_fields"):
        return span.led_from_state(x._asdict(), code_rate_hz)
    return tuple(np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t)
                 for t in x)


def _prn_rows(rec: dict, n_ch: int) -> np.ndarray:
    """Each channel's PRN row at a span's start."""
    x = rec["led_in"]
    if hasattr(x, "_fields"):
        return np.asarray(x.prn_idx)
    rows = np.zeros(n_ch, np.int32)
    for prn, ch in rec["channels"].items():
        rows[ch] = prn - 1
    return rows


def _excess(p, r, wire: str) -> np.ndarray:
    """|p - r|, less half a bfloat16 step of the larger where the wire
    carries the program's value in bfloat16."""
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    d = np.abs(p - r)
    if wire == "f32":
        return d
    m = np.maximum(np.abs(p), np.abs(r))
    e = np.floor(np.log2(np.where(m > 0, m, 1.0)))
    return np.maximum(d - np.where(m > 0, 2.0 ** (e - 8), 0.0), 0.0)


def span_track_gap(prog: dict, ref: dict, wire: str, k: int) -> float:
    """``track_gaps``' sum gap of one block of a span, on what the wire
    carries: the prompt sums every processed epoch, the early and late
    sums where the wire has them (slim2: the first epoch of even
    supersteps); a differing flag, start or epoch count reads 1."""
    for f in FLAGS:
        if not np.array_equal(np.asarray(prog[f], bool), ref[f]):
            return 1.0
    proc = ref["processed"]
    if not proc.any():
        return 0.0
    for f in LEDGER:
        if not np.array_equal(np.asarray(prog[f])[proc], ref[f][proc]):
            return 1.0
    mag = np.sqrt(ref["i_p"].astype(np.float64) ** 2
                  + ref["q_p"].astype(np.float64) ** 2)
    carried = np.ones(proc.shape[0], bool)
    if wire == "slim2":
        carried[:] = False
        carried[::2 * k] = True
    gap = 0.0
    for c in np.nonzero(proc.any(axis=0))[0]:
        rows = proc[:, c]
        scale = max(float(np.median(mag[rows, c])), 1e-30)
        for f in SUMS:
            r = rows if f in ("i_p", "q_p") else rows & carried
            if r.any():
                d = _excess(np.asarray(prog[f])[r, c], ref[f][r, c], wire)
                gap = max(gap, float(d.max()) / scale)
    return gap


def check_handoffs(run, br, n0: int, block: int, code_rate_hz: float
                   ) -> str | None:
    """Between two spans of one run: the handoffs the program made
    (``acq_events``) are the searches' candidates in between, in order,
    as many as idle channels take (eight a span in the pipeline), and
    the next span's ledger is the last one's with exactly those
    channels started (synchronous spans on the host from the search's
    code boundary; the pipeline on the card, the boundary moved into
    [n0, 2 n0) of the span's window, a span late). Returns what
    differs, or None."""
    pipelined = bool(run.drive.get("span_pipeline"))
    events = br.acq_events
    for i in range(1, len(br.spans)):
        a, b = br.spans[i - 1], br.spans[i]
        if a["run"] != b["run"] or b["first"] != a["first"] + a["k"]:
            continue
        made = [(c.prn, float(np.float32(c.carrier_freq_hz)),
                 int(c.sample_local_index))
                for _, c in events[a["events"]:b["events"]]]
        found = [(p, float(np.float32(f)), int(x)) for s in br.searches
                 if s["unit"] == i - 1 for p, f, x in s["handed"]]
        last = _led(a["led_out"], code_rate_hz)
        n_idle = int((last[0] < 0.5).sum())
        take = min(len(found), n_idle, 8 if pipelined else len(found))
        if made != found[:take]:
            return (f"span {i}: handoffs {made} where the searches before "
                    f"it gave {found}")
        start = b["led_in"]
        if pipelined:
            want = last
            for prn, freq, sample in made:
                ch = b["channels"][prn]
                if want[0][ch] > 0.5:
                    return f"span {i}: PRN {prn} started on busy channel {ch}"
                off = n0 + (sample - a["k"] * block) % n0
                want = span.start_in_led(want, ch, freq, off, code_rate_hz)
            got = _led(start, code_rate_hz)
        else:
            st = span.state_from_led(last, a["led_in"].prn_idx)
            want_d = ledger.handoff(st, made, code_rate_hz)
            want = [want_d[f] for f in ledger.DTYPES]
            got = [np.asarray(getattr(start, f)) for f in ledger.DTYPES]
        for w, g in zip(want, got):
            if not np.array_equal(np.asarray(w), np.asarray(g)):
                return f"span {i}: the ledger it started from differs"
    return None


def check_spans(run, n_spans: int, control=False, log=None
                ) -> tuple[float, float, float, list]:
    """(track_gap, loop_gap_hz, carrier_truth_hz, [(branch, block, gap,
    loop gap, truth gap, its PRN)]) over every block of ``n_spans`` of
    the window's spans, drawn from the seed as the window ran; the links
    between blocks, the spans' last ledgers and the handoffs between
    spans besides (not for the control)."""
    fs = float(run.config["stream"]["fs_hz"])
    after = float(run.traffic["check"].get("truth_after_s", TRUTH_AFTER_S))
    gap, loop, truth, seen = 0.0, 0.0, 0.0, []
    for name, br in run.branches.items():
        d = run.config["branches"][name]
        sig = SIGNALS[name]
        lay = Layout(d, fs, sig.code_period_ms)
        code_len = int(sig.code_length)
        sky = _truth(run, name)
        if not control:
            ids = sorted(br.summary)
            for b in ids:
                nxt = br.summary.get(b + 1)
                if nxt is not None and not carries_on_blocks(
                        br.summary[b], nxt, lay.n0):
                    gap, loop = 1.0, FLAG_GAP_HZ
                    seen.append((name, int(b), 1.0, FLAG_GAP_HZ, 0.0, None))
                    if log:
                        log(f"{name}: block {b + 1} does not carry on")
                    break
            bad = check_handoffs(run, br, lay.n0, lay.block,
                                 sig.code_rate_hz)
            if bad is not None:
                gap, loop = 1.0, FLAG_GAP_HZ
                seen.append((name, -1, 1.0, FLAG_GAP_HZ, 0.0, None))
                if log:
                    log(f"{name}: {bad}")
        ref_mod, trk = _tracker(run, name, d, fs, lay)
        g, table = trk.g, trk.table
        picked = sorted(br.sampled)[:n_spans]
        if not picked:
            gap, loop = 1.0, FLAG_GAP_HZ
            if log:
                log(f"{name}: no span in the window")
        for i in picked:
            rec = br.spans[i]
            k, g0 = rec["k"], rec["g0"]
            led = _led(rec["led_in"], sig.code_rate_hz)
            rows = _prn_rows(rec, led[0].shape[0])
            re, im = samples(run.stream, g0, lay.history + k * lay.block)
            ref_led = ctl_led = led
            prev = prev_proc = None
            for b in range(k):
                bid = rec["first"] + b
                if control:
                    ctl, ctl_led, _, _ = span.track_block(
                        ref_mod, g, table, ctl_led, rows, b, re, im, fs,
                        lay.block, code_len,
                        rnd=ref_mod.rounding(g.layout, True))
                    cand = span.on_wire(ctl, br.wire, g.k_epochs)
                else:
                    telem, gs = br.telem[bid]
                    if gs != g0 + (b + 1) * lay.block:
                        raise RuntimeError(f"{name} block {bid}: the span "
                                           f"and the telemetry name other "
                                           f"windows")
                    cand = telem._asdict()
                held = span.held_rates(cand, br.wire, g.k_epochs, prev,
                                       led[5])
                ref, ref_led, prev_proc, lp = span.track_block(
                    ref_mod, g, table, ref_led, rows, b, re, im, fs,
                    lay.block, code_len, held=held, prev_proc=prev_proc)
                gg = span_track_gap(cand, ref, br.wire, g.k_epochs)
                hz, prn = truth_gap(cand, rows, sky,
                                    sig.code_period_ms * 1e-3, after)
                gap, loop, truth = max(gap, gg), max(loop, lp), max(truth, hz)
                if gg >= 1.0:
                    loop = FLAG_GAP_HZ
                seen.append((name, int(bid), gg, lp, hz, prn))
                prev = cand
            if not control:
                out = _led(rec["led_out"], sig.code_rate_hz)
                if not all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(ref_led[:4], out[:4])):
                    gap, loop = 1.0, FLAG_GAP_HZ
                    seen.append((name, int(rec["first"] + k - 1), 1.0,
                                 FLAG_GAP_HZ, 0.0, None))
                    if log:
                        log(f"{name}: the ledger span {i} leaves differs")
                elif prev_proc is not None and prev_proc.any():
                    d_hz = np.abs(ref_led[5][prev_proc][:, [0, 3]].astype(
                        np.float64) - out[5][prev_proc][:, [0, 3]])
                    loop = max(loop, float(d_hz.max()))
    return gap, loop, truth, seen


def check_tracking(run, control=False, log=None
                   ) -> tuple[float, float, float, list]:
    """The tracking numbers of a run (``check_track``): the traffic's
    ``track_spans`` spans where its drive runs spans, else its
    ``track_blocks`` blocks."""
    chk = run.traffic["check"]
    if run.span_blocks > 1:
        return check_spans(run, int(chk["track_spans"]), control=control,
                           log=log)
    return check_track(run, int(chk["track_blocks"]), control=control)


# -- nav ----------------------------------------------------------------

def _decoded(name: str, chain) -> list:
    """The message units a channel's nav chain decoded."""
    if name == "gps_l1ca":
        return list(chain.frames.subframes) if chain.frames else []
    if name == "galileo_e1b":
        return list(chain.dec.words)
    if name == "beidou_b1i":
        return list(chain.frames.subframes)
    if name == "glonass_l1of":
        return list(chain.strings)
    raise KeyError(name)


def _wrong(name: str, units: list, stream, horizon_s: float) -> int:
    """Decoded units of one satellite that it did not broadcast."""
    if name == "gps_l1ca":
        return lnav.wrong_subframes(units, stream)[1]
    if name == "galileo_e1b":
        sent = {stream.word(k).tobytes()
                for k in range(int(horizon_s / 2.0) + 2)}
        return sum(np.asarray(w.data, np.uint8).tobytes() not in sent
                   for w in units)
    if name == "beidou_b1i":
        wrong = 0
        for fra_id, sow, fields, _ in units:
            s, r = divmod(int(sow) - stream.sow0, 6)
            if r or s < 0:
                wrong += 1
                continue
            fra, _, raw = stream.subframe(s)
            wrong += (fra != fra_id
                      or fields != beidou_b1i.fields_of(fra, raw))
        return wrong
    if name == "glonass_l1of":
        sent = []
        for s in range(int(horizon_s / 2.0) + 2):
            m, raw = stream.string(s)
            sent.append((m, glonass_l1of.fields_of(m, raw)))
        return sum(u not in sent for u in units)
    raise KeyError(name)


def check_nav(run, min_s: float) -> tuple[int, int, int]:
    """(nav_wrong, nav_missing, units compared); ``nav_missing`` counts
    no channel of the branches the configuration's ``nav_missing_skip``
    names."""
    truth = {(s.system, s.prn): s.nav for s in run.sky}
    skip = set(run.config.get("nav_missing_skip", ()))
    horizon = run.branches[next(iter(run.branches))].source.pos \
        / float(run.config["stream"]["fs_hz"])
    wrong = missing = checked = 0
    for name, br in run.branches.items():
        period_s = SIGNALS[name].code_period_ms * 1e-3
        for ch, nav in br.nav.channels.items():
            stream = truth.get((name, nav.prn))
            units = _decoded(name, nav.chain)
            checked += len(units)
            if stream is None:
                wrong += len(units)
                continue
            wrong += _wrong(name, units, stream, horizon)
            trace = br.telemetry.traces.get(ch)
            epochs = 0 if trace is None else trace.i_p.size
            if (epochs * period_s >= min_s and nav.subframe_count == 0
                    and name not in skip):
                missing += 1
        if name == "gps_l1ca":
            for prn, eph in br.nav.ephemerides.items():
                stream = truth.get((name, prn))
                checked += 1
                if stream is None or lnav.wrong_ephemeris(eph, stream):
                    wrong += 1
    return wrong, missing, checked


def check(run, log=print, readings=None) -> tuple[bool, dict]:
    """(correct, {number: (value, limit)}) for the numbers the
    configuration's ``limits`` name, each within its limit. Every number
    is logged; ``readings`` (a dict) takes those that have no limit."""
    chk = run.traffic["check"]
    acq, acq_hz, n_s = check_acq(run, int(chk["acq_searches"]), log=log)
    trk, loop, truth, seen = check_tracking(run, log=log)
    wrong, missing, n_units = check_nav(run, float(chk.get("nav_min_s",
                                                           np.inf)))
    log(f"compared: {n_s} searches, {len(seen)} blocks, {n_units} nav "
        f"units")
    worst = max(seen, key=lambda x: x[2], default=None)
    log(f"largest track_gap in block {worst}")
    worst = max(seen, key=lambda x: x[4], default=None)
    log(f"largest carrier_truth_hz at (branch, block, gap, loop gap, Hz, "
        f"PRN) {worst}")
    log("nav chains: " + "; ".join(
        f"{name} " + " ".join(
            f"{nav.prn}:{int(bool(st.get('bit_synced')))}"
            f"{int(bool(st.get('frame_locked')))}/{st.get('subframes')}"
            for nav in br.nav.channels.values()
            for st in [nav.chain.status()])
        for name, br in run.branches.items()))
    values = dict(acq_gap=acq, acq_freq_gap_hz=acq_hz, track_gap=trk,
                  loop_gap_hz=loop, carrier_truth_hz=truth,
                  nav_wrong=float(wrong), nav_missing=float(missing))
    limits = run.config["limits"]
    out = {k: (values[k], limits[k]) for k in NUMBERS if k in limits}
    for k in NUMBERS:
        if k not in limits:
            log(f"{k} {values[k]!r} (no limit: not compared)")
            if readings is not None:
                readings[k] = values[k]
    ok = all(v <= lim for v, lim in out.values())
    return ok, out
