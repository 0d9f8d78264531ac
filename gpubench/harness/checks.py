"""What decides ``correct``: the program's answers in the run held to
the benchmark's plain reference (``gpubench/reference``), which gets the
same int8 samples (rendered again from the seed) and works out again
whatever the program derived from them.

  acq_gap      each branch's first search and a seeded sample of its
               others: the detected PRNs and each one's code phase the
               same as the reference's, and the largest relative gap of
               the peak/average ratios (a differing detection reads 1)
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
  nav_wrong    every message unit the nav layer decoded (LNAV subframe
               and ephemeris, I/NAV word, D1 subframe, GLONASS string)
               that differs from what the satellite broadcast
  nav_missing  channels tracked for the traffic's ``nav_min_s`` of signal
               with nothing decoded (but for the branches that the
               configuration's ``nav_missing_skip`` names)

A configuration compares the numbers its ``limits`` name.

The control (``control=True``) puts the reference at the control's
precision in the program's place for the acquisition and tracking
numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import acquisition as ref_acq
from ..reference import fused, ledger, lnav, scanned
from ..signals import SIGNALS, beidou_b1i, glonass_l1of

NUMBERS = ("acq_gap", "acq_freq_gap_hz", "track_gap", "loop_gap_hz",
           "nav_wrong", "nav_missing")
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
        for s in searches:
            a = s["gs"] + s["w0"] - lay.block
            re8, im8 = run.stream.int8_range(a, a + lay.acq_len)
            inv = 1.0 / run.stream.scale
            x = torch.complex(re8.double() * inv, im8.double() * inv)
            ref = _search_ref(x, name, d, fs, s["allowed"], ref_acq.as_is)
            if control:
                ctl = _search_ref(x, name, d, fs, s["allowed"], ref_acq.bf16)
                prog = {p: (lag, f, r) for p, (det, r, lag, f) in ctl.items()
                        if det}
            else:
                prog = {p: (lag, f, r) for p, lag, f, r in s["cands"]}
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


class _Tracker:
    """A branch's reference tracker: the scanned tracker or the fused
    block tracker, as the configuration's ``reference`` names it."""

    def __init__(self, kind: str, name: str, d: dict, fs: float,
                 lay: Layout):
        sig = SIGNALS[name]
        self.kind, self.lay, self.fs = kind, lay, fs
        n_prn = d["acq"]["n_prn"]
        if kind == "scanned":
            if sig.boc:
                raise ValueError("the scanned reference is BPSK only")
            self.p = scanned.params(d["track"], fs, sig.code_length,
                                    sig.code_rate_hz, sig.code_period_ms)
            self.table = torch.from_numpy(np.stack(
                [sig.table(p) for p in range(1, n_prn + 1)]).astype(
                    np.float32))
        elif kind == "fused":
            self.g = fused.Geometry.create(
                d, fs, sig.code_length, sig.code_rate_hz, sig.carrier_hz,
                sig.code_period_ms, sig.boc, lay.history + lay.block)
            self.table = fused.sampled_table(
                lambda p: sig.sample_code(p, fs), n_prn, lay.n0,
                lay.n0 + d["track"]["window_margin"])
        else:
            raise ValueError(f"no reference tracker {kind!r}")

    def run(self, st: dict, re, im, control: bool, follow=None) -> dict:
        lay = self.lay
        if self.kind == "scanned":
            codes = self.table[np.maximum(np.asarray(st["prn_idx"]), 0)]
            return scanned.track_block(
                self.p, codes, st, re, im, lay.epochs + 1,
                lay.history + lay.block,
                dtype=torch.bfloat16 if control else torch.float32)
        rnd = None
        if control:
            rnd = fused.f8 if self.g.layout == "mxu" else fused.bf16
        return fused.track_block(self.g, self.table, st, re, im, self.fs,
                                 rnd=rnd, follow=follow)


def check_track(run, n_blocks: int, control=False) -> tuple[float, float,
                                                            list]:
    """(track_gap, loop_gap_hz, [(branch, block, gap, loop gap)]) over
    ``n_blocks`` of the window's blocks per branch, drawn from the seed,
    every epoch of each. The reference starts each block from the ledger
    the program's step started from, with the block's handoffs made
    again from the acquisition's verdicts; where the configuration's
    reference says ``follow``, each superstep after a block's first
    starts from the loops as the program's telemetry left them."""
    follow = bool(run.config["reference"].get("follow"))
    fs = float(run.config["stream"]["fs_hz"])
    ids = list(run.window_block_ids())
    rng = np.random.default_rng([run.seed, 4])
    pick = sorted(rng.choice(ids, min(n_blocks, len(ids)), replace=False))
    gap, loop, seen = 0.0, 0.0, []
    for name, br in run.branches.items():
        d = run.config["branches"][name]
        sig = SIGNALS[name]
        lay = Layout(d, fs, sig.code_period_ms)
        if not control:
            # every block of the run hands its ledger on to the next
            for b, (telem, gs) in br.telem.items():
                nxt = br.track_in.get(b + 1)
                if nxt is not None and not carries_on(telem, gs, nxt[0],
                                                      nxt[1], lay.n0):
                    gap, loop = 1.0, FLAG_GAP_HZ
                    seen.append((name, int(b), 1.0, FLAG_GAP_HZ))
                    break
        trk = _Tracker(run.config["reference"]["tracker"], name, d, fs, lay)
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
            gap, loop = max(gap, g), max(loop, lp)
            seen.append((name, int(b), g, lp))
    return gap, loop, seen


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


def check(run, log=print) -> tuple[bool, dict]:
    """(correct, {number: (value, limit)}) for the numbers the
    configuration's ``limits`` name, each within its limit."""
    chk = run.traffic["check"]
    acq, acq_hz, n_s = check_acq(run, int(chk["acq_searches"]), log=log)
    trk, loop, seen = check_track(run, int(chk["track_blocks"]))
    wrong, missing, n_units = check_nav(run, float(chk.get("nav_min_s",
                                                           np.inf)))
    log(f"compared: {n_s} searches, {len(seen)} blocks, {n_units} nav "
        f"units")
    worst = max(seen, key=lambda x: x[2], default=None)
    log(f"largest track_gap in block {worst}")
    log("nav chains: " + "; ".join(
        f"{name} " + " ".join(
            f"{nav.prn}:{int(bool(st.get('bit_synced')))}"
            f"{int(bool(st.get('frame_locked')))}/{st.get('subframes')}"
            for nav in br.nav.channels.values()
            for st in [nav.chain.status()])
        for name, br in run.branches.items()))
    values = dict(acq_gap=acq, acq_freq_gap_hz=acq_hz, track_gap=trk,
                  loop_gap_hz=loop,
                  nav_wrong=float(wrong), nav_missing=float(missing))
    limits = run.config["limits"]
    out = {k: (values[k], limits[k]) for k in NUMBERS if k in limits}
    ok = all(v <= lim for v, lim in out.values())
    return ok, out
