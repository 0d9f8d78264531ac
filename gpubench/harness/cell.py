"""One run of one cell: set-up (the port loaded, the receiver built,
warmed up on the cell's own stream), the measured window, and what the
metrics and the correctness check read afterwards.

The timed call is the configuration's entry, ``run(max_blocks=...)``
of ``Receiver`` or ``MultiConstellationReceiver``, with the traffic's
``drive`` (``scan_blocks``, ``span_pipeline``) where it has one. The
window's duties (its deadline, the card clock's laps, the traced
stretch, the stream rendered ahead) run once per unit: a block or a
span of blocks. Single blocks: the benchmark wraps each branch's public
``step`` on the instance to time it and to close the window (its
sources then report the end of the stream). Spans: the entry's
``on_block`` hook, which the receiver fires after every block or span,
times the unit and stops the run at the deadline. For the check it
records, from the receiver's public state, the ledger each block starts
from (``state``, read before the step) and the handoffs the block made
(``acq_events``); in spans, the ledger each span starts from and the
one it leaves (the arguments and handle of the fused tracker's
``submit_span``); and through the receiver's public members, the
telemetry each block hands to the nav layer
(``telemetry.append_block``, keyed by the block it belongs to, inside a
span too) and each acquisition search's arguments and answers
(``engine.search``, and the in-scan search's answers that
``engine.candidates_from_conv`` reads).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import checks, receivers, spec
from .stream import ChunkStream, StreamSource, build_sky
from .trace import CardClock, Tracer


@dataclasses.dataclass
class Branch:
    name: str
    rx: object
    source: StreamSource
    track_in: dict = dataclasses.field(default_factory=dict)
    telem: dict = dataclasses.field(default_factory=dict)
    searches: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    keep: set = dataclasses.field(default_factory=set)  # blocks kept whole
    summary: dict = dataclasses.field(default_factory=dict)
    wire: str = "f32"
    run_id: int = 0               # the entry's run a span belongs to
    acq_events: list = dataclasses.field(default_factory=list)
    sampled: list = dataclasses.field(default_factory=list)
    appended: int = 0
    step_s: list = dataclasses.field(default_factory=list)
    stages0: dict = dataclasses.field(default_factory=dict)
    stages1: dict = dataclasses.field(default_factory=dict)
    nav: object = None            # the receiver's outputs, kept once
    telemetry: object = None      # the window has closed

    def stage_s(self, name: str) -> float:
        """Seconds the receiver spent in stage ``name`` in the window."""
        return self.stages1.get(name, 0.0) - self.stages0.get(name, 0.0)


@dataclasses.dataclass
class Run:
    """What one run leaves for the metric readers and the check."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    trace: bool
    device: torch.device
    sky: list
    stream: ChunkStream
    branches: dict
    block_s: float = 0.0
    warmup_blocks: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    window_blocks: int = 0
    trace_summary: dict | None = None
    rooflines: dict = dataclasses.field(default_factory=dict)
    card_busy_s: float | None = None    # over the window (card clock)
    cpu_s: float = 0.0                  # the process's CPU seconds in it
    drive: dict = dataclasses.field(default_factory=dict)

    @property
    def span_blocks(self) -> int:
        """Blocks a span of the traffic's drive (1: single blocks)."""
        return int(self.drive.get("scan_blocks", 1))

    @property
    def signal_s(self) -> float:
        """Signal seconds of the blocks completed in the window (one
        stream feeds every branch)."""
        return self.window_blocks * self.block_s

    def window_block_ids(self) -> range:
        """The window's blocks as each branch counts them (1-based)."""
        w = self.warmup_blocks
        return range(w + 1, w + self.window_blocks + 1)


def _stage_totals(rx) -> dict:
    return {k: v.total_s for k, v in rx.timers.stats.items()}


def _hook_check(br: Branch, spans: bool, pick=None) -> None:
    """Record, per block, the telemetry the nav layer gets, and every
    search's arguments and answers (wrappers on the receiver's public
    members). A span hands on its blocks' telemetry after the window
    has rolled past the whole span (in the pipeline, past the next one
    too): each is keyed by the block it belongs to, from its window's
    global start. In spans every block leaves a summary and the blocks
    of the spans ``pick`` keeps leave their telemetry whole."""
    rx = br.rx
    append = rx.telemetry.append_block
    block = rx.block

    def append_hook(telem, gs):
        w = rx.window
        b = w.blocks_fed - (w.global_start - gs) // block
        br.appended += 1
        if spans:
            br.summary[b] = checks.block_summary(telem, gs)
            if b in br.keep:
                br.telem[b] = (telem, gs)
        else:
            br.telem[b] = (telem, gs)
        return append(telem, gs)
    rx.telemetry.append_block = append_hook

    search = rx.engine.search
    in_search = [False]

    def search_hook(samples, window_offset=0, allowed_prns=None):
        in_search[0] = True
        try:
            cands = search(samples, window_offset=window_offset,
                           allowed_prns=allowed_prns)
        finally:
            in_search[0] = False
        br.searches.append(dict(
            kind="search", unit=len(br.spans) - 1,
            block=rx.window.blocks_fed, gs=rx.window.global_start,
            w0=window_offset, allowed=sorted(allowed_prns or ()),
            cands=[(c.prn, c.code_phase_samples, c.carrier_freq_hz,
                    c.ratio) for c in cands],
            handed=[(c.prn, c.carrier_freq_hz, c.sample_local_index)
                    for c in cands]))
        return cands
    rx.engine.search = search_hook
    if not spans:
        return

    from_conv = rx.engine.candidates_from_conv

    def conv_hook(res, window_offset, allowed_prns, rowmap=None):
        cands = from_conv(res, window_offset, allowed_prns, rowmap=rowmap)
        if not in_search[0]:
            # the in-scan search of the span just run, read once due
            r = [np.asarray(x.cpu().numpy() if torch.is_tensor(x) else x)
                 for x in res]
            br.searches.append(dict(
                kind="span", unit=len(br.spans) - 1,
                block=rx.window.blocks_fed, gs=rx.window.global_start,
                w0=window_offset, allowed=sorted(allowed_prns or ()),
                rowmap=list(rowmap), detected=r[0], ratio=r[1], lag=r[3],
                freq=r[4],
                handed=[(c.prn, c.carrier_freq_hz, c.sample_local_index)
                        for c in cands]))
        return cands
    rx.engine.candidates_from_conv = conv_hook

    ft = rx.fused
    submit = ft.submit_span

    def submit_hook(led_or_state, stream_re, stream_im, codes_rows,
                    n_blocks, with_ledger=False, extra_args=()):
        handle = submit(led_or_state, stream_re, stream_im, codes_rows,
                        n_blocks, with_ledger=with_ledger,
                        extra_args=extra_args)
        w = rx.window
        first = w.blocks_fed - n_blocks + 1
        rec = dict(first=first, k=int(n_blocks),
                   g0=w.global_start - n_blocks * block,
                   led_in=led_or_state, led_out=handle.led,
                   events=len(rx.acq_events), run=br.run_id,
                   channels=dict(rx.active))
        br.spans.append(rec)
        if pick is not None and pick(len(br.spans) - 1):
            br.keep.update(range(first, first + n_blocks))
        return handle
    ft.submit_span = submit_hook


class _SpanSample:
    """A uniform sample, drawn from the seed, of the spans the window
    runs (reservoir sampling): the spans whose blocks keep their
    telemetry whole for the check."""

    def __init__(self, br: Branch, size: int, seed: int):
        self.br, self.size = br, int(size)
        self.rng = np.random.default_rng([seed, 4])
        self.seen = 0
        self.active = False

    def __call__(self, i: int) -> bool:
        if not self.active:
            return False
        self.seen += 1
        slots = self.br.sampled
        if len(slots) < self.size:
            slots.append(i)
            return True
        j = int(self.rng.integers(0, self.seen))
        if j >= self.size:
            return False
        old = self.br.spans[slots[j]]
        for b in range(old["first"], old["first"] + old["k"]):
            self.br.keep.discard(b)
            self.br.telem.pop(b, None)
        slots[j] = i
        return True


def _light(x, limit=1 << 16):
    """``x`` itself, or where it is a tensor of more than ``limit``
    elements, a stand-in of its shape and type that holds no memory."""
    if torch.is_tensor(x) and x.numel() > limit:
        return torch.empty_like(x, device="meta")
    return x


class _Roofline:
    """A kernel's bytes and operations per launch, from the wrapped
    entry its roofline file names. The launches in the traced stretch
    are kept (large tensors as stand-ins) and counted once it has
    closed, so the counting puts nothing on the card inside it."""

    def __init__(self, name, mod, tracer):
        self.name, self.mod, self.tracer = name, mod, tracer
        self.calls = []
        module = __import__(mod.TARGET[0], fromlist=["_"])
        self.module, self.attr = module, mod.TARGET[1]
        self.orig = getattr(module, self.attr)

        def wrapped(*args, **kw):
            out = self.orig(*args, **kw)
            if self.tracer.active:
                # outputs up to 4 M elements whole (B1's telemetry of a
                # 500 ms block at 32 channels), the stream's stand-ins
                outs = (tuple(_light(o, 1 << 22) for o in out)
                        if isinstance(out, (tuple, list))
                        else _light(out, 1 << 22))
                self.calls.append((tuple(_light(a) for a in args), kw,
                                   outs))
            return out
        setattr(module, self.attr, wrapped)

    def restore(self):
        setattr(self.module, self.attr, self.orig)

    def totals(self) -> dict:
        tot = {"bytes": 0.0, "f32_ops": 0.0, "bf16_ops": 0.0}
        for args, kw, out in self.calls:
            c = self.mod.cost(args, kw, out)
            for k in tot:
                v = c.get(k, 0.0)
                tot[k] += float(v.item() if torch.is_tensor(v) else v)
        tot["launches"] = len(self.calls)
        return tot


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_process: float | None = None,
             tmp_dir: str = ".", log=print, card_clock: bool = True) -> Run:
    """Set up, warm up and measure one cell; returns the Run (the window
    closed, the receivers still held). ``card_clock`` False opens no
    card clock, whatever the cell's metrics read."""
    t0 = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    cell = spec.cell(bench, cell_name)
    cfg = spec.load_config(bench, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    per_layer = spec.metrics_for(bench, cell_name, "per_layer")

    sc = cfg["stream"]
    fs = float(sc["fs_hz"])
    sky = build_sky(traffic, seed)
    stream = ChunkStream(sky, fs, int(round(sc["chunk_s"] * fs)), seed,
                         sc["int8_scale"], device,
                         noise_power=traffic.get("noise_power", 1.0))
    stream.prefetch(0)
    sources = {name: StreamSource(stream) for name in cfg["branches"]}

    tracer = Tracer(device, tmp_dir)
    # an end-to-end metric that reads the card's busy time over the
    # whole window (CARD_CLOCK in its file) has it measured in an
    # untraced run
    clock = None
    if card_clock and not trace and device.type == "cuda" and any(
            getattr(spec.load_module(spec.metric_path(m["name"])),
                    "CARD_CLOCK", False)
            for m in spec.metrics_for(bench, cell_name, "end_to_end")):
        clock = CardClock(device, stream.side)
    roofs = {}
    if trace:
        for m in per_layer:
            mod = spec.load_module(spec.metric_path(m["name"]))
            kernel = getattr(mod, "ROOFLINE", None)
            if kernel and kernel not in roofs:
                roofs[kernel] = _Roofline(kernel, spec.roofline(kernel),
                                          tracer)
    drive = dict(traffic.get("drive", {}))
    spans = int(drive.get("scan_blocks", 1)) > 1
    if spans and cfg["kind"] != "receiver":
        raise ValueError("a traffic's drive in spans takes one receiver")
    try:
        entry, rxs = receivers.build(cfg, sources, device)
        branches = {n: Branch(n, rx, sources[n]) for n, rx in rxs.items()}
        samplers = {}
        for br in branches.values():
            pick = None
            if spans:
                if br.rx.fused is None:
                    raise ValueError("spans run on the fused tracker")
                br.wire = br.rx.fused.wire
                pick = samplers[br.name] = _SpanSample(
                    br, traffic["check"]["track_spans"], seed)
            _hook_check(br, spans, pick)
        block_ms = {rx.cfg.block_ms for rx in rxs.values()}
        if len(block_ms) != 1:
            raise ValueError("branches with different block lengths")
        run = Run(cell=cell_name, config=cfg, traffic=traffic, seed=seed,
                  trace=trace, device=device, sky=sky, stream=stream,
                  branches=branches, block_s=block_ms.pop() / 1000.0,
                  warmup_blocks=int(traffic["warmup_blocks"]), drive=drive)
        if spans:
            _measure_units(run, entry, seconds, tracer, clock, t0, log,
                           samplers)
        else:
            _measure(run, entry, seconds, tracer, clock, t0, log)
    finally:
        for r in roofs.values():
            r.restore()
    run.rooflines = {k: r.totals() for k, r in roofs.items()}
    run.trace_summary = tracer.summary
    return run


def _measure(run: Run, entry, seconds, tracer, clock, t0, log) -> None:
    branches = list(run.branches.values())
    first, last = branches[0], branches[-1]
    stream, chunk_len = run.stream, run.stream.chunk_len
    tr = run.traffic.get("trace", {})
    trace_at = int(tr.get("start_block", 1))
    trace_n = int(tr.get("blocks", 1))
    state = dict(deadline=None, in_window=False, rounds=0, t_end=None)

    def wrap(br):
        step = br.rx.step

        def timed_step():
            if br is first:
                if (state["deadline"] is not None
                        and time.perf_counter() >= state["deadline"]):
                    for b in branches:
                        b.source.stop = True
                elif (clock is not None and state["in_window"]
                      and clock.due()):
                    clock.lap()
                elif state["in_window"] and run.trace:
                    if state["rounds"] == trace_at:
                        tracer.start()
                    elif state["rounds"] == trace_at + trace_n \
                            and tracer.active:
                        tracer.stop()
                # render ahead: the chunk after the one being read
                k = max(b.source.pos for b in branches) // chunk_len
                stream.prefetch(k + 1)
                stream.release(min(b.source.pos for b in branches)
                               // chunk_len)
            ledger, n_events = br.rx.state, len(br.rx.acq_events)
            ts = time.perf_counter()
            if tracer.active:
                with torch.profiler.record_function(
                        f"gpubench.step.{br.name}"):
                    ok = step()
            else:
                ok = step()
            te = time.perf_counter()
            if ok:
                # the ledger the block started from and its handoffs
                br.track_in[br.rx.window.blocks_fed] = (
                    ledger, br.rx.window.global_start,
                    [(c.prn, c.carrier_freq_hz, c.sample_local_index)
                     for _, c in br.rx.acq_events[n_events:]])
            if ok and state["in_window"]:
                br.step_s.append(te - ts)
                if br is first:
                    state["rounds"] += 1
                if br is last:
                    state["t_end"] = te
            return ok
        br.rx.step = timed_step

    for br in branches:
        wrap(br)
    # set-up: the cold search, first blocks, graph capture where the
    # tracker has one
    entry.run(max_blocks=run.warmup_blocks)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    for br in branches:
        br.stages0 = _stage_totals(br.rx)
    run.setup_s = time.perf_counter() - t0
    log(f"setup_s {run.setup_s:.4f} (warm-up blocks {run.warmup_blocks})")
    if clock is not None:
        clock.start()
    cpu0 = time.process_time()
    tw = time.perf_counter()
    state.update(deadline=tw + seconds, in_window=True, t_end=tw)
    entry.run()
    if tracer.active:
        tracer.stop()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.cpu_s = time.process_time() - cpu0
    state["in_window"] = False
    run.window_s = state["t_end"] - tw
    if clock is not None:
        clock.stop()
        run.card_busy_s = clock.busy_s
        log(f"card clock: {clock.busy_s!r} s busy over {clock.ops} device "
            f"operations in {clock.laps} laps, each record whole")
    run.window_blocks = state["rounds"]
    for br in branches:
        br.stages1 = _stage_totals(br.rx)
        del br.rx.step
        del br.rx.telemetry.append_block
        br.nav, br.telemetry = br.rx.nav, br.rx.telemetry
    log(f"process CPU s in the window {run.cpu_s!r}")
    log(f"window {run.window_s:.4f} s, {run.window_blocks} blocks "
        f"of {run.block_s * 1e3:g} ms, {stream.generated} chunks rendered")


def _measure_units(run: Run, entry, seconds, tracer, clock, t0, log,
                   samplers) -> None:
    """The window in units of a block or a span, as the traffic's drive
    runs the receiver: the entry's ``on_block`` hook fires after each
    unit; it counts the unit's blocks, times it, stops the run at the
    deadline, laps the card clock (on a unit boundary once a lap is
    due), opens and closes the traced stretch on unit
    boundaries (sized in blocks) and renders the stream a span ahead."""
    (br,) = run.branches.values()
    rx, stream = br.rx, run.stream
    chunk_len = stream.chunk_len
    tr = run.traffic.get("trace", {})
    trace_at = int(tr.get("start_block", 1))
    trace_n = int(tr.get("blocks", 1))
    ahead = run.span_blocks * rx.block * rx.decim    # samples a unit reads
    st = dict(deadline=None, in_window=False, blocks=0, seen=0,
              t_prev=None, t_end=None, trace_from=None)

    def render_ahead():
        pos = br.source.pos
        for k in range(pos // chunk_len + 1, (pos + ahead) // chunk_len + 2):
            stream.prefetch(k)
        stream.release(pos // chunk_len)

    def on_unit(_rx):
        te = time.perf_counter()
        n, st["seen"] = br.appended - st["seen"], br.appended
        if not st["in_window"]:
            render_ahead()
            return False
        st["blocks"] += n
        br.step_s.append(te - st["t_prev"])
        st["t_prev"] = st["t_end"] = te
        if te >= st["deadline"]:
            return True
        if clock is not None and clock.due():
            clock.lap()
        if run.trace:
            if st["trace_from"] is None and st["blocks"] >= trace_at:
                tracer.start()
                st["trace_from"] = st["blocks"]
            elif tracer.active and st["blocks"] - st["trace_from"] \
                    >= trace_n:
                tracer.stop()
        render_ahead()
        return False

    # set-up: the cold search, the first blocks and spans
    entry.run(max_blocks=run.warmup_blocks, on_block=on_unit, **run.drive)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    br.stages0 = _stage_totals(rx)
    run.setup_s = time.perf_counter() - t0
    log(f"setup_s {run.setup_s:.4f} (warm-up blocks {run.warmup_blocks})")
    for s in samplers.values():
        s.active = True
    br.run_id = 1
    if clock is not None:
        clock.start()
    cpu0 = time.process_time()
    tw = time.perf_counter()
    st.update(deadline=tw + seconds, in_window=True, t_prev=tw, t_end=tw)
    entry.run(on_block=on_unit, **run.drive)
    if tracer.active:
        tracer.stop()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.cpu_s = time.process_time() - cpu0
    st["in_window"] = False
    run.window_s = st["t_end"] - tw
    if clock is not None:
        clock.stop()
        run.card_busy_s = clock.busy_s
        log(f"card clock: {clock.busy_s!r} s busy over {clock.ops} device "
            f"operations in {clock.laps} laps, each record whole")
    run.window_blocks = st["blocks"]
    br.stages1 = _stage_totals(rx)
    del rx.telemetry.append_block
    del rx.fused.submit_span
    del rx.engine.candidates_from_conv
    br.nav, br.telemetry = rx.nav, rx.telemetry
    br.acq_events = rx.acq_events
    log(f"process CPU s in the window {run.cpu_s!r}")
    log(f"window {run.window_s:.4f} s, {run.window_blocks} blocks "
        f"of {run.block_s * 1e3:g} ms in {len(br.step_s)} units, "
        f"{stream.generated} chunks rendered")
