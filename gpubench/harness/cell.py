"""One run of one cell: set-up (the port loaded, the receiver built,
warmed up on the cell's own stream), the measured window, and what the
metrics and the correctness check read afterwards.

The timed call is the configuration's entry, ``run(max_blocks=...)``
of ``Receiver`` or ``MultiConstellationReceiver``. The benchmark wraps
each branch's public ``step`` on the instance to time it and to close
the window (its sources then report the end of the stream). For the
check it records, from the receiver's public state, the ledger each
block starts from (``state``, read before the step) and the handoffs the
block made (``acq_events``); and through the receiver's public members,
the telemetry each block hands to the nav layer
(``telemetry.append_block``) and each acquisition search's arguments and
answers (``engine.search``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from . import receivers, spec
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


def _hook_check(br: Branch) -> None:
    """Record, per block, the telemetry the nav layer gets, and every
    search's arguments and answers (wrappers on the receiver's public
    members)."""
    rx = br.rx
    append = rx.telemetry.append_block

    def append_hook(telem, gs):
        br.telem[rx.window.blocks_fed] = (telem, gs)
        return append(telem, gs)
    rx.telemetry.append_block = append_hook

    search = rx.engine.search

    def search_hook(samples, window_offset=0, allowed_prns=None):
        cands = search(samples, window_offset=window_offset,
                       allowed_prns=allowed_prns)
        br.searches.append(dict(
            block=rx.window.blocks_fed, gs=rx.window.global_start,
            w0=window_offset, allowed=sorted(allowed_prns or ()),
            cands=[(c.prn, c.code_phase_samples, c.carrier_freq_hz,
                    c.ratio) for c in cands]))
        return cands
    rx.engine.search = search_hook


def _hook_stage_ranges(br: Branch, tracer: Tracer) -> None:
    """Name the receiver's stages in the trace while it records."""
    stage = br.rx.timers.stage

    @contextlib.contextmanager
    def named(name, items=0.0):
        if not tracer.active:
            with stage(name, items):
                yield
            return
        with torch.profiler.record_function(f"stage.{br.name}.{name}"), \
                stage(name, items):
            yield
    br.rx.timers.stage = named


def _light(x, limit=1 << 16):
    """``x`` itself, or where it is a large tensor, a stand-in of its
    shape and type that holds no memory."""
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
                outs = (tuple(_light(o) for o in out)
                        if isinstance(out, (tuple, list)) else _light(out))
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
             tmp_dir: str = ".", log=print) -> Run:
    """Set up, warm up and measure one cell; returns the Run (the window
    closed, the receivers still held)."""
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
    if not trace and device.type == "cuda" and any(
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
    try:
        entry, rxs = receivers.build(cfg, sources, device)
        branches = {n: Branch(n, rx, sources[n]) for n, rx in rxs.items()}
        for br in branches.values():
            _hook_check(br)
            if trace:
                _hook_stage_ranges(br, tracer)
        block_ms = {rx.cfg.block_ms for rx in rxs.values()}
        if len(block_ms) != 1:
            raise ValueError("branches with different block lengths")
        run = Run(cell=cell_name, config=cfg, traffic=traffic, seed=seed,
                  trace=trace, device=device, sky=sky, stream=stream,
                  branches=branches, block_s=block_ms.pop() / 1000.0,
                  warmup_blocks=int(traffic["warmup_blocks"]))
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
    lap = max(1, round(1.0 / run.block_s))     # card clock: a signal second

    def wrap(br):
        step = br.rx.step

        def timed_step():
            if br is first:
                if (state["deadline"] is not None
                        and time.perf_counter() >= state["deadline"]):
                    for b in branches:
                        b.source.stop = True
                elif (clock is not None and state["in_window"]
                      and state["rounds"] and state["rounds"] % lap == 0):
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
            f"operations in {clock.laps} laps")
    run.window_blocks = state["rounds"]
    for br in branches:
        br.stages1 = _stage_totals(br.rx)
        del br.rx.step
        del br.rx.telemetry.append_block
        br.nav, br.telemetry = br.rx.nav, br.rx.telemetry
    log(f"process CPU s in the window {run.cpu_s!r}")
    log(f"window {run.window_s:.4f} s, {run.window_blocks} blocks "
        f"of {run.block_s * 1e3:g} ms, {stream.generated} chunks rendered")

