"""The plain reference: plain PyTorch and NumPy that imports nothing of
the port.

A configuration names its tracking reference by file: its
``reference.tracker`` is ``<name>``, the module ``reference/<name>.py``
(``scanned`` and ``fused`` here), which the check imports by that name.
Such a module provides ``Tracker(sig, d, fs, lay)`` (the branch's
signal from ``signals``, its configuration, the stream's rate and its
sample layout) whose ``run(state, re, im, control, follow)`` tracks
one block from the exact ledger ``state`` over the host window
``re``/``im`` and returns its telemetry {field: [T, C]} as the receiver
reports it: at the configuration's precision, or with ``control`` the
control's; with ``follow`` (the program's telemetry of the block) each
superstep after the first from the loops as the program left them.
For a configuration driven in spans (``span.py``) the module also
provides what the scan runs on: its ``Tracker``'s ``g`` (the geometry)
and ``table`` (the sampled codes), ``build_replicas``, ``superstep``,
``rounding(layout, control)``, ``fma`` and ``N_FIELDS``. A tracker
whose arithmetic differs from every module here is a new module, named
by its configuration; a repair of a tracker in the port is made in
place in that tracker's module.
"""
