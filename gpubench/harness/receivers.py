"""A configuration file's receiver, built through the port's own entry
points: ``Receiver`` for one branch, ``MultiConstellationReceiver`` with
one source per branch for several (each branch reads the same stream at
its own position)."""
from __future__ import annotations

import dataclasses


def receiver_config(d: dict):
    """``ReceiverConfig`` from its dict (every section given)."""
    from gnss_sdr_tpu_torch.config import ReceiverConfig

    base = ReceiverConfig()
    kw = {}
    for f in dataclasses.fields(ReceiverConfig):
        v = d[f.name]
        if isinstance(v, dict):
            cls = type(getattr(base, f.name))
            v = cls(**{k: tuple(x) if isinstance(x, list) else x
                       for k, x in v.items()})
        kw[f.name] = v
    return ReceiverConfig(**kw)


def build(cfg: dict, sources: dict, device):
    """(entry, {branch: Receiver}): ``entry.run(max_blocks=...)`` is the
    timed call."""
    from gnss_sdr_tpu_torch.receiver import MultiConstellationReceiver, \
        Receiver

    configs = {name: receiver_config(d) for name, d in cfg["branches"].items()}
    if cfg["kind"] == "receiver":
        (name, c), = configs.items()
        rx = Receiver(c, sources[name], device=device)
        return rx, {name: rx}
    if cfg["kind"] == "multi":
        mrx = MultiConstellationReceiver(configs, sources=sources,
                                         device=device)
        return mrx, dict(mrx.receivers)
    raise ValueError(f"unknown receiver kind {cfg['kind']!r}")
