"""The tracking ledger's handoff: an acquisition's verdict written into
the first idle channel, the fields a new channel starts from (plain
NumPy; the receiver's handoff, done again from its recorded verdicts)."""
from __future__ import annotations

import numpy as np

DTYPES = {
    "active": np.bool_, "prn_idx": np.int32, "offset": np.int32,
    "epochs": np.int32, "lost_count": np.int32, "carr_freq": np.float32,
    "carr_acc": np.uint32, "carr_err": np.float32,
    "code_rate": np.float32, "chip_int": np.int32,
    "chip_frac_u32": np.uint32, "code_err": np.float32,
    "lock_ema": np.float32,
}


def handoff(state: dict, events, code_rate_hz: float) -> dict:
    """``state`` {field: [C]} with each of ``events`` (PRN, carrier Hz,
    code-boundary sample of the window), in order, started in the first
    idle channel: a new ledger."""
    st = {f: np.array(state[f], dtype=dt, copy=True)
          for f, dt in DTYPES.items()}
    for prn, carrier_hz, sample in events:
        idle = np.nonzero(~st["active"])[0]
        if idle.size == 0:
            break
        c = int(idle[0])
        new = dict(active=True, prn_idx=prn - 1, offset=sample, epochs=0,
                   lost_count=0, carr_freq=carrier_hz, carr_acc=0,
                   carr_err=0.0, code_rate=code_rate_hz, chip_int=0,
                   chip_frac_u32=0, code_err=0.0, lock_ema=1.0)
        for f, v in new.items():
            st[f][c] = v
    return st
