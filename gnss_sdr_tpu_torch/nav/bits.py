"""GPS LNAV bit/frame synchronization and word decoding (host-side).

Capability parity with the reference's legacy decoder
(reference: src/decoding.rs:102-353 — bit sync via sign-flip histogram,
20 ms integrate-and-dump, preamble correlation with polarity, subframe
assembly, word parity, TOW extraction). Bit-level logic is branchy and
tiny, so per SURVEY.md section 7 it runs on host NumPy over the prompt
I/Q telemetry the device pipeline emits — never on the accelerator.

The algorithms here are the full IS-GPS-200 versions (the reference's
legacy file contains non-compiling placeholder logic, SURVEY.md section
1 L6): Hamming(32,26) word parity with D29*/D30* chaining, data-bit
de-complementing, HOW/TLM decoding, and 300-bit subframe assembly. An
encoder is included as the test oracle (encode -> decode roundtrip).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import constants as C

PREAMBLE = np.array(C.GPS_CA_PREAMBLE_BITS, dtype=np.int8)  # +/-1, 10001011
BIT_MS = C.GPS_CA_BIT_PERIOD_MS
WORD_BITS = C.GPS_WORD_BITS
SUBFRAME_BITS = C.GPS_SUBFRAME_BITS

# IS-GPS-200 table 20-XIV: data-bit indices (1..24) feeding each parity
# bit D25..D30, plus which of (D29*, D30*) seeds it.
_PARITY_TAPS = (
    ("D29", (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23)),
    ("D30", (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24)),
    ("D29", (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22)),
    ("D30", (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23)),
    ("D30", (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24)),
    ("D29", (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24)),
)


def compute_parity(data24: np.ndarray, d29_star: int, d30_star: int) -> np.ndarray:
    """Six parity bits for one word.

    ``data24``: the word's source data bits (0/1, already complemented by
    D30* on the transmit side — i.e. as they appear on the air).
    """
    out = np.empty(6, dtype=np.uint8)
    seeds = {"D29": d29_star, "D30": d30_star}
    for k, (seed, taps) in enumerate(_PARITY_TAPS):
        v = seeds[seed]
        for t in taps:
            v ^= int(data24[t - 1])
        out[k] = v
    return out


def check_word_parity(word30: np.ndarray, d29_star: int, d30_star: int) -> bool:
    """Validate a received 30-bit word against its trailing parity."""
    expected = compute_parity(word30[:24], d29_star, d30_star)
    return bool(np.array_equal(expected, word30[24:30]))


def decode_word_data(word30: np.ndarray, d30_star: int) -> np.ndarray:
    """Recover the 24 source data bits: received data bits are
    complemented by the previous word's D30 (IS-GPS-200 20.3.5.2)."""
    return (word30[:24] ^ d30_star).astype(np.uint8)


def bits_to_uint(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def bits_to_int(bits: np.ndarray) -> int:
    """Two's-complement signed integer."""
    v = bits_to_uint(bits)
    if bits[0]:
        v -= 1 << len(bits)
    return v


@dataclasses.dataclass
class Subframe:
    """One parity-verified subframe: 10 words x 24 data bits."""

    subframe_id: int
    tow_counts: int          # HOW truncated TOW (units of 6 s, next SF start)
    data: np.ndarray         # [10, 24] uint8 source data bits
    first_bit_index: int     # bit-stream index of the subframe's first bit

    @property
    def tow_s(self) -> float:
        return self.tow_counts * 6.0


class BitSynchronizer:
    """Epoch-domain bit sync + integrate-and-dump.

    Reference semantics (decoding.rs:164-211): histogram prompt-I sign
    flips by epoch-index mod 20; when one phase accumulates
    ``threshold`` flips, declare that phase the bit boundary; then sum
    20 prompt-I values per bit and emit sign bits.
    """

    def __init__(self, threshold: int = 30):
        self.threshold = threshold
        self.hist = np.zeros(BIT_MS, dtype=np.int64)
        self.synced = False
        self.boundary_phase: Optional[int] = None
        self._prev_ip = 0.0
        self._acc = 0.0
        self._acc_count = 0
        self.bits: list[int] = []        # +/-1 soft-sign bits
        self.bit_epochs: list[int] = []  # epoch index of each bit start

    def feed(self, i_prompt: float, epoch_index: int) -> Optional[int]:
        """Feed one 1 ms prompt; returns a +/-1 bit when one completes."""
        phase = epoch_index % BIT_MS
        if not self.synced:
            if self._prev_ip * i_prompt < 0.0:
                self.hist[phase] += 1
                if self.hist[phase] >= self.threshold:
                    self.synced = True
                    self.boundary_phase = phase
                    self._acc = 0.0
                    self._acc_count = 0
            self._prev_ip = i_prompt
            return None
        self._prev_ip = i_prompt

        if phase == self.boundary_phase:
            self._acc = i_prompt
            self._acc_count = 1
            self._bit_start = epoch_index
            return None
        self._acc += i_prompt
        self._acc_count += 1
        if self._acc_count == BIT_MS:
            bit = 1 if self._acc > 0 else -1
            self.bits.append(bit)
            self.bit_epochs.append(getattr(self, "_bit_start", epoch_index))
            return bit
        return None



    def feed_array(self, i_prompts, epoch_indices):
        """Vectorized feed of a block of consecutive prompts.

        Semantically identical to calling feed() per epoch (the test
        suite asserts bit-for-bit equality, including a sync transition
        mid-block) but runs in a handful of numpy passes — the per-epoch
        python loop was the receiver's host-side bottleneck at scale.
        Returns the list of (bit, bit_start_epoch) completed here.
        """
        ip = np.asarray(i_prompts, np.float64)
        ep = np.asarray(epoch_indices, np.int64)
        n = ip.size
        if n == 0:
            return []
        start = 0
        if not self.synced:
            prev = np.concatenate(([self._prev_ip], ip[:-1]))
            flips = np.where(prev * ip < 0.0)[0]
            ph = (ep[flips] % BIT_MS).astype(np.int64)
            if ph.size:
                onehot = ph[:, None] == np.arange(BIT_MS)[None, :]
                cum = np.cumsum(onehot, axis=0)
                crossed = onehot & (self.hist[None, :] + cum
                                    >= self.threshold)
                rows = np.nonzero(crossed.any(axis=1))[0]
            else:
                rows = np.empty(0, np.int64)
            if rows.size == 0:
                if ph.size:
                    self.hist += cum[-1]
                self._prev_ip = float(ip[-1])
                return []
            r = int(rows[0])
            self.hist += cum[r]
            self.synced = True
            self.boundary_phase = int(ph[r])
            self._acc = 0.0
            self._acc_count = 0
            start = int(flips[r]) + 1       # feed() consumed this epoch
        if start >= n:
            self._prev_ip = float(ip[-1])
            return []

        ip2, ep2 = ip[start:], ep[start:]
        self._prev_ip = float(ip2[-1])
        b = self.boundary_phase
        bit_id = (ep2 - b) // BIT_MS
        uniq, inv = np.unique(bit_id, return_inverse=True)
        sums = np.zeros(uniq.size)
        np.add.at(sums, inv, ip2)
        counts = np.bincount(inv, minlength=uniq.size)
        # fold in the carried partial bit (same group id as its start)
        if self._acc_count and uniq.size:
            carry_id = (getattr(self, "_bit_start", ep2[0]) - b) // BIT_MS
            if uniq[0] == carry_id and (ep2[0] - b) % BIT_MS != 0:
                sums[0] += self._acc
                counts[0] += self._acc_count
        out = []
        for k in range(uniq.size):
            if counts[k] == BIT_MS:
                bit = 1 if sums[k] > 0 else -1
                bit_start = int(uniq[k] * BIT_MS + b)
                self.bits.append(bit)
                self.bit_epochs.append(bit_start)
                out.append((bit, bit_start))
        # the trailing (possibly partial) group becomes the new carry
        if counts[-1] < BIT_MS:
            self._acc = float(sums[-1])
            self._acc_count = int(counts[-1])
            self._bit_start = int(uniq[-1] * BIT_MS + b)
        else:
            self._acc = 0.0
            self._acc_count = 0
        return out


class FrameDecoder:
    """Preamble search + subframe assembly + parity verification.

    Feeds on +/-1 bits from BitSynchronizer. Handles polarity ambiguity
    (preamble may correlate at -8, decoding.rs:213-223) and validates
    candidate frames by checking TLM+HOW parity before locking frame
    sync — stronger than the reference, which locks on the correlation
    alone.
    """

    def __init__(self):
        self.bits: list[int] = []     # +/-1 as received
        self.frame_locked = False
        self.polarity = 1
        self.frame_start: Optional[int] = None   # index of subframe start
        self.subframes: list[Subframe] = []
        # parity-failed subframes in a row at the locked alignment, and
        # the bit count when the lock was last dropped (0: never locked)
        self.failed_run = 0
        self.unlocked_at = 0

    def feed(self, bit: int) -> Optional[Subframe]:
        self.bits.append(int(bit))
        n = len(self.bits)
        if not self.frame_locked:
            return self._try_lock()
        rel = n - self.frame_start
        if rel >= SUBFRAME_BITS and rel % SUBFRAME_BITS == 0:
            sf = self._decode_subframe(n - SUBFRAME_BITS)
            if sf is not None:
                self.failed_run = 0
                return sf
            # parity failed at the locked alignment: one noise-flipped
            # bit costs that subframe only, so the alignment is kept
            # through one failure. A bit slip (e.g. an epoch lost to the
            # fused path's offset walk dropping one 20 ms group) shifts
            # EVERY later subframe: after two failures in a row, unlock
            # and let the preamble search re-acquire the alignment from
            # the bits buffered since (ROADMAP C2)
            self.failed_run += 1
            if self.failed_run >= 2:
                self.frame_locked = False
                self.frame_start = None
                self.failed_run = 0
                self.unlocked_at = n
            return None
        return None

    def _bits01(self, start: int, count: int, polarity: int) -> np.ndarray:
        seg = np.asarray(self.bits[start:start + count], dtype=np.int8) * polarity
        return ((seg + 1) // 2).astype(np.uint8)

    #: preamble as plain int lists for the per-bit fast path (building
    #: a numpy view of the trailing 308 bits EVERY bit measured as the
    #: dominant host nav cost at 32 channels — ~8 ms/signal-s)
    _PRE_POS = [int(b) for b in C.GPS_CA_PREAMBLE_BITS]
    _PRE_NEG = [-b for b in _PRE_POS]

    def _try_lock(self) -> Optional[Subframe]:
        """O(1) per bit: test the alignment where a full subframe plus
        the NEXT subframe's preamble just completed (two preambles 300
        bits apart, reference decoding.rs:213-223, hardened by verifying
        all ten words' parity before declaring lock). Pure-list
        preamble compares gate the (rare) numpy parity verification."""
        n = len(self.bits)
        start = n - 8 - SUBFRAME_BITS
        if start < 2:
            return None
        head = self.bits[start:start + 8]
        tail = self.bits[start + SUBFRAME_BITS:start + SUBFRAME_BITS + 8]
        for pol, pre in ((1, self._PRE_POS), (-1, self._PRE_NEG)):
            if head != pre or tail != pre:
                continue
            saved_pol = self.polarity
            self.polarity = pol
            if self._verify_words(start, pol, 10):
                self.frame_locked = True
                self.frame_start = start
                return self._decode_subframe(start)
            self.polarity = saved_pol
        return None

    def _verify_words(self, start: int, polarity: int, n_words: int) -> bool:
        prev = self._bits01(start - 2, 2, polarity)
        d29, d30 = int(prev[0]), int(prev[1])
        for w in range(n_words):
            word = self._bits01(start + w * WORD_BITS, WORD_BITS, polarity)
            if not check_word_parity(word, d29, d30):
                return False
            d29, d30 = int(word[28]), int(word[29])
        return True

    def _decode_subframe(self, start: int) -> Optional[Subframe]:
        pol = self.polarity
        prev = self._bits01(start - 2, 2, pol)
        d29, d30 = int(prev[0]), int(prev[1])
        data = np.zeros((10, 24), dtype=np.uint8)
        for w in range(10):
            word = self._bits01(start + w * WORD_BITS, WORD_BITS, pol)
            if not check_word_parity(word, d29, d30):
                return None
            data[w] = decode_word_data(word, d30)
            d29, d30 = int(word[28]), int(word[29])
        tow = bits_to_uint(data[1][:17])
        sf_id = bits_to_uint(data[1][19:22])
        sf = Subframe(
            subframe_id=sf_id, tow_counts=tow, data=data,
            first_bit_index=start,
        )
        self.subframes.append(sf)
        return sf


# ---------------------------------------------------------------------------
# Encoder (test oracle + simulator support)
# ---------------------------------------------------------------------------

def encode_subframe(
    subframe_id: int,
    tow_counts: int,
    data_words: np.ndarray,     # [8, 24] uint8 source bits for words 3..10
    d29_star: int = 0,
    d30_star: int = 0,
) -> np.ndarray:
    """Build one 300-bit subframe (0/1, on-air polarity) with valid
    parity chaining, solving the t-bit constraint that words 2 and 10
    end with parity bits 29-30 = 00 (IS-GPS-200 20.3.3.1: the HOW's
    last two data bits are chosen to force this)."""
    preamble01 = ((PREAMBLE + 1) // 2).astype(np.uint8)
    words_data = np.zeros((10, 24), dtype=np.uint8)
    words_data[0, :8] = preamble01
    # TLM message left zero; bits 23-24 reserved
    how = np.zeros(24, dtype=np.uint8)
    for i in range(17):
        how[i] = (tow_counts >> (16 - i)) & 1
    for i in range(3):
        how[19 + i] = (subframe_id >> (2 - i)) & 1
    words_data[1] = how
    words_data[2:] = data_words

    out = np.zeros(300, dtype=np.uint8)
    d29, d30 = d29_star, d30_star
    for w in range(10):
        src = words_data[w].copy()
        if w in (1, 9):
            # solve the two free bits (t-bits, data 23-24) so that the
            # transmitted parity ends 00 -> next word starts unflipped
            for b23 in (0, 1):
                for b24 in (0, 1):
                    src[22], src[23] = b23, b24
                    tx = src ^ d30
                    par = compute_parity(tx, d29, d30)
                    if par[4] == 0 and par[5] == 0:
                        break
                else:
                    continue
                break
        tx = src ^ d30
        par = compute_parity(tx, d29, d30)
        out[w * 30:w * 30 + 24] = tx
        out[w * 30 + 24:(w + 1) * 30] = par
        d29, d30 = int(par[4]), int(par[5])
    return out


def encode_frames(subframes: list[tuple[int, int, np.ndarray]]) -> np.ndarray:
    """Encode consecutive subframes into a +/-1 bit stream."""
    bits = []
    d29 = d30 = 0
    for sf_id, tow, words in subframes:
        sf = encode_subframe(sf_id, tow, words, d29, d30)
        d29, d30 = int(sf[-2]), int(sf[-1])
        bits.append(sf)
    stream = np.concatenate(bits).astype(np.int8)
    return (2 * stream - 1).astype(np.int8)
