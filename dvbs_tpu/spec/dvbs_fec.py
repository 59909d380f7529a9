"""DVB-S inner FEC definitions (EN 300 421 sec. 4.4.3 / 4.5).

- K=7 rate-1/2 convolutional code, G1=171oct (X), G2=133oct (Y)
  (the reference's {79,109} are the same polynomials bit-reversed,
  viterbi_all.cpp:17-26).
- Puncturing patterns for rates 1/2, 2/3, 3/4, 5/6, 7/8; the punctured
  serial stream maps pairwise onto QPSK (I,Q).
- Forney convolutional interleaver I=12, M=17
  (/root/reference/src/demod/dvbs/dvbs_interleaving.h:58-70).

All numpy; depuncturing emits float LLR pairs with 0 = erasure for the
device Viterbi decoder.
"""
from __future__ import annotations

import numpy as np

K_CC = 7
G1 = 0o171   # X output
G2 = 0o133   # Y output

# puncture patterns (X row, Y row), EN 300 421 table 2
PUNCTURE = {
    "1/2": (np.array([1]), np.array([1])),
    "2/3": (np.array([1, 0]), np.array([1, 1])),
    "3/4": (np.array([1, 0, 1]), np.array([1, 1, 0])),
    "5/6": (np.array([1, 0, 1, 0, 1]), np.array([1, 1, 0, 1, 0])),
    "7/8": (np.array([1, 0, 0, 0, 1, 0, 1]), np.array([1, 1, 1, 1, 0, 1, 0])),
}

RATES = list(PUNCTURE)


def cc_encode(bits: np.ndarray, start_state: int = 0) -> np.ndarray:
    """Rate-1/2 mother code. bits [n] -> [n, 2] (X, Y) uint8.

    Shift register holds the last 6 input bits; output uses the current
    bit and the register (standard NSC, G1 on X).
    """
    n = len(bits)
    # build state sequence: reg = previous 6 bits (most recent in MSB)
    out = np.zeros((n, 2), np.uint8)
    reg = start_state & 0x3F
    g1, g2 = G1, G2
    for i, b in enumerate(bits):
        v = (int(b) << 6) | reg
        out[i, 0] = bin(v & g1).count("1") & 1
        out[i, 1] = bin(v & g2).count("1") & 1
        reg = (v >> 1) & 0x3F
    return out


def puncture(xy: np.ndarray, rate: str) -> np.ndarray:
    """xy [n, 2] -> serial punctured stream [m] uint8 (X-first order)."""
    px, py = PUNCTURE[rate]
    p = len(px)
    n = len(xy)
    assert n % p == 0, "length must be a multiple of the puncture period"
    keep = np.stack([np.tile(px, n // p), np.tile(py, n // p)],
                    axis=1).astype(bool)          # [n, 2]
    return xy.reshape(-1)[keep.reshape(-1)]


def depuncture(stream: np.ndarray, rate: str, phase: int = 0) -> np.ndarray:
    """Inverse: serial soft stream [m] float -> [n, 2] float with erasures 0.

    phase: starting offset into the puncture pattern (for alignment
    search). stream values are LLR-like floats (positive = bit 0).
    """
    px, py = PUNCTURE[rate]
    p = len(px)
    pat = np.stack([px, py], axis=1).reshape(-1).astype(bool)  # length 2p
    pat = np.roll(pat, -2 * (phase % p)) if phase else pat
    n_kept = int(pat.sum())
    m = len(stream)
    periods = m // n_kept
    out = np.zeros((periods * 2 * p,), np.float64)
    idx = np.nonzero(np.tile(pat, periods))[0]
    out[idx] = stream[:periods * n_kept]
    return out.reshape(-1, 2)


# ---------------------------------------------------------------------------
# Forney convolutional interleaver (I=12 branches, M=17 bytes delay unit)
# ---------------------------------------------------------------------------

I_BRANCHES = 12
M_DEPTH = 17


class ConvInterleaver:
    """TX direction: branch j delays by j*17 bytes."""

    def __init__(self):
        self.fifos = [np.zeros(j * M_DEPTH, np.uint8) for j in range(I_BRANCHES)]

    def process(self, data: np.ndarray) -> np.ndarray:
        out = np.empty_like(data)
        for j in range(I_BRANCHES):
            lane = data[j::I_BRANCHES]
            if j == 0:
                out[j::I_BRANCHES] = lane
                continue
            buf = np.concatenate([self.fifos[j], lane])
            out[j::I_BRANCHES] = buf[:len(lane)]
            self.fifos[j] = buf[len(lane):]
        return out


class ConvDeinterleaver:
    """RX direction: branch j delays by (11-j)*17 bytes
    (dvbs_interleaving.h:58-70)."""

    def __init__(self):
        self.fifos = [np.zeros((I_BRANCHES - 1 - j) * M_DEPTH, np.uint8)
                      for j in range(I_BRANCHES)]

    def process(self, data: np.ndarray) -> np.ndarray:
        out = np.empty_like(data)
        for j in range(I_BRANCHES):
            lane = data[j::I_BRANCHES]
            buf = np.concatenate([self.fifos[j], lane])
            out[j::I_BRANCHES] = buf[:len(lane)]
            self.fifos[j] = buf[len(lane):]
        return out
