"""PBCH channel coding: CRC-16, tail-biting convolutional code, rate matching.

First-party implementation of 3GPP 36.212 5.1.1 / 5.1.3.1 / 5.1.4.2 (the
reference delegates all of this to srsLTE inside srslte_ue_mib_decode,
lib/mib_impl.cc:162).  Encoding lives here as plain numpy — it is only needed
for synthesis/golden tests.  For the *decoder*, this module precomputes the
static index maps (rate-dematch gather and trellis tables) that the jitted
Viterbi in ops/viterbi.py consumes.
"""

import functools

import numpy as np

from .constants import MIB_PAYLOAD_BITS, CRC_BITS

# LTE convolutional code: K=7, rate 1/3, generators (octal) 133, 171, 165.
CONV_K = 7
CONV_POLYS = (0o133, 0o171, 0o165)
N_STATES = 64

# PBCH CRC masks by number of TX antenna ports (36.212 table 5.3.1.1-1).
CRC_MASKS = {1: 0x0000, 2: 0xFFFF, 4: 0x5555}  # 0101... MSB-first = 0x5555
PORT_HYPOTHESES = (1, 2, 4)


def crc16(bits: np.ndarray) -> np.ndarray:
    """CRC-16 (gCRC16: x^16 + x^12 + x^5 + 1) over a bit array, MSB-first."""
    reg = 0
    for b in bits:
        reg = ((reg << 1) | int(b)) ^ (0x11021 if reg & 0x8000 else 0)
        reg &= 0x1FFFF
    # flush 16 zero bits
    for _ in range(16):
        reg = (reg << 1) ^ (0x11021 if reg & 0x8000 else 0)
        reg &= 0x1FFFF
    return np.array([(reg >> (15 - i)) & 1 for i in range(16)], dtype=np.uint8)


def crc16_attach(payload: np.ndarray, nof_ports: int) -> np.ndarray:
    """payload(24) + CRC masked by the antenna-port mask -> 40 bits."""
    crc = crc16(payload)
    mask = CRC_MASKS[nof_ports]
    maskbits = np.array([(mask >> (15 - i)) & 1 for i in range(16)], dtype=np.uint8)
    return np.concatenate([payload, crc ^ maskbits])


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Tail-biting rate-1/3 K=7 encode -> [3, len(bits)] (d^(0), d^(1), d^(2)).

    Initial shift register = last 6 input bits (36.212 5.1.3.1).
    Register convention: 6-bit state with the delay-d bit at position 6-d
    (newest previous bit at bit 5, oldest at bit 0), so the 7-bit tap window
    is (current << 6) | state and the octal generators apply directly.
    """
    n = len(bits)
    out = np.zeros((3, n), dtype=np.uint8)
    state = 0
    for d in range(1, 7):                      # s_d = bits[n - d]
        state |= int(bits[n - d]) << (6 - d)
    for i in range(n):
        window = (int(bits[i]) << 6) | state
        for j, g in enumerate(CONV_POLYS):
            out[j, i] = bin(window & g).count("1") & 1
        state = (state >> 1) | (int(bits[i]) << 5)
    return out


# --- sub-block interleaver (36.212 5.1.4.2.1) ---
_PERM = (1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
         0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30)


@functools.lru_cache(maxsize=None)
def _subblock_order(n: int):
    """Read-out order of input indices for one stream (NULLs as -1)."""
    cols = 32
    rows = (n + cols - 1) // cols
    pad = rows * cols - n
    mat = np.full((rows, cols), -1, dtype=np.int64)
    flat = np.concatenate([np.full(pad, -1, dtype=np.int64), np.arange(n)])
    mat[:] = flat.reshape(rows, cols)
    order = []
    for c in _PERM:
        order.extend(mat[:, c])
    return np.array(order, dtype=np.int64)   # length rows*cols, -1 = NULL


@functools.lru_cache(maxsize=None)
def ratematch_map(n_info_coded: int, e_bits: int):
    """[e_bits] int64: position i of the rate-matched output <- index into the
    flattened coded bits d.reshape(3*n) (stream-major: d[0] then d[1] then d[2]).

    Circular buffer = concat of the 3 interleaved streams with NULLs skipped.
    """
    order = _subblock_order(n_info_coded)
    kw = []
    for s in range(3):
        for idx in order:
            kw.append(-1 if idx < 0 else s * n_info_coded + idx)
    kw = np.array(kw, dtype=np.int64)
    valid = kw[kw >= 0]
    reps = (e_bits + len(valid) - 1) // len(valid)
    return np.tile(valid, reps)[:e_bits]


def rate_match(coded: np.ndarray, e_bits: int) -> np.ndarray:
    """Encode-side rate matching: [3, n] coded bits -> [e_bits]."""
    m = ratematch_map(coded.shape[1], e_bits)
    return coded.reshape(-1)[m]


@functools.lru_cache(maxsize=None)
def dematch_scatter(n_info_coded: int, e_bits: int):
    """Decoder-side: same map, used to scatter-add e_bits LLRs into 3*n bins."""
    return ratematch_map(n_info_coded, e_bits)


@functools.lru_cache(maxsize=None)
def trellis_tables():
    """Static trellis for the 64-state decoder (convention of conv_encode:
    state bit 6-d holds the delay-d input; newest bit is the state's MSB).

    A transition into state ns consumes input bit b = ns >> 5 and comes from
    ps = ((ns & 0x1F) << 1) | drop, where `drop` is the bit that fell off.

    Returns:
      prev_state [64, 2] int32 : prev_state[ns, drop]
      out_bits   [64, 2, 3] f32: +-1 expected channel symbols for the
                                 transition (bit 0 -> +1, bit 1 -> -1)
    """
    prev_state = np.zeros((N_STATES, 2), dtype=np.int32)
    out_bits = np.zeros((N_STATES, 2, 3), dtype=np.float32)
    for ns in range(N_STATES):
        b = (ns >> 5) & 1
        for drop in (0, 1):
            ps = ((ns & 0x1F) << 1) | drop
            window = (b << 6) | ps
            outs = [bin(window & g).count("1") & 1 for g in CONV_POLYS]
            prev_state[ns, drop] = ps
            out_bits[ns, drop] = 1.0 - 2.0 * np.array(outs, dtype=np.float32)
    return prev_state, out_bits
