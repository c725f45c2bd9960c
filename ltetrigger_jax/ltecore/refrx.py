"""Host-side reference receiver (pure numpy).

A slow, obviously-correct implementation of the whole sensing chain:
decimate -> PSS search/PSR -> align -> SSS -> PBCH/MIB decode.  It exists to
cross-validate the jitted device ops (every ops/ kernel has a golden test against
this module) and to document the numeric contract in one readable place.

Behavioral parity notes vs the reference (NTIA/gr-ltetrigger):
  * PSR is computed in the *power* domain (|corr|^2), matching srsLTE's
    abs-square conv output (reference lib/pss_impl.cc:165 via
    srslte_pss_find_pss); threshold 4 therefore behaves identically.
  * Alignment: a half-frame is aligned so the PSS symbol occupies samples
    [832, 960) => frame_start = corr_argmax - 832 (reference equivalent:
    frame_start = peak_pos - slot_length, lib/pss_impl.cc:185-189).
  * SSS symbol extracted at 960 - 2*128 - cp_len (lib/sss_impl.cc:110).
"""

import numpy as np

from . import coding, crs as crsmod, mib as mibmod, scrambling
from . import pss as pssmod, sss as sssmod
from .constants import (CP_EXT, CP_NORM, HALF_FRAME_LENGTH, PSS_SYMBOL_START,
                        SLOT_LENGTH, SYMBOL_SZ, symbol_data_offsets)


# ---------------------------------------------------------------- frontend --
def design_lowpass(ratio: int, taps_per_phase: int = 16) -> np.ndarray:
    """Hamming-windowed sinc anti-alias filter for integer decimation."""
    n = taps_per_phase * ratio
    t = np.arange(n) - (n - 1) / 2
    cutoff = 1.0 / ratio
    h = np.sinc(t * cutoff) * cutoff * np.hamming(n)
    return (h / h.sum()).astype(np.float64)


def decimate(x: np.ndarray, ratio: int) -> np.ndarray:
    """Anti-aliased integer decimation (zero-phase-ish center alignment)."""
    if ratio == 1:
        return x
    h = design_lowpass(ratio)
    y = np.convolve(x, h, mode="full")[(len(h) - 1) // 2:][:len(x)]
    return y[::ratio]


# --------------------------------------------------------------------- PSS --
def pss_correlate(window: np.ndarray, n_id_2: int) -> np.ndarray:
    """|corr|^2 over start positions [0, 9600) of a >=9727-sample window."""
    rep = pssmod.pss_time()[n_id_2]
    L = 16384
    X = np.fft.fft(window[:HALF_FRAME_LENGTH + SYMBOL_SZ - 1], L)
    R = np.fft.fft(np.conj(rep[::-1]), L)
    c = np.fft.ifft(X * R)[SYMBOL_SZ - 1:SYMBOL_SZ - 1 + HALF_FRAME_LENGTH]
    return np.abs(c) ** 2


def peak_and_psr(power: np.ndarray, lobe_limit: int = 64):
    """(peak_index, psr): peak vs max sidelobe outside the main lobe.

    srsLTE semantics (compute_peak_sidelobe): walk down each side of the peak
    until the first rise (bounded by lobe_limit); sidelobe = max outside.
    """
    n = len(power)
    pk = int(np.argmax(power))
    r = pk
    while r + 1 < n and r - pk < lobe_limit and power[r + 1] <= power[r]:
        r += 1
    l = pk
    while l - 1 >= 0 and pk - l < lobe_limit and power[l - 1] <= power[l]:
        l -= 1
    mask = np.ones(n, dtype=bool)
    mask[l:r + 1] = False
    side = power[mask].max() if mask.any() else 1e-30
    return pk, float(power[pk] / max(side, 1e-30))


# --------------------------------------------------------------------- SSS --
def detect_cp(aligned: np.ndarray) -> bool:
    """True = Normal CP.  Correlate CP against symbol tail for the 2 symbols
    preceding the PSS (which ends at sample 960 of an aligned half-frame)."""
    scores = {}
    for normal, cp in ((True, CP_NORM), (False, CP_EXT)):
        num = 0.0 + 0.0j
        den = 1e-30
        pos = SLOT_LENGTH - SYMBOL_SZ  # start of PSS data: 832
        for _ in range(2):
            pos -= SYMBOL_SZ + cp      # data start of the preceding symbol
            # CP occupies [pos-cp, pos) and copies the data tail
            # [pos+128-cp, pos+128)
            c = aligned[pos - cp:pos]
            t = aligned[pos + SYMBOL_SZ - cp:pos + SYMBOL_SZ]
            num += np.vdot(t, c)
            den += 0.5 * (np.sum(np.abs(c) ** 2) + np.sum(np.abs(t) ** 2))
        scores[normal] = np.abs(num) / den
    return scores[True] >= scores[False]


def sss_decode(aligned: np.ndarray, n_id_2: int, normal_cp: bool = True):
    """-> (n_id_1 or -1, subframe5: bool, m0, m1)."""
    cp = CP_NORM if normal_cp else CP_EXT
    idx = SLOT_LENGTH - 2 * SYMBOL_SZ - cp
    F = np.fft.fft(aligned[idx:idx + SYMBOL_SZ])
    y = F[pssmod.subcarrier_bins()]
    S = sssmod.shift_bank()
    cs = sssmod.c_scramble()[n_id_2]
    zb = sssmod.z_bank()
    m0 = int(np.argmax(np.abs((y[0::2] * cs[0]) @ S.T)))
    m1 = int(np.argmax(np.abs((y[1::2] * cs[1] * zb[m0 % 8]) @ S.T)))
    tab = sssmod.nid1_table()
    if tab[m0, m1] >= 0:
        return int(tab[m0, m1]), False, m0, m1
    if tab[m1, m0] >= 0:
        return int(tab[m1, m0]), True, m0, m1
    return -1, False, m0, m1


# -------------------------------------------------------------------- PBCH --
def ofdm_demod_slot(slot_samples: np.ndarray, normal_cp: bool = True):
    """[nsym, 72] subcarriers (6 PRB centered, DC excluded)."""
    out = []
    for o in symbol_data_offsets(normal_cp):
        F = np.fft.fft(slot_samples[o:o + SYMBOL_SZ])
        out.append(np.concatenate([F[SYMBOL_SZ - 36:], F[1:37]]))
    return np.array(out)


def _chest_port(slot_syms, cell_id, slot_no, port, normal_cp):
    """Average LS channel estimate for one port over its CRS symbols."""
    acc = np.zeros(72, dtype=np.complex128)
    n = 0
    for sym in crsmod.crs_symbol_indices(port, normal_cp):
        pil = crsmod.crs_values(cell_id, slot_no, sym, normal_cp)
        k = crsmod.crs_subcarriers(cell_id, port, sym, slot_no)
        h_ls = slot_syms[sym][k] / pil
        acc += (np.interp(np.arange(72), k, h_ls.real)
                + 1j * np.interp(np.arange(72), k, h_ls.imag))
        n += 1
    return acc / n


def pbch_re_indices(v_shift: int, normal_cp: bool = True):
    """(l, k) pairs of the PBCH REs, freq-first then symbol order.

    CRS positions (ports 0-3 pattern, k % 3 == v_shift % 3) are reserved in
    symbols 0,1 for normal CP and additionally in symbol 3 for extended CP
    (where ports 0/1 CRS fall on l = 3): 240 vs 216 REs.
    """
    crs_syms = (0, 1) if normal_cp else (0, 1, 3)
    return [(l, k) for l in range(4) for k in range(72)
            if not (l in crs_syms and (k % 3) == (v_shift % 3))]


def pbch_res(slot1_syms, v_shift: int, normal_cp: bool = True):
    """Collect the PBCH REs, + their subcarrier and symbol indices."""
    idx = pbch_re_indices(v_shift, normal_cp)
    ys = np.array([slot1_syms[l][k] for l, k in idx])
    ks = np.array([k for _, k in idx])
    ls = np.array([l for l, _ in idx])
    return ys, ks, ls


def pbch_llrs(subframe: np.ndarray, cell_id: int, normal_cp: bool,
              nof_ports: int):
    """QPSK LLRs for the 240 PBCH REs under a TX-port-count hypothesis."""
    slot1 = ofdm_demod_slot(subframe[SLOT_LENGTH:2 * SLOT_LENGTH], normal_cp)
    v_shift = cell_id % 6
    y, k, _ = pbch_res(slot1, v_shift, normal_cp)
    h0 = _chest_port(slot1, cell_id, 1, 0, normal_cp)
    if nof_ports == 1:
        h = h0[k]
        x = y * np.conj(h) / (np.abs(h) ** 2 + 1e-12)
        d = x
    elif nof_ports == 2:
        h1 = _chest_port(slot1, cell_id, 1, 1, normal_cp)
        d = _sfbc_decode(y, h0[k], h1[k])
    else:  # 4 ports: SFBC-FSTD on groups of 4 REs, port pairs (0,2) and (1,3)
        h1 = _chest_port(slot1, cell_id, 1, 1, normal_cp)
        h2 = _chest_port(slot1, cell_id, 1, 2, normal_cp)
        h3 = _chest_port(slot1, cell_id, 1, 3, normal_cp)
        d = _sfbc_fstd_decode(y, h0[k], h1[k], h2[k], h3[k])
    llr = np.empty(2 * len(d))
    llr[0::2] = d.real
    llr[1::2] = d.imag
    return llr


def _sfbc_decode(y, h0, h1):
    """Alamouti SFBC over RE pairs: port0 sends (x0, x1), port1 (-x1*, x0*)."""
    y0, y1 = y[0::2], y[1::2]
    g0, g1 = h0[0::2], h1[0::2]   # channel approx constant over the pair
    denom = np.abs(g0) ** 2 + np.abs(g1) ** 2 + 1e-12
    x0 = (np.conj(g0) * y0 + g1 * np.conj(y1)) / denom
    x1 = (np.conj(g0) * y1 - g1 * np.conj(y0)) / denom
    d = np.empty_like(y)
    d[0::2] = x0
    d[1::2] = x1
    return d


def _sfbc_fstd_decode(y, h0, h1, h2, h3):
    """4-port SFBC+FSTD: groups of 4 REs; (0,2) on REs {0,1}, (1,3) on {2,3}."""
    d = np.empty_like(y)
    for g in range(0, len(y), 4):
        d[g:g + 2] = _sfbc_decode(y[g:g + 2], h0[g:g + 2], h2[g:g + 2])
        d[g + 2:g + 4] = _sfbc_decode(y[g + 2:g + 4], h1[g + 2:g + 4],
                                      h3[g + 2:g + 4])
    return d


def viterbi_tailbiting(llr120: np.ndarray):
    """Exact tail-biting Viterbi (all-64-init-state batch). -> (bits[40], metric).

    llr120 ordered step-major: (d0(t), d1(t), d2(t)) for t = 0..39.
    """
    prev_state, out_bits = coding.trellis_tables()
    r = llr120.reshape(40, 3)
    m = np.full((64, 64), -1e9)
    m[np.arange(64), np.arange(64)] = 0.0
    decisions = np.zeros((40, 64, 64), dtype=np.uint8)
    for t in range(40):
        br = out_bits @ r[t]                        # [64 states, 2 drops]
        cand = m[:, prev_state] + br[None]          # [init, ns, drop]
        decisions[t] = np.argmax(cand, axis=2)
        m = np.max(cand, axis=2)
    init = int(np.argmax(np.diag(m)))
    s = init
    bits = np.zeros(40, dtype=np.uint8)
    for t in range(39, -1, -1):
        bits[t] = (s >> 5) & 1
        s = int(prev_state[s, decisions[t, init, s]])
    return bits, float(m[init, init])


def mib_decode_subframe(subframe: np.ndarray, cell_id: int,
                        normal_cp: bool = True):
    """Single-subframe PBCH decode attempt, mirroring the reference's
    srslte_pbch_decode_reset + srslte_ue_mib_decode per half-frame
    (lib/mib_impl.cc:161-165; soft-combining disabled by the reset).

    -> dict with MIB fields + nof_ports + quarter, or None if CRC never checks.
    """
    e_bits = 480 if normal_cp else 432
    sgn = 1.0 - 2.0 * scrambling.gold_sequence(
        scrambling.pbch_c_init(cell_id), 4 * e_bits).astype(np.float64)
    dem_map = coding.ratematch_map(40, 4 * e_bits)
    for nof_ports in coding.PORT_HYPOTHESES:
        llr = pbch_llrs(subframe, cell_id, normal_cp, nof_ports)
        for q in range(4):
            d = llr * sgn[e_bits * q: e_bits * (q + 1)]
            acc = np.zeros(120)
            np.add.at(acc, dem_map[e_bits * q:e_bits * (q + 1)], d)
            step_major = acc.reshape(3, 40).T.reshape(-1)
            bits, metric = viterbi_tailbiting(step_major)
            mask = coding.CRC_MASKS[nof_ports]
            maskbits = np.array([(mask >> (15 - i)) & 1 for i in range(16)],
                                dtype=np.uint8)
            if np.array_equal(coding.crc16(bits[:24]) ^ maskbits, bits[24:]):
                out = mibmod.mib_unpack(bits[:24])
                out["nof_ports"] = nof_ports
                out["quarter"] = q
                out["metric"] = metric
                return out
    return None


# ------------------------------------------------------------- end-to-end --
def search_frame(iq: np.ndarray, sample_rate: float):
    """Convenience end-to-end search over a looped capture. -> cell dict|None."""
    ratio = int(round(sample_rate / 1.92e6))
    x = decimate(np.concatenate([iq, iq]), ratio)
    for n_id_2 in range(3):
        power = pss_correlate(x, n_id_2)
        pk, psr = peak_and_psr(power)
        if psr <= 4.0:
            continue
        frame_start = pk - PSS_SYMBOL_START
        if frame_start < 0:
            frame_start += HALF_FRAME_LENGTH
        aligned = x[frame_start:frame_start + HALF_FRAME_LENGTH]
        normal_cp = detect_cp(aligned)
        n_id_1, sub5, _, _ = sss_decode(aligned, n_id_2, normal_cp)
        if n_id_1 < 0:
            continue
        if sub5:
            frame_start += HALF_FRAME_LENGTH
            aligned = x[frame_start:frame_start + HALF_FRAME_LENGTH]
        mib = mib_decode_subframe(aligned[:2 * SLOT_LENGTH],
                                  3 * n_id_1 + n_id_2, normal_cp)
        if mib is not None:
            mib["cell_id"] = 3 * n_id_1 + n_id_2
            mib["cp_len"] = "Normal" if normal_cp else "Extended"
            mib["psr"] = psr
            return mib
    return None
