"""Jitted PBCH/MIB decoder (real-pair, FFT-free).

Replaces the whole srslte_ue_mib_decode chain (reference lib/mib_impl.cc:162
— OFDM demod, CRS channel estimation, PBCH demod, descrambling, rate
dematching, Viterbi, CRC/port search, MIB unpack) with one fixed-shape
array program:

  * OFDM demodulation is a [72, 128] DFT matmul per symbol (no FFT);
  * cell_id is a *traced* value (it comes from SSS at runtime), so every
    cell-dependent sequence is computed on device: Gold scrambling and CRS
    pilots are GF(2) matmuls against precomputed generator matrices
    (ltecore/scrambling.py), CRS/PBCH resource positions are arithmetic in
    v_shift;
  * both CP hypotheses, all 3 TX-port-count hypotheses, and all 4 scrambling
    quarters are evaluated unconditionally as batch dimensions; CRC (itself a
    linear GF(2) map) selects the winner.  No data-dependent control flow;
  * rate dematching is a static one-hot matmul (480x120 per quarter).

The reference resets PBCH soft-combining every half-frame
(srslte_pbch_decode_reset, lib/mib_impl.cc:161) so decode is stateless per
subframe — which is exactly what a fixed-shape program wants.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ltecore import coding, scrambling
from ..ltecore.constants import (NOF_PRB_TABLE, SLOT_LENGTH, SYMBOL_SZ,
                                 symbol_data_offsets)
from . import cplx, dft
from .viterbi import viterbi_decode_wa

N_RB_MAX = 110
E_BITS = {True: 480, False: 432}


# --------------------------------------------------------------- static maps
@functools.lru_cache(maxsize=None)
def _gold_mats(length: int):
    G, x1c = scrambling.gold_matrix(length)
    return G.astype(np.float32), x1c.astype(np.float32)


def _gold_signs(c_init, length: int) -> jnp.ndarray:
    """(+1/-1)^c(n) for a traced c_init: one [length,31] matmul + parity."""
    G, x1c = _gold_mats(length)
    bits = ((c_init >> jnp.arange(31)) & 1).astype(jnp.float32)
    # DEFAULT precision is exact: 0/1 operands, sums <= 31, f32 accumulate
    c = jnp.mod(jnp.asarray(G) @ bits + jnp.asarray(x1c), 2.0)
    return 1.0 - 2.0 * c


@functools.lru_cache(maxsize=None)
def _dematch_onehot(normal_cp: bool) -> np.ndarray:
    """[4, e_bits, 120] one-hot scatter matrices, one per quarter."""
    e = E_BITS[normal_cp]
    m = coding.ratematch_map(40, 4 * e)
    out = np.zeros((4, e, 120), dtype=np.float32)
    for q in range(4):
        seg = m[q * e:(q + 1) * e]
        out[q, np.arange(e), seg] = 1.0
    return out


@functools.lru_cache(maxsize=None)
def _crc_matrix() -> np.ndarray:
    """[16, 24] GF(2) matrix: crc16(payload) = C @ payload mod 2."""
    C = np.zeros((16, 24), dtype=np.float32)
    for i in range(24):
        b = np.zeros(24, dtype=np.uint8)
        b[i] = 1
        C[:, i] = coding.crc16(b)
    return C


@functools.lru_cache(maxsize=None)
def _crc_masks() -> np.ndarray:
    """[3, 16] port masks for 1/2/4 ports."""
    out = np.zeros((3, 16), dtype=np.float32)
    for row, ports in enumerate(coding.PORT_HYPOTHESES):
        mask = coding.CRC_MASKS[ports]
        out[row] = [(mask >> (15 - i)) & 1 for i in range(16)]
    return out


# ------------------------------------------------------------------- OFDM --
def ofdm_demod_slot(slot: cplx.Pair, normal_cp: bool) -> cplx.Pair:
    """pair of [..., 960] -> pair of [..., nsym, 72] (6 PRB grid)."""
    offs = symbol_data_offsets(normal_cp)
    wins = cplx.stack(
        [cplx.index(slot, (..., slice(o, o + SYMBOL_SZ))) for o in offs],
        axis=-2)
    return dft.dft_grid(wins)


# ------------------------------------------------------------------ chest --
# The CRS subcarrier offset k0 = (v + v_shift) mod 6 is a *traced* value
# (cell_id comes from SSS at runtime).  Round 2 selected pilots and
# interpolated with take_along_axis on per-candidate indices (per-element
# gathers).  Here every offset-dependent selection is a static matrix for
# each of the 6 possible offsets, evaluated for ALL offsets as one small
# matmul and collapsed with a one-hot weighting — dense, no gathers.
@functools.lru_cache(maxsize=None)
def _crs_sel_mats():
    """(Y [6, 72, 12], W [6, 12, 72]) float32: for CRS offset v, Y selects
    the 12 pilot REs (k = v + 6m) from a 72-subcarrier symbol and W is the
    exact linear-interp-with-flat-extrapolation map back to 72."""
    Y = np.zeros((6, 72, 12), dtype=np.float32)
    W = np.zeros((6, 12, 72), dtype=np.float32)
    for v in range(6):
        for m in range(12):
            Y[v, v + 6 * m, m] = 1.0
        j = np.arange(72)
        t = (j - v) / 6.0
        mf = np.clip(np.floor(t), 0, 10).astype(int)
        fr = np.clip(t - mf, 0.0, 1.0)
        mh = np.minimum(mf + 1, 11)
        for jj in range(72):
            W[v, mf[jj], jj] += 1.0 - fr[jj]
            W[v, mh[jj], jj] += fr[jj]
    return Y, W


def _crs_pilots(cell_id, slot_no: int, sym: int, normal_cp: bool):
    """pair of [..., 12] pilots for the centered 6 PRB (traced cell_id)."""
    c_init = scrambling.crs_c_init(cell_id, slot_no, sym, normal_cp)
    signs = _gold_signs(c_init, 4 * N_RB_MAX)
    m = jnp.arange(12) + (N_RB_MAX - 6)
    re = jnp.take(signs, 2 * m, axis=-1) / np.sqrt(2.0)
    im = jnp.take(signs, 2 * m + 1, axis=-1) / np.sqrt(2.0)
    return (re.astype(jnp.float32), im.astype(jnp.float32))


def _crs_v(port: int, sym: int, slot_no: int) -> int:
    if port == 0:
        return 0 if sym == 0 else 3
    if port == 1:
        return 3 if sym == 0 else 0
    if port == 2:
        return 3 * (slot_no % 2)
    return 3 + 3 * (slot_no % 2)


def _chest_port(slot_syms: cplx.Pair, cell_id, slot_no: int, port: int,
                normal_cp: bool, oh6=None) -> cplx.Pair:
    """pair of [..., 72] averaged LS estimate with linear freq interp.

    oh6: optional precomputed one-hot of v_shift = cell_id mod 6 ([..., 6]).
    """
    if port in (0, 1):
        crs_syms = (0, 4) if normal_cp else (0, 3)
    else:
        crs_syms = (1,)
    if oh6 is None:
        v_shift = jnp.mod(cell_id, 6)
        oh6 = (jnp.arange(6) == v_shift[..., None]).astype(jnp.float32)
    Y, W = _crs_sel_mats()
    Yj, Wj = jnp.asarray(Y), jnp.asarray(W)
    acc = cplx.zeros(slot_syms[0].shape[:-2] + (72,))
    for sym in crs_syms:
        pil = _crs_pilots(cell_id, slot_no, sym, normal_cp)
        # one-hot of k0 = (v + v_shift) mod 6 is oh6 rolled by the static v
        ohk = jnp.roll(oh6, _crs_v(port, sym, slot_no), axis=-1)
        # all 6 offsets at once, then collapse: pilot REs ...
        # (DEFAULT (TF32) precision: within CHEST_RTOL of f64, chip_smoke)
        y_all = (jnp.einsum("...k,vkm->...vm", slot_syms[0][..., sym, :], Yj),
                 jnp.einsum("...k,vkm->...vm", slot_syms[1][..., sym, :], Yj))
        h_all = cplx.div_real(cplx.mul_conj(y_all, cplx.index(
            pil, (..., None, slice(None)))), cplx.abs2(pil)[..., None, :])
        # ... interpolated back to 72 subcarriers per offset, then selected
        h72 = (jnp.einsum("...vm,vmj,...v->...j", h_all[0], Wj, ohk),
               jnp.einsum("...vm,vmj,...v->...j", h_all[1], Wj, ohk))
        acc = cplx.add(acc, h72)
    return cplx.scale(acc, 1.0 / len(crs_syms))


# ------------------------------------------------------- PBCH RE selection --
@functools.lru_cache(maxsize=None)
def _pbch_sel_mats(normal_cp: bool):
    """(P [3, 288, E], K72 [3, 72, E]) float32 selection matrices per
    v3 = cell_id mod 3: P maps the flattened 4x72 PBCH symbol grid to the E
    used REs (frequency-first order; CRS-reserved symbols skip k % 3 == v3:
    k_j = 3*(j//2) + (a if j even else b) with {a,b} = {0,1,2}\\{v3}); K72
    maps a 72-subcarrier channel estimate to the same E positions."""
    e = E_BITS[normal_cp] // 2
    crs_syms = (0, 1) if normal_cp else (0, 1, 3)
    P = np.zeros((3, 4 * 72, e), dtype=np.float32)
    K72 = np.zeros((3, 72, e), dtype=np.float32)
    for v3 in range(3):
        ab = [x for x in (0, 1, 2) if x != v3]
        idx = 0
        for l in range(4):
            if l in crs_syms:
                ks = [3 * (j // 2) + ab[j % 2] for j in range(48)]
            else:
                ks = list(range(72))
            for k in ks:
                P[v3, l * 72 + k, idx] = 1.0
                K72[v3, k, idx] = 1.0
                idx += 1
        assert idx == e
    return P, K72


# ---------------------------------------------------------------- equalize --
# MRC weighting, not ZF: the combiner output is conj(h)*y (scaled by the
# Alamouti branch power for SFBC) with NO division by |h|^2.  Dividing makes
# the constellation unit-scale but weights every RE equally in the Viterbi
# metric; leaving the |h|^2 factor in place weights each RE by its channel
# confidence — the optimal soft metric, and worth ~3 dB of MIB sensitivity
# when the pilots are noise-dominated (the regime TTI soft-combining exists
# for).  Decisions on clean captures are unchanged (scale-invariant CRC/
# Viterbi paths on flat channels).
def _sfbc(y: cplx.Pair, g0: cplx.Pair, g1: cplx.Pair) -> cplx.Pair:
    """Alamouti SFBC combine over adjacent RE pairs (y, channels as pairs)."""
    y0 = cplx.index(y, (..., slice(0, None, 2)))
    y1 = cplx.index(y, (..., slice(1, None, 2)))
    a0 = cplx.index(g0, (..., slice(0, None, 2)))
    a1 = cplx.index(g1, (..., slice(0, None, 2)))
    x0 = cplx.add(cplx.mul(cplx.conj(a0), y0), cplx.mul(a1, cplx.conj(y1)))
    x1 = cplx.sub(cplx.mul(cplx.conj(a0), y1), cplx.mul(a1, cplx.conj(y0)))
    # interleave x0/x1 back
    re = jnp.stack([x0[0], x1[0]], axis=-1).reshape(y[0].shape)
    im = jnp.stack([x0[1], x1[1]], axis=-1).reshape(y[1].shape)
    return (re, im)


def _equalize(y: cplx.Pair, h: list, nof_ports: int) -> cplx.Pair:
    """y pair [..., E]; h = list of 4 per-port pairs [..., E] -> MRC symbols."""
    if nof_ports == 1:
        return cplx.mul_conj(y, h[0])
    if nof_ports == 2:
        return _sfbc(y, h[0], h[1])
    # 4 ports: SFBC-FSTD on groups of 4; pairs (0,2) on REs {0,1} and
    # (1,3) on REs {2,3} of each group
    e = y[0].shape[-1]
    sh = y[0].shape[:-1]

    def grp(p, sel):
        r = p[0].reshape(sh + (e // 4, 4))[..., sel].reshape(sh + (e // 2,))
        i = p[1].reshape(sh + (e // 4, 4))[..., sel].reshape(sh + (e // 2,))
        return (r, i)

    first = slice(0, 2)
    second = slice(2, 4)
    d02 = _sfbc(grp(y, first), grp(h[0], first), grp(h[2], first))
    d13 = _sfbc(grp(y, second), grp(h[1], second), grp(h[3], second))
    re = jnp.concatenate([d02[0].reshape(sh + (e // 4, 2)),
                          d13[0].reshape(sh + (e // 4, 2))], axis=-1)
    im = jnp.concatenate([d02[1].reshape(sh + (e // 4, 2)),
                          d13[1].reshape(sh + (e // 4, 2))], axis=-1)
    return (re.reshape(sh + (e,)), im.reshape(sh + (e,)))


# ------------------------------------------------------------- full decode --
def pbch_quarter_llrs(subframe: cplx.Pair, cell_id, normal_cp: bool):
    """Dematched LLR contributions of ONE subframe: [3 ports, 4 quarters, 120].

    Element [p, q] is this subframe's contribution to the 120 codeword LLRs
    under the hypothesis of p TX ports (index 0/1/2 -> 1/2/4) and of the
    subframe carrying rate-match quarter q of the 40 ms PBCH TTI.  These
    contributions are additive across subframes of one TTI — the basis for
    soft-combining (reference gets this inside srslte_ue_mib_decode /
    srslte_pbch_decode's frame buffer, lib/mib_impl.cc:75-76,162)."""
    return pbch_quarter_llrs_slot1(
        cplx.index(subframe, (..., slice(SLOT_LENGTH, 2 * SLOT_LENGTH))),
        cell_id, normal_cp)


def pbch_quarter_llrs_slot1(slot1_td: cplx.Pair, cell_id, normal_cp: bool):
    """pbch_quarter_llrs taking slot 1's time-domain samples directly.

    slot1_td: pair of [960] float32 (the slot holding PBCH symbols 0-3)."""
    slot1 = ofdm_demod_slot(slot1_td, normal_cp)
    v3 = jnp.mod(cell_id, 3)
    oh3 = (jnp.arange(3) == v3[..., None]).astype(jnp.float32)
    v_shift = jnp.mod(cell_id, 6)
    oh6 = (jnp.arange(6) == v_shift[..., None]).astype(jnp.float32)

    P, K72 = _pbch_sel_mats(normal_cp)
    Pj, Kj = jnp.asarray(P), jnp.asarray(K72)
    grid = (slot1[0][..., :4, :].reshape(slot1[0].shape[:-2] + (288,)),
            slot1[1][..., :4, :].reshape(slot1[1].shape[:-2] + (288,)))
    # used REs for all 3 v3 hypotheses at once, collapsed by the one-hot
    # (DEFAULT (TF32) precision: within LLR_RTOL of f64, chip_smoke)
    y = (jnp.einsum("...k,vke,...v->...e", grid[0], Pj, oh3),
         jnp.einsum("...k,vke,...v->...e", grid[1], Pj, oh3))  # pair [E]
    h = []
    for p in range(4):
        hp = _chest_port(slot1, cell_id, 1, p, normal_cp, oh6=oh6)
        h.append((jnp.einsum("...k,vke,...v->...e", hp[0], Kj, oh3),
                  jnp.einsum("...k,vke,...v->...e", hp[1], Kj, oh3)))

    e_bits = E_BITS[normal_cp]
    d_hyp = [(_equalize(y, h, p)) for p in (1, 2, 4)]
    # LLRs: interleave re/im per RE -> [3 ports, e_bits]
    llr = jnp.stack([jnp.stack([d[0], d[1]], axis=-1).reshape(e_bits)
                     for d in d_hyp])

    signs = _gold_signs(scrambling.pbch_c_init(cell_id), 4 * e_bits)
    signs_q = signs.reshape(4, e_bits)
    M = jnp.asarray(_dematch_onehot(normal_cp))                 # [4, e, 120]
    # DEFAULT (TF32) precision: within LLR_RTOL of f64 (chip_smoke)
    return jnp.einsum("pe,qe,qek->pqk", llr, signs_q, M)


def codeword_search(llrs: jnp.ndarray, port_masks: jnp.ndarray):
    """Viterbi + CRC/port-mask check over H codeword hypotheses.

    llrs:       [H, 120] accumulated LLRs, stream-major [d0(40),d1(40),d2(40)]
    port_masks: [H, 16] CRC xor-mask bits per hypothesis
    returns dict: bits [H, 40], crc_ok [H], metric [H]
    """
    h = llrs.shape[0]
    # the trellis consumes step-major triplets [40, 3]
    r = jnp.transpose(llrs.reshape(h, 3, 40), (0, 2, 1))
    bits, metric = viterbi_decode_wa(r)                         # [H, 40]

    C = jnp.asarray(_crc_matrix())
    payload = bits[:, :24].astype(jnp.float32)
    # DEFAULT precision is exact: 0/1 operands, sums <= 24, f32 accumulate
    crc_calc = jnp.mod(payload @ C.T, 2.0)
    expect = jnp.mod(crc_calc + port_masks, 2.0)
    crc_ok = jnp.all(expect.astype(jnp.int32) == bits[:, 24:], axis=-1)
    return {"bits": bits, "crc_ok": crc_ok, "metric": metric}


def _unpack_fields(bits):
    """[..., 24] payload bits -> traced MIB fields."""
    bw = bits[..., 0] * 4 + bits[..., 1] * 2 + bits[..., 2]
    prb_tab = jnp.asarray(list(NOF_PRB_TABLE) + [0, 0], dtype=jnp.int32)
    nof_prb = prb_tab[jnp.clip(bw, 0, 7)]
    phich_ext = bits[..., 3]
    phich_res = bits[..., 4] * 2 + bits[..., 5]
    sfn = jnp.zeros(bits.shape[:-1], dtype=jnp.int32)
    for i in range(8):
        sfn = (sfn << 1) | bits[..., 6 + i]
    # 36.331 6.2.2: the MIB's 10 spare bits are transmitted as zeros.
    # srsLTE accepts any spare value (CRC-only gate); requiring zeros here
    # cuts the CRC-collision false-publish rate by 2^10 — measured at ~7
    # junk cells per 100 noisy 80 ms exposures without it (the randomized
    # sharded-vs-continuous property test found them).
    spare_zero = jnp.all(bits[..., 14:24] == 0, axis=-1)
    return {"nof_prb": nof_prb.astype(jnp.int32),
            "bw_valid": (bw < 6) & spare_zero,
            "phich_ext": phich_ext.astype(jnp.int32),
            "phich_res": phich_res.astype(jnp.int32),
            "sfn_offset": (sfn << 2).astype(jnp.int32)}


def _contrib_cond(subframe: cplx.Pair, cell_id, normal_cp) -> jnp.ndarray:
    """[3, 4, 120] quarter LLRs with the CP hypothesis behind a lax.cond:
    with a scalar (non-vmapped) normal_cp only the taken branch executes,
    halving the OFDM/chest/equalize work vs evaluating both CPs."""
    return jax.lax.cond(
        normal_cp,
        lambda sf: pbch_quarter_llrs(sf, cell_id, True),
        lambda sf: pbch_quarter_llrs(sf, cell_id, False),
        subframe)


def _search_and_unpack(llrs12: jnp.ndarray, quarter_of: jnp.ndarray):
    """Shared tail: 12-hypothesis codeword search -> result scalars.

    llrs12:     [12, 120] hypothesis-major LLRs (index = port * 4 + j)
    quarter_of: [12] int32 -> reported `quarter` for each hypothesis index
    """
    masks = jnp.repeat(jnp.asarray(_crc_masks()), 4, axis=0)     # [12, 16]
    res = codeword_search(llrs12, masks)

    fields = _unpack_fields(res["bits"][:, :24])
    ok = res["crc_ok"] & fields["bw_valid"]
    # first-hit priority in (ports, quarter) order, like srsLTE's search loop
    prio = jnp.where(ok, jnp.arange(12, 0, -1), 0)
    best = jnp.argmax(prio).astype(jnp.int32)
    found = jnp.any(ok)

    ports_tab = jnp.asarray([1, 1, 1, 1, 2, 2, 2, 2, 4, 4, 4, 4],
                            dtype=jnp.int32)
    return {
        "found": found,
        "nof_prb": fields["nof_prb"][best],
        "nof_ports": ports_tab[best],
        "phich_ext": fields["phich_ext"][best],
        "phich_res": fields["phich_res"][best],
        "sfn_offset": fields["sfn_offset"][best],
        "quarter": quarter_of[best],
        "metric": res["metric"][best],
    }


def quarter_llrs_both_cp(slot1_td: cplx.Pair, cell_id) -> jnp.ndarray:
    """[2, 3, 4, 120]: quarter LLR contributions under both CP hypotheses
    (index 0 = Extended, 1 = Normal) — the batched-candidate post-pass shape,
    where the CP is a traced per-candidate value so both static pipelines run
    and the caller selects."""
    e = pbch_quarter_llrs_slot1(slot1_td, cell_id, False)
    n = pbch_quarter_llrs_slot1(slot1_td, cell_id, True)
    return jnp.stack([e, n])


def search_and_unpack(llrs12: jnp.ndarray, quarter_of: jnp.ndarray):
    """Public alias of the 12-hypothesis codeword search (see
    _search_and_unpack); vmap-friendly for batched candidate decoding."""
    return _search_and_unpack(llrs12, quarter_of)


def mib_decode(subframe: cplx.Pair, cell_id: jnp.ndarray,
               normal_cp: jnp.ndarray):
    """Stateless single-subframe MIB decode attempt.

    subframe:  pair of [1920] float32 (aligned: subframe 0 candidate)
    cell_id:   int32 traced
    normal_cp: bool traced (selects which CP hypothesis runs; scalar -> only
               that branch executes)

    returns dict of scalars:
      found (bool), nof_prb, nof_ports, phich_ext, phich_res, sfn_offset,
      quarter, metric
    """
    contrib = _contrib_cond(subframe, cell_id, normal_cp)       # [3, 4, 120]
    return _search_and_unpack(contrib.reshape(12, 120),
                              jnp.mod(jnp.arange(12, dtype=jnp.int32), 4))


def mib_combine_decode(subframe: cplx.Pair, cell_id: jnp.ndarray,
                       normal_cp: jnp.ndarray, llr_acc: jnp.ndarray,
                       n: jnp.ndarray):
    """MIB decode with soft-combining across the 40 ms PBCH TTI.

    The capability the reference gets from srslte_ue_mib_decode's internal
    frame buffer (lib/mib_impl.cc:75-76,162; srsLTE pbch.c combines up to 4
    frames), recast fixed-shape: 4 TTI-phase hypotheses are carried as an
    accumulator axis.  Under phase h, the subframe-0 attempt number n is
    quarter q = (n + h) mod 4 of a TTI; at q == 0 that phase's accumulator
    restarts (new TTI = new codeword — SFN field changes), otherwise the
    contribution adds.  Phase h = (-n) mod 4 always restarts fresh, so one
    hypothesis per attempt equals the stateless single-subframe decode:
    combining can only add sensitivity, never lose a stateless detection.

    subframe:  pair of [1920] float32 (subframe-0 candidate, sub5 gated out
               by the caller using the SSS m0/m1 order)
    llr_acc:   [12, 120] float32 accumulator, index = port * 4 + phase
    n:         int32 — attempts combined so far for this cell

    returns: (llr_acc_new [12, 120], result dict like mib_decode)
    """
    contrib = _contrib_cond(subframe, cell_id, normal_cp)       # [3, 4, 120]
    q = jnp.mod(n + jnp.arange(4, dtype=jnp.int32), 4)          # [4] per phase
    sel = jnp.take(contrib, q, axis=1)                          # [3, 4(h), 120]
    acc = llr_acc.reshape(3, 4, 120)
    acc_new = jnp.where((q == 0)[None, :, None], sel, acc + sel)
    res = _search_and_unpack(acc_new.reshape(12, 120),
                             jnp.tile(q, 3))
    return acc_new.reshape(12, 120), res
