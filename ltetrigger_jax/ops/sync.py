"""CP detection and SSS decoding (jitted, real-pair).

Replaces srslte_sync_detect_cp + srslte_sss_m0m1_partial + srslte_sss_N_id_1
(reference lib/sss_impl.cc:104-124).  Fixed shape: both CP hypotheses are
evaluated unconditionally (no branches), the SSS symbol is demodulated by a
[62, 128] DFT matmul, and the m0/m1 search is two [31]x[31,31] matmuls
against static cyclic-shift banks.
"""

import functools

import jax.numpy as jnp
import numpy as np

from ..ltecore import sss as sssmod
from ..ltecore.constants import CP_EXT, CP_NORM, SLOT_LENGTH, SYMBOL_SZ
from . import cplx, dft

# srsLTE correlates the SSS m-sequences in 3 sub-segments summed
# noncoherently (srslte_sss_m0m1_partial(..., 3, ...), reference
# lib/sss_impl.cc:112): phase coherence is only required within ~10
# subcarriers, making the search robust to the inter-subcarrier phase ramp
# left by residual timing error / CFO between acquisition and correction.
SSS_SECTIONS = 3


@functools.lru_cache(maxsize=None)
def _section_banks(sections: int) -> np.ndarray:
    """[31, sections * 31] float32: column s*31+m holds section s of the
    m-th cyclic shift of s_tilde (zeros outside the section)."""
    S = sssmod.shift_bank()                      # [31(m), 31(k)]
    bank = np.zeros((31, sections * 31), dtype=np.float32)
    bounds = np.linspace(0, 31, sections + 1).astype(int)
    for s in range(sections):
        lo, hi = bounds[s], bounds[s + 1]
        bank[lo:hi, s * 31:(s + 1) * 31] = S.T[lo:hi]
    return bank


def _partial_corr_metric(y: cplx.Pair, sections: int) -> jnp.ndarray:
    """[..., 31] noncoherent sum over sections of |segment correlation|^2.

    y: pair of [..., 31] descrambled subcarriers.
    """
    bank = jnp.asarray(_section_banks(sections))
    # DEFAULT (TF32) precision: SSS ids exact (chip_smoke)
    c = cplx.matmul_pair_real(y, bank)           # pair [..., sections*31]
    power = cplx.abs2(c)
    return jnp.sum(power.reshape(power.shape[:-1] + (sections, 31)), axis=-2)


def detect_cp(aligned: cplx.Pair, end: int = SLOT_LENGTH) -> jnp.ndarray:
    """bool (True = Normal CP) from the 2 symbols preceding the PSS.

    aligned: pair of [..., >=end] float32 — a slot-0 tail whose last sample
    is the slot boundary, PSS data at [end-128, end).  With the default
    `end` this is a whole peak-aligned slot; the grid engine passes a
    shorter tail segment (trigger.SEG).
    """
    def score(cp: int):
        shape = aligned[0].shape[:-1]
        num = cplx.zeros(shape)
        den = jnp.full(shape, 1e-30, dtype=jnp.float32)
        pos = end - SYMBOL_SZ
        for _ in range(2):
            pos -= SYMBOL_SZ + cp
            c = cplx.index(aligned, (..., slice(pos - cp, pos)))
            t = cplx.index(aligned,
                           (..., slice(pos + SYMBOL_SZ - cp, pos + SYMBOL_SZ)))
            num = cplx.add(num, cplx.dot_conj_sum(c, t))
            den = den + 0.5 * (jnp.sum(cplx.abs2(c), axis=-1)
                               + jnp.sum(cplx.abs2(t), axis=-1))
        return jnp.sqrt(cplx.abs2(num)) / den

    return score(CP_NORM) >= score(CP_EXT)


def sss_decode(aligned: cplx.Pair, n_id_2: jnp.ndarray,
               normal_cp: jnp.ndarray, sections: int = SSS_SECTIONS,
               end: int = SLOT_LENGTH):
    """SSS -> (n_id_1 [..., int32, -1 invalid], subframe5 [..., bool]).

    aligned:   pair of [..., >=end] — slot-0 samples whose index `end` is
               the slot boundary (a whole aligned slot by default, or the
               grid engine's tail segment)
    n_id_2:    [...] int32 root index per batch element
    normal_cp: [...] bool (selects the SSS symbol position)
    sections:  m-sequence correlation sub-segments summed noncoherently
               (3 = srsLTE's m0m1_partial default; 1 = full coherent)
    """
    cs = jnp.asarray(sssmod.c_scramble())         # [3, 2, 31]
    zb = jnp.asarray(sssmod.z_bank())             # [8, 31]
    tab = jnp.asarray(sssmod.nid1_table())        # [31, 31]

    idx_norm = end - 2 * SYMBOL_SZ - CP_NORM
    idx_ext = end - 2 * SYMBOL_SZ - CP_EXT
    sym_n = cplx.index(aligned, (..., slice(idx_norm, idx_norm + SYMBOL_SZ)))
    sym_e = cplx.index(aligned, (..., slice(idx_ext, idx_ext + SYMBOL_SZ)))
    sym = cplx.where(normal_cp[..., None], sym_n, sym_e)

    y = dft.dft_sync(sym)                         # pair of [..., 62]
    c0 = cs[n_id_2, 0]                            # [..., 31]
    c1 = cs[n_id_2, 1]
    even = cplx.index(y, (..., slice(0, None, 2)))
    odd = cplx.index(y, (..., slice(1, None, 2)))

    ce = cplx.scale(even, c0)                     # descramble (real +-1)
    m0 = jnp.argmax(_partial_corr_metric(ce, sections),
                    axis=-1).astype(jnp.int32)
    z = zb[m0 % 8]
    co = cplx.scale(odd, c1 * z)
    m1 = jnp.argmax(_partial_corr_metric(co, sections),
                    axis=-1).astype(jnp.int32)

    direct = tab[m0, m1]
    swapped = tab[m1, m0]
    n_id_1 = jnp.where(direct >= 0, direct, swapped).astype(jnp.int32)
    subframe5 = (direct < 0) & (swapped >= 0)
    return n_id_1, subframe5
