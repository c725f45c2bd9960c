"""PSS matched filtering as direct convolution / dense matmul.

The reference's hot loop is srslte_pss_find_pss, an FFTW overlap-add complex
convolution per N_id_2 chain (lib/pss_impl.cc:165, SURVEY §3.2).  Here a
128-tap matched filter over a 9600-sample half-frame is a dense [2-in,
6-out, 128-wide] real convolution (or the blocked-Toeplitz matmul below).
All three N_id_2 hypotheses are output channels of ONE conv; channels batch
on the leading dim.

Complex correlation by real parts (x = xr + j xi, replica r):
    c[n]   = sum_k x[n+k] * conj(r[k])
    re(c)  = xr (*) rr + xi (*) ri          ((*) = sliding correlation)
    im(c)  = xi (*) rr - xr (*) ri
so the conv kernel is [out=6, in=2, w=128] with rows
    out 2t   (re of root t):  [ rr_t,  ri_t ]
    out 2t+1 (im of root t):  [-ri_t,  rr_t ]
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ltecore import pss as pssmod
from ..ltecore.constants import HALF_FRAME_LENGTH, SYMBOL_SZ
from . import cplx

SEARCH_LEN = HALF_FRAME_LENGTH                   # 9600 candidate starts
WINDOW_LEN = HALF_FRAME_LENGTH + SYMBOL_SZ - 1   # samples the filter reads
N_ROOTS = 3


@functools.lru_cache(maxsize=None)
def _kernel() -> np.ndarray:
    """[6, 2, 128] float32 conv kernel for all three roots."""
    rr, ri = cplx.const(pssmod.pss_time())       # each [3, 128]
    k = np.zeros((2 * N_ROOTS, 2, SYMBOL_SZ), dtype=np.float32)
    for t in range(N_ROOTS):
        k[2 * t, 0] = rr[t]
        k[2 * t, 1] = ri[t]
        k[2 * t + 1, 0] = -ri[t]
        k[2 * t + 1, 1] = rr[t]
    return k


def pss_correlate_power(window: cplx.Pair) -> jnp.ndarray:
    """|corr|^2 for all 3 roots over windows.

    window: pair of [..., >=WINDOW_LEN] float32
    returns: [..., 3, SEARCH_LEN] float32
    """
    wr, wi = window
    batch_shape = wr.shape[:-1]
    x = jnp.stack([wr[..., :WINDOW_LEN], wi[..., :WINDOW_LEN]], axis=-2)
    x = x.reshape((-1, 2, WINDOW_LEN))                        # [B, 2, W]
    y = jax.lax.conv_general_dilated(
        x, jnp.asarray(_kernel()), window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32)                   # [B, 6, 9600]
    y = y.reshape(batch_shape + (N_ROOTS, 2, SEARCH_LEN))
    return y[..., 0, :] ** 2 + y[..., 1, :] ** 2


# ----------------------------------------------------------------------
# v2: blocked-Toeplitz matmul formulation.
#
# Split the window into non-overlapping 128-sample blocks X[j].  For output
# positions p in block j:
#     c[128 j + p] = sum_k x[128 j + p + k] w[k]
#                  = X[j]   @ WL[:, p]   (taps that stay in block j)
#                  + X[j+1] @ WU[:, p]   (taps that spill into block j+1)
# with static banded-triangular weights WL[q, p] = w[q - p] (q >= p) and
# WU[q, p] = w[q + 128 - p] (q < p).  Stacking {3 roots} x {re/im out} x
# {re/im in} into the weight matrices turns the whole correlation into TWO
# dense [75, 256] @ [256, 768] matmuls per window, with no im2col gather
# and no FFT.
# ----------------------------------------------------------------------
V2_WINDOW = HALF_FRAME_LENGTH + SYMBOL_SZ        # 9728 samples read


@functools.lru_cache(maxsize=None)
def _toeplitz_weights_fat():
    """[512, 768] float32: the grid engine's one-matmul weight bank.

    Contraction axis: [x0_re | x0_im | x1_re | x1_im] (x1 = x0 shifted one
    128-block).  Output axis COMP-MAJOR: [comp, root, p] — so the
    square-accumulate runs on two contiguous 384-column halves instead of
    stride-128 interleaves, and the four dots fuse into one K=512
    matmul."""
    WL, WU = _toeplitz_weights()
    def cm(W):
        W5 = W.reshape(2, SYMBOL_SZ, N_ROOTS, 2, SYMBOL_SZ)
        return np.ascontiguousarray(
            np.moveaxis(W5, 3, 2).reshape(256, 768))
    return np.concatenate([cm(WL), cm(WU)], axis=0)


@functools.lru_cache(maxsize=None)
def _toeplitz_weights(cfo_bin: int = 0):
    """(WL, WU): [256, 768] float32 each.

    Contraction axis: [x_re block (128), x_im block (128)].
    Output axis: [root, comp, p] flattened as root * 256 + comp * 128 + p
    with comp 0 = re, 1 = im.

    cfo_bin != 0 builds the bank for replicas shifted by that many integer
    subcarrier spacings (replica_b[n] = rep[n] * exp(2j*pi*b*n/128)) — the
    srsLTE cfo_i-style integer-CFO search as extra filter banks.
    """
    reps = pssmod.pss_time()                     # [3, 128] complex
    if cfo_bin:
        n = np.arange(SYMBOL_SZ)
        reps = reps * np.exp(2j * np.pi * cfo_bin * n / SYMBOL_SZ)
    rr, ri = cplx.const(reps)                    # [3, 128]
    WL = np.zeros((2, 128, N_ROOTS, 2, 128), dtype=np.float32)
    WU = np.zeros((2, 128, N_ROOTS, 2, 128), dtype=np.float32)
    q = np.arange(128)
    for t in range(N_ROOTS):
        for p in range(128):
            lo = q >= p            # tap index k = q - p in [0, 128)
            hi = q < p             # tap index k = q + 128 - p
            # re(c) = x_re*w_re + x_im*w_im ; im(c) = x_im*w_re - x_re*w_im
            WL[0, lo, t, 0, p] = rr[t][q[lo] - p]
            WL[1, lo, t, 0, p] = ri[t][q[lo] - p]
            WL[0, lo, t, 1, p] = -ri[t][q[lo] - p]
            WL[1, lo, t, 1, p] = rr[t][q[lo] - p]
            WU[0, hi, t, 0, p] = rr[t][q[hi] + 128 - p]
            WU[1, hi, t, 0, p] = ri[t][q[hi] + 128 - p]
            WU[0, hi, t, 1, p] = -ri[t][q[hi] + 128 - p]
            WU[1, hi, t, 1, p] = rr[t][q[hi] + 128 - p]
    return (WL.reshape(256, N_ROOTS * 256),
            WU.reshape(256, N_ROOTS * 256))


def pss_correlate_power_v2(window: cplx.Pair,
                           matmul_dtype=jnp.float32) -> jnp.ndarray:
    """Same contract as pss_correlate_power, via blocked-Toeplitz matmuls.

    window: pair of [..., >= V2_WINDOW] float32
    returns: [..., 3, SEARCH_LEN] float32
    """
    wr, wi = window
    batch = wr.shape[:-1]
    nblk = HALF_FRAME_LENGTH // SYMBOL_SZ            # 75
    x0 = jnp.concatenate(
        [wr[..., :HALF_FRAME_LENGTH].reshape(batch + (nblk, SYMBOL_SZ)),
         wi[..., :HALF_FRAME_LENGTH].reshape(batch + (nblk, SYMBOL_SZ))],
        axis=-1)                                     # [..., 75, 256]
    x1 = jnp.concatenate(
        [wr[..., SYMBOL_SZ:V2_WINDOW].reshape(batch + (nblk, SYMBOL_SZ)),
         wi[..., SYMBOL_SZ:V2_WINDOW].reshape(batch + (nblk, SYMBOL_SZ))],
        axis=-1)
    WL, WU = _toeplitz_weights()
    c = jnp.dot(x0.astype(matmul_dtype),
                jnp.asarray(WL).astype(matmul_dtype),
                preferred_element_type=jnp.float32) \
        + jnp.dot(x1.astype(matmul_dtype),
                  jnp.asarray(WU).astype(matmul_dtype),
                  preferred_element_type=jnp.float32)  # [..., 75, 768]
    c = c.reshape(batch + (nblk, N_ROOTS, 2, SYMBOL_SZ))
    power = c[..., 0, :] ** 2 + c[..., 1, :] ** 2    # [..., 75, 3, 128]
    return jnp.moveaxis(power, -3, -2).reshape(batch + (N_ROOTS, SEARCH_LEN))


def pss_correlate_power_fast(window: cplx.Pair) -> jnp.ndarray:
    """v2 with bf16 matmul inputs (f32 accumulation).

    Peak positions match an f64 correlation; PSR agrees within the
    tolerance chip_smoke.py phase 2 states and checks on the device.
    """
    return pss_correlate_power_v2(window, matmul_dtype=jnp.bfloat16)


def pss_correlate_power_cfo_bins(window: cplx.Pair, bins=(-2, -1, 0, 1, 2),
                                 matmul_dtype=jnp.bfloat16) -> jnp.ndarray:
    """Correlation power against integer-CFO-shifted replica banks.

    Detects cells whose carrier offset exceeds the matched filter's
    tolerance (~0.3 subcarrier): every bin is just more output channels of
    the same blocked-Toeplitz matmul.

    window: pair of [..., >= V2_WINDOW] float32
    returns: [..., len(bins), 3, SEARCH_LEN] float32
    """
    wr, wi = window
    batch = wr.shape[:-1]
    nblk = HALF_FRAME_LENGTH // SYMBOL_SZ
    x0 = jnp.concatenate(
        [wr[..., :HALF_FRAME_LENGTH].reshape(batch + (nblk, SYMBOL_SZ)),
         wi[..., :HALF_FRAME_LENGTH].reshape(batch + (nblk, SYMBOL_SZ))],
        axis=-1)
    x1 = jnp.concatenate(
        [wr[..., SYMBOL_SZ:V2_WINDOW].reshape(batch + (nblk, SYMBOL_SZ)),
         wi[..., SYMBOL_SZ:V2_WINDOW].reshape(batch + (nblk, SYMBOL_SZ))],
        axis=-1)
    WL = np.concatenate([_toeplitz_weights(b)[0] for b in bins], axis=1)
    WU = np.concatenate([_toeplitz_weights(b)[1] for b in bins], axis=1)
    c = jnp.dot(x0.astype(matmul_dtype),
                jnp.asarray(WL).astype(matmul_dtype),
                preferred_element_type=jnp.float32) \
        + jnp.dot(x1.astype(matmul_dtype),
                  jnp.asarray(WU).astype(matmul_dtype),
                  preferred_element_type=jnp.float32)
    c = c.reshape(batch + (nblk, len(bins), N_ROOTS, 2, SYMBOL_SZ))
    power = c[..., 0, :] ** 2 + c[..., 1, :] ** 2
    # [..., nblk, bins, roots, 128] -> [..., bins, roots, SEARCH_LEN]
    power = jnp.moveaxis(power, -4, -2)
    return power.reshape(batch + (len(bins), N_ROOTS, SEARCH_LEN))


def pss_correlate_power_diag(window: cplx.Pair,
                             matmul_dtype=jnp.bfloat16) -> jnp.ndarray:
    """Per-root correlation: window lane r against root r ONLY.

    The trigger state machine keeps one stream position per N_id_2 root
    (SURVEY §2.3's three parallel pss chains), so its per-step batch is
    [R=3] windows of which lane r only ever consults root r.  Correlating
    each lane against all 3 roots and taking the diagonal (the original
    formulation) does 3x the matmul work and writes 3x the correlation power;
    this computes just the diagonal.

    window: pair of [..., 3, >= V2_WINDOW] float32
    returns: [..., 3, SEARCH_LEN] float32
    """
    wr, wi = window
    batch = wr.shape[:-1]                            # [..., 3]
    nblk = HALF_FRAME_LENGTH // SYMBOL_SZ
    x0 = jnp.concatenate(
        [wr[..., :HALF_FRAME_LENGTH].reshape(batch + (nblk, SYMBOL_SZ)),
         wi[..., :HALF_FRAME_LENGTH].reshape(batch + (nblk, SYMBOL_SZ))],
        axis=-1)                                     # [..., 3, 75, 256]
    x1 = jnp.concatenate(
        [wr[..., SYMBOL_SZ:V2_WINDOW].reshape(batch + (nblk, SYMBOL_SZ)),
         wi[..., SYMBOL_SZ:V2_WINDOW].reshape(batch + (nblk, SYMBOL_SZ))],
        axis=-1)
    WLn, WUn = _toeplitz_weights()                   # [256, 768]
    WL = np.stack([WLn[:, r * 256:(r + 1) * 256] for r in range(N_ROOTS)])
    WU = np.stack([WUn[:, r * 256:(r + 1) * 256] for r in range(N_ROOTS)])
    c = jnp.einsum("...rbk,rko->...rbo",
                   x0.astype(matmul_dtype),
                   jnp.asarray(WL).astype(matmul_dtype),
                   preferred_element_type=jnp.float32) \
        + jnp.einsum("...rbk,rko->...rbo",
                     x1.astype(matmul_dtype),
                     jnp.asarray(WU).astype(matmul_dtype),
                     preferred_element_type=jnp.float32)  # [..., 3, 75, 256]
    c = c.reshape(batch + (nblk, 2, SYMBOL_SZ))
    power = c[..., 0, :] ** 2 + c[..., 1, :] ** 2    # [..., 3, 75, 128]
    return power.reshape(batch + (SEARCH_LEN,))


import os as _os  # noqa: E402

# LTETRIGGER_CORRELATOR semantics since the round-3 grid engine: the hot
# path (models/trigger pass A) always uses the blocked-Toeplitz formulation
# and honours the env var as a PRECISION toggle ("fast" = bf16 matmul
# inputs, shipped default; anything else = f32).  The conv formulation
# ("v1") remains the independent cross-check used by the golden tests and
# by these standalone entry points.
_IMPLS = {"fast": pss_correlate_power_fast,
          "v2": pss_correlate_power_v2,
          "v1": pss_correlate_power}
default_power = _IMPLS[_os.environ.get("LTETRIGGER_CORRELATOR", "fast")]


def default_power_diag(window: cplx.Pair) -> jnp.ndarray:
    """Per-root correlator honoring LTETRIGGER_CORRELATOR like
    `default_power`: "fast" -> bf16 blocked-Toeplitz diag, "v2" -> f32
    blocked-Toeplitz diag, "v1" -> the conv formulation (each lane
    correlated against all roots, diagonal taken).  Round 2's trigger hot
    path; the round-3 grid engine correlates one shared window per step
    instead (see models/trigger._group_power), so this survives for
    cross-checks and external callers.

    window: pair of [..., 3, >= V2_WINDOW]; returns [..., 3, SEARCH_LEN].
    """
    impl = _os.environ.get("LTETRIGGER_CORRELATOR", "fast")
    if impl == "v1":
        full = pss_correlate_power(window)       # [..., lane, root, S]
        r = jnp.arange(N_ROOTS)
        return full[..., r, r, :]
    dtype = jnp.bfloat16 if impl == "fast" else jnp.float32
    return pss_correlate_power_diag(window, matmul_dtype=dtype)


def peak_and_psr_blocked(power: jnp.ndarray, lobe_limit: int = 64):
    """peak_and_psr on BLOCK-structured power [..., 75, R, 128] — the
    layout pass A produces naturally, in TWO full-resolution passes.

    The round-4 formulation (_peak_and_psr_blocked_multipass below, kept
    as the golden cross-check) made ~5 full passes over the power tensor
    per step — rise masks, edge scans and the sidelobe max each re-read
    all 75*R*128 elements.  Here the full tensor is touched only for
    (a) per-block max/argmax and (b) ONE exact 0/1 one-hot selection of
    the peak's 3-block neighborhood (HIGHEST precision: a rounded `hood`
    would move the rise/lobe walk); every lobe element is within +-64 of
    the peak, so the rise/edge/lobe logic runs on [.., R, 384] tensors and
    the out-of-neighborhood sidelobe comes from the per-block maxima.
    Bit-identical to the flat version including argmax tie order and the
    stream-boundary duplicate-element rise semantics
    (tests/test_ops.py::test_peak_and_psr_blocked_variants).

    returns: (peak_pos int32 [..., R] in [0, 9600), psr float32 [..., R])
    """
    nb, nm = power.shape[-3], power.shape[-1]        # 75, 128
    assert lobe_limit <= nm // 2
    in_max = jnp.max(power, axis=-1)                 # [.., 75, R]
    in_arg = jnp.argmax(power, axis=-1).astype(jnp.int32)
    blk = jnp.argmax(jnp.moveaxis(in_max, -2, -1), axis=-1) \
        .astype(jnp.int32)                           # [.., R]
    m = jnp.take_along_axis(jnp.moveaxis(in_arg, -2, -1),
                            blk[..., None], axis=-1)[..., 0]
    peak = blk * nm + m
    pk_val = jnp.max(in_max, axis=-2)                # [.., R]

    nb0 = jnp.clip(blk - 1, 0, nb - 3)
    oh = (nb0[..., None, None] + jnp.arange(3, dtype=jnp.int32)[:, None]
          == jnp.arange(nb, dtype=jnp.int32)).astype(power.dtype)
    hood = jnp.einsum("...rjb,...brm->...rjm", oh, power,
                      precision=jax.lax.Precision.HIGHEST)
    hood = hood.reshape(hood.shape[:-2] + (3 * nm,))     # [.., R, 384]
    absi = nb0[..., None] * nm + jnp.arange(3 * nm, dtype=jnp.int32)
    rel = absi - peak[..., None]

    # duplicate-end rise semantics: the hood's far ends only matter when
    # they coincide with the stream's ends, where duplicate-self is the
    # flat behavior; interior hood ends sit at |rel| >= 128 > lobe_limit
    shifted = jnp.concatenate([hood[..., 1:], hood[..., -1:]], axis=-1)
    rise = shifted > hood
    right_edge = jnp.min(
        jnp.where((rel >= 1) & (rel <= lobe_limit) & rise, rel,
                  lobe_limit), axis=-1)
    shiftedl = jnp.concatenate([hood[..., :1], hood[..., :-1]], axis=-1)
    risel = shiftedl > hood
    left_edge = jnp.min(
        jnp.where((-rel >= 1) & (-rel <= lobe_limit) & risel, -rel,
                  lobe_limit), axis=-1)
    in_lobe = (rel >= -left_edge[..., None]) & (rel <= right_edge[..., None])
    side_in = jnp.max(jnp.where(in_lobe, 0.0, hood), axis=-1)
    bidx = jnp.arange(nb, dtype=jnp.int32)
    out_blk = (bidx[..., None] < nb0[..., None, :]) \
        | (bidx[..., None] > nb0[..., None, :] + 2)      # [.., 75, R]
    side_out = jnp.max(jnp.where(out_blk, in_max, 0.0), axis=-2)
    psr = pk_val / jnp.maximum(jnp.maximum(side_in, side_out), 1e-30)
    return peak, psr.astype(jnp.float32)


def _peak_and_psr_blocked_multipass(power: jnp.ndarray,
                                    lobe_limit: int = 64):
    """The round-4 full-resolution formulation (golden cross-check)."""
    nb, nm = power.shape[-3], power.shape[-1]        # 75, 128
    # two-stage argmax == flat first-occurrence argmax
    in_max = jnp.max(power, axis=-1)                 # [.., 75, R]
    in_arg = jnp.argmax(power, axis=-1)              # [.., 75, R]
    blk = jnp.argmax(jnp.moveaxis(in_max, -2, -1), axis=-1)   # [.., R]
    m = jnp.take_along_axis(jnp.moveaxis(in_arg, -2, -1),
                            blk[..., None], axis=-1)[..., 0]
    peak = (blk * nm + m).astype(jnp.int32)
    pk_val = jnp.max(in_max, axis=-2)                # [.., R]

    # flattened index of every element, broadcast against [.., 75, R, 128]
    idx = (jnp.arange(nb, dtype=jnp.int32)[:, None, None] * nm
           + jnp.arange(nm, dtype=jnp.int32)[None, None, :])
    rel = idx - peak[..., None, :, None]             # [.., 75, R, 128]

    # next element in flat order: within-block shift; block boundary takes
    # the next block's first element; the very last element duplicates
    # itself (flat semantics: its "rise" is False)
    nxt_first = jnp.concatenate(
        [power[..., 1:, :, 0:1],
         power[..., nb - 1:nb, :, nm - 1:nm]], axis=-3)
    shifted = jnp.concatenate([power[..., 1:], nxt_first], axis=-1)
    rise = shifted > power
    right_cand = jnp.where((rel >= 1) & (rel <= lobe_limit) & rise,
                           rel, lobe_limit)
    right_edge = jnp.min(right_cand, axis=(-3, -1))  # [.., R]

    prv_last = jnp.concatenate(
        [power[..., 0:1, :, 0:1],
         power[..., :nb - 1, :, nm - 1:nm]], axis=-3)
    shiftedl = jnp.concatenate([prv_last, power[..., :-1]], axis=-1)
    risel = shiftedl > power
    left_cand = jnp.where((-rel >= 1) & (-rel <= lobe_limit) & risel,
                          -rel, lobe_limit)
    left_edge = jnp.min(left_cand, axis=(-3, -1))

    in_lobe = (rel >= -left_edge[..., None, :, None]) \
        & (rel <= right_edge[..., None, :, None])
    side = jnp.max(jnp.where(in_lobe, 0.0, power), axis=(-3, -1))
    psr = pk_val / jnp.maximum(side, 1e-30)
    return peak, psr.astype(jnp.float32)


def peak_and_psr(power: jnp.ndarray, lobe_limit: int = 64):
    """Peak position and peak-to-sidelobe ratio (power domain).

    Vectorized equivalent of srsLTE's compute_peak_sidelobe: walk down the
    main lobe on each side until the first rise (bounded by lobe_limit), then
    the sidelobe is the max outside the lobe.

    power: [..., SEARCH_LEN] float32
    returns: (peak_pos int32 [...], psr float32 [...])
    """
    n = power.shape[-1]
    peak = jnp.argmax(power, axis=-1).astype(jnp.int32)
    pk_val = jnp.take_along_axis(power, peak[..., None], axis=-1)[..., 0]

    idx = jnp.arange(n, dtype=jnp.int32)
    rel = idx - peak[..., None]

    # first rise to the right of the peak (p[i+1] > p[i]), bounded
    shifted = jnp.concatenate([power[..., 1:], power[..., -1:]], axis=-1)
    rise = shifted > power
    right_cand = jnp.where((rel >= 1) & (rel <= lobe_limit) & rise,
                           rel, lobe_limit)
    right_edge = jnp.min(right_cand, axis=-1)
    # first rise to the left
    shiftedl = jnp.concatenate([power[..., :1], power[..., :-1]], axis=-1)
    risel = shiftedl > power
    left_cand = jnp.where((-rel >= 1) & (-rel <= lobe_limit) & risel,
                          -rel, lobe_limit)
    left_edge = jnp.min(left_cand, axis=-1)

    in_lobe = (rel >= -left_edge[..., None]) & (rel <= right_edge[..., None])
    side = jnp.max(jnp.where(in_lobe, 0.0, power), axis=-1)
    psr = pk_val / jnp.maximum(side, 1e-30)
    return peak, psr.astype(jnp.float32)
