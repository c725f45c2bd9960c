"""128-point DFT as dense matmuls (in place of every FFT).

The OFDM symbol size at the sensing rate is fixed at 128 (ltecore constants),
so each demodulation is a [*, 128] @ [128, K] matmul against a precomputed
DFT matrix.  Subcarrier selection and reordering
are folded into the matrix (we only ever need the 62 sync subcarriers or the
72 PBCH subcarriers), so "FFT + gather" becomes one [62|72, 128] matmul.
"""

import functools

import numpy as np

from ..ltecore import pss as pssmod
from ..ltecore.constants import SYMBOL_SZ
from . import cplx


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int = SYMBOL_SZ):
    """Full [n, n] DFT matrix as a float32 (re, im) pair of numpy arrays."""
    k = np.arange(n)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return cplx.const(W)


@functools.lru_cache(maxsize=None)
def dft_sync62():
    """[62, 128]: DFT rows for the sync-signal subcarriers, already in
    sequence order (-31..-1, +1..+31)."""
    re, im = dft_matrix()
    bins = pssmod.subcarrier_bins()
    return re[bins], im[bins]


@functools.lru_cache(maxsize=None)
def dft_pbch72():
    """[72, 128]: DFT rows for the 6-PRB grid (subcarriers -36..-1, +1..+36)."""
    re, im = dft_matrix()
    bins = np.concatenate([np.arange(SYMBOL_SZ - 36, SYMBOL_SZ),
                           np.arange(1, 37)])
    return re[bins], im[bins]


def dft_sync(x: cplx.Pair) -> cplx.Pair:
    """[..., 128] time pair -> [..., 62] sync subcarriers."""
    import jax.numpy as jnp
    re, im = dft_sync62()
    # DEFAULT (TF32) precision: within DEMOD_RTOL of f64 (chip_smoke)
    return cplx.matmul_real_pair(jnp.asarray(re), jnp.asarray(im), x)


def dft_grid(x: cplx.Pair) -> cplx.Pair:
    """[..., 128] time pair -> [..., 72] PBCH-grid subcarriers."""
    import jax.numpy as jnp
    re, im = dft_pbch72()
    # DEFAULT (TF32) precision: within DEMOD_RTOL of f64 (chip_smoke)
    return cplx.matmul_real_pair(jnp.asarray(re), jnp.asarray(im), x)
