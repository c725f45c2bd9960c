"""Primary Synchronization Signal (PSS) sequence generation.

Builds the three Zadoff-Chu PSS replicas (3GPP 36.211 6.11.1.1) in both the
frequency domain (62 occupied subcarriers) and the time domain (128-sample
symbol at the 1.92 Msps sensing rate).  These replace the replicas srsLTE
builds inside srslte_pss_init (reference: lib/pss_impl.cc:72-76 delegates to
srsLTE; here the math is first-party and precomputed as numpy constants so the
device correlator consumes them as static weights).
"""

import functools

import numpy as np

from .constants import PSS_LEN, PSS_ZC_ROOTS, SYMBOL_SZ, N_ID_2_COUNT


def zadoff_chu(root: int) -> np.ndarray:
    """Length-62 PSS Zadoff-Chu sequence d_u(n) for the given root."""
    n1 = np.arange(31)
    n2 = np.arange(31, 62)
    d = np.empty(PSS_LEN, dtype=np.complex128)
    d[:31] = np.exp(-1j * np.pi * root * n1 * (n1 + 1) / 63.0)
    d[31:] = np.exp(-1j * np.pi * root * (n2 + 1) * (n2 + 2) / 63.0)
    return d


def subcarrier_bins(fft_size: int = SYMBOL_SZ) -> np.ndarray:
    """FFT bin index for each of the 62 sync-signal subcarriers.

    Subcarrier i in [0, 62): i < 31 maps to negative frequencies
    (bins fft_size-31 .. fft_size-1), i >= 31 to positive (bins 1 .. 31).
    DC (bin 0) is unused.
    """
    bins = np.empty(PSS_LEN, dtype=np.int64)
    bins[:31] = fft_size - 31 + np.arange(31)
    bins[31:] = 1 + np.arange(31)
    return bins


@functools.lru_cache(maxsize=None)
def _replicas(fft_size: int):
    freq = np.zeros((N_ID_2_COUNT, fft_size), dtype=np.complex128)
    bins = subcarrier_bins(fft_size)
    for i, root in enumerate(PSS_ZC_ROOTS):
        freq[i, bins] = zadoff_chu(root)
    time = np.fft.ifft(freq, axis=-1)
    # Unit-energy normalization: PSR is scale-invariant but CFO half-symbol
    # correlations benefit from a sane scale.
    time /= np.linalg.norm(time, axis=-1, keepdims=True)
    return freq, time


def pss_freq(fft_size: int = SYMBOL_SZ) -> np.ndarray:
    """[3, fft_size] complex128 frequency-domain PSS replicas (on FFT grid)."""
    return _replicas(fft_size)[0].copy()


def pss_time(fft_size: int = SYMBOL_SZ) -> np.ndarray:
    """[3, fft_size] complex128 unit-energy time-domain PSS replicas."""
    return _replicas(fft_size)[1].copy()


def pss_freq_occupied() -> np.ndarray:
    """[3, 62] complex128 PSS values on the occupied subcarriers only."""
    return np.stack([zadoff_chu(r) for r in PSS_ZC_ROOTS])
