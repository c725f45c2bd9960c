"""Integer polyphase decimation to the 1.92 Msps sensing rate (jitted).

Replaces GNU Radio's rational_resampler_ccc (reference
examples/cell_search_file.py:56-57; integer ratios only, :50-54).  The
anti-alias FIR runs as a real-channel conv_general_dilated with window
stride = ratio; the IQ pair rides as two real feature channels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ltecore.refrx import design_lowpass
from . import cplx


@functools.lru_cache(maxsize=None)
def _taps(ratio: int, taps_per_phase: int = 16) -> np.ndarray:
    return design_lowpass(ratio, taps_per_phase).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rational_taps(up: int, down: int, taps_per_phase: int = 16) -> np.ndarray:
    """Anti-alias/anti-image filter for up/down rational resampling:
    windowed sinc at cutoff min(1/up, 1/down) of the upsampled rate,
    gain `up` (to compensate zero-stuffing energy loss)."""
    n = taps_per_phase * max(up, down)
    t = np.arange(n) - (n - 1) / 2
    cutoff = 1.0 / max(up, down)
    h = np.sinc(t * cutoff) * cutoff * np.hamming(n)
    return (up * h / h.sum()).astype(np.float32)


def rational_resample(x: cplx.Pair, up: int, down: int) -> cplx.Pair:
    """Rational-rate conversion by up/down (polyphase; jitted).

    Capability the reference explicitly refuses ("Arbitrary resampling not
    supported at this time", examples/cell_search_file.py:50-54): any
    rational input rate can now be brought to 1.92 Msps, e.g. 10 MHz via
    up=24, down=125.

    Implemented as zero-stuff -> anti-alias conv -> stride, with the
    zero-stuffing folded away by phase decomposition: output n comes from
    phase (n * down) % up of the filter applied at input offset
    (n * down) // up.  Runs as `up` strided convs batched over phases.
    """
    import math
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1:
        return decimate(x, down) if down > 1 else x

    h = _rational_taps(up, down)
    nt = len(h)
    lead = (nt - 1) // 2
    n_in = x[0].shape[-1]
    n_out = (n_in * up) // down
    batch_shape = x[0].shape[:-1]
    ntp = -(-nt // up)                           # taps per polyphase branch

    # Polyphase: y[n] = sum_k h[k] xs[n*down - lead + k] over the
    # zero-stuffed stream xs (xs[i] = x[i/up] iff i % up == 0).  Only taps
    # with k === (lead - n*down) mod up touch real samples, so each output
    # uses ntp = ceil(nt/up) taps of one filter branch:
    #   y[n] = sum_j h[k0 + up*j] * x[base + j],
    #   k0 = (lead - n*down) % up, base = (n*down - lead + k0) // up.
    xr = jnp.stack([x[0].reshape(-1, n_in), x[1].reshape(-1, n_in)], axis=1)
    pad = ntp + 2
    xr = jnp.pad(xr, ((0, 0), (0, 0), (pad, pad)))

    ns = jnp.arange(n_out)
    k0 = jnp.mod(lead - ns * down, up)
    base = (ns * down - lead + k0) // up
    j = jnp.arange(ntp)
    tap_idx = k0[:, None] + up * j[None, :]      # [n_out, ntp]
    w = jnp.where(tap_idx < nt,
                  jnp.asarray(h)[jnp.minimum(tap_idx, nt - 1)], 0.0)
    src = jnp.clip(base[:, None] + j[None, :] + pad, 0, xr.shape[-1] - 1)
    gathered = xr[:, :, src]                     # [B, 2, n_out, ntp]
    y = jnp.einsum("bcnk,nk->bcn", gathered, w.astype(jnp.float32))
    out_shape = batch_shape + (n_out,)
    return (y[:, 0].reshape(out_shape), y[:, 1].reshape(out_shape))


def decimate(x: cplx.Pair, ratio: int) -> cplx.Pair:
    """pair of [..., N] -> pair of [..., ceil(N / ratio)].

    Matches ltecore.refrx.decimate: filter center-aligned (group delay
    compensated), output sample n taken from filtered sample n * ratio.
    """
    if ratio == 1:
        return x
    h = _taps(ratio)
    nt = len(h)
    lead = (nt - 1) // 2
    batch_shape = x[0].shape[:-1]
    n = x[0].shape[-1]

    # real/imag as conv feature channels: [B, 2, N]
    xr = jnp.stack([x[0].reshape(-1, n), x[1].reshape(-1, n)], axis=1)
    # conv_general_dilated correlates (no kernel flip); with the symmetric
    # filter this equals refrx's convolution iff the pad is mirrored.
    xr = jnp.pad(xr, ((0, 0), (0, 0), (nt - 1 - lead, lead)))
    # kernel [out_ch=2, in_ch=2, W] block-diagonal (same filter per channel)
    k = jnp.zeros((2, 2, nt), dtype=jnp.float32)
    k = k.at[0, 0].set(h).at[1, 1].set(h)
    # DEFAULT (TF32) precision: within CHANNELIZE_MAX_DB of f64
    y = jax.lax.conv_general_dilated(
        xr, k, window_strides=(ratio,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32)
    out_n = y.shape[-1]
    return (y[:, 0].reshape(batch_shape + (out_n,)),
            y[:, 1].reshape(batch_shape + (out_n,)))
