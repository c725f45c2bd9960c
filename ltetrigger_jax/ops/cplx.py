"""Complex arithmetic as real pairs — the engine's signal representation.

The framework's on-device representation of an IQ signal is a pair of
float32 arrays `(re, im)` (every correlation, DFT and selection is then a
real matmul), and this module is the complete complex algebra over such
pairs.  Whether complex64 with jnp.fft serves better is decided by
measurement (ROADMAP design debt 6).

Pairs are plain tuples — they ride through jit/vmap/scan as pytrees, and XLA
lays each component out independently (no wasted 2-wide lane dimension).
The numpy boundary converts to/from complex64.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Pair = tuple  # (re, im), matching float32 arrays


# ------------------------------------------------------------- boundary ----
def from_numpy(x: np.ndarray) -> Pair:
    x = np.asarray(x)
    return (jnp.asarray(x.real.astype(np.float32)),
            jnp.asarray(x.imag.astype(np.float32)))


def to_numpy(p: Pair) -> np.ndarray:
    return np.asarray(p[0]).astype(np.complex64) \
        + 1j * np.asarray(p[1]).astype(np.complex64)


def const(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Static complex constant -> numpy float32 pair (for kernel weights)."""
    x = np.asarray(x)
    return (x.real.astype(np.float32), x.imag.astype(np.float32))


# -------------------------------------------------------------- algebra ----
def add(a: Pair, b: Pair) -> Pair:
    return (a[0] + b[0], a[1] + b[1])


def sub(a: Pair, b: Pair) -> Pair:
    return (a[0] - b[0], a[1] - b[1])


def mul(a: Pair, b: Pair) -> Pair:
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def mul_conj(a: Pair, b: Pair) -> Pair:
    """a * conj(b)."""
    return (a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1])


def conj(a: Pair) -> Pair:
    return (a[0], -a[1])


def neg(a: Pair) -> Pair:
    return (-a[0], -a[1])


def scale(a: Pair, s) -> Pair:
    return (a[0] * s, a[1] * s)


def abs2(a: Pair) -> jnp.ndarray:
    return a[0] * a[0] + a[1] * a[1]


def angle(a: Pair) -> jnp.ndarray:
    return jnp.arctan2(a[1], a[0])


def div_real(a: Pair, d) -> Pair:
    return (a[0] / d, a[1] / d)


def expi(theta) -> Pair:
    """exp(j*theta)."""
    return (jnp.cos(theta), jnp.sin(theta))


def zeros(shape, dtype=jnp.float32) -> Pair:
    return (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def where(c, a: Pair, b: Pair) -> Pair:
    return (jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1]))


def sum(a: Pair, axis=None) -> Pair:  # noqa: A001
    return (jnp.sum(a[0], axis=axis), jnp.sum(a[1], axis=axis))


def dot_conj_sum(a: Pair, b: Pair, axis=-1) -> Pair:
    """sum(a * conj(b)) along axis — the complex correlation inner product."""
    re = jnp.sum(a[0] * b[0] + a[1] * b[1], axis=axis)
    im = jnp.sum(a[1] * b[0] - a[0] * b[1], axis=axis)
    return (re, im)


def matmul_pair_real(a: Pair, m) -> Pair:
    """(complex pair) @ (real matrix)."""
    return (a[0] @ m, a[1] @ m)


def matmul_real_pair(m_re, m_im, x: Pair) -> Pair:
    """(static complex matrix given as two real parts) @ (pair vector/batch).

    Computes y = M x with M = m_re + j m_im applied along the last axis of x:
    x [..., K] pairs -> y [..., N] pairs for M [N, K].
    """
    xr, xi = x
    yr = xr @ m_re.T - xi @ m_im.T
    yi = xr @ m_im.T + xi @ m_re.T
    return (yr, yi)


def index(a: Pair, idx) -> Pair:
    return (a[0][idx], a[1][idx])


def take(a: Pair, idx, axis=-1) -> Pair:
    return (jnp.take(a[0], idx, axis=axis), jnp.take(a[1], idx, axis=axis))


def stack(pairs, axis=0) -> Pair:
    return (jnp.stack([p[0] for p in pairs], axis=axis),
            jnp.stack([p[1] for p in pairs], axis=axis))


def concat(pairs, axis=0) -> Pair:
    return (jnp.concatenate([p[0] for p in pairs], axis=axis),
            jnp.concatenate([p[1] for p in pairs], axis=axis))


def reshape(a: Pair, shape) -> Pair:
    return (a[0].reshape(shape), a[1].reshape(shape))
