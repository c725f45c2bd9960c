"""Gold (pseudo-random) sequence generation, 3GPP 36.211 7.2.

Device design: the jitted decoder cannot run a 1600-step LFSR per decode attempt
(cell_id — hence c_init — is a *traced* value discovered by SSS).  But the
Gold sequence is linear over GF(2) in the 31 bits of c_init:

    c(n) = x1(n + Nc)  XOR  x2(n + Nc)
    x1 part: constant (x1 seed is fixed)
    x2(n + Nc) = <G[n, :], bits(c_init)>  (mod 2)

so we precompute, once per needed length, a binary generator matrix G
[N, 31] plus the constant x1 vector.  On device the whole scrambling sequence
is then one tiny int matmul + parity — dense and jit-safe.

(The reference gets these sequences implicitly from srsLTE's precomputed
tables inside srslte_pbch_* / srslte_chest_dl_*; lib/mib_impl.cc:162.)
"""

import functools

import numpy as np

NC = 1600


def _x1_bits(length: int) -> np.ndarray:
    """x1(Nc .. Nc+length): fixed LFSR x1(i+31) = x1(i+3) ^ x1(i), seed 100...0."""
    n = NC + length
    x = np.zeros(n + 31, dtype=np.uint8)
    x[0] = 1
    for i in range(n):
        x[i + 31] = x[i + 3] ^ x[i]
    return x[NC:NC + length]


@functools.lru_cache(maxsize=None)
def gold_matrix(length: int):
    """(G, x1c): G is [length, 31] uint8; x1c is [length] uint8.

    c(n) for seed bits b (b[j] = bit j of c_init) is (G @ b + x1c) mod 2.
    """
    # x2 trajectories for each unit seed: linearity over GF(2).
    G = np.zeros((length, 31), dtype=np.uint8)
    n = NC + length
    for j in range(31):
        x = np.zeros(n + 31, dtype=np.uint8)
        x[j] = 1
        for i in range(n):
            x[i + 31] = x[i + 3] ^ x[i + 2] ^ x[i + 1] ^ x[i]
        G[:, j] = x[NC:NC + length]
    return G, _x1_bits(length)


def gold_sequence(c_init: int, length: int) -> np.ndarray:
    """[length] uint8 Gold sequence (host-side, for tests and synthesis)."""
    G, x1c = gold_matrix(length)
    bits = np.array([(c_init >> j) & 1 for j in range(31)], dtype=np.uint8)
    return ((G @ bits.astype(np.int64)) % 2).astype(np.uint8) ^ x1c


def crs_c_init(cell_id, slot, symbol, normal_cp: bool):
    """c_init for cell-specific reference signals (36.211 6.10.1.1).

    Works with python ints or traced jnp int32 (pure arithmetic).
    """
    n_cp = 1 if normal_cp else 0
    return (1 << 10) * (7 * (slot + 1) + symbol + 1) * (2 * cell_id + 1) \
        + 2 * cell_id + n_cp


def pbch_c_init(cell_id):
    """c_init for PBCH scrambling (36.211 6.6.1): just the cell id."""
    return cell_id
