"""Batched tail-biting Viterbi decoders (K=7, rate 1/3), jitted.

The reference gets Viterbi from srsLTE's SSE decoder inside
srslte_ue_mib_decode (lib/mib_impl.cc:162).  Two batched decoders:

  * viterbi_decode_wa (the default): wrap-around decode — the 40-symbol
    LLR block is replicated 3x and a single 64-state trellis is run over
    the 120 steps; the middle copy's decisions are the output.  This is the
    same tail-biting strategy srsLTE itself uses for PBCH, and it is a
    fixed-shape scan: the predecessor butterfly is two STATIC slices of
    the state axis (no gathers), and survivor paths are carried by
    register exchange (per-state packed bit registers permuted by each
    ACS decision) so no [steps, B, 64] decision history is ever stored
    and there is no traceback pass at all.

  * viterbi_decode_tb: exact maximum-likelihood tail-biting decode — the
    64 possible init states become a batch dimension.  64x the state-metric
    traffic of _wa; kept as the golden reference for tests and for
    small-batch offline use.

All hypothesis batches (N_id_2 roots x port-count x scrambling quarter)
ride the same leading dim.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ltecore import coding

N_STATES = coding.N_STATES


@functools.lru_cache(maxsize=None)
def _tables():
    prev_state, out_bits = coding.trellis_tables()
    return (np.asarray(prev_state, dtype=np.int32),
            np.asarray(out_bits, dtype=np.float32))


def viterbi_decode_tb(llr: jnp.ndarray):
    """Exact tail-biting decode.

    llr: [B, 40, 3] float32 — +1 favours bit 0 (matches out_bits polarity).
    returns: (bits [B, 40] int32, metric [B] float32)
    """
    prev_np, out_np = _tables()
    prev_state = jnp.asarray(prev_np)          # [64, 2]
    out_bits = jnp.asarray(out_np)             # [64, 2, 3]

    B = llr.shape[0]
    eye = jnp.eye(N_STATES, dtype=jnp.float32)
    m0 = jnp.broadcast_to((eye - 1.0) * 1e9, (B, N_STATES, N_STATES))

    def acs(m, r_t):
        # r_t: [B, 3]; branch metric for (state, drop): [B, 64, 2]
        # DEFAULT (TF32) precision: bits identical to refrx
        br = jnp.einsum("sdc,bc->bsd", out_bits, r_t)
        cand = m[:, :, prev_state] + br[:, None, :, :]   # [B, I, S, 2]
        dec = jnp.argmax(cand, axis=-1).astype(jnp.int8)
        return jnp.max(cand, axis=-1), dec

    m_final, decisions = jax.lax.scan(acs, m0, jnp.swapaxes(llr, 0, 1))
    # decisions: [40, B, I, S]

    diag = jnp.diagonal(m_final, axis1=1, axis2=2)       # [B, I]
    best_init = jnp.argmax(diag, axis=-1).astype(jnp.int32)   # [B]
    metric = jnp.max(diag, axis=-1)

    bidx = jnp.arange(B)

    def trace(s, dec_t):
        bit = (s >> 5) & 1
        d = dec_t[bidx, best_init, s].astype(jnp.int32)  # [B]
        return prev_state[s, d], bit

    _, bits_rev = jax.lax.scan(trace, best_init, decisions[::-1])
    return bits_rev[::-1].T.astype(jnp.int32), metric


@functools.lru_cache(maxsize=None)
def _butterfly_tables():
    """out_bits reorganized for the static butterfly: [2(drop), 64, 3]."""
    _, out_np = _tables()                       # [64, 2, 3]
    return np.ascontiguousarray(np.swapaxes(out_np, 0, 1))


@functools.lru_cache(maxsize=None)
def _radix4_tables():
    """Two trellis stages fused (radix-4 ACS): for new state ns and
    j = (drop_last << 1) | drop_first, the two-step predecessor is
    pp = 4*(ns & 15) + j (a static tile pattern — no gathers), with
    branch symbols OB2[ns, j, 0:3] = first transition, [3:6] = second,
    and the two survivor bits BITS2[ns, j] = (bit(ps1) << 1) | bit(ns)."""
    prev_np, out_np = _tables()
    OB2 = np.zeros((N_STATES, 4, 6), dtype=np.float32)
    BITS2 = np.zeros((N_STATES, 4), dtype=np.uint32)
    for ns in range(N_STATES):
        for d0 in range(2):                     # last transition's drop
            ps1 = int(prev_np[ns, d0])
            for d1 in range(2):                 # first transition's drop
                j = (d0 << 1) | d1
                pp = int(prev_np[ps1, d1])
                assert pp == 4 * (ns & 15) + j  # the static tile layout
                OB2[ns, j, 0:3] = out_np[ps1, d1]
                OB2[ns, j, 3:6] = out_np[ns, d0]
                BITS2[ns, j] = ((ps1 >> 5) << 1) | (ns >> 5)
    return OB2, BITS2


def _sel4(cands, dec):
    """cands [..., 4] selected by dec [...] in {0..3} without a gather."""
    return jnp.where(dec == 0, cands[..., 0],
                     jnp.where(dec == 1, cands[..., 1],
                               jnp.where(dec == 2, cands[..., 2],
                                         cands[..., 3])))


def viterbi_decode_wa(llr: jnp.ndarray):
    """Wrap-around tail-biting decode, radix-4: two trellis stages per scan
    step (60 sequential steps instead of 120), with PHASE-SPLIT survivor
    recording: only the middle copy's 40 bits are ever read, so the scan
    runs as

      phase 1 (symbols   0..39): ACS only — the carry is just the state
              metric [B, 64] (no survivor registers at all);
      phase 2 (symbols  40..79): ACS + register-exchange RECORDING into
              two uint32 registers (2 bits/step x 20 steps = exactly the
              40 wanted bits);
      phase 3 (symbols 80..119): ACS + register exchange only (the
              recorded bits keep following their paths, nothing shifts in).

    The serial chain's cost is its carry traffic; dropping from three
    always-carried registers to {0, 2, 2} across the phases cuts that
    traffic ~1.7x.
    Identical outputs to viterbi_decode_wa_r2 up to argmax tie order.

    llr: [B, 40, 3] float32 — +1 favours bit 0.
    returns: (bits [B, 40] int32, metric [B] float32)
    """
    OB2_np, BITS2_np = _radix4_tables()
    OB2 = jnp.asarray(OB2_np)                          # [64, 4, 6]
    BITS2 = jnp.asarray(BITS2_np.astype(np.int32))     # [64, 4]
    B = llr.shape[0]
    n = llr.shape[1]
    assert n == 40, "wrap-around layout is sized for the 40-bit PBCH block"
    r3 = jnp.concatenate([llr, llr, llr], axis=1)      # [B, 3n, 3]
    r6 = r3.reshape(B, 3 * n // 2, 6)                  # two symbols per step

    def tile4(x):
        return jnp.tile(x.reshape(B, 1, 16, 4),
                        (1, 4, 1, 1)).reshape(B, N_STATES, 4)

    def acs_core(m, r_t):
        # DEFAULT (TF32): bits = refrx, metric in 1e-3
        br = jnp.einsum("njc,bc->bnj", OB2, r_t)       # [B, 64, 4]
        cand = tile4(m) + br
        dec = jnp.argmax(cand, axis=-1)                # [B, 64]
        return jnp.max(cand, axis=-1), dec

    xs = jnp.swapaxes(r6, 0, 1)                        # [60, B, 6]

    def p1(m, r_t):                                    # metric-only
        m_new, _ = acs_core(m, r_t)
        return m_new, None

    m, _ = jax.lax.scan(p1, jnp.zeros((B, N_STATES), jnp.float32), xs[:20])

    def p2(carry, r_t):                                # record 2 bits/step
        m, r1, r0 = carry
        m_new, dec = acs_core(m, r_t)
        bits2 = _sel4(jnp.broadcast_to(BITS2, (B,) + BITS2.shape), dec) \
            .astype(jnp.uint32)
        r0p = _sel4(tile4(r0), dec)
        r1p = _sel4(tile4(r1), dec)
        # r1 holds only the top 40-32=8 survivor bits: uint8 carry (1/4
        # the r1 carry bytes)
        r1n = ((r1p << 2) | (r0p >> 30).astype(jnp.uint8))
        return (m_new, r1n, (r0p << 2) | bits2), None

    z = jnp.zeros((B, N_STATES), jnp.uint32)
    z8 = jnp.zeros((B, N_STATES), jnp.uint8)
    (m, r1, r0), _ = jax.lax.scan(p2, (m, z8, z), xs[20:40])

    def p3(carry, r_t):                                # exchange only
        m, r1, r0 = carry
        m_new, dec = acs_core(m, r_t)
        return (m_new, _sel4(tile4(r1), dec), _sel4(tile4(r0), dec)), None

    (m, r1, r0), _ = jax.lax.scan(p3, (m, r1, r0), xs[40:])

    best = jnp.argmax(m, axis=-1)
    metric = jnp.max(m, axis=-1) / 3.0
    bidx = jnp.arange(B)
    h1 = r1[bidx, best].astype(jnp.uint32)
    h0 = r0[bidx, best]
    # middle-copy symbol t in [40, 79] was recorded at chain bit 79 - t
    t = jnp.arange(n, dtype=jnp.uint32) + n
    k = jnp.uint32(2 * n - 1) - t                      # 39..0
    from_r1 = k >= 32
    word = jnp.where(from_r1[None, :], h1[:, None], h0[:, None])
    shift = jnp.where(from_r1, k - 32, k)
    bits = (word >> shift[None, :]) & 1
    return bits.astype(jnp.int32), metric


def viterbi_decode_wa_r2(llr: jnp.ndarray):
    """Wrap-around tail-biting decode (srsLTE's PBCH strategy).

    llr: [B, 40, 3] float32 — +1 favours bit 0 (matches out_bits polarity).
    returns: (bits [B, 40] int32, metric [B] float32)

    The metric is the best path metric over the middle 40 steps' scale
    (total 120-step metric / 3) so it is comparable to viterbi_decode_tb.

    Trellis convention (ltecore/coding.trellis_tables): new state ns takes
    input bit b = ns >> 5 from predecessor ps = ((ns & 0x1F) << 1) | drop.
    So the two predecessors of ns are the even/odd pair (2*(ns&31),
    2*(ns&31)+1) — i.e. m[:, ::2] and m[:, 1::2], each tiled twice along
    the state axis.  Static slices, no gathers.

    Survivor bits ride three per-state uint32 registers (96-step window
    covers replicated steps 24..119 at the end; the wanted middle copy is
    steps 40..79).
    """
    out_bits = jnp.asarray(_butterfly_tables())       # [2, 64, 3]
    B = llr.shape[0]
    n = llr.shape[1]
    r3 = jnp.concatenate([llr, llr, llr], axis=1)     # [B, 3n, 3]
    bit_s = (jnp.arange(N_STATES, dtype=jnp.uint32) >> 5) & 1   # [64]

    def tile2(x):
        # predecessor views: even preds (drop=0) and odd preds (drop=1),
        # each repeated for the two successor halves s<32 / s>=32
        return (jnp.tile(x[:, 0::2], (1, 2)), jnp.tile(x[:, 1::2], (1, 2)))

    def acs(carry, r_t):
        m, r2, r1, r0 = carry
        # DEFAULT (TF32) precision: bits identical to refrx
        br = jnp.einsum("dsc,bc->bds", out_bits, r_t)           # [B, 2, 64]
        m_p0, m_p1 = tile2(m)
        cand0 = m_p0 + br[:, 0]
        cand1 = m_p1 + br[:, 1]
        dec = cand1 > cand0                                      # [B, 64]
        m_new = jnp.maximum(cand0, cand1)

        def exch(r):
            p0, p1 = tile2(r)
            return jnp.where(dec, p1, p0)

        r0p, r1p, r2p = exch(r0), exch(r1), exch(r2)
        r0n = (r0p << 1) | bit_s[None, :]
        r1n = (r1p << 1) | (r0p >> 31)
        r2n = (r2p << 1) | (r1p >> 31)
        return (m_new, r2n, r1n, r0n), None

    m0 = jnp.zeros((B, N_STATES), jnp.float32)
    z = jnp.zeros((B, N_STATES), jnp.uint32)
    (m, r2, r1, r0), _ = jax.lax.scan(acs, (m0, z, z, z),
                                      jnp.swapaxes(r3, 0, 1))

    best = jnp.argmax(m, axis=-1)
    metric = jnp.max(m, axis=-1) / 3.0
    bidx = jnp.arange(B)
    h2 = r2[bidx, best]        # chain bits k=64..95 -> steps 55..24
    h1 = r1[bidx, best]        # chain bits k=32..63 -> steps 87..56
    # decoded bit of replicated step t sits at chain position k = 3n-1-t
    t = jnp.arange(n, dtype=jnp.uint32) + n       # steps 40..79 (middle copy)
    k = jnp.uint32(3 * n - 1) - t                 # 79..40
    from_r2 = k >= 64
    word = jnp.where(from_r2[None, :], h2[:, None], h1[:, None])
    shift = jnp.where(from_r2, k - 64, k - 32)
    bits = (word >> shift[None, :]) & 1
    return bits.astype(jnp.int32), metric
