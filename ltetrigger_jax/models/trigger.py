"""The downlink trigger: PSS tracking state machine + SSS + MIB, fused.

This is the framework's flagship "model".  The reference implements it as a
GNU Radio hier block of 12 threads (3x pss -> sss -> mib + tag_debug,
python/downlink_trigger_c.py:27-45) with data-dependent stream consumption.
Here the whole thing is ONE fixed-shape jitted program in THREE passes,
organized around a single principle: **only the truly sequential recurrences
run inside the scan; every sample-proportional computation is batched.**

  pass A — grid correlation (one matmul, batched over steps):
    * the stream is searched on a FIXED grid: step t's 9600 candidate
      positions start at grid0 + 9600*t.  The reference instead re-aligns
      its stream pointer to the detected frame boundary (consume_each
      (frame_start + 9600), lib/pss_impl.cc:188-195) — but correlation is
      shift-invariant and the PSS is exactly half-frame-periodic, so the
      fixed grid sees the peak at a CONSTANT bin and the running average
      stays coherent; alignment becomes a per-root *offset* (the peak bin)
      instead of a data-dependent stream position.  This makes every
      correlation window position static, so the matched filter for ALL
      steps of a dispatch is a handful of dense blocked-Toeplitz matmuls
      ([G*75, 256] @ [256, 768] per group of G steps) with no per-step
      gathers at all.  (Round-2's engine gathered a 12,480-sample window
      per root per step instead.)

  pass B — lax.scan over half-frame steps (the streaming state machine):
    * consumes precomputed correlation power; carries ONLY the sequential
      state: EMA'd correlation power, peak/PSR, hysteresis score/timer/
      tracking, PSR telemetry ring (reference incr_score/reset_score,
      lib/pss_impl.cc:111-152).  No sample buffers are touched.

  pass C — batched post-pass, once per dispatch (`_mib_postpass`):
    * slot-0 tail segments for ALL steps are gathered in one batch; CFO
      estimation, the CFO-ring recurrence (scalars), rotation, CP detect and
      SSS run batched over the step axis;
    * MIB candidate selection (the reference mib block's tag gating,
      lib/mib_impl.cc:122-135) is closed-form boolean algebra over the step
      axis — capture slot k goes to the k-th step wanting one; overflow
      beyond K slots is counted (observable deferral);
    * the candidates' slot-1 samples are gathered lazily (K per root per
      dispatch, not per step), rotated by their capture-time CFO, and decoded
      in ONE batched PBCH pipeline + ONE batched wrap-around Viterbi with
      the 40 ms TTI soft-combining accumulator (reference
      srslte_ue_mib_decode's frame buffer, lib/mib_impl.cc:75-76,162)
      carried across dispatches in TriggerState.llr_acc;
    * track/drop events and the published-cell state machine are assembled
      with log-depth associative scans over the step axis (publish on first
      CRC-valid decode of an acquisition epoch, drop on the first tracking
      loss while published);
    * the whole pass is gated on `any step emitted` and the decode on `any
      candidate captured` (scalar lax.cond — noise channels and wideband
      scans skip everything but passes A+B).

Faithful semantics (reference lib/pss_impl.cc:154-223, SURVEY §2.3):
  score hysteresis with track_after saturation, EMA reset on acquisition and
  loss, track_every correlation skipping with PSR reuse, CFO running-mean
  correction only while tracking, immediate in-chunk MIB reacquisition after
  a drop, and the tracking_lost cascade that retracts a published cell.
  The observable contract (events, fields, telemetry) is unchanged from the
  re-aligning formulation; only the internal stream coordinates differ (the
  host drivers see a constant consumption of 9600 samples per active step).

Capture-capacity note: dispatches of up to K_STEP_CAP (32) steps allocate
one MIB capture slot PER STEP, so in-dispatch overflow is impossible there —
this covers every host-driver path (search chunks, streaming step buckets),
so a >16-capture burst followed by silence still decodes and publishes
(tests/test_trigger.py::test_capture_overflow_defers_not_loses).  Longer
offline dispatches (channel_scan with n_steps > 32) bound the decode batch
at K_CANDIDATES slots; captures beyond that are counted in
TriggerState.cap_overflow and only re-decode if the stream presents further
candidates (an offline capture can simply be re-scanned; live streams never
take this path).  A capture whose slot-1 read would cross n_valid (the last
~1 slot of a clipped streaming buffer) is likewise deferred and counted —
never gathered misaligned (see `gatherable` in _capture_chain).

All three N_id_2 hypotheses are a trailing [R] axis; multi-channel batches
are leading axes — every function here is rank-polymorphic, so the
channel_scan path is this same code with a [C] prefix (no outer vmap, which
keeps the lax.cond gates real branches instead of selects).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ltecore.constants import (DEFAULT_TRACK_AFTER, DEFAULT_TRACK_EVERY,
                                 HALF_FRAME_LENGTH, MOVING_AVG_SZ,
                                 PSR_EMA_ALPHA, PSS_SYMBOL_START, SLOT_LENGTH,
                                 SYMBOL_SZ)
from ..ops import cfo as cfo_ops
from ..ops import cplx, correlate, pbch, sync

R = 3                                   # N_id_2 hypotheses
LOOKBACK = PSS_SYMBOL_START             # 832 samples of history before grid0
# WINDOW - LOOKBACK = the correlator's read-ahead past a grid position; the
# buffer must hold >= LOOKBACK samples (or zeros) before grid0 and WINDOW -
# LOOKBACK beyond the last active grid position.
WINDOW = LOOKBACK + correlate.V2_WINDOW                # 10560
K_CANDIDATES = 16                       # MIB candidate slots (long dispatches)
# dispatches up to this many steps get ONE capture slot PER STEP, so
# in-dispatch capture overflow is structurally impossible there (a step
# produces at most one candidate).  Every host-driver path (search chunks,
# streaming step buckets) stays <= this; only long offline channel_scan
# dispatches fall back to K_CANDIDATES slots with counted deferral.
K_STEP_CAP = 32
# max batch*G steps per pass-A matmul group (bounds the materialized power
# tensor to ~GROUP_BUDGET * 115 KB); raising it amortizes pass B better at
# high channel counts at the cost of device-memory headroom
GROUP_BUDGET = int(os.environ.get("LTETRIGGER_GROUP_BUDGET", "4096"))
# slot-0 tail gathered per step: must hold every CP-detect / SSS / PSS-sym
# read.  Lowest relative read is extended-CP detect at slot_length - 480
# (two symbol+CP hops below the PSS, ops/sync.py::detect_cp), so 512
# samples with 32 of margin suffice.
SEG = 512
SEG_OFF = SLOT_LENGTH - SEG
# The dense extraction paths (_gather_cands_dense_core, _extract_segs_dense)
# use 0/1-weighted contractions as gathers.  At HIGHEST the data operand is
# not rounded (a GPU runs DEFAULT f32 dots in TF32), so every output is
# exactly one input sample: bit-identical to the gather paths.
_EXACT = jax.lax.Precision.HIGHEST


class TriggerState(NamedTuple):
    """Carry across dispatches (trailing [R] per channel)."""
    pos: jnp.ndarray          # [R] int32 — next grid position (all equal)
    ema: jnp.ndarray          # [75, R, 128] f32 — EMA'd correlation power
    #   (block layout: flat grid bin = 128*block + lane; pass A produces
    #   this layout natively, so the hot loop never transposes it)
    score: jnp.ndarray        # [R] int32
    timer: jnp.ndarray        # [R] int32
    tracking: jnp.ndarray     # [R] bool
    psr: jnp.ndarray          # [R] f32 — last PSR (reused when not searching)
    peak: jnp.ndarray         # [R] int32 — last peak bin in [0, 9600)
    psr_max: jnp.ndarray      # [R] f32
    psr_ring: jnp.ndarray     # [R, 200] f32
    psr_count: jnp.ndarray    # [R] int32
    cfo_ring: jnp.ndarray     # [R, 200] f32
    cfo_count: jnp.ndarray    # [R] int32
    published: jnp.ndarray    # [R] bool
    pub_cell_id: jnp.ndarray  # [R] int32
    llr_acc: jnp.ndarray      # [R, 12, 120] f32 — PBCH TTI soft-combine acc
    mib_n: jnp.ndarray        # [R] int32 — subframe-0 attempts combined
    mib_cell: jnp.ndarray     # [R] int32 — cell id of the last MIB capture
    pending_fresh: jnp.ndarray  # [R] bool — loss seen since last capture
    cap_overflow: jnp.ndarray   # [R] int32 — captures deferred (all K slots
    #   of a dispatch full; observable deferral, see module docstring)
    chest: jnp.ndarray        # [R, 62, 2] f32 — LS channel estimate over
    #   the 62 PSS subcarriers from the most recent tracked half-frame
    #   (reference srslte_pss_chest into d_channel_estimation_buffer,
    #   lib/pss_impl.cc:206-209; telemetry, like the reference's — computed
    #   on the CFO-corrected PSS symbol, never consumed downstream)


class RawStepOutput(NamedTuple):
    """Per-step observables of pass B (pre-SSS/MIB)."""
    grid: jnp.ndarray         # int32 (step-scalar) — this step's grid start
    active: jnp.ndarray       # bool (step-scalar)
    peak: jnp.ndarray         # [R] int32
    psr: jnp.ndarray          # [R] f32
    score: jnp.ndarray        # [R] int32
    tracking: jnp.ndarray     # [R] bool
    emit: jnp.ndarray         # [R] bool — active & (over | lost)
    lost: jnp.ndarray         # [R] bool — active & tracking-lost this step
    consumed: jnp.ndarray     # [R] int32


class StepOutput(NamedTuple):
    """Per-step, per-root observables (events + telemetry) — the public
    contract of scan_engine, unchanged since round 1."""
    track_event: jnp.ndarray  # bool — publish this cell (reference: `track` PMT)
    drop_event: jnp.ndarray   # bool — retract published cell (`drop` PMT)
    drop_cell_id: jnp.ndarray # int32 — the previously *published* cell id
    cell_id: jnp.ndarray      # int32
    nof_prb: jnp.ndarray      # int32
    nof_ports: jnp.ndarray    # int32
    phich_ext: jnp.ndarray    # int32
    phich_res: jnp.ndarray    # int32
    sfn_offset: jnp.ndarray   # int32
    normal_cp: jnp.ndarray    # bool
    psr: jnp.ndarray          # f32
    score: jnp.ndarray        # int32
    tracking: jnp.ndarray     # bool
    cfo_mean: jnp.ndarray     # f32
    consumed: jnp.ndarray     # int32


def init_state(start_pos: int = LOOKBACK) -> TriggerState:
    z = jnp.zeros
    return TriggerState(
        pos=jnp.full((R,), start_pos, dtype=jnp.int32),
        ema=z((HALF_FRAME_LENGTH // SYMBOL_SZ, R, SYMBOL_SZ),
              jnp.float32),
        score=z((R,), jnp.int32),
        timer=z((R,), jnp.int32),
        tracking=z((R,), bool),
        psr=z((R,), jnp.float32),
        peak=jnp.full((R,), LOOKBACK, dtype=jnp.int32),
        psr_max=z((R,), jnp.float32),
        psr_ring=z((R, MOVING_AVG_SZ), jnp.float32),
        psr_count=z((R,), jnp.int32),
        cfo_ring=z((R, MOVING_AVG_SZ), jnp.float32),
        cfo_count=z((R,), jnp.int32),
        published=z((R,), bool),
        pub_cell_id=z((R,), jnp.int32),
        llr_acc=z((R, 12, 120), jnp.float32),
        mib_n=z((R,), jnp.int32),
        mib_cell=jnp.full((R,), -1, dtype=jnp.int32),
        pending_fresh=jnp.ones((R,), dtype=bool),
        cap_overflow=z((R,), jnp.int32),
        chest=z((R, 62, 2), jnp.float32),
    )


def _ring_mean(ring, count):
    n = jnp.minimum(count, MOVING_AVG_SZ)
    return jnp.where(n > 0, jnp.sum(ring, axis=-1) / jnp.maximum(n, 1), 0.0)


def _ring_push(ring, count, value):
    idx = jnp.mod(count, MOVING_AVG_SZ)
    onehot = jax.nn.one_hot(idx, MOVING_AVG_SZ, dtype=ring.dtype)
    return ring * (1 - onehot) + onehot * value[..., None]


# ======================================================================
# pass A — grid correlation
# ======================================================================
def _pass_a_dtype():
    impl = os.environ.get("LTETRIGGER_CORRELATOR", "fast")
    # "fast" (shipped default) = bf16 matmul inputs, f32 accumulation —
    # peak positions identical to an f64 correlation (chip_smoke.py phase
    # 2 checks it on the device); anything else = f32.
    # The conv formulation ("v1") remains available as the independent
    # cross-check via correlate.pss_correlate_power (golden tests), but the
    # grid engine always uses the blocked-Toeplitz formulation.
    return jnp.bfloat16 if impl == "fast" else jnp.float32


def _group_power(buffer: cplx.Pair, lo, g: int) -> jnp.ndarray:
    """Correlation power for g consecutive grid steps starting at `lo`.

    buffer: pair of [..., N]; lo: traced scalar start (grid of step 0).
    returns [..., g, 75, 3, 128] float32 in pass A's NATIVE block layout —
    power[..., t, b, r, m] is the matched-filter power of root r at stream
    position lo + 9600*t + 128*b + m.  Batch-first and block-structured on
    purpose: an [g, .., R, 9600] layout costs two transposes of the full
    power tensor; pass B consumes this layout directly
    (peak_and_psr_blocked) and slices its per-step input by index instead
    of requiring a leading step axis.

    ONE blocked-Toeplitz matmul for the whole group (K=512 contraction over
    [x0_re | x0_im | x1_re | x1_im], comp-major output — see
    correlate._toeplitz_weights_fat): the g*9600 candidate positions tile
    into g*75 blocks of 128, each correlated by [512]->[768] dense weights,
    and the square-accumulate combines two CONTIGUOUS 384-column halves.
    Replaces the reference's per-half-frame FFTW convolution
    (srslte_pss_find_pss, lib/pss_impl.cc:165) with one dense matmul.
    """
    span = g * HALF_FRAME_LENGTH
    batch = buffer[0].shape[:-1]
    nb = span // SYMBOL_SZ
    dt = _pass_a_dtype()

    def blocks(off, comp):
        s = jax.lax.dynamic_slice_in_dim(buffer[comp], lo + off, span, -1)
        return s.reshape(batch + (nb, SYMBOL_SZ))

    x = jnp.concatenate([blocks(0, 0), blocks(0, 1),
                         blocks(SYMBOL_SZ, 0), blocks(SYMBOL_SZ, 1)],
                        -1).astype(dt)                  # [..., g*75, 512]
    W = jnp.asarray(correlate._toeplitz_weights_fat()).astype(dt)
    # bf16 operands, f32 accumulation: peaks identical to f64, PSR within
    # PASS_A_PSR_RTOL=2e-2 (chip_smoke.py phase 2)
    c = jnp.dot(x, W, preferred_element_type=jnp.float32)  # [.., g*75, 768]
    p = c[..., :384] ** 2 + c[..., 384:] ** 2           # comp-major squares
    return p.reshape(batch + (g, 75, R, SYMBOL_SZ))


def _pick_group(n_steps: int, batch: int) -> int:
    limit = max(1, min(GROUP_BUDGET // max(batch, 1), 32, n_steps))
    for g in range(limit, 0, -1):
        if n_steps % g == 0:
            return g
    return 1


# ======================================================================
# pass B — the sequential state machine
# ======================================================================
def _step_core(state: TriggerState, power, grid, active, psr_threshold,
               track_after: int, track_every: int):
    """One half-frame step (rank-polymorphic: trailing [R] / [R, 9600]).

    power: [..., R, 9600] f32 — pass-A power for this step's grid window.
    grid, active: traced step-scalars (the static grid schedule).
    """
    search = (~state.tracking) | (state.timer == 0)
    timer = jnp.where(search, track_every, state.timer - 1)

    # power/ema ride in pass A's native [.., 75, R, 128] block layout;
    # masks shaped [.., R] broadcast as [.., 1, R, 1]
    ema = jnp.where(search[..., None, :, None],
                    PSR_EMA_ALPHA * power + (1 - PSR_EMA_ALPHA) * state.ema,
                    state.ema)
    peak_new, psr_new = correlate.peak_and_psr_blocked(ema)
    psr = jnp.where(search, psr_new, state.psr)
    peak = jnp.where(search, peak_new, state.peak)

    psr_ring = jnp.where(search[..., None],
                         _ring_push(state.psr_ring, state.psr_count, psr),
                         state.psr_ring)
    psr_count = state.psr_count + search.astype(jnp.int32)

    # --- hysteresis scoring (reference incr_score / reset_score) ---
    over = psr > psr_threshold
    score_inc = jnp.minimum(state.score + 1, track_after)
    crossing = over & (~state.tracking) & (score_inc == track_after)
    lost = (~over) & (state.score > 0)

    score = jnp.where(over, score_inc, 0)
    tracking = jnp.where(over, state.tracking | crossing,
                         jnp.zeros_like(state.tracking))
    ema = jnp.where((crossing | lost)[..., None, :, None],
                    jnp.zeros_like(ema), ema)
    timer = jnp.where(lost, 0, timer)
    psr_ring = jnp.where(lost[..., None], 0.0, psr_ring)
    psr_count = jnp.where(lost, 0, psr_count)
    psr_max = jnp.maximum(state.psr_max, psr)
    emit = over | lost

    def frz(new, old):
        return jnp.where(active, new, old)

    nxt = state._replace(
        pos=frz(jnp.broadcast_to(grid + HALF_FRAME_LENGTH, state.pos.shape)
                .astype(jnp.int32), state.pos),
        ema=frz(ema, state.ema),
        score=frz(score, state.score),
        timer=frz(timer, state.timer),
        tracking=frz(tracking, state.tracking),
        psr=frz(psr, state.psr),
        peak=frz(peak, state.peak),
        psr_max=frz(psr_max, state.psr_max),
        psr_ring=frz(psr_ring, state.psr_ring),
        psr_count=frz(psr_count, state.psr_count),
    )
    shape = state.score.shape
    out = RawStepOutput(
        grid=jnp.asarray(grid, jnp.int32),
        active=jnp.asarray(active, bool),
        peak=nxt.peak,
        psr=nxt.psr,
        score=nxt.score,
        tracking=nxt.tracking,
        emit=jnp.broadcast_to(active, shape) & emit,
        lost=jnp.broadcast_to(active, shape) & emit & lost,
        consumed=jnp.where(active, HALF_FRAME_LENGTH, 0)
        * jnp.ones(shape, jnp.int32),
    )
    return nxt, out


def scan_pass(buffer: cplx.Pair, state: TriggerState, n_steps: int,
              psr_threshold,
              track_after: int = DEFAULT_TRACK_AFTER,
              track_every: int = DEFAULT_TRACK_EVERY,
              n_valid=None, grid0_static: int | None = None,
              pad_dynamic: bool = True):
    """Passes A+B: correlate and scan `n_steps` half-frame steps.

    buffer: pair of [..., N] float32 — >= LOOKBACK zeros/history before
        grid0 and WINDOW - LOOKBACK samples beyond the last active grid.
    state: TriggerState with leading batch dims matching `buffer`'s.
        All pos entries must be equal (the grid is shared — guaranteed by
        init_state and preserved by every step).
    n_valid: traced scalar — logical end of data (default: N).
    grid0_static: the caller's promise that pos == this static int; enables
        static pass-A slicing with a trace-time bounds check.  When None the
        buffer is zero-padded on device to cover the worst-case grid span.
    returns: (final_state, RawStepOutput stacked [n_steps, ...]).
    """
    n = buffer[0].shape[-1]
    if n_valid is None:
        n_valid = n
    n_valid = jnp.asarray(n_valid, dtype=jnp.int32)
    thresh = jnp.asarray(psr_threshold, dtype=jnp.float32)
    batch = int(np.prod(buffer[0].shape[:-1], dtype=np.int64)) or 1
    g = _pick_group(n_steps, batch)
    n_groups = n_steps // g
    span_need = n_steps * HALF_FRAME_LENGTH + SYMBOL_SZ

    if grid0_static is not None:
        assert n >= grid0_static + span_need, (
            f"buffer length {n} < grid0 {grid0_static} + span {span_need}")
        grid0 = jnp.int32(grid0_static)
    else:
        grid0 = jnp.reshape(state.pos, (-1,))[0]
        if pad_dynamic:
            pad = jnp.zeros(buffer[0].shape[:-1] + (span_need,), jnp.float32)
            buffer = (jnp.concatenate([buffer[0], pad], axis=-1),
                      jnp.concatenate([buffer[1], pad], axis=-1))

    nbatch = buffer[0].ndim - 1

    def group_body(st, gi):
        lo = grid0 + gi * (g * HALF_FRAME_LENGTH)
        power = _group_power(buffer, lo, g)          # [.., g, 75, R, 128]

        def stepf(st2, ti):
            # per-step power by scalar-index slice along the g axis — a
            # contiguous batch-first read, NOT a relayout (the step axis
            # never has to lead)
            p_t = jax.lax.dynamic_index_in_dim(power, ti, axis=nbatch,
                                               keepdims=False)
            grid = lo + ti * HALF_FRAME_LENGTH
            active = grid + correlate.V2_WINDOW <= n_valid
            return _step_core(st2, p_t, grid, active, thresh,
                              track_after, track_every)

        return jax.lax.scan(stepf, st, jnp.arange(g, dtype=jnp.int32))

    final, raws = jax.lax.scan(group_body, state,
                               jnp.arange(n_groups, dtype=jnp.int32))
    raws = jax.tree_util.tree_map(
        lambda a: a.reshape((n_steps,) + a.shape[2:]), raws)
    return final, raws


# ======================================================================
# pass C — batched SSS / capture / MIB decode / event assembly
# ======================================================================
def _gather_rows(comp, starts, length: int):
    """Batched contiguous gathers.  comp: [*B, N]; starts: [*B, ...] int32
    (clamped by dynamic_slice); returns [*B, ..., length]."""
    nb = comp.ndim - 1

    def one(buf, st):
        flat = st.reshape(-1)
        rows = jax.vmap(
            lambda s: jax.lax.dynamic_slice(buf, (s,), (length,)))(flat)
        return rows.reshape(st.shape + (length,))

    fn = one
    for _ in range(nb):
        fn = jax.vmap(fn)
    return fn(comp, starts)


def _gather_steps(buffer: cplx.Pair, starts, length: int) -> cplx.Pair:
    """Per-step gathers: buffer pair [*B, N], starts [S, *B, R] ->
    pair [S, *B, R, length]."""
    nb = buffer[0].ndim - 1
    perm_in = tuple(range(1, 1 + nb)) + (0, 1 + nb)
    perm_out = (nb,) + tuple(range(nb)) + (nb + 1, nb + 2)

    def one_comp(comp):
        st = jnp.transpose(starts, perm_in) if nb else starts
        rows = _gather_rows(comp, st, length)        # [*B, S, R, length]
        return jnp.transpose(rows, perm_out) if nb else rows

    return (one_comp(buffer[0]), one_comp(buffer[1]))


def _gather_cands(buffer: cplx.Pair, starts, length: int) -> cplx.Pair:
    """Candidate gathers: starts [*B, R, K] (batch dims already leading)."""
    return (_gather_rows(buffer[0], starts, length),
            _gather_rows(buffer[1], starts, length))


# Candidate slot-1 extraction strategy: "gather" (default) is the
# K-candidate vmapped dynamic slice; "dense" is the same selection as exact
# one-hot contractions (the slot-0 scheme), bit-identical and slower on
# the H100 at C=128 x 100 steps (chip_smoke.py phase 3, PERF.md).
CAND_EXTRACT = os.environ.get("LTETRIGGER_CAND_EXTRACT", "gather")


def _gather_cands_dense(buffer: cplx.Pair, cand_start, grid0,
                        n_steps: int) -> cplx.Pair:
    """Memory-bounded wrapper around _gather_cands_dense_core: the dense
    selection materializes O(C * (S*9600 + RK*10752)) temporaries, so
    channel batches above _CAND_CHUNK lanes run as a sequential lax.map
    over channel chunks (peak memory divides by the chunk count, total
    work unchanged)."""
    batch = buffer[0].shape[:-1]
    if len(batch) == 1 and batch[0] > _CAND_CHUNK:
        c = batch[0]
        ch = max(d for d in range(1, _CAND_CHUNK + 1) if c % d == 0)
        n_ch = c // ch

        def one_chunk(args):
            b0, b1, st = args
            return _gather_cands_dense_core((b0, b1), st, grid0, n_steps)

        o0, o1 = jax.lax.map(
            one_chunk,
            (buffer[0].reshape((n_ch, ch) + buffer[0].shape[1:]),
             buffer[1].reshape((n_ch, ch) + buffer[1].shape[1:]),
             cand_start.reshape((n_ch, ch) + cand_start.shape[1:])))
        return (o0.reshape((c,) + o0.shape[2:]),
                o1.reshape((c,) + o1.shape[2:]))
    return _gather_cands_dense_core(buffer, cand_start, grid0, n_steps)


_CAND_CHUNK = 128


def _gather_cands_dense_core(buffer: cplx.Pair, cand_start, grid0,
                             n_steps: int) -> cplx.Pair:
    """Slot-1 segments for the decode candidates with NO per-lane gathers.

    cand_start [*B, R, K] are absolute starts (grid0 + 9600*s + peak + 128
    for a real candidate; garbage for invalid slots — their one-hots match
    nothing and the output row is exactly zero, which the `valid` mask
    drops downstream).  Selection runs in four dense stages, all 0/1-
    weighted f32 contractions at HIGHEST precision (EXACT — only one
    operand element is ever selected per output):

      stage 0  step:  one-hot [RK, S] over per-step 10752-sample regions,
               built from two stride-9600 reshapes of the buffer (the same
               no-gather view trick as _extract_segs_dense);
      stage 1  q = off//128: 9 consecutive 128-blocks of the 84;
      stage 2  u = off%128//16: 61 consecutive 16-sub-blocks;
      stage 3  v = off%16: einsum over the 16 static 960-shifts.

    A region may read past data_valid / the buffer's padded tail; every
    such sample is dropped by the later selection stages (gatherable
    gating guarantees a REAL candidate's [start, start+960) lies inside
    data_valid), and clamped dynamic-slices make the reads in-bounds."""
    batch = buffer[0].shape[:-1]
    s = n_steps
    shp = cand_start.shape
    rk = shp[-2] * shp[-1]
    rel = cand_start - grid0
    sidx = rel // HALF_FRAME_LENGTH
    off = rel - sidx * HALF_FRAME_LENGTH            # [0, 9600)
    q = off // SYMBOL_SZ                            # [0, 75)
    u = (off % SYMBOL_SZ) // 16                     # [0, 8)
    v = off % 16

    def flat(a):
        return a.reshape(batch + (rk,))

    sidxf, qf, uf, vf = flat(sidx), flat(q), flat(u), flat(v)
    oh_s = (sidxf[..., None]
            == jnp.arange(s, dtype=jnp.int32)).astype(jnp.float32)
    oh_q = (qf[..., None, None] + jnp.arange(9, dtype=jnp.int32)[:, None]
            == jnp.arange(84, dtype=jnp.int32)).astype(jnp.float32)
    oh_u = (uf[..., None, None] + jnp.arange(61, dtype=jnp.int32)[:, None]
            == jnp.arange(72, dtype=jnp.int32)).astype(jnp.float32)
    oh_v = (vf[..., None]
            == jnp.arange(16, dtype=jnp.int32)).astype(jnp.float32)
    span = s * HALF_FRAME_LENGTH

    def one(comp):
        v1 = jax.lax.dynamic_slice_in_dim(comp, grid0, span, -1) \
            .reshape(batch + (s, HALF_FRAME_LENGTH))
        v2 = jax.lax.dynamic_slice_in_dim(comp, grid0 + HALF_FRAME_LENGTH,
                                          span, -1) \
            .reshape(batch + (s, HALF_FRAME_LENGTH))[..., :1152]
        r1 = jnp.einsum("...ks,...sw->...kw", oh_s, v1, precision=_EXACT)
        r2 = jnp.einsum("...ks,...sw->...kw", oh_s, v2, precision=_EXACT)
        blocks = jnp.concatenate([r1, r2], -1) \
            .reshape(batch + (rk, 84, SYMBOL_SZ))
        cat = jnp.einsum("...kjb,...kbm->...kjm", oh_q, blocks,
                         precision=_EXACT).reshape(batch + (rk, 72, 16))
        cat2 = jnp.einsum("...kwb,...kbm->...kwm", oh_u, cat,
                          precision=_EXACT).reshape(batch + (rk, 976))
        sl = jnp.stack([cat2[..., vv:vv + SLOT_LENGTH] for vv in range(16)],
                       axis=-2)
        out = jnp.einsum("...kv,...kvm->...km", oh_v, sl, precision=_EXACT)
        return out.reshape(shp + (SLOT_LENGTH,))

    return one(buffer[0]), one(buffer[1])


# Pass-C slot-0 segment extraction strategy.  "taa" (default) is one
# take_along_axis gather; "dense" is the same selection as exact one-hot
# f32 matmuls + static slices, bit-identical and slower on the H100 at
# C=128 x 100 steps (chip_smoke.py phase 3, PERF.md); "gather" is the
# round-3 vmapped-dynamic-slice path.
SEG_EXTRACT = os.environ.get("LTETRIGGER_SEG_EXTRACT", "taa")


def _extract_segs_taa(buffer: cplx.Pair, starts) -> cplx.Pair:
    """take_along_axis formulation: starts [S, *B, R] -> [S, *B, R, SEG]."""
    nb = buffer[0].ndim - 1
    idx = starts[..., None] + jnp.arange(SEG, dtype=starts.dtype)

    def one(comp):
        b = jnp.expand_dims(comp, axis=(0, nb + 1))   # [1, *B, 1, N]
        return jnp.take_along_axis(b, idx, axis=-1)

    return one(buffer[0]), one(buffer[1])


def _extract_segs_dense(buffer: cplx.Pair, grid0, n_steps: int,
                        peak) -> cplx.Pair:
    """Slot-0 tail segments with NO per-lane gathers.

    seg[s, *B, r] = buffer[*B, grid0 + 9600 s + peak[s,*B,r] - 384 : +SEG]
    (the -384 = SEG_OFF - LOOKBACK).  The peak shift decomposes as
    peak = 128 q + 16 u + v; selection then runs entirely on dense units:

      stage 0  ONE contiguous slice per step group (static shapes), viewed
               as 128-sample blocks; per-step 80-block windows come from
               the stride-75 reshape trick (no gathers);
      stage 1  q: one-hot [5, 80] matmul picks the 5 blocks q..q+4;
      stage 2  u: one-hot [33, 40] matmul picks 16-sample sub-blocks;
      stage 3  v: einsum against the 16 static 512-shifts.

    One-hot f32 matmuls at HIGHEST precision are EXACT (weights 0/1, data
    unrounded), so this is bit-identical to the gather path
    (tests/test_trigger.py::test_seg_extract_paths_agree; chip_smoke.py
    phase 2 on the device).  Memory is bounded group-wise, like pass A."""
    batch = buffer[0].shape[:-1]
    nbatch = int(np.prod(batch, dtype=np.int64)) or 1
    g = _pick_group(n_steps, nbatch)
    n_groups = n_steps // g
    q = peak // SYMBOL_SZ                       # [S, *B, R] in [0, 74]
    u = (peak % SYMBOL_SZ) // 16                # [0, 7]
    v = peak % 16                               # [0, 15]

    def regroup(a):
        return a.reshape((n_groups, g) + a.shape[1:])

    qg, ug, vg = regroup(q), regroup(u), regroup(v)
    span = g * HALF_FRAME_LENGTH + 640          # g*75 + 5 blocks of 128
    nblk = span // SYMBOL_SZ
    b_idx = jnp.arange(80, dtype=jnp.int32)
    w_idx = jnp.arange(40, dtype=jnp.int32)

    def group(_, xs):
        gi, qx, ux, vx = xs
        lo = grid0 - (LOOKBACK - SEG_OFF) + gi * (g * HALF_FRAME_LENGTH)
        oh1 = (qx[..., None, None]
               + jnp.arange(5, dtype=jnp.int32)[:, None]
               == b_idx).astype(jnp.float32)    # [g, *B, R, 5, 80]
        oh2 = (ux[..., None, None]
               + jnp.arange(33, dtype=jnp.int32)[:, None]
               == w_idx).astype(jnp.float32)    # [g, *B, R, 33, 40]
        oh3 = (vx[..., None]
               == jnp.arange(16, dtype=jnp.int32)).astype(jnp.float32)

        def extract(comp):
            U = jax.lax.dynamic_slice_in_dim(comp, lo, span, -1)
            blocks = U.reshape(batch + (nblk, SYMBOL_SZ))
            w1 = blocks[..., :g * 75, :].reshape(
                batch + (g, 75, SYMBOL_SZ))
            pad = jnp.zeros(batch + (70, SYMBOL_SZ), comp.dtype)
            bx = jnp.concatenate([blocks[..., 75:, :], pad], axis=-2)
            w2 = bx.reshape(batch + (g, 75, SYMBOL_SZ))[..., :5, :]
            W = jnp.concatenate([w1, w2], axis=-2)       # [*B, g, 80, 128]
            Wg = jnp.moveaxis(W, len(batch), 0)          # [g, *B, 80, 128]
            cat = jnp.einsum('g...rjb,g...bk->g...rjk', oh1, Wg,
                             precision=_EXACT)
            cat = cat.reshape(cat.shape[:-2] + (640,))   # [g, *B, R, 640]
            sb = cat.reshape(cat.shape[:-1] + (40, 16))
            cat2 = jnp.einsum('g...rwb,g...rbm->g...rwm', oh2, sb,
                              precision=_EXACT)
            cat2 = cat2.reshape(cat2.shape[:-2] + (528,))
            sl = jnp.stack([cat2[..., vv:vv + SEG] for vv in range(16)],
                           axis=-2)                      # [g, *B, R, 16, SEG]
            return jnp.einsum('g...rv,g...rvm->g...rm', oh3, sl,
                              precision=_EXACT)

        return _, (extract(buffer[0]), extract(buffer[1]))

    _, segs = jax.lax.scan(
        group, 0, (jnp.arange(n_groups, dtype=jnp.int32), qg, ug, vg))

    def flat(a):
        return a.reshape((n_steps,) + a.shape[2:])

    return flat(segs[0]), flat(segs[1])


def _ring_series(ring0, count0, est, push, lost):
    """Closed-form telemetry-ring recurrence over the step axis (exact
    parity with per-step reset-then-push semantics).  Possible without a
    sequential scan because one dispatch pushes at most n_steps <=
    MOVING_AVG_SZ values, so two in-dispatch pushes can never collide on a
    ring slot.

    ring0 [.., R, 200], count0 [.., R]; est/push/lost [S, .., R].
    returns (ring_final, count_final, mean_per_step [S, .., R]).
    """
    s = est.shape[0]
    assert s <= MOVING_AVG_SZ, (
        f"{s} steps > ring size {MOVING_AVG_SZ}: slot-collision closed form "
        "does not hold; split the dispatch")
    tt = jnp.arange(s, dtype=jnp.int32).reshape(
        (s,) + (1,) * (est.ndim - 1))
    last_reset = jax.lax.cummax(jnp.where(lost, tt, -1), axis=0)  # incl.
    pcum = jnp.cumsum(push.astype(jnp.int32), axis=0)             # incl.
    pcum_at_reset = jnp.take_along_axis(pcum, jnp.maximum(last_reset, 0),
                                        axis=0)
    # lost steps never push (tracking is false there), so pcum at the reset
    # index equals the pushes strictly before it
    seg_pushes = jnp.where(last_reset >= 0, pcum - pcum_at_reset, pcum)
    count_after = seg_pushes + jnp.where(last_reset >= 0, 0, count0[None])
    count_before = count_after - push.astype(jnp.int32)
    slot = jnp.mod(count_before, MOVING_AVG_SZ)
    # an eviction replaces a value from the INCOMING ring (in-dispatch
    # collisions are impossible; after a reset the ring is zeros)
    evict = (last_reset < 0) & (count_before >= MOVING_AVG_SZ)
    ring0_at = jnp.take_along_axis(
        jnp.broadcast_to(ring0[None], (s,) + ring0.shape),
        slot[..., None], axis=-1)[..., 0]
    contrib = jnp.where(push, est - jnp.where(evict, ring0_at, 0.0), 0.0)
    ccum = jnp.cumsum(contrib, axis=0)
    ccum_at_reset = jnp.take_along_axis(ccum, jnp.maximum(last_reset, 0),
                                        axis=0)
    sum0 = jnp.sum(ring0, axis=-1)
    sum_after = jnp.where(last_reset >= 0, ccum - ccum_at_reset,
                          ccum + sum0[None])
    n_eff = jnp.minimum(count_after, MOVING_AVG_SZ)
    mean = jnp.where(n_eff > 0, sum_after / jnp.maximum(n_eff, 1), 0.0)

    final_reset = last_reset[-1]
    live = push & (tt > final_reset)
    onehot = (slot[..., None] == jnp.arange(MOVING_AVG_SZ,
                                            dtype=jnp.int32)) \
        & live[..., None]
    pushed_any = jnp.any(onehot, axis=0)
    pushed_val = jnp.sum(onehot.astype(jnp.float32) * est[..., None], axis=0)
    base = jnp.where((final_reset >= 0)[..., None], 0.0, ring0)
    ring_f = jnp.where(pushed_any, pushed_val, base)
    return ring_f, count_after[-1], mean


def _capture_chain(state0: TriggerState, raw: RawStepOutput, sss_valid,
                   sub5, cell_id, gatherable, k: int):
    """Per-step capture selection (reference mib tag gating + the in-scan
    published_live reacquisition semantics, lib/mib_impl.cc:109-135).

    All inputs [S, ..., R]; `gatherable` gates candidates whose slot-1 read
    would cross n_valid (deferred + counted, never gathered misaligned).
    Returns per-step (want_cap, slot, fresh) plus final (cnt, mib_cell,
    pending_fresh, p_live, overflow)."""
    tagged = raw.emit & (~raw.lost) & sss_valid

    # published_live: starts at `published`, cleared by any in-chunk loss
    not_lost_cum = jnp.cumprod(1 - raw.lost.astype(jnp.int32), axis=0)
    p_live_after = state0.published[None] & (not_lost_cum > 0)   # [S, .., R]
    p_live_before = jnp.concatenate(
        [jnp.broadcast_to(state0.published[None], p_live_after[:1].shape),
         p_live_after[:-1]], axis=0)
    # the step's own loss clears the gate before capture gating (parity with
    # the reference: mib re-attempts the very next half-frame after a drop)
    p_gate = p_live_before & (~raw.lost)

    want_any = tagged & (~p_gate) & (~sub5)
    eligible = want_any & gatherable
    cum_excl = jnp.cumsum(eligible.astype(jnp.int32), axis=0) \
        - eligible.astype(jnp.int32)
    want_cap = eligible & (cum_excl < k)
    slot = jnp.where(want_cap, cum_excl, -1)
    overflow = jnp.sum((want_any & (~want_cap)).astype(jnp.int32), axis=0)
    cnt = jnp.sum(want_cap.astype(jnp.int32), axis=0)

    # (pending_fresh, mib_cell) chain, closed form over the step axis: a
    # capture sets cell & clears pf, a loss sets pf (mutually exclusive per
    # step — losses are never tagged), so before-step values follow from
    # the most recent prior event of each kind.  No sequential scan (each
    # scan step is a separate loop iteration of tiny kernels).
    s = want_cap.shape[0]
    tt = jnp.arange(s, dtype=jnp.int32).reshape(
        (s,) + (1,) * (want_cap.ndim - 1))
    cap_idx = jnp.where(want_cap, tt, -1)
    lost_idx = jnp.where(raw.lost, tt, -1)
    last_cap = jax.lax.cummax(cap_idx, axis=0)
    last_lost = jax.lax.cummax(lost_idx, axis=0)
    neg1 = jnp.full_like(last_cap[:1], -1)
    last_cap_x = jnp.concatenate([neg1, last_cap[:-1]], axis=0)
    last_lost_x = jnp.concatenate([neg1, last_lost[:-1]], axis=0)
    cell_at = jnp.take_along_axis(cell_id, jnp.maximum(last_cap_x, 0), axis=0)
    cell_before = jnp.where(last_cap_x >= 0, cell_at, state0.mib_cell[None])
    pf_before = jnp.where((last_cap_x < 0) & (last_lost_x < 0),
                          state0.pending_fresh[None],
                          last_lost_x > last_cap_x)
    fresh = pf_before | (cell_id != cell_before)
    cell_f = jnp.where(
        last_cap[-1] >= 0,
        jnp.take_along_axis(cell_id, jnp.maximum(last_cap[-1:], 0),
                            axis=0)[0],
        state0.mib_cell)
    pf_f = jnp.where((last_cap[-1] < 0) & (last_lost[-1] < 0),
                     state0.pending_fresh, last_lost[-1] > last_cap[-1])
    return (want_cap, slot, fresh, cnt, cell_f, pf_f,
            p_live_after[-1], overflow)


def _decode_candidates(state0: TriggerState, buffer: cplx.Pair,
                      cand_start, cand_freq, cand_cell, cand_cp, cand_fresh,
                      valid, combine: bool, grid0=None, n_steps=None):
    """Batched PBCH + Viterbi over the captured candidates.

    cand_* : [..., R, K]; returns per-candidate verdicts [..., R, K] and the
    updated TTI accumulator carry."""
    k = cand_cell.shape[-1]
    batch = cand_cell.shape[:-2]

    # lazy slot-1 extraction + capture-time CFO rotation (phase continues
    # from the aligned frame start: slot-1 sample n had aligned index
    # 960 + n)
    if CAND_EXTRACT == "dense" and grid0 is not None:
        slot1 = _gather_cands_dense(buffer, cand_start, grid0, n_steps)
    else:
        slot1 = _gather_cands(buffer, cand_start, SLOT_LENGTH)
    slot1 = cfo_ops.cfo_rotate(slot1, cand_freq, SLOT_LENGTH)

    flat = (slot1[0].reshape((-1, SLOT_LENGTH)),
            slot1[1].reshape((-1, SLOT_LENGTH)))
    cells_flat = cand_cell.reshape(-1)

    # CP hypotheses: real batches are CP-uniform (a dispatch's candidates
    # come from one or a few cells, and deployed cells are Normal-CP), so
    # the common case runs ONE OFDM/chest/equalize front end instead of
    # both.
    # Mixed-CP batches (synthetic/adversarial) take the both-CP path.
    def one_cp(cp_flag: bool):
        def f(_):
            c = jax.vmap(lambda s0, s1, cid: pbch.pbch_quarter_llrs_slot1(
                (s0, s1), cid, cp_flag))(flat[0], flat[1], cells_flat)
            return c.reshape(batch + (R, k, 3, 4, 120))
        return f

    def mixed_cp(_):
        both = jax.vmap(pbch.quarter_llrs_both_cp)(
            flat, cells_flat)                 # [BRK, 2, 3, 4, 120]
        both = both.reshape(batch + (R, k, 2, 3, 4, 120))
        return jnp.where(cand_cp[..., None, None, None],
                         both[..., 1, :, :, :], both[..., 0, :, :, :])

    all_norm = jnp.all(cand_cp | ~valid)
    all_ext = jnp.all((~cand_cp) | ~valid)
    contrib = jax.lax.cond(
        all_norm, one_cp(True),
        lambda _: jax.lax.cond(all_ext, one_cp(False), mixed_cp, None),
        None)

    # TTI soft-combining chain over the K slots (reference
    # srslte_ue_mib_decode's 40 ms frame buffer): 4 TTI-phase hypotheses,
    # phase h restarts its accumulator at quarter 0
    def chain(carry, xs):
        acc, n, cell = carry                  # [.., R, 3, 4, 120] etc
        c_k, fresh_k, cell_k, valid_k = xs
        if not combine:
            fresh_k = jnp.ones_like(fresh_k)
        restart = fresh_k | (cell_k != cell)
        n_k = jnp.where(restart, 0, n)
        q = jnp.mod(n_k[..., None] + jnp.arange(4, dtype=jnp.int32), 4)
        sel = jnp.take_along_axis(c_k, q[..., None, :, None], axis=-2)
        # a restart (loss or cell-id change) clears the accumulator for
        # EVERY phase hypothesis, not just the q==0 one: phases 1-3
        # otherwise add the new candidate's LLRs onto the PREVIOUS cell's
        # accumulated energy, which can CRC-pass the old payload under the
        # new (junk) cell id — the randomized sharded-vs-continuous
        # property test caught exactly that (noise-tail SSS misdecodes
        # publishing phantom cells with the real cell's MIB fields).
        # Reference parity: srsLTE re-inits its PBCH state on cell change
        # (lib/mib_impl.cc:148-160).
        acc_base = jnp.where(restart[..., None, None, None],
                             jnp.zeros_like(acc), acc)
        acc_new = jnp.where((q == 0)[..., None, :, None], sel,
                            acc_base + sel)
        acc_out = jnp.where(valid_k[..., None, None, None], acc_new, acc)
        n_out = jnp.where(valid_k, n_k + 1, n)
        cell_out = jnp.where(valid_k, cell_k, cell)
        return (acc_out, n_out, cell_out), (acc_out, q)

    xs = tuple(jnp.moveaxis(a, -1, 0) if a.ndim == cand_cell.ndim else
               jnp.moveaxis(a, len(batch) + 1, 0)
               for a in (contrib, cand_fresh, cand_cell, valid))
    acc0 = state0.llr_acc.reshape(batch + (R, 3, 4, 120))
    (acc_f, n_f, cell_f), (accs, qs) = jax.lax.scan(
        chain, (acc0, state0.mib_n, state0.mib_cell), xs)
    # accs: [K, .., R, 3, 4, 120]; qs: [K, .., R, 4]

    llrs12 = accs.reshape((-1, 12, 120))
    quarter_of = jnp.tile(qs.reshape((-1, 1, 4)), (1, 3, 1)).reshape(-1, 12)
    res = jax.vmap(pbch.search_and_unpack)(llrs12, quarter_of)

    def kb(a):
        return jnp.moveaxis(a.reshape((k,) + batch + (R,)), 0, -1)

    found = kb(res["found"]) & valid
    return (found, kb(res["nof_prb"]), kb(res["nof_ports"]),
            kb(res["phich_ext"]), kb(res["phich_res"]),
            kb(res["sfn_offset"]), acc_f, n_f, cell_f)


def _mib_postpass(state0: TriggerState, final: TriggerState,
                  raw: RawStepOutput, buffer: cplx.Pair,
                  data_valid=None, k: int | None = None,
                  combine: bool = True, do_extract=None, do_decode=None):
    """Pass C.  Returns (final_state, StepOutput stacked [n_steps, ...]).

    data_valid: logical end of DATA (scalar or [batch, 1]-broadcastable); a
    candidate whose slot-1 read would cross it is deferred (counted in
    cap_overflow), never gathered misaligned.  Default: buffer length.
    (Distinct from scan_pass's n_valid, which bounds step OWNERSHIP — a
    time shard owns fewer steps than its halo'd buffer holds data for.)
    k: MIB capture slots (default: one per step up to K_STEP_CAP, then
    K_CANDIDATES — see module docstring).

    combine=False forces every candidate to restart the TTI accumulator —
    stateless single-subframe decoding, kept for sensitivity A/B
    measurement (apps/snr_sweep.py --no-combine).

    do_extract / do_decode: optional scalar bools overriding the internal
    gates (`any step emitted` / `any candidate captured`).  Because this
    whole module is rank-polymorphic rather than vmapped, the gates stay
    real lax.cond branches for batched (multi-channel) calls too — the
    universal no-detection case (noise channels, wideband scans) skips
    everything below pass B.
    """
    s = raw.psr.shape[0]
    if k is None:
        k = s if s <= K_STEP_CAP else K_CANDIDATES
    if data_valid is None:
        data_valid = buffer[0].shape[-1]
    data_valid = jnp.asarray(data_valid, jnp.int32)
    batch = final.score.shape[:-1]
    if do_extract is None:
        do_extract = jnp.any(raw.emit)

    zero_i = jnp.zeros(raw.psr.shape, jnp.int32)
    zero_b = jnp.zeros(raw.psr.shape, bool)

    def cheap(_):
        mean0 = _ring_mean(state0.cfo_ring, state0.cfo_count)
        cfo_mean = jnp.broadcast_to(mean0[None], raw.psr.shape)
        return (final, zero_b, zero_b, zero_i, zero_i, zero_i, zero_i,
                zero_i, zero_i, zero_i, zero_b, cfo_mean)

    def heavy(_):
        # ---- batched slot-0 tail extraction for every step ----
        grid = raw.grid                        # [S]
        gridx = grid.reshape((s,) + (1,) * (len(batch) + 1))
        st0 = gridx + raw.peak - LOOKBACK      # slot-0 start [S, .., R]
        if SEG_EXTRACT == "dense":
            seg = _extract_segs_dense(buffer, grid[0], s, raw.peak)
        elif SEG_EXTRACT == "taa":
            seg = _extract_segs_taa(buffer, st0 + SEG_OFF)
        else:
            seg = _gather_steps(buffer, st0 + SEG_OFF, SEG)  # [S,..,R,SEG]

        # ---- CFO estimate (on the PSS symbol) + ring recurrence ----
        reps = tuple(jnp.asarray(a) for a in cfo_ops.replica_pairs())
        pss_sym = cplx.index(seg, (..., slice(SEG - SYMBOL_SZ, SEG)))
        est = cfo_ops.cfo_estimate(pss_sym, reps)       # [S, .., R]

        push = raw.emit & raw.tracking
        if s <= MOVING_AVG_SZ:
            ring_f, count_f, cfo_mean = _ring_series(
                state0.cfo_ring, state0.cfo_count, est, push, raw.lost)
        else:           # dispatches longer than the ring: sequential parity
            def ring_step(carry, xs):
                ring, count = carry
                est_t, push_t, lost_t = xs
                ring = jnp.where(lost_t[..., None], 0.0, ring)
                count = jnp.where(lost_t, 0, count)
                ring = jnp.where(push_t[..., None],
                                 _ring_push(ring, count, est_t), ring)
                count = count + push_t.astype(jnp.int32)
                return (ring, count), _ring_mean(ring, count)

            (ring_f, count_f), cfo_mean = jax.lax.scan(
                ring_step, (state0.cfo_ring, state0.cfo_count),
                (est, push, raw.lost))

        # ---- rotate, CP detect, SSS (reference sss block, sss_impl.cc) ----
        freq = jnp.where(raw.tracking, -cfo_mean / SYMBOL_SZ, 0.0)
        sf = cfo_ops.cfo_rotate(seg, freq, SEG_OFF)

        # ---- PSS LS channel estimate on tracked half-frames ----
        # (reference computes srslte_pss_chest right after cfo_correct,
        # lib/pss_impl.cc:204-206; the carry keeps the LAST tracked step's
        # estimate per root.)  The last-pushed PSS SYMBOL is selected
        # first (one 0/1 sum over the step axis — exact, only one step
        # selected) and the DFT + replica conjugation run ONCE per lane
        # instead of per step.
        from ..ops import dft
        pss_rot = cplx.index(sf, (..., slice(SEG - SYMBOL_SZ, SEG)))
        tt_c = jnp.arange(s, dtype=jnp.int32).reshape(
            (s,) + (1,) * (push.ndim - 1))
        last_push = jax.lax.cummax(jnp.where(push, tt_c, -1), axis=0)[-1]
        pick = (push & (tt_c == last_push[None]))[..., None]
        sym = tuple(jnp.sum(jnp.where(pick, comp, 0.0), axis=0)
                    for comp in pss_rot)                  # [.., R, 128]
        Y62 = dft.dft_sync(sym)
        fr62, fi62 = cfo_ops.chest_replicas()
        chv = cplx.mul_conj(Y62, (jnp.asarray(fr62), jnp.asarray(fi62)))
        chest_f = jnp.where((last_push >= 0)[..., None, None],
                            jnp.stack(chv, axis=-1), state0.chest)

        normal_cp = sync.detect_cp(sf, end=SEG)
        nid2 = jnp.arange(R, dtype=jnp.int32)
        n_id_1, sub5 = sync.sss_decode(sf, nid2, normal_cp, end=SEG)
        sss_valid = n_id_1 >= 0
        cell_id = 3 * jnp.maximum(n_id_1, 0) + nid2

        # ---- capture selection ----
        # slot-1 of a candidate is read from [st0 + 960, st0 + 1920); defer
        # candidates that would read past data_valid (ADVICE r3: a clipped
        # streaming buffer otherwise fed zero/misaligned samples into the
        # TTI accumulator for peaks in the grid's last ~960 bins)
        gatherable = st0 + 2 * SLOT_LENGTH <= data_valid
        (want_cap, slot, fresh, cnt, cell_f0, pf_f, p_live_f,
         overflow) = _capture_chain(state0, raw, sss_valid, sub5, cell_id,
                                    gatherable, k)

        onehot = (slot[..., None] == jnp.arange(k, dtype=jnp.int32)) \
            & want_cap[..., None]                       # [S, .., R, K]

        def scatter_i(v):
            # integer fields stay integer end-to-end (a f32 one-hot
            # multiply-sum loses exactness for positions above 2^24,
            # ~8.7 s of stream — ADVICE r3)
            return jnp.sum(jnp.where(onehot, v[..., None], 0), axis=0)

        def scatter_f(v):
            x = v[..., None].astype(jnp.float32) * onehot.astype(jnp.float32)
            return jnp.sum(x, axis=0)

        cand_cell = scatter_i(cell_id)
        cand_cp = scatter_i(normal_cp.astype(jnp.int32)) > 0
        cand_fresh = scatter_i(fresh.astype(jnp.int32)) > 0
        cand_start = scatter_i(st0 + SLOT_LENGTH)
        cand_freq = scatter_f(freq)
        valid = jnp.arange(k, dtype=jnp.int32) < cnt[..., None]

        inner_decode = jnp.sum(cnt) > 0 if do_decode is None else do_decode

        def dheavy(_):
            return _decode_candidates(state0, buffer, cand_start, cand_freq,
                                      cand_cell, cand_cp, cand_fresh, valid,
                                      combine, grid0=grid[0], n_steps=s)

        def dcheap(_):
            zi = jnp.zeros(batch + (R, k), jnp.int32)
            return (jnp.zeros(batch + (R, k), bool), zi, zi, zi, zi, zi,
                    state0.llr_acc.reshape(batch + (R, 3, 4, 120)),
                    state0.mib_n, state0.mib_cell)

        (found, prb_rk, ports_rk, pext_rk, pres_rk, sfn_rk,
         acc_f, n_f, cell_f) = jax.lax.cond(inner_decode, dheavy, dcheap,
                                            None)

        # ---- publish-once-per-epoch (epoch = cumulative fresh count) ----
        fresh_eff = cand_fresh & valid
        e = jnp.cumsum(fresh_eff.astype(jnp.int32), axis=-1)    # [.., R, K]
        same_ep = e[..., :, None] == e[..., None, :]
        ks = jnp.arange(k, dtype=jnp.int32)
        j_lt_k = ks[None, :] < ks[:, None]                      # [K(k), K(j)]
        prior = jnp.any(same_ep & j_lt_k & found[..., None, :], axis=-1)
        is_pub = found & ~prior & ~(state0.published[..., None] & (e == 0))

        # ---- map candidate verdicts back to step space ----
        track_event = jnp.any(onehot & is_pub[None], axis=-1)   # [S, .., R]

        def fld(a):
            x = jnp.sum(jnp.where(onehot, a[None], 0), axis=-1)
            return jnp.where(track_event, x, 0)

        new_final = final._replace(
            cfo_ring=ring_f, cfo_count=count_f,
            llr_acc=acc_f.reshape(batch + (R, 12, 120)),
            mib_n=n_f, mib_cell=cell_f,
            pending_fresh=pf_f,
            cap_overflow=state0.cap_overflow + overflow,
            chest=chest_f,
        )
        return (new_final, track_event, raw.lost, fld(prb_rk),
                fld(ports_rk), fld(pext_rk), fld(pres_rk), fld(sfn_rk),
                cell_id, zero_i + normal_cp.astype(jnp.int32),
                jnp.zeros(raw.psr.shape, bool), cfo_mean)

    (mid_final, track_event, lost_e, nof_prb, nof_ports, phich_ext,
     phich_res, sfn_offset, cell_id_o, normal_cp_i, _pad, cfo_mean) = \
        jax.lax.cond(do_extract, heavy, cheap, None)

    # ---- published/drop state machine over steps, log-depth ----
    t, l = track_event, lost_e
    A, B = jax.lax.associative_scan(
        lambda x, y: (x[0] & y[0], (x[1] & y[0]) | y[1]), (~l, t), axis=0)
    p0 = state0.published[None]
    p_incl = (p0 & A) | B
    p_before = jnp.concatenate(
        [jnp.broadcast_to(p0, p_incl[:1].shape), p_incl[:-1]], axis=0)
    drop_event = l & p_before
    S2, I2 = jax.lax.associative_scan(
        lambda x, y: (x[0] | y[0], jnp.where(y[0], y[1], x[1])),
        (t, jnp.where(t, cell_id_o, 0)), axis=0)
    id0 = state0.pub_cell_id[None]
    id_incl = jnp.where(S2, I2, id0)
    id_before = jnp.concatenate(
        [jnp.broadcast_to(id0, id_incl[:1].shape), id_incl[:-1]], axis=0)

    final_state = mid_final._replace(
        published=p_incl[-1],
        pub_cell_id=id_incl[-1],
    )
    out = StepOutput(
        track_event=track_event,
        drop_event=drop_event,
        drop_cell_id=id_before,
        cell_id=cell_id_o,
        nof_prb=nof_prb,
        nof_ports=nof_ports,
        phich_ext=phich_ext,
        phich_res=phich_res,
        sfn_offset=sfn_offset,
        normal_cp=normal_cp_i > 0,
        psr=raw.psr,
        score=raw.score,
        tracking=raw.tracking,
        cfo_mean=cfo_mean,
        consumed=raw.consumed,
    )
    return final_state, out


_BOOL_FIELDS = ("track_event", "drop_event", "normal_cp", "tracking")
_F32_FIELDS = ("psr", "cfo_mean")


def pack_output(out: StepOutput) -> jnp.ndarray:
    """StepOutput -> ONE [n_steps, ..., 15] float32 array.

    One device->host transfer per drain instead of 15.  Every field fits
    exactly in f32 (ids <= 503, sfn_offset <= 1020, bools)."""
    cols = [jnp.asarray(getattr(out, f)).astype(jnp.float32)
            for f in StepOutput._fields]
    return jnp.stack(cols, axis=-1)


def unpack_output(arr) -> StepOutput:
    """Inverse of pack_output, on host numpy."""
    a = np.asarray(arr)
    kw = {}
    for i, f in enumerate(StepOutput._fields):
        col = a[..., i]
        if f in _BOOL_FIELDS:
            kw[f] = col > 0.5
        elif f in _F32_FIELDS:
            kw[f] = col.astype(np.float32)
        else:
            kw[f] = col.astype(np.int32)
    return StepOutput(**kw)


def scan_engine(buffer: cplx.Pair, state: TriggerState, n_steps: int,
                psr_threshold,
                track_after: int = DEFAULT_TRACK_AFTER,
                track_every: int = DEFAULT_TRACK_EVERY,
                n_valid=None, combine: bool = True,
                grid0_static: int | None = None, data_valid=None):
    """Device-resident engine: scan `n_steps` half-frame steps over a
    padded stream buffer, then batch-decode the captured MIB candidates
    (the whole GNU Radio scheduler collapses to this).

    buffer: pair of [..., N] float32 (leading dims = channels); see
    scan_pass for the padding contract.
    n_valid bounds step OWNERSHIP (which grid steps run); data_valid bounds
    readable DATA for candidate gathers (defaults to n_valid; a time shard
    passes its halo'd extent, which exceeds its owned extent).
    returns: (final_state, StepOutput stacked [n_steps, ...])
    """
    if grid0_static is None:
        # one pad covering BOTH pass A's read-ahead and pass C's dense
        # extraction span (grid0 is traced, so worst-case grid0 = N), done
        # here so the postpass sees the same padded buffer as the scan
        span_c = n_steps * HALF_FRAME_LENGTH + 640
        pad = jnp.zeros(buffer[0].shape[:-1] + (span_c,), jnp.float32)
        buffer = (jnp.concatenate([buffer[0], pad], axis=-1),
                  jnp.concatenate([buffer[1], pad], axis=-1))
    else:
        # dense extraction reads [grid0 - 384, grid0 + n_steps*9600 + 256)
        assert buffer[0].shape[-1] >= grid0_static + \
            n_steps * HALF_FRAME_LENGTH + 256, "buffer too short for pass C"
        assert grid0_static >= 384
    final, raw = scan_pass(buffer, state, n_steps, psr_threshold,
                           track_after, track_every, n_valid=n_valid,
                           grid0_static=grid0_static, pad_dynamic=False)
    if data_valid is None:
        data_valid = n_valid
    return _mib_postpass(state, final, raw, buffer, data_valid=data_valid,
                         combine=combine)
