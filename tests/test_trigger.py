"""Integration tests for the fused trigger pipeline — the device
equivalents of the reference's 4 known-answer QA tests
(python/qa_downlink_trigger_c.py) plus state-machine behavior tests the
reference never had."""

import jax.numpy as jnp
import numpy as np
import pytest

from ltetrigger_jax.ltecore import synth
from ltetrigger_jax.models import api, trigger as trig
from ltetrigger_jax.runtime.cellstore import CellStore
from tests.conftest import load_frame


@pytest.mark.parametrize("nof_prb", [6, 25, 50, 100])
def test_known_answer_search(nof_prb):
    """Reference QA parity: 1 s of looped capture, threshold 4,
    exit_on_success — assert all six fields (qa_downlink_trigger_c.py)."""
    iq, cell_id, rate = load_frame(nof_prb)
    cells = api.search(iq, rate, psr_threshold=4, exit_on_success=True,
                       max_seconds=1.0)
    assert cells, "No message triggered"
    cell = cells[0]
    assert cell.cell_id == cell_id
    assert cell.cp_len == "Normal"
    assert cell.nof_phich_resources == "1"
    assert cell.nof_prb == nof_prb
    assert cell.nof_tx_ports == 1
    assert cell.phich_len == "Normal"


def test_search_noise_not_found():
    rng = np.random.default_rng(0)
    noise = (rng.normal(size=19200) + 1j * rng.normal(size=19200)) \
        .astype(np.complex64)
    cells = api.search(noise, 1.92e6, max_seconds=0.25)
    assert cells == []


def test_threshold_clamp():
    assert api.ensure_safe_threshold(0.5) == 1.5
    assert api.ensure_safe_threshold(4.0) == 4.0


def test_tracking_acquisition_and_loss():
    """Hysteresis contract: score saturates at track_after, tracking starts,
    then signal loss resets score and retracts the published cell."""
    iq, cell_id, _ = load_frame(6)
    rng = np.random.default_rng(1)

    store = CellStore()
    trigger = api.Trigger(psr_threshold=4, cellstore=store)
    n_frames = 20
    sig = np.tile(iq, n_frames)
    trigger.process(sig)
    trigger.flush()

    lane = cell_id % 3
    assert trigger.tracking[lane], "should be tracking after 20 half-frames"
    assert trigger.tracking_score[lane] == 16
    assert store.tracking()
    assert store.latest_cell().cell_id == cell_id
    assert trigger.max_psr[lane] > 4.0
    assert abs(trigger.mean_cfo[lane]) < 0.05   # synthetic capture: no CFO

    # now feed noise at the signal's own RMS: tracking must drop and the
    # published cell must be retracted.  While tracking, correlation
    # re-runs only every track_every-th half-frame (stale PSR reused in
    # between, reference lib/pss_impl.cc:163-172) and the EMA'd
    # correlation decays gradually, so give it a couple dozen half-frames.
    sigma = 3.0 * float(np.sqrt(np.mean(np.abs(iq) ** 2)))
    noise = sigma * (rng.normal(size=19200 * 20)
                     + 1j * rng.normal(size=19200 * 20))
    trigger.process(noise.astype(np.complex64))
    trigger.flush()
    assert not trigger.tracking[lane]
    assert trigger.tracking_score[lane] == 0
    assert not store.tracking(), "drop event must empty the cellstore"


def test_trigger_streaming_chunks_equivalent():
    """Feeding odd-sized chunks produces the same detection as one shot."""
    iq, cell_id, _ = load_frame(6)
    sig = np.tile(iq, 6)

    t1 = api.Trigger(psr_threshold=4)
    cells1 = t1.process(sig) + t1.flush()

    t2 = api.Trigger(psr_threshold=4)
    cells2 = []
    for i in range(0, len(sig), 7777):
        cells2.extend(t2.process(sig[i:i + 7777]))
    cells2.extend(t2.flush())

    assert [c.cell_id for c in cells1] == [c.cell_id for c in cells2]
    assert cells1 and cells1[0].cell_id == cell_id
    np.testing.assert_allclose(t1.mean_psr, t2.mean_psr, rtol=1e-5)


def test_scan_engine_matches_streaming():
    """Device-resident scan and host streaming produce identical events."""
    iq, cell_id, _ = load_frame(6)
    sig = np.tile(iq, 4)

    from ltetrigger_jax.ops import cplx
    sp = cplx.from_numpy(sig)
    zh = jnp.zeros(trig.LOOKBACK, jnp.float32)
    zt = jnp.zeros(trig.WINDOW, jnp.float32)
    buffer = (jnp.concatenate([zh, sp[0], zt]),
              jnp.concatenate([zh, sp[1], zt]))
    state = trig.init_state()
    _, out = trig.scan_engine(buffer, state, 7, 4.0)
    track_steps, track_roots = np.where(np.asarray(out.track_event))
    assert len(track_steps) == 1
    assert track_roots[0] == cell_id % 3
    assert int(out.cell_id[track_steps[0], track_roots[0]]) == cell_id


def test_exit_on_success_stops():
    iq, cell_id, _ = load_frame(6)
    trigger = api.Trigger(psr_threshold=4, exit_on_success=True)
    cells = trigger.process(np.tile(iq, 10))
    assert len(cells) == 1
    assert trigger.done
    assert trigger.process(np.tile(iq, 2)) == []


def test_extended_cp_cell_via_search():
    """A capability the reference has but never ships a fixture for."""
    f = synth.synthesize_frame(301, nof_prb_field=25, normal_cp=False,
                               nof_ports=2).astype(np.complex64)
    cells = api.search(f, 1.92e6, max_seconds=0.3)
    assert cells and cells[0].cell_id == 301
    assert cells[0].cp_len == "Extended"
    assert cells[0].nof_tx_ports == 2
    assert cells[0].nof_prb == 25


def test_search_multi_quarter_tti_stream():
    """A realistic stream where the PBCH quarter cycles 1,2,3,0 frame to
    frame (the bundled captures loop a single quarter-0 frame, so this path
    — including the TTI-phase bookkeeping of the soft-combiner — is
    otherwise never exercised end-to-end)."""
    cell_id = 142
    frames = [synth.synthesize_frame(cell_id, nof_prb_field=100,
                                     sfn=q, quarter=q) for q in (1, 2, 3, 0)]
    sig = np.concatenate(frames).astype(np.complex64)
    cells = api.search(sig, 1.92e6, psr_threshold=4, max_seconds=0.5)
    assert cells and cells[0].cell_id == cell_id
    assert cells[0].nof_prb == 100


def test_reacquisition_within_one_chunk():
    """After a mid-chunk tracking loss drops a published cell, MIB capture
    must resume IMMEDIATELY (in-scan published_live gating) — the reference
    re-attempts the very next half-frame (lib/mib_impl.cc:109-135), not at
    the next scan dispatch."""
    iq, cell_id, _ = load_frame(6)
    rng = np.random.default_rng(7)
    store = CellStore()
    trigger = api.Trigger(psr_threshold=4, cellstore=store)

    # chunk(s) 1: publish the cell
    assert trigger.process(np.tile(iq, 4)) + trigger.flush()
    assert store.tracking()

    # one process call whose FIRST internal chunk (16 steps) contains the
    # loss AND the reacquisition: 2 half-frames of loud noise, then frames
    sigma = 3.0 * float(np.sqrt(np.mean(np.abs(iq) ** 2)))
    noise = sigma * (rng.normal(size=19200) + 1j * rng.normal(size=19200))
    burst = np.concatenate([noise.astype(np.complex64), np.tile(iq, 4)])
    cells = trigger.process(burst) + trigger.flush()
    assert cells and cells[0].cell_id == cell_id, \
        "reacquisition must publish within the same scan chunk"
    assert store.tracking()


def _hostile_burst(cell_id: int, n_bad: int, n_good: int):
    """`n_bad` PBCH-corrupted + `n_good` clean copies of ONE subframe-0
    half-frame: every half-frame tags a MIB capture (hostile all-sub0
    stream; real frames alternate sub0/sub5)."""
    rng = np.random.default_rng(3)
    half = synth.synthesize_frame(cell_id, nof_prb_field=50)[:9600]
    bad = half.copy()
    bad[960:1920] = (0.2 * (rng.normal(size=960) + 1j * rng.normal(size=960)))
    return np.concatenate([np.tile(bad, n_bad), np.tile(half, n_good)]) \
        .astype(np.complex64)


def _engine_buffer(sig: np.ndarray):
    from ltetrigger_jax.ops import cplx

    sp = cplx.from_numpy(sig)
    zh = jnp.zeros(trig.LOOKBACK, jnp.float32)
    zt = jnp.zeros(trig.WINDOW, jnp.float32)
    return (jnp.concatenate([zh, sp[0], zt]),
            jnp.concatenate([zh, sp[1], zt]))


def test_capture_overflow_defers_not_loses():
    """Hostile stream: EVERY step wants a MIB capture (25 > the old K=16
    burst), then the stream goes SILENT forever.  Driver-path dispatches
    (<= K_STEP_CAP steps) allocate one capture slot per step, so the whole
    burst decodes in-dispatch and the cell publishes even though no further
    candidate ever arrives (VERDICT r3 #7)."""
    cell_id = 151
    burst = _hostile_burst(cell_id, 20, 5)          # 25 capture-worthy steps
    silence = np.zeros(4 * 9600, dtype=np.complex64)
    buffer = _engine_buffer(np.concatenate([burst, silence]))

    state = trig.init_state()
    state, out1 = trig.scan_engine(buffer, state, 25, 4.0)
    lane = cell_id % 3
    assert int(state.cap_overflow[lane]) == 0, \
        "a <=32-step dispatch has a capture slot per step: no overflow"
    steps, roots = np.where(np.asarray(out1.track_event))
    assert len(steps) >= 1, \
        "the >16-capture burst must publish within its own dispatch"
    assert roots[0] == lane
    assert int(out1.cell_id[steps[0], roots[0]]) == cell_id

    # the silence afterwards produces no retraction (loss only drops the
    # cell after it was tracking-published and hysteresis decays)
    state, out2 = trig.scan_engine(buffer, state, 4, 4.0)
    assert not np.asarray(out2.track_event).any()


def test_capture_overflow_counted_long_dispatch():
    """Dispatches longer than K_STEP_CAP (offline channel_scan shape) bound
    the decode batch at K_CANDIDATES and COUNT the deferred captures in
    cap_overflow — the documented fallback, observable not silent."""
    cell_id = 151
    sig = _hostile_burst(cell_id, 40, 0)
    buffer = _engine_buffer(sig)

    state = trig.init_state()
    state, _out = trig.scan_engine(buffer, state, 40, 4.0)
    lane = cell_id % 3
    assert int(state.cap_overflow[lane]) > 0, \
        "a 40-step all-capture dispatch must overflow K=16 and count it"


def test_capture_edge_deferral_no_misaligned_gather():
    """A capture whose peak lands in the grid's last ~960 bins would read
    slot 1 past n_valid (ADVICE r3 medium): it must be deferred + counted,
    never gathered from unuploaded/misaligned samples.  Earlier candidates
    keep publishing identically."""
    cell_id = 153
    frame = synth.synthesize_frame(cell_id, nof_prb_field=50)
    # 8767 samples of lead-in puts every sub0 PSS peak at grid bin 9599
    lead = np.zeros(8767, dtype=np.complex64)
    sig = np.concatenate([lead, np.tile(frame, 8)]).astype(np.complex64)
    buffer = _engine_buffer(sig)
    n_steps = 15
    lane = cell_id % 3

    # full visibility: baseline behavior
    st_full, out_full = trig.scan_engine(buffer, trig.init_state(), n_steps,
                                         2.0)
    assert np.asarray(out_full.track_event).any()
    full_overflow = int(st_full.cap_overflow[lane])

    # clip n_valid so the LAST step is active (grid + 9728 <= n_valid) but
    # its candidate is not gatherable (grid + 8767 + 1920 > n_valid)
    last_grid = trig.LOOKBACK + 9600 * (n_steps - 1)
    n_valid = last_grid + 10000
    st_clip, out_clip = trig.scan_engine(buffer, trig.init_state(), n_steps,
                                         2.0, n_valid=n_valid)
    # the final step ran (consumed) but its capture was deferred + counted
    assert np.asarray(out_clip.consumed)[-1].all()
    extra = int(st_clip.cap_overflow[lane]) - full_overflow
    assert extra >= 1, "edge capture must be counted as deferred"
    # earlier captures publish identically (no llr_acc pollution upstream)
    np.testing.assert_array_equal(
        np.asarray(out_full.track_event)[:-1],
        np.asarray(out_clip.track_event)[:-1])


def test_ring_series_matches_sequential():
    """The postpass's closed-form telemetry-ring recurrence (_ring_series)
    must match the per-step reset-then-push semantics exactly, including
    wrap-around evictions of incoming-ring values and mid-sequence
    resets."""
    import jax

    rng = np.random.default_rng(5)
    S, C, R = 100, 2, 3
    for _trial in range(2):
        count0_np = rng.integers(0, 500, size=(C, R))
        ring0 = rng.normal(size=(C, R, 200)).astype(np.float32)
        idx = np.arange(200)
        ring0 *= idx[None, None, :] < np.minimum(count0_np[..., None], 200)
        ring0 = jnp.asarray(ring0)
        count0 = jnp.asarray(count0_np, jnp.int32)
        est = jnp.asarray(rng.normal(size=(S, C, R)).astype(np.float32))
        push_np = rng.random((S, C, R)) < 0.6
        lost = jnp.asarray((rng.random((S, C, R)) < 0.1) & ~push_np)
        push = jnp.asarray(push_np)

        rf1, cf1, m1 = trig._ring_series(ring0, count0, est, push, lost)

        def ring_step(carry, xs):
            ring, count = carry
            est_t, push_t, lost_t = xs
            ring = jnp.where(lost_t[..., None], 0.0, ring)
            count = jnp.where(lost_t, 0, count)
            ring = jnp.where(push_t[..., None],
                             trig._ring_push(ring, count, est_t), ring)
            count = count + push_t.astype(jnp.int32)
            return (ring, count), trig._ring_mean(ring, count)

        (rf2, cf2), m2 = jax.lax.scan(ring_step, (ring0, count0),
                                      (est, push, lost))
        np.testing.assert_allclose(np.asarray(rf1), np.asarray(rf2),
                                   atol=1e-5)
        np.testing.assert_array_equal(np.asarray(cf1), np.asarray(cf2))
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), atol=1e-4)


def test_checkpoint_resume(tmp_path):
    """Streaming state survives a save/load cycle mid-acquisition."""
    iq, cell_id, _ = load_frame(6)
    lane = cell_id % 3

    t1 = api.Trigger(psr_threshold=4)
    t1.process(np.tile(iq, 4))          # partially acquired (score < 16)
    t1.flush()
    score_before = int(t1.tracking_score[lane])
    assert 0 < score_before < 16

    ckpt = str(tmp_path / "trigger.npz")
    t1.save_state(ckpt)

    t2 = api.Trigger(psr_threshold=4)
    t2.load_state(ckpt)
    assert int(t2.tracking_score[lane]) == score_before

    # both continue identically
    more = np.tile(iq, 8)
    t1.process(more)
    t2.process(more)
    t1.flush()
    t2.flush()
    np.testing.assert_array_equal(t1.tracking_score, t2.tracking_score)
    np.testing.assert_array_equal(t1.tracking, t2.tracking)
    np.testing.assert_allclose(t1.mean_psr, t2.mean_psr, rtol=1e-6)
    assert t2.tracking[lane]


def test_cfo_recovery_end_to_end():
    """A 0.2-subcarrier CFO (3 kHz) breaks uncorrected PBCH decode but
    keeps the PSS PSR over threshold; after acquisition (16 half-frames)
    the running-mean CFO correction kicks in (reference
    lib/pss_impl.cc:197-204) and the MIB decodes.  (Larger CFOs lower the
    PSS correlation peak below threshold 4 — same physics as srsLTE.)"""
    f = synth.synthesize_frame(123, nof_prb_field=25)
    n = np.arange(f.size, dtype=np.float64)
    cfo = 0.2  # subcarrier spacings
    rx = (f * np.exp(2j * np.pi * cfo / 128.0 * n)).astype(np.complex64)

    # sanity: without correction the subframe must NOT decode
    from ltetrigger_jax.ltecore import refrx
    assert refrx.mib_decode_subframe(rx[:1920].astype(np.complex128),
                                     123) is None

    cells = api.search(rx, 1.92e6, psr_threshold=4, max_seconds=0.5)
    assert cells and cells[0].cell_id == 123
    assert cells[0].nof_prb == 25

    # telemetry: the estimated CFO must match the injected one
    store = CellStore()
    t = api.Trigger(psr_threshold=4, cellstore=store)
    t.process(np.tile(rx, 25))
    t.flush()
    lane = 123 % 3
    assert t.tracking[lane]
    assert abs(t.mean_cfo[lane] - cfo) < 0.05


def test_integer_cfo_search():
    """A 1.3-subcarrier CFO kills the normal matched filter (PSR < 4) but
    cfo_search_range=2 pre-rotates by the best integer bin and the cell
    decodes (capability the reference keeps disabled in srsLTE)."""
    f = synth.synthesize_frame(200, nof_prb_field=50)
    n = np.arange(f.size, dtype=np.float64)
    rx = (f * np.exp(2j * np.pi * 1.3 / 128.0 * n)).astype(np.complex64)

    assert api.search(rx, 1.92e6, max_seconds=0.3) == []
    cells = api.search(rx, 1.92e6, max_seconds=0.5, cfo_search_range=2)
    assert cells and cells[0].cell_id == 200
    assert cells[0].nof_prb == 50


def test_tracking_start_time_from_stream_position(monkeypatch):
    """tracking_start_time derives from WHEN the detected samples ARRIVED,
    not when the (possibly pipeline-delayed) drain happened: a deep-pipeline
    run and a synchronous run stamp the same instant (VERDICT r3 #6; the
    reference stamps at in-block publish, lib/mib_impl.cc:246-248, which on
    its synchronous scheduler is the arrival instant)."""
    iq, cell_id, _ = load_frame(6)
    sig = np.tile(iq, 12)
    chunks = [sig[i:i + 9600] for i in range(0, len(sig), 9600)]

    clock = {"t": 1_700_000_000.0}
    monkeypatch.setattr(api.time, "time", lambda: clock["t"])

    def run(pipeline):
        clock["t"] = 1_700_000_000.0
        trg = api.Trigger(psr_threshold=4, pipeline=pipeline)
        got = []
        for ch in chunks:
            got += trg.process(ch)
            clock["t"] += 10.0          # 10 s per half-frame: unambiguous
        got += trg.flush()
        return got, clock["t"]

    cells_sync, _end_sync = run(0)
    cells_deep, end_deep = run(3)
    assert cells_sync and cells_deep
    t_sync = cells_sync[0].tracking_start_time
    t_deep = cells_deep[0].tracking_start_time
    assert t_sync == t_deep, \
        "pipeline depth must not move the published timestamp"
    assert t_deep <= end_deep - 50, \
        "timestamp must track the detection's stream position, not drain"


def test_streaming_integer_cfo_acquisition(tmp_path):
    """A live stream at 1.3-subcarrier offset never acquires through the
    plain driver, but cfo_search_range=2 probes replica banks while
    untracked, rotates the device mirror by the winning bin
    (phase-continuously), and the cell publishes (VERDICT r3 #5 — the
    search()-only capability now runs in the streaming path)."""
    f = synth.synthesize_frame(200, nof_prb_field=50)
    sig = np.tile(f, 12)
    n = np.arange(sig.size, dtype=np.float64)
    rx = (sig * np.exp(2j * np.pi * 1.3 / 128.0 * n)).astype(np.complex64)

    plain = api.Trigger(psr_threshold=4)
    assert plain.process(rx) + plain.flush() == [], \
        "the uncorrected matched filter must NOT see a 1.3-sc offset cell"

    trg = api.Trigger(psr_threshold=4, cfo_search_range=2)
    cells = []
    for i in range(0, len(rx), 19200):
        cells += trg.process(rx[i:i + 19200])
    cells += trg.flush()
    assert cells and cells[0].cell_id == 200
    assert trg._cfo_bin != 0, "acquisition must have come from a probe hit"

    # the probed bin survives checkpoint/resume
    ckpt = str(tmp_path / "cfo.npz")
    trg.save_state(ckpt)
    trg2 = api.Trigger(psr_threshold=4, cfo_search_range=2)
    trg2.load_state(ckpt)
    assert trg2._cfo_bin == trg._cfo_bin


def test_seg_extract_paths_agree():
    """The dense one-hot-matmul slot-0 extraction (default) must be
    BIT-IDENTICAL to the reference vmapped-gather path for random peaks
    (one-hot f32 matmuls select exactly), including batched channels and
    non-divisible group shapes."""
    rng = np.random.default_rng(9)
    for S, batch in ((12, ()), (10, (3,))):
        n = trig.LOOKBACK + S * 9600 + trig.WINDOW
        buf = (jnp.asarray(rng.normal(size=batch + (n,)).astype(np.float32)),
               jnp.asarray(rng.normal(size=batch + (n,)).astype(np.float32)))
        peak = jnp.asarray(rng.integers(0, 9600, size=(S,) + batch + (3,)),
                           jnp.int32)
        grid = trig.LOOKBACK + 9600 * jnp.arange(S, dtype=jnp.int32)
        gridx = grid.reshape((S,) + (1,) * (len(batch) + 1))
        starts = gridx + peak - trig.LOOKBACK + trig.SEG_OFF

        ref = trig._gather_steps(buf, starts, trig.SEG)
        dense = trig._extract_segs_dense(buf, jnp.int32(trig.LOOKBACK),
                                         S, peak)
        taa = trig._extract_segs_taa(buf, starts)
        for a, b in zip(ref, dense):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(ref, taa):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cand_extract_paths_agree():
    """The dense candidate slot-1 extraction (default) must be
    BIT-IDENTICAL to the vmapped-gather path for random capture positions
    (one-hot f32 selection is exact), including batched channels and
    invalid slots (start=0 sentinels -> all-zero rows)."""
    rng = np.random.default_rng(13)
    for S, batch, K in ((12, (), 12), (10, (3,), 10)):
        n = trig.LOOKBACK + S * 9600 + trig.WINDOW
        buf = (jnp.asarray(rng.normal(size=batch + (n,)).astype(np.float32)),
               jnp.asarray(rng.normal(size=batch + (n,)).astype(np.float32)))
        s_cand = rng.integers(0, S, size=batch + (3, K))
        peak = rng.integers(0, 9600, size=batch + (3, K))
        grid0 = trig.LOOKBACK
        starts = (grid0 + 9600 * s_cand + peak
                  - trig.LOOKBACK + trig.SLOT_LENGTH).astype(np.int32)
        # a couple of invalid slots carry the scatter sentinel start 0
        starts[..., -1] = 0
        starts = jnp.asarray(starts)

        ref = trig._gather_cands(buf, starts, trig.SLOT_LENGTH)
        dense = trig._gather_cands_dense(buf, starts, jnp.int32(grid0), S)
        if len(batch) == 1:
            # exercise the memory-bounding lax.map chunk path too
            import unittest.mock
            with unittest.mock.patch.object(trig, "_CAND_CHUNK", 1):
                chunked = trig._gather_cands_dense(buf, starts,
                                                   jnp.int32(grid0), S)
            for a, b in zip(dense, chunked):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(ref, dense):
            a = np.asarray(a).copy()
            b = np.asarray(b).copy()
            # the gather path CLAMPS invalid starts and reads real samples;
            # the dense path zeroes them — compare only the valid slots,
            # and require exact zeros on the sentinel slot
            assert (b[..., -1, :] == 0).all()
            np.testing.assert_array_equal(a[..., :-1, :], b[..., :-1, :])


def test_no_phantom_cells_from_stale_tti_accumulator():
    """After a cell's signal ends, the EMA-pinned peak keeps emitting over
    the noise tail for a while and SSS misdecodes produce junk cell-id
    candidates.  Those candidates must NEVER inherit the previous cell's
    accumulated PBCH energy: before the fix, TTI phases 1-3 added the
    noise LLRs onto the real cell's accumulator and CRC-passed its payload
    under the junk id (phantom publishes — found by the sharded-vs-
    continuous property test)."""
    cell_id = 20
    rng = np.random.default_rng(14)
    total = 16 * 9600
    frame = synth.synthesize_frame(cell_id, nof_prb_field=50)
    sig = np.zeros(total, np.complex128)
    sig[46880:46880 + 2 * 19200] = np.tile(frame, 2)
    sp = np.mean(np.abs(frame) ** 2)
    sigma = np.sqrt(sp / (2 * 10 ** 0.6))          # 6 dB SNR
    sig += sigma * (rng.normal(size=total) + 1j * rng.normal(size=total))
    buffer = _engine_buffer(sig.astype(np.complex64))

    _, out = trig.scan_engine(buffer, trig.init_state(), 16, 4.0)
    ids = set(np.asarray(out.cell_id)[np.asarray(out.track_event)].tolist())
    assert ids == {cell_id}, f"phantom cells published: {ids - {cell_id}}"


def test_mixed_cp_cells_same_dispatch():
    """Two superimposed cells with DIFFERENT CP types on different N_id_2
    roots must both decode from one dispatch — exercises the mixed-CP
    decode branch (the uniform-CP fast paths cover real deployments)."""
    norm = synth.synthesize_frame(210, nof_prb_field=25, normal_cp=True)
    ext = synth.synthesize_frame(302, nof_prb_field=50, normal_cp=False)
    assert 210 % 3 != 302 % 3
    sig = np.concatenate([np.tile(norm, 6), np.tile(ext, 6)]) \
        .astype(np.complex64)
    buffer = _engine_buffer(sig)
    _, out = trig.scan_engine(buffer, trig.init_state(), 24, 2.0)
    te = np.asarray(out.track_event)
    ids = set(np.asarray(out.cell_id)[te].tolist())
    assert {210, 302} <= ids, f"got {ids}"
    cp = np.asarray(out.normal_cp)
    for s, r in zip(*np.where(te)):
        if out.cell_id[s, r] == 210:
            assert cp[s, r]
        if out.cell_id[s, r] == 302:
            assert not cp[s, r]


def test_integer_cfo_search_late_signal():
    """A capture whose cell only appears AFTER the first 4 half-frames must
    still probe the right integer-CFO bin (the probe windows are spread
    across the buffer; probing only the head returned bin 0 here)."""
    f = synth.synthesize_frame(200, nof_prb_field=50)
    lead = np.zeros(5 * 9600, dtype=np.complex64)      # silent head
    sig = np.concatenate([lead, np.tile(f, 8)])
    n = np.arange(sig.size, dtype=np.float64)
    rx = (sig * np.exp(2j * np.pi * 1.3 / 128.0 * n)).astype(np.complex64)
    cells = api.search(rx, 1.92e6, max_seconds=0.5, cfo_search_range=2)
    assert cells and cells[0].cell_id == 200


def test_channel_estimate_telemetry():
    """Trigger.channel_estimate (reference srslte_pss_chest telemetry,
    lib/pss_impl.cc:206-209): on a flat channel the 62-subcarrier LS
    estimate is flat; through a 2-tap multipath channel its magnitude
    profile matches the channel's analytic |H(f)| at the PSS subcarriers."""
    cell_id = 150
    f = synth.synthesize_frame(cell_id, nof_prb_field=50)
    root = cell_id % 3
    ks = np.r_[np.arange(-31, 0), np.arange(1, 32)]      # subcarrier order

    def run(sig):
        t = api.Trigger(psr_threshold=4, transport="f32")
        for i in range(0, len(sig), 19200):
            t.process(sig[i:i + 19200])
        t.flush()
        return t

    # flat channel
    sig = np.tile(f, 12).astype(np.complex64)
    t = run(sig)
    assert t.tracking[root]
    ch = t.channel_estimate[root]
    assert np.abs(ch).min() > 0, "chest must be populated once tracking"
    flat = np.abs(ch)
    assert flat.std() / flat.mean() < 0.1, "flat channel must look flat"
    # untracked roots keep zeros
    other = [r for r in range(3) if r != root]
    assert np.all(t.channel_estimate[other] == 0)

    # 2-tap channel: h = [1, 0, 0.5] -> |H(k)| = |1 + 0.5 e^{-2pi i 2k/128}|
    taps = [(0, 1.0), (2, 0.5)]
    faded = synth.multipath_channel(np.tile(f, 12), taps).astype(np.complex64)
    t2 = run(faded)
    assert t2.tracking[root]
    got = np.abs(t2.channel_estimate[root])
    want = np.abs(1.0 + 0.5 * np.exp(-2j * np.pi * 2 * ks / 128.0))
    cos = np.dot(got, want) / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.98, f"chest magnitude profile off: cos={cos}"
    # and the profile is genuinely non-flat (the notch is visible)
    assert got.max() / got.min() > 1.5


def test_trigger_backlog_property():
    iq, _, _ = load_frame(6)
    t = api.Trigger(psr_threshold=4, pipeline=0)
    assert t.backlog == 0
    t.process(np.tile(iq, 2))
    t.flush()
    # the correlator reads 128 samples past a grid position, so the final
    # half-frame stays buffered until more samples arrive
    assert 0 <= t.backlog <= 9600 + 128
