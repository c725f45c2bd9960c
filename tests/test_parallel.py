"""Multi-device tests on the 8-way virtual CPU mesh — the distributed test
layer the reference has no equivalent of (SURVEY §4: 'no distributed
tests')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltetrigger_jax.models import trigger as trig
from ltetrigger_jax.parallel import (channel_scan, make_mesh,
                                     time_sharded_scan)
from tests.conftest import load_frame


def _padded(sig):
    return np.concatenate([
        np.zeros(trig.LOOKBACK, np.complex64), sig.astype(np.complex64),
        np.zeros(trig.WINDOW, np.complex64)])


def _pairify(stack_np):
    return (jnp.asarray(stack_np.real.astype(np.float32)),
            jnp.asarray(stack_np.imag.astype(np.float32)))


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["ch"] * mesh.shape["t"] == len(jax.devices())
    mesh2 = make_mesh(n_channels=4, n_time=2)
    assert mesh2.shape == {"ch": 4, "t": 2}


def test_channel_scan_sharded_matches_local():
    """8 channels sharded over 8 devices == unsharded vmap, event-for-event."""
    iq, cell_id, _ = load_frame(6)
    rng = np.random.default_rng(0)
    sig = np.tile(iq, 3)
    chans = []
    for c in range(8):
        if c % 2 == 0:
            chans.append(_padded(sig))
        else:
            n = (rng.normal(size=sig.size) + 1j * rng.normal(size=sig.size))
            chans.append(_padded(0.1 * n))
    buffers = _pairify(np.stack(chans))

    mesh = make_mesh(n_channels=8, n_time=1)
    _, out_sharded = channel_scan(buffers, 5, 4.0, mesh=mesh)
    _, out_local = channel_scan(buffers, 5, 4.0, mesh=None)

    ev_s = np.asarray(out_sharded.track_event)
    ev_l = np.asarray(out_local.track_event)
    np.testing.assert_array_equal(ev_s, ev_l)
    # signal channels (even) detect, noise channels don't
    per_chan = ev_s.any(axis=(0, 2))
    np.testing.assert_array_equal(per_chan, [True, False] * 4)
    # detected ids correct
    ids = np.asarray(out_sharded.cell_id)[ev_s]
    assert set(ids.tolist()) == {cell_id}


def test_time_sharded_scan_finds_cell_in_every_block():
    """One long stream split over 4 time shards; halo exchange keeps seams
    detection-safe and each block independently finds the cell."""
    iq, cell_id, _ = load_frame(6)
    sig = np.tile(iq, 8)                     # 8 frames -> 2 per t-shard
    mesh = make_mesh(n_channels=2, n_time=4)
    out = time_sharded_scan(_pairify(sig), mesh, 4.0)
    ev = np.asarray(out.track_event)         # [4, steps, R]
    assert ev.shape[0] == 4
    found_per_shard = ev.any(axis=(1, 2))
    assert found_per_shard.all(), f"missed in shards: {found_per_shard}"
    ids = np.asarray(out.cell_id)[ev]
    assert set(ids.tolist()) == {cell_id}


def test_time_shard_peak_straddles_seam():
    """Adversarial seam placement: the stream is offset so in every t-shard
    the last PSS peak sits 200 samples before the shard boundary — the
    emitted half-frame (and its SSS/PBCH) lives almost entirely in the
    right-neighbour halo.  Every shard must still detect the cell."""
    iq, cell_id, _ = load_frame(6)
    # peaks (PSS starts) land at 832 + 9600k in the capture; shift the
    # stream so local peaks sit at 9400, 19000, 28600, 38200 in each
    # 38400-sample shard -> the 38200 peak's aligned output needs 8440
    # samples of halo.
    shift = 9400 - 832
    sig = np.tile(iq, 9)[19200 - shift: 19200 - shift + 8 * 19200]
    mesh = make_mesh(n_channels=2, n_time=4)
    out = time_sharded_scan(_pairify(sig), mesh, 4.0)
    ev = np.asarray(out.track_event)          # [4, steps, R]
    assert ev.any(axis=(1, 2)).all(), "a shard missed the cell entirely"
    ids = np.asarray(out.cell_id)[ev.astype(bool)]
    assert set(ids.tolist()) == {cell_id}
    # the step whose search window crosses the seam (local peak 38200,
    # aligned output 8568 samples into the halo) must still identify the
    # cell with full PSR on the owning lane — in every shard with a real
    # right neighbour.  A broken halo turns these into noise.
    lane = cell_id % 3
    psr = np.asarray(out.psr)
    cid = np.asarray(out.cell_id)
    for shard in range(3):
        assert psr[shard, 3, lane] > 4.0, psr[shard]
        assert cid[shard, 3, lane] == cell_id


def test_time_shard_halo_only_detection():
    """A single radio frame placed so its only subframe-0 PSS peak is 100
    samples before the seam: the owning shard can decode it ONLY through the
    halo (the aligned half-frame, SSS and PBCH all extend past the block),
    and no other shard may double-report it."""
    iq, cell_id, _ = load_frame(6)
    stream = np.zeros(8 * 19200, np.complex64)
    g = 38400 - 100 - 832          # frame start: PSS#1 peak at 38300
    stream[g:g + 19200] = iq
    mesh = make_mesh(n_channels=2, n_time=4)
    out = time_sharded_scan(_pairify(stream), mesh, 4.0)
    ev = np.asarray(out.track_event)
    per_shard = ev.sum(axis=(1, 2))
    # shard 0 owns the peak (starts before the seam) and decodes via halo;
    # shard 1 sees only the subframe-5 half with full context (no MIB) —
    # nobody else fires.
    np.testing.assert_array_equal(per_shard, [1, 0, 0, 0])
    ids = np.asarray(out.cell_id)[ev.astype(bool)]
    assert set(ids.tolist()) == {cell_id}


def test_halo_exchange_unit():
    from ltetrigger_jax.parallel.sharded import halo_exchange_right
    from jax.sharding import PartitionSpec as P
    mesh = make_mesh(n_channels=1, n_time=8)
    x = jnp.arange(64, dtype=jnp.float32)

    def f(xl):
        return halo_exchange_right(xl[0], 4)[None]

    y = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("t"),
                              out_specs=P("t"), check_vma=False))(
        x.reshape(8, 8))
    y = np.asarray(y)
    # shard 0 holds [0..8) plus halo [8..12)
    np.testing.assert_array_equal(y[0], list(range(8)) + [8, 9, 10, 11])
    # last shard's halo is zeros
    np.testing.assert_array_equal(y[7], list(range(56, 64)) + [0, 0, 0, 0])


def test_time_sharded_matches_continuous_property():
    """Randomized property test (VERDICT r3 #4): over random frame
    placements, SNRs, CFOs, bandwidth fields and cell ids, the time-sharded
    scan detects EXACTLY the same cell-id set as the continuous unsharded
    engine.  (Event multiplicity legitimately differs: each time block
    re-acquires independently, so a long-lived cell publishes once per
    block instead of once — the documented re-detection-latency trade,
    parallel/sharded.py:19-29.  The detected-cell SET must not.)

    SNR levels sit well away from the detection knee (~-9 dB)
    so the property is deterministic, not a coin flip at the boundary.
    """
    from ltetrigger_jax.ltecore import synth

    mesh = make_mesh(n_channels=2, n_time=4)
    n_steps = 16
    total = n_steps * 9600                    # 4 t-shards x 4 steps
    rng = np.random.default_rng(2024)
    n_cases = 100
    divergences = []

    # ONE compiled executable per engine for all cases (eager per-case
    # execution mini-compiles every primitive; XLA:CPU leaks until it
    # segfaults after ~100 cases)
    continuous = jax.jit(
        lambda buf: trig.scan_engine(buf, trig.init_state(), n_steps, 4.0))

    for case in range(n_cases):
        cell_id = int(rng.integers(0, 504))
        prb = int(rng.choice([6, 25, 50, 100]))
        n_frames = int(rng.integers(2, 7))
        offset = int(rng.integers(0, total - n_frames * 19200 + 1))
        snr_db = float(rng.choice([np.inf, 6.0, -18.0]))
        cfo = float(rng.uniform(-0.3, 0.3))   # subcarrier units

        frame = synth.synthesize_frame(cell_id, nof_prb_field=prb)
        sig = np.zeros(total, np.complex128)
        sig[offset:offset + n_frames * 19200] = np.tile(frame, n_frames)
        n = np.arange(total)
        sig *= np.exp(2j * np.pi * cfo * n / 128)
        if np.isfinite(snr_db):
            sp = np.mean(np.abs(frame) ** 2)
            sigma = np.sqrt(sp / (2 * 10 ** (snr_db / 10)))
            sig += sigma * (rng.normal(size=total)
                            + 1j * rng.normal(size=total))
        sig = sig.astype(np.complex64)

        # continuous engine
        buf = _pairify(_padded(sig)[None])[0], _pairify(_padded(sig)[None])[1]
        buf = (buf[0][0], buf[1][0])
        _, out_c = continuous(buf)
        ev_c = np.asarray(out_c.track_event)
        ids_c = set(np.asarray(out_c.cell_id)[ev_c].tolist())

        # time-sharded engine
        out_s = time_sharded_scan(_pairify(sig), mesh, 4.0)
        ev_s = np.asarray(out_s.track_event)
        ids_s = set(np.asarray(out_s.cell_id)[ev_s].tolist())

        if ids_c != ids_s:
            divergences.append(
                dict(case=case, cell=cell_id, prb=prb, frames=n_frames,
                     offset=offset, snr=snr_db, cfo=round(cfo, 3),
                     continuous=sorted(ids_c), sharded=sorted(ids_s)))
        if np.isfinite(snr_db) and snr_db < -15:
            assert not ids_c, f"case {case}: detection below the knee"

    assert not divergences, \
        f"{len(divergences)}/{n_cases} diverged: {divergences[:5]}"


def test_time_sharded_knee_within_1db():
    """Seam-state cost of the `t` axis, MEASURED (VERDICT r4 #4): the
    time-sharded scan gives up EMA/TTI integration at block seams
    (parallel/sharded.py:19-29); the sweep (examples/seam_sweep.py, on
    the 6 PRB known-answer fixture) puts both knees at -9 dB with a small
    in-transition probability loss.  This pins the sharded knee
    within 1 dB of continuous: continuous detects at its -9 dB knee,
    sharded detects at -8 dB (deterministic: seeded noise, same
    realizations through both engines)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "seam_sweep",
        pathlib.Path(__file__).resolve().parent.parent / "examples"
        / "seam_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    res = {r["snr_db"]: r
           for r in mod.seam_sweep([-9.0, -8.0], n_trials=8, seed=0)}
    assert res[-9.0]["p_continuous"] >= 0.5, \
        f"continuous knee regressed: {res[-9.0]}"
    assert res[-8.0]["p_sharded"] >= 0.5, \
        f"sharded knee worse than 1 dB off continuous: {res[-8.0]}"
    # and the sharded path must not beat physics either (sanity: same
    # engine, strictly less carried state)
    assert res[-8.0]["p_continuous"] >= res[-8.0]["p_sharded"] - 0.25
