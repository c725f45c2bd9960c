"""MultiTrigger: N host-fed streams through one batched dispatch pipeline.

The headline contract (VERDICT r3 #1): per-stream events are identical to
running N separate single-stream Triggers over the same chunks — the [N]
axis only batches work, never mixes streams.
"""

import numpy as np
import pytest

from ltetrigger_jax.ltecore import synth
from ltetrigger_jax.models import api
from ltetrigger_jax.models.multi import MultiTrigger
from tests.conftest import load_frame

CHUNK = 19200


def _streams_3():
    """Three dissimilar streams: a real capture, pure noise, a synth cell."""
    iq, cell_id, _ = load_frame(6)
    rng = np.random.default_rng(11)
    noise = (0.5 * (rng.normal(size=6 * CHUNK)
                    + 1j * rng.normal(size=6 * CHUNK))).astype(np.complex64)
    cell2 = synth.synthesize_frame(207, nof_prb_field=25)
    sigs = [np.tile(iq, 6),
            noise,
            np.tile(cell2, 6).astype(np.complex64)]
    n = min(len(s) for s in sigs)
    return [s[:n] for s in sigs], {0: cell_id, 2: 207}


def test_multi_matches_single_stream_events():
    sigs, expect = _streams_3()

    # N separate single-stream triggers (bit-exact transport)
    singles = [api.Trigger(psr_threshold=4, transport="f32")
               for _ in sigs]
    for t, s in zip(singles, sigs):
        for i in range(0, len(s), CHUNK):
            t.process(s[i:i + CHUNK])
        t.flush()

    multi = MultiTrigger(3, psr_threshold=4, transport="f32")
    events = []
    for i in range(0, len(sigs[0]), CHUNK):
        events += multi.process_all([s[i:i + CHUNK] for s in sigs])
    events += multi.flush()

    for n in range(3):
        want = [c.cell_id for c in singles[n].cellstore.cells()]
        got = [c.cell_id for c in multi.stores[n].cells()]
        assert got == want, f"stream {n}: {got} != single-run {want}"
    assert {n for n, _ in events} == set(expect)
    for n, cid in expect.items():
        assert multi.stores[n].latest_cell().cell_id == cid
    assert multi.stores[1].cells() == []

    # telemetry parity per stream (same engine, same samples, f32)
    np.testing.assert_allclose(
        multi.mean_psr,
        np.stack([t.mean_psr for t in singles]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        multi.tracking_score,
        np.stack([t.tracking_score for t in singles]))


@pytest.mark.parametrize("transport", ["i16", "i8", "i4"])
def test_multi_quantized_transports_detect(transport):
    sigs, expect = _streams_3()
    multi = MultiTrigger(3, psr_threshold=4, transport=transport)
    for i in range(0, len(sigs[0]), CHUNK):
        multi.process_all([s[i:i + CHUNK] for s in sigs])
    multi.flush()
    for n, cid in expect.items():
        assert multi.stores[n].latest_cell() is not None, \
            f"stream {n} lost its cell under {transport} transport"
        assert multi.stores[n].latest_cell().cell_id == cid
    assert multi.stores[1].cells() == []


def test_multi_shared_consumption_and_fill_gap():
    """The group advances at the slowest stream's pace; fill_gap unblocks."""
    iq, cell_id, _ = load_frame(6)
    sig = np.tile(iq, 6)
    multi = MultiTrigger(2, psr_threshold=4, transport="f32")

    # feed only stream 0: nothing can scan (stream 1 has no data)
    multi.process(0, sig)
    multi.flush()
    assert multi.stores[0].cells() == []
    assert multi.backlog[0] > multi.backlog[1]

    # declare the same span as dropped on stream 1: group unblocks and
    # stream 0 publishes; stream 1 (silence) stays quiet
    multi.fill_gap(1, len(sig))
    multi.flush()
    assert multi.stores[0].latest_cell().cell_id == cell_id
    assert multi.stores[1].cells() == []


def test_multi_loss_drops_only_that_stream():
    iq, cell_id, _ = load_frame(6)
    rng = np.random.default_rng(5)
    sig = np.tile(iq, 6)
    multi = MultiTrigger(2, psr_threshold=4, transport="f32")
    multi.process_all([sig, sig])
    multi.flush()
    assert multi.stores[0].tracking() and multi.stores[1].tracking()

    # stream 1 degrades to noise; stream 0 keeps the cell
    sigma = 3.0 * float(np.sqrt(np.mean(np.abs(iq) ** 2)))
    noise = (sigma * (rng.normal(size=len(sig))
                      + 1j * rng.normal(size=len(sig)))).astype(np.complex64)
    drops = []
    multi.on_drop = lambda n, cid: drops.append((n, cid))
    multi.process_all([np.tile(iq, 6), noise])
    multi.flush()
    assert multi.stores[0].tracking(), "stream 0 must keep its cell"
    assert not multi.stores[1].tracking(), "stream 1 must drop"
    assert (1, cell_id) in drops and (0, cell_id) not in drops


def test_multi_checkpoint_resume(tmp_path):
    sigs, expect = _streams_3()
    path = str(tmp_path / "multi.npz")

    # checkpoint mid-stream; post-resume event streams must be identical
    # (CellStore contents are the app's to persist, same contract as the
    # single-stream checkpoint test)
    m1 = MultiTrigger(3, psr_threshold=4, transport="f32")
    m1.process_all([s[:2 * CHUNK] for s in sigs])
    m1.save_state(path)

    m2 = MultiTrigger(3, psr_threshold=4, transport="f32")
    m2.load_state(path)
    evs = {}
    for key, m in (("m1", m1), ("m2", m2)):
        e = m.process_all([s[2 * CHUNK:] for s in sigs])
        e += m.flush()
        evs[key] = [(n, c.cell_id) for n, c in e]
    assert evs["m1"] == evs["m2"]
    np.testing.assert_allclose(m1.mean_psr, m2.mean_psr, rtol=1e-5)
    np.testing.assert_array_equal(m1.tracking_score, m2.tracking_score)


def test_rebase_preserves_detection(monkeypatch):
    """Stream-coordinate rebase (int32 overflow protection, normally at
    2^29 samples = ~4.7 min) must be transparent: detections and telemetry
    continue across the wrap.  Threshold patched small so the test streams
    seconds, not minutes."""
    from ltetrigger_jax.models import api
    from tests.conftest import load_frame as lf

    iq, cell_id, _ = lf(6)
    sig = np.tile(iq, 16)

    monkeypatch.setattr(api.Trigger, "REBASE_AT", 4 * 19200)
    monkeypatch.setattr(MultiTrigger, "REBASE_AT", 4 * 19200)

    # pipeline=0: fully-drained synchronous calls so stream positions
    # advance per call on the slow CPU backend (on a GPU the pipelined
    # driver harvests continuously and hits the same path)
    t1 = api.Trigger(psr_threshold=4, transport="f32", pipeline=0)
    cells = []
    for i in range(0, len(sig), 9600):
        cells += t1.process(sig[i:i + 9600])
    cells += t1.flush()
    # stream-coordinate end < samples fed <=> coordinates were shifted down
    assert t1._base + len(t1._buf) < len(sig), "rebase must have fired"
    assert any(c.cell_id == cell_id for c in cells)
    assert t1.tracking[cell_id % 3]

    m = MultiTrigger(2, psr_threshold=4, transport="f32", pipeline=0)
    ev = []
    for i in range(0, len(sig), 9600):
        ev += m.process_all([sig[i:i + 9600]] * 2)
    ev += m.flush()
    assert m._base + len(m._bufs[0]) < len(sig), \
        "multi rebase must have fired"
    for n in range(2):
        assert m.stores[n].latest_cell().cell_id == cell_id


def test_multi_streaming_integer_cfo_acquisition(tmp_path):
    """Mirror of test_trigger.py::test_streaming_integer_cfo_acquisition
    for the multi path (VERDICT r4 weak #5): stream 0 carries a cell at a
    +1.3-subcarrier offset (invisible to the plain matched filter), stream
    1 an on-frequency cell.  cfo_search_range=2 must acquire BOTH — the
    probe rotates only the offset stream's mirror rows — and the probed
    bins survive checkpoint/resume."""
    f = synth.synthesize_frame(200, nof_prb_field=50)
    sig = np.tile(f, 12)
    n = np.arange(sig.size, dtype=np.float64)
    rx_off = (sig * np.exp(2j * np.pi * 1.3 / 128.0 * n)) \
        .astype(np.complex64)
    iq, cell_id, _ = load_frame(6)
    rx_on = np.tile(iq, 12)[:rx_off.size]

    plain = MultiTrigger(2, psr_threshold=4)
    for i in range(0, len(rx_off), CHUNK):
        plain.process_all([rx_off[i:i + CHUNK], rx_on[i:i + CHUNK]])
    plain.flush()
    assert plain.stores[0].cells() == [], \
        "the uncorrected filter must NOT see a 1.3-sc offset cell"
    assert plain.stores[1].latest_cell().cell_id == cell_id

    m = MultiTrigger(2, psr_threshold=4, cfo_search_range=2)
    for i in range(0, len(rx_off), CHUNK):
        m.process_all([rx_off[i:i + CHUNK], rx_on[i:i + CHUNK]])
    m.flush()
    assert m.stores[0].latest_cell() is not None \
        and m.stores[0].latest_cell().cell_id == 200
    assert m.stores[1].latest_cell().cell_id == cell_id
    assert m._cfo_bins[0] != 0, "stream 0 must have acquired via a probe"
    assert m._cfo_bins[1] == 0, "on-frequency stream must stay unrotated"

    ckpt = str(tmp_path / "multi_cfo.npz")
    m.save_state(ckpt)
    m2 = MultiTrigger(2, psr_threshold=4, cfo_search_range=2)
    m2.load_state(ckpt)
    np.testing.assert_array_equal(m2._cfo_bins, m._cfo_bins)


def test_multi_sharded_over_mesh_matches_unsharded():
    """8 streams sharded over an 8-device `ch` mesh produce exactly the
    unsharded events and telemetry (the [N] axis partitions with zero
    cross-device communication; same jitted programs, shardings propagate
    from the inputs)."""
    from ltetrigger_jax.parallel import make_mesh

    iq, cell_id, _ = load_frame(6)
    rng = np.random.default_rng(21)
    sigs = []
    for i in range(8):
        if i % 2 == 0:
            sigs.append(np.tile(iq, 6))
        else:
            n = len(np.tile(iq, 6))
            sigs.append((0.4 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                         ).astype(np.complex64))

    def run(mesh):
        m = MultiTrigger(8, psr_threshold=4, transport="f32", mesh=mesh)
        ev = []
        for i in range(0, len(sigs[0]), CHUNK):
            ev += m.process_all([s[i:i + CHUNK] for s in sigs])
        ev += m.flush()
        return m, [(n, c.cell_id) for n, c in ev]

    m0, ev0 = run(None)
    m1, ev1 = run(make_mesh(n_channels=8, n_time=1))
    assert ev0 == ev1
    assert ev1 and {n for n, _ in ev1} == {0, 2, 4, 6}
    np.testing.assert_allclose(m0.mean_psr, m1.mean_psr, rtol=1e-5)
    np.testing.assert_array_equal(m0.tracking_score, m1.tracking_score)
