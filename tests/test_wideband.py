"""Wideband channelizer + scan: synthesize two cells at different carrier
offsets inside one wide capture, find both in one pass — and the STREAMING
wideband front end (WidebandTrigger: one wide upload feeds N live
carriers, VERDICT r4 #1)."""

import numpy as np
import pytest

from ltetrigger_jax.apps.wideband_scan import wideband_scan
from ltetrigger_jax.ltecore import synth
from ltetrigger_jax.models.multi import MultiTrigger
from ltetrigger_jax.models.wideband import WidebandTrigger
from ltetrigger_jax.ops import channelize, cplx
from tests.conftest import load_frame


def test_channelizer_roundtrip():
    """Up-convert the 6 PRB capture to an offset inside a 7.68M band;
    channelizing at that offset must recover a detectable signal."""
    iq, cell_id, _ = load_frame(6)
    wide = synth.upconvert(iq.astype(np.complex128), 7.68e6, 1.5e6)
    chans = channelize.channelize(wide.astype(np.complex64), 7.68e6,
                                  [0.0, 1.5e6])
    x = cplx.to_numpy((chans[0][1], chans[1][1]))
    from ltetrigger_jax.ltecore import refrx
    power = refrx.pss_correlate(
        np.concatenate([x, x]).astype(np.complex128), cell_id % 3)
    pk, psr = refrx.peak_and_psr(power)
    assert psr > 4.0
    # the off-target channel must NOT contain the cell
    x0 = cplx.to_numpy((chans[0][0], chans[1][0]))
    _, psr0 = refrx.peak_and_psr(refrx.pss_correlate(
        np.concatenate([x0, x0]).astype(np.complex128), cell_id % 3))
    assert psr0 < 4.0


def test_wideband_scan_two_cells():
    """Two synthesized cells at different offsets in one 7.68M capture."""
    fa = synth.synthesize_frame(99, nof_prb_field=25)
    fb = synth.synthesize_frame(250, nof_prb_field=50)
    wide = (synth.upconvert(np.tile(fa, 2), 7.68e6, -2.4e6)
            + synth.upconvert(np.tile(fb, 2), 7.68e6, 2.4e6))
    wide = (wide / np.sqrt(np.mean(np.abs(wide) ** 2))).astype(np.complex64)

    out = wideband_scan(wide, 7.68e6, [-2.4e6, 0.0, 2.4e6], seconds=0.25)
    by_off = {r["center_offset_hz"]: r for r in out}
    assert by_off[-2.4e6]["detected"] and by_off[-2.4e6]["cell_id"] == 99
    assert by_off[2.4e6]["detected"] and by_off[2.4e6]["cell_id"] == 250
    assert by_off[-2.4e6]["nof_prb"] == 25
    assert by_off[2.4e6]["nof_prb"] == 50
    assert not by_off[0.0]["detected"]


# ---------------------------------------------------------------------------
# WidebandTrigger: the live multi-carrier front end
# ---------------------------------------------------------------------------
RATE = 7.68e6
CENTERS = [-2.4e6, 0.0, 2.4e6]
WCHUNK = 4 * 19200                      # wide samples per feed


def _two_cell_band(n_frames: int = 12) -> tuple[np.ndarray, dict]:
    fa = synth.synthesize_frame(99, nof_prb_field=25)
    fb = synth.synthesize_frame(250, nof_prb_field=50)
    wide = (synth.upconvert(np.tile(fa, n_frames), RATE, -2.4e6)
            + synth.upconvert(np.tile(fb, n_frames), RATE, 2.4e6))
    wide = (wide / np.sqrt(np.mean(np.abs(wide) ** 2))).astype(np.complex64)
    return wide, {0: 99, 2: 250}


def test_wideband_trigger_matches_channelized_multi():
    """WidebandTrigger events == MultiTrigger fed the one-shot channelizer's
    narrow streams: the streaming front end is the same channelizer, fed in
    context-overlapped segments."""
    wide, expect = _two_cell_band()

    chans = channelize.channelize(wide, RATE, CENTERS)
    narrow = [cplx.to_numpy((chans[0][i], chans[1][i]))
              for i in range(len(CENTERS))]
    m = MultiTrigger(len(CENTERS), psr_threshold=4, transport="f32")
    ev_m = []
    for i in range(0, len(narrow[0]), 19200):
        ev_m += m.process_all([s[i:i + 19200] for s in narrow])
    ev_m += m.flush()

    w = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport="f32")
    ev_w = []
    for i in range(0, len(wide), WCHUNK):
        ev_w += w.process_wide(wide[i:i + WCHUNK])
    ev_w += w.flush()

    assert sorted((n, c.cell_id) for n, c in ev_w) \
        == sorted((n, c.cell_id) for n, c in ev_m)
    for n, cid in expect.items():
        assert w.stores[n].latest_cell().cell_id == cid
    assert w.stores[1].cells() == []
    np.testing.assert_allclose(w.mean_psr, m.mean_psr, rtol=1e-3)
    np.testing.assert_array_equal(w.tracking_score, m.tracking_score)


def test_wideband_trigger_chunking_invariant():
    """Upload-segment boundaries are invisible: two very different wide
    chunkings produce identical events and matching telemetry (each
    segment carries real context blocks, and the mixer phase tables are
    evaluated at absolute stream indices)."""
    wide, expect = _two_cell_band()
    runs = []
    for chunk in (WCHUNK, 30720 * 7):
        w = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport="f32")
        ev = []
        for i in range(0, len(wide), chunk):
            ev += w.process_wide(wide[i:i + chunk])
        ev += w.flush()
        runs.append((ev, w.mean_psr.copy(), w.tracking_score.copy()))
    (ev_a, psr_a, sc_a), (ev_b, psr_b, sc_b) = runs
    assert sorted((n, c.cell_id) for n, c in ev_a) \
        == sorted((n, c.cell_id) for n, c in ev_b)
    np.testing.assert_allclose(psr_a, psr_b, rtol=1e-4)
    np.testing.assert_array_equal(sc_a, sc_b)


@pytest.mark.parametrize("transport", ["i16", "i8", "i4"])
def test_wideband_trigger_quantized_transports(transport):
    """The quantized transports detect through the wideband path (the
    per-channel effective SNR gains 10*log10(ratio) dB of decimation
    processing gain over the wide-stream quantization noise)."""
    wide, expect = _two_cell_band()
    w = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport=transport)
    for i in range(0, len(wide), WCHUNK):
        w.process_wide(wide[i:i + WCHUNK])
    w.flush()
    for n, cid in expect.items():
        assert w.stores[n].latest_cell() is not None, \
            f"stream {n} lost under wide {transport}"
        assert w.stores[n].latest_cell().cell_id == cid
    assert w.stores[1].cells() == []


def test_wideband_trigger_checkpoint_resume(tmp_path):
    wide, expect = _two_cell_band()
    cut = 6 * WCHUNK
    path = str(tmp_path / "wb.npz")
    w1 = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport="f32")
    for i in range(0, cut, WCHUNK):
        w1.process_wide(wide[i:i + WCHUNK])
    w1.save_state(path)
    w2 = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport="f32")
    w2.load_state(path)
    evs = {}
    for key, w in (("w1", w1), ("w2", w2)):
        e = w.process_wide(wide[cut:])
        e += w.flush()
        evs[key] = sorted((n, c.cell_id) for n, c in e)
    assert evs["w1"] == evs["w2"]
    np.testing.assert_allclose(w1.mean_psr, w2.mean_psr, rtol=1e-5)


def test_wideband_rebase_preserves_detection(monkeypatch):
    """The coordinate rebase must not jump the mixer phase (origins are
    evaluated at absolute wide indices via _wabs)."""
    monkeypatch.setattr(WidebandTrigger, "REBASE_AT", 4 * 19200)
    wide, expect = _two_cell_band(16)
    w = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport="f32",
                        pipeline=0)
    ev = []
    for i in range(0, len(wide), WCHUNK):
        ev += w.process_wide(wide[i:i + WCHUNK])
    ev += w.flush()
    assert w._base + 1 < w._fed_min() or w._base < 16 * 19200, "sanity"
    assert w._wabs > 0, "rebase must have fired"
    for n, cid in expect.items():
        assert w.stores[n].latest_cell().cell_id == cid
    # cells still tracked across the wrap
    assert w.tracking[0].any() and w.tracking[2].any()


def test_wideband_trigger_sharded_over_mesh():
    """WidebandTrigger(mesh=...): carrier lanes shard over the `ch` axis
    (one wide upload, channelized into device-sharded rows) and produce
    exactly the unsharded events and telemetry."""
    from ltetrigger_jax.parallel import make_mesh

    wide, expect = _two_cell_band()
    centers4 = CENTERS + [1.2e6]          # 4 lanes / 4-device ch axis

    def run(mesh):
        w = WidebandTrigger(RATE, centers4, psr_threshold=4,
                            transport="f32", mesh=mesh)
        ev = []
        for i in range(0, len(wide), WCHUNK):
            ev += w.process_wide(wide[i:i + WCHUNK])
        ev += w.flush()
        return w, sorted((n, c.cell_id) for n, c in ev)

    w0, ev0 = run(None)
    w1, ev1 = run(make_mesh(n_channels=4, n_time=2))
    assert ev0 == ev1
    assert {n for n, _ in ev1} == {0, 2}
    for n, cid in expect.items():
        assert w1.stores[n].latest_cell().cell_id == cid
    np.testing.assert_allclose(w0.mean_psr, w1.mean_psr, rtol=1e-5)
    np.testing.assert_array_equal(w0.tracking_score, w1.tracking_score)


def test_wideband_integer_cfo_acquisition():
    """A carrier inside the band with a 1.3-subcarrier offset (invisible
    to the plain matched filter) acquires through the inherited per-stream
    integer-CFO probe — the probe rotates only that carrier's channelized
    mirror rows."""
    fa = synth.synthesize_frame(200, nof_prb_field=50)
    sig = np.tile(fa, 12)
    n = np.arange(sig.size, dtype=np.float64)
    off = (sig * np.exp(2j * np.pi * 1.3 / 128.0 * n))
    wide = synth.upconvert(off, RATE, -2.4e6)
    fb = synth.synthesize_frame(250, nof_prb_field=50)
    wide = wide + synth.upconvert(np.tile(fb, 12), RATE, 2.4e6)
    wide = (wide / np.sqrt(np.mean(np.abs(wide) ** 2))).astype(np.complex64)

    plain = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport="f32")
    for i in range(0, len(wide), WCHUNK):
        plain.process_wide(wide[i:i + WCHUNK])
    plain.flush()
    assert plain.stores[0].cells() == [], \
        "uncorrected filter must NOT see the offset carrier"
    assert plain.stores[2].latest_cell().cell_id == 250

    w = WidebandTrigger(RATE, CENTERS, psr_threshold=4, transport="f32",
                        cfo_search_range=2)
    for i in range(0, len(wide), WCHUNK):
        w.process_wide(wide[i:i + WCHUNK])
    w.flush()
    assert w.stores[0].latest_cell() is not None \
        and w.stores[0].latest_cell().cell_id == 200
    assert w.stores[2].latest_cell().cell_id == 250
    assert w._cfo_bins[0] != 0 and w._cfo_bins[2] == 0
