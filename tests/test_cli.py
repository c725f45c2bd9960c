"""CLI parity tests (reference examples/cell_search_file.py interface)."""

import json
import os
import threading

import numpy as np
import pytest

from ltetrigger_jax.apps import cell_search_file as cli
from ltetrigger_jax.utils.eng_notation import num_to_str, str_to_num
from tests.conftest import FRAMES, TEST_FRAMES_DIR


def test_eng_notation():
    assert str_to_num("15.36M") == 15.36e6
    assert str_to_num("1.92M") == 1.92e6
    assert str_to_num("192k") == 192e3
    assert str_to_num("7") == 7.0
    assert num_to_str(15.36e6) == "15.36M"
    with pytest.raises(ValueError):
        str_to_num("")


def _frame_path(nof_prb):
    name, _, _ = FRAMES[nof_prb]
    p = TEST_FRAMES_DIR / name
    if not p.exists():
        pytest.skip("test vectors unavailable")
    return str(p)


def test_cli_finds_cell(capsys):
    rc = cli.main([_frame_path(6), "-s", "1.92M", "--repeat",
                   "--time-out", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Starting cell search" in out
    payload = out[out.index("{"):]
    rec = json.loads(payload)
    assert rec["status"] == "FOUND"
    assert rec["cell_id"] == 123
    assert rec["nof_prb"] == 6
    assert rec["cp_len"] == "Normal"


def test_cli_resampled_cut_off(capsys):
    rc = cli.main([_frame_path(25), "-s", "7.68M", "--repeat",
                   "--time-out", "1", "-c", "7.68M", "--json-only"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["status"] == "FOUND" and rec["cell_id"] == 124


def test_cli_not_found(tmp_path, capsys):
    rng = np.random.default_rng(0)
    noise = (0.1 * (rng.normal(size=19200) + 1j * rng.normal(size=19200))
             ).astype(np.complex64)
    f = tmp_path / "noise.iq"
    noise.tofile(f)
    rc = cli.main([str(f), "-s", "1.92M", "--time-out", "0.1",
                   "--json-only"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec == {"status": "NOT_FOUND"}


def test_cli_bad_rate(capsys):
    # 5 MHz used to be rejected (reference behavior); the rational
    # resampler now accepts any p/q rate, so only non-rational rates fail
    rc = cli.main([_frame_path(6), "-s", "1.9200001M", "--json-only"])
    assert rc == -1


def test_cli_fifo_output(tmp_path, capsys):
    fifo = str(tmp_path / "cells.fifo")
    os.mkfifo(fifo)
    got = {}

    def reader():
        with open(fifo, "rb") as fh:
            got["data"] = fh.read()

    t = threading.Thread(target=reader)
    t.start()
    rc = cli.main([_frame_path(6), "-s", "1.92M", "--repeat",
                   "--time-out", "1", "--fifoname", fifo, "--json-only"])
    t.join(timeout=30)
    assert rc == 0
    data = got["data"].decode()
    length, _, body = data.partition("\n")
    assert int(length) == len(body)
    rec = json.loads(body)
    assert rec["cell_id"] == 123 and rec["status"] == "FOUND"


def test_live_monitor(tmp_path, capsys):
    """Pipe a looped capture through the live monitor; status lines and a
    track event must appear (rtlsdr-demo probe parity)."""
    import io
    import json as _json

    from ltetrigger_jax.apps import live_monitor

    iq, cell_id, _ = __import__("tests.conftest", fromlist=["load_frame"]) \
        .load_frame(6)
    data = np.tile(iq, 12).tobytes()
    out = io.StringIO()
    live_monitor.run(io.BytesIO(data), psr_threshold=4.0, refresh_every=4,
                     out=out)
    events = [_json.loads(line) for line in out.getvalue().splitlines()]
    kinds = {e["event"] for e in events}
    assert "status" in kinds and "track" in kinds
    track = next(e for e in events if e["event"] == "track")
    assert track["cell_id"] == cell_id
    status = [e for e in events if e["event"] == "status"][-1]
    assert status["tracking"][cell_id % 3]
    assert status["cells"] == [cell_id]
    # observability: the driver's per-stage timing must be live
    assert set(status["stages"]) == {"prep", "scan", "drain"}
    assert all(v >= 0 for v in status["stages"].values())
    # waterfall analogue (reference rtlsdr demo's QT waterfall sink): one
    # coarse PSD line per status refresh, LTE energy above the band edges
    psd = status["psd_db"]
    assert len(psd) == 32
    mid = np.mean(psd[12:20])
    edges = np.mean(psd[:4] + psd[-4:])
    assert mid > edges + 3, "in-band LTE energy must stand out of the PSD"


def test_trigger_stage_timer():
    """Trigger.process accumulates per-stage wall clock (SURVEY §5 gap)."""
    from ltetrigger_jax.models import api
    from tests.conftest import load_frame

    iq, _, _ = load_frame(6)
    t = api.Trigger(psr_threshold=4)
    t.process(np.tile(iq, 4))
    t.flush()
    summary = t.timer.summary()
    assert {"prep", "scan", "drain"} <= set(summary)
    for name in ("prep", "scan", "drain"):
        assert summary[name]["count"] >= 1
        assert summary[name]["total_s"] > 0
    t.timer.reset()
    assert t.timer.summary() == {}


def test_live_monitor_multi_source():
    """Several IQ sources through one MultiTrigger pipeline: per-stream
    track events, per-stream cell lists in the status, silence-padding for
    a source that ends early."""
    import io
    import json as _json

    from ltetrigger_jax.apps import live_monitor
    from tests.conftest import load_frame

    iq, cell_id, _ = load_frame(6)
    rng = np.random.default_rng(3)
    sig = np.tile(iq, 10)
    noise = (0.3 * (rng.normal(size=len(sig) // 2)
                    + 1j * rng.normal(size=len(sig) // 2))) \
        .astype(np.complex64)          # half-length: ends early -> fill_gap
    out = io.StringIO()
    live_monitor.run_multi([io.BytesIO(sig.tobytes()),
                            io.BytesIO(noise.tobytes())],
                           psr_threshold=4.0, refresh_every=2, out=out,
                           transport="f32")
    events = [_json.loads(line) for line in out.getvalue().splitlines()]
    tracks = [e for e in events if e["event"] == "track"]
    assert tracks and all(t["stream"] == 0 for t in tracks)
    assert tracks[0]["cell_id"] == cell_id
    status = [e for e in events if e["event"] == "status"][-1]
    assert status["cells"][0] == [cell_id]
    assert status["cells"][1] == []


def test_live_monitor_wideband():
    """One wide source -> N monitored carriers (run_wideband): track events
    carry the carrier's center offset; status reports per-carrier state."""
    import io
    import json as _json

    from ltetrigger_jax.apps import live_monitor
    from ltetrigger_jax.ltecore import synth

    fa = synth.synthesize_frame(99, nof_prb_field=25)
    wide = synth.upconvert(np.tile(fa, 10), 7.68e6, 2.4e6)
    wide = (wide / np.sqrt(np.mean(np.abs(wide) ** 2))).astype(np.complex64)
    out = io.StringIO()
    live_monitor.run_wideband(io.BytesIO(wide.tobytes()), 7.68e6,
                              [-2.4e6, 2.4e6], psr_threshold=4.0,
                              refresh_every=2, out=out, transport="i8")
    events = [_json.loads(line) for line in out.getvalue().splitlines()]
    tracks = [e for e in events if e["event"] == "track"]
    assert tracks and all(t["stream"] == 1 for t in tracks)
    assert tracks[0]["cell_id"] == 99
    assert tracks[0]["center_offset_hz"] == 2.4e6
    status = [e for e in events if e["event"] == "status"][-1]
    assert status["cells"][1] == [99]
    assert status["cells"][0] == []
    # the wideband waterfall line covers the whole band: the +2.4 MHz
    # carrier's energy sits in the upper half of the DC-centered PSD
    psd = status["psd_db"]
    assert len(psd) == 32
    assert np.mean(psd[20:28]) > np.mean(psd[4:12]) + 3
