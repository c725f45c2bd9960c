#!/usr/bin/env python
"""Live cell monitor: stream IQ in, live telemetry + tracked cells out.

The reference's rtlsdr_ltetrigger.grc demo (osmosdr source -> trigger, QT
probes polling tracking_score / latest_cell) rebuilt as a headless tool: any
SDR process pipes raw complex64 at 1.92 Msps into stdin or a FIFO,

    rtl_sdr ... | csdr convert_u8_c | ... | \\
        python -m ltetrigger_jax.apps.live_monitor -

and the monitor prints a status line per refresh plus JSON events for every
tracked/dropped cell.  The probe surface (per-root tracking_score, mean_psr,
mean_cfo, max_psr, latest_cell) is exactly what the GRC function probes
polled (reference lib/pss_impl.h:95-100, cellstore query API).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _psd_db(chunk: np.ndarray, nbins: int = 32) -> list[float]:
    """Coarse PSD of the latest chunk (dB, DC-centered, `nbins` bins) —
    one waterfall LINE per status refresh: the headless analogue of the
    reference rtlsdr demo's QT waterfall sink (a UI renders the status
    stream's psd_db rows as the waterfall)."""
    n = (len(chunk) // nbins) * nbins
    if n == 0:
        return [0.0] * nbins
    spec = np.fft.fftshift(np.abs(np.fft.fft(chunk[:n])) ** 2)
    p = spec.reshape(nbins, -1).mean(axis=1) / max(n, 1)
    return np.round(10.0 * np.log10(p + 1e-30), 1).tolist()


def run(stream, psr_threshold: float = 4.0, chunk_samples: int = 19200,
        refresh_every: int = 10, out=sys.stdout, max_chunks=None) -> None:
    from ..models import api

    def on_track(cell):
        print(json.dumps({"event": "track", **cell.to_dict()}), file=out,
              flush=True)

    def on_drop(cell_id):
        print(json.dumps({"event": "drop", "cell_id": cell_id}), file=out,
              flush=True)

    trig = api.Trigger(psr_threshold=psr_threshold, on_track=on_track,
                       on_drop=on_drop)
    n = 0
    t0 = time.time()
    while max_chunks is None or n < max_chunks:
        raw = stream.read(chunk_samples * 8)
        if not raw:
            break
        samples = np.frombuffer(raw, dtype=np.complex64)
        trig.process(samples)          # events drain async (pipeline mode)
        n += 1
        if n % refresh_every == 0:
            score = trig.tracking_score
            status = {
                "t": round(time.time() - t0, 1),
                "psd_db": _psd_db(samples),
                "tracking_score": score.tolist(),
                "tracking": trig.tracking.tolist(),
                "mean_psr": np.round(trig.mean_psr, 2).tolist(),
                "max_psr": np.round(trig.max_psr, 2).tolist(),
                "mean_cfo": np.round(trig.mean_cfo, 4).tolist(),
                "cells": [c.cell_id for c in trig.cellstore.cells()],
                # per-stage driver timing (prep/scan/drain mean ms) — the
                # observability layer the reference lacks (SURVEY §5)
                "stages": {name: round(st["mean_ms"], 3)
                           for name, st in trig.timer.summary().items()},
            }
            print(json.dumps({"event": "status", **status}), file=out,
                  flush=True)
    trig.flush()                       # surface any still-pending events


def run_multi(streams, psr_threshold: float = 4.0,
              chunk_samples: int = 19200, refresh_every: int = 10,
              out=sys.stdout, max_chunks=None,
              transport: str = "i16") -> None:
    """N sources -> ONE MultiTrigger pipeline (one SDR per carrier; the
    reference needs one process per carrier).  Sources are read
    round-robin one chunk each; a source that ends is padded with silence
    (fill_gap semantics) so the group keeps flowing."""
    from ..models.multi import MultiTrigger

    n_streams = len(streams)

    def on_track(stream_idx, cell):
        print(json.dumps({"event": "track", "stream": stream_idx,
                          **cell.to_dict()}), file=out, flush=True)

    def on_drop(stream_idx, cell_id):
        print(json.dumps({"event": "drop", "stream": stream_idx,
                          "cell_id": cell_id}), file=out, flush=True)

    trig = MultiTrigger(n_streams, psr_threshold=psr_threshold,
                        on_track=on_track, on_drop=on_drop,
                        transport=transport)
    ended = [False] * n_streams
    n = 0
    t0 = time.time()
    while max_chunks is None or n < max_chunks:
        chunks = []
        for i, st in enumerate(streams):
            raw = b"" if ended[i] else st.read(chunk_samples * 8)
            if not raw:
                ended[i] = True
                chunks.append(np.zeros(chunk_samples, np.complex64))
            else:
                chunks.append(np.frombuffer(raw, dtype=np.complex64))
        if all(ended):
            break
        trig.process_all(chunks)
        n += 1
        if n % refresh_every == 0:
            status = {
                "t": round(time.time() - t0, 1),
                "tracking_score": trig.tracking_score.tolist(),
                "tracking": trig.tracking.tolist(),
                "mean_psr": np.round(trig.mean_psr, 2).tolist(),
                "mean_cfo": np.round(trig.mean_cfo, 4).tolist(),
                "backlog": trig.backlog.tolist(),
                "cells": [[c.cell_id for c in s.cells()]
                          for s in trig.stores],
                "stages": {name: round(st["mean_ms"], 3)
                           for name, st in trig.timer.summary().items()},
            }
            print(json.dumps({"event": "status", **status}), file=out,
                  flush=True)
    trig.flush()


def run_wideband(stream, sample_rate: float, centers,
                 psr_threshold: float = 4.0, chunk_samples: int = 0,
                 refresh_every: int = 10, out=sys.stdout, max_chunks=None,
                 transport: str = "i8") -> None:
    """ONE wideband source -> N monitored carriers (WidebandTrigger): one
    SDR and one upload stream replace N per-carrier pipes (the reference
    needs one process AND one SDR per carrier).  `stream` carries raw
    complex64 at `sample_rate` (an integer multiple of 1.92 MHz)."""
    from ..models.wideband import WidebandTrigger

    ratio = int(round(sample_rate / 1.92e6))
    if not chunk_samples:
        chunk_samples = 19200 * ratio          # one radio frame of band

    def on_track(stream_idx, cell):
        print(json.dumps({"event": "track", "stream": stream_idx,
                          "center_offset_hz": centers[stream_idx],
                          **cell.to_dict()}), file=out, flush=True)

    def on_drop(stream_idx, cell_id):
        print(json.dumps({"event": "drop", "stream": stream_idx,
                          "center_offset_hz": centers[stream_idx],
                          "cell_id": cell_id}), file=out, flush=True)

    trig = WidebandTrigger(sample_rate, centers,
                           psr_threshold=psr_threshold,
                           on_track=on_track, on_drop=on_drop,
                           transport=transport)
    n = 0
    t0 = time.time()
    while max_chunks is None or n < max_chunks:
        raw = stream.read(chunk_samples * 8)
        if not raw:
            break
        wide_chunk = np.frombuffer(raw, dtype=np.complex64)
        trig.process_wide(wide_chunk)
        n += 1
        if n % refresh_every == 0:
            status = {
                "t": round(time.time() - t0, 1),
                "psd_db": _psd_db(wide_chunk),    # whole-band waterfall line
                "centers_hz": centers,
                "tracking_score": trig.tracking_score.tolist(),
                "tracking": trig.tracking.tolist(),
                "mean_psr": np.round(trig.mean_psr, 2).tolist(),
                "mean_cfo": np.round(trig.mean_cfo, 4).tolist(),
                "backlog": trig.backlog.tolist(),
                "cells": [[c.cell_id for c in s.cells()]
                          for s in trig.stores],
                "stages": {name: round(st["mean_ms"], 3)
                           for name, st in trig.timer.summary().items()},
            }
            print(json.dumps({"event": "status", **status}), file=out,
                  flush=True)
    trig.flush()


def main(argv=None) -> int:
    from ..utils.eng_notation import str_to_num

    p = argparse.ArgumentParser(prog="live_monitor")
    p.add_argument("sources", nargs="+",
                   help="'-' for stdin, or path(s) (FIFO / growing file) of "
                        "raw complex64 at 1.92 Msps; several paths monitor "
                        "several carriers through ONE device pipeline")
    p.add_argument("--threshold", type=float, default=4.0)
    p.add_argument("--chunk", type=int, default=0,
                   help="samples per read (default: one radio frame)")
    p.add_argument("--refresh", type=int, default=10,
                   help="status line every N chunks")
    p.add_argument("--transport", default=None,
                   choices=("f32", "i16", "i8", "i4"),
                   help="host->device sample encoding (default: i16 for "
                        "narrow multi-source, i8 for --wideband)")
    p.add_argument("--wideband", action="store_true",
                   help="the single source is a WIDE band; channelize on "
                        "device to --centers (one SDR, N carriers)")
    p.add_argument("-s", "--sample-rate", type=str, default="1.92M",
                   help="wideband input rate, eng notation (with "
                        "--wideband; integer multiple of 1.92M)")
    p.add_argument("--centers", type=str, default="0",
                   help="comma-separated carrier offsets from band center, "
                        "eng notation (with --wideband), e.g. "
                        "-5.76M,-1.92M,1.92M,5.76M")
    args = p.parse_args(argv)

    streams = [sys.stdin.buffer if s == "-" else open(s, "rb")
               for s in args.sources]
    try:
        if args.wideband:
            assert len(streams) == 1, "--wideband takes exactly one source"
            centers = [str_to_num(tok) for tok in args.centers.split(",")
                       if tok.strip()]
            run_wideband(streams[0], str_to_num(args.sample_rate), centers,
                         psr_threshold=args.threshold,
                         chunk_samples=args.chunk,
                         refresh_every=args.refresh,
                         transport=args.transport or "i8")
        elif len(streams) == 1:
            run(streams[0], psr_threshold=args.threshold,
                chunk_samples=args.chunk or 19200,
                refresh_every=args.refresh)
        else:
            run_multi(streams, psr_threshold=args.threshold,
                      chunk_samples=args.chunk or 19200,
                      refresh_every=args.refresh,
                      transport=args.transport or "i16")
    except KeyboardInterrupt:
        pass
    finally:
        for st in streams:
            if st is not sys.stdin.buffer:
                st.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
