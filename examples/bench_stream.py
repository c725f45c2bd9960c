#!/usr/bin/env python
"""Streaming-driver diagnosis: per-stage wall clock of Trigger.process.

Feeds the 6-PRB capture in 4-half-frame chunks (the live-SDR shape), twice
(pass 1 compiles, pass 2 is steady state), printing the driver's StageTimer
split (prep = host buffer work, scan = dispatch, drain = device->host) and
the dispatch-depth histogram.

Usage: python examples/bench_stream.py [seconds] [chunk_halfframes] \
           [transports] [--multi N]

--multi N: N concurrent host-fed streams through ONE MultiTrigger (each
stream gets the capture; chunks fed round-robin).  Reports aggregate and
per-stream samples/s — per-stream >= 1.92e6 means every stream holds real
time.  Host->device bytes scale with N: at i16 (4 B/sample) 8 real-time
streams need 61 MB/s.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ltetrigger_jax.ltecore import synth
from ltetrigger_jax.ltecore.constants import HALF_FRAME_LENGTH
from ltetrigger_jax.models.api import Trigger



def multi_main(n_streams: int, seconds: float, chunk_hf: int, transports,
               passes: int):
    from ltetrigger_jax.models.multi import MultiTrigger

    iq = synth.known_answer_frame(6)[0]
    total = int(seconds * 1.92e6)
    sig = np.tile(iq, -(-total // iq.size))[:total]
    chunk = chunk_hf * HALF_FRAME_LENGTH

    for transport in transports:
        trg = MultiTrigger(n_streams, psr_threshold=4.0, transport=transport)
        best = 0.0
        for p in range(passes):
            trg.timer.reset()
            t0 = time.perf_counter()
            fed = 0
            for i in range(0, total, chunk):
                trg.process_all([sig[i:i + chunk]] * n_streams)
                fed += min(chunk, total - i) * n_streams
            trg.flush()
            dt = time.perf_counter() - t0
            best = max(best, fed / dt)
            print(json.dumps({
                "streams": n_streams, "transport": transport, "pass": p,
                "sps_total": round(fed / dt, 1),
                "sps_per_stream": round(fed / dt / n_streams, 1),
                "wall_s": round(dt, 2),
                "stages": {k: {kk: round(vv, 1) for kk, vv in v.items()}
                           for k, v in trg.timer.summary().items()},
            }), flush=True)
        ok = all(st.latest_cell() is not None
                 and st.latest_cell().cell_id == 123 for st in trg.stores)
        print(json.dumps({
            "streams": n_streams, "transport": transport,
            "best_sps_total": round(best, 1),
            "best_sps_per_stream": round(best / n_streams, 1),
            "realtime_per_stream": round(best / n_streams / 1.92e6, 2),
            "detections_ok": ok}), flush=True)


def main():
    args = sys.argv[1:]
    n_multi = None
    if "--multi" in args:
        i = args.index("--multi")
        n_multi = int(args[i + 1])
        args = args[:i] + args[i + 2:]
    seconds = float(args[0]) if len(args) > 0 else 0.5
    chunk_hf = int(args[1]) if len(args) > 1 else 4
    transports = args[2].split(",") if len(args) > 2 \
        else ["f32", "i16", "i8"]
    passes = int(os.environ.get("STREAM_PASSES", "5"))
    if n_multi is not None:
        return multi_main(n_multi, seconds, chunk_hf, transports, passes)
    iq = synth.known_answer_frame(6)[0]
    total = int(seconds * 1.92e6)
    sig = np.tile(iq, -(-total // iq.size))[:total]
    chunk = chunk_hf * HALF_FRAME_LENGTH

    for transport in transports:
        trg = Trigger(psr_threshold=4.0, transport=transport)
        best = 0.0
        for p in range(passes):
            trg.timer.reset()
            t0 = time.perf_counter()
            fed = 0
            for i in range(0, total, chunk):
                trg.process(sig[i:i + chunk])
                fed += min(chunk, total - i)
            trg.flush()
            dt = time.perf_counter() - t0
            best = max(best, fed / dt)
            print(json.dumps({
                "transport": transport, "pass": p,
                "sps": round(fed / dt, 1), "wall_s": round(dt, 2),
                "stages": {k: {kk: round(vv, 1) for kk, vv in v.items()}
                           for k, v in trg.timer.summary().items()},
            }), flush=True)
        ok = any(c.cell_id == 123 for c in trg.cellstore.cells())
        print(json.dumps({"transport": transport,
                          "best_sps": round(best, 1),
                          "detections_ok": ok}), flush=True)


if __name__ == "__main__":
    main()
