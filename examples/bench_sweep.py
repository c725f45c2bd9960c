#!/usr/bin/env python
"""Channel-count sweep of the fenced channel_scan benchmark.

Runs the exact bench.py protocol (device-resident buffers, n_steps per
dispatch, D2H fence, in-run detection assertions) at several channel counts
in ONE process, printing one JSON line per operating point and a final
summary line.

Usage: python examples/bench_sweep.py [C ...]   (default 32 64 128 256 512 1024)
Env: SWEEP_STEPS (100), SWEEP_ITERS (3), SWEEP_SECONDS (0.55).
"""

import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ltetrigger_jax.ltecore import synth
from ltetrigger_jax.ltecore.constants import HALF_FRAME_LENGTH
from ltetrigger_jax.models import trigger as trig
from ltetrigger_jax.parallel import channel_scan



@functools.partial(jax.jit, static_argnames=("channels", "total"))
def _tile_on_device(sig, channels, total):
    """One channel's samples -> padded [C, N] bench buffer, built on the
    device (one upload instead of C identical copies)."""
    reps = -(-total // sig[0].shape[0])

    def one(comp):
        s = jnp.tile(comp, reps)[:total]
        row = jnp.concatenate([jnp.zeros(trig.LOOKBACK, jnp.float32), s,
                               jnp.zeros(trig.WINDOW, jnp.float32)])
        return jnp.broadcast_to(row, (channels, row.shape[0]))

    return (one(sig[0]), one(sig[1]))


def make_buffer(channels, seconds):
    iq = synth.known_answer_frame(6)[0]
    total = int(seconds * 1.92e6)
    sig = (jnp.asarray(iq.real.astype(np.float32)),
           jnp.asarray(iq.imag.astype(np.float32)))
    return _tile_on_device(sig, channels, total)


def run_point(channels, n_steps, seconds, iters):
    buf = make_buffer(channels, seconds)
    jax.block_until_ready(buf)
    t0 = time.perf_counter()
    final, out = channel_scan(buf, n_steps, 4.0)
    _ = float(jnp.sum(final.pos))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        final, out = channel_scan(buf, n_steps, 4.0)
        _ = float(jnp.sum(final.pos))
        best = min(best, time.perf_counter() - t0)
    tracked = np.asarray(out.track_event)
    cids = np.asarray(out.cell_id)
    ok = bool(tracked.any()) and bool((cids[tracked] == 123).all())
    sps = channels * n_steps * HALF_FRAME_LENGTH / best
    rec = {"channels": channels, "n_steps": n_steps,
           "ms_per_dispatch": round(best * 1e3, 2),
           "ms_per_step": round(best * 1e3 / n_steps, 3),
           "sps": round(sps, 1), "msps": round(sps / 1e6, 1),
           "compile_s": round(compile_s, 1), "detections_ok": ok}
    print(json.dumps(rec), flush=True)
    del buf, final, out
    return rec


def main():
    cs = [int(a) for a in sys.argv[1:]] or [32, 64, 128, 256, 512, 1024]
    n_steps = int(os.environ.get("SWEEP_STEPS", "100"))
    iters = int(os.environ.get("SWEEP_ITERS", "3"))
    seconds = float(os.environ.get("SWEEP_SECONDS", "0.55"))
    print(json.dumps({"device": str(jax.devices()[0])}), flush=True)
    results = []
    for c in cs:
        # keep buffer under ~6 GB: C * (sec*1.92e6 + 13k) * 8 B
        sec = seconds
        while c * (sec * 1.92e6 + 13500) * 8 > 6e9 and sec > 0.15:
            sec = round(sec / 2, 3)
        steps = min(n_steps, max(10, int(sec * 1.92e6) // HALF_FRAME_LENGTH))
        results.append(run_point(c, steps, sec, iters))
    best = max(results, key=lambda r: r["sps"])
    print(json.dumps({"best": best}), flush=True)


if __name__ == "__main__":
    main()
