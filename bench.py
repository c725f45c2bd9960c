#!/usr/bin/env python
"""Benchmark: fenced, correctness-checked full-trigger throughput.

Primary metric: IQ samples/s/chip through the COMPLETE trigger pipeline —
PSS matched filter + EMA + hysteresis state machine + CP detect + SSS +
TTI-soft-combined MIB decode — via the multi-channel scan engine
(channel_scan: C channels x n_steps half-frames per dispatch), the
deployment shape for wideband monitoring.

Measurement protocol:
  1. keep buffers device-resident, run many steps per dispatch (lax.scan);
  2. end every timed region with a device->host fetch derived from the
     last output, so timings are true device fences;
  3. assert the detections are correct in the same run (always on).

Every signal is synthesized from a seed (ltecore/synth.py known-answer
fixtures); no capture file is read.  Needs a GPU: on any other backend the
run exits without a result.

vs_baseline is relative to the reference's implied real-time operating
point (1.92 Msps sustained through its 3-chain flowgraph on a laptop CPU,
README.rst:92-104 / rtlsdr demo): how many real-time LTE sensing channels
one GPU replaces.

Modes:
  python bench.py            one JSON line (primary + extras)
  python bench.py --trace    capture a jax.profiler device trace of one
                             warmed channel_scan dispatch -> ./trace/
                             (view in TensorBoard/Perfetto)

Env knobs: BENCH_CHANNELS (128), BENCH_STEPS (100), BENCH_ITERS (3),
BENCH_SECONDS (0.55), BENCH_SKIP_STREAMING (unset).
"""

import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import card_line, require_gpu
from ltetrigger_jax.ltecore import synth
from ltetrigger_jax.ltecore.constants import HALF_FRAME_LENGTH
from ltetrigger_jax.models import trigger as trig
from ltetrigger_jax.parallel import channel_scan

BASELINE_SAMPLES_PER_S = 1.92e6   # reference real-time operating point


def _frame_6prb() -> np.ndarray:
    """The 6 PRB known-answer capture (cell 123, 1.92 Msps)."""
    return synth.known_answer_frame(6)[0]


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


def _make_buffer(channels: int, seconds: float):
    iq = _frame_6prb()
    total = int(seconds * 1.92e6)
    sig = (jnp.asarray(iq.real.astype(np.float32)),
           jnp.asarray(iq.imag.astype(np.float32)))
    return _tile_on_device(sig, channels, total)


def _fenced_channel_scan(channels: int, n_steps: int, seconds: float,
                         iters: int):
    """(best_seconds_per_dispatch, steady_state_best, detections_ok).

    Two regimes: the headline re-acquires from FRESH state every timed
    dispatch (acquisition + SSS + full MIB decode — the conservative
    number), and the steady-state regime carries the TriggerState across
    dispatches the way a monitoring deployment does (cells stay published,
    so the postpass decode gate stays closed and pass C's heavy branch is
    skipped — the engine's gating architecture paying off)."""
    buf = _make_buffer(channels, seconds)
    jax.block_until_ready(buf)
    final, out = channel_scan(buf, n_steps, 4.0)          # compile + warm
    _ = float(jnp.sum(final.pos))                          # fence
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        final, out = channel_scan(buf, n_steps, 4.0)
        _ = float(jnp.sum(final.pos))                      # D2H fence
        best = min(best, time.perf_counter() - t0)
    tracked = np.asarray(out.track_event)
    cids = np.asarray(out.cell_id)
    ok = bool(tracked.any()) and bool((cids[tracked] == 123).all())

    # steady state: rewind pos (the bench buffer is a loop) but keep the
    # acquired tracking/published state — compile + warm, then time
    states = final._replace(pos=jnp.zeros_like(final.pos)
                            + jnp.int32(trig.LOOKBACK))
    final2, _o = channel_scan(buf, n_steps, 4.0, states=states)
    _ = float(jnp.sum(final2.pos))
    ss_best = float("inf")
    for _ in range(iters):
        st = final._replace(pos=jnp.zeros_like(final.pos)
                            + jnp.int32(trig.LOOKBACK))
        t0 = time.perf_counter()
        final2, _o = channel_scan(buf, n_steps, 4.0, states=st)
        _ = float(jnp.sum(final2.pos))
        ss_best = min(ss_best, time.perf_counter() - t0)
    return best, ss_best, ok


def _stats(xs):
    xs = sorted(xs)
    return {"best": round(xs[-1], 1), "median": round(xs[len(xs) // 2], 1),
            "worst": round(xs[0], 1)}


def _wideband_throughput(n_centers: int = 16, seconds: float = 0.25,
                         iters: int = 5):
    """Fenced wideband scan: one 30.72 Msps capture -> n_centers channels
    (ONE on-device mixing+decimation program) -> full trigger over all
    channels.  Returns (list of wideband input samples/s per iter,
    detections_ok) — published as best/median/worst.
    The capture's real cell sits at offset 0; the other centers see
    filtered noise/adjacent energy and exercise the no-detection path."""
    from ltetrigger_jax.ops import channelize as chan
    from ltetrigger_jax.ops import cplx

    rate = 30.72e6
    iq = synth.known_answer_frame(100)[0]
    need = int(seconds * rate)
    wide = np.tile(iq, -(-need // iq.size))[:need]
    # upload once, outside the timed region
    wide_dev = cplx.from_numpy(wide)
    jax.block_until_ready(wide_dev)
    centers = [0.0] + [((i % 2) * 2 - 1) * (1.92e6 * (1 + i // 2))
                       for i in range(1, n_centers)]

    def run():
        chans = chan.channelize(wide_dev, rate, centers)
        c = chans[0].shape[0]
        total = chans[0].shape[1]
        zh = jnp.zeros((c, trig.LOOKBACK), jnp.float32)
        zt = jnp.zeros((c, trig.WINDOW), jnp.float32)
        buffers = (jnp.concatenate([zh, chans[0], zt], axis=1),
                   jnp.concatenate([zh, chans[1], zt], axis=1))
        n_steps = total // HALF_FRAME_LENGTH
        final, out = channel_scan(buffers, n_steps, 4.0)
        return out

    out = run()                                   # compile + warm
    _ = float(jnp.sum(out.consumed))
    sps = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = run()
        _ = float(jnp.sum(out.consumed))          # D2H fence
        sps.append(need / (time.perf_counter() - t0))
    track = np.asarray(out.track_event)           # [steps, C, R]
    cids = np.asarray(out.cell_id)
    det = track.any(axis=(0, 2))
    ok = bool(det[0]) and bool(
        (cids[:, 0, :][track[:, 0, :]] == 369).all())
    return sps, ok


def _streaming_throughput(seconds: float = 0.5, passes: int = 5):
    """samples/s through the host-driven streaming Trigger (includes the
    per-chunk event drains).
    Returns (per-pass sps list, detections_ok)."""
    from ltetrigger_jax.models.api import Trigger

    iq = _frame_6prb()
    total = int(seconds * 1.92e6)
    sig = np.tile(iq, -(-total // iq.size))[:total]
    trg = Trigger(psr_threshold=4.0)
    chunk = 4 * HALF_FRAME_LENGTH

    def feed():
        fed = 0
        t0 = time.perf_counter()
        for i in range(0, total, chunk):
            trg.process(sig[i:i + chunk])
            fed += min(chunk, total - i)
        trg.flush()        # the timed region ends fully drained: fed/dt is
        return fed / (time.perf_counter() - t0)   # processed throughput

    feed()     # warm pass: compiles every (depth, shape) the steady-state
    feed()     # feed pattern reaches, so later passes measure the driver
    sps = [feed() for _ in range(passes)]
    ok = any(c.cell_id == 123 for c in trg.cellstore.cells())
    return sps, ok


def _wideband_stream_throughput(n_carriers: int = 8, seconds: float = 0.5,
                                passes: int = 3, transport: str = "i8"):
    """HOST-FED wideband streaming: one wide upload feeds n_carriers live
    monitored streams (WidebandTrigger — VERDICT r4 #1).  Every carrier
    slot holds a real cell; returns per-carrier narrow samples/s (real
    time = 1.92e6) and whether every carrier detected its cell.

    Transport bytes: ONE wide stream (n_carriers * 1.92 Msps) instead of
    n_carriers narrow ones; per-channel effective SNR gains
    10*log10(ratio) dB of decimation processing gain over the wide-stream
    quantization noise (wide i8 ~ 45 dB at ratio 8; wide i4 ~ 23 dB)."""
    from ltetrigger_jax.models.wideband import WidebandTrigger

    rate = n_carriers * 1.92e6
    centers = [(-(n_carriers - 1) / 2 + i) * 1.92e6
               for i in range(n_carriers)]
    cells = [101 + 7 * i for i in range(n_carriers)]
    need = int(seconds * rate)
    one = np.zeros(19200 * n_carriers, np.complex128)
    for c, cid in zip(centers, cells):
        one += synth.upconvert(synth.synthesize_frame(cid, nof_prb_field=50),
                               rate, c)
    one = (one / np.sqrt(np.mean(np.abs(one) ** 2))).astype(np.complex64)
    wide = np.tile(one, -(-need // one.size))[:need]

    trg = WidebandTrigger(rate, centers, psr_threshold=4.0,
                          transport=transport)
    chunk = 19200 * n_carriers          # one radio frame of band per feed

    def feed():
        fed = 0
        t0 = time.perf_counter()
        for i in range(0, need, chunk):
            trg.process_wide(wide[i:i + chunk])
            fed += min(chunk, need - i)
        trg.flush()
        # PER-CARRIER narrow samples/s
        return (fed / trg.ratio) / (time.perf_counter() - t0)

    feed()
    feed()
    sps = [feed() for _ in range(passes)]
    ok = all(st.latest_cell() is not None
             and st.latest_cell().cell_id == cid
             for st, cid in zip(trg.stores, cells))
    return sps, ok


def _multistream_throughput(n: int = 8, seconds: float = 0.5,
                            passes: int = 3, transport: str = "i16"):
    """Per-stream samples/s through an n-stream MultiTrigger (all streams
    host-fed in one batched pipeline)."""
    from ltetrigger_jax.models.multi import MultiTrigger

    iq = _frame_6prb()
    total = int(seconds * 1.92e6)
    sig = np.tile(iq, -(-total // iq.size))[:total]
    trg = MultiTrigger(n, psr_threshold=4.0, transport=transport)
    chunk = 4 * HALF_FRAME_LENGTH

    def feed():
        fed = 0
        t0 = time.perf_counter()
        for i in range(0, total, chunk):
            trg.process_all([sig[i:i + chunk]] * n)
            fed += min(chunk, total - i)
        trg.flush()
        return fed / (time.perf_counter() - t0)   # PER-STREAM sps

    feed()
    feed()
    sps = [feed() for _ in range(passes)]
    ok = all(st.latest_cell() is not None
             and st.latest_cell().cell_id == 123 for st in trg.stores)
    return sps, ok


def main():
    channels = int(os.environ.get("BENCH_CHANNELS", "128"))
    n_steps = int(os.environ.get("BENCH_STEPS", "100"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    seconds = float(os.environ.get("BENCH_SECONDS", "0.55"))
    require_gpu()
    card = card_line().splitlines()[0]
    dev = jax.devices()[0]

    best, ss_best, ok = _fenced_channel_scan(channels, n_steps, seconds,
                                             iters)
    assert ok, "bench pipeline broken: capture cell not detected on device"
    samples = channels * n_steps * HALF_FRAME_LENGTH
    sps = samples / best

    extra = {
        "halfframe_steps_per_s": round(channels * n_steps / best, 1),
        "ms_per_dispatch": round(best * 1e3, 2),
        "steady_state_sps": round(samples / ss_best, 1),
        "detections_checked": True,
    }
    if not os.environ.get("BENCH_SKIP_STREAMING"):
        s_sps, s_ok = _streaming_throughput()
        st = _stats(s_sps)
        extra["streaming_sps"] = st["median"]
        extra["streaming_sps_best"] = st["best"]
        extra["streaming_sps_worst"] = st["worst"]
        extra["streaming_checked"] = bool(s_ok)
    if not os.environ.get("BENCH_SKIP_MULTISTREAM"):
        for tr in ("i16", "i4"):
            m_sps, m_ok = _multistream_throughput(transport=tr)
            st = _stats(m_sps)
            extra[f"multistream8_{tr}_sps_per_stream"] = st["median"]
            extra[f"multistream8_{tr}_sps_per_stream_best"] = st["best"]
            extra[f"multistream8_{tr}_checked"] = bool(m_ok)
    if not os.environ.get("BENCH_SKIP_WBSTREAM"):
        for tr in ("i8", "i4"):
            wb_sps, wb_ok = _wideband_stream_throughput(transport=tr)
            st = _stats(wb_sps)
            extra[f"wbstream8_{tr}_sps_per_stream"] = st["median"]
            extra[f"wbstream8_{tr}_sps_per_stream_best"] = st["best"]
            extra[f"wbstream8_{tr}_checked"] = bool(wb_ok)
    if not os.environ.get("BENCH_SKIP_WIDEBAND"):
        w_sps, w_ok = _wideband_throughput()
        st = _stats(w_sps)
        extra["wideband_sps"] = st["median"]
        extra["wideband_sps_best"] = st["best"]
        extra["wideband_sps_worst"] = st["worst"]
        extra["wideband_checked"] = bool(w_ok)

    print(json.dumps({
        "metric": "full_trigger_throughput",
        "value": round(sps, 1),
        "unit": "IQ samples/s/chip",
        "vs_baseline": round(sps / BASELINE_SAMPLES_PER_S, 2),
        "config": {"channels": channels, "n_steps": n_steps,
                   "iters": iters, "fenced": True,
                   "platform": dev.platform, "device_kind": dev.device_kind,
                   "device_count": len(jax.devices()), "card": card},
        "extra": extra,
    }))


def trace_mode():
    """Device-trace one warmed bench dispatch (utils/profiling.trace around
    the exact timed region of the headline number)."""
    from ltetrigger_jax.utils.profiling import trace

    channels = int(os.environ.get("BENCH_CHANNELS", "128"))
    n_steps = int(os.environ.get("BENCH_STEPS", "100"))
    require_gpu()
    buf = _make_buffer(channels, float(os.environ.get("BENCH_SECONDS",
                                                      "0.55")))
    jax.block_until_ready(buf)
    final, _ = channel_scan(buf, n_steps, 4.0)         # compile + warm
    _ = float(jnp.sum(final.pos))
    out_dir = os.environ.get("BENCH_TRACE_DIR", "./trace")
    with trace(out_dir):
        final, _ = channel_scan(buf, n_steps, 4.0)
        _ = float(jnp.sum(final.pos))
    print(json.dumps({"trace_dir": out_dir, "channels": channels,
                      "n_steps": n_steps}))


if __name__ == "__main__":
    if "--trace" in sys.argv:
        trace_mode()
        sys.exit(0)
    main()
