#!/usr/bin/env python
"""GPU smoke check: the LTE trigger's main path, end to end, on the card.

    python chip_smoke.py              # phases 0-4 on one GPU
    python chip_smoke.py --devices 4  # phase 0 + phase 5 (mesh) on 4 GPUs

Phases, in order.  Any failed check raises and ends the run with a non-zero
exit; nothing is caught and carried on.

  0 device      a GPU backend or exit; versions, flags, compile cache, card
  1 answers     the four known-answer captures (ltecore/synth.py) through
                `search` and the cell_search_file CLI, against refrx
  2 ops         each op on the device against its plain reference, at real
                widths, printing the worst error beside its tolerance
  3 scan        channel_scan at C=128 x 100 half-frames (cold, steady) and
                C=512 (cold); gather vs dense one-hot extraction timed
  4 live        Trigger, MultiTrigger(8, i16), WidebandTrigger(8 carriers)
  5 mesh        (--devices 4 only) channel_scan, time_sharded_scan,
                MultiTrigger and WidebandTrigger over a 4-device mesh,
                event for event against one device

Timings are informational (ms per dispatch, Msps), printed beside the
card's name and power limit.  The last stdout line is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from ltetrigger_jax import compile_cache_dir
from ltetrigger_jax.ltecore import pss as pssmod
from ltetrigger_jax.ltecore import refrx, synth
from ltetrigger_jax.ltecore.constants import HALF_FRAME_LENGTH, SYMBOL_SZ
from ltetrigger_jax.models import trigger as trig

SEED = 0
PSR_THRESHOLD = 4.0
MIB_FIELDS = ("cell_id", "nof_prb", "nof_tx_ports", "cp_len", "phich_len",
              "nof_phich_resources")
# channel_scan / MultiTrigger cells: distinct ids over all three N_id_2 roots
SCAN_CELLS = (101, 202, 303, 404, 57, 158, 259, 360)
SCAN_PRB = 50
NOISE_EVERY = 16          # channel c % 16 == 15 carries noise only

# ---- tolerances (phase 2) -------------------------------------------------
# pass A: bf16 operands, f32 accumulation.  bf16 keeps 8 significand bits,
# so each operand is off by <= 2^-9 relative; the squared correlation by
# a few 2^-9 at most.
PASS_A_POWER_RTOL = 2e-2  # peaks must match where the f64 peak leads by more
PASS_A_PSR_RTOL = 2e-2    # PSR relative error on those windows
# PBCH front end against the f64 numpy receiver (relative to the largest
# magnitude): f32 DFT / chest / dematch arithmetic.
DEMOD_RTOL = 1e-2
CHEST_RTOL = 1e-2
LLR_RTOL = 1e-2
VITERBI_METRIC_RTOL = 1e-3
# channelizer: error power relative to the f64 mixer + decimator output
CHANNELIZE_MAX_DB = -40.0


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# ======================================================================
# phase 0 — device
# ======================================================================
def require_gpu() -> None:
    """Exit unless JAX's default backend is a GPU (never fall back)."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU backend; JAX has "
                         f"{backend!r}")


def card_line() -> str:
    """`nvidia-smi` name and power limit of every card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True,
                       "device": {"platform": d.platform,
                                  "kind": d.device_kind,
                                  "count": len(devices)}})


def phase0() -> str:
    require_gpu()
    card = card_line()
    log("phase 0 | jax", jax.__version__, "| devices", jax.devices())
    log("phase 0 | XLA_FLAGS", repr(os.environ.get("XLA_FLAGS", "")))
    log("phase 0 | compile cache", jax.config.jax_compilation_cache_dir,
        f"(package rule: {compile_cache_dir()})")
    log(card)
    return card.splitlines()[0]


# ======================================================================
# phase 1 — known answers
# ======================================================================
def _ref_fields(ref: dict) -> dict:
    return {"cell_id": ref["cell_id"], "nof_prb": ref["nof_prb"],
            "nof_tx_ports": ref["nof_ports"], "cp_len": ref["cp_len"],
            "phich_len": ref["phich_len"],
            "nof_phich_resources": ref["nof_phich_resources"]}


def _json_records(text: str) -> list:
    dec = json.JSONDecoder()
    out, i = [], 0
    while True:
        j = text.find("{", i)
        if j < 0:
            return out
        obj, i = dec.raw_decode(text, j)
        out.append(obj)


def phase1(seed: int = SEED) -> None:
    from ltetrigger_jax import search
    from ltetrigger_jax.apps import cell_search_file

    for prb in sorted(synth.KNOWN_ANSWERS):
        iq, cid, rate = synth.known_answer_frame(prb, seed=seed)
        want = {"cell_id": cid, "nof_prb": prb, "nof_tx_ports": 1,
                "cp_len": "Normal", "phich_len": "Normal",
                "nof_phich_resources": "1"}
        ref = refrx.search_frame(iq.astype(np.complex128), rate)
        check(ref is not None and _ref_fields(ref) == want,
              f"refrx on the {prb} PRB fixture: {ref}")

        t0 = time.perf_counter()
        cells = search(iq, rate)
        dt = time.perf_counter() - t0
        check(len(cells) >= 1, f"search found nothing in the {prb} PRB "
                               "fixture")
        got = {k: cells[0].to_dict()[k] for k in MIB_FIELDS}
        check(got == want, f"search on {prb} PRB: {got} != {want}")

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, f"lte_frame_{prb}prb_cellid_{cid}")
            iq.tofile(path)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cell_search_file.main(
                    [path, "-s", f"{rate:.0f}", "--repeat", "--time-out",
                     "1", "--json-only"])
        recs = _json_records(buf.getvalue())
        check(rc == 0 and len(recs) >= 1 and recs[0].get("status") ==
              "FOUND", f"cell_search_file on {prb} PRB: rc={rc} {recs}")
        cli = {k: recs[0][k] for k in MIB_FIELDS}
        check(cli == want, f"cell_search_file on {prb} PRB: {cli}")
        log(f"phase 1 | {prb:3d} PRB @ {rate / 1e6:5.2f} Msps | search, CLI "
            f"and refrx agree: {want} | search {dt:.2f} s")


# ======================================================================
# shared: device-built multi-channel scan buffers
# ======================================================================
@functools.partial(jax.jit, static_argnames=("n_channels", "total"))
def _tile_channels(fr, fi, key, sigma, n_channels: int, total: int):
    reps = -(-total // fr.shape[1])
    idx = jnp.arange(n_channels) % fr.shape[0]
    live = (jnp.arange(n_channels) % NOISE_EVERY != NOISE_EVERY - 1)
    keys = jax.random.split(key, 2)

    def one(comp, k):
        sig = jnp.tile(comp, (1, reps))[:, :total][idx] * live[:, None]
        body = sig + sigma * jax.random.normal(k, (n_channels, total))
        return jnp.concatenate(
            [jnp.zeros((n_channels, trig.LOOKBACK), jnp.float32), body,
             jnp.zeros((n_channels, trig.WINDOW), jnp.float32)], axis=1)

    return one(fr, keys[0]), one(fi, keys[1])


@functools.lru_cache(maxsize=None)
def _scan_frames() -> np.ndarray:
    return np.stack([synth.synthesize_frame(cid, nof_prb_field=SCAN_PRB)
                     for cid in SCAN_CELLS]).astype(np.complex64)


def scan_buffers(n_channels: int, n_steps: int, seed: int,
                 snr_db: float = 10.0):
    """Padded [C, LOOKBACK + n_steps*9600 + WINDOW] pair built on the
    device: channel c carries SCAN_CELLS[c % 8] plus AWGN at `snr_db`,
    except every NOISE_EVERY-th channel, which is noise only."""
    fr = _scan_frames()
    sigma = 10.0 ** (-snr_db / 20.0) / np.sqrt(2.0)
    return _tile_channels(jnp.asarray(fr.real), jnp.asarray(fr.imag),
                          jax.random.PRNGKey(seed), jnp.float32(sigma),
                          n_channels, n_steps * HALF_FRAME_LENGTH)


def expected_cell(c: int):
    return None if c % NOISE_EVERY == NOISE_EVERY - 1 else \
        SCAN_CELLS[c % len(SCAN_CELLS)]


# ======================================================================
# phase 2 — op equivalence
# ======================================================================
def _f64_power(x: np.ndarray, lo: int, n_pos: int) -> np.ndarray:
    """|sum_k x[lo+n+k] conj(rep_r[k])|^2 in float64: [C, 3, n_pos]."""
    reps = pssmod.pss_time()
    seg = x[:, lo:lo + n_pos + SYMBOL_SZ]
    L = 1 << int(np.ceil(np.log2(seg.shape[-1] + SYMBOL_SZ)))
    out = np.empty((x.shape[0], 3, n_pos))
    for c0 in range(0, x.shape[0], 16):
        X = np.fft.fft(seg[c0:c0 + 16], L, axis=-1)
        for r in range(3):
            R = np.fft.fft(reps[r], L)
            out[c0:c0 + 16, r] = np.abs(
                np.fft.ifft(X * np.conj(R), axis=-1)[:, :n_pos]) ** 2
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def check_pass_a(buffers, n_steps: int, card: str):
    """_group_power (bf16 operands) against an f64 numpy correlation."""
    from ltetrigger_jax.ops import correlate

    c = buffers[0].shape[0]
    group_power = jax.jit(trig._group_power, static_argnums=(1, 2))
    power = group_power(buffers, trig.LOOKBACK, n_steps)  # [C,g,75,R,128]
    _, ts = _timed(lambda: group_power(buffers, trig.LOOKBACK, n_steps), 5)
    log(f"phase 2 | _group_power C={c} G={n_steps}: "
        f"{float(np.median(ts)) * 1e3:.2f} ms median of 5 (all "
        f"{[round(t * 1e3, 2) for t in ts]}) | {card}")
    flat = jnp.moveaxis(power, -3, -2).reshape(c, n_steps, 3, -1)
    pk_d, psr_d = jax.jit(correlate.peak_and_psr)(flat)
    pk_d, psr_d = np.asarray(pk_d), np.asarray(psr_d)

    x = (np.asarray(buffers[0], np.float64)
         + 1j * np.asarray(buffers[1], np.float64))
    ref = _f64_power(x, trig.LOOKBACK, n_steps * HALF_FRAME_LENGTH)
    ref = ref.reshape(c, 3, n_steps, HALF_FRAME_LENGTH).transpose(0, 2, 1, 3)
    pk_r = np.empty(pk_d.shape, np.int64)
    psr_r = np.empty(psr_d.shape)
    lead = np.empty(psr_d.shape)
    for i in np.ndindex(pk_d.shape):
        pk_r[i], psr_r[i] = refrx.peak_and_psr(ref[i])
        w = ref[i]
        top = w[pk_r[i]]
        lead[i] = (top - np.max(np.delete(w, pk_r[i]))) / top
    clear = lead > PASS_A_POWER_RTOL
    mism = int(np.sum((pk_d != pk_r) & clear))
    psr_err = float(np.max(np.abs(psr_d - psr_r)[clear] / psr_r[clear]))
    log(f"phase 2 | pass A bf16 power vs f64 | C={c} x {n_steps} steps | "
        f"{int(clear.sum())}/{clear.size} windows with a peak leading by "
        f"> {PASS_A_POWER_RTOL:g}: {mism} peak mismatches (need 0) | worst "
        f"PSR rel err {psr_err:.3e} (tol {PASS_A_PSR_RTOL:g}) | all-window "
        f"peak mismatches {int(np.sum(pk_d != pk_r))}")
    check(mism == 0, "pass A peak positions differ from the f64 reference")
    check(psr_err <= PASS_A_PSR_RTOL, "pass A PSR beyond tolerance")
    det = psr_r > PSR_THRESHOLD
    check(bool(np.all(pk_d[det] == pk_r[det])),
          "pass A peak differs on an above-threshold window")
    return power


def check_peak_paths(power) -> None:
    """peak_and_psr_blocked == multipass == flat, bit for bit."""
    from ltetrigger_jax.ops import correlate

    blk = power.reshape((-1,) + power.shape[-3:])          # [B, 75, R, 128]
    a = jax.jit(correlate.peak_and_psr_blocked)(blk)
    b = jax.jit(correlate._peak_and_psr_blocked_multipass)(blk)
    flat = jnp.moveaxis(blk, -3, -2).reshape(blk.shape[0], 3, -1)
    f = jax.jit(correlate.peak_and_psr)(flat)
    same_b = all(np.array_equal(np.asarray(x), np.asarray(y))
                 for x, y in zip(a, b))
    same_f = all(np.array_equal(np.asarray(x), np.asarray(y))
                 for x, y in zip(a, f))
    log(f"phase 2 | peak_and_psr_blocked vs multipass vs flat | "
        f"{blk.shape[0]}x3 windows | bit-identical: {same_b} / {same_f} "
        "(need both)")
    check(same_b and same_f, "peak/PSR paths differ")


def check_extractions(buffers, n_steps: int, seed: int) -> None:
    """Dense one-hot extractions == their gather paths, bit for bit."""
    c = buffers[0].shape[0]
    rng = np.random.default_rng(seed)
    peak = jnp.asarray(rng.integers(0, HALF_FRAME_LENGTH,
                                    (n_steps, c, 3)), jnp.int32)
    grid0 = trig.LOOKBACK
    dense = jax.jit(trig._extract_segs_dense, static_argnums=(1, 2))(
        buffers, grid0, n_steps, peak)
    grid = grid0 + HALF_FRAME_LENGTH * jnp.arange(n_steps, dtype=jnp.int32)
    st0 = grid[:, None, None] + peak - trig.LOOKBACK
    taa = jax.jit(trig._extract_segs_taa)(buffers, st0 + trig.SEG_OFF)
    seg_err = max(float(jnp.max(jnp.abs(x - y))) for x, y in zip(dense, taa))
    log(f"phase 2 | _extract_segs_dense vs _extract_segs_taa | C={c} x "
        f"{n_steps} steps | max |diff| {seg_err:g} (need 0)")
    check(seg_err == 0.0, "dense slot-0 extraction is not exact")

    k = 16
    s_idx = rng.integers(0, n_steps - 1, (c, 3, k))
    pk = rng.integers(0, HALF_FRAME_LENGTH, (c, 3, k))
    starts = jnp.asarray(grid0 + HALF_FRAME_LENGTH * s_idx + pk + 128,
                         jnp.int32)
    dense = jax.jit(trig._gather_cands_dense, static_argnums=(2, 3))(
        buffers, starts, grid0, n_steps)
    gath = jax.jit(trig._gather_cands, static_argnums=(2,))(
        buffers, starts, trig.SLOT_LENGTH)
    cand_err = max(float(jnp.max(jnp.abs(x - y)))
                   for x, y in zip(dense, gath))
    log(f"phase 2 | _gather_cands_dense vs gather | C={c} x {3 * k} "
        f"candidates | max |diff| {cand_err:g} (need 0)")
    check(cand_err == 0.0, "dense candidate extraction is not exact")


def _aligned_subframe(iq: np.ndarray, cid: int, rate: float) -> np.ndarray:
    """Host alignment of a known-answer capture to its subframe 0."""
    x = refrx.decimate(np.concatenate([iq, iq]).astype(np.complex128),
                       int(round(rate / 1.92e6)))
    pk, _ = refrx.peak_and_psr(refrx.pss_correlate(x, cid % 3))
    start = pk - trig.LOOKBACK
    if start < 0:
        start += HALF_FRAME_LENGTH
    aligned = x[start:start + HALF_FRAME_LENGTH]
    _, sub5, _, _ = refrx.sss_decode(aligned, cid % 3, True)
    if sub5:
        start += HALF_FRAME_LENGTH
    return x[start:start + 2 * trig.SLOT_LENGTH]


def _pbch_errors(sf: np.ndarray, cid: int, prb: int) -> dict:
    """Device PBCH front end + Viterbi vs the f64 host receiver."""
    from ltetrigger_jax.ltecore import coding, scrambling
    from ltetrigger_jax.ltecore import mib as mibmod
    from ltetrigger_jax.ops import cplx, pbch
    from ltetrigger_jax.ops.viterbi import viterbi_decode_wa

    slot1 = sf[trig.SLOT_LENGTH:]
    syms_r = refrx.ofdm_demod_slot(slot1, True)
    syms_d = jax.jit(pbch.ofdm_demod_slot, static_argnums=(1,))(
        cplx.from_numpy(slot1), True)
    h_r = refrx._chest_port(syms_r, cid, 1, 0, True)
    h_d = jax.jit(pbch._chest_port, static_argnums=(2, 3, 4))(
        syms_d, jnp.int32(cid), 1, 0, True)

    # MRC reference LLRs (the device equalizer keeps the |h|^2 weight)
    y, k, _ = refrx.pbch_res(syms_r, cid % 6, True)
    d = y * np.conj(h_r[k])
    llr = np.empty(2 * d.size)
    llr[0::2], llr[1::2] = d.real, d.imag
    e = 480
    sgn = 1.0 - 2.0 * scrambling.gold_sequence(
        scrambling.pbch_c_init(cid), 4 * e).astype(np.float64)
    dem = coding.ratematch_map(40, 4 * e)
    ref_q = np.zeros((4, 120))
    for q in range(4):
        sl = slice(e * q, e * (q + 1))
        np.add.at(ref_q[q], dem[sl], llr * sgn[sl])
    llr_d = jax.jit(pbch.pbch_quarter_llrs, static_argnums=(2,))(
        cplx.from_numpy(sf), jnp.int32(cid), True)          # [3, 4, 120]
    llr_d1 = np.asarray(llr_d[0])

    # Viterbi on the device LLRs of the true hypothesis (1 port, q 0)
    r = np.asarray(llr_d1[0], np.float64)
    bits_d, metric_d = jax.jit(viterbi_decode_wa)(
        jnp.asarray(r.reshape(3, 40).T[None], jnp.float32))
    bits_r, metric_r = refrx.viterbi_tailbiting(r.reshape(3, 40).T.reshape(-1))
    sent = coding.crc16_attach(mibmod.mib_pack(prb, False, 2, 0), 1)
    mib_d = jax.jit(pbch.mib_decode)(cplx.from_numpy(sf), jnp.int32(cid),
                                    jnp.bool_(True))
    mib_r = refrx.mib_decode_subframe(sf, cid, True)
    return {
        "demod": _rel(cplx.to_numpy(syms_d), syms_r),
        "chest": _rel(cplx.to_numpy(h_d), h_r),
        "llr": _rel(llr_d1, ref_q),
        "bits_same": bool(np.array_equal(np.asarray(bits_d[0]), bits_r)
                          and np.array_equal(bits_r, sent)),
        "metric": abs(float(metric_d[0]) - metric_r) / abs(metric_r),
        "mib_same": bool(mib_d["found"]) and mib_r is not None and all(
            int(mib_d[a]) == b for a, b in (
                ("nof_prb", mib_r["nof_prb"]),
                ("nof_ports", mib_r["nof_ports"]),
                ("sfn_offset", mib_r["sfn_offset"]))),
    }


def check_pbch(seed: int) -> None:
    for prb in sorted(synth.KNOWN_ANSWERS):
        iq, cid, rate = synth.known_answer_frame(prb, seed=seed)
        sf = _aligned_subframe(iq, cid, rate)
        err = _pbch_errors(sf, cid, prb)
        with jax.default_matmul_precision("highest"):
            hi = _pbch_errors(sf, cid, prb)
        log(f"phase 2 | PBCH {prb:3d} PRB cell {cid} | demod rel err "
            f"{err['demod']:.2e} (HIGHEST {hi['demod']:.2e}, tol "
            f"{DEMOD_RTOL:g}) | chest {err['chest']:.2e} (HIGHEST "
            f"{hi['chest']:.2e}, tol {CHEST_RTOL:g}) | LLR {err['llr']:.2e} "
            f"(HIGHEST {hi['llr']:.2e}, tol {LLR_RTOL:g}) | Viterbi bits "
            f"identical {err['bits_same']}, metric rel err "
            f"{err['metric']:.2e} (tol {VITERBI_METRIC_RTOL:g}) | MIB "
            f"fields identical {err['mib_same']}")
        check(err["demod"] <= DEMOD_RTOL, "OFDM demod beyond tolerance")
        check(err["chest"] <= CHEST_RTOL, "CRS chest beyond tolerance")
        check(err["llr"] <= LLR_RTOL, "PBCH LLRs beyond tolerance")
        check(err["bits_same"], "Viterbi bits differ from refrx")
        check(err["metric"] <= VITERBI_METRIC_RTOL, "Viterbi metric off")
        check(err["mib_same"], "device MIB decode differs from refrx")


def _channelize_error(wide: np.ndarray, rate: float, centers) -> float:
    from ltetrigger_jax.ops import channelize, cplx

    ratio = int(round(rate / 1.92e6))
    got = cplx.to_numpy(channelize.channelize(wide, rate, centers))
    got = got.astype(np.complex128)
    n = np.arange(wide.size, dtype=np.float64)
    worst = -np.inf
    for i, f in enumerate(centers):
        mixed = wide.astype(np.complex128) * np.exp(
            -2j * np.pi * np.mod(f / rate * n, 1.0))
        ref = refrx.decimate(mixed, ratio)[:got.shape[1]]
        e = np.sum(np.abs(got[i] - ref) ** 2) / np.sum(np.abs(ref) ** 2)
        worst = max(worst, 10 * np.log10(e))
    return float(worst)


def check_channelize(seed: int, seconds: float = 0.05) -> None:
    iq, cid, rate = synth.known_answer_frame(100, seed=seed)
    need = int(seconds * rate)
    wide = np.tile(iq, -(-need // iq.size))[:need]
    centers = [0.0] + [((i % 2) * 2 - 1) * 1.92e6 * (1 + i // 2)
                       for i in range(1, 16)]
    err = _channelize_error(wide, rate, centers)
    with jax.default_matmul_precision("highest"):
        hi = _channelize_error(wide, rate, centers)
    log(f"phase 2 | channelize 30.72 Msps -> 16 x 1.92 Msps | worst error "
        f"{err:.1f} dB (HIGHEST {hi:.1f} dB, tol {CHANNELIZE_MAX_DB:g} dB)")
    check(err <= CHANNELIZE_MAX_DB, "channelizer error beyond tolerance")


def phase2(card: str, n_channels: int = 128, n_steps: int = 32,
           seed: int = SEED) -> None:
    buffers = scan_buffers(n_channels, n_steps, seed)
    power = check_pass_a(buffers, n_steps, card)
    check_peak_paths(power)
    del power
    check_extractions(buffers, n_steps, seed)
    del buffers
    check_pbch(seed)
    check_channelize(seed)


# ======================================================================
# phase 3 — offline scan at deployment size
# ======================================================================
def _timed(fn, iters: int):
    """(last result, [seconds per call]) with a device fence per call."""
    out, ts = None, []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return out, ts


def check_scan_events(final, out, n_channels: int, fresh: bool) -> None:
    track = np.asarray(out.track_event)                   # [S, C, R]
    cids = np.asarray(out.cell_id)
    prbs = np.asarray(out.nof_prb)
    drops = np.asarray(out.drop_event)
    pub = np.asarray(final.published)
    pub_id = np.asarray(final.pub_cell_id)
    for c in range(n_channels):
        want = expected_cell(c)
        t = track[:, c, :]
        if want is None:
            check(not t.any() and not pub[c].any(),
                  f"noise channel {c} published a cell")
            continue
        r = want % 3
        check(bool(pub[c, r]) and int(pub_id[c, r]) == want,
              f"channel {c}: not publishing cell {want}")
        check(not drops[:, c, :].any(), f"channel {c}: dropped its cell")
        if fresh:
            check(t.any(), f"channel {c}: no track event")
            check(bool(np.all(cids[:, c, :][t] == want))
                  and bool(np.all(prbs[:, c, :][t] == SCAN_PRB)),
                  f"channel {c}: wrong cell in its track events")
        else:
            check(not t.any(), f"channel {c}: re-published in steady state")


def _engine_variant(seg_extract: str, cand_extract: str):
    """The channel_scan engine traced with other extraction paths (the
    module switches trigger.SEG_EXTRACT / CAND_EXTRACT are read while
    tracing)."""
    @functools.partial(jax.jit, static_argnames=("n_steps", "grid0"))
    def run(buffers, states, thresh, n_steps, grid0):
        saved = trig.SEG_EXTRACT, trig.CAND_EXTRACT
        trig.SEG_EXTRACT, trig.CAND_EXTRACT = seg_extract, cand_extract
        try:
            return trig.scan_engine(buffers, states, n_steps, thresh,
                                    grid0_static=grid0)
        finally:
            trig.SEG_EXTRACT, trig.CAND_EXTRACT = saved
    return run


def _rewound(final):
    return final._replace(pos=jnp.zeros_like(final.pos)
                          + jnp.int32(trig.LOOKBACK))


def phase3(card: str, n_channels: int = 128, n_steps: int = 100,
           wide_channels: int = 512, iters: int = 3,
           seed: int = SEED) -> None:
    """channel_scan (default: gather extraction) at deployment size, cold
    and steady, against the dense one-hot extraction variant: both timed,
    outputs bit-identical.  C=wide_channels runs both cold too (the dense
    variant's _CAND_CHUNK lax.map path)."""
    from ltetrigger_jax.parallel import channel_scan

    dense = _engine_variant("dense", "dense")
    thresh = jnp.float32(PSR_THRESHOLD)

    def fresh(c):
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (c,) + x.shape), trig.init_state())

    def rate(ts, samples):
        med = float(np.median(ts))
        return (f"{med * 1e3:.1f} ms/dispatch median (all "
                f"{[round(t * 1e3, 1) for t in ts]}), "
                f"{samples / med / 1e6:.0f} Msps")

    def same(a, b):
        return all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a, b))

    for c, reps in ((n_channels, iters), (wide_channels, 1)):
        samples = c * n_steps * HALF_FRAME_LENGTH
        buffers = scan_buffers(c, n_steps, seed)
        jax.block_until_ready(buffers)
        log(f"phase 3 | C={c} x {n_steps} steps: {samples / 1e6:.1f} M "
            f"samples, {2 * buffers[0].nbytes / 1e9:.2f} GB of IQ on the "
            "device")

        t0 = time.perf_counter()
        final, out = channel_scan(buffers, n_steps, PSR_THRESHOLD)
        jax.block_until_ready(out)
        first = time.perf_counter() - t0
        check_scan_events(final, out, c, fresh=True)
        (final, out), ts = _timed(
            lambda: channel_scan(buffers, n_steps, PSR_THRESHOLD), reps)
        check_scan_events(final, out, c, fresh=True)
        log(f"phase 3 | C={c} cold   gather | first call {first:.1f} s | "
            f"{rate(ts, samples)} | {card}")

        t0 = time.perf_counter()
        fd, od = dense(buffers, fresh(c), thresh, n_steps, trig.LOOKBACK)
        jax.block_until_ready(od)
        first = time.perf_counter() - t0
        check(same(od, out), "dense-extraction scan differs from gather")
        _, ts = _timed(lambda: dense(buffers, fresh(c), thresh, n_steps,
                                     trig.LOOKBACK), reps)
        log(f"phase 3 | C={c} cold   dense  | first call {first:.1f} s | "
            f"{rate(ts, samples)} | outputs identical to gather | {card}")
        if c != n_channels:
            continue

        steady = _rewound(final)
        f2, o2 = channel_scan(buffers, n_steps, PSR_THRESHOLD, states=steady)
        check_scan_events(f2, o2, c, fresh=False)
        (f2, o2), ts = _timed(lambda: channel_scan(
            buffers, n_steps, PSR_THRESHOLD, states=steady), reps)
        check_scan_events(f2, o2, c, fresh=False)
        log(f"phase 3 | C={c} steady gather | {rate(ts, samples)} | {card}")
        fd, od = dense(buffers, steady, thresh, n_steps, None)
        check(same(od, o2), "dense-extraction steady scan differs")
        _, ts = _timed(lambda: dense(buffers, steady, thresh, n_steps, None),
                       reps)
        log(f"phase 3 | C={c} steady dense  | {rate(ts, samples)} | {card}")
        del buffers, final, out, f2, o2, fd, od, steady


# ======================================================================
# phase 4 — host-fed live paths
# ======================================================================
def _noisy(frame: np.ndarray, total: int, seed: int,
           snr_db: float = 10.0) -> np.ndarray:
    sig = np.tile(frame, -(-total // frame.size))[:total]
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2))
    rng = np.random.default_rng(seed)
    sigma = 10.0 ** (-snr_db / 20.0) / np.sqrt(2.0)
    return (sig + sigma * (rng.normal(size=total)
                           + 1j * rng.normal(size=total))).astype(np.complex64)


def _feed(make, feed, total: int, chunk: int):
    """Two passes over the stream, each through a fresh detector: the
    first pays compilation.  Returns (detector, [seconds per pass])."""
    ts = []
    for _ in range(2):
        det = make()
        t0 = time.perf_counter()
        for i in range(0, total, chunk):
            feed(det, i, min(i + chunk, total))
        det.flush()
        ts.append(time.perf_counter() - t0)
    return det, ts


def phase4(card: str, trigger_seconds: float = 2.0,
           multi_seconds: float = 1.0, wide_seconds: float = 0.5,
           seed: int = SEED) -> None:
    from ltetrigger_jax import MultiTrigger, Trigger, WidebandTrigger

    iq, cid, _ = synth.known_answer_frame(6, seed=seed)
    total = int(trigger_seconds * 1.92e6)
    stream = np.tile(iq, -(-total // iq.size))[:total]
    trg, ts = _feed(lambda: Trigger(psr_threshold=PSR_THRESHOLD),
                    lambda d, a, b: d.process(stream[a:b]),
                    total, 4 * HALF_FRAME_LENGTH)
    got = [c.cell_id for c in trg.cellstore.cells()]
    check(got == [cid], f"Trigger published {got}, want [{cid}]")
    log(f"phase 4 | Trigger {trigger_seconds:g} s @ 1.92 Msps | cell {cid} "
        f"| first pass {ts[0]:.1f} s, warm {total / ts[1] / 1e6:.2f} Msps | "
        f"{card}")

    n = 8
    total = int(multi_seconds * 1.92e6)
    streams = [_noisy(f, total, seed + i)
               for i, f in enumerate(_scan_frames())]
    mt, ts = _feed(lambda: MultiTrigger(n, psr_threshold=PSR_THRESHOLD,
                                        transport="i16"),
                   lambda d, a, b: d.process_all([s[a:b] for s in streams]),
                   total, 4 * HALF_FRAME_LENGTH)
    for i, st in enumerate(mt.stores):
        cell = st.latest_cell()
        check(cell is not None and cell.cell_id == SCAN_CELLS[i],
              f"MultiTrigger stream {i}: {cell}")
    log(f"phase 4 | MultiTrigger(8, i16) {multi_seconds:g} s per stream | "
        f"cells {list(SCAN_CELLS)} | first pass {ts[0]:.1f} s, warm "
        f"{total / ts[1] / 1e6:.2f} Msps per stream | {card}")

    rate, centers, cells, wide = wideband_stream(n, wide_seconds, seed)
    chunk = 19200 * n
    wt, ts = _feed(lambda: WidebandTrigger(rate, centers,
                                           psr_threshold=PSR_THRESHOLD,
                                           transport="i8"),
                   lambda d, a, b: d.process_wide(wide[a:b]),
                   wide.size, chunk)
    for st, want in zip(wt.stores, cells):
        cell = st.latest_cell()
        check(cell is not None and cell.cell_id == want,
              f"WidebandTrigger carrier {want}: {cell}")
    log(f"phase 4 | WidebandTrigger 8 carriers from one 15.36 Msps i8 "
        f"stream, {wide_seconds:g} s | cells {cells} | first pass "
        f"{ts[0]:.1f} s, warm {wide.size / n / ts[1] / 1e6:.2f} Msps per "
        f"carrier | {card}")


def wideband_stream(n: int, seconds: float, seed: int):
    """n carriers, 1.92 MHz apart, in one n x 1.92 Msps complex64 stream."""
    rate = n * 1.92e6
    centers = [(-(n - 1) / 2 + i) * 1.92e6 for i in range(n)]
    cells = [101 + 7 * i for i in range(n)]
    one = np.zeros(19200 * n, np.complex128)
    for c, cid in zip(centers, cells):
        one += synth.upconvert(synth.synthesize_frame(cid, nof_prb_field=50),
                               rate, c)
    one = one / np.sqrt(np.mean(np.abs(one) ** 2))
    need = int(seconds * rate)
    return rate, centers, cells, _noisy(one, need, seed, snr_db=20.0)


# ======================================================================
# phase 5 — four devices
# ======================================================================
def _events(host) -> list:
    return [(s, {k: v for k, v in c.to_dict().items()
                 if k != "tracking_start_time"}) for s, c in host]


def phase5(card: str, n_devices: int = 4, n_steps: int = 20,
           seed: int = SEED) -> None:
    from ltetrigger_jax import MultiTrigger, WidebandTrigger
    from ltetrigger_jax.parallel import (channel_scan, make_mesh,
                                         time_sharded_scan)

    devs = jax.devices()
    check(len(devs) >= n_devices, f"need {n_devices} devices, have {devs}")
    devs = devs[:n_devices]
    one = jax.sharding.SingleDeviceSharding(devs[0])

    # ch axis: C channels split over the devices
    c = 8 * n_devices
    buffers = scan_buffers(c, n_steps, seed)
    ref_f, ref_o = channel_scan(jax.device_put(buffers, one), n_steps,
                                PSR_THRESHOLD)
    mesh = make_mesh(n_channels=n_devices, devices=devs)
    fin, out = channel_scan(buffers, n_steps, PSR_THRESHOLD, mesh=mesh)
    check(all(np.array_equal(np.asarray(a), np.asarray(b))
              for a, b in zip(out, ref_o)),
          "mesh channel_scan differs from one device")
    check_scan_events(fin, out, c, fresh=True)
    log(f"phase 5 | channel_scan C={c} over ch={n_devices}: every output "
        f"field identical to one device | {card}")

    # t axis: one stream in n_devices time blocks, halo by ppermute
    iq, cid, _ = synth.known_answer_frame(6, seed=seed)
    stream = np.tile(iq, 4 * n_devices)
    sp = (jnp.asarray(stream.real), jnp.asarray(stream.imag))
    tmesh = make_mesh(n_channels=1, n_time=n_devices, devices=devs)
    got = time_sharded_scan(sp, tmesh, PSR_THRESHOLD)
    # the same blocks, each with its right neighbour's head, on one device
    block = stream.size // n_devices
    ref = []
    for k in range(n_devices):
        seg = stream[k * block:(k + 1) * block]
        halo = (stream[(k + 1) * block:(k + 1) * block + trig.WINDOW]
                if k + 1 < n_devices else
                np.zeros(trig.WINDOW, np.complex64))
        ref.append(_one_block(np.concatenate([seg, halo]), block))
    for name in got._fields:
        a = np.asarray(getattr(got, name))
        b = np.stack([np.asarray(getattr(r, name)) for r in ref])
        check(np.array_equal(a, b),
              f"time_sharded_scan field {name} differs from one device")
    tracks = np.asarray(got.track_event)
    check(all(tracks[k].any() for k in range(n_devices))
          and set(np.asarray(got.cell_id)[tracks].tolist()) == {cid},
          "time_sharded_scan: a block missed the cell")
    log(f"phase 5 | time_sharded_scan over t={n_devices}: every output "
        f"field identical to the blocks on one device | {card}")

    # live drivers, sharded over ch
    n = 8
    total = int(0.5 * 1.92e6)
    streams = [_noisy(f, total, seed + i)
               for i, f in enumerate(_scan_frames())]
    chunk = 4 * HALF_FRAME_LENGTH
    evs = []
    for m in (None, mesh):
        mt = MultiTrigger(n, psr_threshold=PSR_THRESHOLD, transport="i16",
                          mesh=m, pipeline=0)
        got_ev = []
        for i in range(0, total, chunk):
            got_ev += mt.process_all([s[i:i + chunk] for s in streams])
        got_ev += mt.flush()
        evs.append(_events(got_ev))
    check(evs[0] == evs[1] and len(evs[0]) >= n,
          f"MultiTrigger mesh events differ: {evs[1]} vs {evs[0]}")
    log(f"phase 5 | MultiTrigger(8, mesh ch={n_devices}): {len(evs[0])} "
        f"events identical to one device | {card}")

    rate, centers, cells, wide = wideband_stream(n, 0.25, seed)
    evs = []
    for m in (None, mesh):
        wt = WidebandTrigger(rate, centers, psr_threshold=PSR_THRESHOLD,
                             transport="i8", mesh=m, pipeline=0)
        got_ev = []
        for i in range(0, wide.size, 19200 * n):
            got_ev += wt.process_wide(wide[i:i + 19200 * n])
        got_ev += wt.flush()
        evs.append(_events(got_ev))
    check(evs[0] == evs[1] and len(evs[0]) >= n,
          f"WidebandTrigger mesh events differ: {evs[1]} vs {evs[0]}")
    log(f"phase 5 | WidebandTrigger(8 carriers, mesh ch={n_devices}): "
        f"{len(evs[0])} events identical to one device | {card}")


@functools.partial(jax.jit, static_argnames=("block",))
def _one_block_jit(xr, xi, thresh, block: int):
    from ltetrigger_jax.ops.correlate import V2_WINDOW
    zh = jnp.zeros(trig.LOOKBACK, jnp.float32)
    zt = jnp.zeros(trig.WINDOW, jnp.float32)
    buf = (jnp.concatenate([zh, xr, zt]), jnp.concatenate([zh, xi, zt]))
    _, out = trig.scan_engine(
        buf, trig.init_state(), block // HALF_FRAME_LENGTH, thresh,
        n_valid=trig.LOOKBACK + block + (V2_WINDOW - HALF_FRAME_LENGTH),
        grid0_static=trig.LOOKBACK,
        data_valid=trig.LOOKBACK + block + trig.WINDOW)
    return out


def _one_block(x: np.ndarray, block: int):
    """One time block plus its halo, scanned the way a t-shard scans it."""
    return _one_block_jit(jnp.asarray(x.real), jnp.asarray(x.imag),
                          jnp.float32(PSR_THRESHOLD), block)


# ======================================================================
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-device mesh phase")
    args = ap.parse_args(argv)

    card = phase0()
    if args.devices == 4:
        phase5(card, n_devices=4)
    else:
        for name, fn in (("1", lambda: phase1()), ("2", lambda: phase2(card)),
                         ("3", lambda: phase3(card)),
                         ("4", lambda: phase4(card))):
            t0 = time.perf_counter()
            fn()
            log(f"phase {name} | done in {time.perf_counter() - t0:.1f} s")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
