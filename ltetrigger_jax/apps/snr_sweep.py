#!/usr/bin/env python
"""Detection-probability-vs-SNR sweep.

Programmatic replacement for the reference's snr_ltetrigger.grc GUI demo
(SURVEY §2.1: file source + noise source + adder + SNR meter, detection
observed by eye).  Here the whole sweep is ONE batched device program: each
(SNR point x noise trial) becomes a channel of the multi-channel scan
engine, so a 20-point, 8-trial curve costs one jit invocation (and shards
across chips via the `ch` mesh axis when available).

Library use:
    from ltetrigger_jax.apps.snr_sweep import snr_sweep
    curve = snr_sweep(iq, sample_rate, snrs_db=range(-10, 11, 2), n_trials=8)

CLI:
    python -m ltetrigger_jax.apps.snr_sweep capture.iq -s 1.92M \\
        --snr-min -10 --snr-max 10 --snr-step 2 [--seconds 0.5] [--seed 0] \\
        [--trials 8] [--no-combine]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _noisy_buffers(sig, sigmas, key):
    """[N] clean signal + [C] noise sigmas -> padded [C, N'] scan buffers,
    entirely on device."""
    import functools

    import jax
    import jax.numpy as jnp

    from ..models import trigger as trig

    @functools.partial(jax.jit, static_argnames=())
    def build(sig, sigmas, key):
        c = sigmas.shape[0]
        n = sig[0].shape[0]
        kr, ki = jax.random.split(key)
        zh = jnp.zeros((c, trig.LOOKBACK), jnp.float32)
        zt = jnp.zeros((c, trig.WINDOW), jnp.float32)

        def comp(s, k):
            noise = jax.random.normal(k, (c, n), jnp.float32) \
                * sigmas[:, None]
            return jnp.concatenate([zh, s[None] + noise, zt], axis=1)

        return (comp(sig[0], kr), comp(sig[1], ki))

    return build(sig, sigmas, key)


def snr_sweep(iq: np.ndarray, sample_rate: float, snrs_db,
              seconds: float = 0.5, psr_threshold: float = 4.0,
              seed: int = 0, mesh=None, n_trials: int = 1,
              combine: bool = True, channel_taps=None) -> list[dict]:
    """Detection stats per SNR point. SNR = signal power / noise power.

    n_trials > 1 runs that many independent noise realizations per SNR
    point (all as channels of one device program) and reports the
    detection probability.  combine=False disables MIB soft-combining
    across the 40 ms PBCH TTI (stateless per-subframe decoding) for
    sensitivity A/B measurement.  channel_taps (list of (delay_samples,
    complex_gain)) passes the signal through a static multipath channel
    before noise — SNR stays defined at the receiver (post-channel signal
    power is renormalized to 1).
    """
    import jax.numpy as jnp

    from ..ltecore.constants import SAMPLE_RATE
    from ..models import api, trigger as trig
    from ..parallel import channel_scan
    from ..ops import resample, cplx

    snrs_db = list(snrs_db)
    ratio = int(round(sample_rate / SAMPLE_RATE))
    base = cplx.to_numpy(resample.decimate(cplx.from_numpy(iq), ratio))
    total = int(seconds * SAMPLE_RATE)
    reps = -(-total // base.size)
    sig = np.tile(base, reps)[:total]
    if channel_taps is not None:
        from ..ltecore.synth import multipath_channel
        sig = multipath_channel(sig, channel_taps)
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2) + 1e-30)

    # noise is generated ON DEVICE (jax PRNG): the host uploads one clean
    # signal (~MBs) instead of (n_snr x n_trials) noisy copies
    import jax

    sigmas = np.repeat(
        np.sqrt(np.power(10.0, -np.asarray(snrs_db, np.float64) / 10.0)
                / 2.0), n_trials).astype(np.float32)
    sigp = (jnp.asarray(sig.real.astype(np.float32)),
            jnp.asarray(sig.imag.astype(np.float32)))
    buffers = _noisy_buffers(sigp, jnp.asarray(sigmas),
                             jax.random.PRNGKey(seed))

    n_steps = total // trig.HALF_FRAME_LENGTH
    final, out = channel_scan(buffers, n_steps,
                              api.ensure_safe_threshold(psr_threshold),
                              mesh=mesh, combine=combine)

    track = np.asarray(out.track_event)       # [steps, C, R]
    psr = np.asarray(out.psr)
    cell_ids = np.asarray(out.cell_id)
    results = []
    for i, snr_db in enumerate(snrs_db):
        lanes = slice(i * n_trials, (i + 1) * n_trials)
        ev = track[:, lanes, :]               # [steps, trials, R]
        det_per_trial = ev.any(axis=(0, 2))   # [trials]
        detected = bool(det_per_trial.any())
        rec = {
            "snr_db": float(snr_db),
            "detected": detected,
            "prob": float(det_per_trial.mean()),
            "n_trials": n_trials,
            "max_psr": float(psr[:, lanes, :].max()),
            "mean_psr": float(psr[:, lanes, :].mean()),
        }
        if detected:
            s, t, r = np.argwhere(ev)[0]
            rec["cell_id"] = int(cell_ids[s, i * n_trials + t, r])
            rec["steps_to_detect"] = int(s)
        results.append(rec)
    return results


def pbch_sweep(pbch_rel_db, cell_id: int = 77, nof_prb_field: int = 50,
               n_ttis: int = 6, n_trials: int = 8,
               snr_sync_db: float = 0.0, psr_threshold: float = 4.0,
               seed: int = 0, combine: bool = True, mesh=None) -> list[dict]:
    """P(MIB publish) vs PBCH resource-element level, in the PBCH-LIMITED
    regime (VERDICT r4 #2): PSS/SSS/CRS ride at `snr_sync_db` (default
    0 dB — acquisition always succeeds; the end-to-end knee is -9 dB), and
    ONLY the PBCH REs are attenuated by `pbch_rel_db` (dB relative to
    nominal).  This isolates what the overall-SNR sweep cannot show: the
    committed SNR curves are acquisition-limited, so MIB soft-combining
    across the 40 ms TTI can never move their knees.  Here the publish
    decision IS the MIB decode.

    The stream cycles the true PBCH quarter sequence over `n_ttis` full
    TTIs (4 frames each, payload advancing per TTI), so combining has real
    40 ms structure to integrate.  combine=False is the stateless
    per-subframe decoder (same A/B as snr_sweep).

    Device shape: ONE jitted scan over [n_points * n_trials] channels,
    built on device from two uploaded streams (sync-only and PBCH-only
    components — PBCH level is a per-channel linear gain)."""
    import functools

    import jax
    import jax.numpy as jnp

    from ..ltecore.synth import synthesize_frame_ports
    from ..models import api, trigger as trig
    from ..parallel import channel_scan

    pbch_rel_db = list(pbch_rel_db)
    f0, f1 = [], []
    for f in range(4 * n_ttis):
        kw = dict(sfn=f, quarter=f % 4)
        f0.append(synthesize_frame_ports(cell_id, nof_prb_field,
                                         pbch_scale=0.0, **kw)[0])
        f1.append(synthesize_frame_ports(cell_id, nof_prb_field,
                                         pbch_scale=1.0, **kw)[0])
    s0 = np.concatenate(f0)
    d = np.concatenate(f1) - s0                  # the PBCH REs alone
    norm = np.sqrt(np.mean(np.abs(s0) ** 2))     # SAME scale for both parts
    s0, d = s0 / norm, d / norm
    sigma = float(np.sqrt(10.0 ** (-snr_sync_db / 10.0) / 2.0))
    gains = np.repeat(10.0 ** (np.asarray(pbch_rel_db, np.float64) / 20.0),
                      n_trials).astype(np.float32)

    @functools.partial(jax.jit, static_argnames=())
    def build(s0p, dp, gains, key):
        c = gains.shape[0]
        n = s0p[0].shape[0]
        kr, ki = jax.random.split(key)
        zh = jnp.zeros((c, trig.LOOKBACK), jnp.float32)
        zt = jnp.zeros((c, trig.WINDOW), jnp.float32)

        def comp(s, dd, k):
            noise = jax.random.normal(k, (c, n), jnp.float32) * sigma
            return jnp.concatenate(
                [zh, s[None] + gains[:, None] * dd[None] + noise, zt],
                axis=1)

        return (comp(s0p[0], dp[0], kr), comp(s0p[1], dp[1], ki))

    s0p = (jnp.asarray(s0.real.astype(np.float32)),
           jnp.asarray(s0.imag.astype(np.float32)))
    dp = (jnp.asarray(d.real.astype(np.float32)),
          jnp.asarray(d.imag.astype(np.float32)))
    buffers = build(s0p, dp, jnp.asarray(gains), jax.random.PRNGKey(seed))

    n_steps = s0.size // trig.HALF_FRAME_LENGTH
    _, out = channel_scan(buffers, n_steps,
                          api.ensure_safe_threshold(psr_threshold),
                          mesh=mesh, combine=combine)

    track = np.asarray(out.track_event)          # [steps, C, R]
    cells = np.asarray(out.cell_id)
    results = []
    for i, rel_db in enumerate(pbch_rel_db):
        lanes = slice(i * n_trials, (i + 1) * n_trials)
        ev = track[:, lanes, :]
        good = ev & (cells[:, lanes, :] == cell_id)
        per_trial = good.any(axis=(0, 2))
        rec = {
            "pbch_rel_db": float(rel_db),
            "prob": float(per_trial.mean()),
            "n_trials": n_trials,
            "snr_sync_db": float(snr_sync_db),
        }
        if per_trial.any():
            rec["median_steps_to_publish"] = int(np.median(
                [np.argwhere(good[:, t, :])[0][0]
                 for t in range(n_trials) if good[:, t, :].any()]))
        results.append(rec)
    return results


def main(argv=None) -> int:
    from .cell_search_file import eng_float, filetype

    p = argparse.ArgumentParser(prog="snr_sweep")
    p.add_argument("filename", type=filetype)
    p.add_argument("-s", "--sample-rate", type=eng_float, required=True)
    p.add_argument("--snr-min", type=float, default=-10)
    p.add_argument("--snr-max", type=float, default=10)
    p.add_argument("--snr-step", type=float, default=2)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--threshold", type=eng_float, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--no-combine", action="store_true",
                   help="disable MIB soft-combining across the PBCH TTI")
    p.add_argument("--fading", action="store_true",
                   help="pass the signal through the default ETU-class "
                        "frequency-selective multipath profile before noise")
    args = p.parse_args(argv)

    taps = None
    if args.fading:
        from ..ltecore.synth import default_port_channels
        taps = default_port_channels(1)[0]

    iq = np.fromfile(args.filename, dtype=np.complex64)
    snrs = np.arange(args.snr_min, args.snr_max + 1e-9, args.snr_step)
    curve = snr_sweep(iq, args.sample_rate, snrs, seconds=args.seconds,
                      psr_threshold=args.threshold, seed=args.seed,
                      n_trials=args.trials, combine=not args.no_combine,
                      channel_taps=taps)
    print(json.dumps(curve, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
