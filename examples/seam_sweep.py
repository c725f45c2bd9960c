#!/usr/bin/env python
"""Seam-state sensitivity of the time-sharded scan (VERDICT r4 #3/weak #3).

`time_sharded_scan` deliberately does NOT carry TriggerState across `t`-axis
seams (parallel/sharded.py:19-29): each block acquires independently, which
keeps the shards data-parallel instead of serially chained.  The cost is
integration state — EMA'd correlation power and the TTI soft-combine
accumulator restart at every seam.  This script MEASURES that cost instead
of arguing about it: detection probability near the knee, continuous scan
vs 8-way time-sharded scan of the SAME noisy streams (same noise
realizations, signal present throughout, so every seam "straddles" the
signal).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/seam_sweep.py [--trials 16]

tests/test_parallel.py::test_time_sharded_knee_within_1db pins the knee gap
on the 6 PRB known-answer fixture (ltecore/synth.py).
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# this measurement runs on the 8-virtual-device CPU mesh (same rig as the
# test suite); the backend is set through jax.config, which holds even if
# jax was imported first
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8") \
    .strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)


def seam_sweep(snrs_db, n_trials: int = 16, n_shards: int = 8,
               steps_per_shard: int = 12, psr_threshold: float = 4.0,
               seed: int = 0):
    """-> per-SNR {snr_db, p_continuous, p_sharded} over shared noise."""
    import jax
    import jax.numpy as jnp

    from ltetrigger_jax.models import trigger as trig
    from ltetrigger_jax.parallel import (channel_scan, make_mesh,
                                         time_sharded_scan)

    from ltetrigger_jax.ltecore import synth
    iq = synth.known_answer_frame(6)[0]
    block = steps_per_shard * trig.HALF_FRAME_LENGTH
    total = n_shards * block
    sig = np.tile(iq, -(-total // iq.size))[:total]
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2))
    mesh = make_mesh(n_channels=1, n_time=n_shards)

    rng = np.random.default_rng(seed)
    out = []
    for snr_db in snrs_db:
        sigma = float(np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0))
        det_c, det_s = 0, 0
        for _ in range(n_trials):
            noisy = (sig + sigma * (rng.normal(size=total)
                                    + 1j * rng.normal(size=total))) \
                .astype(np.complex64)
            pair = (jnp.asarray(noisy.real.astype(np.float32)),
                    jnp.asarray(noisy.imag.astype(np.float32)))
            # continuous: one channel through the same engine
            zh = jnp.zeros((1, trig.LOOKBACK), jnp.float32)
            zt = jnp.zeros((1, trig.WINDOW), jnp.float32)
            buf = (jnp.concatenate([zh, pair[0][None], zt], axis=1),
                   jnp.concatenate([zh, pair[1][None], zt], axis=1))
            _, oc = channel_scan(buf, total // trig.HALF_FRAME_LENGTH,
                                 psr_threshold)
            track_c = np.asarray(oc.track_event)
            cid_c = np.asarray(oc.cell_id)
            det_c += bool((track_c & (cid_c == 123)).any())
            # sharded: same samples through the t axis
            os_ = time_sharded_scan(pair, mesh, psr_threshold)
            track_s = np.asarray(os_.track_event)
            cid_s = np.asarray(os_.cell_id)
            det_s += bool((track_s & (cid_s == 123)).any())
        out.append({"snr_db": float(snr_db),
                    "p_continuous": det_c / n_trials,
                    "p_sharded": det_s / n_trials,
                    "n_trials": n_trials})
        print(json.dumps(out[-1]), flush=True)
    return out


def knee(xs, key):
    best = None
    for r in sorted(xs, key=lambda r: -r["snr_db"]):
        if r[key] >= 0.5:
            best = r["snr_db"]
        else:
            break
    return best


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=16)
    p.add_argument("--snr-min", type=float, default=-12)
    p.add_argument("--snr-max", type=float, default=-6)
    p.add_argument("--step", type=float, default=1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    snrs = list(np.arange(args.snr_min, args.snr_max + 1e-9, args.step))
    res = seam_sweep(snrs, n_trials=args.trials, seed=args.seed)
    print(json.dumps({
        "knee_continuous_db": knee(res, "p_continuous"),
        "knee_sharded_db": knee(res, "p_sharded"),
        "curve": res,
    }, indent=2))


if __name__ == "__main__":
    main()
