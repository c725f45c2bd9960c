#!/usr/bin/env python
"""Wideband LTE scan: find every cell in a wide capture in one device pass.

A capability with no reference counterpart (gr-ltetrigger watches a single
carrier per process): channelize the capture to a grid of candidate centers,
then run the full trigger pipeline over all channels at once — sharded over
the mesh `ch` axis when more than one chip is available.

CLI:
    python -m ltetrigger_jax.apps.wideband_scan capture.iq -s 30.72M \\
        --centers -10M,0,10M [--seconds 0.5] [--threshold 4]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def wideband_scan(iq: np.ndarray, sample_rate: float, center_offsets_hz,
                  seconds: float = 0.5, psr_threshold: float = 4.0,
                  mesh=None) -> list[dict]:
    """-> list of {center_offset_hz, detected, cell fields...} per channel."""
    import jax.numpy as jnp

    from ..ltecore.constants import SAMPLE_RATE
    from ..models import api, trigger as trig
    from ..ops import channelize as chan
    from ..parallel import channel_scan
    from ..runtime.cellstore import PHICH_RES_STR

    centers = list(center_offsets_hz)
    total = int(seconds * SAMPLE_RATE)
    need_wide = int(seconds * sample_rate)
    if iq.size < need_wide:
        reps = -(-need_wide // iq.size)
        iq = np.tile(iq, reps)[:need_wide]

    chans = chan.channelize(iq, sample_rate, centers)   # pair [C, Nd]
    c = chans[0].shape[0]
    zh = jnp.zeros((c, trig.LOOKBACK), jnp.float32)
    zt = jnp.zeros((c, trig.WINDOW), jnp.float32)
    buffers = (jnp.concatenate([zh, chans[0][:, :total], zt], axis=1),
               jnp.concatenate([zh, chans[1][:, :total], zt], axis=1))

    n_steps = total // trig.HALF_FRAME_LENGTH
    _, out = channel_scan(buffers, n_steps,
                          api.ensure_safe_threshold(psr_threshold),
                          mesh=mesh)

    track = np.asarray(out.track_event)                # [steps, C, R]
    results = []
    for ci, off in enumerate(centers):
        ev = track[:, ci, :]
        rec = {"center_offset_hz": float(off), "detected": bool(ev.any())}
        if rec["detected"]:
            s, r = np.argwhere(ev)[0]
            rec.update({
                "cell_id": int(np.asarray(out.cell_id)[s, ci, r]),
                "nof_prb": int(np.asarray(out.nof_prb)[s, ci, r]),
                "nof_tx_ports": int(np.asarray(out.nof_ports)[s, ci, r]),
                "cp_len": "Normal" if np.asarray(out.normal_cp)[s, ci, r]
                          else "Extended",
                "phich_len": "Extended"
                             if np.asarray(out.phich_ext)[s, ci, r]
                             else "Normal",
                "nof_phich_resources":
                    PHICH_RES_STR[int(np.asarray(out.phich_res)[s, ci, r])],
                "psr": float(np.asarray(out.psr)[s, ci, r]),
            })
        results.append(rec)
    return results


def _centers(spec: str):
    from ..utils.eng_notation import str_to_num
    return [str_to_num(tok) for tok in spec.split(",") if tok.strip()]


def main(argv=None) -> int:
    from .cell_search_file import eng_float, filetype

    p = argparse.ArgumentParser(prog="wideband_scan")
    p.add_argument("filename", type=filetype)
    p.add_argument("-s", "--sample-rate", type=eng_float, required=True)
    p.add_argument("--centers", type=_centers, required=True,
                   help="comma-separated offsets from capture center, "
                        "eng notation (e.g. -10M,0,10M)")
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--threshold", type=eng_float, default=4)
    args = p.parse_args(argv)

    iq = np.fromfile(args.filename, dtype=np.complex64)
    out = wideband_scan(iq, args.sample_rate, args.centers,
                        seconds=args.seconds, psr_threshold=args.threshold)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
