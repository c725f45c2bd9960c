#!/usr/bin/env python
"""Given a file containing a recorded LTE downlink, decode MIB and print to
stdout.

Flag-compatible rebuild of the reference CLI (examples/cell_search_file.py):

    python -m ltetrigger_jax.apps.cell_search_file FILE -s 15.36M \\
        --repeat --time-out 1 [--threshold 4] [--cut-off N] [--fifoname F]

Behavior parity:
  * raw interleaved complex64 input, sample rate must be an integer multiple
    of 1.92 MHz (reference :50-54);
  * `--repeat` loops the capture; `--time-out` bounds the *stream time*
    searched; `--cut-off` bounds the number of input samples (head block);
  * results printed as JSON ("FOUND" records with the reference's cell
  schema, or {"status": "NOT_FOUND"}); optional length-prefixed JSON to a
  named FIFO (reference :131-137) — the integration hook for scanners;
  * `--throttle` is accepted for interface parity (a no-op here).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np


def eng_float(value):
    from ..utils.eng_notation import str_to_num
    try:
        return str_to_num(value)
    except Exception:
        raise argparse.ArgumentTypeError(
            f"invalid engineering notation value: {value!r}")


def eng_int(value):
    return int(eng_float(value))


def filetype(fname):
    if os.path.isfile(fname):
        return fname
    raise argparse.ArgumentTypeError(f"file {fname} does not exist")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cell_search_file")
    p.add_argument("filename", type=filetype)
    p.add_argument("-s", "--sample-rate", type=eng_float, required=True,
                   metavar="Hz", help="input data's sample rate [Required]")
    p.add_argument("-f", "--frequency", type=eng_float, metavar="Hz",
                   help="input data's center frequency")
    p.add_argument("--repeat", action="store_true",
                   help="loop file until cell found or cut-off reached "
                        "[default=%(default)s]")
    p.add_argument("-c", "--cut-off", type=eng_int, metavar="N", default=-1,
                   help="stop looping after N samples [default=%(default)s]")
    p.add_argument("--throttle", type=eng_float, metavar="Hz",
                   help="accepted for compatibility; no-op")
    p.add_argument("--time-out", type=eng_float, metavar="sec", default=-1,
                   help="max stream seconds to search [default=%(default)s]")
    p.add_argument("--threshold", type=eng_float, default=4,
                   help="set peak to side-lobe ratio threshold "
                        "[default=%(default)s]")
    p.add_argument("--fifoname", default=None, required=False,
                   help="FIFO name to which to write output")
    p.add_argument("--gui", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--debug", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--json-only", action="store_true",
                   help="suppress progress text; print only JSON")
    return p


def main(argv=None) -> int:
    logging.basicConfig()
    args = build_parser().parse_args(argv)

    if args.debug:
        print(f"Blocked waiting for debugger attach (pid = {os.getpid()})")
        input("Press enter to continue...")

    from ..ltecore.constants import SAMPLE_RATE
    from ..models import api
    from ..runtime.cellstore import CellStore

    from fractions import Fraction

    iq = np.fromfile(args.filename, dtype=np.complex64)
    frac = Fraction(args.sample_rate / SAMPLE_RATE).limit_denominator(1000)
    if abs(float(frac) - args.sample_rate / SAMPLE_RATE) > 1e-9:
        logging.getLogger("cell_search_file").error(
            "Sample rate %.2f MHz is not a rational multiple of 1.92 MHz.",
            args.sample_rate / 1e6)
        return -1

    if args.cut_off > -1:
        iq = iq[:args.cut_off]

    # stream-time budget: --time-out seconds, else (if not repeating) just
    # one pass over the file
    if args.time_out > -1:
        seconds = float(args.time_out)
    elif args.repeat:
        seconds = 1.0
    else:
        seconds = len(iq) / args.sample_rate

    if not args.repeat:
        seconds = min(seconds, len(iq) / args.sample_rate)

    if not args.json_only:
        print("Starting cell search... ", end="")
        sys.stdout.flush()

    store = CellStore()
    api.search(iq, args.sample_rate, psr_threshold=args.threshold,
               exit_on_success=True, max_seconds=max(seconds, 0.01),
               cellstore=store)

    if not args.json_only:
        print("done.")

    results = []
    if store.tracking():
        for cell in store.cells():
            d = cell.to_dict()
            d["status"] = "FOUND"
            results.append(json.dumps(d, indent=4))
    else:
        results.append(json.dumps({"status": "NOT_FOUND"}))

    for cell in results:
        print(cell)

    if args.fifoname:
        if not os.path.exists(args.fifoname):
            os.mkfifo(args.fifoname)
        pipeout = os.open(args.fifoname, os.O_WRONLY)
        for cell in results:
            os.write(pipeout, f"{len(cell)}\n{cell}".encode())
        os.close(pipeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
