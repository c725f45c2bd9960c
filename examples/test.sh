#!/bin/bash
# Smoke test: run the CLI over the 4 known-answer captures (parity with the
# reference's examples/test.sh).  FRAMES names a directory holding
# lte_frame_<prb>prb_cellid_<id> files; unset, the seeded fixtures
# (ltecore/synth.known_answer_frame) are written to a temporary directory.
set -e
cd "$(dirname "$0")/.."
if [ -z "$FRAMES" ]; then
    FRAMES=$(mktemp -d)
    trap 'rm -rf "$FRAMES"' EXIT
    python - "$FRAMES" <<'PY'
import sys
from ltetrigger_jax.ltecore import synth
for prb in synth.KNOWN_ANSWERS:
    iq, cid, _ = synth.known_answer_frame(prb)
    iq.tofile(f"{sys.argv[1]}/lte_frame_{prb}prb_cellid_{cid}")
PY
fi
python -m ltetrigger_jax.apps.cell_search_file "$FRAMES/lte_frame_6prb_cellid_123"   -s 1.92M  --repeat --time-out 1
python -m ltetrigger_jax.apps.cell_search_file "$FRAMES/lte_frame_25prb_cellid_124"  -s 7.68M  --repeat --time-out 1
python -m ltetrigger_jax.apps.cell_search_file "$FRAMES/lte_frame_50prb_cellid_125"  -s 15.36M --repeat --time-out 1
python -m ltetrigger_jax.apps.cell_search_file "$FRAMES/lte_frame_100prb_cellid_369" -s 30.72M --repeat --time-out 1
