"""SNR-sweep harness test: detection must be monotone-ish — solid at high
SNR, absent far below the threshold (the measurement the reference only
offered as a GUI demo)."""

import numpy as np

from ltetrigger_jax.apps.snr_sweep import snr_sweep
from tests.conftest import load_frame


def test_snr_sweep_curve():
    iq, cell_id, rate = load_frame(6)
    curve = snr_sweep(iq, rate, snrs_db=[-20, 0, 20], seconds=0.35)
    by_snr = {c["snr_db"]: c for c in curve}
    assert not by_snr[-20.0]["detected"]
    assert by_snr[20.0]["detected"]
    assert by_snr[20.0]["cell_id"] == cell_id
    # PSR should grow with SNR
    assert by_snr[20.0]["max_psr"] > by_snr[-20.0]["max_psr"]


def test_detection_knee_pinned():
    """The detection-SNR knee at the reference's default threshold 4 sits
    at -8 dB (examples/make_snr_curve.py measures the curve): detection
    holds at -8 dB and is gone by -14 dB.  Guards the BASELINE.md secondary metric
    against sensitivity regressions."""
    iq, cell_id, rate = load_frame(6)
    curve = snr_sweep(iq, rate, snrs_db=[-14, -8], seconds=0.5, seed=0)
    by_snr = {c["snr_db"]: c for c in curve}
    assert by_snr[-8.0]["detected"]
    assert by_snr[-8.0]["cell_id"] == cell_id
    assert not by_snr[-14.0]["detected"]


def test_tti_combining_gain_in_pbch_limited_regime():
    """The regime where 40 ms TTI soft-combining MUST show its gain
    (VERDICT r4 #2): PSS/SSS/CRS at 0 dB (acquisition always succeeds),
    ONLY the PBCH REs attenuated, exposure = 4 full TTIs.  At a PBCH level
    between the two knees (-27 dB rel: combine P=1.0, single P=0.0 on the
    committed curve), combining must publish and the stateless decoder
    must not.  The overall-SNR curves (examples/make_snr_curve.py) are
    acquisition-limited and cannot separate the two — this pins the
    separation where it exists."""
    from ltetrigger_jax.apps.snr_sweep import pbch_sweep

    p_comb = pbch_sweep([-27.0], n_ttis=4, n_trials=4, combine=True,
                        seed=2)[0]["prob"]
    p_single = pbch_sweep([-27.0], n_ttis=4, n_trials=4, combine=False,
                          seed=2)[0]["prob"]
    assert p_comb >= 0.75, f"combining must decode at -27 dB: P={p_comb}"
    assert p_single <= 0.25, \
        f"stateless decode should fail at -27 dB: P={p_single}"
