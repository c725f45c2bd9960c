"""Physical-channel realism tests (VERDICT r2 gap #1): the receiver must
survive frequency-selective multipath per TX port — the input class the
reference meets over the air (rtlsdr demo, README.rst:12-13) but that no
identity-channel fixture ever exercised.  These are the first tests to push
non-flat h through the CRS linear-interp chest (ops/pbch.py:135-146) and the
SFBC / SFBC-FSTD combiners."""

import numpy as np
import pytest

from ltetrigger_jax.ltecore import synth
from ltetrigger_jax.models import api


def _channel_response(taps, nfft=128):
    h = np.zeros(nfft, dtype=np.complex128)
    for d, g in taps:
        h[d] = g
    return np.fft.fft(h)


def test_default_channels_are_frequency_selective():
    """Sanity that the fixture channel actually stresses the chest: |H|
    varies by >6 dB across the 72 occupied subcarriers."""
    for taps in synth.default_port_channels(4):
        H = _channel_response(taps)
        occ = np.concatenate([H[-36:], H[1:37]])     # the 6-PRB band
        ratio = np.max(np.abs(occ)) / (np.min(np.abs(occ)) + 1e-12)
        assert ratio > 2.0, f"channel too flat: {ratio:.2f}"


@pytest.mark.parametrize("nof_ports", [1, 2, 4])
def test_fading_mib_decode(nof_ports):
    """Full pipeline through per-port ETU-class multipath, noiseless."""
    cell_id = 77 + nof_ports
    rx = synth.synthesize_faded_frames(cell_id, n_frames=8,
                                       nof_prb_field=50,
                                       nof_ports=nof_ports, seed=2)
    cells = api.search(rx, 1.92e6, psr_threshold=4, max_seconds=0.5)
    assert cells, f"no detection through multipath ({nof_ports} ports)"
    assert cells[0].cell_id == cell_id
    assert cells[0].nof_prb == 50
    assert cells[0].nof_tx_ports == nof_ports


def test_fading_with_noise_and_doppler():
    """Multipath + 10 dB SNR + 100 Hz common Doppler: per-subframe chest
    must track the rotation; TTI combining still converges."""
    rx = synth.synthesize_faded_frames(200, n_frames=10, nof_prb_field=25,
                                       nof_ports=2, snr_db=10.0,
                                       doppler_hz=100.0, seed=5)
    cells = api.search(rx, 1.92e6, psr_threshold=4, max_seconds=0.6)
    assert cells and cells[0].cell_id == 200
    assert cells[0].nof_prb == 25


def test_fading_extended_cp():
    rx = synth.synthesize_faded_frames(301, n_frames=8, nof_prb_field=15,
                                       nof_ports=1, normal_cp=False, seed=3)
    cells = api.search(rx, 1.92e6, psr_threshold=4, max_seconds=0.5)
    assert cells and cells[0].cell_id == 301
    assert cells[0].cp_len == "Extended"


def test_per_port_synthesis_matches_identity_sum():
    """synthesize_frame (identity channel) must equal the per-port rows
    summed — the refactor cannot change the existing fixtures."""
    ports = synth.synthesize_frame_ports(142, nof_prb_field=100, nof_ports=2)
    summed = ports.sum(axis=0)
    summed /= np.sqrt(np.mean(np.abs(summed) ** 2))
    direct = synth.synthesize_frame(142, nof_prb_field=100, nof_ports=2)
    np.testing.assert_allclose(summed, direct, atol=1e-12)
