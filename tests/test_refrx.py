"""Golden tests for the host reference receiver against the 4 real captures.

These mirror the reference's known-answer integration tests
(python/qa_downlink_trigger_c.py:67-203): same files, same asserted fields.
"""

import numpy as np
import pytest

from ltetrigger_jax.ltecore import refrx
from tests.conftest import load_frame


@pytest.mark.parametrize("nof_prb", [6, 25, 50, 100])
def test_known_answer(nof_prb):
    iq, cell_id, rate = load_frame(nof_prb)
    cell = refrx.search_frame(iq.astype(np.complex128), rate)
    assert cell is not None, "no cell found"
    assert cell["cell_id"] == cell_id
    assert cell["nof_prb"] == nof_prb
    assert cell["cp_len"] == "Normal"
    assert cell["nof_ports"] == 1
    assert cell["phich_len"] == "Normal"
    assert cell["nof_phich_resources"] == "1"
    assert cell["psr"] > 4.0


def test_synthetic_pss_injection():
    """PSS injected into noise is found at the right offset with high PSR."""
    from ltetrigger_jax.ltecore import pss as pssmod
    rng = np.random.default_rng(0)
    noise = (rng.normal(size=10240) + 1j * rng.normal(size=10240)) * 0.05
    x = noise.copy()
    start = 4321
    x[start:start + 128] += pssmod.pss_time()[1]
    p = refrx.pss_correlate(x, 1)
    pk, psr = refrx.peak_and_psr(p)
    assert pk == start
    assert psr > 4.0
    # wrong root must not fire
    p0 = refrx.pss_correlate(x, 0)
    _, psr0 = refrx.peak_and_psr(p0)
    assert psr0 < 4.0


def test_sss_all_cells_synthetic():
    """Synthesized SSS symbols decode to the right N_id_1 for a sweep of cells."""
    from ltetrigger_jax.ltecore import pss as pssmod, sss as sssmod
    from ltetrigger_jax.ltecore.constants import CP_NORM, SLOT_LENGTH, SYMBOL_SZ
    bins = pssmod.subcarrier_bins()
    for n_id_1 in (0, 1, 41, 100, 123, 167):
        for n_id_2 in range(3):
            for sub5 in (False, True):
                F = np.zeros(128, dtype=np.complex128)
                F[bins] = sssmod.sss_sequence(n_id_1, n_id_2, sub5)
                sym = np.fft.ifft(F)
                aligned = np.zeros(9600, dtype=np.complex128)
                idx = SLOT_LENGTH - 2 * SYMBOL_SZ - CP_NORM
                aligned[idx:idx + 128] = sym
                got, got5, _, _ = refrx.sss_decode(aligned, n_id_2, True)
                assert got == n_id_1 and got5 == sub5


def test_cp_detect_synthetic():
    """CP detection distinguishes normal vs extended on synthesized symbols."""
    rng = np.random.default_rng(3)
    for normal in (True, False):
        cp = 9 if normal else 32
        x = np.zeros(9600, dtype=np.complex128)
        pos = 960 - 128
        for _ in range(3):
            sym = rng.normal(size=128) + 1j * rng.normal(size=128)
            x[pos:pos + 128] = sym
            x[pos - cp:pos] = sym[-cp:]
            pos -= 128 + cp
        assert refrx.detect_cp(x) == normal


def test_mib_synthesis_loopback():
    """Full PBCH transmit -> receive loopback on a synthesized subframe."""
    from ltetrigger_jax.ltecore import synth
    for cell_id in (0, 123, 369, 501):
        sf = synth.synthesize_pbch_subframe(cell_id, nof_prb_field=50,
                                            sfn=8, quarter=0)
        out = refrx.mib_decode_subframe(sf, cell_id)
        assert out is not None
        assert out["nof_prb"] == 50
        assert out["nof_ports"] == 1
        assert out["quarter"] == 0


@pytest.mark.parametrize("nof_ports,normal_cp,quarter", [
    (1, True, 1), (2, True, 0), (4, True, 2),
    (1, False, 3), (2, False, 0), (4, False, 1),
])
def test_end_to_end_synthetic_configs(nof_ports, normal_cp, quarter):
    """Configs the bundled captures don't cover: multi-port TX and extended CP
    through the full search path (PSS -> CP detect -> SSS -> MIB)."""
    from ltetrigger_jax.ltecore import synth
    cell_id = 77
    f = synth.synthesize_frame(cell_id, nof_prb_field=15,
                               nof_ports=nof_ports, normal_cp=normal_cp,
                               quarter=quarter)
    cell = refrx.search_frame(np.concatenate([f, f]), 1.92e6)
    assert cell is not None
    assert cell["cell_id"] == cell_id
    assert cell["nof_prb"] == 15
    assert cell["nof_ports"] == nof_ports
    assert cell["cp_len"] == ("Normal" if normal_cp else "Extended")
    assert cell["quarter"] == quarter
