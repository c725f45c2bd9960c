"""Golden tests: every jitted op against the host reference receiver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltetrigger_jax.ltecore import refrx, synth
from ltetrigger_jax.ltecore.constants import (HALF_FRAME_LENGTH,
                                              PSS_SYMBOL_START, SYMBOL_SZ)
from ltetrigger_jax.ops import cfo as cfo_ops
from ltetrigger_jax.ops import correlate, cplx, pbch, resample, sync
from tests.conftest import load_frame


@pytest.fixture(scope="module")
def frame6():
    iq, cell_id, _ = load_frame(6)
    return iq.astype(np.complex64), cell_id


class TestCorrelate:
    def test_power_matches_reference(self, frame6):
        iq, _ = frame6
        win = np.concatenate([iq, iq])[:correlate.WINDOW_LEN]
        got = np.asarray(jax.jit(correlate.pss_correlate_power)(cplx.from_numpy(win)))
        for nid2 in range(3):
            ref = refrx.pss_correlate(win.astype(np.complex128), nid2)
            np.testing.assert_allclose(got[nid2], ref, rtol=2e-3, atol=1e-4)

    def test_peak_psr_matches_reference(self, frame6):
        iq, _ = frame6
        win = np.concatenate([iq, iq])[:correlate.WINDOW_LEN]
        power = jax.jit(correlate.pss_correlate_power)(cplx.from_numpy(win))
        peaks, psrs = jax.jit(correlate.peak_and_psr)(power)
        for nid2 in range(3):
            ref_pk, ref_psr = refrx.peak_and_psr(np.asarray(power[nid2]))
            assert int(peaks[nid2]) == ref_pk
            np.testing.assert_allclose(float(psrs[nid2]), ref_psr, rtol=1e-4)

    def test_batched(self, frame6):
        iq, _ = frame6
        win = np.concatenate([iq, iq])[:correlate.WINDOW_LEN]
        wp = cplx.from_numpy(win)
        batch = (jnp.stack([wp[0]] * 4), jnp.stack([wp[1]] * 4))
        p = jax.jit(correlate.pss_correlate_power)(batch)
        assert p.shape == (4, 3, HALF_FRAME_LENGTH)
        np.testing.assert_allclose(p[0], p[3], rtol=1e-6)


class TestCfo:
    def test_estimate_recovers_injected_offset(self):
        from ltetrigger_jax.ltecore import pss as pssmod
        rep = pssmod.pss_time()[1].astype(np.complex64)
        # unambiguous estimator range is (-1, 1) subcarrier spacings
        # (phase over a half symbol), matching srsLTE
        for cfo_true in (-0.9, -0.25, 0.0, 0.4, 0.9):
            n = np.arange(SYMBOL_SZ)
            rx = rep * np.exp(2j * np.pi * cfo_true / SYMBOL_SZ * n)
            est = cfo_ops.cfo_estimate(cplx.from_numpy(rx),
                                       cplx.from_numpy(rep))
            assert abs(float(est) - cfo_true) < 0.02

    def test_correct_inverts_offset(self):
        from ltetrigger_jax.ltecore import pss as pssmod
        rep = pssmod.pss_time()[0].astype(np.complex64)
        n = np.arange(SYMBOL_SZ)
        cfo_true = 0.8
        rx = rep * np.exp(2j * np.pi * cfo_true / SYMBOL_SZ * n)
        fixed = cfo_ops.cfo_correct(cplx.from_numpy(rx),
                                    jnp.asarray(-cfo_true / SYMBOL_SZ))
        np.testing.assert_allclose(cplx.to_numpy(fixed), rep, atol=1e-5)


class TestSync:
    def test_cp_detect_matches_reference(self, frame6):
        iq, _ = frame6
        aligned = iq[:HALF_FRAME_LENGTH]
        got = bool(jax.jit(sync.detect_cp)(cplx.from_numpy(aligned)))
        assert got == refrx.detect_cp(aligned.astype(np.complex128))
        assert got is True

    def test_cp_detect_extended(self):
        f = synth.synthesize_frame(300, nof_prb_field=25, normal_cp=False)
        aligned = f[:HALF_FRAME_LENGTH]
        assert not bool(sync.detect_cp(cplx.from_numpy(aligned)))

    def test_sss_on_capture(self, frame6):
        iq, cell_id = frame6
        aligned = cplx.from_numpy(iq[:HALF_FRAME_LENGTH])
        nid1, sub5 = jax.jit(sync.sss_decode)(
            aligned, jnp.int32(cell_id % 3), jnp.bool_(True))
        assert int(nid1) == cell_id // 3
        assert not bool(sub5)

    def test_sss_subframe5(self, frame6):
        iq, cell_id = frame6
        aligned = cplx.from_numpy(iq[HALF_FRAME_LENGTH:])
        nid1, sub5 = sync.sss_decode(aligned, jnp.int32(cell_id % 3),
                                     jnp.bool_(True))
        assert int(nid1) == cell_id // 3
        assert bool(sub5)

    def test_sss_partial_correlation_timing_robust(self):
        """srslte_sss_m0m1_partial parity (reference lib/sss_impl.cc:112):
        a few samples of residual timing error put a phase ramp across the
        62 SSS subcarriers that collapses full-length coherent correlation;
        the 3-section partial correlation (the shipped default) survives."""
        cell_id = 321
        f = synth.synthesize_frame(cell_id, nof_prb_field=50)
        n = np.arange(9600)
        # 3 samples early (inside the CP) + 0.3-subcarrier residual CFO
        x = np.concatenate([np.zeros(3, complex), f[:9597]])
        x = (x * np.exp(2j * np.pi * 0.3 / 128 * n)).astype(np.complex64)
        xp = cplx.from_numpy(x)
        full, _ = sync.sss_decode(xp, jnp.int32(cell_id % 3),
                                  jnp.bool_(True), sections=1)
        part, sub5 = sync.sss_decode(xp, jnp.int32(cell_id % 3),
                                     jnp.bool_(True), sections=3)
        assert int(full) != cell_id // 3, "impairment too weak to demonstrate"
        assert int(part) == cell_id // 3
        assert not bool(sub5)

    def test_sss_batched_roots(self, frame6):
        iq, cell_id = frame6
        ap = cplx.from_numpy(iq[:HALF_FRAME_LENGTH])
        aligned = (jnp.stack([ap[0]] * 3), jnp.stack([ap[1]] * 3))
        nid1, _ = jax.vmap(sync.sss_decode)(
            aligned, jnp.arange(3, dtype=jnp.int32),
            jnp.ones(3, dtype=bool))
        assert int(nid1[cell_id % 3]) == cell_id // 3


class TestResample:
    @pytest.mark.parametrize("nof_prb", [25, 50, 100])
    def test_matches_reference(self, nof_prb):
        iq, _, rate = load_frame(nof_prb)
        ratio = int(rate / 1.92e6)
        x = iq[:ratio * 4096]
        got = cplx.to_numpy(resample.decimate(cplx.from_numpy(x), ratio))
        ref = refrx.decimate(x.astype(np.complex128), ratio)
        np.testing.assert_allclose(got, ref.astype(np.complex64),
                                   rtol=2e-3, atol=2e-3)


class TestPbch:
    def test_decodes_capture(self, frame6):
        iq, cell_id = frame6
        out = jax.jit(pbch.mib_decode)(
            cplx.from_numpy(iq[:1920]), jnp.int32(cell_id), jnp.bool_(True))
        assert bool(out["found"])
        assert int(out["nof_prb"]) == 6
        assert int(out["nof_ports"]) == 1
        assert int(out["phich_ext"]) == 0
        assert int(out["phich_res"]) == 2   # "1"
        assert int(out["quarter"]) == 0

    def test_wrong_cell_id_no_false_positive(self, frame6):
        iq, cell_id = frame6
        out = pbch.mib_decode(cplx.from_numpy(iq[:1920]),
                              jnp.int32(cell_id + 1), jnp.bool_(True))
        assert not bool(out["found"])

    def test_subframe5_no_decode(self, frame6):
        iq, cell_id = frame6
        out = pbch.mib_decode(cplx.from_numpy(iq[9600:9600 + 1920]),
                              jnp.int32(cell_id), jnp.bool_(True))
        assert not bool(out["found"])

    @pytest.mark.parametrize("nof_ports,normal_cp,quarter", [
        (1, True, 0), (2, True, 1), (4, True, 3),
        (1, False, 2), (2, False, 0), (4, False, 1),
    ])
    def test_synthetic_configs(self, nof_ports, normal_cp, quarter):
        cell_id = 451
        sf = synth.synthesize_pbch_subframe(
            cell_id, nof_prb_field=75, quarter=quarter,
            nof_ports=nof_ports, normal_cp=normal_cp)
        out = pbch.mib_decode(cplx.from_numpy(sf), jnp.int32(cell_id),
                              jnp.bool_(normal_cp))
        assert bool(out["found"])
        assert int(out["nof_prb"]) == 75
        assert int(out["nof_ports"]) == nof_ports
        assert int(out["quarter"]) == quarter

    def test_tti_soft_combining_beats_single_subframe(self):
        """40 ms TTI soft-combining (the srslte_ue_mib_decode frame-buffer
        capability, reference lib/mib_impl.cc:75-76,162): at -21 dB SNR no
        individual subframe decodes, but accumulating the four quarters'
        LLRs across the TTI does."""
        cell_id = 451
        frames = [synth.synthesize_frame(cell_id, nof_prb_field=50,
                                         sfn=q, quarter=q) for q in range(4)]
        rng = np.random.default_rng(2)
        sigma = np.sqrt(10 ** (21 / 10) / 2)

        acc = jnp.zeros((12, 120), jnp.float32)
        n = jnp.int32(0)
        combined_found = False
        for q in range(4):
            sf = frames[q][:1920] + sigma * (
                rng.normal(size=1920) + 1j * rng.normal(size=1920))
            sfp = cplx.from_numpy(sf.astype(np.complex64))
            single = pbch.mib_decode(sfp, jnp.int32(cell_id), jnp.bool_(True))
            assert not bool(single["found"]), \
                f"quarter {q} decoded single-shot; SNR too high for this test"
            acc, out = pbch.mib_combine_decode(
                sfp, jnp.int32(cell_id), jnp.bool_(True), acc, n)
            n = n + 1
            if bool(out["found"]):
                combined_found = True
                assert int(out["nof_prb"]) == 50
                assert int(out["nof_ports"]) == 1
        assert combined_found, "soft-combining failed to decode the TTI"

    def test_combine_first_attempt_equals_stateless(self):
        """Phase h = 0 of a fresh accumulator IS the stateless decode: the
        first combined attempt must reproduce mib_decode exactly."""
        iq, cell_id = load_frame(6)[0].astype(np.complex64), 123
        sfp = cplx.from_numpy(iq[:1920])
        single = pbch.mib_decode(sfp, jnp.int32(cell_id), jnp.bool_(True))
        acc = jnp.zeros((12, 120), jnp.float32)
        _, comb = pbch.mib_combine_decode(sfp, jnp.int32(cell_id),
                                          jnp.bool_(True), acc, jnp.int32(0))
        for k in ("found", "nof_prb", "nof_ports", "phich_ext", "phich_res",
                  "sfn_offset", "quarter"):
            assert np.asarray(single[k]) == np.asarray(comb[k]), k

    def test_noise_rejected(self):
        rng = np.random.default_rng(7)
        noise = rng.normal(size=1920) + 1j * rng.normal(size=1920)
        out = pbch.mib_decode(cplx.from_numpy(noise), jnp.int32(123),
                              jnp.bool_(True))
        assert not bool(out["found"])


class TestViterbi:
    def test_wraparound_matches_exact_tb(self):
        """The wrap-around decoder (srsLTE's PBCH strategy, the production
        path) must agree with the exact 64-init tail-biting decoder on
        clean and noisy codewords, and both must invert conv_encode."""
        from ltetrigger_jax.ltecore import coding
        from ltetrigger_jax.ops.viterbi import (viterbi_decode_tb,
                                                viterbi_decode_wa)
        rng = np.random.default_rng(11)
        for noise in (0.0, 0.6, 1.0):
            bits_in = rng.integers(0, 2, size=(24, 40)).astype(np.uint8)
            llr = np.stack([
                (1.0 - 2.0 * coding.conv_encode(b).astype(np.float64)
                 + noise * rng.normal(size=(3, 40))).T
                for b in bits_in])
            llr = jnp.asarray(llr, dtype=jnp.float32)
            bt, mt = viterbi_decode_tb(llr)
            bw, mw = viterbi_decode_wa(llr)
            np.testing.assert_array_equal(np.asarray(bw), np.asarray(bt))
            np.testing.assert_array_equal(np.asarray(bt), bits_in)
            # the wa metric is the 120-step wrap path / 3: identical on
            # clean codewords, a few % off under noise (outer thirds may
            # take different survivor routes)
            np.testing.assert_allclose(np.asarray(mw), np.asarray(mt),
                                       rtol=1e-5 if noise == 0.0 else 0.05)

    def test_radix4_matches_radix2(self):
        """The radix-4 production decoder (2 trellis stages per scan step)
        must be bit- and metric-exact vs the radix-2 formulation."""
        from ltetrigger_jax.ltecore import coding
        from ltetrigger_jax.ops.viterbi import (viterbi_decode_wa,
                                                viterbi_decode_wa_r2)
        rng = np.random.default_rng(12)
        bits_in = rng.integers(0, 2, size=(32, 40)).astype(np.uint8)
        llr = np.stack([
            (1.0 - 2.0 * coding.conv_encode(b).astype(np.float64)
             + 0.8 * rng.normal(size=(3, 40))).T
            for b in bits_in])
        llr = jnp.asarray(llr, dtype=jnp.float32)
        b4, m4 = viterbi_decode_wa(llr)
        b2, m2 = viterbi_decode_wa_r2(llr)
        np.testing.assert_array_equal(np.asarray(b4), np.asarray(b2))
        np.testing.assert_allclose(np.asarray(m4), np.asarray(m2), rtol=1e-6)


class TestCorrelateV2:
    def test_v2_matches_v1(self, frame6):
        iq, _ = frame6
        win = np.concatenate([iq, iq])[:correlate.V2_WINDOW]
        wp = cplx.from_numpy(win)
        p1 = np.asarray(correlate.pss_correlate_power(wp))
        p2 = np.asarray(correlate.pss_correlate_power_v2(wp))
        np.testing.assert_allclose(p2, p1, rtol=5e-3, atol=1e-4)
        # peak/PSR decisions must agree exactly
        pk1, psr1 = correlate.peak_and_psr(jnp.asarray(p1))
        pk2, psr2 = correlate.peak_and_psr(jnp.asarray(p2))
        np.testing.assert_array_equal(np.asarray(pk1), np.asarray(pk2))
        np.testing.assert_allclose(np.asarray(psr1), np.asarray(psr2),
                                   rtol=5e-3)


class TestPssChest:
    def test_flat_channel_on_capture(self, frame6):
        """PSS LS channel estimate (telemetry parity: the reference computes
        it into a never-consumed buffer, lib/pss_impl.cc:206-209) — on the
        synthetic capture the channel is flat, so all 62 estimates agree."""
        iq, cell_id = frame6
        sym = cplx.from_numpy(iq[PSS_SYMBOL_START:PSS_SYMBOL_START + 128])
        h = cfo_ops.pss_chest(sym, n_id_2=cell_id % 3)
        hv = np.asarray(h[0]) + 1j * np.asarray(h[1])
        assert np.std(np.abs(hv)) / np.mean(np.abs(hv)) < 0.05
        assert np.std(np.angle(hv * np.exp(-1j * np.angle(hv.mean())))) < 0.1


class TestRationalResample:
    def test_tone_preserved(self):
        fs, n = 10e6, 50000
        t = np.arange(n) / fs
        sig = np.exp(2j * np.pi * 200e3 * t).astype(np.complex64)
        y = cplx.to_numpy(resample.rational_resample(
            cplx.from_numpy(sig), 24, 125))          # 10 MHz -> 1.92 MHz
        assert y.size == n * 24 // 125
        t2 = np.arange(y.size) * 125 / (24 * fs)
        ref = np.exp(2j * np.pi * 200e3 * t2)
        assert np.abs(y[200:-200] - ref[200:-200]).max() < 0.01

    def test_integer_path_consistent(self):
        rng = np.random.default_rng(0)
        x = (rng.normal(size=8192) + 1j * rng.normal(size=8192)) \
            .astype(np.complex64)
        a = cplx.to_numpy(resample.rational_resample(cplx.from_numpy(x), 1, 4))
        b = cplx.to_numpy(resample.decimate(cplx.from_numpy(x), 4))
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_search_from_3mhz(self, frame6):
        """End-to-end: a capture 'recorded' at 3 MHz (up 25/16 host
        interpolation) searches fine via the rational path — a rate the
        reference rejects outright."""
        from ltetrigger_jax.models import api
        iq, cell_id = frame6
        # FFT-interpolate 1.92M -> 3.0M (x25/16)
        F = np.fft.fft(iq.astype(np.complex128))
        n = iq.size
        nw = n * 25 // 16
        Fw = np.zeros(nw, dtype=np.complex128)
        Fw[:n // 2] = F[:n // 2]
        Fw[-n // 2:] = F[-n // 2:]
        wide = (np.fft.ifft(Fw) * (nw / n)).astype(np.complex64)
        cells = api.search(wide, 3.0e6, psr_threshold=4, max_seconds=0.4)
        assert cells and cells[0].cell_id == cell_id
        assert cells[0].nof_prb == 6


def test_peak_and_psr_blocked_matches_flat():
    """The block-layout peak/PSR (engine hot path) must be bit-identical to
    the flat formulation, including argmax tie order and lobe-walk edges."""
    import jax.numpy as jnp

    from ltetrigger_jax.ops import correlate

    rng = np.random.default_rng(17)
    for trial in range(7):
        p = rng.random((2, 3, 9600)).astype(np.float32)
        if trial == 1:      # exact ties
            p[(p > 0.99)] = 1.5
            p[0, 0, 0] = 1.5
            p[0, 0, 9599] = 1.5
        if trial == 2:      # peak at block boundaries
            p[0, :, 128 * 40 - 1] = 3.0
            p[1, :, 128 * 40] = 3.0
        if trial == 3:      # peak at the stream ends (duplicate-element
            p[0, :, 0] = 3.0            # rise semantics at the edges)
            p[1, :, 9599] = 3.0
        if trial == 4:      # peak just inside the ends, lobe reaching out
            p[0, :, 5] = 3.0
            p[1, :, 9597] = 3.0
        if trial == 5:      # monotone plateau around the peak (no rise
            p[0, 0, 4000:4200] = 2.0    # within lobe_limit on either side)
        if trial == 6:      # strong sidelobe exactly at the lobe edge
            p[0, 0, 4000] = 3.0
            p[0, 0, 4063] = 2.9
            p[0, 0, 4064] = 2.95
        pk_f, psr_f = correlate.peak_and_psr(jnp.asarray(p))
        blocked = jnp.asarray(p.reshape(2, 3, 75, 128).transpose(0, 2, 1, 3))
        for impl in (correlate.peak_and_psr_blocked,
                     correlate._peak_and_psr_blocked_multipass):
            pk_b, psr_b = impl(blocked)
            np.testing.assert_array_equal(np.asarray(pk_f), np.asarray(pk_b))
            np.testing.assert_array_equal(np.asarray(psr_f),
                                          np.asarray(psr_b))
