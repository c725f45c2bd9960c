"""Unit tests for the pure signal-model layer (the unit layer the reference
lacks — SURVEY.md §4 'unit tests: effectively none')."""

import numpy as np
import pytest

from ltetrigger_jax.ltecore import (coding, constants as C, crs, mib, pss,
                                    scrambling, sss)


class TestPSS:
    def test_zadoff_chu_cazac(self):
        for root in C.PSS_ZC_ROOTS:
            d = pss.zadoff_chu(root)
            assert d.shape == (62,)
            np.testing.assert_allclose(np.abs(d), 1.0, atol=1e-12)

    def test_roots_distinct_low_crosscorr(self):
        t = pss.pss_time()
        g = np.abs(t @ t.conj().T)
        # unit-energy autocorr on the diagonal, low cross terms
        np.testing.assert_allclose(np.diag(g), 1.0, atol=1e-9)
        off = g - np.diag(np.diag(g))
        # roots 25/34 are conjugate pairs => elevated zero-lag crosscorr (~0.38)
        assert off.max() < 0.5

    def test_subcarrier_bins(self):
        b = pss.subcarrier_bins()
        assert b[0] == 128 - 31 and b[30] == 127
        assert b[31] == 1 and b[61] == 31
        assert 0 not in b  # DC punctured


class TestSSS:
    def test_nid1_roundtrip(self):
        tab = sss.nid1_table()
        for nid1 in range(168):
            m0, m1 = sss.m0m1_from_nid1(nid1)
            assert tab[m0, m1] == nid1
            assert tab[m1, m0] == -1  # swapped pair must be invalid (subframe 5)

    def test_table_count(self):
        assert (sss.nid1_table() >= 0).sum() == 168

    def test_sequence_pm1(self):
        d = sss.sss_sequence(41, 0, subframe5=False)
        assert set(np.unique(d)) <= {-1.0, 1.0}

    def test_subframe5_is_swap(self):
        d0 = sss.sss_sequence(41, 0, subframe5=False)
        d5 = sss.sss_sequence(41, 0, subframe5=True)
        assert not np.array_equal(d0, d5)


class TestScrambling:
    def test_gold_matches_direct_lfsr(self):
        # direct LFSR implementation, independently coded
        def direct(c_init, n):
            x1 = [1] + [0] * 30
            x2 = [(c_init >> i) & 1 for i in range(31)]
            out = []
            for i in range(scrambling.NC + n):
                n1 = x1[3] ^ x1[0]
                n2 = x2[3] ^ x2[2] ^ x2[1] ^ x2[0]
                if i >= scrambling.NC:
                    out.append(x1[0] ^ x2[0])
                x1 = x1[1:] + [n1]
                x2 = x2[1:] + [n2]
            return np.array(out, dtype=np.uint8)

        for c_init in (0, 1, 123, 0x12345, (1 << 30) + 12345):
            np.testing.assert_array_equal(
                scrambling.gold_sequence(c_init, 200), direct(c_init, 200))

    def test_crs_c_init(self):
        # spot value: cell 0, slot 0, sym 0, normal cp
        assert scrambling.crs_c_init(0, 0, 0, True) == 1024 * 8 + 1


class TestCoding:
    def test_crc16_known_vector(self):
        # CRC-16/CCITT-FALSE-like with zero init: CRC of '123456789' ascii bits
        bits = np.unpackbits(np.frombuffer(b"123456789", dtype=np.uint8))
        crc = coding.crc16(bits)
        val = int("".join(map(str, crc)), 2)
        assert val == 0x31C3  # XMODEM (poly 0x1021, init 0)

    def test_conv_encode_matches_trellis(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 40).astype(np.uint8)
        enc = coding.conv_encode(bits)
        # walk the trellis with the same input and compare outputs
        prev_state, out_bits = coding.trellis_tables()
        state = 0
        for d in range(1, 7):
            state |= int(bits[40 - d]) << (6 - d)
        for t in range(40):
            ns = (state >> 1) | (int(bits[t]) << 5)
            drop = state & 1
            assert prev_state[ns, drop] == state
            expect = 1.0 - 2.0 * enc[:, t].astype(np.float64)
            np.testing.assert_array_equal(out_bits[ns, drop], expect)
            state = ns

    def test_viterbi_loopback(self):
        from ltetrigger_jax.ltecore.refrx import viterbi_tailbiting
        rng = np.random.default_rng(1)
        for trial in range(5):
            payload = rng.integers(0, 2, 24).astype(np.uint8)
            bits = coding.crc16_attach(payload, 1)
            enc = coding.conv_encode(bits)
            llr = (1.0 - 2.0 * enc.T.reshape(-1).astype(np.float64))
            llr += rng.normal(0, 0.3, llr.shape)  # mild noise
            dec, _ = viterbi_tailbiting(llr)
            np.testing.assert_array_equal(dec, bits)

    def test_ratematch_roundtrip(self):
        rng = np.random.default_rng(2)
        coded = rng.integers(0, 2, (3, 40)).astype(np.uint8)
        e = coding.rate_match(coded, 1920)
        assert e.shape == (1920,)
        # soft dematch of noiseless +-1 must recover every coded bit
        llr = 1.0 - 2.0 * e.astype(np.float64)
        acc = np.zeros(120)
        np.add.at(acc, coding.ratematch_map(40, 1920), llr)
        hard = (acc < 0).astype(np.uint8)
        np.testing.assert_array_equal(hard, coded.reshape(-1))
        # every coded bit repeated 16x
        counts = np.bincount(coding.ratematch_map(40, 1920), minlength=120)
        assert counts.min() == 16 and counts.max() == 16

    def test_crc_mask_distinguishes_ports(self):
        payload = np.zeros(24, dtype=np.uint8)
        b1 = coding.crc16_attach(payload, 1)
        b2 = coding.crc16_attach(payload, 2)
        b4 = coding.crc16_attach(payload, 4)
        assert not np.array_equal(b1, b2)
        assert not np.array_equal(b1, b4)
        assert not np.array_equal(b2, b4)


class TestMib:
    def test_pack_unpack_roundtrip(self):
        for nof_prb in C.NOF_PRB_TABLE:
            for res in range(4):
                bits = mib.mib_pack(nof_prb, False, res, 256)
                out = mib.mib_unpack(bits)
                assert out["nof_prb"] == nof_prb
                assert out["nof_phich_resources"] == mib.PHICH_RESOURCES_STR[res]
                assert out["phich_len"] == "Normal"
                assert out["sfn_offset"] == 256


class TestCRS:
    def test_values_qpsk(self):
        v = crs.crs_values(123, 1, 0)
        np.testing.assert_allclose(np.abs(v), 1.0, atol=1e-12)
        assert v.shape == (12,)

    def test_subcarriers_within_range(self):
        for port in range(4):
            for sym in crs.crs_symbol_indices(port):
                k = crs.crs_subcarriers(123, port, sym, 1)
                assert k.min() >= 0 and k.max() < 72
                assert len(np.unique(k % 6)) == 1

    def test_port01_disjoint_same_symbol(self):
        k0 = crs.crs_subcarriers(123, 0, 0, 1)
        k1 = crs.crs_subcarriers(123, 1, 0, 1)
        assert not set(k0) & set(k1)


class TestFrameGeometry:
    def test_symbol_offsets(self):
        offs = C.symbol_data_offsets(True)
        assert len(offs) == 7 and offs[0] == 10
        assert offs[-1] + 128 == 960
        offs_e = C.symbol_data_offsets(False)
        assert len(offs_e) == 6 and offs_e[0] == 32
        assert offs_e[-1] + 128 == 960
