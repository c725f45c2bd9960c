"""Tests for the native C++ frontend (and its numpy fallbacks)."""

import threading

import numpy as np
import pytest

from ltetrigger_jax.ltecore import refrx
from ltetrigger_jax.runtime import native
from tests.conftest import load_frame


@pytest.fixture(scope="module")
def have_native():
    return native.available()


def test_deinterleave(have_native):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=1000) + 1j * rng.normal(size=1000)) \
        .astype(np.complex64)
    re, im = native.deinterleave(x)
    np.testing.assert_array_equal(re, x.real)
    np.testing.assert_array_equal(im, x.imag)


@pytest.mark.parametrize("ratio", [4, 8, 16])
def test_native_decimator_matches_reference(ratio, have_native):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=ratio * 2048) + 1j * rng.normal(size=ratio * 2048)) \
        .astype(np.complex64)
    got = native.Decimator(ratio)(x)
    ref = refrx.decimate(x.astype(np.complex128), ratio)
    np.testing.assert_allclose(got, ref.astype(np.complex64),
                               rtol=2e-3, atol=2e-3)


def test_decimator_end_to_end_detection(have_native):
    """Host-decimated capture must still decode through the host chain."""
    if not have_native:
        pytest.skip("no native lib")
    iq, cell_id, rate = load_frame(50)
    dec = native.Decimator(int(rate / 1.92e6))
    x = dec(np.concatenate([iq, iq]))
    power = refrx.pss_correlate(x.astype(np.complex128), cell_id % 3)
    pk, psr = refrx.peak_and_psr(power)
    assert psr > 4.0


def test_ring_buffer_roundtrip(have_native):
    ring = native.RingBuffer(1024)
    rng = np.random.default_rng(2)
    x = (rng.normal(size=600) + 1j * rng.normal(size=600)) \
        .astype(np.complex64)
    assert ring.write(x) == 600
    assert ring.available() == 600
    got = ring.read(600)
    np.testing.assert_array_equal(got, x)
    # overfill: writes clamp to capacity
    big = np.zeros(2000, dtype=np.complex64)
    assert ring.write(big) == 1024
    assert ring.read(2000).size == 1024


def test_ring_buffer_threaded(have_native):
    """Producer/consumer across threads: every sample arrives, in order."""
    ring = native.RingBuffer(4096)
    n_total = 200_000
    src = np.arange(n_total, dtype=np.complex64)
    got = []

    def producer():
        sent = 0
        while sent < n_total:
            sent += ring.write(src[sent:sent + 1000])

    def consumer():
        while sum(len(g) for g in got) < n_total:
            chunk = ring.read(1000)
            if chunk.size:
                got.append(chunk)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start(); tc.start()
    tp.join(timeout=30); tc.join(timeout=30)
    all_got = np.concatenate(got)
    np.testing.assert_array_equal(all_got, src)


def test_file_source_repeat(have_native, tmp_path):
    x = np.arange(100, dtype=np.complex64)
    f = tmp_path / "capture.iq"
    x.tofile(f)
    src = native.FileSource(str(f), repeat=True)
    assert src.n_samples == 100
    got = src.read(250)
    np.testing.assert_array_equal(got, np.concatenate([x, x, x[:50]]))

    src2 = native.FileSource(str(f), repeat=False)
    assert src2.read(250).size == 100
    assert src2.read(10).size == 0


def test_cpp_unit_suite():
    """Build and run the native C++ test binary (the reference's CppUnit
    suite is empty and unregistered; this one is real)."""
    import subprocess
    cpp_dir = native._CPP_DIR
    try:
        r = subprocess.run(["make", "-C", cpp_dir, "test"],
                           capture_output=True, text=True, timeout=120)
    except FileNotFoundError:
        pytest.skip("no make toolchain")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all C++ frontend tests passed" in r.stdout
