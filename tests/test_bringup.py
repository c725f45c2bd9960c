"""Device bring-up contracts that the CPU suite can check: the known-answer
fixtures, exact (HIGHEST-precision) selection contractions, the compile
cache rule, and chip_smoke.py's device gate and result line."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ltetrigger_jax import compile_cache_dir
from ltetrigger_jax.ltecore import refrx, synth
from ltetrigger_jax.models import api
from ltetrigger_jax.models import trigger as trig
from ltetrigger_jax.ops import correlate

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("nof_prb", sorted(synth.KNOWN_ANSWERS))
def test_known_answer_fixture_search(nof_prb):
    """Each seeded fixture decodes through api.search to the six MIB
    fields the reference's capture of that bandwidth carries, equal to
    the host reference receiver's."""
    iq, cell_id, rate = synth.known_answer_frame(nof_prb)
    assert iq.dtype == np.complex64
    assert iq.size == 19200 * round(rate / 1.92e6)
    want = {"cell_id": cell_id, "nof_prb": nof_prb, "nof_tx_ports": 1,
            "cp_len": "Normal", "phich_len": "Normal",
            "nof_phich_resources": "1"}
    ref = refrx.search_frame(iq.astype(np.complex128), rate)
    assert chip_smoke._ref_fields(ref) == want
    cells = api.search(iq, rate, max_seconds=0.2)
    assert cells, "no cell found"
    assert {k: cells[0].to_dict()[k] for k in chip_smoke.MIB_FIELDS} == want


def _dense_segs():
    s, c = 2, 2
    n = trig.LOOKBACK + s * trig.HALF_FRAME_LENGTH + trig.WINDOW
    buf = (jnp.zeros((c, n)), jnp.zeros((c, n)))
    peak = jnp.zeros((s, c, trig.R), jnp.int32)
    return jax.jit(trig._extract_segs_dense, static_argnums=(1, 2)).lower(
        buf, trig.LOOKBACK, s, peak)


def _dense_cands():
    s, c = 2, 2
    n = trig.LOOKBACK + s * trig.HALF_FRAME_LENGTH + trig.WINDOW
    buf = (jnp.zeros((c, n)), jnp.zeros((c, n)))
    starts = jnp.full((c, trig.R, 4), trig.LOOKBACK + 128, jnp.int32)
    return jax.jit(trig._gather_cands_dense_core,
                   static_argnums=(2, 3)).lower(buf, starts, trig.LOOKBACK, s)


def _peak_blocked():
    power = jnp.zeros((2, 75, trig.R, 128))
    return jax.jit(correlate.peak_and_psr_blocked).lower(power)


@pytest.mark.parametrize("lowered", [_dense_segs, _dense_cands,
                                     _peak_blocked],
                         ids=["extract_segs_dense", "gather_cands_dense",
                              "peak_and_psr_blocked"])
def test_selection_contractions_are_highest(lowered):
    """Every 0/1 selection contraction runs at HIGHEST precision, so a GPU
    cannot round its data operand to TF32 (the outputs stay exact)."""
    dots = [ln for ln in lowered().as_text().splitlines()
            if "dot_general" in ln]
    assert dots, "no contraction found"
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


def _cache_dir_in_child(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, ltetrigger_jax; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(ltetrigger_jax.compile_cache_dir())"],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.split()


def test_compile_cache_uses_env_dir(tmp_path):
    got = _cache_dir_in_child(str(tmp_path))
    assert got == [str(tmp_path), str(tmp_path)]


def test_compile_cache_default_is_checkout(monkeypatch):
    want = str(REPO / ".jax_cache")
    got = _cache_dir_in_child(None)
    assert got == [want, want]
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == want


def test_compile_cache_path_is_fixed(monkeypatch):
    """Neither the process nor the time enters the path: two processes
    agree, and the path holds no pid."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a = _cache_dir_in_child(None)[1]
    b = _cache_dir_in_child(None)[1]
    assert a == b == compile_cache_dir()
    assert str(os.getpid()) not in a


def test_chip_smoke_refuses_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)


def test_chip_smoke_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=env, cwd=str(REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line_shape():
    line = chip_smoke.result_line(jax.devices())
    assert "\n" not in line
    rec = json.loads(line)
    assert rec == {"ok": True,
                   "device": {"platform": jax.devices()[0].platform,
                              "kind": jax.devices()[0].device_kind,
                              "count": len(jax.devices())}}
