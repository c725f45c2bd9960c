"""Test configuration.

Tests run on CPU with 8 virtual XLA devices so the multi-device sharding
paths are exercised without accelerators (the analogue of the reference's
'no multi-node tests possible' gap — SURVEY.md §4).  The backend is set
through jax.config before any device is touched, which holds even when jax
was imported before this file.  The GPU check is `python chip_smoke.py` on
a machine with a card; tests marked `gpu` skip here.
"""

import os
import pathlib

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# XLA:CPU cache entries can target ISA extensions another host lacks;
# CPU compiles are cheap, so tests run cache-less.  Device runs keep the
# persistent cache (see ltetrigger_jax.compile_cache_dir).
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

TEST_FRAMES_DIR = pathlib.Path("/root/reference/test_frames")

FRAMES = {
    6: ("lte_frame_6prb_cellid_123", 123, 1.92e6),
    25: ("lte_frame_25prb_cellid_124", 124, 7.68e6),
    50: ("lte_frame_50prb_cellid_125", 125, 15.36e6),
    100: ("lte_frame_100prb_cellid_369", 369, 30.72e6),
}


def load_frame(nof_prb: int):
    name, cell_id, rate = FRAMES[nof_prb]
    path = TEST_FRAMES_DIR / name
    if not path.exists():
        pytest.skip(f"test vector {path} not available")
    return np.fromfile(path, dtype=np.complex64), cell_id, rate


@pytest.fixture
def frame_loader():
    return load_frame
