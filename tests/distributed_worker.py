"""Worker process for the 2-process jax.distributed test.

Spawned by tests/test_distributed.py with TEST_COORD/TEST_NPROC/TEST_PID in
the environment; each process contributes 4 virtual CPU devices to a global
8-device (ch, t) mesh, runs a short channel_scan over the mesh, and checks
the cross-process detection pattern.  This is the multi-host bring-up path
(parallel/mesh.py::init_distributed) the single-process suite can't reach.
"""

import os
import sys

import numpy as np


def main() -> int:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from ltetrigger_jax.models import trigger as trig
    from ltetrigger_jax.parallel import channel_scan, make_mesh
    from ltetrigger_jax.parallel.mesh import init_distributed

    init_distributed(os.environ["TEST_COORD"],
                     int(os.environ["TEST_NPROC"]),
                     int(os.environ["TEST_PID"]))
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    from ltetrigger_jax.ltecore import synth
    iq, cell_id, _ = synth.known_answer_frame(6)
    sig = np.concatenate([
        np.zeros(trig.LOOKBACK, np.complex64), np.tile(iq, 2),
        np.zeros(trig.WINDOW, np.complex64)])
    rng = np.random.default_rng(0)
    noise = 0.1 * (rng.normal(size=sig.size)
                   + 1j * rng.normal(size=sig.size)).astype(np.complex64)
    chans = np.stack([sig if c % 2 == 0 else noise for c in range(8)])

    mesh = make_mesh(n_channels=8, n_time=1)
    from jax.sharding import NamedSharding, PartitionSpec as P
    cs = NamedSharding(mesh, P("ch"))
    # every process holds the full host value; make_array_from_callback
    # uploads only the locally-addressable shards
    buffers = tuple(
        jax.make_array_from_callback(
            chans.shape, cs,
            lambda idx, comp=comp: comp[idx])
        for comp in (chans.real.astype(np.float32),
                     chans.imag.astype(np.float32)))

    _, out = channel_scan(buffers, 3, 4.0, mesh=mesh)

    from jax.experimental import multihost_utils
    ev = multihost_utils.process_allgather(out.track_event,
                                           tiled=True)       # [steps, 8, R]
    cid = multihost_utils.process_allgather(out.cell_id, tiled=True)
    per_chan = ev.any(axis=(0, 2))
    assert per_chan.tolist() == [True, False] * 4, per_chan
    assert set(cid[ev].tolist()) == {cell_id}, cid[ev]
    print("DISTRIBUTED_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
