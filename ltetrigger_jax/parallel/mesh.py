"""Device mesh construction and multi-host initialization.

The reference has no distributed layer at all (SURVEY §2.6): its concurrency
is GNU Radio's thread-per-block scheduler plus 3-way chain parallelism.  Here
scaling is first-class: a jax.sharding.Mesh over axes

  ch — monitored channels (wideband scan lanes), embarrassingly parallel
  t  — time-blocks of one stream, overlap-save halo at the seams

and XLA collectives (NCCL between GPUs) replace any hand-rolled comm.
Every GPU of a host reaches every other at the same rate, so the mesh
shape follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_channels: int | None = None, n_time: int = 1,
              devices=None) -> Mesh:
    """Mesh with axes (ch, t).  Defaults to all devices on the ch axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_channels is None:
        n_channels = n // n_time
    assert n_channels * n_time == n, \
        f"{n_channels} x {n_time} != {n} devices"
    arr = np.array(devices).reshape(n_channels, n_time)
    return Mesh(arr, ("ch", "t"))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (channel) dim over ch, replicate the rest."""
    return NamedSharding(mesh, P("ch"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up (one controller process per host).

    Where a cluster manager configures jax.distributed the arguments can be
    omitted; otherwise pass the coordinator's host:port, the process count
    and this process's id.
    """
    kw = {}
    if coordinator is not None:
        kw.update(coordinator_address=coordinator,
                  num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kw)
