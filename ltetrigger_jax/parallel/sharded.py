"""Sharded detection: multi-channel scan-out and time-sharded streams.

Two scaling patterns (BASELINE.md north star: "multi-channel wideband scan,
N channels sharded across hosts; halo-exchange streaming"):

  1. channel_scan — C independent monitored channels, sharded over the mesh
     `ch` axis.  The trigger pipeline is vmapped over channels; XLA partitions
     the batch with zero communication.  This preserves full streaming
     state-machine semantics per channel.

  2. time_sharded_scan — ONE stream split into D contiguous time blocks
     (mesh `t` axis), each block scanned independently after a halo exchange
     (ppermute) hands every shard the WINDOW-sized head of its right
     neighbour, so no peak is lost at a seam.  Tracking state does not cross
     seams (each block acquires independently) — the offline wide-area scan
     trade-off, documented here rather than hidden.

Seam-state design choice (deliberate): carrying TriggerState across seams
would make shard k+1 data-depend on shard k's final carry, serializing the
scan into a device-count-long sequential chain — exactly the wall-clock the
`t` axis exists to remove.  Independent acquisition costs only re-detection
latency inside each block: publishing a cell needs ONE over-threshold
half-frame with valid SSS + MIB CRC (tracking hysteresis gates telemetry
and loss events, not first publication), so any shard holding >= 1 clean
subframe-0 half-frame detects on its own, and the adversarial seam cases
are covered by halo width (tests/test_parallel.py seam tests).  Streams
needing continuous tracking state belong on the `ch` axis (one stream per
lane) or in the host-driven api.Trigger, both of which carry state forever.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ltecore.constants import DEFAULT_TRACK_AFTER, DEFAULT_TRACK_EVERY
from ..models import trigger as trig


# --------------------------------------------------------- channel scan ----
@functools.partial(jax.jit, static_argnames=("n_steps", "track_after",
                                             "track_every", "combine",
                                             "grid0_static"))
def _channel_scan_jit(buffers, states, psr_threshold, n_steps,
                      track_after, track_every, combine, grid0_static):
    # the engine is rank-polymorphic: the [C] channel axis rides as a
    # leading batch dim of every tensor (no outer vmap), which keeps the
    # postpass lax.cond gates real branches — when no channel emitted or
    # captured anything (the universal case for noise channels / wideband
    # scans) everything past the correlation+hysteresis passes is skipped
    return trig.scan_engine(buffers, states, n_steps, psr_threshold,
                            track_after, track_every, combine=combine,
                            grid0_static=grid0_static)


def channel_scan(buffers: jnp.ndarray, n_steps: int, psr_threshold,
                 mesh: Mesh | None = None,
                 track_after: int = DEFAULT_TRACK_AFTER,
                 track_every: int = DEFAULT_TRACK_EVERY,
                 states=None, combine: bool = True):
    """Run the scan engine over C channels, sharded over `ch`.

    buffers: pair of [C, N] float32 (see ops/cplx.py), each padded like
             trigger.scan_engine expects (LOOKBACK zero head + WINDOW tail).
    states:  optional [C,...] TriggerState carry from a previous call
             (fresh init per channel if None).
    returns: (final_states [C,...], StepOutput [n_steps, C, R, ...])

    The jitted engine is a single module-level function so repeated calls
    with the same (shape, n_steps) hit XLA's executable cache instead of
    re-tracing a fresh closure each time (which recompiled per call and cost
    seconds of host time per invocation).
    """
    c = buffers[0].shape[0]
    fresh = states is None
    if fresh:
        states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (c,) + x.shape), trig.init_state())

    if mesh is not None:
        cs = NamedSharding(mesh, P("ch"))
        buffers = jax.device_put(buffers, cs)
        states = jax.device_put(states, cs)
    # fresh states start at the static grid origin -> static pass-A slicing
    grid0_static = trig.LOOKBACK if fresh else None
    return _channel_scan_jit(buffers, states,
                             jnp.asarray(psr_threshold, jnp.float32),
                             n_steps, track_after, track_every,
                             combine, grid0_static)


# ----------------------------------------------------- time-sharded scan ---
def halo_exchange_right(x_local: jnp.ndarray, halo: int,
                        axis_name: str = "t") -> jnp.ndarray:
    """Append the first `halo` samples of the right neighbour's block.

    Inside shard_map: x_local [B] -> [B + halo].  The last shard receives
    zeros (stream end).  The ring hop is one ppermute (a collective).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    head = x_local[:halo]
    # send my head to my LEFT neighbour (so I receive my right neighbour's)
    recv = jax.lax.ppermute(head, axis_name,
                            [(i, (i - 1) % n) for i in range(n)])
    recv = jnp.where(idx == n - 1, jnp.zeros_like(recv), recv)
    return jnp.concatenate([x_local, recv])


@functools.lru_cache(maxsize=64)
def _time_sharded_exec(mesh: Mesh, block: int, track_after: int,
                       track_every: int):
    """Compiled t-sharded scan for one (mesh, block) geometry.  Cached at
    module level: building a fresh jit(shard_map(...)) closure per call
    recompiled every invocation AND leaked executables (XLA:CPU segfaulted
    after ~100 compiles in the randomized property test)."""
    halo = trig.WINDOW
    steps = block // trig.HALF_FRAME_LENGTH

    def shard_fn(xr, xi, thresh):
        zh = jnp.zeros(trig.LOOKBACK, jnp.float32)
        zt = jnp.zeros(trig.WINDOW, jnp.float32)
        buf = tuple(jnp.concatenate(
            [zh, halo_exchange_right(comp[0], halo), zt])
            for comp in (xr, xi))
        # logical end: exactly the grid steps whose 9600 candidate starts
        # lie inside this block are active (active <=> grid + V2_WINDOW <=
        # n_valid <=> 9600*(k+1) <= block) — each stream position is owned
        # by exactly one shard; the halo exists so windows reaching past
        # the seam stay valid.
        from ..ops.correlate import V2_WINDOW
        n_valid = trig.LOOKBACK + block + (V2_WINDOW
                                           - trig.HALF_FRAME_LENGTH)
        st, out = trig.scan_engine(buf, trig.init_state(), steps,
                                   thresh, track_after, track_every,
                                   n_valid=n_valid,
                                   grid0_static=trig.LOOKBACK,
                                   # candidate gathers may read into the
                                   # halo: data extends past the owned span
                                   data_valid=trig.LOOKBACK + block + halo)
        return jax.tree_util.tree_map(lambda a: a[None], out)

    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P("t"), P("t"), P()),
        out_specs=P("t"), check_vma=False))


def time_sharded_scan(stream: jnp.ndarray, mesh: Mesh, psr_threshold,
                      track_after: int = DEFAULT_TRACK_AFTER,
                      track_every: int = DEFAULT_TRACK_EVERY):
    """Scan one long stream with time blocks sharded over the `t` axis.

    stream: pair of [N] float32 (unpadded).  N must divide evenly by the
    t-axis size; pad the tail with zeros beforehand if needed.
    returns StepOutput stacked [t_shards, steps_per_shard, R, ...].
    """
    n_t = mesh.shape["t"]
    assert stream[0].shape[0] % n_t == 0
    block = stream[0].shape[0] // n_t
    assert block % trig.HALF_FRAME_LENGTH == 0, (
        "pad the stream so each time block is a half-frame multiple — the "
        "grid engine searches in exact 9600-sample tiles")
    fn = _time_sharded_exec(mesh, block, track_after, track_every)
    return fn(stream[0].reshape(n_t, block), stream[1].reshape(n_t, block),
              jnp.asarray(psr_threshold, jnp.float32))
