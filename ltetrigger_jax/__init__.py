"""ltetrigger_jax: LTE cell sensing in JAX.

A from-scratch re-design of the capabilities of NTIA/gr-ltetrigger as
fixed-shape batched JAX/XLA array programs: PSS/SSS synchronization,
PBCH/MIB decode, tracked-cell store, CLI, and multi-device scaling — with
the reference's thread-per-block GNU Radio graph replaced by jitted scans.

Layers (bottom-up):
  ltecore/   pure LTE signal math (numpy constants + host reference receiver)
  ops/       jitted device ops (correlators, OFDM, chest, Viterbi, resampler)
  models/    the flagship "downlink trigger" detection pipeline (lax.scan)
  parallel/  mesh / shard_map multi-channel + multi-device scaling
  runtime/   host streaming driver, cellstore, IO frontends (incl. native C++)
  apps/      cell_search_file-compatible CLI
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir() -> str:
    """Directory of the persistent XLA compilation cache:
    $JAX_COMPILATION_CACHE_DIR when set, else the fixed <checkout>/.jax_cache
    (a fixed path, so repeat runs from one checkout hit the cache)."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return _os.path.abspath(_os.path.join(_os.path.dirname(__file__),
                                          _os.pardir, ".jax_cache"))


def _enable_compilation_cache():
    """Persist XLA compilations across processes (the CLI, bench and smoke
    check recompile the same engine shapes every run otherwise)."""
    if _os.environ.get("JAX_PLATFORMS", "") == "cpu":
        # XLA:CPU cache entries can target ISA extensions another host
        # lacks; CPU compiles are cheap, so CPU runs stay cache-less.
        return
    try:
        import jax
    except ImportError:         # numpy-only use of ltecore
        return
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()

from .ltecore import constants  # noqa: F401,E402


def __getattr__(name):
    # Lazy imports keep `import ltetrigger_jax` fast and jax-optional for
    # pure-numpy users of ltecore.
    if name in ("search", "Trigger"):
        from .models import api
        return getattr(api, name)
    if name == "MultiTrigger":
        from .models.multi import MultiTrigger
        return MultiTrigger
    if name == "WidebandTrigger":
        from .models.wideband import WidebandTrigger
        return WidebandTrigger
    if name == "CellStore":
        from .runtime.cellstore import CellStore
        return CellStore
    raise AttributeError(name)
