#!/usr/bin/env python
"""THE attribution tool for the grid engine (consolidates the former
bench_attrib{,2,3,5}.py one-offs into subcommands so the measurement
protocol stays reproducible).

All timings follow the bench protocol: device-resident inputs, every timed
region fenced by a device->host scalar fetch, best of N.

Subcommands:
  passes  [--channels C] [--steps S]
      The per-pass op-ladder of one dispatch: pass A alone (grid
      correlation matmuls), passes A+B (scan_pass), A+B+C without decode,
      full engine with decode.  Deltas localize the cost.
  sweep   [--channels 128,512,1024] [--steps S]
      `passes` over a channel list -> the high-C attribution table.
  groups  [--channels C] [--budgets 2048,4096,8192,16384] [--steps S]
      GROUP_BUDGET sensitivity (pass-A group amortization vs device
      memory): spawns one subprocess per budget with LTETRIGGER_GROUP_BUDGET
      set, full-engine timing.  The parent never touches the device, so
      each child in turn is the only process on the GPU.
  decode  [--channels C]
      Decode-stage micro: PBCH front-end, codeword search (Viterbi+CRC),
      raw wrap-around Viterbi, TTI chain — at bench shapes.
  micro   [--channels C] [--steps S]
      Pass-C micro: slot-0 segment gather, CFO rotation, ring recurrence,
      capture chain.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ltetrigger_jax.models import trigger as trig  # noqa: E402

R = trig.R


def fence(x):
    leaves = jax.tree_util.tree_leaves(x)
    return float(sum(jnp.sum(a.astype(jnp.float32)) for a in leaves[:1]))


def timeit(fn, *args, iters=3):
    out = fn(*args)
    _ = fence(out)
    best = float("inf")
    for _i in range(iters):
        t0 = time.perf_counter()
        _ = fence(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def emit(**kw):
    print(json.dumps(kw), flush=True)


def _buffer(channels, seconds=0.55):
    from bench_sweep import make_buffer
    buf = make_buffer(channels, seconds)
    jax.block_until_ready(buf)
    return buf


def _states(channels):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (channels,) + x.shape),
        trig.init_state())


def alive(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return sum(jnp.sum(x.astype(jnp.float32)) for x in leaves)


# ---------------------------------------------------------------- passes --
def cmd_passes(args):
    C, S = args.channels, args.steps
    buf = _buffer(C)
    sts = _states(C)
    g = trig._pick_group(S, C)
    emit(config={"channels": C, "steps": S, "group": g,
                 "group_budget": trig.GROUP_BUDGET})

    @jax.jit
    def pass_a(buffers):
        n_groups = S // g

        def body(acc, gi):
            lo = jnp.int32(trig.LOOKBACK) + gi * (g * trig.HALF_FRAME_LENGTH)
            p = trig._group_power(buffers, lo, g)
            return acc + jnp.sum(p), None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0),
                              jnp.arange(n_groups, dtype=jnp.int32))
        return acc

    @jax.jit
    def ab(buffers, states):
        finals, raws = trig.scan_pass(buffers, states, S, jnp.float32(4.0),
                                      grid0_static=trig.LOOKBACK)
        return alive((finals, raws))

    def full_fn(decode):
        @jax.jit
        def full(buffers, states):
            f, raw = trig.scan_pass(buffers, states, S, jnp.float32(4.0),
                                    grid0_static=trig.LOOKBACK)
            finals, outs = trig._mib_postpass(
                sts, f, raw, buffers, do_decode=jnp.asarray(decode))
            return alive((finals, outs))
        return full

    rows = []
    for name, fn, a in [("pass_A_only", pass_a, (buf,)),
                        ("passes_AB", ab, (buf, sts)),
                        ("ABC_nodecode", full_fn(False), (buf, sts)),
                        ("ABC_decode", full_fn(True), (buf, sts))]:
        t = timeit(fn, *a)
        rows.append((name, t))
        emit(variant=name, ms_per_dispatch=round(t * 1e3, 1),
             ms_per_step=round(t * 1e3 / S, 3),
             msps=round(C * S * trig.HALF_FRAME_LENGTH / t / 1e6, 1))
    return rows


def cmd_sweep(args):
    for c in args.channel_list:
        args.channels = c
        cmd_passes(args)


def cmd_groups(args):
    here = os.path.abspath(__file__)
    for b in args.budgets:
        env = dict(os.environ, LTETRIGGER_GROUP_BUDGET=str(b))
        emit(group_budget=b)
        subprocess.run([sys.executable, here, "passes",
                        "--channels", str(args.channels),
                        "--steps", str(args.steps)], env=env, check=False)


# ---------------------------------------------------------------- decode --
def cmd_decode(args):
    from ltetrigger_jax.ops import pbch
    from ltetrigger_jax.ops.viterbi import viterbi_decode_wa

    C, K = args.channels, trig.K_CANDIDATES
    rng = np.random.default_rng(0)

    slot1 = (jnp.asarray(rng.normal(size=(C * K * R, 960)).astype(np.float32)),
             jnp.asarray(rng.normal(size=(C * K * R, 960)).astype(np.float32)))
    cells = jnp.asarray(rng.integers(0, 504, size=(C * K * R,)), jnp.int32)

    @jax.jit
    def front(s, c):
        return jax.vmap(pbch.quarter_llrs_both_cp)(s, c)

    emit(stage="pbch_front_both_cp", batch=C * K * R,
         ms=round(timeit(front, slot1, cells) * 1e3, 1))

    llrs = jnp.asarray(rng.normal(size=(C * K * R, 12, 120))
                       .astype(np.float32))
    qof = jnp.tile(jnp.arange(12, dtype=jnp.int32) % 4, (C * K * R, 1))

    @jax.jit
    def search(l, q):
        return jax.vmap(pbch.search_and_unpack)(l, q)

    emit(stage="search_and_unpack", batch=C * K * R,
         ms=round(timeit(search, llrs, qof) * 1e3, 1))

    r = jnp.asarray(rng.normal(size=(C * K * R * 12, 40, 3))
                    .astype(np.float32))

    @jax.jit
    def vit(x):
        return viterbi_decode_wa(x)

    emit(stage="viterbi_wa", batch=C * K * R * 12,
         ms=round(timeit(vit, r) * 1e3, 1))


# ----------------------------------------------------------------- micro --
def cmd_micro(args):
    from ltetrigger_jax.ops import cfo as cfo_ops

    C, S = args.channels, args.steps
    rng = np.random.default_rng(0)
    n = 1_100_000
    buf = (jnp.asarray(rng.normal(size=(C, n)).astype(np.float32)),
           jnp.asarray(rng.normal(size=(C, n)).astype(np.float32)))
    starts = jnp.asarray(
        rng.integers(0, n - 2000, size=(S, C, R)).astype(np.int32))
    jax.block_until_ready(buf)

    @jax.jit
    def gather(b, st):
        return trig._gather_steps(b, st, trig.SEG)

    emit(op="gather_seg", ms=round(timeit(gather, buf, starts) * 1e3, 1))

    # the three slot-0 extraction strategies at the ENGINE's real geometry
    # (clustered per-step starts, not the uniform-random ones above)
    n_eng = trig.LOOKBACK + S * 9600 + trig.WINDOW
    ebuf = (jnp.asarray(rng.normal(size=(C, n_eng)).astype(np.float32)),
            jnp.asarray(rng.normal(size=(C, n_eng)).astype(np.float32)))
    peak = jnp.asarray(rng.integers(0, 9600, size=(S, C, R)), jnp.int32)
    grid = trig.LOOKBACK + 9600 * jnp.arange(S, dtype=jnp.int32)
    est = grid.reshape(S, 1, 1) + peak - trig.LOOKBACK + trig.SEG_OFF
    jax.block_until_ready(ebuf)

    @jax.jit
    def eg(b, st):
        return trig._gather_steps(b, st, trig.SEG)

    @jax.jit
    def etaa(b, st):
        return trig._extract_segs_taa(b, st)

    @jax.jit
    def edense(b, pk):
        return trig._extract_segs_dense(b, jnp.int32(trig.LOOKBACK), S, pk)

    emit(op="extract_gather", ms=round(timeit(eg, ebuf, est) * 1e3, 1))
    emit(op="extract_taa", ms=round(timeit(etaa, ebuf, est) * 1e3, 1))
    emit(op="extract_dense", ms=round(timeit(edense, ebuf, peak) * 1e3, 1))

    seg = (jnp.asarray(rng.normal(size=(S, C, R, trig.SEG))
                       .astype(np.float32)),
           jnp.asarray(rng.normal(size=(S, C, R, trig.SEG))
                       .astype(np.float32)))
    freq = jnp.asarray(rng.normal(size=(S, C, R)).astype(np.float32) * 0.01)

    @jax.jit
    def rot(s, f):
        return cfo_ops.cfo_rotate(s, f, trig.SEG_OFF)

    emit(op="cfo_rotate", ms=round(timeit(rot, seg, freq) * 1e3, 1))

    est = jnp.asarray(rng.normal(size=(S, C, R)).astype(np.float32))
    push = jnp.asarray(rng.random((S, C, R)) < 0.5)
    lost = jnp.asarray(rng.random((S, C, R)) < 0.05)
    ring0 = jnp.zeros((C, R, 200), jnp.float32)
    cnt0 = jnp.zeros((C, R), jnp.int32)

    @jax.jit
    def rings(r0, c0, e, p, l):
        return trig._ring_series(r0, c0, e, p, l)

    emit(op="ring_series",
         ms=round(timeit(rings, ring0, cnt0, est, push, lost) * 1e3, 1))


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("passes", "sweep", "groups", "decode", "micro"):
        p = sub.add_parser(name)
        p.add_argument("--channels", type=int, default=128)
        p.add_argument("--steps", type=int, default=100)
        if name == "sweep":
            p.add_argument("--channel-list", type=lambda s: [
                int(x) for x in s.split(",")], default=[128, 512, 1024])
        if name == "groups":
            p.add_argument("--budgets", type=lambda s: [
                int(x) for x in s.split(",")],
                default=[2048, 4096, 8192, 16384])
    args = ap.parse_args()
    {"passes": cmd_passes, "sweep": cmd_sweep, "groups": cmd_groups,
     "decode": cmd_decode, "micro": cmd_micro}[args.cmd](args)


if __name__ == "__main__":
    main()
