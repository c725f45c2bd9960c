"""WidebandTrigger: N carriers monitored live from ONE wideband stream.

`MultiTrigger` needs N separate 1.92 Msps feeds — N SDRs, and N streams of
host->device transport (8 real-time i16 streams need 61 MB/s).  A
wideband SDR gives the
same carriers as ONE pipe: this class accepts the wide stream (integer
multiple of 1.92 Msps), uploads each segment ONCE, and channelizes ON
DEVICE — frequency shift to every center, anti-alias decimate — directly
into the multi-stream mirror that feeds the batched trigger engine.  The
host-side narrow streams never exist.

Transport economics vs N narrow streams at the same byte budget: the wide
stream quantization noise is spread over the whole band, and the
channelizer keeps only 1/ratio of it per carrier — a 10*log10(ratio) dB
processing gain (+9 dB at ratio 8, +12 dB at 16).  A wide i8 upload
(2 bytes/sample) therefore lands ~45 dB effective per-channel SNR at
ratio 8 — between narrow i16 (~84 dB) and narrow i8 (~36 dB) — and wide
i4 (1 byte/sample) ~23 dB, still ~33 dB above the detection knee.  Eight
carriers ride a 15.36 Msps pipe: 15.4 MB/s at i4, 31 MB/s at i8.

Streaming correctness details:
  * the mixer phase is the same mod-1 f64 host-table decomposition as
    ops/channelize.py, evaluated at ABSOLUTE wide-stream indices (tracked
    across coordinate rebases), so every channel's oscillator is
    phase-continuous for the life of the stream;
  * each upload carries one 9600-sample context block per side so the
    decimator's transients never land in the mirror — segment boundaries
    are invisible to the detector (tested against the one-shot
    channelizer);
  * everything downstream — shared-consumption grid schedule, per-stream
    events/telemetry/cellstores, integer-CFO probes (per-carrier, applied
    to the channelized rows), checkpoint/resume — is MultiTrigger,
    unchanged.

Reference capability being beaten: one carrier per process
(/root/reference/python/downlink_trigger_c.py:27-45; the rtlsdr demo
watches a single center, examples/rtlsdr_ltetrigger.grc).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ltecore.constants import SAMPLE_RATE
from ..ops import channelize as chan
from ..runtime.cellstore import Cell
from ..runtime.chunkbuf import ChunkBuffer
from . import trigger as trig
from .multi import MultiTrigger, _rot_segments

LOOKBACK = trig.LOOKBACK
BLOCK = chan.BLOCK                       # wide-side context + phase block


def _wb_write(dev_r, dev_i, seg, half_bins, seg_start, shift, write_off):
    sr, si = _rot_segments(seg[0], seg[1], half_bins, seg_start)

    def one(d, s):
        ext = jnp.concatenate([d, jnp.zeros_like(d)], axis=-1)
        d2 = jax.lax.dynamic_slice_in_dim(ext, shift, d.shape[-1], -1)
        return jax.lax.dynamic_update_slice_in_dim(d2, s, write_off, -1)

    return one(dev_r, sr), one(dev_i, si)


@functools.partial(jax.jit, static_argnames=("ratio", "n_chunks",
                                             "chunk_blocks"))
def _wb_advance(dev_r, dev_i, up_r, up_i, scale, origins, ramps, shift,
                write_off, half_bins, seg_start, ratio: int, n_chunks: int,
                chunk_blocks: int):
    """Dequantize one wide segment, channelize it to [C] narrow lanes
    (ops/channelize._channelize_scan — the bench-proven fused mixer +
    decimator), apply per-stream integer-CFO rotation, write the mirror."""
    xpad = (up_r.astype(jnp.float32) * scale,
            up_i.astype(jnp.float32) * scale)
    seg = chan._channelize_scan(xpad, origins, ramps, ratio, n_chunks,
                                chunk_blocks)
    return _wb_write(dev_r, dev_i, seg, half_bins, seg_start, shift,
                     write_off)


@functools.partial(jax.jit, static_argnames=("ratio", "n_chunks",
                                             "chunk_blocks"))
def _wb_advance_i4(dev_r, dev_i, up, scale, origins, ramps, shift,
                   write_off, half_bins, seg_start, ratio: int,
                   n_chunks: int, chunk_blocks: int):
    re = ((up >> 4).astype(jnp.float32) - 8.0) * scale
    im = ((up & 0xF).astype(jnp.float32) - 8.0) * scale
    seg = chan._channelize_scan((re, im), origins, ramps, ratio, n_chunks,
                                chunk_blocks)
    return _wb_write(dev_r, dev_i, seg, half_bins, seg_start, shift,
                     write_off)


class WidebandTrigger(MultiTrigger):
    """MultiTrigger fed by ONE wideband stream (see module docstring).

    sample_rate: wide input rate, an integer multiple of 1.92 MHz.
    center_offsets_hz: carrier centers relative to the capture center; one
    monitored stream each (stream i of events/telemetry/cellstores is
    centers[i]).

    Feed with process_wide(samples) — complex64 at `sample_rate`.  All
    other MultiTrigger surface (flush, stores, telemetry, checkpoints,
    cfo_search_range, transports incl. packed i4) is inherited; the
    per-stream feeding methods are disabled (one pipe feeds everyone, so
    shared consumption never stalls and fill_gap is just zeros into the
    wide stream)."""

    def __init__(self, sample_rate: float,
                 center_offsets_hz: Sequence[float],
                 transport: str = "i8", **kwargs):
        ratio = sample_rate / SAMPLE_RATE
        if abs(ratio - round(ratio)) > 1e-9:
            raise ValueError(
                "sample_rate must be an integer multiple of 1.92 MHz")
        self.ratio = int(round(ratio))
        self.sample_rate = float(sample_rate)
        self.centers = [float(c) for c in center_offsets_hz]
        nyq = sample_rate / 2
        for c in self.centers:
            if abs(c) + SAMPLE_RATE / 2 > nyq + 1e-6:
                raise ValueError(f"center {c/1e6:.2f} MHz exceeds the "
                                 f"{sample_rate/1e6:.2f} MHz band")
        super().__init__(len(self.centers), transport=transport, **kwargs)

        # wide-side chunking: chunk_blocks must divide the blocks of one
        # narrow upload quantum (8 half-frames -> 8*ratio wide blocks)
        blocks_per_quantum = (self._quantum * self.ratio) // BLOCK
        self._chunk_blocks = next(
            d for d in range(min(32, blocks_per_quantum), 0, -1)
            if blocks_per_quantum % d == 0)

        self._offs_norm = np.asarray(self.centers,
                                     dtype=np.float64) / self.sample_rate
        self._ramps = jnp.asarray(np.mod(
            -self._offs_norm[:, None]
            * np.arange(BLOCK, dtype=np.float64)[None, :], 1.0)
            .astype(np.float32))
        if self._sharding is not None:
            self._ramps = jax.device_put(self._ramps, self._sharding)
        # wide host buffer; wide coord = narrow stream coord * ratio.
        # Starts with the LOOKBACK zeros' worth of wide samples plus one
        # decimator context block.
        self._wbuf = ChunkBuffer(
            np.zeros(LOOKBACK * self.ratio + BLOCK, dtype=np.complex64))
        self._wbase = -LOOKBACK * self.ratio - BLOCK
        # rebase-immune offset: wide index + _wabs = absolute sample count
        # since construction (mixer phase must NOT jump at a rebase)
        self._wabs = 0

    # ---- feeding ---------------------------------------------------------
    def process_wide(self, samples: np.ndarray) -> list[tuple[int, Cell]]:
        """Feed a chunk of the wide stream (complex64 at sample_rate);
        returns (stream, Cell) events that drained during the call."""
        import time
        self._wbuf.append(samples)
        end = self._fed_min()
        t = time.time()
        for q in self._anchors:
            q.append((end, t))
        published: list[tuple[int, Cell]] = []
        self._maybe_rebase()
        self._pump(published, flush_mode=(self.pipeline == 0))
        return published

    def fill_gap_wide(self, n_wide_samples: int) -> list[tuple[int, Cell]]:
        """Declare dropped WIDE samples (SDR overflow): zeros enter the
        band, every channel sees silence there."""
        return self.process_wide(np.zeros(n_wide_samples, np.complex64))

    def process(self, stream, samples):
        raise TypeError("WidebandTrigger is fed through process_wide(); "
                        "per-stream feeding belongs to MultiTrigger")

    process_all = process
    fill_gap = process

    # ---- driver hooks ----------------------------------------------------
    def _fed_min(self) -> int:
        # producing narrow sample b-1 needs wide data through b*ratio+BLOCK
        return (self._wbase + len(self._wbuf) - BLOCK) // self.ratio

    @property
    def backlog(self):
        return np.full(self.n, self._fed_min(), dtype=np.int64) \
            - self._pos_lb.min(axis=1)

    def _trim_front(self, keep_from: int) -> None:
        self._base += keep_from
        keep_w = self._base * self.ratio - BLOCK
        drop = keep_w - self._wbase
        if drop > 0:
            self._wbuf.drop_front(drop)
            self._wbase = keep_w

    def _maybe_rebase(self) -> None:
        if self._base >= self.REBASE_AT:
            delta_w = self.REBASE_AT * self.ratio
            self._wbase -= delta_w
            self._wabs += delta_w
        super()._maybe_rebase()

    # ---- the wideband mirror advance ------------------------------------
    def _sync_device_window(self, hi: int) -> None:
        lo = int(self._pos_lb.min()) - LOOKBACK
        if self._dev is None or lo >= self._dev_base + self._dev_len:
            self._dev = (self._put(jnp.zeros((self.n, self._cap),
                                             jnp.float32)),
                         self._put(jnp.zeros((self.n, self._cap),
                                             jnp.float32)))
            self._dev_base = lo
            self._dev_len = 0
        shift = 0
        if hi - self._dev_base > self._cap - self._quantum:
            shift = lo - self._dev_base
        new_base = self._dev_base + shift
        assert hi - new_base <= self._cap - self._quantum, (
            f"stream mirror overflow: window [{lo}, {hi}) exceeds capacity "
            f"{self._cap}")
        have_end = self._dev_base + self._dev_len
        new = hi - have_end
        if new <= 0 and shift == 0:
            return
        if new > 0:
            a = have_end
            n_pad = -(-new // self._quantum) * self._quantum
            L = n_pad * self.ratio
            wlo = a * self.ratio - BLOCK
            assert wlo >= self._wbase, (wlo, self._wbase)
            whi = min(self._wbase + len(self._wbuf), wlo + L + 2 * BLOCK)
            seg = self._wbuf.view(wlo - self._wbase, whi - self._wbase)
            pad = (L + 2 * BLOCK) - seg.size
        else:
            # pure slide: write one zero quantum beyond the valid end
            a = hi
            n_pad = self._quantum
            L = n_pad * self.ratio
            wlo = a * self.ratio - BLOCK
            seg = np.empty(0, np.complex64)
            pad = L + 2 * BLOCK
            have_end = hi
        q = self._quantize(seg, pad)              # wide-segment quantization
        up_r, up_i, scale = q
        n_chunks = L // (self._chunk_blocks * BLOCK)
        nb = self._chunk_blocks + 2
        chunk_w = self._chunk_blocks * BLOCK
        # origins [n_chunks, C, nb] stay replicated (the mesh `ch` sharding
        # partitions leading [N] axes; these lead with the chunk axis)
        origins = jnp.asarray(np.stack(
            [chan._phase_tables(self._offs_norm,
                                self._wabs + wlo + k * chunk_w, nb)
             for k in range(n_chunks)]))
        bins = self._put(jnp.asarray(self._cfo_bins))
        args = (jnp.int32(shift), jnp.int32(have_end - new_base),
                bins, jnp.int32(a))
        if self.transport == "i4":
            self._dev = _wb_advance_i4(
                self._dev[0], self._dev[1], jnp.asarray(up_r),
                jnp.float32(scale), origins, self._ramps, *args,
                ratio=self.ratio, n_chunks=n_chunks,
                chunk_blocks=self._chunk_blocks)
        else:
            self._dev = _wb_advance(
                self._dev[0], self._dev[1], jnp.asarray(up_r),
                jnp.asarray(up_i), jnp.float32(scale), origins, self._ramps,
                *args, ratio=self.ratio, n_chunks=n_chunks,
                chunk_blocks=self._chunk_blocks)
        self._dev_base = new_base
        self._dev_len = hi - new_base

    # ---- checkpoint ------------------------------------------------------
    def save_state(self, path: str) -> None:
        self.flush()
        fields = {f"state_{k}": np.asarray(v)
                  for k, v in self._state._asdict().items()}
        np.savez(path, n=self.n, base=self._base,
                 psr_threshold=self.psr_threshold,
                 cfo_bins=self._cfo_bins,
                 wide=self._wbuf.to_array(), wbase=self._wbase,
                 wabs=self._wabs, sample_rate=self.sample_rate,
                 centers=np.asarray(self.centers), **fields)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        assert float(data["sample_rate"]) == self.sample_rate
        assert np.allclose(np.asarray(data["centers"]),
                           np.asarray(self.centers)), "center plan mismatch"
        kw = {k[len("state_"):]: jnp.asarray(data[k])
              for k in data.files if k.startswith("state_")}
        self._state = trig.TriggerState(**kw)
        if self._sharding is not None:
            self._state = jax.device_put(self._state, self._sharding)
        self._pos_lb = np.asarray(data["state_pos"]).astype(np.int64)
        self._outstanding.clear()
        self._disp_steps = 0
        for q in self._anchors:
            q.clear()
        self._dev = None
        self._dev_len = 0
        self._wbuf = ChunkBuffer(data["wide"])
        self._wbase = int(data["wbase"])
        self._wabs = int(data["wabs"])
        self._base = int(data["base"])
        self.psr_threshold = float(data["psr_threshold"])
        self._cfo_bins = np.asarray(data["cfo_bins"]).astype(np.int32)
        st = self._state
        self._any_tracking = np.asarray(st.tracking).any(axis=-1)
        self._max_score = np.asarray(st.score).max(axis=-1).astype(np.int64)
