"""Receiver session: wires a sample source (radio / file / generator) to the
device pipeline, the spectrum display path, the rate-locked audio queue, and
the metrics registry.

Reference analogue: MainWindow's orchestration (gui/mainwindow.cpp) — create
the interface, wire signals, 200 ms status timer with keepalive every 5
ticks, run/stop logic, live parameter plumbing — minus the Qt widgets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

import jax

from cutesdr_tpu.io.audio_sink import RateLockedQueue
from cutesdr_tpu.metrics import StreamMetrics
from cutesdr_tpu.pipeline.receiver import Receiver, ReceiverConfig
from cutesdr_tpu.pipeline.spectrum import SpectrumAnalyzer, SpectrumConfig
from cutesdr_tpu.settings import SessionSettings


def _start_host_copy(leaf) -> None:
    """Begin an async device->host copy of one output leaf (no-op for
    non-device values); np.asarray later completes against the staged copy
    instead of issuing a fresh synchronous round trip."""
    start = getattr(leaf, "copy_to_host_async", None)
    if start is not None:
        try:
            start()
        except Exception:
            pass               # backend without async copies: finish() syncs


class _IngestWorker:
    """Double-buffered host→device uploader: a dedicated thread
    device_puts the next block's planes while the main thread dispatches
    compute on the previous one — the reference's FIFO-decoupled
    UDP→DSP thread handoff (interface/netiobase.cpp:571-600) applied to
    the H2D copy.  Bounded input queue gives natural backpressure."""

    def __init__(self, depth: int = 2):
        import queue
        import threading
        self._in: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._out: "queue.Queue" = queue.Queue()
        self.pending = 0               # submitted, not yet polled out
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="cutesdr-ingest")
        self._t.start()

    def _run(self):
        import jax
        while True:
            item = self._in.get()
            if item is None:
                return
            re, im = item
            try:
                self._out.put((jax.device_put(re), jax.device_put(im)))
            except Exception as e:      # surface upload failures to poll()
                self._out.put(e)

    def submit(self, re, im) -> None:
        self.pending += 1
        self._in.put((re, im))

    def poll(self, block: bool = False):
        """Next uploaded (re, im) device pair, or None if none ready."""
        import queue
        if self.pending == 0:
            return None
        try:
            item = self._out.get(block=block)
        except queue.Empty:
            return None
        self.pending -= 1
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._in.put(None)


@dataclass
class ReceiverSession:
    """Pull-based session: call ``pump()`` with raw IQ blocks (any size);
    it re-blocks to the pipeline's block size, runs the receiver and the
    display FFT, pushes audio into the rate-locked queue, and keeps metrics.

    The audio consumer (sound card thread / WAV writer) calls
    ``audio_queue.get(n)``; its queue-depth P controller feeds back into the
    on-device resampler ratio once per second, closing the reference's
    clock-tracking loop (interface/soundout.cpp:456-468) around the device.
    """
    cfg: ReceiverConfig
    spectrum_cfg: Optional[SpectrumConfig] = None
    settings: SessionSettings = field(default_factory=SessionSettings)
    on_spectrum: Optional[Callable[[np.ndarray], None]] = None
    # dispatch pipelining: with depth D the session keeps up to D-1 steps
    # in flight and materializes (device->host) one step behind, so the
    # host decodes/transfers block k+1 while the device computes block k —
    # the reference's FIFO-decoupled thread handoff
    # (interface/netiobase.cpp:571-600) via XLA's async dispatch.  depth=1
    # is fully synchronous (materialize every step immediately).
    pipeline_depth: int = 2
    # program-cache bound: a long-running serve walking many configs would
    # otherwise accumulate compiled programs + device state without limit;
    # least-recently-used Receivers beyond this are dropped (their stream
    # state migrates forward on every switch, so eviction only costs a
    # recompile on revisit).
    max_cached_programs: int = 12

    def __post_init__(self):
        import threading
        from collections import OrderedDict
        # serializes the pump loop against structural switches arriving
        # from other threads (serve's HTTP handlers: /mode, /probe) — the
        # reference's reconfigure-vs-process mutexes
        # (dsp/demodulator.cpp:109/166), one lock at session level
        self._lock = threading.RLock()
        self.receiver = Receiver(self.cfg)
        self.receiver.set_volume(self.settings.volume)
        # bucketed LRU program cache: one Receiver (compiled step + stream
        # state donor) per static configuration seen, so mode walks are
        # compile-free after the first visit (the reference's equivalent is
        # the per-mode demod objects it can rebuild under mutex,
        # dsp/demodulator.cpp:107-157)
        self._receivers: "OrderedDict" = OrderedDict(
            {self._cfg_key(self.cfg): self.receiver})
        if self.spectrum_cfg is None:
            self.spectrum_cfg = SpectrumConfig(
                fft_size=self.settings.display.fft_size,
                ave_size=self.settings.display.fft_ave,
                sample_rate=self.cfg.input_rate)
        self.analyzer = SpectrumAnalyzer(
            self.spectrum_cfg,
            max_display_rate=self.settings.display.max_display_rate)
        self.audio_queue = RateLockedQueue(stereo=self.cfg.stereo)
        self.metrics = StreamMetrics()
        self._pending = np.zeros(0, np.complex64)
        self._pending_re = np.zeros(0, np.float32)   # plane-path re-block
        self._pending_im = np.zeros(0, np.float32)
        self._ingest: Optional[_IngestWorker] = None  # created on first
                                                      # pump_planes
        self._inflight: list = []      # dispatched, not yet materialized
        self._nominal_ratio = (self.cfg.output_rate /
                               (self.cfg.audio_rate or self.cfg.output_rate))
        self._last_correction = 0.0
        self.current_tune = self.cfg.tune_freq
        self.current_low, self.current_hi = self.cfg.low_cut, self.cfg.hi_cut
        # probe-tap instrument (the testbench scope, set_probe below)
        self._probe_tap: Optional[str] = None
        self._probe_view = "spectrum"
        self._probe_inst = None
        self.running = False

    def start(self) -> None:
        self.running = True
        self.metrics = StreamMetrics()

    def stop(self) -> None:
        self.flush()
        self.running = False

    # ------------------------------------------------------------- data ---
    def _finish(self, out, bs: int) -> None:
        """Materialize one dispatched step (device->host) and deliver it.
        (samples_in/blocks were counted at dispatch; here the delivered
        half: audio, meters, queue accounting.)"""
        if self._probe_tap is not None and out.probes is not None:
            self._feed_probe(out.probes.get(self._probe_tap))
        if out.probes is not None and "pll_tier" in out.probes:
            tier = int(np.asarray(out.probes["pll_tier"]))
            if 0 <= tier <= 2:
                self.metrics.pll_tier_blocks[tier] += 1
        n_aud = int(out.n_audio)
        audio = np.asarray(out.audio)[:n_aud]
        self.audio_queue.put_block(
            np.clip(audio, -32767, 32767).astype(np.int16))
        self.metrics.audio_samples_out += n_aud
        self.metrics.smeter_ave_db = float(out.smeter_ave_db)
        self.metrics.smeter_peak_db = float(out.smeter_peak_db)
        self.metrics.audio_overflows = self.audio_queue.overflows
        self.metrics.audio_underflows = self.audio_queue.underflows

    def flush(self) -> int:
        """Drain in-flight uploads and steps (call before reading final
        state)."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if self._ingest is not None:
            while self._ingest.pending:
                self._dispatch_uploaded(self._ingest.poll(block=True))
        n = len(self._inflight)
        for out, bs in self._inflight:
            self._finish(out, bs)
        self._inflight.clear()
        return n

    def pump(self, iq: np.ndarray) -> int:
        """Feed raw IQ samples; returns number of pipeline blocks run.

        With pipeline_depth > 1 the newest steps stay in flight (XLA async
        dispatch) and each call delivers the steps that are at least one
        behind — the device computes block k while the host decodes and
        uploads k+1."""
        if not self.running:
            return 0
        with self._lock:
            return self._pump_locked(iq)

    def _pump_locked(self, iq) -> int:
        buf = np.concatenate([self._pending, np.asarray(iq, np.complex64)])
        bs = self.cfg.block_size
        blocks = 0
        while len(buf) >= bs:
            chunk, buf = buf[:bs], buf[bs:]
            # display path uses the raw (pre-mix) stream
            if self.analyzer.feed(chunk) and self.on_spectrum:
                self.on_spectrum(self.analyzer.spectrum_db())
            self.metrics.overload = self.analyzer.overload

            # host-plane path: float32 re/im planes up, float stacks down
            # (stereo audio arrives as [cap, 2])
            out = self.receiver.process_host(chunk)
            self.metrics.samples_in += bs
            self.metrics.blocks += 1
            # kick off the device->host copies NOW so they overlap the next
            # block's upload + compute; _finish's np.asarray then finds the
            # host copy already staged (same trick as double-buffered D2H)
            jax.tree_util.tree_map(_start_host_copy, out)
            self._inflight.append((out, bs))
            while len(self._inflight) >= max(1, self.pipeline_depth):
                done, dbs = self._inflight.pop(0)
                self._finish(done, dbs)
            blocks += 1
        self._pending = buf

        # close the rate-lock loop when the consumer's correction changes
        corr = self.audio_queue.rate_correction
        if corr != self._last_correction and self.cfg.audio_rate:
            self._last_correction = corr
            self.metrics.ppm_error = self.audio_queue.ppm_error
            self.receiver.set_resample_ratio(
                self._nominal_ratio * (1.0 + corr))
        return blocks

    def _dispatch_uploaded(self, item) -> None:
        """Run the receiver step on an already-uploaded plane pair and
        enter it into the in-flight pipeline."""
        if item is None:
            return
        re_d, im_d = item
        out = self.receiver.process_planes(re_d, im_d)
        self.metrics.samples_in += self.cfg.block_size
        self.metrics.blocks += 1
        jax.tree_util.tree_map(_start_host_copy, out)
        self._inflight.append((out, self.cfg.block_size))
        while len(self._inflight) >= max(1, self.pipeline_depth):
            done, dbs = self._inflight.pop(0)
            self._finish(done, dbs)

    def pump_planes(self, re, im) -> int:
        """High-rate ingest: feed separate re/im planes — int16 straight
        off the radio's 16-bit wire format (half the H2D bytes; cast to
        f32 on device) or float32.  Uploads run on a dedicated ingest
        thread double-buffered against dispatch, so the host decodes and
        uploads block k+1 while the device computes block k; the display
        FFT is fed at the throttle's sample granularity without copying
        skipped samples.  Complex never crosses the host↔device boundary.

        This is the production path for the 20 MSPS configuration; the
        complex-input pump() remains for convenience at radio-native
        rates."""
        if not self.running:
            return 0
        with self._lock:
            return self._pump_planes_locked(re, im)

    def _pump_planes_locked(self, re, im) -> int:
        if self._ingest is None:
            self._ingest = _IngestWorker(depth=max(1, self.pipeline_depth))
        re = np.asarray(re)
        im = np.asarray(im)
        if not len(self._pending_re):
            self._pending_re = self._pending_re.astype(re.dtype)
            self._pending_im = self._pending_im.astype(im.dtype)
        elif self._pending_re.dtype != re.dtype:
            # mid-stream wire-dtype change with a partial block pending:
            # promote BOTH sides to float32 — casting pending f32 down to
            # int16 would silently truncate/wrap out-of-range values
            self._pending_re = self._pending_re.astype(np.float32)
            self._pending_im = self._pending_im.astype(np.float32)
            re = re.astype(np.float32)
            im = im.astype(np.float32)
        buf_re = np.concatenate([self._pending_re, re])
        buf_im = np.concatenate([self._pending_im, im])
        if buf_re.dtype not in (np.int16, np.float32):
            # mixed-dtype feeds promote (i16+f32 -> f64); keep the device
            # contract to the two supported wire dtypes
            buf_re = buf_re.astype(np.float32)
            buf_im = buf_im.astype(np.float32)
        bs = self.cfg.block_size
        blocks = 0
        while len(buf_re) >= bs:
            rb, buf_re = buf_re[:bs], buf_re[bs:]
            ib, buf_im = buf_im[:bs], buf_im[bs:]
            if self.analyzer.feed_planes(rb, ib) and self.on_spectrum:
                self.on_spectrum(self.analyzer.spectrum_db())
            self.metrics.overload = self.analyzer.overload
            self._ingest.submit(rb, ib)
            self._dispatch_uploaded(self._ingest.poll())
            blocks += 1
        self._pending_re, self._pending_im = buf_re, buf_im
        # opportunistically drain any uploads that completed meanwhile
        while True:
            item = self._ingest.poll()
            if item is None:
                break
            self._dispatch_uploaded(item)

        corr = self.audio_queue.rate_correction
        if corr != self._last_correction and self.cfg.audio_rate:
            self._last_correction = corr
            self.metrics.ppm_error = self.audio_queue.ppm_error
            self.receiver.set_resample_ratio(
                self._nominal_ratio * (1.0 + corr))
        return blocks

    # ----------------------------------------------- mode / rate switches --
    @staticmethod
    def _cfg_key(cfg: ReceiverConfig):
        from dataclasses import astuple
        return astuple(cfg)

    def _touch(self, key) -> None:
        """Mark a cached program most-recently-used and evict beyond the
        bound (never the just-touched program or the active receiver)."""
        self._receivers.move_to_end(key)
        keep = {key, self._cfg_key(self.cfg)}
        while len(self._receivers) > max(1, self.max_cached_programs):
            oldest = next((k for k in self._receivers if k not in keep), None)
            if oldest is None:
                break
            self._receivers.pop(oldest)

    def _switch_to(self, new_cfg: ReceiverConfig) -> None:
        """Swap the compiled program and migrate the stream state.

        Pending input samples are kept (re-blocked at the new block size),
        so nothing is dropped; carries migrate per
        pipeline.receiver.migrate_state — seamless like the reference's
        live SetDemod (dsp/demodulator.cpp:107-157)."""
        from cutesdr_tpu.pipeline.receiver import migrate_state
        self._lock.acquire()
        try:
            self._switch_to_locked(new_cfg, migrate_state)
        finally:
            self._lock.release()

    def _switch_to_locked(self, new_cfg: ReceiverConfig,
                          migrate_state) -> None:
        self.flush()                      # deliver in-flight steps first
        old_cfg, old_state = self.cfg, self.receiver.state
        key = self._cfg_key(new_cfg)
        nxt = self._receivers.get(key)
        if nxt is None:
            nxt = Receiver(new_cfg)
            self._receivers[key] = nxt
        self._touch(key)
        nxt.state = migrate_state(old_cfg, old_state, new_cfg, nxt.state)
        nxt.params = nxt.params._replace(
            audio_gain=self.receiver.params.audio_gain,
            dc_offset=self.receiver.params.dc_offset)
        self.receiver = nxt
        self.cfg = new_cfg
        # traced knobs of a cached program may have drifted (tune / filter /
        # AGC are params-level): re-pin them to the switch target.  The
        # user's current tune survives the switch.
        self.receiver.set_tune_freq(self.current_tune)
        self.receiver.set_filter(new_cfg.low_cut, new_cfg.hi_cut)
        self.receiver.set_agc()
        self.current_low, self.current_hi = new_cfg.low_cut, new_cfg.hi_cut
        self._nominal_ratio = (new_cfg.output_rate /
                               (new_cfg.audio_rate or new_cfg.output_rate))
        if self.cfg.audio_rate:
            self.receiver.set_resample_ratio(
                self._nominal_ratio * (1.0 + self._last_correction))

    def _prebuild(self, cfg: ReceiverConfig) -> None:
        """Compile a config's program WITHOUT holding the session lock, so
        the stream keeps flowing during a (possibly minutes-long remote)
        compile; the subsequent locked switch is then a cache hit.  Safe
        to race: duplicate builds just overwrite each other."""
        key = self._cfg_key(cfg)
        if key in self._receivers:
            return
        rx = Receiver(cfg)
        saved = rx.state
        rx.process_host(np.zeros(cfg.block_size, np.complex64))
        rx.state = saved
        with self._lock:                 # only the insert; not the compile
            self._receivers[key] = rx

    def set_mode(self, mode: str) -> None:
        """Live demod-mode change: applies the persisted per-mode settings
        (the m_DemodSettings[] array) and switches programs without
        dropping stream samples.  An uncached mode compiles OUTSIDE the
        session lock first (the stream keeps running), then switches as a
        cache hit; precompile() at startup makes even that wait go away."""
        from dataclasses import replace
        d = self.settings.demod[mode]
        new_cfg = replace(
            self.cfg, mode=mode, low_cut=d.low_cut, hi_cut=d.hi_cut,
            cw_offset=d.offset, squelch_ui=d.squelch_value,
            agc_on=d.agc_on, agc_hang=d.agc_hang_on,
            agc_thresh_db=d.agc_thresh, agc_manual_gain_db=d.agc_manual_gain,
            agc_slope=d.agc_slope, agc_decay_ms=d.agc_decay)
        self._prebuild(new_cfg)
        self._switch_to(new_cfg)
        self.settings.demod_mode = mode

    def set_input_rate(self, input_rate: float) -> None:
        """Live input-sample-rate change (the radio's bandwidth index
        switch): rebuilds the decimation plan, migrates state, keeps
        pending samples."""
        from dataclasses import replace
        self._switch_to(replace(self.cfg, input_rate=input_rate))

    def precompile(self, modes) -> None:
        """Warm the program cache for a set of modes (compile ahead so
        set_mode() is glitch-free on first use)."""
        from dataclasses import replace
        for mode in modes:
            d = self.settings.demod[mode]
            cfg = replace(
                self.cfg, mode=mode, low_cut=d.low_cut, hi_cut=d.hi_cut,
                cw_offset=d.offset, squelch_ui=d.squelch_value,
                agc_on=d.agc_on, agc_hang=d.agc_hang_on,
                agc_thresh_db=d.agc_thresh,
                agc_manual_gain_db=d.agc_manual_gain,
                agc_slope=d.agc_slope, agc_decay_ms=d.agc_decay)
            key = self._cfg_key(cfg)
            if key in self._receivers:
                continue
            rx = Receiver(cfg)
            self._receivers[key] = rx
            self._touch(key)
            # trace+compile the production planes path now (throwaway zero
            # block; state unchanged).
            saved = rx.state
            rx.process_host(np.zeros(cfg.block_size, np.complex64))
            rx.state = saved

    # ----------------------------------------------------- probe scope ----
    PROBE_TAPS = ("p1_downconvert", "p2_fastfir", "p3_agc", "p4_demod",
                  "p5_resampled", "p6_pll", "p7_blanker")

    def _tap_rate(self, key: str) -> float:
        c = self.cfg
        if key == "p7_blanker":
            return c.input_rate
        if key == "p5_resampled":
            return c.audio_rate or c.output_rate
        return c.output_rate

    def set_probe(self, tap: Optional[str], view: str = "spectrum",
                  trigger_mode: str = "free", trigger_level: float = 0.0,
                  length: int = 1024) -> Optional[str]:
        """Select a live probe tap for the serving UI — the testbench's
        probe scope (gui/testbench.cpp:583-898): any of the pipeline's
        named taps rendered as an averaged spectrum or a (level-triggered)
        time capture.  Enabling a tap switches to the probes-enabled
        compiled program glitch-free (stream state migrates); ``None``
        switches back.  Returns the applied tap (None = off).

        A first-time probes-program compile runs OUTSIDE the session lock
        (the stream keeps flowing); only the state migration holds it."""
        from dataclasses import replace
        want_probes = tap not in (None, "", "off")
        if want_probes != self.cfg.probes:
            self._prebuild(replace(self.cfg, probes=want_probes))
        with self._lock:
            return self._set_probe_locked(tap, view, trigger_mode,
                                          trigger_level, length)

    def _set_probe_locked(self, tap, view, trigger_mode, trigger_level,
                          length):
        from dataclasses import replace

        from cutesdr_tpu.testbench.probes import (ProbeSpectrum,
                                                  TriggeredCapture,
                                                  TriggerMode)
        short = {"p1": "p1_downconvert", "p2": "p2_fastfir", "p3": "p3_agc",
                 "p4": "p4_demod", "p5": "p5_resampled", "p6": "p6_pll",
                 "p7": "p7_blanker"}
        tap = short.get(tap, tap)
        if tap in (None, "", "off"):
            if self.cfg.probes:
                self._switch_to(replace(self.cfg, probes=False))
            self._probe_tap = self._probe_inst = None
            return None
        if tap not in self.PROBE_TAPS:
            raise ValueError(f"unknown probe tap {tap!r}")
        if tap == "p7_blanker" and not self.cfg.nb_on:
            raise ValueError("p7 requires the noise blanker (nb_on)")
        if tap == "p5_resampled" and self.cfg.audio_rate is None:
            raise ValueError("p5 requires the 48 kHz resampler (audio_rate)")
        if tap == "p6_pll" and (self.cfg.mode not in ("sam", "fm")
                                or self.cfg.stereo):
            raise ValueError("p6 requires a mono PLL mode (sam/fm)")
        if not self.cfg.probes:
            self._switch_to(replace(self.cfg, probes=True))
        self._probe_tap = tap
        self._probe_view = view
        if view == "scope":
            modes = {"free": TriggerMode.FREE_RUN,
                     "pos": TriggerMode.NORM_POS,
                     "neg": TriggerMode.NORM_NEG,
                     "single+": TriggerMode.SINGLE_POS,
                     "single-": TriggerMode.SINGLE_NEG}
            if trigger_mode not in modes:
                raise ValueError(f"unknown trigger mode {trigger_mode!r}")
            mode = modes[trigger_mode]
            self._probe_inst = TriggeredCapture(
                length=length, pre_samples=length // 4,
                level=trigger_level,
                hysteresis=max(1.0, abs(trigger_level) * 0.05), mode=mode)
        else:
            self._probe_inst = ProbeSpectrum(self._tap_rate(tap))
        return tap

    def _feed_probe(self, leaf) -> None:
        if leaf is None or self._probe_inst is None:
            return
        arr = np.asarray(leaf)
        if arr.ndim == 2 and arr.shape[-1] == 2:     # split complex leaf
            arr = arr[..., 0] + 1j * arr[..., 1]
        if self._probe_view == "scope":
            self._probe_inst.feed(np.real(arr))
        else:
            self._probe_inst.feed(arr)

    def probe_frame(self) -> Optional[dict]:
        """Latest probe display frame for the server (or None)."""
        with self._lock:
            return self._probe_frame_locked()

    def _probe_frame_locked(self) -> Optional[dict]:
        if self._probe_tap is None or self._probe_inst is None:
            return None
        base = {"tap": self._probe_tap, "view": self._probe_view,
                "sample_rate": self._tap_rate(self._probe_tap)}
        if self._probe_view == "scope":
            rec = self._probe_inst.record
            if rec is None:
                return {**base, "record": None}
            return {**base,
                    "record": [round(float(v), 2) for v in rec]}
        return {**base,
                "db": [round(float(v), 1)
                       for v in self._probe_inst.spectrum_db()]}

    # ---------------------------------------------------------- controls --
    def tune(self, freq_hz: float) -> None:
        self.receiver.set_tune_freq(freq_hz)
        self.current_tune = freq_hz

    def tune_clicked(self, freq_hz: float) -> float:
        """Click-to-tune with the mode's click resolution rounding
        (gui/plotter.cpp roundFreq with m_ClickResolution)."""
        res = max(1, int(self.settings.demod[self.cfg.mode]
                         .filter_click_resolution))
        rounded = round(freq_hz / res) * res
        self.tune(rounded)
        return rounded

    def set_filter(self, low_cut: float, hi_cut: float) -> tuple[float, float]:
        """Set the channel-filter edges, clamped to the mode's limit table
        and mirrored for symmetric modes (the GUI's enforcement in
        gui/mainwindow.cpp:1000-1054 / plotter edge drag).  Returns the
        edges actually applied."""
        from cutesdr_tpu.pipeline.receiver import MODE_LIMITS
        hi_min, hi_max, low_min, low_max, sym = MODE_LIMITS[self.cfg.mode]
        lo = float(min(max(low_cut, low_min), low_max))
        hi = float(min(max(hi_cut, hi_min), hi_max))
        if sym:
            m = max(hi, -lo)
            lo, hi = -m, m
        self.receiver.set_filter(lo, hi)
        self.current_low, self.current_hi = lo, hi
        return lo, hi

    def set_volume(self, vol: int) -> None:
        self.settings.volume = vol
        self.receiver.set_volume(vol)

    def status_line(self) -> str:
        return self.metrics.status_line()


@dataclass
class DiversitySession:
    """Dual-RX session: coherent [2, block_size] IQ stacks → MRC combine →
    one receiver chain → rate-locked audio + spectrum + metrics.

    The reference defines the dual-channel modes
    (interface/protocoldefs.h:143-152) but never demodulates channel 2;
    this is the live end of that capability (CLI/serve ``--dual``) — the
    display shows channel 1's raw spectrum, the audio is the combined
    (up to +3 dB SNR) stream, and ``gain`` exposes the tracked complex
    channel-balance estimate."""
    cfg: ReceiverConfig
    settings: SessionSettings = field(default_factory=SessionSettings)
    on_spectrum: Optional[Callable[[np.ndarray], None]] = None
    smoothing_blocks: float = 8.0

    def __post_init__(self):
        from cutesdr_tpu.shard.coherent import DiversityReceiver
        self.receiver = DiversityReceiver(self.cfg,
                                          self.smoothing_blocks)
        self.receiver.set_volume(self.settings.volume)
        self.analyzer = SpectrumAnalyzer(
            SpectrumConfig(fft_size=self.settings.display.fft_size,
                           ave_size=self.settings.display.fft_ave,
                           sample_rate=self.cfg.input_rate),
            max_display_rate=self.settings.display.max_display_rate)
        self.audio_queue = RateLockedQueue(stereo=self.cfg.stereo)
        self.metrics = StreamMetrics()
        self._pending = np.zeros((2, 0), np.complex64)
        self._nominal_ratio = (self.cfg.output_rate /
                               (self.cfg.audio_rate or self.cfg.output_rate))
        self._last_correction = 0.0
        self.current_tune = self.cfg.tune_freq
        self.current_low, self.current_hi = self.cfg.low_cut, self.cfg.hi_cut
        self.running = False

    def start(self) -> None:
        self.running = True
        self.metrics = StreamMetrics()

    def stop(self) -> None:
        self.running = False

    def flush(self) -> int:
        return 0                           # synchronous pump: nothing staged

    def pump(self, iq_stack) -> int:
        """Feed a [2, n] coherent complex stack (any n; re-blocked)."""
        if not self.running:
            return 0
        buf = np.concatenate(
            [self._pending, np.asarray(iq_stack, np.complex64)], axis=1)
        bs = self.cfg.block_size
        blocks = 0
        while buf.shape[1] >= bs:
            chunk, buf = buf[:, :bs], buf[:, bs:]
            if self.analyzer.feed(chunk[0]) and self.on_spectrum:
                self.on_spectrum(self.analyzer.spectrum_db())
            self.metrics.overload = self.analyzer.overload
            out = self.receiver.process_host(chunk)
            self.metrics.samples_in += bs
            self.metrics.blocks += 1
            n_aud = int(out.n_audio)
            audio = np.asarray(out.audio)[:n_aud]
            self.audio_queue.put_block(
                np.clip(audio, -32767, 32767).astype(np.int16))
            self.metrics.audio_samples_out += n_aud
            self.metrics.smeter_ave_db = float(out.smeter_ave_db)
            self.metrics.smeter_peak_db = float(out.smeter_peak_db)
            blocks += 1
        self._pending = buf

        corr = self.audio_queue.rate_correction
        if corr != self._last_correction and self.cfg.audio_rate:
            self._last_correction = corr
            self.metrics.ppm_error = self.audio_queue.ppm_error
            self.receiver.set_resample_ratio(
                self._nominal_ratio * (1.0 + corr))
        return blocks

    # ---------------------------------------------------------- controls --
    @property
    def gain(self) -> complex:
        return self.receiver.last_gain

    def tune(self, freq_hz: float) -> None:
        self.receiver.set_tune_freq(freq_hz)
        self.current_tune = freq_hz

    def tune_clicked(self, freq_hz: float) -> float:
        res = max(1, int(self.settings.demod[self.cfg.mode]
                         .filter_click_resolution))
        rounded = round(freq_hz / res) * res
        self.tune(rounded)
        return rounded

    def set_filter(self, low_cut: float, hi_cut: float) -> tuple[float, float]:
        from cutesdr_tpu.pipeline.receiver import MODE_LIMITS
        hi_min, hi_max, low_min, low_max, sym = MODE_LIMITS[self.cfg.mode]
        lo = float(min(max(low_cut, low_min), low_max))
        hi = float(min(max(hi_cut, hi_min), hi_max))
        if sym:
            m = max(hi, -lo)
            lo, hi = -m, m
        self.receiver.set_filter(lo, hi)
        self.current_low, self.current_hi = lo, hi
        return lo, hi

    def set_volume(self, vol: int) -> None:
        self.settings.volume = vol
        self.receiver.set_volume(vol)

    def status_line(self) -> str:
        g = self.gain
        return (self.metrics.status_line()
                + f" | rx2 gain {abs(g):.3f} ∠{np.degrees(np.angle(g)):.1f}°")
