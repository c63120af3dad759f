"""Channel-bank session: N demodulators over one wideband stream, with a
shared display path and a monitor channel feeding the audio queue.

Reference analogue: none — CuteSDR runs exactly one demod chain
(dsp/demodulator.cpp); the bank is the batched capability it unlocks
(BASELINE config 4: 64 channels from one stream).  The session mirrors
ReceiverSession's contract (``pump`` / controls / metrics) so the CLI and
the web UI drive either interchangeably.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import jax
import numpy as np

from cutesdr_tpu.io.audio_sink import RateLockedQueue
from cutesdr_tpu.session import _start_host_copy
from cutesdr_tpu.metrics import StreamMetrics
from cutesdr_tpu.pipeline.receiver import ReceiverConfig
from cutesdr_tpu.pipeline.spectrum import SpectrumAnalyzer, SpectrumConfig
from cutesdr_tpu.settings import SessionSettings
from cutesdr_tpu.shard.channels import ChannelBank

SPECTRA_BINS = 48               # per-channel mini-spectrum width (UI sparkline)


@dataclass
class BankSession:
    """Pull-based session over a ChannelBank.

    One wideband IQ stream in; per-channel S-meters out every block; the
    *monitor* channel's audio goes to the rate-locked queue (listening to
    all N at once is not a thing — the reference's operator listens to one
    channel; the bank demodulates all of them for metering/recording).
    """
    cfg: ReceiverConfig
    tune_freqs: Sequence[float]
    spectrum_cfg: Optional[SpectrumConfig] = None
    settings: SessionSettings = field(default_factory=SessionSettings)
    on_spectrum: Optional[Callable[[np.ndarray], None]] = None
    monitor: int = 0
    # dispatch pipelining: keep depth-1 steps in flight with device->host
    # copies staged async, like ReceiverSession (1 = synchronous)
    pipeline_depth: int = 2

    def __post_init__(self):
        self.tune_freqs = list(self.tune_freqs)
        self.bank = ChannelBank(self.cfg, self.tune_freqs)
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
        self.smeter_db = np.full(len(self.tune_freqs), -160.0, np.float32)
        self.smeter_peak_db = np.full(len(self.tune_freqs), -160.0, np.float32)
        # per-channel audio mini-spectra (dB, SPECTRA_BINS bins to ~6 kHz)
        self.channel_spectra = np.full((len(self.tune_freqs), SPECTRA_BINS),
                                       -120.0, np.float32)
        self._pending = np.zeros(0, np.complex64)
        self._inflight: list = []
        self._probe_tap: Optional[str] = None
        self._probe_view = "spectrum"
        self._probe_inst = None
        self.running = False
        # serve's HTTP handler threads call set_probe/select/tune while the
        # main loop is inside pump(); same RLock discipline as
        # ReceiverSession (session.py) — reconfiguration vs process pairs
        # are the reference's per-object QMutex hazard (dsp/demodulator.cpp)
        self._lock = threading.RLock()

    # ------------------------------------------------------------- data ---
    def start(self) -> None:
        self.running = True
        self.metrics = StreamMetrics()

    def stop(self) -> None:
        self.flush()
        self.running = False

    def _finish(self, out, bs: int) -> None:
        """Materialize one dispatched bank step (device->host) and deliver."""
        if self._probe_tap is not None and out.probes is not None:
            leaf = out.probes.get(self._probe_tap)
            if leaf is not None:
                arr = np.asarray(leaf)[self.monitor]   # leading channel axis
                if arr.ndim == 2 and arr.shape[-1] == 2:
                    arr = arr[..., 0] + 1j * arr[..., 1]
                if self._probe_view == "scope":
                    self._probe_inst.feed(np.real(arr))
                else:
                    self._probe_inst.feed(arr)
        self.smeter_db = np.asarray(out.smeter_ave_db)
        self.smeter_peak_db = np.asarray(out.smeter_peak_db)
        all_audio = np.asarray(out.audio)
        self._update_spectra(all_audio, np.asarray(out.n_audio))
        m = self.monitor
        n_aud = int(np.asarray(out.n_audio)[m])
        audio = all_audio[m, :n_aud]
        self.audio_queue.put_block(
            np.clip(audio, -32767, 32767).astype(np.int16))
        self.metrics.update_block(bs, n_aud,
                                  float(self.smeter_db[m]),
                                  float(self.smeter_peak_db[m]))

    def flush(self) -> int:
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        n = len(self._inflight)
        for out, bs in self._inflight:
            self._finish(out, bs)
        self._inflight.clear()
        return n

    def pump(self, iq: np.ndarray) -> int:
        """Feed raw wideband IQ; returns number of bank steps run."""
        with self._lock:
            return self._pump_locked(iq)

    def _pump_locked(self, iq: np.ndarray) -> int:
        if not self.running:
            return 0
        buf = np.concatenate([self._pending, np.asarray(iq, np.complex64)])
        bs = self.cfg.block_size
        blocks = 0
        while len(buf) >= bs:
            chunk, buf = buf[:bs], buf[bs:]
            if self.analyzer.feed(chunk) and self.on_spectrum:
                self.on_spectrum(self.analyzer.spectrum_db())
            self.metrics.overload = self.analyzer.overload

            # host-plane path: stereo audio arrives as [ch, cap, 2] float
            # stacks; complex64 never crosses the device boundary
            out = self.bank.process_host(chunk)
            jax.tree_util.tree_map(_start_host_copy, out)
            self._inflight.append((out, bs))
            while len(self._inflight) >= max(1, self.pipeline_depth):
                done, dbs = self._inflight.pop(0)
                self._finish(done, dbs)
            blocks += 1
        self._pending = buf
        return blocks

    # ---------------------------------------------------------- controls --
    @property
    def n_channels(self) -> int:
        return len(self.tune_freqs)

    def select(self, channel: int) -> int:
        """Make `channel` the monitor (audio) channel."""
        with self._lock:
            self.monitor = int(channel) % self.n_channels
            return self.monitor

    def tune_channel(self, channel: int, freq_hz: float) -> float:
        with self._lock:
            self.tune_freqs[channel] = float(freq_hz)
            self.bank.set_tune_freqs(self.tune_freqs)
            return float(freq_hz)

    def set_volume(self, vol: int) -> None:
        """Web-UI volume (0..99 -> -50..0 dB) for the monitor audio: the
        gain is a traced per-channel param, applied bank-wide (the queue
        carries only the monitor channel, so per-channel volumes would be
        indistinguishable anyway)."""
        from cutesdr_tpu.pipeline.receiver import volume_params
        with self._lock:
            self.settings.volume = int(vol)
            one = volume_params(
                jax.tree_util.tree_map(lambda a: a[0], self.bank.params),
                int(vol))
            n = self.n_channels
            self.bank.params = self.bank.params._replace(
                audio_gain=jax.numpy.broadcast_to(
                    one.audio_gain, (n,) + one.audio_gain.shape))

    def tune_clicked(self, freq_hz: float) -> float:
        """Click-to-tune applies to the monitor channel, with the mode's
        click-resolution rounding (gui/plotter.cpp roundFreq)."""
        res = max(1, int(self.settings.demod[self.cfg.mode]
                         .filter_click_resolution))
        rounded = round(freq_hz / res) * res
        return self.tune_channel(self.monitor, rounded)

    def _update_spectra(self, audio: np.ndarray, n_audio: np.ndarray) -> None:
        """Per-channel audio-band mini-spectrum (what the operator scans the
        bank with): SPECTRA_BINS log-power bins over 0..fs_audio/8."""
        n = int(n_audio.min())
        if n < 4 * SPECTRA_BINS:
            return
        a = audio[:, :n]
        if np.iscomplexobj(a):
            a = a.real
        w = np.hanning(n)
        spec = np.abs(np.fft.rfft(a * w, axis=-1)) ** 2
        # keep the bottom eighth of the band (voice) folded to SPECTRA_BINS
        k = max(1, (spec.shape[-1] // 8) // SPECTRA_BINS)
        spec = spec[:, :k * SPECTRA_BINS].reshape(len(a), SPECTRA_BINS, k)
        power = spec.max(axis=-1)
        ref = (32767.0 * w.sum() / 2.0) ** 2
        self.channel_spectra = (10.0 * np.log10(
            np.maximum(power / ref, 1e-12))).astype(np.float32)

    def channel_info(self) -> list[dict]:
        return [{"id": i, "tune_hz": float(f),
                 "smeter_db": round(float(self.smeter_db[i]), 1),
                 "monitor": i == self.monitor,
                 "spec": [round(float(v), 1)
                          for v in self.channel_spectra[i]]}
                for i, f in enumerate(self.tune_freqs)]

    # ----------------------------------------------------- probe scope ----
    def set_probe(self, tap: Optional[str], view: str = "spectrum",
                  trigger_mode: str = "free", trigger_level: float = 0.0,
                  length: int = 1024) -> Optional[str]:
        """Probe scope for the MONITOR channel's taps.  Enabling rebuilds
        the bank with probes on (bank carries restart — a bounded fill-in
        transient, acceptable for a debug instrument; unlike the single
        session there is no per-config migration cache for N-channel
        state).  Returns the applied tap (None = off)."""
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
                self.flush()
                self.cfg = replace(self.cfg, probes=False)
                self.bank = ChannelBank(self.cfg, self.tune_freqs)
            self._probe_tap = self._probe_inst = None
            return None
        # p6 (PLL internals) is single-session only: the bank demod path
        # runs the bank-voted batch PLL, which has no probed variant
        valid = ("p1_downconvert", "p2_fastfir", "p3_agc", "p4_demod",
                 "p5_resampled", "p7_blanker")
        if tap not in valid:
            raise ValueError(f"unknown probe tap {tap!r}")
        if tap == "p7_blanker" and not self.cfg.nb_on:
            raise ValueError("p7 requires the noise blanker (nb_on)")
        if tap == "p5_resampled" and self.cfg.audio_rate is None:
            raise ValueError("p5 requires the 48 kHz resampler (audio_rate)")
        if not self.cfg.probes:
            self.flush()
            self.cfg = replace(self.cfg, probes=True)
            self.bank = ChannelBank(self.cfg, self.tune_freqs)
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

    def _tap_rate(self, key: str) -> float:
        c = self.cfg
        if key == "p7_blanker":
            return c.input_rate
        if key == "p5_resampled":
            return c.audio_rate or c.output_rate
        return c.output_rate

    def probe_frame(self) -> Optional[dict]:
        """Latest monitor-channel probe frame for the server (or None)."""
        with self._lock:
            return self._probe_frame_locked()

    def _probe_frame_locked(self) -> Optional[dict]:
        if self._probe_tap is None or self._probe_inst is None:
            return None
        base = {"tap": self._probe_tap, "view": self._probe_view,
                "channel": self.monitor,
                "sample_rate": self._tap_rate(self._probe_tap)}
        if self._probe_view == "scope":
            rec = self._probe_inst.record
            if rec is None:
                return {**base, "record": None}
            return {**base, "record": [round(float(v), 2) for v in rec]}
        return {**base, "db": [round(float(v), 1)
                               for v in self._probe_inst.spectrum_db()]}

    def status_line(self) -> str:
        return (f"{self.n_channels} ch | monitor {self.monitor} | "
                + self.metrics.status_line())
