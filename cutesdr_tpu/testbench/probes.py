"""Probe capture utilities: triggered time capture and spectrum capture of
any pipeline tap.

Reference analogue: CTestBench's 8-tap probe scope — a 2048-pt spectrum
analyzer or a triggered oscilloscope with a level+hysteresis trigger state
machine (gui/testbench.cpp:583-898, trigger modes off/±normal/±single).
Here the same instruments as host-side utilities over the receiver's named
probe outputs (cfg.probes=True).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TriggerMode(enum.Enum):
    FREE_RUN = 0
    NORM_POS = 1
    NORM_NEG = 2
    SINGLE_POS = 3
    SINGLE_NEG = 4


class _TrigState(enum.Enum):
    WAIT = 0        # waiting for pre-trigger history
    ARMED = 1       # looking for an edge
    CAPTURING = 2
    DONE = 3


@dataclass
class TriggeredCapture:
    """Level-triggered capture over a streamed probe signal.

    Feed blocks with ``feed``; when a full record is captured, ``record``
    holds ``length`` samples beginning ``pre_samples`` before the trigger
    edge.  Hysteresis: the signal must cross below (above for NEG) the
    trigger level by ``hysteresis`` before re-arming, like the reference's
    two-threshold machine (gui/testbench.cpp:819-898).
    """
    length: int = 2048
    pre_samples: int = 512
    level: float = 0.0
    hysteresis: float = 0.05
    mode: TriggerMode = TriggerMode.NORM_POS

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        self._hist = np.zeros(0, np.float64)
        self._state = (_TrigState.ARMED if self.mode != TriggerMode.FREE_RUN
                       else _TrigState.CAPTURING)
        self._below = False
        self._cap: list[np.ndarray] = []
        self._cap_len = 0
        self.record: np.ndarray | None = None

    def _edges(self, x: np.ndarray) -> np.ndarray:
        pos = self.mode in (TriggerMode.NORM_POS, TriggerMode.SINGLE_POS)
        lo = self.level - self.hysteresis if pos else self.level + self.hysteresis
        if pos:
            armed_mask = x < lo
            fire_mask = x >= self.level
        else:
            armed_mask = x > lo
            fire_mask = x <= self.level
        # fire where previous samples armed and current crosses
        fired = np.zeros(len(x), bool)
        below = self._below
        for i, (a, f) in enumerate(zip(armed_mask, fire_mask)):
            if below and f:
                fired[i] = True
                below = False
            elif a:
                below = True
        self._below = below
        return fired

    def feed(self, block: np.ndarray) -> bool:
        """Returns True when a complete record becomes available."""
        x = np.asarray(block, np.float64)
        if self._state == _TrigState.DONE:
            return False
        if self.mode == TriggerMode.FREE_RUN:
            self._cap.append(x)
            self._cap_len += len(x)
            if self._cap_len >= self.length:
                self.record = np.concatenate(self._cap)[:self.length]
                self._cap, self._cap_len = [], 0
                return True
            return False

        if self._state == _TrigState.ARMED:
            fired = self._edges(x)
            idx = np.flatnonzero(fired)
            if len(idx):
                t = int(idx[0])
                pre = np.concatenate([self._hist, x[:t]])
                pre = pre[max(0, len(pre) - self.pre_samples):]
                self._cap = [pre, x[t:]]
                self._cap_len = len(pre) + len(x) - t
                self._state = _TrigState.CAPTURING
            else:
                self._hist = np.concatenate([self._hist, x])[-self.pre_samples:]
        elif self._state == _TrigState.CAPTURING:
            self._cap.append(x)
            self._cap_len += len(x)

        if self._state == _TrigState.CAPTURING and self._cap_len >= self.length:
            self.record = np.concatenate(self._cap)[:self.length]
            self._cap, self._cap_len = [], 0
            self._hist = np.zeros(0, np.float64)
            if self.mode in (TriggerMode.SINGLE_POS, TriggerMode.SINGLE_NEG):
                self._state = _TrigState.DONE
            else:
                self._state = _TrigState.ARMED
            return True
        return False


@dataclass
class ProbeSpectrum:
    """2048-pt averaged power spectrum of a probe tap (the testbench's
    frequency display), reusing the display-FFT math."""
    sample_rate: float
    fft_size: int = 2048
    ave: int = 4

    def __post_init__(self):
        import jax

        from cutesdr_tpu.pipeline import spectrum as sp
        from cutesdr_tpu.pipeline.spectrum import SpectrumConfig, init
        self._cfg = SpectrumConfig(fft_size=self.fft_size, ave_size=self.ave,
                                   sample_rate=self.sample_rate)
        self._state = init(self._cfg)
        self._pending = np.zeros(0, np.complex64)
        # frames cross host->device as f32 re/im planes (the host
        # contract of Receiver.process_host)
        self._acc = jax.jit(lambda s, re, im: sp.accumulate(
            self._cfg, s, jax.lax.complex(re, im)))

    def feed(self, block: np.ndarray) -> None:
        x = np.asarray(block)
        if not np.iscomplexobj(x):
            x = x.astype(np.complex64)
        buf = np.concatenate([self._pending, x])
        n = self.fft_size
        while len(buf) >= n:
            self._state, _ = self._acc(
                self._state,
                np.ascontiguousarray(np.real(buf[:n]), np.float32),
                np.ascontiguousarray(np.imag(buf[:n]), np.float32))
            buf = buf[n:]
        self._pending = buf

    def spectrum_db(self) -> np.ndarray:
        from cutesdr_tpu.pipeline import spectrum as sp
        return np.asarray(sp.db_spectrum(self._cfg, self._state)) * 10.0
