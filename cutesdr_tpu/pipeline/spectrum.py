"""Spectrum display path: windowed power FFT, averaging, dB mapping, and
bin→pixel reduction for plotting.

Reference analogue: CFft's display half (dsp/fft.cpp) — which *fuses* the
windowing, power averaging, dB mapping, and overload detection inside the
radix-4 FFT butterflies (:465-502, :560-589).  Here each concern is a pure
function over a batched jnp.fft:

  * power spectrum: |FFT(window·x)|², fftshifted so bin 0 = -fs/2.  (The
    reference feeds I/Q swapped into its FFT and un-mirrors during output
    mapping — a documented quirk, dsp/fft.cpp:278-281 — with identical net
    power spectrum; we do the straightforward equivalent.)
  * averaging: moving average over the first ave_size frames, then leaky
    (exponential-window) averaging with the same sum-replace recurrence
    sum ← sum - ave + new, ave = sum/ave_size (dsp/fft.cpp:465-476).
  * dB map: 0.1·dB units, y = log10(p + K_C) + K_B with
    K_B = (dBcomp - 20·log10(N·32767/2))/10 and K_C from the -220 dB floor —
    the same absolute calibration as the reference (dsp/fft.cpp:170-188).
  * bin→pixel: max-hold segment reduction when bins > pixels, interpolation
    table when pixels > bins (dsp/fft.cpp:308-410).
  * overload flag when any |I| exceeds 32000 counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cutesdr_tpu.design.windows import window_table
from cutesdr_tpu.types import MAX_AMPLITUDE

MIN_FFT_SIZE = 512
MAX_FFT_SIZE = 65536
K_MAXDB = 0.0
K_MINDB = -220.0
OVER_LIMIT = 32000.0


@dataclass(frozen=True)
class SpectrumConfig:
    fft_size: int = 4096
    ave_size: int = 1
    sample_rate: float = 2_000_000.0
    db_compensation: float = 0.0     # gain-calibration offset in dB
    window: str = "hann"

    def __post_init__(self):
        n = self.fft_size
        if not (MIN_FFT_SIZE <= n <= MAX_FFT_SIZE) or n & (n - 1):
            raise ValueError(f"fft_size must be a power of 2 in "
                             f"[{MIN_FFT_SIZE},{MAX_FFT_SIZE}], got {n}")

    @cached_property
    def k_b(self) -> float:
        # calibrated so a full-scale (32767) complex tone reads 0 dB: the
        # gain-normalized windows have coherent gain 1, so the FFT peak is
        # N·A.  (The reference calibrates against N·A/2 *and* applies the
        # same windows — a systematic +6 dB it never corrected; we do.)
        return (self.db_compensation
                - 20.0 * np.log10(self.fft_size * MAX_AMPLITUDE)) / 10.0

    @cached_property
    def k_c(self) -> float:
        return 10.0 ** ((K_MINDB / 10.0) - self.k_b)


class SpectrumState(NamedTuple):
    pwr_ave: jax.Array     # [fft_size] averaged power, fftshifted
    pwr_sum: jax.Array
    count: jax.Array       # frames accumulated, saturates at ave_size


def init(cfg: SpectrumConfig, rdtype=jnp.float32) -> SpectrumState:
    z = jnp.zeros(cfg.fft_size, rdtype)
    return SpectrumState(pwr_ave=z, pwr_sum=z,
                         count=jnp.zeros((), jnp.int32))


def accumulate(cfg: SpectrumConfig, state: SpectrumState,
               x: jax.Array) -> tuple[SpectrumState, jax.Array]:
    """Feed one fft_size block of complex input; returns (state', overload).

    Accepts [..., fft_size]; leading axes average as extra frames in order.
    """
    rdtype = state.pwr_ave.dtype
    win = jnp.asarray(window_table(cfg.window, cfg.fft_size, with_gain=True),
                      rdtype)
    overload = jnp.any(x.real > OVER_LIMIT)
    spec = jnp.fft.fftshift(jnp.fft.fft(x * win, axis=-1), axes=-1)
    pwr = (spec.real * spec.real + spec.imag * spec.imag).astype(rdtype)
    pwr = pwr.reshape((-1, cfg.fft_size))

    def one_frame(carry, p):
        ave, total, count = carry
        count = jnp.minimum(count + 1, cfg.ave_size)
        in_moving = count < cfg.ave_size
        total = jnp.where(in_moving, total + p, total - ave + p)
        # while still filling: plain moving average over `count` frames;
        # afterwards the sum-replace recurrence = leaky exponential window
        ave = total / count.astype(p.dtype)
        return (ave, total, count), None

    (ave, total, count), _ = jax.lax.scan(
        one_frame, (state.pwr_ave, state.pwr_sum, state.count), pwr)
    return SpectrumState(pwr_ave=ave, pwr_sum=total, count=count), overload


def db_spectrum(cfg: SpectrumConfig, state: SpectrumState) -> jax.Array:
    """Averaged spectrum in 0.1·dB units (K_MINDB/10 .. K_MAXDB/10),
    bin 0 = -fs/2."""
    return jnp.log10(state.pwr_ave + cfg.k_c) + cfg.k_b


def reset(cfg: SpectrumConfig, state: SpectrumState) -> SpectrumState:
    return init(cfg, state.pwr_ave.dtype)


def screen_map(cfg: SpectrumConfig, db: jax.Array, max_height: int,
               max_width: int, max_db: float, min_db: float,
               start_freq: float, stop_freq: float) -> jax.Array:
    """Map dB bins to integer pixel heights (0=top), max-hold when several
    bins share a pixel.  Static geometry -> precomputed index tables."""
    n = cfg.fft_size
    bin_min = int(start_freq * n / cfg.sample_rate) + n // 2
    bin_max = int(stop_freq * n / cfg.sample_rate) + n // 2
    bin_min = min(max(bin_min, 0), n - 1)
    bin_max = min(max(bin_max, 0), n - 1)

    gain = -10.0 / (max_db - min_db) * max_height
    y_all = gain * (db - max_db / 10.0)
    y_all = jnp.clip(y_all, 0, max_height).astype(jnp.int32)

    if (bin_max - bin_min) > max_width:
        # more bins than pixels: per-pixel max-hold (min of y = max signal,
        # since y is inverted screen coordinate)
        bins = np.arange(bin_min, bin_max + 1)
        px = ((bins - bin_min) * max_width) // (bin_max - bin_min)
        seg = jnp.asarray(px, jnp.int32)
        out = jnp.full((max_width + 1,), max_height, jnp.int32)
        return out.at[seg].min(y_all[bin_min:bin_max + 1])
    # more pixels than bins: nearest-bin lookup
    px = np.arange(max_width)
    tbl = bin_min + (px * (bin_max - bin_min)) // max_width
    return y_all[jnp.asarray(tbl, jnp.int32)]


@dataclass
class SpectrumAnalyzer:
    """Stateful convenience wrapper with display-rate throttling.

    Reference analogue: the FFT accumulate/throttle logic in
    CSdrInterface::ProcessIQData (interface/sdrinterface.cpp:895-908) with
    m_DisplaySkipValue = fs / (fft_size · max_display_rate).
    """
    cfg: SpectrumConfig
    max_display_rate: float = 10.0

    def __post_init__(self):
        self.state = init(self.cfg)
        # host frames go up as f32 re/im planes (the host contract of
        # Receiver.process_host)
        self._acc = jax.jit(lambda s, re, im: accumulate(
            self.cfg, s, jax.lax.complex(re, im)))
        self._db = jax.jit(lambda s: db_spectrum(self.cfg, s))
        self._pending = np.zeros(0, np.complex64)
        self._skip = max(1, int(self.cfg.sample_rate
                                / (self.cfg.fft_size * self.max_display_rate)))
        self._skip_count = 0
        self.overload = False
        # plane-feed path state (feed_planes): one frame being collected
        self._fbuf_re = np.zeros(self.cfg.fft_size, np.float32)
        self._fbuf_im = np.zeros(self.cfg.fft_size, np.float32)
        self._collected = 0
        self._skip_remaining = 0

    def feed(self, iq: np.ndarray) -> bool:
        """Append raw IQ; returns True when a new display frame is ready."""
        buf = np.concatenate([self._pending, np.asarray(iq)])
        n = self.cfg.fft_size
        ready = False
        while len(buf) >= n:
            frame, buf = buf[:n], buf[n:]
            self._skip_count += 1
            if self._skip_count >= self._skip:
                self._skip_count = 0
                self.state, ov = self._acc(
                    self.state,
                    np.ascontiguousarray(np.real(frame), np.float32),
                    np.ascontiguousarray(np.imag(frame), np.float32))
                self.overload = bool(ov)
                ready = True
        self._pending = buf
        return ready

    def feed_planes(self, re, im) -> bool:
        """Plane-format feed for the high-rate ingest path: re/im planes
        (int16 wire format or float32).  Unlike feed(), samples inside
        skipped display frames are never buffered or converted — the
        reference's m_DisplaySkipValue throttle applied at sample
        granularity, so a 20 MSPS stream costs one fft_size frame of host
        work per display update, not a full-stream copy."""
        n = self.cfg.fft_size
        ready = False
        pos, total = 0, len(re)
        while pos < total:
            if self._skip_remaining > 0:
                take = min(self._skip_remaining, total - pos)
                self._skip_remaining -= take
                pos += take
                continue
            take = min(n - self._collected, total - pos)
            c = self._collected
            self._fbuf_re[c:c + take] = re[pos:pos + take]
            self._fbuf_im[c:c + take] = im[pos:pos + take]
            self._collected += take
            pos += take
            if self._collected == n:
                self.state, ov = self._acc(self.state, self._fbuf_re,
                                           self._fbuf_im)
                self.overload = bool(ov)
                self._collected = 0
                self._skip_remaining = (self._skip - 1) * n
                ready = True
        return ready

    def spectrum_db(self) -> np.ndarray:
        """Current averaged spectrum in dB (not 0.1-dB units)."""
        return np.asarray(self._db(self.state)) * 10.0
