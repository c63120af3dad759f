"""Scalar per-sample oracle implementations of the reference recurrences.

These are deliberately naive float64 loops written from the documented
semantics (SURVEY.md section 2.1 / reference file:line cites in each op's
docstring) and used only to verify the vectorized ops.  They mirror the
*math*, including block/boundary behavior, of the reference C++ chain.
"""

from __future__ import annotations

import numpy as np

K_2PI = 2.0 * np.pi


# --- decimate-by-2 stages (dsp/downconvert.cpp) ---

class HalfbandStage:
    def __init__(self, taps: np.ndarray):
        self.h = np.asarray(taps, np.float64)
        self.tail = np.zeros(len(taps) - 1, np.complex128)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        z = np.concatenate([self.tail, x])
        L = len(self.h)
        out = np.empty(len(x) // 2, np.complex128)
        for n in range(len(out)):
            out[n] = np.dot(self.h, z[2 * n:2 * n + L])
        self.tail = z[len(z) - (L - 1):]
        return out


class Cic3Stage:
    def __init__(self):
        self.xodd = 0.0 + 0.0j
        self.xeven = 0.0 + 0.0j

    def __call__(self, x: np.ndarray) -> np.ndarray:
        out = np.empty(len(x) // 2, np.complex128)
        for j in range(len(out)):
            even, odd = x[2 * j], x[2 * j + 1]
            out[j] = 0.125 * (odd + self.xeven + 3.0 * (self.xodd + even))
            self.xodd, self.xeven = odd, even
        return out


class CascadeOracle:
    def __init__(self, plan):
        self.stages = [Cic3Stage() if s == "cic3"
                       else HalfbandStage(plan.stage_taps(s))
                       for s in plan.stages]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for s in self.stages:
            x = s(x)
        return x


# --- overlap-save fast convolution (dsp/fastfir.cpp:268-306) ---

class FastFirOracle:
    def __init__(self, h_freq: np.ndarray, nfft: int = 2048, nfir: int = 1025):
        self.h = np.asarray(h_freq, np.complex128)
        self.nfft, self.nfir = nfft, nfir
        self.buf = np.zeros(nfft, np.complex128)
        self.pos = nfir - 1

    def __call__(self, x: np.ndarray) -> np.ndarray:
        out = []
        for s in x:
            self.buf[self.pos] = s
            self.pos += 1
            if self.pos >= self.nfft:
                spec = np.fft.fft(self.buf)
                y = np.fft.ifft(spec * self.h) * self.nfft
                out.extend(y[self.nfir - 1:])
                self.buf[:self.nfir - 1] = self.buf[self.nfft - (self.nfir - 1):]
                self.pos = self.nfir - 1
        return np.asarray(out, np.complex128)


# --- FIR (dsp/fir.cpp:72-127) ---

class FirOracle:
    def __init__(self, taps_i, taps_q=None):
        self.hi = np.asarray(taps_i, np.float64)
        self.hq = self.hi if taps_q is None else np.asarray(taps_q, np.float64)
        self.zi = np.zeros(len(self.hi), np.float64)
        self.zq = np.zeros(len(self.hi), np.float64)

    def real(self, x):
        out = np.empty(len(x))
        for n, v in enumerate(x):
            self.zi = np.roll(self.zi, 1)
            self.zi[0] = v
            out[n] = np.dot(self.hi, self.zi)
        return out

    def cpx(self, x):
        out = np.empty(len(x), np.complex128)
        for n, v in enumerate(x):
            self.zi = np.roll(self.zi, 1)
            self.zq = np.roll(self.zq, 1)
            self.zi[0] = v.real
            self.zq[0] = v.imag
            out[n] = np.dot(self.hi, self.zi) + 1j * np.dot(self.hq, self.zq)
        return out


# --- AGC (dsp/agc.cpp:174-296) ---

class AgcOracle:
    def __init__(self, cfg, threshold_db, manual_gain_db, slope, decay_ms):
        fs = cfg.sample_rate
        self.on = cfg.agc_on
        self.use_hang = cfg.use_hang
        self.knee = threshold_db / 20.0
        self.gain_slope = slope / 100.0
        self.fixed_gain = 0.7 * 10.0 ** (self.knee * (self.gain_slope - 1.0))
        self.manual_gain = 32767.0 * 10.0 ** (-(100 - manual_gain_db) / 20.0)
        self.a_rise = 1 - np.exp(-1.0 / (fs * 0.002))
        self.a_fall = 1 - np.exp(-1.0 / (fs * 0.005))
        self.d_rise = 1 - np.exp(-1.0 / (fs * decay_ms * 1e-3 * 0.3))
        self.d_fall = (1 - np.exp(-1.0 / (fs * 0.05)) if cfg.use_hang
                       else 1 - np.exp(-1.0 / (fs * decay_ms * 1e-3)))
        self.hang_time = int(fs * decay_ms * 1e-3)
        self.delay = np.zeros(cfg.delay_samples, np.complex128)
        self.magbuf = np.full(cfg.window_samples, -16.0)
        self.W = cfg.window_samples
        self.attack = -5.0
        self.decay = -5.0
        self.timer = 0

    def __call__(self, x):
        if not self.on:
            return self.manual_gain * x
        out = np.empty_like(x)
        for n, v in enumerate(x):
            delayed = self.delay[0]
            self.delay = np.concatenate([self.delay[1:], [v]])
            mag = np.log10(max(abs(v.real), abs(v.imag)) + 3.2767e-4) \
                - np.log10(32767.0)
            self.magbuf = np.concatenate([self.magbuf[1:], [mag]])
            peak = self.magbuf[-self.W:].max() if self.W else mag
            aa = self.a_rise if peak > self.attack else self.a_fall
            self.attack = (1 - aa) * self.attack + aa * peak
            if self.use_hang:
                if peak > self.decay:
                    self.decay = (1 - self.d_rise) * self.decay + self.d_rise * peak
                    self.timer = 0
                elif self.timer < self.hang_time:
                    self.timer += 1
                else:
                    self.decay = (1 - self.d_fall) * self.decay + self.d_fall * peak
            else:
                da = self.d_rise if peak > self.decay else self.d_fall
                self.decay = (1 - da) * self.decay + da * peak
            m = max(self.attack, self.decay)
            gain = (self.fixed_gain if m <= self.knee
                    else 0.7 * 10.0 ** (m * (self.gain_slope - 1.0)))
            out[n] = delayed * gain
        return out


# --- fractional resampler (dsp/fractresampler.cpp:144-184) ---

class ResamplerOracle:
    def __init__(self, sinc_table):
        self.sinc = np.asarray(sinc_table, np.float64)
        self.PTS = 10000
        self.P = 28
        self.buf_tail = np.zeros(self.P, np.complex128)
        self.ft = 0.0

    def __call__(self, x, rate):
        z = np.concatenate([self.buf_tail, x])
        out = []
        it = int(self.ft)
        while it < len(x):
            acc = 0.0 + 0.0j
            for i in range(1, self.P + 1):
                j = it + i
                sindx = int((j - self.ft) * self.PTS)
                acc += z[j] * self.sinc[sindx]
            out.append(acc)
            self.ft += rate
            it = int(self.ft)
        self.ft -= len(x)
        self.buf_tail = z[len(z) - self.P:]
        return np.asarray(out)


# --- noise blanker (dsp/noiseproc.cpp:121-176) ---

class BlankerOracle:
    def __init__(self, cfg):
        self.W = cfg.width_samples
        self.M = cfg.mag_samples
        self.D = cfg.delay_samples
        self.ratio = cfg.ratio
        self.magbuf = np.zeros(self.M + 1)
        self.mptr = 0
        self.delaybuf = np.zeros(self.D + 1, np.complex128)
        self.dptr = 0
        self.magsum = 0.0
        self.counter = 0

    def __call__(self, x):
        out = np.empty_like(x)
        for n, v in enumerate(x):
            mag = max(abs(v.real), abs(v.imag))
            self.magsum -= self.magbuf[self.mptr]
            self.magsum += mag
            self.magbuf[self.mptr] = mag
            self.mptr = 0 if self.mptr + 1 > self.M else self.mptr + 1
            oldest = self.delaybuf[self.dptr]
            self.delaybuf[self.dptr] = v
            self.dptr = 0 if self.dptr + 1 > self.D else self.dptr + 1
            if mag * self.ratio > self.magsum:
                self.counter = self.W
            if self.counter:
                self.counter -= 1
                out[n] = 0.0
            else:
                out[n] = oldest
        return out


# --- PLL demods (dsp/fmdemod.cpp:157-192, dsp/samdemod.cpp:78-110) ---

class FmPllOracle:
    """FM PLL frequency tracker, per-sample (excluding noise squelch)."""

    def __init__(self, fs):
        norm = K_2PI / fs
        self.alpha = 2.0 * 0.707 * 6000.0 * norm
        self.beta = self.alpha ** 2 / (4.0 * 0.707 ** 2)
        self.limit = 6000.0 * norm
        self.out_gain = 25000.0 / self.limit
        self.dc_alpha = 1.0 - np.exp(-1.0 / (fs * 0.01))
        self.phase = 0.0
        self.freq = 0.0
        self.dc = 0.0

    def __call__(self, x):
        out = np.empty(len(x))
        for n, v in enumerate(x):
            tmp = v * np.exp(1j * self.phase)
            err = -np.arctan2(tmp.imag, tmp.real)
            self.freq = np.clip(self.freq + self.beta * err,
                                -self.limit, self.limit)
            self.phase += self.freq + self.alpha * err
            self.dc = (1 - self.dc_alpha) * self.dc + self.dc_alpha * self.freq
            out[n] = (self.freq - self.dc) * self.out_gain
        self.phase = np.mod(self.phase, K_2PI)
        return out


class SamPllOracle:
    """SAM carrier-tracking PLL, per-sample (mono: DC-removed real part)."""

    def __init__(self, fs):
        norm = K_2PI / fs
        self.alpha = 2.0 * 0.707 * 100.0 * norm
        self.beta = self.alpha ** 2 / (4.0 * 0.707 ** 2)
        self.limit = 1000.0 * norm
        self.phase = 0.0
        self.freq = 0.0
        self.z1 = 0.0

    def __call__(self, x):
        out = np.empty(len(x))
        for n, v in enumerate(x):
            tmp = v * np.exp(-1j * self.phase)
            err = np.arctan2(tmp.imag, tmp.real)
            self.freq = np.clip(self.freq + self.beta * err,
                                -self.limit, self.limit)
            self.phase += self.freq + self.alpha * err
            z0 = tmp.real + self.z1 * 0.99
            out[n] = z0 - self.z1
            self.z1 = z0
        self.phase = np.mod(self.phase, K_2PI)
        return out
