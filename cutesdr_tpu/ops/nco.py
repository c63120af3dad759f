"""Numerically-controlled oscillator / complex mixer.

Reference analogue: the per-sample quadrature-oscillator NCO loop in
CDownConvert (dsp/downconvert.cpp:203-245) — a serial recurrence with a
self-normalizing gain hack.  Here it is closed-form instead: the
phase of sample ``n`` is an *exact* 32-bit fixed-point accumulator value

    acc_n = acc_0 + n * phase_inc   (mod 2^32)

computed for a whole block at once (hardware-DDS style), so it is fully
parallel, drift-free over unbounded streams, and sharding-friendly (a time
shard at global offset g just adds g*phase_inc).  Frequency resolution is
fs / 2^32 (≈ 0.0005 Hz at 2 MSPS).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cutesdr_tpu.types import K_2PI

_TWO32 = 4294967296.0


class NcoParams(NamedTuple):
    phase_inc: jax.Array   # uint32 scalar: round(-freq/fs * 2^32) mod 2^32


class NcoCarry(NamedTuple):
    phase_acc: jax.Array   # uint32 scalar


def phase_increment(freq_hz: float, sample_rate: float) -> np.uint32:
    """Fixed-point phase increment for a mixer that shifts a tone at
    ``+freq_hz`` down to DC (multiplication by e^{-j 2π f n / fs})."""
    frac = -freq_hz / sample_rate
    return np.uint32(np.int64(np.round(frac * _TWO32)) & 0xFFFFFFFF)


def init(freq_hz: float, sample_rate: float) -> tuple[NcoParams, NcoCarry]:
    return (NcoParams(phase_inc=jnp.asarray(phase_increment(freq_hz, sample_rate))),
            NcoCarry(phase_acc=jnp.zeros((), jnp.uint32)))


def retune(params: NcoParams, freq_hz: float, sample_rate: float) -> NcoParams:
    """New params for a frequency change; phase continuity is automatic
    because the accumulator carry is untouched (same live-retune behavior as
    the reference oscillator keeping phase, dsp/downconvert.cpp:98-107)."""
    return params._replace(phase_inc=jnp.asarray(phase_increment(freq_hz, sample_rate)))


def phases(params: NcoParams, carry: NcoCarry, n: int,
           dtype=jnp.float32) -> tuple[NcoCarry, jax.Array]:
    """Radian phase vector for the next ``n`` samples plus advanced carry."""
    k = jax.lax.iota(jnp.uint32, n)
    acc = carry.phase_acc + k * params.phase_inc          # uint32 wraps mod 2^32
    ang = acc.astype(dtype) * jnp.asarray(K_2PI / _TWO32, dtype)
    new_acc = carry.phase_acc + jnp.uint32(n) * params.phase_inc
    return NcoCarry(phase_acc=new_acc), ang


def process(params: NcoParams, carry: NcoCarry,
            x: jax.Array) -> tuple[NcoCarry, jax.Array]:
    """Mix a complex block: y = x * e^{j·phase}."""
    real_dtype = jnp.real(x).dtype
    carry, ang = phases(params, carry, x.shape[-1], dtype=real_dtype)
    osc = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    return carry, x * osc
