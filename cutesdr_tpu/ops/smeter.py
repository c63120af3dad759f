"""S-meter: calibrated dB-power metering with attack/decay averaging.

Reference analogue: CSMeter (dsp/smeter.cpp): per-sample dB power
10·log10((I²+Q²)/32767²), 10 ms attack / 500 ms decay EMAs with the
attack-dominates rule (rising signal snaps the decay average up), peak hold
that resets when read, +5 dB absolute calibration offset.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cutesdr_tpu.ops.util import ema, max_affine_recurrence
from cutesdr_tpu.types import MAX_AMPLITUDE

ATTACK_TIMECONST = 0.01
DECAY_TIMECONST = 0.5
SMETER_CALIBRATION = 5.0
MAX_PWR = MAX_AMPLITUDE * MAX_AMPLITUDE


class SMeterParams(NamedTuple):
    attack_alpha: jax.Array
    decay_alpha: jax.Array


class SMeterCarry(NamedTuple):
    attack_ave: jax.Array
    decay_ave: jax.Array
    average_mag: jax.Array
    peak_mag: jax.Array


def init(sample_rate: float, rdtype=jnp.float32) -> tuple[SMeterParams, SMeterCarry]:
    a = 1.0 - np.exp(-1.0 / (sample_rate * ATTACK_TIMECONST))
    d = 1.0 - np.exp(-1.0 / (sample_rate * DECAY_TIMECONST))
    r = lambda v: jnp.asarray(v, rdtype)
    return (SMeterParams(attack_alpha=r(a), decay_alpha=r(d)),
            SMeterCarry(attack_ave=r(-120.0), decay_ave=r(-120.0),
                        average_mag=r(-120.0), peak_mag=r(0.0)))


def process(params: SMeterParams, carry: SMeterCarry,
            x: jax.Array) -> tuple[SMeterCarry, jax.Array]:
    """Returns (carry', per-sample dB magnitudes); read meter via getters.

    The per-sample recurrence
        a[n] = (1-aa)·a[n-1] + aa·m[n]
        d[n] = max((1-ad)·d[n-1] + ad·m[n], a[n])   # attack dominates
    is solved in parallel: the attack average is a plain linear recurrence
    and the snapped decay is a max-affine recurrence — both log-depth
    associative scans (ops/util.py), not a sequential per-sample scan."""
    rdtype = jnp.real(x).dtype
    pwr = (x.real * x.real + x.imag * x.imag) / MAX_PWR
    # floor at -160 dBFS: the reference's 1e-50 guard would underflow to 0
    # in float32 and poison the averagers with -inf
    mag = (10.0 * jnp.log10(jnp.maximum(pwr, 1e-16))).astype(rdtype)

    a_series = ema(params.attack_alpha, mag, carry.attack_ave)
    d_series = max_affine_recurrence(
        1.0 - params.decay_alpha, params.decay_alpha * mag, a_series,
        carry.decay_ave)
    a = a_series[..., -1]
    d = d_series[..., -1]
    peak = jnp.maximum(carry.peak_mag, jnp.max(mag))
    return SMeterCarry(attack_ave=a, decay_ave=d, average_mag=d,
                       peak_mag=peak), mag


def get_ave(carry: SMeterCarry) -> jax.Array:
    return carry.average_mag + SMETER_CALIBRATION


def get_peak(carry: SMeterCarry) -> tuple[SMeterCarry, jax.Array]:
    """Peak hold, reset on read (same contract as the reference getter)."""
    return carry._replace(peak_mag=jnp.zeros_like(carry.peak_mag)), \
        carry.peak_mag + SMETER_CALIBRATION
