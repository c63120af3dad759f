"""Synchronous AM demodulator (carrier-tracking PLL).

Reference analogue: CSamDemod (dsp/samdemod.cpp): atan2 phase-detector PLL
(loop BW 100 Hz, zeta 0.707, NCO clamped to ±1 kHz), per-sample NCO mix and
alpha/beta loop update, one-pole DC removal; the stereo path additionally
runs the DC-removed I/Q through a 0-10 kHz Hilbert bandpass pair and emits
USB→right / LSB→left via I∓Q.

Like the FM demodulator, the PLL runs the parallel locked-loop solve
(ops/pll.py: the recurrence is exactly linear while the phase-detector wrap
and the NCO clamp are inactive, so the block is a short convolution instead
of a scan) with a per-block exactness check and a lax.cond fallback to the
sequential scan during acquisition.  The baseband rotation x·e^{-jφ} is
vectorized either way from the recovered phase sequence.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from cutesdr_tpu.design.fir_kaiser import design_lowpass, hilbert_bandpass
from cutesdr_tpu.ops import fir
from cutesdr_tpu.ops import pll
from cutesdr_tpu.ops.util import first_order_recurrence
from cutesdr_tpu.types import K_2PI

DC_ALPHA = 0.99
PLL_BW = 100.0
PLL_ZETA = 0.707
PLL_LIMIT = 1000.0


class SamParams(NamedTuple):
    pll_alpha: jax.Array
    pll_beta: jax.Array
    nco_limit: jax.Array          # ± rad/sample clamp
    pll_kernel: jax.Array         # [D,2,2] locked-loop impulse response
    hilbert: fir.FirParams        # 0..10 kHz Hilbert bandpass pair (stereo)


class SamCarry(NamedTuple):
    nco_phase: jax.Array
    nco_freq: jax.Array
    z1: jax.Array                 # DC state, I plane
    y1: jax.Array                 # DC state, Q plane (stereo)
    hilbert: fir.FirCarry


def init(sample_rate: float, rdtype=jnp.float32) -> tuple[SamParams, SamCarry]:
    norm = K_2PI / sample_rate
    alpha = 2.0 * PLL_ZETA * PLL_BW * norm
    beta = (alpha * alpha) / (4.0 * PLL_ZETA * PLL_ZETA)
    lp = design_lowpass(1.0, 40.0, 4500.0, 5500.0, sample_rate)
    hi, hq = hilbert_bandpass(lp, 5000.0, sample_rate)
    fp, fc = fir.init(hi, hq, complex_input=True, rdtype=rdtype)
    r = lambda v: jnp.asarray(v, rdtype)
    kernel = pll.locked_loop_kernel(float(alpha), float(beta))
    return (SamParams(pll_alpha=r(alpha), pll_beta=r(beta),
                      nco_limit=r(PLL_LIMIT * norm),
                      pll_kernel=r(kernel), hilbert=fp),
            SamCarry(nco_phase=r(0.0), nco_freq=r(0.0),
                     z1=r(0.0), y1=r(0.0), hilbert=fc))


def _wrap_pi(e):
    """Wrap radians into (-pi, pi]."""
    return e - K_2PI * jnp.round(e / K_2PI)


def _pll_scan(params: SamParams, carry: SamCarry, theta: jax.Array):
    """Sequential loop; returns (phase', freq', pre-update phase sequence).

    The phase detector atan2(x·e^{-jφ}) equals wrap(arg(x) − φ): arg(x) is
    vectorized over the block, the serial recurrence carries only cheap
    arithmetic, and the baseband rotation x·e^{-jφ} is applied vectorized
    afterwards from the emitted phase sequence.
    """
    def step(c, th):
        phase, freq = c
        err = _wrap_pi(th - phase)
        freq = jnp.clip(freq + params.pll_beta * err,
                        -params.nco_limit, params.nco_limit)
        phase = _wrap_pi(phase + freq + params.pll_alpha * err)
        return (phase, freq), phase

    (phase, freq), phases = lax.scan(
        step, (carry.nco_phase, carry.nco_freq), theta,
        unroll=8)
    # note: the reference rotates by the *pre-update* phase; emitting the
    # post-update phase differs by one loop increment — the PLL output is a
    # tracked baseband either way (lock behavior identical); rotate with the
    # pre-update sequence for exact parity:
    prev = jnp.concatenate([carry.nco_phase[None], phases[:-1]], axis=-1)
    return jnp.mod(phase, K_2PI), freq, prev


def _pll_linear(params: SamParams, carry: SamCarry, theta: jax.Array):
    """Parallel locked-loop solve (ops/pll.py); pre-update phases come back
    as theta - e (equal to the scan's mod 2π, which the rotation absorbs)."""
    e0 = _wrap_pi(theta[0] - carry.nco_phase)
    psi = _wrap_pi(theta[1:] - theta[:-1])
    u = jnp.concatenate([jnp.zeros((1,), theta.dtype), psi])
    e, f_next, valid = pll.solve_locked(params.pll_kernel, params.pll_beta,
                                        params.nco_limit, e0,
                                        carry.nco_freq, u)
    prev = theta - e
    phase = jnp.mod(theta[-1] - e[-1] + f_next[-1] + params.pll_alpha * e[-1],
                    K_2PI)
    return valid, (phase, f_next[-1], prev)


TIER_LINEAR, TIER_SCAN = 0, 2     # tier 1 (chunked) does not exist for SAM


def _pll(params: SamParams, carry: SamCarry, x: jax.Array):
    """Hybrid PLL; returns (tier, phase', freq', baseband I/Q,
    phase-error seq).  tier (int32) = 0 parallel linear solve, 2
    sequential scan (matching fm._pll's numbering; there is no chunked
    tier 1 here — see below)."""
    # Unlike FM, there is no chunked guess-verify middle tier here: the
    # 100 Hz loop's memory is ~2600 samples (|eigenvalue| 0.993 at 62.5k),
    # so warmup halos that could bit-sync a chunk would be as long as the
    # chunk itself, and the weak feedback (alpha+beta ~ 0.014) also makes
    # the iterated wrap-pattern solve diverge on noise (the error process
    # is a near-integrator with sigma ~ 11 rad — wraps are dense, not
    # sparse perturbations).  Measured (r5, f32 sequential runs from
    # different initial states on identical carrier-less noise): bitwise
    # state sync took 4.6k / 16k / NEVER-within-20k samples across seeds
    # — chunked_scan's bitwise boundary check is not live at any chunk
    # size that beats the plain scan, so the tier would only add cost.
    # The scan fallback only runs during acquisition transients or on
    # carrier-less noise.
    theta = jnp.arctan2(x.imag, x.real)
    valid, linear = _pll_linear(params, carry, theta)

    def take_linear(_):
        return jnp.asarray(TIER_LINEAR, jnp.int32), linear

    def run_scan(_):
        return (jnp.asarray(TIER_SCAN, jnp.int32),
                _pll_scan(params, carry, theta))

    tier, (phase, freq, prev) = lax.cond(valid, take_linear, run_scan, None)
    base = x * jax.lax.complex(jnp.cos(prev), -jnp.sin(prev))
    return tier, phase, freq, base, _wrap_pi(theta - prev)


def _pll_batch(params: SamParams, carry: SamCarry, x: jax.Array):
    """Channel-bank PLL (leading channel axis on params/carry/x): one real
    lax.cond over the whole bank's validity vote instead of a per-channel
    select under vmap — see fm.process_batch for the rationale."""
    theta = jnp.arctan2(x.imag, x.real)
    valid, linear = jax.vmap(_pll_linear)(params, carry, theta)
    phase, freq, prev = lax.cond(
        jnp.all(valid),
        lambda _: linear,
        lambda _: jax.vmap(_pll_scan)(params, carry, theta),
        None)
    base = x * jax.lax.complex(jnp.cos(prev), -jnp.sin(prev))
    return phase, freq, base, _wrap_pi(theta - prev)


def _dc_block(state, u):
    z0 = first_order_recurrence(DC_ALPHA, u, state)
    z_prev = jnp.concatenate([state[None], z0[:-1]], axis=-1)
    return z0[-1], z0 - z_prev


def _post_mono(carry: SamCarry, phase, freq, base):
    z1, y = _dc_block(carry.z1, base.real)
    return carry._replace(nco_phase=phase, nco_freq=freq, z1=z1), y


def _post_stereo(params: SamParams, carry: SamCarry, phase, freq, base):
    z1, yi = _dc_block(carry.z1, base.real)
    y1, yq = _dc_block(carry.y1, base.imag)
    fc, f = fir.process_complex(params.hilbert, carry.hilbert,
                                jax.lax.complex(yi, yq))
    left = f.real + f.imag       # lower sideband
    right = f.real - f.imag      # upper sideband
    return (carry._replace(nco_phase=phase, nco_freq=freq, z1=z1, y1=y1,
                           hilbert=fc),
            jax.lax.complex(left, right))


def process(params: SamParams, carry: SamCarry,
            x: jax.Array) -> tuple[SamCarry, jax.Array]:
    _tier, phase, freq, base, _ = _pll(params, carry, x)
    return _post_mono(carry, phase, freq, base)


def process_probed(params: SamParams, carry: SamCarry, x: jax.Array):
    """process() + the PLL phase-error series x100 — the reference's
    ad-hoc PROFILE_6 tap (dsp/samdemod.cpp:92: `phzerror*100.0` to
    g_pTestBench) — and the executed solver tier (int32, see _pll).
    Returns (carry', audio, p6, tier)."""
    tier, phase, freq, base, err = _pll(params, carry, x)
    c, y = _post_mono(carry, phase, freq, base)
    return c, y, err * 100.0, tier


def process_stereo(params: SamParams, carry: SamCarry,
                   x: jax.Array) -> tuple[SamCarry, jax.Array]:
    _tier, phase, freq, base, _ = _pll(params, carry, x)
    return _post_stereo(params, carry, phase, freq, base)


def process_batch(params: SamParams, carry: SamCarry,
                  x: jax.Array) -> tuple[SamCarry, jax.Array]:
    phase, freq, base, _ = _pll_batch(params, carry, x)
    return jax.vmap(_post_mono)(carry, phase, freq, base)


def process_batch_stereo(params: SamParams, carry: SamCarry,
                         x: jax.Array) -> tuple[SamCarry, jax.Array]:
    phase, freq, base, _ = _pll_batch(params, carry, x)
    return jax.vmap(_post_stereo)(params, carry, phase, freq, base)
