"""Digital AGC with delayed signal path, window peak detector, dual
attack/decay averagers and knee/slope gain law.

Reference analogue: CAgc (dsp/agc.cpp).  Structure (complex and real paths
share everything but the magnitude estimate, :174-296 / :301-401):

  1. signal delay line (15 ms) so gain leads the signal,
  2. log magnitude  log10(max(|I|,|Q|) + K_MIN) - log10(32767)  in decades
     (0 = full scale, -8 = -160 dB),
  3. 18 ms sliding-window peak — a van Herk cummax instead of the
     reference's branch-heavy O(W) rescan (:209-231),
  4. attack & decay exponential averagers with separate rise/fall constants
     (optionally a hang-timer release mode) — solved in PARALLEL by
     guess-verify over the branch pattern (the recurrence is linear once
     the rise/fall pattern is fixed; see _two_rate_parallel) with an
     exact sequential-scan fallback,
  5. gain law: fixed gain below the knee, 10^(mag*(slope-1)) above, output
     scaled to ~3 dB below max (AGC_OUTSCALE).

AGC on/off and hang mode are *static* (they change program structure); the
numeric parameters are traced so the UI can slide them without recompiling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cutesdr_tpu.ops.util import (distance_since_last_true,
                                  first_order_recurrence,
                                  sliding_window_max)


from cutesdr_tpu.types import MAX_AMPLITUDE, complex_zeros

DELAY_TIMECONST = 0.015
WINDOW_TIMECONST = 0.018
ATTACK_RISE_TIMECONST = 0.002
ATTACK_FALL_TIMECONST = 0.005
DECAY_RISEFALL_RATIO = 0.3
RELEASE_TIMECONST = 0.05
AGC_OUTSCALE = 0.7
MIN_CONSTANT = 3.2767e-4      # log10(0 + K) - log10(32767) == -8 (-160 dB)
MAX_DELAY_SAMPLES = 2047


@dataclass(frozen=True)
class AgcConfig:
    """Static structure: determines delay/window sizes and scan shape."""
    agc_on: bool
    use_hang: bool
    sample_rate: float

    @property
    def delay_samples(self) -> int:
        return min(int(self.sample_rate * DELAY_TIMECONST), MAX_DELAY_SAMPLES)

    @property
    def window_samples(self) -> int:
        return int(self.sample_rate * WINDOW_TIMECONST)


class AgcParams(NamedTuple):
    knee: jax.Array            # thresh_dB / 20 (decades)
    gain_slope: jax.Array      # slope / 100
    fixed_gain: jax.Array
    manual_gain: jax.Array
    attack_rise_alpha: jax.Array
    attack_fall_alpha: jax.Array
    decay_rise_alpha: jax.Array
    decay_fall_alpha: jax.Array
    hang_time: jax.Array       # samples (int32)


class AgcCarry(NamedTuple):
    sig_delay: jax.Array       # [delay_samples] input history
    mag_tail: jax.Array        # [window_samples-1] magnitude history
    attack_ave: jax.Array
    decay_ave: jax.Array
    hang_timer: jax.Array      # int32


def make_params(cfg: AgcConfig, threshold_db: float, manual_gain_db: float,
                slope_factor: float, decay_ms: float,
                rdtype=jnp.float32) -> AgcParams:
    fs = cfg.sample_rate
    knee = threshold_db / 20.0
    gain_slope = slope_factor / 100.0
    fixed_gain = AGC_OUTSCALE * 10.0 ** (knee * (gain_slope - 1.0))
    manual = MAX_AMPLITUDE * 10.0 ** (-(100.0 - manual_gain_db) / 20.0)
    a_rise = 1.0 - np.exp(-1.0 / (fs * ATTACK_RISE_TIMECONST))
    a_fall = 1.0 - np.exp(-1.0 / (fs * ATTACK_FALL_TIMECONST))
    d_rise = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3 * DECAY_RISEFALL_RATIO))
    if cfg.use_hang:
        d_fall = 1.0 - np.exp(-1.0 / (fs * RELEASE_TIMECONST))
    else:
        d_fall = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3))
    hang_time = int(fs * decay_ms * 1e-3)
    r = lambda v: jnp.asarray(v, rdtype)
    return AgcParams(knee=r(knee), gain_slope=r(gain_slope),
                     fixed_gain=r(fixed_gain), manual_gain=r(manual),
                     attack_rise_alpha=r(a_rise), attack_fall_alpha=r(a_fall),
                     decay_rise_alpha=r(d_rise), decay_fall_alpha=r(d_fall),
                     hang_time=jnp.asarray(hang_time, jnp.int32))


def init_carry(cfg: AgcConfig, complex_input: bool,
               rdtype=jnp.float32) -> AgcCarry:
    zero = jnp.zeros((), rdtype)
    sig_dtype = jax.lax.complex(zero, zero).dtype if complex_input else rdtype
    return AgcCarry(
        sig_delay=complex_zeros(cfg.delay_samples, sig_dtype),
        mag_tail=jnp.full(cfg.window_samples - 1, -16.0, rdtype),
        attack_ave=jnp.asarray(-5.0, rdtype),
        decay_ave=jnp.asarray(-5.0, rdtype),
        hang_timer=jnp.zeros((), jnp.int32))


def _averager_scan(cfg: AgcConfig, p: AgcParams, carry: AgcCarry,
                   peak: jax.Array):
    """Audio-rate scan over the peak sequence producing max(attack, decay)."""

    def step(c, pk):
        a, d, timer = c
        a_alpha = jnp.where(pk > a, p.attack_rise_alpha, p.attack_fall_alpha)
        a_new = (1.0 - a_alpha) * a + a_alpha * pk
        if cfg.use_hang:
            rising = pk > d
            d_rise = (1.0 - p.decay_rise_alpha) * d + p.decay_rise_alpha * pk
            d_fall = (1.0 - p.decay_fall_alpha) * d + p.decay_fall_alpha * pk
            hold = timer < p.hang_time
            d_new = jnp.where(rising, d_rise, jnp.where(hold, d, d_fall))
            timer = jnp.where(rising, 0, jnp.where(hold, timer + 1, timer))
        else:
            d_alpha = jnp.where(pk > d, p.decay_rise_alpha, p.decay_fall_alpha)
            d_new = (1.0 - d_alpha) * d + d_alpha * pk
        return (a_new, d_new, timer), jnp.maximum(a_new, d_new)

    (a, d, timer), mag = lax.scan(
        step, (carry.attack_ave, carry.decay_ave, carry.hang_timer), peak,
        unroll=8)   # fallback path only; ~2x on the scan floor
    return a, d, timer, mag


GUESS_ITERS = 24    # cap on guess-verify rounds (lax.while_loop exits as
                    # soon as the pattern validates — realistic window-peak
                    # series converge in <=4 rounds after the warm start;
                    # each extra round is one log-depth associative scan,
                    # far cheaper than the sequential-scan fallback a
                    # premature exit would cost)


def _shift1(x: jax.Array, x0) -> jax.Array:
    """x[n-1] series: [x0, x[0], ..., x[-2]]."""
    return jnp.concatenate(
        [jnp.broadcast_to(jnp.asarray(x0, x.dtype),
                          x.shape[:-1] + (1,)), x[..., :-1]], axis=-1)


def _two_rate_parallel(rise_alpha, fall_alpha, x0, peak, n_iters):
    """Parallel solve of the two-rate averager
        x[n] = (1-a[n])·x[n-1] + a[n]·pk[n],
        a[n] = rise_alpha if pk[n] > x[n-1] else fall_alpha
    by guess-verify: pick a branch pattern, solve the then-linear
    time-varying recurrence in log depth (associative scan), re-derive the
    pattern from the trajectory, iterate.  Because every fixed-pattern
    trajectory lower-bounds the true one (the true step is the max of the
    two branches — they cross at pk[n], and rise_alpha > fall_alpha makes
    the taken branch the larger), the iteration is monotone non-decreasing
    and its fixed point IS the exact solution.  Returns (trajectory,
    converged) — the caller falls back to the sequential scan when the
    final pattern has not stabilized (same architecture as the FM PLL's
    linear locked-loop solve, ops/pll.py)."""
    # warm start: one solve with the geometric-mean rate as a proxy state —
    # its induced pattern is within ~4 rounds of the fixed point on
    # realistic window-peak series (the naive "input rising" guess needs
    # 6-7)
    ag = jnp.sqrt(rise_alpha * fall_alpha)
    xg = first_order_recurrence(jnp.broadcast_to(1.0 - ag, peak.shape),
                                ag * peak, x0)
    pattern0 = peak > _shift1(xg, x0)

    # loop-invariant products hoisted: each round then costs two selects
    # + the associative solve instead of re-deriving alpha arrays
    rise_b = rise_alpha * peak
    fall_b = fall_alpha * peak
    rise_c = 1.0 - rise_alpha
    fall_c = 1.0 - fall_alpha

    def body(carry):
        pattern, _, _, i = carry
        x = first_order_recurrence(jnp.where(pattern, rise_c, fall_c),
                                   jnp.where(pattern, rise_b, fall_b), x0)
        prev = _shift1(x, x0)
        pattern_new = peak > prev
        # a pattern mismatch is harmless when the branch choice cannot
        # change the stored value: at an exact tie (pk == x[n-1]) both
        # branches produce x[n] = pk, and more generally whenever the two
        # branch updates round to the SAME f32 (near-ties — the COMMON
        # case on window-peak plateaus, where the state sits within an
        # ulp of pk; without this the pattern flips forever between
        # rounding-equivalent branches: 12 rounds observed vs 3 with the
        # forgiveness).  The downstream effect of a forgiven
        # flip is bounded by the same sub-ulp difference through the
        # stable (|A| < 1) composition — inside the documented f32
        # reassociation tolerance of the parallel solve.
        same_val = (rise_c * prev + rise_b == fall_c * prev + fall_b)
        valid = jnp.all((pattern_new == pattern) | (peak == prev)
                        | same_val, axis=-1)
        return pattern_new, x, valid, i + 1

    def not_converged(c):
        return jnp.logical_not(jnp.all(c[2])) & (c[3] < n_iters)

    carry0 = body((pattern0, xg, jnp.asarray(False), jnp.asarray(0)))
    _, x, valid, _ = lax.while_loop(not_converged, body, carry0)
    return x, valid


def _hang_decay_parallel(p: AgcParams, d0, timer0, peak, n_iters):
    """Parallel solve of the hang-mode decay averager: rise fast while
    pk > d, then HOLD for hang_time samples, then release.  The branch
    pattern reduces to the rising flags alone: the hold window is
    `distance since last rise < hang_time` (the timer is exactly
    min(distance, hang_time) — it resets on rise, increments during hold,
    freezes at the cap).

    NOTE: unlike the two-rate solver, exact ties (pk == d[n-1]) canNOT be
    forgiven in the validity check — the branch choice at a tie resets the
    hang TIMER even when the value is unchanged, so a tie mismatch alters
    future hold windows.  The check is therefore EXACT pattern equality.
    Measured r5 (tests/test_ops.py::test_agc_hang_parallel_is_steady_state):
    that strictness does NOT push choppy envelopes onto the scan fallback
    — 0 fallbacks over choppy random walks, hard on/off keying, tie-dense
    quantized plateaus and speech-like AM, because an exact tie resolves
    identically in both pattern derivations (pk > d is False either way;
    there is no branch to flip).  The parallel trajectory tracks the scan
    within f32 associative-solve roundoff (~2e-4 decades = 0.004 dB)."""
    pattern0 = peak > _shift1(peak, d0)

    def body(carry):
        pattern, _, _, _, i = carry
        dist = distance_since_last_true(pattern, timer0)
        timer_prev = _shift1(dist, timer0)
        hold = (~pattern) & (timer_prev < p.hang_time)
        alpha = jnp.where(pattern, p.decay_rise_alpha,
                          jnp.where(hold, jnp.zeros_like(p.decay_fall_alpha),
                                    p.decay_fall_alpha))
        d = first_order_recurrence(1.0 - alpha, alpha * peak, d0)
        pattern_new = peak > _shift1(d, d0)
        valid = jnp.all(pattern_new == pattern, axis=-1)
        return pattern_new, d, dist, valid, i + 1

    zero_d = jnp.zeros_like(peak)
    zero_dist = jnp.zeros(peak.shape, jnp.int32)
    def not_converged(c):
        return jnp.logical_not(jnp.all(c[3])) & (c[4] < n_iters)

    carry0 = body((pattern0, zero_d, zero_dist, jnp.asarray(False),
                   jnp.asarray(0)))
    _, d, dist, valid, _ = lax.while_loop(not_converged, body, carry0)
    timer = jnp.minimum(dist[..., -1], p.hang_time).astype(jnp.int32)
    return d, timer, valid


def _averager_parallel(cfg: AgcConfig, p: AgcParams, carry: AgcCarry,
                       peak: jax.Array):
    """Parallel (log-depth) averagers + per-solve convergence flags."""
    a, a_ok = _two_rate_parallel(p.attack_rise_alpha, p.attack_fall_alpha,
                                 carry.attack_ave, peak, GUESS_ITERS)
    if cfg.use_hang:
        d, timer, d_ok = _hang_decay_parallel(p, carry.decay_ave,
                                              carry.hang_timer, peak,
                                              GUESS_ITERS)
    else:
        d, d_ok = _two_rate_parallel(p.decay_rise_alpha, p.decay_fall_alpha,
                                     carry.decay_ave, peak, GUESS_ITERS)
        timer = carry.hang_timer
    magsel = jnp.maximum(a, d)
    return (a[..., -1], d[..., -1], timer, magsel), a_ok & d_ok


def _averager(cfg: AgcConfig, p: AgcParams, carry: AgcCarry,
              peak: jax.Array):
    """Averagers: parallel solve, exact sequential fallback on the rare
    non-converged block (lax.cond — the scan only executes then)."""
    par, valid = _averager_parallel(cfg, p, carry, peak)

    def take_parallel(_):
        return par

    def run_scan_fallback(_):
        return _averager_scan(cfg, p, carry, peak)

    return lax.cond(valid, take_parallel, run_scan_fallback, None)


def _prefix(cfg: AgcConfig, carry: AgcCarry, x: jax.Array):
    """Delay line, log magnitude, window peak — the fully parallel part."""
    n = x.shape[-1]
    rdtype = jnp.real(x).dtype
    zd = jnp.concatenate([carry.sig_delay, x], axis=-1)
    delayed = zd[..., :n]
    new_sig_delay = zd[..., n:]
    if jnp.iscomplexobj(x):
        inst = jnp.maximum(jnp.abs(x.real), jnp.abs(x.imag))
    else:
        inst = jnp.abs(x)
    mag = jnp.log10(inst + MIN_CONSTANT) - np.log10(MAX_AMPLITUDE)
    mag = mag.astype(rdtype)
    peak, mag_tail = sliding_window_max(mag, cfg.window_samples,
                                        carry.mag_tail)
    return delayed, new_sig_delay, peak, mag_tail


def _apply_gain(params: AgcParams, magsel: jax.Array, delayed: jax.Array):
    rdtype = jnp.real(delayed).dtype
    gain = jnp.where(magsel <= params.knee, params.fixed_gain,
                     AGC_OUTSCALE * 10.0 ** (magsel * (params.gain_slope
                                                       - 1.0)))
    return delayed * gain.astype(rdtype)


def process(cfg: AgcConfig, params: AgcParams, carry: AgcCarry,
            x: jax.Array) -> tuple[AgcCarry, jax.Array]:
    if not cfg.agc_on:
        return carry, params.manual_gain * x

    delayed, new_sig_delay, peak, mag_tail = _prefix(cfg, carry, x)
    a, d, timer, magsel = _averager(cfg, params, carry, peak)
    y = _apply_gain(params, magsel, delayed)
    return AgcCarry(sig_delay=new_sig_delay, mag_tail=mag_tail,
                    attack_ave=a, decay_ave=d, hang_timer=timer), y


def process_batch(cfg: AgcConfig, params: AgcParams, carry: AgcCarry,
                  x: jax.Array) -> tuple[AgcCarry, jax.Array]:
    """AGC over a channel bank (leading channel axis on params/carry/x).

    Equivalent to vmap(process) except convergence of the parallel
    averagers is voted bank-wide so the sequential-scan fallback stays a
    real runtime branch — a vmapped lax.cond lowers to select and would
    execute the scan every step (the same hazard _demod_apply_batch
    handles for the PLL demods, pipeline/receiver.py)."""
    if not cfg.agc_on:
        return carry, params.manual_gain[..., None] * x

    delayed, new_sig_delay, peak, mag_tail = jax.vmap(
        lambda c, xx: _prefix(cfg, c, xx))(carry, x)
    par, valid = jax.vmap(
        lambda p, c, pk: _averager_parallel(cfg, p, c, pk))(
            params, carry, peak)
    def take_parallel(_):
        return par

    def run_scan_fallback(_):
        return jax.vmap(lambda p, c, pk: _averager_scan(cfg, p, c, pk))(
            params, carry, peak)

    a, d, timer, magsel = lax.cond(jnp.all(valid), take_parallel,
                                   run_scan_fallback, None)
    y = jax.vmap(_apply_gain)(params, magsel, delayed)
    return AgcCarry(sig_delay=new_sig_delay, mag_tail=mag_tail,
                    attack_ave=a, decay_ave=d, hang_timer=timer), y
