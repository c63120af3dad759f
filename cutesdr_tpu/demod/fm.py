"""NBFM demodulator with PLL frequency tracker and noise squelch.

Reference analogue: CFmDemod (dsp/fmdemod.cpp): PLL (BW 6 kHz, zeta .707,
±6 kHz range) whose NCO-frequency term *is* the FM audio after removing its
slow DC (one-pole tracked offset); noise squelch measures rectified,
exponentially-averaged noise power above the voice band through an HP FIR,
gates with ±100 hysteresis against a 0..5000 threshold, and either zeroes
the block or lowpasses it with a 3 kHz IIR.

The PLL (+DC tracker) runs in one of two forms, chosen per block on-device:

* **Linear (parallel) form** — the default path while locked.  Writing the
  state as x = [e, f] (phase error, NCO frequency) and psi[n] =
  wrap(theta[n] - theta[n-1]) (the wrapped input phase increments), the
  sequential recurrence is *exactly*

      x[n+1] = A x[n] + [-psi[n+1], 0],   A = [[1-a-b, -1], [b, 1]]

  whenever the phase-detector wrap and the frequency clamp are inactive
  (proved by induction: err[n+1] = -wrap(theta[n+1]+phase[n+1]) equals the
  linear e[n+1] while |e| <= pi).  A is constant with spectral radius
  sqrt(1-a) << 1, so the whole block is a short causal FIR of psi with the
  truncated impulse response A^d — a convolution (fully parallel), not a
  scan.  Validity (max |e| < pi, max |f| <= clamp) is checked from the
  linear solution itself; a violating block falls back to
* **the sequential scan** (lax.cond, so only one branch executes per
  block) — bit-faithful to the reference recurrence during acquisition,
  clamp hits, or squelch-grade noise.

The squelch measurement is fully parallel (FIR + parallel EMA) with a tiny
per-block state machine.  Note: under vmap (channel banks) lax.cond lowers
to select and both branches execute — the bank pays the scan anyway and the
linear path is then only a (small) constant overhead.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from cutesdr_tpu.design.fir_kaiser import design_highpass
from cutesdr_tpu.design.iir_biquad import biquad_lowpass
from cutesdr_tpu.ops import fir, iir
from cutesdr_tpu.ops import pll
from cutesdr_tpu.ops.util import ema
from cutesdr_tpu.types import K_2PI

FMPLL_RANGE = 6000.0
VOICE_BANDWIDTH = 3000.0
FMPLL_BW = VOICE_BANDWIDTH * 2.0
FMPLL_ZETA = 0.707
FMDC_ALPHA = 0.01
MAX_FMOUT = 25000.0
SQUELCH_MAX = 5000.0
SQUELCHAVE_TIMECONST = 0.02
SQUELCH_HYSTERESIS = 100.0


class FmParams(NamedTuple):
    pll_alpha: jax.Array
    pll_beta: jax.Array
    nco_limit: jax.Array
    out_gain: jax.Array
    dc_alpha: jax.Array
    squelch_alpha: jax.Array
    squelch_threshold: jax.Array
    pll_kernel: jax.Array         # [D,2,2] powers A^d of the locked-loop
                                  # state matrix (truncated impulse response)
    hp_fir: fir.FirParams         # noise HP above the voice band
    lp_iir: iir.IirParams         # 3 kHz audio lowpass when squelch open
    deemph_alpha: jax.Array       # one-pole de-emphasis; 1.0 = off (y = x)


class FmCarry(NamedTuple):
    nco_phase: jax.Array
    nco_freq: jax.Array
    freq_error_dc: jax.Array
    squelch_ave: jax.Array
    squelch_on: jax.Array         # bool
    hp_fir: fir.FirCarry
    lp_iir: iir.IirCarry
    deemph: jax.Array             # de-emphasis filter state


def squelch_threshold_from_ui(value: int) -> float:
    """UI 0..99 -> threshold (99 forces permanent squelch, as the
    reference's 'strong signal threshold' special case)."""
    return SQUELCH_MAX - (SQUELCH_MAX * value) / 99.0


def deemphasis_alpha(sample_rate: float, tau_us: float) -> float:
    """One-pole de-emphasis coefficient for a time constant in
    microseconds; 0 (off) maps to alpha = 1 (identity), so toggling is a
    traced-knob update, never a recompile."""
    if tau_us <= 0.0:
        return 1.0
    import numpy as np
    return float(1.0 - np.exp(-1.0 / (sample_rate * tau_us * 1e-6)))


def init(sample_rate: float, squelch_ui_value: int = 0,
         fm_bw: float = VOICE_BANDWIDTH, deemphasis_us: float = 0.0,
         rdtype=jnp.float32) -> tuple[FmParams, FmCarry]:
    norm = K_2PI / sample_rate
    alpha = 2.0 * FMPLL_ZETA * FMPLL_BW * norm
    beta = (alpha * alpha) / (4.0 * FMPLL_ZETA * FMPLL_ZETA)
    limit = FMPLL_RANGE * norm
    kernel = pll.locked_loop_kernel(float(alpha), float(beta))
    hp = design_highpass(1.0, 50.0, fm_bw, fm_bw * 0.6, sample_rate)
    fp, fc = fir.init(hp, rdtype=rdtype)
    ip, ic = iir.init(biquad_lowpass(VOICE_BANDWIDTH, 1.0, sample_rate),
                      rdtype=rdtype)
    r = lambda v: jnp.asarray(v, rdtype)
    params = FmParams(
        pll_alpha=r(alpha), pll_beta=r(beta), nco_limit=r(limit),
        out_gain=r(MAX_FMOUT / limit),
        dc_alpha=r(1.0 - jnp.exp(-1.0 / (sample_rate * FMDC_ALPHA))),
        squelch_alpha=r(1.0 - jnp.exp(-1.0 / (sample_rate * SQUELCHAVE_TIMECONST))),
        squelch_threshold=r(squelch_threshold_from_ui(squelch_ui_value)),
        pll_kernel=r(kernel), hp_fir=fp, lp_iir=ip,
        deemph_alpha=r(deemphasis_alpha(sample_rate, deemphasis_us)))
    carry = FmCarry(
        nco_phase=r(0.0), nco_freq=r(0.0), freq_error_dc=r(0.0),
        squelch_ave=r(0.0), squelch_on=jnp.asarray(True),
        hp_fir=fc, lp_iir=ic, deemph=r(0.0))
    return params, carry


def set_squelch(params: FmParams, ui_value: int) -> FmParams:
    return params._replace(squelch_threshold=jnp.asarray(
        squelch_threshold_from_ui(ui_value), params.squelch_threshold.dtype))


def set_deemphasis(params: FmParams, tau_us: float,
                   sample_rate: float) -> FmParams:
    """Live de-emphasis change (traced-knob update, no recompile).

    BASELINE config 3 names "CFmDemod with de-emphasis"; the reference's
    CFmDemod (dsp/fmdemod.cpp) has NO de-emphasis stage, so this is a
    documented extension — off (tau 0) by default for reference parity.
    Typical NBFM values: 75 us (Americas), 50 us (Europe)."""
    return params._replace(deemph_alpha=jnp.asarray(
        deemphasis_alpha(sample_rate, tau_us), params.deemph_alpha.dtype))


def set_bandwidth(params: FmParams, fm_bw: float, sample_rate: float) -> FmParams:
    """Re-derive the squelch HP filter when the channel filter BW changes.
    Tap count may change -> host-side param update (recompile only if the
    designed length differs from the current one)."""
    hp = design_highpass(1.0, 50.0, fm_bw, fm_bw * 0.6, sample_rate)
    dt = params.hp_fir.taps_i.dtype
    return params._replace(hp_fir=params.hp_fir._replace(
        taps_i=jnp.asarray(hp, dt), taps_q=jnp.asarray(hp, dt)))


def _wrap_pi(e):
    """Wrap radians into (-pi, pi]."""
    return e - K_2PI * jnp.round(e / K_2PI)


def _pll_scan(params: FmParams, carry: FmCarry, theta: jax.Array):
    # The phase detector atan2(x·e^{jφ}) equals wrap(arg(x) + φ), so the
    # per-sample arg(x) vectorizes over the whole block and the
    # serial recurrence is pure arithmetic — ~4× faster than rotating and
    # atan2-ing inside the scan, and numerically equivalent (φ is even
    # wrapped every step instead of once per block as in the reference,
    # dsp/fmdemod.cpp:189).
    def step(c, th):
        phase, freq, dc = c
        err = -_wrap_pi(th + phase)
        freq = jnp.clip(freq + params.pll_beta * err,
                        -params.nco_limit, params.nco_limit)
        phase = _wrap_pi(phase + freq + params.pll_alpha * err)
        dc = (1.0 - params.dc_alpha) * dc + params.dc_alpha * freq
        return (phase, freq, dc), ((freq - dc) * params.out_gain, err)

    (phase, freq, dc), (audio, err) = lax.scan(
        step, (carry.nco_phase, carry.nco_freq, carry.freq_error_dc), theta,
        unroll=8)
    return jnp.mod(phase, K_2PI), freq, dc, audio, err


def _dc_track(params: FmParams, freqs: jax.Array, dc0: jax.Array):
    """DC-tracker EMA evaluated about the block's first frequency sample
    as origin (exact linear identity: shifting x and x0 by a constant
    shifts the EMA by the same constant).  Keeps the f32 state near ZERO
    so its ulp is set by the frequency DEVIATION scale (~0.02 rad/sample)
    rather than the absolute NCO frequency (~0.2 at a 2 kHz offset) —
    measured r5: the absolute-frame f32 EMA was the FM chain's noise
    floor (86 dB; offset frame ~104 dB, equal to computing the tracker
    in f64).  Returns (audio_series, dc_last)."""
    off = freqs[..., :1]
    f_off = freqs - off
    dcs_off = ema(params.dc_alpha, f_off, dc0 - off[..., 0])
    audio = (f_off - dcs_off) * params.out_gain
    return audio, off[..., 0] + dcs_off[..., -1]


PLL_CHUNK = 128
PLL_HALO = 128


def _chunkable(n: int) -> bool:
    """Host-side static gate for the chunked guess-verify scan tier."""
    return n % PLL_CHUNK == 0 and n // PLL_CHUNK >= 4


def _pll_chunked(params: FmParams, carry: FmCarry, theta: jax.Array):
    """Guess-verify parallel evaluation of the *unlocked* loop
    (ops/pll.chunked_scan): the exact sequential recurrence — wrap and
    clamp included — evaluated as C concurrent chunk scans with warmup
    halos and a bitwise boundary check.  The clipped loop re-synchronizes
    from any state within ~40 samples (clamp rails restore freq exactly;
    phase error contracts by 1-alpha), so the check passes on noise —
    the worst case that previously forced the full sequential scan every
    block (dsp/fmdemod.cpp:62-89 is the per-sample serial reference).
    The DC tracker does not feed back into the loop, so it is solved
    afterwards in parallel (ema), like the linear path."""
    def step(state, th):
        phase, freq = state
        err = -_wrap_pi(th + phase)
        freq = jnp.clip(freq + params.pll_beta * err,
                        -params.nco_limit, params.nco_limit)
        phase = _wrap_pi(phase + freq + params.pll_alpha * err)
        return (phase, freq), (freq, err)

    init = (carry.nco_phase, carry.nco_freq)
    valid, (freqs, errs), (phase, freq) = pll.chunked_scan(
        step, init, init, theta, PLL_CHUNK, PLL_HALO)
    audio, dc_last = _dc_track(params, freqs, carry.freq_error_dc)
    return valid, (jnp.mod(phase, K_2PI), freq, dc_last, audio, errs)


def _pll_linear(params: FmParams, carry: FmCarry, theta: jax.Array):
    """Parallel solve of the locked (wrap/clip-free) loop — see module
    docstring for the derivation — plus the validity flag telling whether
    the linearization was exact for this block."""
    e0 = -_wrap_pi(theta[0] + carry.nco_phase)
    psi = _wrap_pi(theta[1:] - theta[:-1])
    u = jnp.concatenate([jnp.zeros((1,), theta.dtype), -psi])
    e, f_next, valid = pll.solve_locked(params.pll_kernel, params.pll_beta,
                                        params.nco_limit, e0,
                                        carry.nco_freq, u)
    audio, dc_last = _dc_track(params, f_next, carry.freq_error_dc)
    phase = jnp.mod(-theta[-1] - e[-1] + f_next[-1] + params.pll_alpha * e[-1],
                    K_2PI)
    return valid, (phase, f_next[-1], dc_last, audio, e)


TIER_LINEAR, TIER_CHUNKED, TIER_SCAN = 0, 1, 2


def _pll(params: FmParams, carry: FmCarry, x: jax.Array):
    """Tiered PLL solve.  Returns (tier, pll_out): tier is an on-device
    int32 telling which tier actually executed this block (0 = parallel
    linear/locked solve, 1 = chunked guess-verify, 2 = sequential scan).
    The tier is exposed through process_probed -> the receiver's
    "pll_tier" probe so a silent always-fallback regression (e.g. the
    chunked tier's bitwise check failing under a compiler change) is
    detectable at runtime — see tests/test_pll_chunked.py."""
    theta = jnp.arctan2(x.imag, x.real)
    valid, linear = _pll_linear(params, carry, theta)

    def take_linear(_):
        return jnp.asarray(TIER_LINEAR, jnp.int32), linear

    def run_scan(_):
        return (jnp.asarray(TIER_SCAN, jnp.int32),
                _pll_scan(params, carry, theta))

    if not _chunkable(theta.shape[-1]):
        return lax.cond(valid, take_linear, run_scan, None)

    def fallback(_):
        cvalid, chunked = _pll_chunked(params, carry, theta)

        def take_chunked(_):
            return jnp.asarray(TIER_CHUNKED, jnp.int32), chunked

        return lax.cond(cvalid, take_chunked, run_scan, None)

    return lax.cond(valid, take_linear, fallback, None)


def _noise_squelch(params: FmParams, carry: FmCarry, audio: jax.Array):
    fc, noise = fir.process_real(params.hp_fir, carry.hp_fir, audio)
    aves = ema(params.squelch_alpha, jnp.abs(noise), carry.squelch_ave)
    ave = aves[-1]

    force = params.squelch_threshold == 0.0
    open_thresh = params.squelch_threshold - SQUELCH_HYSTERESIS
    close_thresh = params.squelch_threshold + SQUELCH_HYSTERESIS
    squelched = jnp.where(
        force, True,
        jnp.where(carry.squelch_on, ave >= open_thresh, ave >= close_thresh))

    ic, lp_audio = iir.process(params.lp_iir, carry.lp_iir, audio)
    # freeze the LP state and zero the audio while squelched
    ic = jax.tree_util.tree_map(
        lambda new, old: jnp.where(squelched, old, new), ic, carry.lp_iir)
    y = jnp.where(squelched, jnp.zeros((), audio.dtype), lp_audio)
    return fc, ic, ave, squelched, y


def _post(params: FmParams, carry: FmCarry, pll_out):
    """Squelch + de-emphasis + carry assembly after the PLL (parallel)."""
    phase, freq, dc, audio, _err = pll_out
    fc, ic, ave, squelched, y = _noise_squelch(params, carry, audio)
    # one-pole de-emphasis (alpha = 1 -> identity = off); a linear
    # recurrence, solved in parallel like every audio-rate one-pole here
    y = ema(params.deemph_alpha, y, carry.deemph)
    return FmCarry(nco_phase=phase, nco_freq=freq, freq_error_dc=dc,
                   squelch_ave=ave, squelch_on=squelched,
                   hp_fir=fc, lp_iir=ic, deemph=y[..., -1]), y


def process(params: FmParams, carry: FmCarry,
            x: jax.Array) -> tuple[FmCarry, jax.Array]:
    _tier, pll_out = _pll(params, carry, x)
    return _post(params, carry, pll_out)


def process_probed(params: FmParams, carry: FmCarry, x: jax.Array):
    """process() + the PLL-internal probe series: the per-sample phase
    error in radians x100 — the reference's ad-hoc PROFILE_6 tap
    (dsp/fmdemod.cpp:120 scales the FM loop internals the same way;
    dsp/samdemod.cpp:92 is the x100 phase-error site) — and the executed
    solver tier (int32, see _pll).  Returns (carry', audio, p6, tier)."""
    tier, pll_out = _pll(params, carry, x)
    c, y = _post(params, carry, pll_out)
    return c, y, pll_out[4] * 100.0, tier


def process_stereo(params: FmParams, carry: FmCarry,
                   x: jax.Array) -> tuple[FmCarry, jax.Array]:
    carry, y = process(params, carry, x)
    return carry, jax.lax.complex(y, y)


def last_tier(params: FmParams, carry: FmCarry, x: jax.Array) -> jax.Array:
    """Solver-tier diagnostic alone (0/1/2, see _pll) for a block —
    the ADVICE-r4 visibility hook for the chunked tier's liveness."""
    tier, _ = _pll(params, carry, x)
    return tier


def process_batch(params: FmParams, carry: FmCarry,
                  x: jax.Array) -> tuple[FmCarry, jax.Array]:
    """Channel-bank form: params/carry/x carry a leading channel axis.

    Under plain vmap the per-channel lax.cond in _pll lowers to select, so
    every bank step pays the sequential scan even when all channels are
    locked.  Here the validity vote is taken across the whole bank *outside*
    vmap: one real lax.cond picks the parallel linear solve for the entire
    bank when every channel's linearization is exact, and falls back to the
    (vmapped) scan otherwise.

    Caveats of the all-channel vote:

    * The fallback is *numerically equivalent* per channel (roundoff-level —
      linear solve and scan differ in float rounding), not bit-identical to
      the per-channel ``process()``; and *which* path a locked channel takes
      depends on the other channels' lock state, so bank output is only
      reproducible given the same whole-bank input.
    * A bank with even one persistently-unlocked channel (e.g. a squelched
      monitor slot with pure noise) takes the scan every block, and the
      linear solve is still computed and discarded — the vote helps banks
      that are mostly locked, and costs a small constant otherwise.
      Measured on a realistic mixed-lock bank before relying on the speedup
      (tests/test_bank.py exercises both paths).
    """
    theta = jnp.arctan2(x.imag, x.real)
    valid, linear = jax.vmap(_pll_linear)(params, carry, theta)
    if _chunkable(theta.shape[-1]):
        def scan_fallback(_):
            cvalid, chunked = jax.vmap(_pll_chunked)(params, carry, theta)
            return lax.cond(jnp.all(cvalid),
                            lambda _: chunked,
                            lambda _: jax.vmap(_pll_scan)(params, carry, theta),
                            None)
    else:
        def scan_fallback(_):
            return jax.vmap(_pll_scan)(params, carry, theta)
    pll_out = lax.cond(jnp.all(valid), lambda _: linear, scan_fallback, None)
    return jax.vmap(_post)(params, carry, pll_out)


def process_batch_stereo(params: FmParams, carry: FmCarry,
                         x: jax.Array) -> tuple[FmCarry, jax.Array]:
    carry, y = process_batch(params, carry, x)
    return carry, jax.lax.complex(y, y)
