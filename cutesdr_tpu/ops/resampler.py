"""Arbitrary-ratio fractional resampler (windowed-sinc interpolation).

Reference analogue: CFractResampler (dsp/fractresampler.cpp): a 28-period
Blackman-Harris windowed sinc table at 10,000 points per zero crossing; each
output sample convolves 28 input taps selected by a floating-point time
accumulator, which carries fractional phase across blocks.

Design: all output timestamps for a block are computed at once
(t_k = t0 + k·dt); chunks of 64 consecutive outputs share one lane-aligned
input window (the only gather) and every windowed-sinc tap weight is
evaluated analytically in place via a separable closed form of the table
entry (_sinc_band — the naive per-tap window + table gathers were the
chain's dominant stage).  The output
count per block is data-dependent in the reference (while-loop); here the
block yields a *static* ``max_out`` with a validity count, so shapes stay
static under jit — callers consume ``n_valid`` samples.

Numerics: timestamps use an exact split-precision scheme (dt = dt_hi + dt_lo
with dt_hi a multiple of 2^-12 so k·dt_hi is exact in float32) giving ~1e-7
fractional-phase accuracy without float64 — see _times().
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cutesdr_tpu.design.windows import window_table
from cutesdr_tpu.types import K_PI, complex_zeros

SINC_PERIOD_PTS = 10000
SINC_PERIODS = 28            # reference-exact default (fractresampler.cpp:50)
SINC_LENGTH = SINC_PERIODS * SINC_PERIOD_PTS + 1
MAX_SOUNDCARDVAL = 32767.0

_DT_SPLIT = 4096.0   # dt_hi quantum 2^-12


def make_sinc_table(rdtype=np.float32,
                    periods: int = SINC_PERIODS) -> np.ndarray:
    """Blackman-Harris windowed sinc, identical formula to the reference
    table builder (dsp/fractresampler.cpp:101-114).  ``periods`` > 28
    raises the method's SNR ceiling beyond the reference's (the window gets
    longer, so its transition region narrows and the interpolation images
    drop); 28 reproduces the reference table exactly."""
    length = periods * SINC_PERIOD_PTS + 1
    i = np.arange(length, dtype=np.float64)
    window = window_table("blackman_harris", length)
    fi = K_PI * (i - length // 2) / SINC_PERIOD_PTS
    with np.errstate(invalid="ignore", divide="ignore"):
        s = window * np.sin(fi) / fi
    s[length // 2] = 1.0
    return s.astype(rdtype)


class ResamplerParams(NamedTuple):
    # tap weights are computed in closed form (_sinc_band) — no table is
    # carried; the static tap count lives in carry.tail's shape
    dt_hi: jax.Array     # rate split: dt = in_rate/out_rate = dt_hi + dt_lo
    dt_lo: jax.Array


class ResamplerCarry(NamedTuple):
    tail: jax.Array      # [SINC_PERIODS] input history
    t0: jax.Array        # fractional time offset in [0, dt)


def split_rate(rate: float) -> tuple[np.float32, np.float32]:
    hi = np.round(rate * _DT_SPLIT) / _DT_SPLIT
    return np.float32(hi), np.float32(rate - hi)


def init(rate: float, complex_input: bool = False, rdtype=jnp.float32,
         periods: int = SINC_PERIODS) -> tuple[ResamplerParams, ResamplerCarry]:
    hi, lo = split_rate(rate)
    zero = jnp.zeros((), rdtype)
    tdtype = jax.lax.complex(zero, zero).dtype if complex_input else rdtype
    return (ResamplerParams(dt_hi=jnp.asarray(hi, rdtype),
                            dt_lo=jnp.asarray(lo, rdtype)),
            ResamplerCarry(tail=complex_zeros(periods, tdtype),
                           t0=jnp.zeros((), rdtype)))


def set_rate(params: ResamplerParams, rate: float) -> ResamplerParams:
    """Update the resample ratio (e.g. from the audio rate-lock loop);
    traced-scalar update, no recompile."""
    hi, lo = split_rate(rate)
    return params._replace(dt_hi=jnp.asarray(hi, params.dt_hi.dtype),
                           dt_lo=jnp.asarray(lo, params.dt_lo.dtype))


def max_out_for(block_len: int, nominal_rate: float) -> int:
    """Static per-block output capacity with margin for rate corrections.

    The audio rate-lock's P controller can swing the ratio by up to
    ±queue_half·P_GAIN ≈ ±0.2% (interface/soundout.cpp:456-462), so the
    margin must exceed that or peak corrections would silently drop
    samples against the static output shape."""
    return int(np.ceil(block_len / (nominal_rate * 0.996))) + 4


def rational_for(in_rate: float, out_rate: float, max_den: int = 512,
                 max_num: int = 2048) -> tuple[int, int] | None:
    """(p, q) with in_rate/out_rate == p/q exactly (reduced), else None.

    Every decimation-plan output rate is in_rate/2^k, so the common audio
    targets make small exact fractions (62500/48000 = 125/96 on the
    flagship; 78125/48000 = 625/384 at 20 MSPS) — the structural hook for
    the static-polyphase fast path below.  q == 1 (integer ratio) is
    excluded (the group algebra below assumes q >= 2; it would also mean
    a pure decimation no real config hits)."""
    if out_rate <= 0 or in_rate <= 0:
        return None
    fr = Fraction(in_rate / out_rate).limit_denominator(max_den)
    if fr.numerator <= 0 or fr.numerator > max_num or fr.denominator < 2:
        return None
    if abs(float(fr) - in_rate / out_rate) > 1e-12 * float(fr):
        return None
    return int(fr.numerator), int(fr.denominator)


def _sinc_np(v: np.ndarray, periods: int) -> np.ndarray:
    """f64 windowed-sinc weight f(v), the same closed form as _sinc_value
    (= the reference table entry at index v*10000), vectorized in numpy
    for static weight construction."""
    v = np.asarray(v, np.float64)
    inside = (v > 0) & (v <= periods)
    w = np.zeros_like(v)
    for kk, a in enumerate(_BH_COEFS):
        w = w + ((-1.0) ** kk) * a * np.cos((2.0 * np.pi * kk / periods) * v)
    fi = np.pi * (v - periods / 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(np.abs(fi) < 1e-9, 1.0, np.sin(fi) / fi)
    return np.where(inside, w * s, 0.0)


@functools.lru_cache(maxsize=16)
def _rational_weights(p: int, q: int, periods: int, interp: bool):
    """Static polyphase tap bank for ratio dt = p/q.

    Conv-stream output u = q*k + p' sits at time t = p*k + b(p') + nu/q
    with b = (p*p')//q, nu = (p*p') mod q; its ``periods`` taps read
    input offsets w = b+1 .. b+periods of the window starting at p*k.
    rhs[p', w] holds f(w - b - nu/q) evaluated in f64 (exact phases —
    better than the banded path's f32 phase assembly); interp=False
    applies the reference's truncating 10,000-pt grid to the exact
    position first."""
    pp = np.arange(q)
    b = (p * pp) // q
    nu = (p * pp) % q
    W = int(b.max()) + periods + 1
    rhs = np.zeros((q, W), np.float64)
    j = np.arange(1, periods + 1)
    for c in range(q):
        v = j - nu[c] / q
        if not interp:
            v = np.floor(v * SINC_PERIOD_PTS) / SINC_PERIOD_PTS
        rhs[c, b[c] + 1:b[c] + periods + 1] = _sinc_np(v, periods)
    return rhs, W


def _rational_process(p: int, q: int, params: ResamplerParams,
                      carry: ResamplerCarry, x: jax.Array, max_out: int,
                      interp: bool):
    """Exact-rational resample: ONE static-weight strided convolution.

    When the traced ratio equals the nominal p/q (the rate-lock
    correction is zero — bench, file output, serve before the P loop
    engages), all output phases live on the /q grid: only q distinct
    fractional phases exist, their windowed-sinc taps are STATIC, and
    the whole block is a stride-p VALID conv with q output channels —
    replacing the banded evaluator's ~M-per-output closed-form weight
    evaluation (256 evals/output on the flagship) with ~periods
    MACs/output.

    Integer bookkeeping: position numerator N(o) = num0 + p*o with
    num0 = round(t0*q) (t0 always sits on the /q grid in steady state;
    after a corr!=0 episode the snap is <= 1/(2q) sample, once).  Group
    alignment: output o maps to conv-stream index u = o + u0 with the
    input shifted sigma samples, where u0 = num0*inv(p mod q) mod q
    and sigma = (p*u0 - num0)/q — both integers by construction."""
    n = x.shape[-1]
    periods = carry.tail.shape[-1]
    rdtype = params.dt_hi.dtype
    rhs_np, W = _rational_weights(p, q, periods, interp)
    inv = pow(p % q, -1, q)

    num0 = jnp.round(carry.t0 * q).astype(jnp.int32)        # [0, p]
    u0 = (num0 * inv) % q           # p*u0 == num0 (mod q)
    sigma = (p * u0 - num0) // q                             # [0, p)

    K = -(-((q - 1) + max_out) // q) + 1                     # conv groups
    Lc = p * (K - 1) + W
    # stream position t indexes the TAIL-PREFIXED z (z[i] = x[i - P]):
    # output at time t reads z[t+1 .. t+P] — exactly the banded path's
    # convention (support = x[t-P+1 .. t], the P-sample history window)
    pad_front = p                  # zfull[phi] = z[phi - p]
    pad_right = max(0, Lc - n) + p
    start = pad_front - sigma      # lhs[i] = z[i - sigma]
    rhs = jnp.asarray(rhs_np, x.real.dtype if jnp.iscomplexobj(x)
                      else x.dtype)

    def conv1(vec):
        zfull = jnp.concatenate([
            jnp.zeros((p,), vec.dtype), vec,
            jnp.zeros((pad_right,), vec.dtype)])
        lhs = lax.dynamic_slice(zfull, (start,), (Lc,))
        # NCW output + explicit transpose to time order ([q, K] -> [K, q]
        # -> flat)
        out = lax.conv_general_dilated(
            lhs[None, None, :], rhs[:, None, :],
            window_strides=(p,), padding="VALID",
            dimension_numbers=("NCW", "OIW", "NCW"),
            precision=jax.lax.Precision.HIGHEST)             # [1, q, K]
        flat = out[0].T.reshape(-1)                          # time order
        return lax.dynamic_slice(flat, (u0,), (max_out,))

    z = jnp.concatenate([carry.tail, x], axis=-1)
    if jnp.iscomplexobj(x):
        y = jax.lax.complex(conv1(z.real), conv1(z.imag)).astype(x.dtype)
    else:
        y = conv1(z).astype(x.dtype)

    o = jnp.arange(max_out, dtype=jnp.int32)
    valid = (num0 + p * o) // q < n
    y = jnp.where(valid, y, jnp.zeros((), y.dtype))
    n_valid = jnp.sum(valid.astype(jnp.int32))
    num_new = num0 + p * n_valid - q * n                     # [0, p)
    t0_new = num_new.astype(rdtype) / q
    return (ResamplerCarry(tail=z[..., z.shape[-1] - periods:],
                           t0=t0_new),
            y, n_valid)


_CHUNK = 64          # outputs per banded chunk (see process docstring)

# Blackman-Harris 4-term coefficients (design/windows.py _WINDOWS table)
_BH_COEFS = (0.35875, 0.48829, 0.14128, 0.01168)


def _sinc_value(v: jax.Array, periods: int, interp: bool) -> jax.Array:
    """The windowed-sinc tap weight at position ``v`` (periods units,
    support (0, periods]) evaluated ANALYTICALLY — the closed form of the
    reference's table entry at index v·10000 (make_sinc_table):

        f(v) = [Σ_k (−1)^k a_k cos(2πkv/periods · ... )] · sin(π(v−P/2))/(π(v−P/2))

    with the window's cos(2πk·i/(L−1)) reducing to cos(2πk·v/periods).
    ``interp=False`` quantizes v to the table's 10,000-points-per-period
    grid first (the reference's truncating lookup, bit-close to the f64
    table within f32 rounding); ``interp=True`` evaluates at the exact
    position — strictly better than the table's linear interpolation.

    Why analytic: a table lookup is a 5-6M-element gather per block on the
    flagship config; the closed form is elementwise arithmetic.  Zero
    outside (0, periods] — callers rely on this for the banded form."""
    rdtype = v.dtype
    if not interp:
        v = jnp.floor(v * SINC_PERIOD_PTS) / SINC_PERIOD_PTS
    inside = (v > 0) & (v <= periods)
    vs = jnp.where(inside, v, jnp.asarray(periods / 2, rdtype))
    w = jnp.zeros_like(vs)
    for kk, a in enumerate(_BH_COEFS):
        w = w + ((-1.0) ** kk) * a * jnp.cos(
            (2.0 * np.pi * kk / periods) * vs)
    fi = np.float32(K_PI) * (vs - periods / 2)
    s = jnp.where(jnp.abs(fi) < 1e-5, 1.0, jnp.sin(fi) / fi)
    # center guard: exactly 1.0·w(center)=1.0 like the table's patched point
    return jnp.where(inside, w * s, jnp.zeros_like(vs))


def _sinc_band(Ti: jax.Array, tf: jax.Array, m: np.ndarray,
               periods: int, parts: str = "full") -> jax.Array:
    """Windowed-sinc weights over a whole band: sv[..., m] = f(m - T[...])
    with T = Ti + tf and f as in _sinc_value, but evaluated SEPARABLY so
    the inner [..., M] loop is pure multiply-add:

      * sin(pi*(v - P/2)) with v = m - T and integer m reduces to
        -(-1)^(m + round(T)) * sin(pi*(T - round(T))) — ONE well-reduced
        sine per output (argument in [-pi/2, pi/2], no cancellation at the
        tap center);
      * each Blackman-Harris term cos(2*pi*k*(m-T)/P) splits into
        cos_km*cos_kT + sin_km*sin_kT with the per-m factors precomputed
        static — a rank-8 outer product.

    ~10 transcendentals per OUTPUT instead of ~10 per (output, band)
    element: the weight evaluation drops from ~130M to ~2M transcendental
    calls per flagship block.

    The position comes in EXACTLY DECOMPOSED — ``Ti`` int32 whole samples,
    ``tf`` fractional in [0, 1) — and is never reassembled into one float:
    row-aligned band bases push Ti to a few hundred, where the f32
    representation of Ti + tf would round the tap position by ~1e-5 of a
    period and cost ~10 dB against the reference binary's f64 table
    (test_resampler_matches_reference_binary).  Integer arithmetic gives
    the parity and the window phase exactly; the only float subtraction,
    (m - P/2 - Ti) - tf, has an exact integer minuend.  Truncating-table
    mode is the CALLER quantizing tf to the 10,000-pt grid first."""
    rdtype = tf.dtype
    mf = m.astype(np.float64)
    assert periods % 2 == 0, "separable band form needs even periods"

    w = None
    if parts in ("full", "window"):
        TP = (Ti % periods).astype(rdtype) + tf       # T mod P, exact
        w = jnp.full(tf.shape + (len(m),), _BH_COEFS[0], rdtype)
        for kk in (1, 2, 3):
            a = ((-1.0) ** kk) * _BH_COEFS[kk]
            ang_m = 2.0 * np.pi * kk * mf / periods
            # a_k folded into the STATIC per-m factors: the inner [..., M]
            # update is two pure FMAs instead of FMA + a broadcast a*
            # multiply (the band is ~51M elements/flagship block, so every
            # per-element op counts)
            cm = jnp.asarray((a * np.cos(ang_m)).astype(np.float32), rdtype)
            sm = jnp.asarray((a * np.sin(ang_m)).astype(np.float32), rdtype)
            ang_T = (2.0 * np.pi * kk / periods) * TP
            w = w + (jnp.cos(ang_T)[..., None] * cm
                     + jnp.sin(ang_T)[..., None] * sm)

    # (m - P/2 - Ti) - tf in ONE float subtraction from an exact integer
    # minuend: reassembling T first (or subtracting P/2 after) double-
    # rounds and loses ~3 decades of accuracy on the near-center taps
    im = jnp.asarray(m - periods // 2, jnp.int32) - Ti[..., None]
    vc = im.astype(rdtype) - tf[..., None]
    fi = np.float32(K_PI) * vc
    inside = (vc > -(periods / 2)) & (vc <= periods / 2)
    if parts == "window":
        return jnp.where(inside, w, jnp.zeros_like(w))

    rf = jnp.round(tf)
    r = tf - rf                                       # [-0.5, 0.5], exact
    sin_r = jnp.sin(np.float32(K_PI) * r)
    # numer(m) = sin(pi*(m - T - P/2)) = -(-1)^(m + n + P/2) * sin(pi*r)
    # with n = round(T) = Ti + round(tf) (P even; the extra (-1)^(P/2)
    # matters when P/2 is odd, e.g. P=30) — parity as a sign outer product
    n_round = Ti + rf.astype(jnp.int32)
    par_T = (1 - 2 * (n_round % 2)).astype(rdtype)    # (-1)^round(T)
    sign_m = jnp.asarray(
        np.where((m + periods // 2) % 2 == 0, -1.0, 1.0), rdtype)
    numer = (par_T * sin_r)[..., None] * sign_m       # [..., M]

    if parts == "sinc":
        w = jnp.ones_like(vc)
    small = jnp.abs(fi) < 1e-4                        # sin(fi)/fi -> 1
    s = jnp.where(small, w, w * numer / jnp.where(small, 1.0, fi))
    return jnp.where(inside, s, jnp.zeros_like(s))


_K_SPLIT = 2048.0    # two-level split of k (see _times)


def _times(params: ResamplerParams, t0, k):
    """Exact-ish (t_int, t_frac) of t_k = t0 + k*dt.

    k*dt_hi is computed in TWO exact pieces (r5 fix): the single product
    is only exact for k < 2^11 (dt_hi is a multiple of 2^-12, so the
    product must stay under 2^24 quanta) — at the flagship's 202k
    outputs/block the one-product form had fractional-phase errors up to
    ~2^-7 of a sample and the production resampler measured 46 dB SINAD
    (137 dB at 4 k blocks; tests/test_ops.py::test_resampler_large_block_snr
    pins the fix).  Split k = k_hi*2048 + k_lo: a1 = k_hi*(2048*dt_hi)
    (2048*dt_hi is exact with 2^-1 quanta; product < 2^24 half-quanta for
    any realistic block) and a2 = k_lo*dt_hi (exact, < 2^24 quanta); take
    frac() of each exactly, then combine.  b = t0 + k*dt_lo: |dt_lo| <=
    2^-13, so even at 202k outputs |b| <= ~25 and its f32 rounding is
    ~2e-6 of a sample (~-110 dB, below the f32 weight noise)."""
    a1 = jnp.floor(k / _K_SPLIT) * (_K_SPLIT * params.dt_hi)
    a2 = (k - jnp.floor(k / _K_SPLIT) * _K_SPLIT) * params.dt_hi
    b = t0 + k * params.dt_lo
    i1 = jnp.floor(a1)
    i2 = jnp.floor(a2)
    ftot = (a1 - i1) + (a2 - i2) + b
    f_int = jnp.floor(ftot)
    return (i1 + i2 + f_int).astype(jnp.int32), ftot - f_int


def process(params: ResamplerParams, carry: ResamplerCarry, x: jax.Array,
            max_out: int,
            interp: bool = False,
            _stage: str = "full",
            rational: tuple[int, int] | None = None,
            ) -> tuple[ResamplerCarry, jax.Array, jax.Array]:
    """Resample one block.

    ``rational``: the exact nominal ratio (p, q) from ``rational_for``,
    or None.  When given, a runtime ``lax.cond`` takes the static-
    polyphase conv fast path (_rational_process) whenever the traced
    ratio equals the nominal — the zero-correction steady state — and
    the banded evaluator otherwise (rate-lock corrections, arbitrary
    ratios).  Pass it only from non-vmapped call sites: under vmap the
    cond lowers to select and BOTH paths would execute every block
    (pipeline/receiver passes it from the single-stream tail only,
    like the scan1 fast= flags).
    """
    if rational is not None and _stage == "full" and \
            carry.tail.shape[-1] % 2 == 0 \
            and rational[0] * (max_out + 1) < 2**31 \
            and rational[1] * (x.shape[-1] + 1) < 2**31:
        # the int32 phase numerators p*o and q*n must not overflow; real
        # configs sit ~15x under the bound (125*202k, 96*262k)
        p, q = rational
        nom_hi, nom_lo = split_rate(p / q)
        pred = ((params.dt_hi == jnp.asarray(nom_hi, params.dt_hi.dtype))
                & (params.dt_lo == jnp.asarray(nom_lo, params.dt_lo.dtype)))
        return lax.cond(
            pred,
            lambda a: _rational_process(p, q, a[0], a[1], a[2], max_out,
                                        interp),
            lambda a: _banded_process(a[0], a[1], a[2], max_out, interp,
                                      "full"),
            (params, carry, x))
    return _banded_process(params, carry, x, max_out, interp, _stage)


def _banded_process(params: ResamplerParams, carry: ResamplerCarry,
                    x: jax.Array, max_out: int, interp: bool = False,
                    _stage: str = "full",
                    ) -> tuple[ResamplerCarry, jax.Array, jax.Array]:
    """Arbitrary-ratio banded evaluator (the general path).

    Returns (carry', y[max_out], n_valid).  y[k] for k >= n_valid is zero.

    ``interp=False`` reproduces the reference's truncating table lookup
    (positions quantized to the 10,000-pt grid); ``interp=True`` evaluates
    the windowed sinc at the exact position (better than the table's
    linear interpolation).  Weights come from ``_sinc_value``'s closed
    form, not a table gather — tests/test_ops.py::test_resampler_long_sinc_snr
    measures the combined effect.

    The tap count is derived from ``carry.tail``, so one compiled program
    per sinc length (static shape).

    ``_stage`` (ablation instrumentation, bench_resamp_ablation — NOT a
    production knob): 'gather' stops after the row-gathered windows
    (weights replaced by a constant), 'window' evaluates only the
    Blackman-Harris term, 'sinc' only the sine/reciprocal term, 'full'
    (production) everything.
    """
    n = x.shape[-1]
    periods = carry.tail.shape[-1]
    rdtype = params.dt_hi.dtype

    # banded chunked evaluation: C consecutive outputs share one M-sample
    # input window and every tap weight is computed analytically in place
    # (_sinc_value/_sinc_band).  Chunk bases are rounded DOWN to a
    # 128-lane row boundary so the window fetch is a gather of whole
    # rows of the lane-major reshape — ~n_chunks·M/128 contiguous
    # 128-wide slices instead of n_chunks·M single elements (the
    # misalignment is absorbed by widening the coefficient band by one
    # row).  M is static,
    # sized for the nominal ratio implied by (n, max_out) plus the rate
    # lock's ±0.2% swing plus the row-alignment slack.
    C = _CHUNK
    max_out_p = -(-max_out // C) * C
    n_chunks = max_out_p // C
    dt_max = 1.0062 * n / max(1.0, max_out - 5.0)
    M = int(np.ceil(C * dt_max)) + periods + 4 + 128
    M = -(-M // 128) * 128                       # lane-align the band

    k = jnp.arange(max_out_p, dtype=rdtype)
    t_int, t_frac = _times(params, carry.t0, k)            # [max_out_p]
    valid = t_int[:max_out] < n

    z = jnp.concatenate([carry.tail, x], axis=-1)          # z[m] = x[m-P]
    nrows = -(-z.shape[-1] // 128)
    # edge-pad to whole rows: matches the old element-clip semantics for
    # windows that run past the end (their outputs are invalid anyway)
    zpad = jnp.concatenate(
        [z, jnp.broadcast_to(z[..., -1:],
                             z.shape[:-1] + (nrows * 128 - z.shape[-1],))],
        axis=-1)
    z2 = zpad.reshape(z.shape[:-1] + (nrows, 128))
    b0 = (jnp.clip(t_int[::C], 0, None) // 128) * 128      # [n_chunks]
    ridx = jnp.clip(b0[:, None] // 128 + jnp.arange(M // 128)[None, :],
                    0, nrows - 1)                          # [nc, M/128]
    zc = z2[..., ridx, :].reshape(                         # row gather
        z.shape[:-1] + (n_chunks, M))

    idx_local = t_int.reshape(n_chunks, C) - b0[:, None]   # [nc, C]
    tf = t_frac.reshape(n_chunks, C)
    if not interp:
        # truncating-table semantics: quantize the position to the
        # 10,000-pt grid ONCE per output (floor(v*PTS) with integer
        # m - t_int is exactly -ceil(T*PTS), so one ceil covers every
        # tap).  The decision is evaluated at the CHUNK-LOCAL offset
        # (t_int - first t_int of the chunk, <= ~90), not the row-aligned
        # band offset: the f32 product there sits within half an ulp
        # (~0.03 grid units) of the f64 table index the reference binary
        # computes, which is what keeps the grid DECISIONS aligned with
        # the fixture (120 dB; deciding at the ~2e5-grid-unit band offset
        # costs ~10 dB of decision flips,
        # test_resampler_matches_reference_binary).
        offs = (t_int.reshape(n_chunks, C)
                - jnp.clip(t_int[::C], 0, None)[:, None]).astype(rdtype)
        q = jnp.ceil((offs + tf) * SINC_PERIOD_PTS)
        tf = (q - offs * SINC_PERIOD_PTS) / SINC_PERIOD_PTS
    # tap position v = m - T with T the output's local time; weight
    # nonzero only for v in (0, periods] — exactly the reference's 28
    # taps per output (separable evaluation, see _sinc_band; odd tap
    # counts fall back to the direct per-element closed form)
    # the evaluators get the position exactly decomposed (int32 whole
    # samples + fractional part, already grid-quantized when not interp)
    # and run in exact mode — see _sinc_band's accuracy note
    if _stage == "gather":
        # ablation: weights replaced by a broadcast constant so only the
        # timestamp math + row gather + reduce remain
        sv = jnp.broadcast_to(jnp.float32(1.0 / M), idx_local.shape + (M,))
    elif periods % 2 == 0:
        sv = _sinc_band(idx_local, tf, np.arange(M), periods,
                        parts={"full": "full", "window": "window",
                               "sinc": "sinc"}[_stage])   # [nc, C, M]
    else:
        v = (jnp.asarray(np.arange(M), jnp.int32)
             - idx_local[..., None]).astype(rdtype) - tf[..., None]
        sv = _sinc_value(v, periods, True)

    # elementwise multiply+reduce, not a dot: an f32 dot at default
    # precision may use reduced-precision multiplies, which would cap the
    # resampler's ~100 dB SINAD at ~40 dB
    if jnp.iscomplexobj(x):
        y = (jnp.sum(sv * zc.real[:, None, :], axis=-1)
             + 1j * jnp.sum(sv * zc.imag[:, None, :], axis=-1)).astype(x.dtype)
    else:
        y = jnp.sum(sv * zc[:, None, :], axis=-1).astype(x.dtype)
    y = y.reshape(max_out_p)[:max_out]
    y = jnp.where(valid, y, jnp.zeros((), y.dtype))
    n_valid = jnp.sum(valid.astype(jnp.int32))

    # t0' = t0 + n_valid*dt - n, via the same two-level exact split as
    # _times (the one-product form rounded at ~0.015 samples per block
    # at flagship counts — a per-block phase JUMP, the dominant term of
    # the 46 dB large-block regression the r5 fix removes)
    cnt = n_valid.astype(rdtype)
    a1 = jnp.floor(cnt / _K_SPLIT) * (_K_SPLIT * params.dt_hi)
    a2 = (cnt - jnp.floor(cnt / _K_SPLIT) * _K_SPLIT) * params.dt_hi
    i1 = jnp.floor(a1)
    i2 = jnp.floor(a2)
    t0_new = (((i1 + i2) - n) + ((a1 - i1) + (a2 - i2))
              + (carry.t0 + cnt * params.dt_lo))
    return (ResamplerCarry(tail=z[..., z.shape[-1] - periods:],
                           t0=t0_new),
            y, n_valid)


def to_int16(y: jax.Array, gain, stereo: bool = False) -> jax.Array:
    """Gain + clip + int16 quantize (soundcard format).  Complex input with
    ``stereo`` maps re->left, im->right; real input gives mono."""
    if jnp.iscomplexobj(y):
        g = jnp.stack([y.real, y.imag], axis=-1) * gain
    else:
        g = y * gain
    g = jnp.clip(g, -MAX_SOUNDCARDVAL, MAX_SOUNDCARDVAL)
    return g.astype(jnp.int16)
