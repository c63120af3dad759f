"""Op-level tests: each vectorized op vs its per-sample oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracles
from cutesdr_tpu.design import plan_decimation
from cutesdr_tpu.design.fastfir_design import design_fastfir
from cutesdr_tpu.design.fir_kaiser import design_lowpass, hilbert_bandpass
from cutesdr_tpu.design.iir_biquad import biquad_lowpass
from cutesdr_tpu.ops import (agc, decimator, fastfir, fir, iir, nco,
                             noiseblanker, resampler, smeter)
from cutesdr_tpu.ops.util import (ema, first_order_recurrence, moving_sum,
                                  sliding_window_max)
from cutesdr_tpu.testbench.generators import tone

F64 = jnp.float64
C128 = jnp.complex128


def run_blocks(fn, carry, x, nblocks):
    """Push x through fn in nblocks equal chunks, concatenating outputs."""
    outs = []
    for blk in np.split(x, nblocks):
        carry, y = fn(carry, jnp.asarray(blk))
        outs.append(np.asarray(y))
    return carry, np.concatenate(outs)


# ------------------------------------------------------------------- util --

def test_first_order_recurrence_matches_loop(rng):
    x = rng.standard_normal(257)
    got = np.asarray(first_order_recurrence(0.97, jnp.asarray(x), 0.5))
    want = np.empty_like(x)
    s = 0.5
    for i, v in enumerate(x):
        s = 0.97 * s + v
        want[i] = s
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_ema_matches_loop(rng):
    x = rng.standard_normal(100)
    got = np.asarray(ema(0.125, jnp.asarray(x), -2.0))
    s = -2.0
    for i, v in enumerate(x):
        s = 0.875 * s + 0.125 * v
        assert np.isclose(got[i], s, rtol=1e-9)


def test_sliding_window_max(rng):
    x = rng.standard_normal(200)
    tail = np.full(7, -10.0)
    got, new_tail = sliding_window_max(jnp.asarray(x), 8, jnp.asarray(tail))
    z = np.concatenate([tail, x])
    want = np.array([z[i:i + 8].max() for i in range(200)])
    np.testing.assert_allclose(np.asarray(got), want)
    np.testing.assert_allclose(np.asarray(new_tail), x[-7:])


def test_moving_sum(rng):
    x = rng.standard_normal(150)
    tail = rng.standard_normal(9)
    got, _ = moving_sum(jnp.asarray(x), 10, jnp.asarray(tail))
    z = np.concatenate([tail, x])
    want = np.array([z[i:i + 10].sum() for i in range(150)])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9)


# -------------------------------------------------------------------- nco --

def test_nco_tone_shift():
    fs = 100_000.0
    f0 = 12_345.0
    x = tone(4096, f0, fs)
    p, c = nco.init(f0, fs)
    c, y = nco.process(p, c, jnp.asarray(x, C128))
    y = np.asarray(y)
    # tone should land at DC: nearly constant complex value
    assert np.std(np.abs(y)) < 1e-6 * np.mean(np.abs(y))
    ang = np.unwrap(np.angle(y))
    drift = np.abs(ang[-1] - ang[0])
    assert drift < 0.05   # < fs/2^32 resolution over the block


def test_nco_block_split_invariance():
    fs = 1e6
    p, c1 = nco.init(123_456.7, fs)
    x = tone(8192, 0.0, fs)
    _, y_full = nco.process(p, c1, jnp.asarray(x, C128))
    _, c2 = nco.init(123_456.7, fs)
    c2, y_a = nco.process(p, c2, jnp.asarray(x[:4096], C128))
    c2, y_b = nco.process(p, c2, jnp.asarray(x[4096:], C128))
    np.testing.assert_allclose(np.asarray(y_full),
                               np.concatenate([y_a, y_b]), atol=1e-6)


# -------------------------------------------------------------------- fir --

def test_fir_real_matches_oracle(rng):
    taps = design_lowpass(1.0, 50.0, 3000.0, 4000.0, 48000.0)
    x = rng.standard_normal(512)
    p, c = fir.init(taps, rdtype=F64)
    _, got = run_blocks(lambda c, b: fir.process_real(p, c, b), c, x, 4)
    want = oracles.FirOracle(taps).real(x)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_fir_complex_hilbert_matches_oracle(rng):
    lp = design_lowpass(1.0, 40.0, 4500.0, 5500.0, 31250.0)
    hi, hq = hilbert_bandpass(lp, 5000.0, 31250.0)
    x = rng.standard_normal(256) + 1j * rng.standard_normal(256)
    p, c = fir.init(hi, hq, complex_input=True, rdtype=F64)
    _, got = run_blocks(lambda c, b: fir.process_complex(p, c, b), c, x, 2)
    want = oracles.FirOracle(hi, hq).cpx(x)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


# -------------------------------------------------------------------- iir --

def test_iir_biquad_matches_loop(rng):
    coefs = biquad_lowpass(3000.0, 1.0, 48000.0)
    b0, b1, b2, a1, a2 = coefs
    x = rng.standard_normal(300)
    p, c = iir.init(coefs, rdtype=F64)
    _, got = run_blocks(lambda c, b: iir.process(p, c, b), c, x, 3)
    w1 = w2 = 0.0
    want = np.empty_like(x)
    for i, v in enumerate(x):
        w0 = v - a1 * w1 - a2 * w2
        want[i] = b0 * w0 + b1 * w1 + b2 * w2
        w2, w1 = w1, w0
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


# -------------------------------------------------------- decimator chain --

def test_cascade_matches_oracle(rng):
    plan = plan_decimation(500_000.0, 10_000.0)
    assert len(plan.stages) >= 3
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048))
    c = decimator.cascade_init(plan, C128)
    _, got = run_blocks(
        lambda c, b: decimator.cascade_process(plan, c, b), c, x, 4)
    want = oracles.CascadeOracle(plan)(x)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_fused_matches_cascade(rng):
    plan = plan_decimation(2_000_000.0, 2800.0)   # 7 stages incl. cic3
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)) * 1000
    cc = decimator.cascade_init(plan, C128)
    _, want = run_blocks(
        lambda c, b: decimator.cascade_process(plan, c, b), cc, x, 2)
    fp, fc = decimator.fused_init(plan, C128, F64)
    _, got = run_blocks(
        lambda c, b: decimator.fused_process(plan, fp, c, b), fc, x, 2)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-6)


def test_fused_block_split_invariance(rng):
    plan = plan_decimation(250_000.0, 10_000.0)
    x = rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
    fp, fc = decimator.fused_init(plan, C128, F64)
    _, y1 = run_blocks(
        lambda c, b: decimator.fused_process(plan, fp, c, b), fc, x, 1)
    fp, fc = decimator.fused_init(plan, C128, F64)
    _, y8 = run_blocks(
        lambda c, b: decimator.fused_process(plan, fp, c, b), fc, x, 8)
    np.testing.assert_allclose(y1, y8, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------- fastfir --

@pytest.mark.parametrize("nfft,ntaps", [(2048, 1025), (4096, 3073),
                                        (4096, 2049)])
def test_fastfir_matches_oracle(rng, nfft, ntaps):
    """The jnp.fft overlap-save filter (cuFFT on the GPU) equals the
    per-sample direct-form oracle at the reference size and the larger
    frame/tap pairs the latency planner picks."""
    fs = 15625.0
    h = design_fastfir(100.0, 2800.0, 0.0, fs, fft_size=nfft, fir_size=ntaps)
    p = fastfir.FastFirParams(h_freq=jnp.asarray(h, C128))
    c = fastfir.FastFirCarry(tail=jnp.zeros(ntaps - 1, C128))
    n = fastfir.valid_per_frame(nfft, ntaps) * 4
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 100
    _, got = run_blocks(lambda c, b: fastfir.process(p, c, b), c, x, 2)
    want = oracles.FastFirOracle(h, nfft, ntaps)(x)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-6)


def test_fastfir_passband_stopband():
    fs = 15625.0
    p, c = fastfir.init(100.0, 2800.0, 0.0, fs, C128)
    n = fastfir.VALID * 8
    x_pass = tone(n, 1500.0, fs)
    x_stop = tone(n, 5000.0, fs)
    _, y_pass = fastfir.process(p, c, jnp.asarray(x_pass, C128))
    _, y_stop = fastfir.process(p, c, jnp.asarray(x_stop, C128))
    p_pass = np.mean(np.abs(np.asarray(y_pass)[2048:]) ** 2)
    p_stop = np.mean(np.abs(np.asarray(y_stop)[2048:]) ** 2)
    assert 10 * np.log10(p_pass / np.mean(np.abs(x_pass) ** 2)) > -1.0
    assert 10 * np.log10(p_stop / np.mean(np.abs(x_stop) ** 2)) < -80.0


# -------------------------------------------------------------------- agc --

@pytest.mark.parametrize("use_hang", [False, True])
def test_agc_matches_oracle(rng, use_hang):
    fs = 15625.0
    cfg = agc.AgcConfig(agc_on=True, use_hang=use_hang, sample_rate=fs)
    p = agc.make_params(cfg, -100.0, 30.0, 2.0, 200.0, F64)
    c = agc.init_carry(cfg, complex_input=True, rdtype=F64)
    n = 1200
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 3000
    x[300:600] *= 10.0   # step change to exercise attack/decay
    _, got = run_blocks(lambda c, b: agc.process(cfg, p, c, b), c, x, 3)
    want = oracles.AgcOracle(cfg, -100.0, 30.0, 2.0, 200.0)(x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_agc_hang_parallel_is_steady_state():
    """VERDICT r4 #4a: the hang-mode parallel solve must BE the steady
    state, not the scan fallback.  Across envelope classes chosen to
    stress its validity check — choppy random walks, hard on/off keying,
    tie-dense quantized plateaus, rectified speech-like AM — every block
    must validate (exact ties resolve identically in both pattern
    derivations: pk > d is False either way, so no flip-flop), and the
    parallel trajectory must match the sequential scan within f32
    associative-solve roundoff (~2e-4 decades = 0.004 dB of gain)."""
    import jax
    from cutesdr_tpu.ops.util import sliding_window_max
    fs = 62500.0
    cfg = agc.AgcConfig(agc_on=True, use_hang=True, sample_rate=fs)
    p = agc.make_params(cfg, -90.0, 30.0, 100.0, 50.0)

    @jax.jit
    def check(carry, m):
        peak, tail = sliding_window_max(m, cfg.window_samples,
                                        carry.mag_tail)
        par, valid = agc._averager_parallel(cfg, p, carry, peak)
        sa, sd, st, smag = agc._averager_scan(cfg, p, carry, peak)
        err = jnp.max(jnp.abs(par[3] - smag))
        new = carry._replace(mag_tail=tail, attack_ave=sa, decay_ave=sd,
                             hang_timer=st)
        return valid, err, new

    n, bs = 4096 * 6, 4096
    t_ = np.arange(n) / fs
    rng0 = np.random.default_rng(0)
    envs = [
        np.clip(-3 + 0.7 * np.cumsum(rng0.standard_normal(n)) / np.sqrt(n)
                + 0.4 * rng0.standard_normal(n), -8, 0),
        np.where((np.arange(n) // 1500) % 2 == 0, -1.0, -7.0)
        + 0.01 * rng0.standard_normal(n),
        np.clip(np.round(4 * np.cumsum(rng0.standard_normal(n))
                         / np.sqrt(n)) / 4 - 3, -8, 0),
        -3 + 2 * np.sign(np.sin(2 * np.pi * 5 * t_))
        * np.abs(np.sin(2 * np.pi * 1.3 * t_)),
    ]
    fallbacks, maxerr = 0, 0.0
    for mag in envs:
        mag = mag.astype(np.float32)
        carry = agc.init_carry(cfg, complex_input=False)
        for b in range(n // bs):
            v, e, carry = check(carry, jnp.asarray(mag[b * bs:(b + 1) * bs]))
            fallbacks += int(not bool(v))
            maxerr = max(maxerr, float(e))
    assert fallbacks == 0, f"{fallbacks} blocks fell back to the scan"
    assert maxerr < 1e-3, maxerr


def _two_rate_loop(rise, fall, x0, pk):
    out = np.empty_like(pk)
    x = x0
    for i, v in enumerate(pk):
        a = rise if v > x else fall
        x = (1 - a) * x + a * v
        out[i] = x
    return out


@pytest.mark.parametrize("n", [65536, 262144])
@pytest.mark.parametrize("solver", ["agc", "smeter"])
def test_parallel_averagers_match_sequential_loop(solver, n):
    """The log-depth solvers the levels stage runs on every block — the
    AGC's guess-verify two-rate averager and the S-meter's attack EMA +
    snapped decay — against a plain sequential loop over a
    flagship-sized f32 block."""
    rng = np.random.default_rng(n)
    if solver == "agc":
        fs = 62500.0
        cfg = agc.AgcConfig(agc_on=True, use_hang=False, sample_rate=fs)
        p = agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
        walk = np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
        peak = np.clip(-3 + walk + 0.3 * rng.standard_normal(n), -8, 0)
        peak = peak.astype(np.float32)
        x, ok = agc._two_rate_parallel(p.attack_rise_alpha,
                                       p.attack_fall_alpha,
                                       jnp.float32(-5.0), jnp.asarray(peak),
                                       agc.GUESS_ITERS)
        assert bool(ok)
        want = _two_rate_loop(float(p.attack_rise_alpha),
                              float(p.attack_fall_alpha), -5.0,
                              peak.astype(np.float64))
        np.testing.assert_allclose(np.asarray(x), want, atol=2e-4)
    else:
        fs = 62500.0
        p, c = smeter.init(fs)
        iq = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              * 300 * np.exp(np.linspace(0, 3, n))).astype(np.complex64)
        c2, mag = smeter.process(p, c, jnp.asarray(iq))
        m = np.asarray(mag, np.float64)
        aa, ad = float(p.attack_alpha), float(p.decay_alpha)
        a = d = -120.0
        for v in m:
            a = (1 - aa) * a + aa * v
            d = max((1 - ad) * d + ad * v, a)
        assert abs(float(c2.attack_ave) - a) < 1e-3
        assert abs(float(c2.decay_ave) - d) < 1e-3


def test_agc_manual_mode(rng):
    cfg = agc.AgcConfig(agc_on=False, use_hang=False, sample_rate=15625.0)
    p = agc.make_params(cfg, -100.0, 40.0, 0.0, 200.0, F64)
    c = agc.init_carry(cfg, complex_input=True, rdtype=F64)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    _, y = agc.process(cfg, p, c, jnp.asarray(x))
    g = 32767.0 * 10 ** (-(100 - 40) / 20)
    np.testing.assert_allclose(np.asarray(y), g * x, rtol=1e-6)


# ----------------------------------------------------------------- smeter --

def test_smeter_full_scale_tone():
    fs = 15625.0
    p, c = smeter.init(fs, F64)
    x = tone(4096, 1000.0, fs, power_db=0.0)   # full scale
    c, _ = smeter.process(p, c, jnp.asarray(x, C128))
    ave = float(smeter.get_ave(c))
    # full-scale tone = 0 dBFS + 5 dB calibration
    assert abs(ave - 5.0) < 0.5
    c, peak = smeter.get_peak(c)
    assert abs(float(peak) - 5.0) < 0.5
    assert float(c.peak_mag) == 0.0   # reset on read


# ---------------------------------------------------------- noise blanker --

def test_blanker_matches_oracle(rng):
    fs = 500_000.0
    cfg = noiseblanker.BlankerConfig(on=True, threshold=50.0, width_usec=20.0,
                                     sample_rate=fs)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)) * 100
    x[500] = 50000.0 + 50000.0j      # impulse
    x[1700] = -80000.0j
    c = noiseblanker.init_carry(cfg, C128, F64)
    _, got = run_blocks(lambda c, b: noiseblanker.process(cfg, c, b), c, x, 3)
    want = oracles.BlankerOracle(cfg)(x)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_blanker_kills_impulse(rng):
    fs = 500_000.0
    cfg = noiseblanker.BlankerConfig(on=True, threshold=30.0, width_usec=20.0,
                                     sample_rate=fs)
    x = (rng.standard_normal(2000) + 1j * rng.standard_normal(2000)) * 10
    x[1000] = 1e6
    c = noiseblanker.init_carry(cfg, C128, F64)
    _, y = noiseblanker.process(cfg, c, jnp.asarray(x))
    y = np.asarray(y)
    assert np.max(np.abs(y)) < 1000.0   # impulse removed


# -------------------------------------------------------------- resampler --

@pytest.mark.parametrize("rate", [0.3255208333, 1.0, 1.2345])
def test_resampler_matches_oracle(rng, rate):
    x = (rng.standard_normal(960) + 1j * rng.standard_normal(960)) * 100
    p, c = resampler.init(rate, complex_input=True, rdtype=F64)
    oracle = oracles.ResamplerOracle(resampler.make_sinc_table(np.float64))
    max_out = resampler.max_out_for(320, rate)
    got_all, want_all = [], []
    for blk in np.split(x, 3):
        c, y, nv = resampler.process(p, c, jnp.asarray(blk), max_out,
                                     interp=False)
        got_all.append(np.asarray(y)[:int(nv)])
        want_all.append(oracle(blk, rate))
    got = np.concatenate(got_all)
    want = np.concatenate(want_all)
    assert len(got) == len(want)
    # the oracle accumulates float time (ft += rate) while the op uses the
    # exact closed form t_k = t0 + k*dt, so sinc table indices may differ by
    # ±1 step (1e-4 of a zero crossing) for non-terminating rates
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=0.1)


def _audio_band_sinad(y, fs, f0, guard_hz=8.0, band=(20.0, 20000.0)):
    """Tone power vs in-band noise+distortion power, measured on a
    detrended, Kaiser-windowed PSD.  (A naive tone-fit residual is
    dominated by fit leakage and under-reports the method by ~30 dB —
    the round-1 '70 dB ceiling' was that artifact.)"""
    y = np.asarray(y, np.float64)
    y = y - np.polyval(np.polyfit(np.arange(len(y)), y, 1), np.arange(len(y)))
    w = np.kaiser(len(y), 38.0)
    ps = np.abs(np.fft.rfft(y * w)) ** 2
    f = np.fft.rfftfreq(len(y), 1.0 / fs)
    tone_bins = np.abs(f - f0) <= guard_hz
    inband = (f >= band[0]) & (f <= band[1]) & ~tone_bins
    return 10 * np.log10(ps[tone_bins].sum() / ps[inband].sum())


@pytest.mark.parametrize("fs_in,interp,min_db", [
    (15625.0, False, 92.0),    # upsample, reference-exact truncating lookup
    (62500.0, False, 104.0),   # downsample
    (15625.0, True, 115.0),    # table interpolation (the framework default)
    (62500.0, True, 120.0),
])
def test_resampler_streaming_sinad(fs_in, interp, min_db):
    """Audio-band SINAD of the production streaming path (f32, carried
    state, per-block k < 2^11 so the split-precision timestamps stay
    exact).  The truncating lookup is the reference's method
    (dsp/fractresampler.cpp:144-184); interp=True beats it by ~20 dB for
    one extra gather+FMA, which is why ReceiverConfig defaults it on."""
    fs_out = 48000.0
    rate = fs_in / fs_out
    f0 = 1000.0
    block = 1024
    p, c = resampler.init(rate, rdtype=jnp.float32)
    max_out = resampler.max_out_for(block, rate)
    step = jax.jit(lambda p, c, x: resampler.process(p, c, x, max_out,
                                                     interp=interp))
    ys = []
    for b in range(96):
        x = np.cos(2 * np.pi * f0 / fs_in
                   * (np.arange(block) + b * block)).astype(np.float32) * 0.3
        c, y, nv = step(p, c, jnp.asarray(x))
        ys.append(np.asarray(y)[:int(nv)])
    y = np.concatenate(ys)[1000:-1000]
    sinad = _audio_band_sinad(y, fs_out, f0)
    assert sinad > min_db, sinad


def test_resampler_large_block_snr():
    """SINAD at the flagship's PRODUCTION block size (262144 decimated
    samples, ~202k outputs/block).  Pins the r5 two-level _times split:
    the one-product k*dt_hi form is only exact for k < 2^11, and at 202k
    outputs the f32 fractional phases drifted up to ~2^-7 of a sample —
    the shipped resampler measured 46 dB here while the k<2^11 tests
    above showed 120+ dB (their blocks were too small to see it)."""
    fs_in, fs_out = 62500.0, 48000.0
    rate = fs_in / fs_out
    f0 = 10000.0
    block = 262144
    p, c = resampler.init(rate, rdtype=jnp.float32)
    max_out = resampler.max_out_for(block, rate)
    ys = []
    for b in range(2):
        x = np.cos(2 * np.pi * f0 / fs_in
                   * (np.arange(block) + b * block)).astype(np.float32) * 0.3
        c, y, nv = resampler.process(p, c, jnp.asarray(x), max_out,
                                     interp=True)
        ys.append(np.asarray(y)[:int(nv)])
    y = np.concatenate(ys)[1000:-1000]
    sinad = _audio_band_sinad(y, fs_out, f0)
    assert sinad > 115.0, sinad


def test_resampler_rational_fast_path(rng):
    """The static-polyphase conv fast path (exact rational ratio, zero
    rate-lock correction) equals the banded evaluator across carry
    boundaries for real/complex and both interp modes, and a non-nominal
    ratio falls back to the banded path bit-exactly."""
    fs_in, fs_out = 62500.0, 48000.0
    rate = fs_in / fs_out
    rat = resampler.rational_for(fs_in, fs_out)
    assert rat == (125, 96)
    assert resampler.rational_for(62500.0, 44100.0) == (625, 441)
    assert resampler.rational_for(62500.0, 62500.0) is None  # q == 1
    n = 16384
    max_out = resampler.max_out_for(n, rate)
    for interp in (True, False):
        for cplx in (False, True):
            p0, cf = resampler.init(rate, complex_input=cplx,
                                    rdtype=jnp.float32)
            _, cb = resampler.init(rate, complex_input=cplx,
                                   rdtype=jnp.float32)
            for blk in range(3):
                if cplx:
                    x = jnp.asarray((rng.standard_normal(n)
                                     + 1j * rng.standard_normal(n)
                                     ).astype(np.complex64))
                else:
                    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
                cf, yf, nf = resampler.process(p0, cf, x, max_out,
                                               interp=interp, rational=rat)
                cb, yb, nb = resampler.process(p0, cb, x, max_out,
                                               interp=interp)
                assert int(nf) == int(nb)
                rel = float(jnp.max(jnp.abs(yf - yb))) / \
                    float(jnp.max(jnp.abs(yb)))
                # interp=False: the banded path makes the truncating-grid
                # decision in f32, the fast path on the exact f64 phase —
                # isolated decisions flip near grid boundaries (the fast
                # path is the more faithful of the two)
                assert rel < (1e-4 if interp else 1e-3), \
                    (interp, cplx, blk, rel)
            assert abs(float(cf.t0) - float(cb.t0)) < 1e-4
    # non-nominal ratio: the cond must take the banded branch exactly
    p1, c1 = resampler.init(rate * 1.001, rdtype=jnp.float32)
    _, c2 = resampler.init(rate * 1.001, rdtype=jnp.float32)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    _, y1, n1 = resampler.process(p1, c1, x, max_out, rational=rat)
    _, y2, n2 = resampler.process(p1, c2, x, max_out)
    assert int(n1) == int(n2)
    # same banded code, but compiled inside lax.cond vs standalone —
    # XLA's fusion/FMA choices may differ between the two programs, so
    # value-level (not bitwise) equality is the contract
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=1e-4, atol=1e-6)


def test_sinc_band_matches_direct_form_all_parities():
    """_sinc_band's separable evaluation equals the direct closed form for
    every tap-count parity class — P=30 exercises the (-1)^(P/2) factor a
    review caught missing (P/2 odd negated every weight), odd P takes the
    direct-form fallback inside process()."""
    from cutesdr_tpu.ops import resampler as R
    rng = np.random.default_rng(0)
    m = np.arange(128)
    Ti = jnp.asarray(rng.integers(0, 60, 256).astype(np.int32))
    tf = jnp.asarray(rng.random(256).astype(np.float32))
    for P in (28, 30, 32, 48):
        sb = R._sinc_band(Ti, tf, m, P)
        v = (jnp.asarray(m, jnp.int32) - Ti[:, None]).astype(jnp.float32) \
            - tf[:, None]
        sv = R._sinc_value(v, P, True)
        d = float(jnp.max(jnp.abs(sb - sv)))
        assert d < 2e-4, (P, d)
    # odd periods route through the fallback and still resample
    p, c = R.init(62500 / 48000, periods=29)
    x = (1000 * np.exp(2j * np.pi * 1000 * np.arange(4096) / 62500)
         ).astype(np.complex64)
    _, y, nv = R.process(p, c, jnp.asarray(x),
                         R.max_out_for(4096, 62500 / 48000))
    assert int(nv) > 3000


def test_resampler_long_sinc_snr():
    """The parametrized sinc length must stream correctly (tap count derives
    from the carry shape) and keep the same quality."""
    fs_in, fs_out = 15625.0, 48000.0
    rate = fs_in / fs_out
    f0 = 1000.0
    block = 1024
    p, c = resampler.init(rate, rdtype=jnp.float32, periods=48)
    assert c.tail.shape[-1] == 48
    max_out = resampler.max_out_for(block, rate)
    ys = []
    for b in range(64):
        x = np.cos(2 * np.pi * f0 / fs_in
                   * (np.arange(block) + b * block)).astype(np.float32) * 0.3
        c, y, nv = resampler.process(p, c, jnp.asarray(x), max_out,
                                     interp=True)
        ys.append(np.asarray(y)[:int(nv)])
    y = np.concatenate(ys)[1000:-1000]
    assert _audio_band_sinad(y, fs_out, f0) > 110.0


def test_resampler_to_int16():
    y = jnp.asarray(np.array([0.5, -2.0, 40000.0, -40000.0]), F64)
    out = np.asarray(resampler.to_int16(y, gain=1.0))
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, [0, -2, 32767, -32767])
    # stereo: complex -> [n, 2]
    yc = jnp.asarray(np.array([1 + 2j, -3 - 4j]), C128)
    out2 = np.asarray(resampler.to_int16(yc, gain=100.0, stereo=True))
    np.testing.assert_array_equal(out2, [[100, 200], [-300, -400]])


def test_resampler_capacity_covers_max_rate_correction(rng):
    """At the rate-lock's extreme correction (~±0.2%) no output may be lost
    to the static capacity."""
    nominal = 15625.0 / 48000.0
    worst = nominal * (1.0 - 0.00195)       # max negative correction
    cap = resampler.max_out_for(1024, nominal)
    p, c = resampler.init(worst, rdtype=F64)
    total = 0
    for _ in range(6):
        x = rng.standard_normal(1024)
        c, y, nv = resampler.process(p, c, jnp.asarray(x), cap)
        assert int(nv) < cap                # never saturates the capacity
        total += int(nv)
    assert abs(total - 6 * 1024 / worst) <= 2
