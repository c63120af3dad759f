"""Demodulator behavior tests: tone recovery, PLL lock, squelch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cutesdr_tpu.demod import am, fm, sam, ssb
from cutesdr_tpu.testbench.generators import tone
from cutesdr_tpu.types import K_2PI

F64 = jnp.float64
C128 = jnp.complex128


def fit_tone_snr(y, f0, fs, skip=500):
    y = np.asarray(y, np.float64)[skip:]
    t = np.arange(len(y)) / fs
    ref = np.exp(2j * np.pi * f0 * t)
    amp = (y @ np.conj(ref)) / len(y) * 2
    resid = y - np.real(amp * ref)
    return abs(amp), 10 * np.log10(np.mean(y ** 2) / max(np.mean(resid ** 2), 1e-30))


def test_ssb_is_real_part(rng):
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    _, y = ssb.process(None, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), x.real)
    _, ys = ssb.process_stereo(None, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(ys), x.real + 1j * x.real)


def test_am_envelope_recovers_modulation():
    fs = 31250.0
    n = 8192
    fm_audio = 1000.0
    t = np.arange(n) / fs
    envelope = 10000.0 * (1.0 + 0.5 * np.cos(2 * np.pi * fm_audio * t))
    x = envelope * np.exp(1j * (0.3 + 2 * np.pi * 25.0 * t))  # near-DC carrier
    p, c = am.init(5000.0, fs, F64)
    c, y = am.process(p, c, jnp.asarray(x, C128))
    amp, snr = fit_tone_snr(y, fm_audio, fs, skip=1000)
    assert abs(amp - 5000.0) / 5000.0 < 0.05
    assert snr > 30.0


def test_am_block_split_invariance(rng):
    fs = 31250.0
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)) * 100
    p, c1 = am.init(5000.0, fs, F64)
    _, y_full = am.process(p, c1, jnp.asarray(x, C128))
    _, c2 = am.init(5000.0, fs, F64)
    outs = []
    for blk in np.split(x, 4):
        c2, y = am.process(p, c2, jnp.asarray(blk, C128))
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.asarray(y_full), np.concatenate(outs),
                               rtol=1e-9, atol=1e-9)


def test_sam_pll_locks_and_demodulates():
    """Carrier offset within pull-in range: PLL locks, audio recovered."""
    fs = 15625.0
    n = 3 * 4096
    f_carrier = 300.0           # offset carrier (within ±1 kHz clamp)
    f_audio = 400.0
    t = np.arange(n) / fs
    env = 8000.0 * (1.0 + 0.5 * np.cos(2 * np.pi * f_audio * t))
    x = env * np.exp(1j * 2 * np.pi * f_carrier * t)
    p, c = sam.init(fs, F64)
    c, y = sam.process(p, c, jnp.asarray(x, C128))
    # after lock, NCO freq should track the carrier offset
    locked_freq = float(c.nco_freq) * fs / K_2PI
    assert abs(locked_freq - f_carrier) < 20.0
    amp, snr = fit_tone_snr(y, f_audio, fs, skip=n // 2)
    assert abs(amp - 4000.0) / 4000.0 < 0.1
    assert snr > 20.0


def test_sam_stereo_separates_sidebands():
    fs = 15625.0
    n = 4 * 4096
    t = np.arange(n) / fs
    f_u, f_l = 1200.0, 700.0
    # carrier + upper sideband at +1200, lower sideband at -700
    x = 8000.0 * np.exp(1j * 0 * t)
    x = x + 2000.0 * np.exp(1j * 2 * np.pi * f_u * t)
    x = x + 2000.0 * np.exp(-1j * 2 * np.pi * f_l * t)
    p, c = sam.init(fs, F64)
    c, y = sam.process_stereo(p, c, jnp.asarray(x, C128))
    y = np.asarray(y)[n // 2:]
    left, right = y.real, y.imag
    def tone_power(sig, f):
        tt = np.arange(len(sig)) / fs
        return abs(sig @ np.exp(-2j * np.pi * f * tt)) / len(sig) * 2
    # upper sideband should dominate the right channel, lower the left
    assert tone_power(right, f_u) > 5 * tone_power(right, f_l)
    assert tone_power(left, f_l) > 5 * tone_power(left, f_u)


def test_fm_demodulates_tone():
    # FM runs at 62.5 kHz out of the decimator (max BW 15 kHz -> stop at f<=89.8k)
    fs = 62500.0
    n = 3 * 4096
    f_audio = 1000.0
    deviation = 3000.0
    t = np.arange(n) / fs
    phase = (deviation / f_audio) * np.sin(2 * np.pi * f_audio * t)
    x = 10000.0 * np.exp(1j * phase)
    p, c = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    # squelch_ui 0 -> threshold SQUELCH_MAX -> squelch never trips on clean FM
    c, y = fm.process(p, c, jnp.asarray(x, C128))
    amp, snr = fit_tone_snr(y, f_audio, fs, skip=n // 2)
    # audio amplitude = deviation * out_gain where out_gain = 25000/nco_limit
    norm = K_2PI / fs
    expect = deviation * norm * (25000.0 / (6000.0 * norm))
    assert abs(amp - expect) / expect < 0.05
    assert snr > 25.0


def test_fm_deemphasis_one_pole_response():
    """fm_deemphasis_us applies a one-pole lowpass to the demodulated
    audio whose tone attenuation matches the analytic EMA response
    |H(f)| = a/|1-(1-a)e^{-jw}|; tau=0 is bit-identical OFF (alpha=1, a
    traced-knob toggle).  BASELINE config 3 ("CFmDemod with de-emphasis");
    the reference dsp/fmdemod.cpp has none — documented extension."""
    fs = 62500.0
    n = 3 * 4096
    tau_us = 75.0
    for f_audio in (300.0, 3000.0):
        t = np.arange(n) / fs
        deviation = 2000.0
        phase = (deviation / f_audio) * np.sin(2 * np.pi * f_audio * t)
        x = 10000.0 * np.exp(1j * phase)

        p0, c0 = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
        _, y_off = fm.process(p0, c0, jnp.asarray(x, C128))
        p1, c1 = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0,
                         deemphasis_us=tau_us, rdtype=F64)
        _, y_on = fm.process(p1, c1, jnp.asarray(x, C128))

        a_off, _ = fit_tone_snr(y_off, f_audio, fs, skip=n // 2)
        a_on, _ = fit_tone_snr(y_on, f_audio, fs, skip=n // 2)
        alpha = fm.deemphasis_alpha(fs, tau_us)
        w = 2 * np.pi * f_audio / fs
        h = abs(alpha / (1.0 - (1.0 - alpha) * np.exp(-1j * w)))
        assert abs(a_on / a_off - h) < 0.02 * h, (f_audio, a_on / a_off, h)

    # tau=0 -> alpha=1 -> identity
    p0, c0 = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    pz, cz = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0,
                     deemphasis_us=0.0, rdtype=F64)
    _, ya = fm.process(p0, c0, jnp.asarray(x, C128))
    _, yb = fm.process(pz, cz, jnp.asarray(x, C128))
    np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))

    # live knob update keeps the params pytree shape (no recompile)
    p2 = fm.set_deemphasis(p0, 50.0, fs)
    assert p2.deemph_alpha.dtype == p0.deemph_alpha.dtype


def test_fm_squelch_mutes_noise(rng):
    fs = 62500.0
    p, c = fm.init(fs, squelch_ui_value=50, fm_bw=5000.0, rdtype=F64)
    # pure noise input -> PLL output is wideband noise -> squelch closes
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)) * 10000.0
    for blk in np.split(x, 4):
        c, y = fm.process(p, c, jnp.asarray(blk, C128))
    assert bool(c.squelch_on)
    assert np.all(np.asarray(y) == 0.0)


def test_fm_squelch_opens_on_signal():
    fs = 62500.0
    n = 8192
    t = np.arange(n) / fs
    x = 10000.0 * np.exp(1j * 2 * np.pi * 100.0 * t)   # clean carrier
    p, c = fm.init(fs, squelch_ui_value=50, fm_bw=5000.0, rdtype=F64)
    for _ in range(3):
        c, y = fm.process(p, c, jnp.asarray(x, C128))
    assert not bool(c.squelch_on)


@pytest.mark.parametrize("n", [1024, 8192, 32768])
def test_fm_pll_matches_oracle(n):
    """The wrap-form PLL (the sequential lax.scan tier) must track the
    rotate+atan2 reference recurrence (identical math; float rounding
    differences decay through the stable loop)."""
    import oracles
    fs = 62500.0
    t = np.arange(n) / fs
    x = (8000.0 * np.exp(1j * ((2000.0 / 700.0) * np.sin(2 * np.pi * 700.0 * t)
                               + 2 * np.pi * 500.0 * t))).astype(complex)
    p, c = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    xj = jnp.asarray(x, C128)
    theta = jnp.arctan2(xj.imag, xj.real)
    _, _, _, audio, _ = fm._pll_scan(p, c, theta)
    want = oracles.FmPllOracle(fs)(x)
    got = np.asarray(audio)
    # after lock-in, trajectories coincide
    skip = min(2000, n // 2)
    scale = np.abs(want[skip:]).max()
    np.testing.assert_allclose(got[skip:], want[skip:], atol=1e-6 * scale)


def test_fm_pll_linear_matches_scan_when_locked():
    """The parallel (convolution) form of the locked loop must reproduce
    the sequential scan sample-for-sample, and must report validity."""
    fs = 62500.0
    n = 8192
    t = np.arange(n) / fs
    x = (8000.0 * np.exp(1j * ((2000.0 / 700.0) * np.sin(2 * np.pi * 700.0 * t)
                               + 2 * np.pi * 500.0 * t))).astype(complex)
    p, c = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    xj = jnp.asarray(x, C128)
    theta = jnp.arctan2(xj.imag, xj.real)
    # run a first block sequentially to lock, then compare forms on block 2
    phase, freq, dc, _, _ = fm._pll_scan(p, c, theta[:4096])
    c2 = c._replace(nco_phase=phase, nco_freq=freq, freq_error_dc=dc)
    valid, (lp, lf, ldc, laud, _) = fm._pll_linear(p, c2, theta[4096:])
    sp, sf, sdc, saud, _ = fm._pll_scan(p, c2, theta[4096:])
    assert bool(valid)
    scale = float(np.abs(np.asarray(saud)).max())
    np.testing.assert_allclose(np.asarray(laud), np.asarray(saud),
                               atol=1e-9 * scale)
    np.testing.assert_allclose(float(lf), float(sf), atol=1e-12)
    np.testing.assert_allclose(float(ldc), float(sdc), atol=1e-12)
    # phase carry agrees mod 2pi
    dphi = (float(lp) - float(sp)) % (2 * np.pi)
    assert min(dphi, 2 * np.pi - dphi) < 1e-9


def test_fm_pll_linear_flags_unlocked_block():
    """A carrier far outside the pull-in behavior (large phase steps) must
    be flagged invalid so process() falls back to the exact scan."""
    fs = 62500.0
    n = 2048
    t = np.arange(n) / fs
    # 20 kHz offset: phase step 2*pi*20000/62500 ~ 2.0 rad >> loop range
    x = 8000.0 * np.exp(1j * 2 * np.pi * 20000.0 * t)
    p, c = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    xj = jnp.asarray(x, C128)
    theta = jnp.arctan2(xj.imag, xj.real)
    valid, _ = fm._pll_linear(p, c, theta)
    assert not bool(valid)
    # and the public path still matches the oracle through the fallback
    import oracles
    _, audio = fm.process(p, c, xj)
    want = oracles.FmPllOracle(fs)(x)
    # squelch will likely mute; compare the raw PLL instead
    _tier, (_, _, _, raw, _) = fm._pll(p, c, xj)
    np.testing.assert_allclose(np.asarray(raw), want,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_sam_pll_linear_matches_scan_when_locked():
    fs = 15625.0
    n = 8192
    t = np.arange(n) / fs
    env = 6000.0 * (1.0 + 0.4 * np.cos(2 * np.pi * 350.0 * t))
    x = env * np.exp(1j * 2 * np.pi * 200.0 * t)
    p, c = sam.init(fs, F64)
    xj = jnp.asarray(x, C128)
    theta = jnp.arctan2(xj.imag, xj.real)
    # lock on the first half, compare forms on the second
    phase, freq, _ = sam._pll_scan(p, c, theta[:4096])
    c2 = c._replace(nco_phase=phase, nco_freq=freq)
    valid, (lp, lf, lprev) = sam._pll_linear(p, c2, theta[4096:])
    sp, sf, sprev = sam._pll_scan(p, c2, theta[4096:])
    assert bool(valid)
    # pre-update phases agree mod 2pi (the rotation absorbs the branch)
    d = np.asarray(lprev) - np.asarray(sprev)
    d = np.abs(d - 2 * np.pi * np.round(d / (2 * np.pi)))
    assert d.max() < 1e-9
    np.testing.assert_allclose(float(lf), float(sf), atol=1e-12)
    dphi = (float(lp) - float(sp)) % (2 * np.pi)
    assert min(dphi, 2 * np.pi - dphi) < 1e-9


@pytest.mark.parametrize("n", [1024, 8192, 32768])
def test_sam_pll_matches_oracle(n):
    import oracles
    fs = 15625.0
    t = np.arange(n) / fs
    env = 6000.0 * (1.0 + 0.4 * np.cos(2 * np.pi * 350.0 * t))
    x = env * np.exp(1j * 2 * np.pi * 200.0 * t)
    p, c = sam.init(fs, F64)
    c2, got = sam.process(p, c, jnp.asarray(x, C128))
    want = oracles.SamPllOracle(fs)(x)
    skip = min(2000, n // 2)
    scale = np.abs(want[skip:]).max()
    np.testing.assert_allclose(np.asarray(got)[skip:], want[skip:],
                               atol=1e-6 * scale)


def _stack_tree(trees):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees)


def _bcast_tree(tree, n):
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (n,) + a.shape), tree)


def _fm_signal(fs, n, mod_hz, dev_hz, t0=0.0):
    t = t0 + np.arange(n) / fs
    return (8000.0 * np.exp(1j * (dev_hz / mod_hz)
                            * np.sin(2 * np.pi * mod_hz * t))).astype(complex)


def test_fm_process_batch_matches_per_channel():
    """Bank-voted batch path (all channels locked → one linear solve for the
    whole bank) must reproduce per-channel fm.process."""
    fs = 62500.0
    n = 4096
    p, _ = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    xs, carries = [], []
    for mod in (400.0, 700.0, 1100.0):
        x1 = jnp.asarray(_fm_signal(fs, n, mod, 2000.0), C128)
        x2 = jnp.asarray(_fm_signal(fs, n, mod, 2000.0, t0=n / fs), C128)
        _, c0 = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
        c1, _ = fm.process(p, c0, x1)      # lock-in block
        carries.append(c1)
        xs.append(x2)
    bp = _bcast_tree(p, 3)
    bc = _stack_tree(carries)
    bx = jnp.stack(xs)
    # the fast path must actually be available: every channel locked
    theta = jnp.arctan2(bx.imag, bx.real)
    valid, _ = jax.vmap(fm._pll_linear)(bp, bc, theta)
    assert bool(jnp.all(valid))
    nbc, by = fm.process_batch(bp, bc, bx)
    for i in range(3):
        ci, yi = fm.process(p, carries[i], xs[i])
        scale = max(float(jnp.abs(yi).max()), 1.0)
        np.testing.assert_allclose(np.asarray(by[i]), np.asarray(yi),
                                   atol=1e-9 * scale)
        np.testing.assert_allclose(
            float(jax.tree_util.tree_map(lambda a: a[i], nbc).nco_freq),
            float(ci.nco_freq), atol=1e-12)


def test_fm_process_batch_unlocked_falls_back_to_scan():
    """One unlocked channel flips the whole bank to the scan; locked
    channels still agree with per-channel process (linear == scan)."""
    fs = 62500.0
    n = 2048
    p, _ = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    t = np.arange(n) / fs
    locked = jnp.asarray(_fm_signal(fs, n, 700.0, 2000.0), C128)
    # 20 kHz off-tune carrier: phase steps ~2 rad >> loop range → invalid
    unlocked = jnp.asarray(8000.0 * np.exp(1j * 2 * np.pi * 20000.0 * t), C128)
    _, c0 = fm.init(fs, squelch_ui_value=0, fm_bw=5000.0, rdtype=F64)
    c1, _ = fm.process(p, c0, locked)
    bp = _bcast_tree(p, 2)
    bc = _stack_tree([c1, c0])
    bx = jnp.stack([locked, unlocked])
    theta = jnp.arctan2(bx.imag, bx.real)
    valid, _ = jax.vmap(fm._pll_linear)(bp, bc, theta)
    assert bool(valid[0]) and not bool(valid[1])
    _, by = fm.process_batch(bp, bc, bx)
    for i, (c, x) in enumerate([(c1, locked), (c0, unlocked)]):
        _, yi = fm.process(p, c, x)
        scale = max(float(jnp.abs(yi).max()), 1.0)
        np.testing.assert_allclose(np.asarray(by[i]), np.asarray(yi),
                                   atol=1e-8 * scale)


def test_sam_process_batch_matches_per_channel():
    fs = 15625.0
    n = 4096
    p, _ = sam.init(fs, F64)
    xs, carries = [], []
    for f0, mod in ((200.0, 350.0), (-150.0, 500.0)):
        t = np.arange(2 * n) / fs
        env = 6000.0 * (1.0 + 0.4 * np.cos(2 * np.pi * mod * t))
        x = env * np.exp(1j * 2 * np.pi * f0 * t)
        _, c0 = sam.init(fs, F64)
        c1, _ = sam.process(p, c0, jnp.asarray(x[:n], C128))
        carries.append(c1)
        xs.append(jnp.asarray(x[n:], C128))
    bp = _bcast_tree(p, 2)
    bc = _stack_tree(carries)
    bx = jnp.stack(xs)
    _, by = sam.process_batch(bp, bc, bx)
    for i in range(2):
        _, yi = sam.process(p, carries[i], xs[i])
        scale = max(float(jnp.abs(yi).max()), 1.0)
        np.testing.assert_allclose(np.asarray(by[i]), np.asarray(yi),
                                   atol=1e-9 * scale)
    # stereo variant compiles and matches too
    _, bys = sam.process_batch_stereo(bp, bc, bx)
    for i in range(2):
        _, yis = sam.process_stereo(p, carries[i], xs[i])
        scale = max(float(jnp.abs(yis).max()), 1.0)
        np.testing.assert_allclose(np.asarray(bys[i]), np.asarray(yis),
                                   atol=1e-9 * scale)
