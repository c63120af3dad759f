"""Dual-channel MRC combining tests.

The reference defines dual-RX channel modes but never demodulates channel
2 (interface/protocoldefs.h:143-152); this verifies the new coherent
combining: gain estimation, SNR improvement, steering override, and the
combined receiver end-to-end.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from cutesdr_tpu.shard import coherent


def _two_branch(n, g, snr_db, f=0.02, seed=0, amp=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    s = amp * np.exp(2j * np.pi * f * t)
    npow = amp * 10 ** (-snr_db / 20.0)
    n0 = npow * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    n1 = npow * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    return np.stack([s + n0, g * s + n1]).astype(np.complex64), s


def _tone_snr(y, f):
    n = len(y)
    w = np.hanning(n)
    spec = np.abs(np.fft.fft(y * w)) ** 2
    k = int(round(f * n)) % n
    sig = spec[max(0, k - 2):k + 3].sum()
    noise = spec.sum() - sig
    return 10 * np.log10(sig / noise)


def test_gain_estimate_converges():
    g_true = 0.8 * np.exp(1j * 2.1)
    x, _ = _two_branch(65536, g_true, snr_db=20.0)
    p, c = coherent.init(smoothing_blocks=4.0)
    for blk in x.reshape(2, 16, 4096).transpose(1, 0, 2):
        c, _ = coherent.process(p, c, jnp.asarray(blk))
    g = complex(np.asarray(c.gain))
    # EMA weight left on the init value after 16 blocks: (3/4)^16 ~ 1%
    assert abs(g - g_true) < 0.05


def test_mrc_improves_snr():
    """Equal-SNR branches: MRC output must beat the best single branch by
    ~3 dB (allow >2 dB with estimation noise)."""
    x, _ = _two_branch(32768, np.exp(1j * 1.0), snr_db=15.0)
    p, c = coherent.init(smoothing_blocks=2.0)
    outs = []
    for blk in x.reshape(2, 8, 4096).transpose(1, 0, 2):
        c, y = coherent.process(p, c, jnp.asarray(blk))
        outs.append(np.asarray(y))
    y = np.concatenate(outs[2:])          # skip convergence
    snr0 = _tone_snr(np.asarray(x[0][2 * 4096:]), 0.02)
    snr1 = _tone_snr(np.asarray(x[1][2 * 4096:]), 0.02)
    snrc = _tone_snr(y, 0.02)
    assert snrc > max(snr0, snr1) + 2.0, (snr0, snr1, snrc)


def test_manual_steering_override():
    x, _ = _two_branch(4096, 1.0j, snr_db=30.0)
    p, c = coherent.init(manual=True, fixed_gain=1.0j)
    c, y = coherent.process(p, c, jnp.asarray(x))
    # with the exact gain, combining is coherent: amplitude ~ sqrt(2)·|s|
    amp = np.abs(np.asarray(y)).mean()
    assert abs(amp - np.sqrt(2.0)) < 0.05
    assert complex(np.asarray(c.gain)) == 1.0j


def test_diversity_receiver_end_to_end():
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig
    from cutesdr_tpu.shard.coherent import DiversityReceiver

    cfg = ReceiverConfig(input_rate=2e6, mode="usb", tune_freq=100e3,
                         agc_on=False)
    rx = DiversityReceiver(cfg, smoothing_blocks=2.0)
    fs, n = 2e6, cfg.block_size
    n_blocks = 8
    t = np.arange(n_blocks * n) / fs
    s = 8000.0 * np.exp(2j * np.pi * 102e3 * t)     # 2 kHz audio in USB
    g = 0.9 * np.exp(-1j * 0.7)
    stack = np.stack([s, g * s]).astype(np.complex64)
    audio = []
    for i in range(n_blocks):
        out = rx.process(stack[:, i * n:(i + 1) * n])
        audio.append(np.asarray(out.audio)[:int(out.n_audio)])
    a = np.concatenate(audio[4:])
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1 / 48000.0)
    pk = f[np.argmax(spec)]
    assert abs(pk - 2000.0) < 30, pk
    assert abs(rx.last_gain - g) < 0.05


def test_diversity_receiver_host_planes_matches_complex_path():
    """process_host (f32 re/im planes both ways — the production
    contract) produces the same audio and gain as process()."""
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig, join_complex_pair
    from cutesdr_tpu.shard.coherent import DiversityReceiver

    cfg = ReceiverConfig(input_rate=2e6, mode="usb", tune_freq=100e3,
                         agc_on=False)
    rx_c = DiversityReceiver(cfg, smoothing_blocks=2.0)
    rx_h = DiversityReceiver(cfg, smoothing_blocks=2.0)
    fs, n = 2e6, cfg.block_size
    t = np.arange(3 * n) / fs
    s = 8000.0 * np.exp(2j * np.pi * 102e3 * t)
    stack = np.stack([s, 0.8 * np.exp(1j * 0.3) * s]).astype(np.complex64)
    for i in range(3):
        blk = stack[:, i * n:(i + 1) * n]
        out_c = rx_c.process(blk)
        out_h = rx_h.process_host(blk)
        np.testing.assert_allclose(np.asarray(out_h.audio),
                                   np.asarray(out_c.audio),
                                   rtol=0, atol=1e-4)
    assert abs(rx_h.last_gain - rx_c.last_gain) < 1e-6


def test_array_combiner_generalizes_mrc():
    """M-branch MRC (array_process): gains converge to the per-branch
    channel mismatches, the combine beats the best single branch's SNR,
    and M=2 reproduces the pairwise combiner."""
    import jax
    import jax.numpy as jnp

    from cutesdr_tpu.shard import coherent

    rng = np.random.default_rng(9)
    n = 4096
    t = np.arange(n)
    s = np.exp(2j * np.pi * 0.01 * t) * 1000.0
    gains = np.array([1.0, 0.8 * np.exp(1j * 0.7), 0.5 * np.exp(-1j * 1.1)])
    noise = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
             ) * 100.0
    x = gains[:, None] * s[None, :] + noise

    p, c = coherent.array_init(3, smoothing_blocks=1.0)
    step = jax.jit(coherent.array_process)
    for _ in range(6):
        c, y = step(p, c, jnp.asarray(x, jnp.complex64))
    g = np.asarray(c.gains)
    np.testing.assert_allclose(np.abs(g), np.abs(gains), atol=0.05)
    np.testing.assert_allclose(np.angle(g[1:]), np.angle(gains[1:]),
                               atol=0.05)

    def snr(sig):
        sig = np.asarray(sig)
        a = (sig @ np.conj(s)) / (s @ np.conj(s))
        resid = sig - a * s
        return 10 * np.log10(np.abs(a) ** 2 * np.mean(np.abs(s) ** 2)
                             / np.mean(np.abs(resid) ** 2))

    best_branch = max(snr(x[i]) for i in range(3))
    assert snr(y) > best_branch + 1.0       # MRC gain over the best branch

    # M=2 degenerates to the pairwise combiner
    p2, c2 = coherent.array_init(2, smoothing_blocks=1.0)
    pp, cp = coherent.init(smoothing_blocks=1.0)
    c2, y2 = coherent.array_process(p2, c2, jnp.asarray(x[:2], jnp.complex64))
    cp, yp = coherent.process(pp, cp, jnp.asarray(x[:2], jnp.complex64))
    np.testing.assert_allclose(np.asarray(y2), np.asarray(yp), atol=1e-2)


def test_diversity_receiver_n_branches():
    """DiversityReceiver with n_branches=4: combines four coherent
    streams, tracks all branch gains, demodulates the tone."""
    import jax.numpy as jnp

    from cutesdr_tpu.pipeline.receiver import ReceiverConfig
    from cutesdr_tpu.shard.coherent import DiversityReceiver
    from cutesdr_tpu.testbench.generators import tone

    cfg = ReceiverConfig(input_rate=250_000.0, mode="usb",
                         tune_freq=60_000.0, audio_rate=None,
                         agc_on=False)
    drx = DiversityReceiver(cfg, smoothing_blocks=1.0, n_branches=4)
    gains = np.array([1.0, 0.9 * np.exp(1j * 0.5), 0.6 * np.exp(-1j * 1.0),
                      0.3 * np.exp(1j * 2.0)])
    x0 = tone(cfg.block_size * 3, 61_000.0, cfg.input_rate, -20.0)
    audio = []
    for b in np.split(x0, 3):
        stack = (gains[:, None] * b[None, :]).astype(np.complex64)
        out = drx.process(jnp.asarray(stack))
        audio.append(np.asarray(out.audio))
    g = np.asarray(drx.last_gains)
    np.testing.assert_allclose(np.abs(g), np.abs(gains), atol=0.05)
    a = np.concatenate(audio)[2048:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f_pk = np.fft.rfftfreq(len(a), 1 / cfg.output_rate)[int(np.argmax(spec))]
    assert abs(f_pk - 1000.0) < 80.0, f_pk
