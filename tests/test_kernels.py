"""Pallas kernel equivalence tests (interpret mode on the CPU backend)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cutesdr_tpu.design.decimation_plan import plan_decimation
from cutesdr_tpu.kernels.mixdec import MixDecimate, supported
from cutesdr_tpu.ops import decimator, nco
from cutesdr_tpu.testbench.generators import tone

C64 = jnp.complex64


def _reference(plan, tune, x_blocks):
    """XLA-composed reference: nco.process then fused_process per block."""
    p_n, c_n = nco.init(tune, plan.in_rate)
    p_d, c_d = decimator.fused_init(plan)
    out = []
    for b in x_blocks:
        c_n, mixed = nco.process(p_n, c_n, jnp.asarray(b, C64))
        c_d, y = decimator.fused_process(plan, p_d, c_d, mixed)
        out.append(np.asarray(y))
    return np.concatenate(out)


def _kernel_run(md, x_blocks):
    carry = md.init_carry()
    got = []
    for b in x_blocks:
        carry, y = md(md.params, carry, jnp.asarray(b, C64))
        got.append(np.asarray(y))
    return np.concatenate(got)


def _noise(rng, n, scale):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("tune", [0.0, 123_456.7])
def test_mixdec_matches_xla_composition(rng, tune):
    plan = plan_decimation(2_000_000.0, 20_000.0)   # decimation 32
    md = MixDecimate(plan, tune, interpret=True)
    n_blk = 256 * md.D
    x = _noise(rng, 3 * n_blk, 1000)
    blocks = np.split(x, 3)
    want = _reference(plan, tune, blocks)
    got = _kernel_run(md, blocks)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale)


def test_mixdec_multi_tile_block(rng):
    plan = plan_decimation(500_000.0, 20_000.0)     # decimation 8
    md = MixDecimate(plan, 10_000.0, interpret=True)
    n_blk = (md.H + 4 * md.bm) * md.D               # 4 kernel programs
    assert md.split(n_blk)[1] == 4
    x = _noise(rng, n_blk, 100)
    want = _reference(plan, 10_000.0, [x])
    got = _kernel_run(md, [x])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale)


def test_mixdec_tone_lands_at_dc(rng):
    plan = plan_decimation(500_000.0, 20_000.0)
    f0 = 42_000.0
    md = MixDecimate(plan, f0, interpret=True)
    x = tone(2 * md.bm * md.D + md.T, f0, plan.in_rate, -20.0)
    x = x[:len(x) // md.D * md.D].astype(np.complex64)
    y = _kernel_run(md, [x])[md.halo // md.D + 1:]   # skip startup transient
    # tone at the tune frequency -> DC after mix+decimate: constant phasor
    assert np.std(np.abs(y)) < 1e-3 * np.mean(np.abs(y))
    ang = np.unwrap(np.angle(y))
    assert abs(ang[-1] - ang[0]) < 0.05


def test_receiver_with_pallas_decimator():
    """decimator_impl='pallas' matches the fused XLA receiver."""
    from cutesdr_tpu.pipeline.receiver import Receiver, ReceiverConfig

    kw = dict(input_rate=500_000.0, mode="usb", tune_freq=20_000.0,
              audio_rate=None, agc_on=False)
    rx_p = Receiver(ReceiverConfig(decimator_impl="pallas",
                                   pallas_interpret=True, **kw))
    rx_f = Receiver(ReceiverConfig(decimator_impl="fused", **kw))
    x = tone(rx_f.cfg.block_size * 2, 21_000.0, 500_000.0, -20.0)
    a_p, a_f = [], []
    for b in np.split(x, 2):
        a_p.append(np.asarray(rx_p.process(jnp.asarray(b, C64)).audio))
        a_f.append(np.asarray(rx_f.process(jnp.asarray(b, C64)).audio))
    a_p, a_f = np.concatenate(a_p), np.concatenate(a_f)
    scale = np.abs(a_f).max()
    np.testing.assert_allclose(a_p, a_f, atol=3e-4 * scale)


def test_mixdec_small_block_low_latency_config():
    """The serve low-latency path (small fastfir -> short block) works
    with the kernel: a block shorter than one program's outputs is all
    XLA head, longer ones split between head and kernel."""
    from dataclasses import replace

    from cutesdr_tpu.design.latency import choose_fastfir_sizes
    from cutesdr_tpu.pipeline.receiver import (Receiver, ReceiverConfig,
                                               _make_mixdec)

    base = choose_fastfir_sizes(
        ReceiverConfig(input_rate=250_000.0, mode="usb",
                       tune_freq=60_000.0, audio_rate=48000.0), 0.010)
    kw = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
              audio_rate=48000.0, fastfir_nfft=base.fastfir_nfft,
              fastfir_ntaps=base.fastfir_ntaps)
    cfg_p = ReceiverConfig(decimator_impl="pallas", pallas_interpret=True,
                           **kw)
    cfg_x = replace(cfg_p, decimator_impl="fused", pallas_interpret=False)
    head, progs = _make_mixdec(cfg_p).split(cfg_p.block_size)
    assert head + progs * _make_mixdec(cfg_p).bm == \
        cfg_p.block_size // cfg_p.plan.decimation
    x = tone(cfg_p.block_size * 2, 61_000.0, 250_000.0, -20.0)
    rx_p, rx_x = Receiver(cfg_p), Receiver(cfg_x)
    a_p = np.concatenate([np.asarray(rx_p.process(jnp.asarray(b, C64)).audio)
                          for b in np.split(x, 2)])
    a_x = np.concatenate([np.asarray(rx_x.process(jnp.asarray(b, C64)).audio)
                          for b in np.split(x, 2)])
    np.testing.assert_allclose(a_p, a_x, atol=5e-4 * np.abs(a_x).max())


def test_mixdec_wide_decimation_matches_xla(rng):
    """Decimation 256 (the 20 MSPS plan): 8.5k composed taps over 35 tap
    rows of 256 lanes must match the XLA-composed NCO + fused decimator."""
    plan = plan_decimation(16_000_000.0, 20_000.0)
    assert plan.decimation == 256, plan.decimation
    tune = 1_234_567.0
    md = MixDecimate(plan, tune, interpret=True)
    n = (md.H + 2 * md.bm + 5) * md.D
    blocks = np.split(_noise(rng, 2 * n, 100), 2)
    want = _reference(plan, tune, blocks)
    got = _kernel_run(md, blocks)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-5 * scale)


# input rates whose usb plan decimates by 2 ... 512
RATE_FOR_D = {2: 125_000.0, 4: 250_000.0, 8: 500_000.0, 16: 1e6, 32: 2e6,
              64: 4e6, 128: 8e6, 256: 16e6, 512: 32e6}


@pytest.mark.parametrize("D", sorted(RATE_FOR_D))
def test_mixdec_every_decimation(rng, D):
    """Every decimation the kernel accepts (powers of two 2 ... 512),
    chained across a carry boundary, with blocks that leave a head longer
    than the history rows: kernel == XLA nco + fused decimator."""
    plan = plan_decimation(RATE_FOR_D[D], 20_000.0)
    assert plan.decimation == D and supported(D)
    tune = RATE_FOR_D[D] / 7.3
    md = MixDecimate(plan, tune, interpret=True)
    n = (md.H + 2 * md.bm + 3) * D
    head, progs = md.split(n)
    assert progs == 2 and head == md.H + 3
    blocks = np.split(_noise(rng, 2 * n, 100), 2)
    want = _reference(plan, tune, blocks)
    got = _kernel_run(md, blocks)
    np.testing.assert_allclose(got, want, atol=5e-5 * np.abs(want).max())


def test_mixdec_split_and_tap_rows():
    """The head/kernel split covers every output exactly once with all
    kernel rows in bounds, and the padded tap rows hold the taps in order
    behind H*D - T front zeros."""
    for D in sorted(RATE_FOR_D):
        md = MixDecimate(plan_decimation(RATE_FOR_D[D], 20_000.0), 0.0,
                         interpret=True)
        assert md.Q == md.H + 1 and md.bm * D == 4096
        for n_out in (1, md.H, md.H + 1, md.H + md.bm, 3 * md.bm + 7):
            head, progs = md.split(n_out * D)
            assert head + progs * md.bm == n_out
            if progs:
                assert head >= md.H                  # first row >= 0
    assert not supported(1) and not supported(1024) and not supported(48)
    with pytest.raises(ValueError):
        MixDecimate(plan_decimation(64e6, 20_000.0), 0.0)


def test_pallas_decimator_needs_gpu_or_interpret():
    """Off the GPU an explicit decimator_impl='pallas' raises instead of
    quietly interpreting; pallas_interpret=True is the test-only way in."""
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig

    with pytest.raises(ValueError, match="GPU"):
        ReceiverConfig(decimator_impl="pallas")
    ReceiverConfig(decimator_impl="pallas", pallas_interpret=True)
    assert ReceiverConfig().decimator_impl == "fused"      # cpu auto
    with pytest.raises(ValueError):
        ReceiverConfig(input_rate=64e6, decimator_impl="pallas",
                       pallas_interpret=True)


def test_mixdec_process_planes_matches_call(rng):
    """The plane-native entry (separate re/im planes, DC cal in the
    epilogue — the production receiver path) equals __call__ with the DC
    offset pre-subtracted, across a carry boundary, once the carried raw
    history no longer reaches the output."""
    for in_rate in (2_000_000.0, 16_000_000.0):
        plan = plan_decimation(in_rate, 20_000.0)
        md = MixDecimate(plan, in_rate / 17.0, interpret=True)
        n = (md.H + 2 * md.bm + 1) * md.D
        x = _noise(rng, 2 * n, 100)
        dc = np.complex64(0.37 - 0.21j)

        c1 = md.init_carry()
        c2 = md.init_carry()
        got, want = [], []
        for b in np.split(x, 2):
            xb = jnp.asarray(b)
            c1, y1 = md.process_planes(md.params, c1, xb.real, xb.imag,
                                       jnp.asarray(dc))
            c2, y2 = md(md.params, c2, xb - dc)
            got.append(np.asarray(y1))
            want.append(np.asarray(y2))
        got, want = np.concatenate(got), np.concatenate(want)
        scale = np.abs(want).max()
        # the tail carried by process_planes is raw (pre-DC), __call__'s is
        # DC-removed: the outputs whose window reaches the carried history
        # differ by the DC response of the composed filter
        d = np.abs(got - want)
        h = md.H + 1
        nb = n // md.D
        assert d[h:nb].max() < 5e-5 * scale
        assert d[nb + h:].max() < 5e-5 * scale
