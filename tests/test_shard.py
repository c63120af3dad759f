"""Sharding tests on the 8-device virtual CPU mesh: exactness of the
time-sharded front-end vs the single-chip receiver, and channel banks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cutesdr_tpu.pipeline.receiver import Receiver, ReceiverConfig
from cutesdr_tpu.shard import ChannelBank, ShardedReceiver, make_mesh
from cutesdr_tpu.testbench.generators import GenConfig, SignalGenerator, tone

C64 = jnp.complex64

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _stream(cfg, n_superblocks, n_dev):
    gen = SignalGenerator(GenConfig(sample_rate=cfg.input_rate,
                                    sweep_start_hz=19_000.0,
                                    sweep_stop_hz=22_000.0,
                                    sweep_rate_hz_per_sec=1e4,
                                    signal_power_db=-20.0,
                                    noise_power_db=-50.0))
    return gen.next_block(cfg.block_size * n_dev * n_superblocks)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_timeshard_matches_single_chip(n_dev):
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb",
                         tune_freq=20_000.0, audio_rate=48000.0)
    mesh = make_mesh(time=n_dev)
    x = _stream(cfg, 2, n_dev)

    srx = ShardedReceiver(cfg, mesh)
    rx = Receiver(cfg)

    for sb in range(2):
        xs = x[sb * srx.superblock_size:(sb + 1) * srx.superblock_size]
        out_s = srx.process(jnp.asarray(xs, C64))
        audio_s = np.asarray(out_s.audio)[:int(out_s.n_audio)]
        # single-chip processes the same superblock in n_dev blocks
        ref_audio = []
        for b in range(n_dev):
            o = rx.process(jnp.asarray(
                xs[b * cfg.block_size:(b + 1) * cfg.block_size], C64))
            ref_audio.append(np.asarray(o.audio)[:int(o.n_audio)])
        ref_audio = np.concatenate(ref_audio)
        assert len(audio_s) == len(ref_audio)
        scale = max(np.abs(ref_audio).max(), 1e-6)
        np.testing.assert_allclose(audio_s, ref_audio, atol=5e-4 * scale)
        np.testing.assert_allclose(float(out_s.smeter_ave_db),
                                   float(o.smeter_ave_db), atol=0.1)


def test_timeshard_stateful_across_superblocks():
    """Carry handoff: processing 3 superblocks through the sharded receiver
    equals one long single-chip run (no seams at superblock boundaries)."""
    cfg = ReceiverConfig(input_rate=500_000.0, mode="am",
                         tune_freq=100_000.0, audio_rate=None, agc_on=False)
    n_dev = 4
    mesh = make_mesh(time=n_dev)
    fs = cfg.input_rate
    n = cfg.block_size * n_dev * 3
    t = np.arange(n) / fs
    env = 3000.0 * (1.0 + 0.5 * np.cos(2 * np.pi * 400.0 * t))
    x = env * np.exp(1j * 2 * np.pi * 100_000.0 * t)

    srx = ShardedReceiver(cfg, mesh)
    rx = Receiver(cfg)
    got, want = [], []
    for sb in range(3):
        xs = x[sb * srx.superblock_size:(sb + 1) * srx.superblock_size]
        got.append(np.asarray(srx.process(jnp.asarray(xs, C64)).audio))
        for b in range(n_dev):
            want.append(np.asarray(rx.process(jnp.asarray(
                xs[b * cfg.block_size:(b + 1) * cfg.block_size], C64)).audio))
    got, want = np.concatenate(got), np.concatenate(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-3 * scale)


def test_channel_bank_unsharded():
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb", audio_rate=None,
                         agc_on=False)
    freqs = [10_000.0, 50_000.0, 120_000.0, 200_000.0]
    bank = ChannelBank(cfg, freqs)
    # put a tone on channel 2's frequency (+1 kHz audio)
    x = tone(cfg.block_size * 2, 120_000.0 + 1000.0, cfg.input_rate, -20.0)
    for b in range(2):
        out = bank.process(jnp.asarray(
            x[b * cfg.block_size:(b + 1) * cfg.block_size], C64))
    audio = np.asarray(out.audio)          # [4, block]
    powers = (audio ** 2).mean(axis=1)
    assert powers[2] > 100 * powers[0]
    assert powers[2] > 100 * powers[1]
    assert powers[2] > 100 * powers[3]


def test_channel_bank_sharded_matches_unsharded():
    cfg = ReceiverConfig(input_rate=250_000.0, mode="am", audio_rate=None,
                         agc_on=False)
    freqs = [5_000.0 * (i + 1) for i in range(8)]
    mesh = make_mesh(channels=4)
    x = tone(cfg.block_size, 20_000.0, cfg.input_rate, -20.0)

    bank_s = ChannelBank(cfg, freqs, mesh=mesh)
    bank_u = ChannelBank(cfg, freqs)
    out_s = bank_s.process(jnp.asarray(x, C64))
    out_u = bank_u.process(jnp.asarray(x, C64))
    scale = np.abs(np.asarray(out_u.audio)).max()
    np.testing.assert_allclose(np.asarray(out_s.audio),
                               np.asarray(out_u.audio), atol=1e-5 * scale)


def test_timeshard_pallas_mixdec_matches_single_chip():
    """The Pallas fused mix+decimate kernel inside the time-sharded
    receiver (raw-sample halos, per-shard phase_base offset) must match the
    single-chip receiver — lifting round-1's decimator_impl=='fused'
    restriction so the kernel's front-end win survives sharding
    (kernels/mixdec.py; interpret mode on the CPU mesh)."""
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb",
                         tune_freq=20_000.0, audio_rate=48000.0,
                         decimator_impl="pallas", pallas_interpret=True)
    n_dev = 4
    mesh = make_mesh(time=n_dev)
    x = _stream(cfg, 2, n_dev)

    srx = ShardedReceiver(cfg, mesh)
    rx = Receiver(cfg)
    for sb in range(2):
        xs = x[sb * srx.superblock_size:(sb + 1) * srx.superblock_size]
        out_s = srx.process(jnp.asarray(xs, C64))
        audio_s = np.asarray(out_s.audio)[:int(out_s.n_audio)]
        ref_audio = []
        for b in range(n_dev):
            o = rx.process(jnp.asarray(
                xs[b * cfg.block_size:(b + 1) * cfg.block_size], C64))
            ref_audio.append(np.asarray(o.audio)[:int(o.n_audio)])
        ref_audio = np.concatenate(ref_audio)
        assert len(audio_s) == len(ref_audio)
        scale = max(np.abs(ref_audio).max(), 1e-6)
        np.testing.assert_allclose(audio_s, ref_audio, atol=5e-4 * scale)


def test_timeshard_with_noise_blanker(rng):
    """Blanker in sharded mode (raw-history halos) matches single chip."""
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb",
                         tune_freq=50_000.0, audio_rate=None, agc_on=False,
                         nb_on=True, nb_threshold=40.0, nb_width_us=20.0)
    n_dev = 4
    mesh = make_mesh(time=n_dev)
    n = cfg.block_size * n_dev * 2
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 50
    x = x.astype(np.complex64)
    x[10_000] = 500_000.0            # impulses to blank
    x[25_000] = -400_000.0j
    x[int(cfg.block_size * 4.5)] = 300_000.0 + 300_000.0j

    srx = ShardedReceiver(cfg, mesh)
    rx = Receiver(cfg)
    got, want = [], []
    for sb in range(2):
        xs = x[sb * srx.superblock_size:(sb + 1) * srx.superblock_size]
        got.append(np.asarray(srx.process(jnp.asarray(xs, C64)).audio))
        for b in range(n_dev):
            want.append(np.asarray(rx.process(jnp.asarray(
                xs[b * cfg.block_size:(b + 1) * cfg.block_size], C64)).audio))
    got, want = np.concatenate(got), np.concatenate(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-3 * scale)


def test_channel_bank_probes():
    """bank_receiver_step threads the testbench probe taps with a leading
    channel axis (round-1 VERDICT item 9)."""
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb", audio_rate=None,
                         agc_on=False, probes=True)
    freqs = [10_000.0, 120_000.0]
    bank = ChannelBank(cfg, freqs)
    x = tone(cfg.block_size, 120_000.0 + 1000.0, cfg.input_rate, -20.0)
    out = bank.process(jnp.asarray(x, C64))
    n_dec = cfg.block_size // cfg.plan.decimation
    for key in ("p1_downconvert", "p2_fastfir", "p3_agc", "p4_demod"):
        assert out.probes[key].shape[:2] == (2, n_dec), key
    # the tone sits on channel 1's passband: its p2 power dominates
    p2 = np.asarray(out.probes["p2_fastfir"])
    pw = np.mean(np.abs(p2) ** 2, axis=1)
    assert pw[1] > 100 * pw[0]


def test_timeshard_probes_match_single_chip():
    """Sharded probe taps (all_gathered per-shard streams) equal the
    single-chip probe captures block for block."""
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb",
                         tune_freq=20_000.0, audio_rate=None, agc_on=False,
                         probes=True)
    n_dev = 4
    mesh = make_mesh(time=n_dev)
    x = _stream(cfg, 1, n_dev)

    srx = ShardedReceiver(cfg, mesh)
    rx = Receiver(cfg)
    out_s = srx.process(jnp.asarray(x, C64))
    p1_ref, p2_ref = [], []
    for b in range(n_dev):
        o = rx.process(jnp.asarray(
            x[b * cfg.block_size:(b + 1) * cfg.block_size], C64))
        p1_ref.append(np.asarray(o.probes["p1_downconvert"]))
        p2_ref.append(np.asarray(o.probes["p2_fastfir"]))
    p1_ref, p2_ref = np.concatenate(p1_ref), np.concatenate(p2_ref)
    for key, ref in (("p1_downconvert", p1_ref), ("p2_fastfir", p2_ref)):
        got = np.asarray(out_s.probes[key])
        assert got.shape == ref.shape, key
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, atol=5e-4 * scale,
                                   err_msg=key)


def test_stacked_receiver_dual_channel():
    """Twin chains over two independent streams (dual-ADC radio)."""
    from cutesdr_tpu.shard import StackedReceiver

    cfg = ReceiverConfig(input_rate=250_000.0, mode="usb", audio_rate=None,
                         agc_on=False)
    rx2 = StackedReceiver(cfg, [20_000.0, 60_000.0])
    n = cfg.block_size
    x1 = tone(2 * n, 21_000.0, cfg.input_rate, -20.0)     # ch1's band
    x2 = tone(2 * n, 61_000.0, cfg.input_rate, -20.0)     # ch2's band
    for b in range(2):
        out = rx2.process(np.stack([x1[b * n:(b + 1) * n],
                                    x2[b * n:(b + 1) * n]]).astype(np.complex64))
    audio = np.asarray(out.audio)
    assert audio.shape[0] == 2
    assert np.mean(audio[0] ** 2) > 1e3      # both channels demodulate
    assert np.mean(audio[1] ** 2) > 1e3
    # swap check: feeding ch2's tone to ch1 yields silence
    rx3 = StackedReceiver(cfg, [20_000.0, 60_000.0])
    out3 = rx3.process(np.stack([x2[:n], x1[:n]]).astype(np.complex64))
    a3 = np.asarray(out3.audio)
    assert np.mean(a3[0] ** 2) < 1e-2 * np.mean(audio[0] ** 2)


def test_decode_dual_packet():
    from cutesdr_tpu.io.netsdr import decode_iq_packet_dual
    import struct
    data = np.zeros(512, "<i2")
    data[0::4] = 1      # I1
    data[1::4] = 2      # Q1
    data[2::4] = 3      # I2
    data[3::4] = 4      # Q2
    pkt = struct.pack("<HH", 0x8204, 5) + data.tobytes()
    seq, c1, c2 = decode_iq_packet_dual(pkt)
    assert seq == 5
    np.testing.assert_allclose(c1, np.full(128, 1 + 2j))
    np.testing.assert_allclose(c2, np.full(128, 3 + 4j))


def test_channel_bank_pallas_decimator_per_channel_tuning():
    """With decimator_impl='pallas' the kernel owns the oscillator: the bank
    must program per-channel phase increments into the kernel params too
    (regression: all channels silently shared one tune frequency)."""
    import numpy as np
    import jax.numpy as jnp

    from cutesdr_tpu.pipeline.receiver import ReceiverConfig
    from cutesdr_tpu.shard.channels import ChannelBank

    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb", audio_rate=None,
                         agc_on=False, decimator_impl="pallas",
                         pallas_interpret=True)
    freqs = [20_000.0, 60_000.0]
    bank = ChannelBank(cfg, freqs)
    n = cfg.block_size
    t = np.arange(2 * n) / cfg.input_rate
    # tones 1.5 kHz above each channel's tune -> 1.5 kHz audio in both
    x = (8000.0 * (np.exp(2j * np.pi * 21_500.0 * t)
                   + np.exp(2j * np.pi * 61_500.0 * t))).astype(np.complex64)
    audio = []
    for b in np.split(x, 2):
        out = bank.process(jnp.asarray(b))
        audio.append(np.asarray(out.audio))
    a = np.concatenate(audio, axis=-1)
    fs_out = cfg.plan.out_rate
    for ch in range(2):
        y = a[ch]
        spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
        f = np.fft.rfftfreq(len(y), 1.0 / fs_out)
        pk = f[np.argmax(spec)]
        assert abs(pk - 1500.0) < 40.0, (ch, pk)

def test_channel_bank_fm_matches_single_receivers():
    """FM bank (bank-voted PLL; one real lax.cond instead of per-channel
    select under vmap) matches per-channel Receiver runs, sharded and not."""
    cfg = ReceiverConfig(input_rate=250_000.0, mode="fm", audio_rate=None,
                         agc_on=False, squelch_ui=0)
    freqs = [20_000.0, 60_000.0, 100_000.0, 140_000.0]
    fs = cfg.input_rate
    n = cfg.block_size * 3
    t = np.arange(n) / fs
    x = sum(3000.0 * np.exp(1j * (2 * np.pi * f * t
                                  + (2000.0 / m) * np.sin(2 * np.pi * m * t)))
            for f, m in zip(freqs, (300.0, 500.0, 700.0, 900.0)))

    bank = ChannelBank(cfg, freqs)
    mesh = make_mesh(channels=4)
    bank_s = ChannelBank(cfg, freqs, mesh=mesh)
    singles = [Receiver(ReceiverConfig(input_rate=cfg.input_rate, mode="fm",
                                       audio_rate=None, agc_on=False,
                                       squelch_ui=0, tune_freq=f))
               for f in freqs]
    for b in range(3):
        blk = jnp.asarray(x[b * cfg.block_size:(b + 1) * cfg.block_size], C64)
        out = bank.process(blk)
        out_s = bank_s.process(blk)
        for i, r in enumerate(singles):
            o = r.process(blk)
            scale = max(float(np.abs(np.asarray(o.audio)).max()), 1e-3)
            np.testing.assert_allclose(np.asarray(out.audio[i]),
                                       np.asarray(o.audio),
                                       atol=2e-3 * scale)
            np.testing.assert_allclose(np.asarray(out_s.audio[i]),
                                       np.asarray(o.audio),
                                       atol=2e-3 * scale)
