"""Smoke run of the receiver on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py                # one card: phases 1-5 below
    python chip_smoke.py --four-cards   # four cards: the multi-card paths only

One card:
  1. device: the card's name and power limit, JAX's device, the
     device->host readback floor, and whether complex64 crosses the
     host<->device boundary;
  2. the flagship stream (2 MSPS USB, 8,388,608-sample blocks) through
     Receiver.process_host: a tone at tune + 1 kHz must come out at 1 kHz,
     > 60 dB above the spectrum floor;
  3. the CLI (`cutesdr-tpu run --source=sweep`) in this process: a
     non-empty WAV;
  4. the reference-binary fixtures replayed through the f32 chain, each SNR
     against its pinned bound (tests/fixtures, cutesdr_tpu/testbench/
     refgold.py);
  5. one block each of the 20 MSPS receiver, the 64-channel bank from one
     10 MSPS stream, FM and SAM on pure noise, and the x16 plan: compile
     and block times, nothing asserted about speed.
Four cards: the time-sharded stream, the channel-sharded 64-channel bank
and the two-stage pipeline, each checked against one card.

Every check that fails ends the run with a non-zero exit.  The last line
of standard output is one JSON object naming the device.  Without a GPU
the run stops in phase 1 with a non-zero exit and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = dict(input_rate=2_000_000.0, mode="usb", tune_freq=100_000.0,
                audio_rate=48_000.0, frames_per_block=256)
BANK_RATE = 10_000_000.0
BANK_FREQS = [-4.5e6 + 140_000.0 * i for i in range(64)]
SHARD_BOUND = 5e-4       # sharded vs single card, relative to audio scale


def log(*a):
    print(*a, flush=True)


def check_devices(devices, count: int) -> None:
    """Refuse to run anywhere but on ``count`` or more GPUs."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "nothing"
        raise SystemExit(f"chip_smoke needs an NVIDIA GPU; JAX found "
                         f"{found}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX found "
                         f"{len(devices)}")


def _tone(n, f0, fs, n0=0, amp=3000.0):
    ph = 2 * np.pi * f0 / fs * (n0 + np.arange(n, dtype=np.float64))
    return (amp * np.exp(1j * ph)).astype(np.complex64)


def _timed(f, *a):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*a))
    return out, time.perf_counter() - t0


# ------------------------------------------------------------- one card --

def phase_device():
    import jax

    from cutesdr_tpu.design.latency import measure_readback_floor

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
        f"jax {jax.__version__}")
    log(f"readback floor: {measure_readback_floor() * 1e6:.1f} us")
    z = np.array([1 + 2j, -3.5 - 0.25j], np.complex64)
    back = np.asarray(jax.device_put(z) * 2)
    ok = bool(np.array_equal(back, z * 2))
    log(f"complex64 host->device->host round trip: "
        f"{'exact' if ok else 'WRONG'}")
    if not ok:
        raise SystemExit("complex64 round trip through the card failed")


def phase_flagship(blocks: int = 5):
    import jax

    from cutesdr_tpu.pipeline.receiver import Receiver, ReceiverConfig

    cfg = ReceiverConfig(**FLAGSHIP)
    rx = Receiver(cfg)
    n, fs = cfg.block_size, cfg.input_rate
    rng = np.random.default_rng(1)
    log(f"flagship: block {n}, decimation x{cfg.plan.decimation}, "
        f"decimator {cfg.decimator_impl}")
    re0 = np.zeros(n, np.float32)
    t0 = time.perf_counter()
    compiled = rx._step_planes.lower(rx.params, rx.state, re0, re0).compile()
    log(f"flagship: compile {time.perf_counter() - t0:.2f} s, "
        f"{compiled.memory_analysis()}")
    audio, walls = [], []
    for b in range(blocks):
        x = _tone(n, cfg.tune_freq + 1000.0, fs, n0=b * n)
        x += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
              ).astype(np.complex64)
        t0 = time.perf_counter()
        out = jax.block_until_ready(rx.process_host(x))
        walls.append(time.perf_counter() - t0)
        if b:
            audio.append(np.asarray(out.audio)[:int(out.n_audio)])
    log(f"flagship: first block {walls[0] * 1e3:.2f} ms, steady "
        f"{np.median(walls[1:]) * 1e3:.3f} ms/block (median of "
        f"{blocks - 1}, host->device planes included)")
    a = np.concatenate(audio)
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1.0 / cfg.audio_rate)
    k = int(np.argmax(spec))
    ratio = 20 * np.log10(spec[k] / np.median(spec))
    log(f"flagship: audio peak {f[k]:.2f} Hz, {ratio:.1f} dB above floor")
    if abs(f[k] - 1000.0) > 2.0 or not ratio > 60.0:
        raise SystemExit("flagship: the 1 kHz tone did not come through")


def phase_cli():
    from cutesdr_tpu import cli

    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "smoke.wav")
        t0 = time.perf_counter()
        rc = cli.main(["run", "--source=sweep", "--fs=2e6", "--mode=usb",
                       "--seconds=1", f"--out={wav}"])
        size = os.path.getsize(wav) if os.path.exists(wav) else 0
    log(f"cli run: rc {rc}, wav {size} bytes, "
        f"{time.perf_counter() - t0:.2f} s")
    if rc != 0 or size <= 44:
        raise SystemExit("cli run wrote no audio")


def phase_fixtures():
    from cutesdr_tpu.testbench import refgold

    failed = []

    def report(name, snr, bound, extra=True):
        ok = snr > bound and extra
        log(f"fixture {name}: {snr:.1f} dB (bound {bound}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)

    for name in refgold.NAMES:
        report(name, *refgold.production(name))
    report("sam_stereo", *refgold.stereo_sam())
    snr, bound, n_got, n_ref = refgold.resampler()
    report(f"resampler ({n_got}/{n_ref} outputs)", snr, bound,
           n_got == n_ref)
    snr, bound, same = refgold.blanker()
    report(f"blanker (same blanked set: {same})", snr, bound, same)
    if failed:
        raise SystemExit(f"fixtures below their bounds: {failed}")


def _one_block(name, cfg, x):
    from cutesdr_tpu.pipeline.receiver import Receiver

    rx = Receiver(cfg)
    out, first = _timed(rx.process_host, x)
    out, second = _timed(rx.process_host, x)
    audio = np.asarray(out.audio)
    if not np.all(np.isfinite(audio)):
        raise SystemExit(f"{name}: non-finite audio")
    log(f"{name}: block {cfg.block_size}, decimator {cfg.decimator_impl}, "
        f"compile+first {first:.2f} s, block {second * 1e3:.3f} ms")


def phase_configs():
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig
    from cutesdr_tpu.shard import ChannelBank

    rng = np.random.default_rng(5)

    def noise(n, amp):
        return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                * amp).astype(np.complex64)

    cfg = ReceiverConfig(input_rate=20_000_000.0, mode="usb",
                         audio_rate=48_000.0, frames_per_block=16)
    _one_block("usb_20msps", cfg, noise(cfg.block_size, 300.0))

    cfg = ReceiverConfig(input_rate=BANK_RATE, mode="usb",
                         audio_rate=48_000.0)
    bank = ChannelBank(cfg, BANK_FREQS)
    x = noise(cfg.block_size, 300.0)
    out, first = _timed(bank.process_host, x)
    out, second = _timed(bank.process_host, x)
    if not np.all(np.isfinite(np.asarray(out.audio))):
        raise SystemExit("bank64: non-finite audio")
    log(f"bank64_10msps: {len(BANK_FREQS)} channels, block "
        f"{cfg.block_size}, compile+first {first:.2f} s, block "
        f"{second * 1e3:.3f} ms")

    for mode in ("fm", "sam"):
        cfg = ReceiverConfig(input_rate=2_000_000.0, mode=mode,
                             audio_rate=48_000.0, frames_per_block=16)
        _one_block(f"{mode}_noise_2msps", cfg, noise(cfg.block_size, 300.0))

    cfg = ReceiverConfig(input_rate=1_000_000.0, mode="usb",
                         audio_rate=48_000.0, frames_per_block=16)
    assert cfg.plan.decimation == 16
    _one_block("usb_1msps_x16", cfg, noise(cfg.block_size, 300.0))


# ----------------------------------------------------------- four cards --

def _spread(arr, want: int, what: str):
    devs = arr.sharding.device_set
    log(f"{what}: placed on {len(devs)} devices "
        f"{sorted(d.id for d in devs)}")
    if len(devs) != want:
        raise SystemExit(f"{what}: expected {want} devices")


def check_time_sharded(cfg, devices, superblocks: int = 2):
    """ShardedReceiver over len(devices) cards == one-card Receiver."""
    import jax

    from cutesdr_tpu.pipeline.receiver import Receiver
    from cutesdr_tpu.shard import ShardedReceiver, make_mesh

    n_dev = len(devices)
    srx = ShardedReceiver(cfg, make_mesh(time=n_dev, devices=devices))
    single = Receiver(cfg)
    f0 = cfg.tune_freq + 1000.0
    for sb in range(superblocks):
        n0 = sb * srx.superblock_size
        xs = _tone(srx.superblock_size, f0, cfg.input_rate, n0=n0)
        re = jax.device_put(np.real(xs).astype(np.float32), srx._x_sharding)
        if sb == 0:
            _spread(re, n_dev, "time-sharded superblock")
        out = srx.process_host(xs)
        got = np.asarray(out.audio)[:int(out.n_audio)]
        ref = []
        for b in range(n_dev):
            o = single.process_host(
                xs[b * cfg.block_size:(b + 1) * cfg.block_size])
            ref.append(np.asarray(o.audio)[:int(o.n_audio)])
        ref = np.concatenate(ref)
        if got.shape != ref.shape:
            raise SystemExit(f"time-sharded: shape {got.shape} vs "
                             f"{ref.shape}")
        scale = max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(got - ref).max()) / scale
        log(f"time-sharded x{n_dev}, superblock {srx.superblock_size}: "
            f"max rel err {err:.3g} (bound {SHARD_BOUND})")
        if not err <= SHARD_BOUND or np.abs(got).max() < 1e-2 * scale:
            raise SystemExit("time-sharded stream differs from one card")


def check_channel_bank(cfg, freqs, devices):
    """ChannelBank over a len(devices)-card channel mesh == one receiver
    per channel (one program, retuned)."""
    from cutesdr_tpu.pipeline.receiver import Receiver, init
    from cutesdr_tpu.shard import ChannelBank, make_mesh

    n_dev = len(devices)
    quiet = len(freqs) - 1            # silent channel: S-meter contrast
    n2 = 2 * cfg.block_size
    x = np.zeros(n2, np.complex64)
    for ch in range(quiet):
        x += _tone(n2, freqs[ch] + 1000.0, cfg.input_rate) / len(freqs)
    bank = ChannelBank(cfg, freqs, mesh=make_mesh(channels=n_dev,
                                                  devices=devices))
    _spread(bank.params.nco.phase_inc, n_dev, "bank channel params")
    single = Receiver(cfg)
    blocks = [x[:cfg.block_size], x[cfg.block_size:]]
    outs = [bank.process_host(b) for b in blocks]
    bank_audio = np.asarray(outs[-1].audio)
    gscale = max(float(np.abs(bank_audio).max()), 1e-6)
    worst, worst_quiet = 0.0, 0.0
    for ch, f in enumerate(freqs):
        single.params, single.state = init(single.cfg)
        single.set_tune_freq(f)
        for b in blocks:
            o = single.process_host(b)
        ref = np.asarray(o.audio)
        err = float(np.abs(bank_audio[ch] - ref).max())
        if ch == quiet:
            worst_quiet = err / gscale
        else:
            worst = max(worst, err / max(float(np.abs(ref).max()), 1e-6))
    log(f"channel bank x{n_dev}, {len(freqs)} channels: max rel err "
        f"{worst:.3g} (bound {SHARD_BOUND}), quiet channel "
        f"{worst_quiet:.3g} of full scale (bound {10 * SHARD_BOUND})")
    sm = np.asarray(outs[-1].smeter_ave_db)
    if (not worst <= SHARD_BOUND or not worst_quiet <= 10 * SHARD_BOUND
            or not sm[0] > sm[quiet] + 20.0):
        raise SystemExit("channel-sharded bank differs from per-channel "
                         "receivers")


def check_pipelined(cfg, devices, blocks: int = 3):
    """PipelinedReceiver (front end on one card, audio tail on another,
    one block of delay) == one-card Receiver."""
    from cutesdr_tpu.pipeline.receiver import Receiver
    from cutesdr_tpu.shard import PipelinedReceiver

    pp = PipelinedReceiver(cfg, device_front=devices[0],
                           device_back=devices[1])
    single = Receiver(cfg)
    got, ref = [], []
    f0 = cfg.tune_freq + 1000.0
    for b in range(blocks):
        xb = _tone(cfg.block_size, f0, cfg.input_rate, n0=b * cfg.block_size)
        o = pp.process(xb)
        if o is not None:
            got.append(np.asarray(o.audio)[:int(o.n_audio)])
        o2 = single.process_host(xb)
        ref.append(np.asarray(o2.audio)[:int(o2.n_audio)])
    o = pp.flush()
    got.append(np.asarray(o.audio)[:int(o.n_audio)])
    got, ref = np.concatenate(got), np.concatenate(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max()) / scale if got.shape == ref.shape \
        else float("inf")
    log(f"pipelined on devices {devices[0].id},{devices[1].id}: max rel err "
        f"{err:.3g} (bound 1e-4)")
    if not err <= 1e-4:
        raise SystemExit("pipelined receiver differs from one card")


def four_cards(devices):
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig

    flagship = ReceiverConfig(**FLAGSHIP)
    check_time_sharded(flagship, devices[:4])
    bank_cfg = ReceiverConfig(input_rate=BANK_RATE, mode="usb",
                              audio_rate=48_000.0)
    check_channel_bank(bank_cfg, BANK_FREQS, devices[:4])
    check_pipelined(flagship, devices[:2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from cutesdr_tpu.cache import enable_compile_cache

    count = 4 if args.four_cards else 1
    check_devices(jax.devices(), count)
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(f"cards: {card}")
        four_cards(jax.devices())
    else:
        for phase in (phase_device, phase_flagship, phase_cli,
                      phase_fixtures, phase_configs):
            t = time.perf_counter()
            phase()
            log(f"[{phase.__name__} done in {time.perf_counter() - t:.1f} s]")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
