"""chip_smoke.py: refuses to run without GPUs, and its multi-card checks
hold on a virtual CPU mesh (the rehearsal of `--four-cards`)."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_chip_smoke_four_cards_needs_four_devices():
    gpu = SimpleNamespace(platform="gpu")
    cpu = SimpleNamespace(platform="cpu")
    for devices, count in (([gpu] * 3, 4), ([cpu] * 8, 4), ([cpu], 1),
                           ([], 1)):
        with pytest.raises(SystemExit):
            chip_smoke.check_devices(devices, count)
    chip_smoke.check_devices([gpu] * 4, 4)
    chip_smoke.check_devices([gpu], 1)


def test_chip_smoke_multi_card_checks_on_virtual_devices():
    """The four-card phase's three checks — time-sharded stream, channel-
    sharded bank, two-stage pipeline, each against one device — at a
    small configuration on four virtual CPU devices."""
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig

    devices = jax.devices()[:4]
    assert len(devices) == 4
    cfg = ReceiverConfig(input_rate=250_000.0, mode="usb",
                         tune_freq=20_000.0, audio_rate=48000.0)
    chip_smoke.check_time_sharded(cfg, devices)
    chip_smoke.check_channel_bank(
        cfg, [5_000.0 * (i + 1) for i in range(8)], devices)
    chip_smoke.check_pipelined(cfg, devices[:2])
