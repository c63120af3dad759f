"""Config-space fuzz: random valid receiver configurations must build,
run, and produce finite audio."""

import jax.numpy as jnp
import numpy as np
import pytest

from cutesdr_tpu.pipeline.receiver import (MODE_LIMITS, Receiver,
                                           ReceiverConfig)
from cutesdr_tpu.testbench.generators import tone

RATES = [196608.0, 250_000.0, 500_000.0, 614_400.0, 1_234_567.0, 2_000_000.0]


def _random_cfg(rng) -> ReceiverConfig:
    mode = rng.choice(list(MODE_LIMITS))
    hi_min, hi_max, low_min, low_max, _ = MODE_LIMITS[mode]
    hi = float(rng.uniform(hi_min, hi_max))
    lo = float(rng.uniform(low_min, min(low_max, hi - 50.0)))
    return ReceiverConfig(
        input_rate=float(rng.choice(RATES)),
        mode=mode, low_cut=lo, hi_cut=hi,
        tune_freq=float(rng.uniform(-0.3, 0.3)) * 100_000.0,
        agc_on=bool(rng.integers(2)),
        agc_hang=bool(rng.integers(2)),
        agc_thresh_db=float(rng.uniform(-140, -20)),
        agc_decay_ms=float(rng.uniform(20, 2000)),
        nb_on=bool(rng.integers(2)),
        squelch_ui=int(rng.integers(0, 99)),   # 99 would force mute
        stereo=bool(rng.integers(2)),
        audio_rate=48000.0 if rng.integers(2) else None,
    )


@pytest.mark.parametrize("seed", range(12))
def test_random_config_runs(seed):
    rng = np.random.default_rng(seed + 1000)
    cfg = _random_cfg(rng)
    rx = Receiver(cfg)
    x = tone(cfg.block_size, cfg.tune_freq + 500.0, cfg.input_rate, -25.0)
    x = x + (rng.standard_normal(cfg.block_size)
             + 1j * rng.standard_normal(cfg.block_size)) * 10.0
    out = rx.process(jnp.asarray(x, jnp.complex64))
    audio = np.asarray(out.audio)
    assert np.all(np.isfinite(audio)), cfg
    assert np.isfinite(float(out.smeter_ave_db)), cfg
    assert 0 <= int(out.n_audio) <= audio.shape[-1], cfg


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_auto_front_end_resolution_boundaries(backend):
    """resolve_front_end picks the mixdec kernel exactly when the plan is
    legal on the GPU with the f32 front, and the fused XLA conv elsewhere."""
    from cutesdr_tpu.pipeline.receiver import (mixdec_supported,
                                               resolve_front_end)

    want = "pallas" if backend == "gpu" else "fused"
    for d in (2, 4, 8, 16, 32, 64, 128, 256, 512):
        assert mixdec_supported(d)
        assert resolve_front_end(d, backend=backend) == want
        assert resolve_front_end(d, front_dtype="bf16",
                                 backend=backend) == "fused"
    for d in (1, 3, 48, 96, 1024, 2048):
        assert not mixdec_supported(d)
        assert resolve_front_end(d, backend=backend) == "fused"

    # random configs resolve to a runnable implementation here
    rng = np.random.default_rng(7)
    for _ in range(20):
        cfg = _random_cfg(rng)
        assert cfg.decimator_impl == "fused"


@pytest.mark.parametrize("seed", range(6))
def test_random_config_pallas_equivalence(seed):
    """Randomized front-end equivalence: for any legal config, the Pallas
    mixdec receiver (interpret mode) matches the fused XLA receiver —
    catches kernel layout/tile/padding edge cases across random rates,
    filter sizes, and block lengths (the fixed-tile bug class)."""
    from dataclasses import replace

    from cutesdr_tpu.pipeline.receiver import mixdec_supported

    rng = np.random.default_rng(seed + 2000)
    cfg = _random_cfg(rng)
    cfg = replace(cfg, agc_on=False, nb_on=False, stereo=False,
                  frames_per_block=int(rng.integers(1, 3)))
    if not mixdec_supported(cfg.plan.decimation):
        pytest.skip(f"decimation {cfg.plan.decimation} not mixdec-legal")
    # compare the FRONT-END taps (what the kernel computes) via probes —
    # demod audio through the PLL modes amplifies rounding chaotically
    cfg_p = replace(cfg, decimator_impl="pallas", pallas_interpret=True,
                    probes=True)
    cfg_f = replace(cfg, decimator_impl="fused", probes=True)

    x = tone(cfg.block_size * 2, cfg.tune_freq + 400.0, cfg.input_rate,
             -25.0)
    x = x + (rng.standard_normal(len(x))
             + 1j * rng.standard_normal(len(x))) * 20.0
    rx_p, rx_f = Receiver(cfg_p), Receiver(cfg_f)
    for b in np.split(x, 2):
        out_p = rx_p.process(jnp.asarray(b, jnp.complex64))
        out_f = rx_f.process(jnp.asarray(b, jnp.complex64))
        for tap in ("p1_downconvert", "p2_fastfir"):
            t_p = np.asarray(out_p.probes[tap])
            t_f = np.asarray(out_f.probes[tap])
            scale = max(np.abs(t_f).max(), 1e-3)
            np.testing.assert_allclose(
                t_p, t_f, atol=3e-4 * scale,
                err_msg=f"{tap}: {cfg_p}")


def test_mixdec_tile_legality_invariant():
    """For every rate, mode and filter size, the kernel's head/program
    split covers the block's outputs exactly once and every program reads
    input rows inside the block (kernels/mixdec.py)."""
    from cutesdr_tpu.pipeline.receiver import (ReceiverConfig, _make_mixdec,
                                               mixdec_supported)

    rates = [196608.0, 250_000.0, 500_000.0, 1e6, 2e6, 4e6, 10e6, 20e6]
    for fs in rates:
        for mode in ("usb", "am", "fm", "cwu"):
            for frames in (1, 2, 16):
                for nfft, ntaps in ((2048, 1025), (512, 257), (4096, 2049)):
                    cfg = ReceiverConfig(input_rate=fs, mode=mode,
                                         frames_per_block=frames,
                                         fastfir_nfft=nfft,
                                         fastfir_ntaps=ntaps,
                                         decimator_impl="fused")
                    D = cfg.plan.decimation
                    if not mixdec_supported(D):
                        continue
                    md = _make_mixdec(cfg)
                    n_out = cfg.block_size // D
                    head, progs = md.split(cfg.block_size)
                    assert head + progs * md.bm == n_out, cfg
                    if progs:
                        # first kernel row head-H >= 0, last row n_out-1
                        assert head >= md.H, cfg
                        assert md.Q - 1 == md.H, cfg
