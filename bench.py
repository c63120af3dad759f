"""Benchmark harness: IQ megasamples/s/chip through the full receiver chain.

Prints ONE JSON line:
  {"metric": "iq_msps_per_chip", "value": N, "unit": "Msamples/s", "vs_baseline": N}

Baseline: the reference sustains a 2 MSPS complex stream in real time on one
~3 GHz x86 core (BASELINE.md); vs_baseline = measured_Msps / 2.0.

The benchmark streams synthetic IQ through the flagship config (2 MSPS USB:
fused mix+decimate ×32 → 2048-pt FFT overlap-save bandpass → parallel
S-meter/AGC → SSB demod → rational-polyphase 48 kHz resample), state
chained between steps, input resident on device.  Per-step time is the
slope between two chained run lengths, each ended by a scalar readback
(see bench_receiver).  Details go to stderr; any failure is an error.
"""

import json
import sys
import time

import numpy as np


def bench_receiver(frames_per_block=256, k1=4, k2=64, reps=5):
    """Device throughput of the production receiver step: per-step time
    is the SLOPE between two chained lengths, each fenced by a scalar
    device->host readback, so the fixed readback latency cancels."""
    import jax
    import jax.numpy as jnp

    from cutesdr_tpu.pipeline import receiver as rx

    cfg = rx.ReceiverConfig(input_rate=2_000_000.0, mode="usb",
                            tune_freq=100_000.0, audio_rate=48000.0,
                            frames_per_block=frames_per_block)
    params, state = rx.init(cfg)
    print(f"decimator: {cfg.decimator_impl}", file=sys.stderr)

    @jax.jit
    def step(params, state, re, im):
        # complex formed on device from f32 planes, as the production
        # ingest path ships them
        return rx.receiver_step(cfg, params, state, jax.lax.complex(re, im))

    rng = np.random.default_rng(7)
    re = jax.device_put(jnp.asarray(
        rng.standard_normal(cfg.block_size).astype(np.float32) * 100))
    im = jax.device_put(jnp.asarray(
        rng.standard_normal(cfg.block_size).astype(np.float32) * 100))

    def fence(out):
        return float(jnp.sum(out.audio))      # D2H readback = real fence

    t0 = time.perf_counter()
    state, out = step(params, state, re, im)
    fence(out)
    print(f"compile+warmup: {time.perf_counter() - t0:.1f}s  "
          f"block={cfg.block_size}", file=sys.stderr)

    pers = []
    for rep in range(reps):
        ts = {}
        for k in (k1, k2):
            t0 = time.perf_counter()
            s = state
            for _ in range(k):
                s, out = step(params, s, re, im)
            fence(out)
            ts[k] = time.perf_counter() - t0
        per = (ts[k2] - ts[k1]) / (k2 - k1)
        if per <= 0:
            raise RuntimeError(f"rep {rep}: non-positive slope "
                               f"{per * 1e3:.3f} ms")
        pers.append(per)
        print(f"rep {rep}: slope {per * 1e3:.3f} ms/step -> "
              f"{cfg.block_size / per / 1e6:.1f} Msps", file=sys.stderr)

    # headline = median of the per-rep slopes; spread + n alongside
    msps_all = sorted(cfg.block_size / p / 1e6 for p in pers)
    msps = float(np.median(msps_all))
    stats = {"n": reps, "min": round(msps_all[0], 2),
             "max": round(msps_all[-1], 2),
             "best": round(msps_all[-1], 2),
             "spread_pct": round(100.0 * (msps_all[-1] - msps_all[0])
                                 / msps, 1)}
    print(f"receiver median-of-{reps} slope: {msps:.1f} Msps "
          f"(min {stats['min']}, max {stats['max']}, "
          f"spread {stats['spread_pct']}%)", file=sys.stderr)
    return msps, stats


def main():
    import jax

    from cutesdr_tpu.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)
    msps, stats = bench_receiver()
    print(json.dumps({
        "metric": "iq_msps_per_chip",
        "value": round(msps, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / 2.0, 2),
        "stats": stats,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
