"""End-to-end latency accounting and low-latency size selection.

The reference has no explicit latency budget; its latency falls out of the
~10 ms DSP block (dsp/demodulator.cpp:145-146), the 1025-tap channel filter's
group delay (dsp/fastfir.cpp:55-57) and the half-filled 16384-sample sound
queue (interface/soundout.cpp:312-334).  Here the same quantities are modeled
explicitly so a target latency can be traded against filter sharpness.

Components of one sample's input→audio delay:

* **block accumulation** — a block of ``cfg.block_size`` input samples must
  arrive before the step runs: ``block_size / input_rate`` (worst case; the
  *average* sample waits half that).
* **decimator group delay** — the composed half-band/CIC cascade is linear
  phase: ``(len(H_eq) - 1) / 2`` input samples.
* **channel-filter group delay** — the ntaps windowed-sinc bandpass is
  linear phase: ``(ntaps - 1) / 2`` decimated samples.
* **resampler group delay** — the 28-period interpolation sinc is centered:
  ``SINC_PERIODS / 2`` decimated samples.
* **audio queue** — the rate-locked output queue plays from its half-fill
  set point: ``OUTQSIZE / 2`` samples at the audio rate (only when an audio
  sink with the reference's queue is in the loop; the raw `Receiver` API has
  no queue).

Compute time is *not* modeled: on an accelerator the step runs far faster
than real time at these block sizes, so arrival time dominates.
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING

from cutesdr_tpu.ops.resampler import SINC_PERIODS

if TYPE_CHECKING:  # avoid an import cycle; ReceiverConfig imports design/*
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig

MIN_NFFT = 128           # smallest overlap-save frame worth dispatching
MAX_NFFT = 32768


def measure_readback_floor(reps: int = 3) -> float:
    """One device→host readback round-trip (seconds, median of ``reps``).

    Where this floor exceeds a 10 ms audio block (a remotely attached or
    heavily shared device), a low-latency config starves the audio queue
    no matter how fast the device is.  serve/run call this at startup and
    auto-raise the latency target when the floor demands it
    (ensure_realtime_blocks) instead of streaming silence."""
    import time

    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    float(jnp.sum(f(x)))              # compile + first transfer
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(jnp.sum(f(x)))          # readback IS the fence
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def ensure_realtime_blocks(cfg: "ReceiverConfig", floor_s: float,
                           margin: float = 2.0) -> tuple["ReceiverConfig", float]:
    """Grow the block until its real-time duration covers the measured
    device→host readback floor (every delivered block pays one readback,
    so blocks shorter than the floor drain the audio queue faster than
    they fill it — the r4 'silent /audio.wav' failure).  Returns
    (possibly-modified cfg, per-block seconds after the fix); prints
    nothing — the caller reports what was chosen and why."""
    need = floor_s * margin
    if cfg.latency_sec >= need:
        return cfg, cfg.latency_sec
    cand = cfg
    # prefer more frames per step (same filter sharpness, pure batching);
    # fall back to larger frames if the cap is hit
    while cand.latency_sec < need and cand.frames_per_block < 256:
        cand = replace(cand, frames_per_block=cand.frames_per_block * 2)
    while cand.latency_sec < need and cand.fastfir_nfft < MAX_NFFT:
        nfft = cand.fastfir_nfft * 2
        cand = replace(cand, fastfir_nfft=nfft, fastfir_ntaps=nfft // 2 + 1)
    return cand, cand.latency_sec


def latency_report(cfg: "ReceiverConfig", include_queue: bool = False) -> dict:
    """Per-component latency (seconds) for a configuration."""
    fs_in, fs_out = cfg.input_rate, cfg.output_rate
    comp = {
        "block_accumulation": cfg.block_size / fs_in,
        "decimator_group_delay": (len(cfg.plan.composed_taps()) - 1) / 2 / fs_in,
        "fastfir_group_delay": (cfg.fastfir_ntaps - 1) / 2 / fs_out,
    }
    if cfg.audio_rate is not None:
        periods = getattr(cfg, "resampler_periods", SINC_PERIODS)
        comp["resampler_group_delay"] = periods / 2 / fs_out
    if include_queue and cfg.audio_rate is not None:
        from cutesdr_tpu.io.audio_sink import OUTQSIZE
        comp["audio_queue_half_fill"] = OUTQSIZE / 2 / cfg.audio_rate
    comp["total"] = sum(comp.values())
    return comp


def choose_fastfir_sizes(cfg: "ReceiverConfig",
                         target_latency_s: float) -> "ReceiverConfig":
    """Return a copy of ``cfg`` with the largest channel-filter sizes whose
    pipeline latency (block accumulation + filter group delays, no queue)
    meets ``target_latency_s``.

    Keeps the reference's tap ratio ``ntaps = nfft/2 + 1`` (so each frame
    yields nfft/2 samples and the transition width scales as
    ~2·fs_out/ntaps); larger nfft = sharper filter but more latency.  Raises
    if even the smallest frame (MIN_NFFT) cannot meet the target.
    """
    best = None
    nfft = MIN_NFFT
    while nfft <= MAX_NFFT:
        cand = replace(cfg, fastfir_nfft=nfft, fastfir_ntaps=nfft // 2 + 1,
                       frames_per_block=1)
        if latency_report(cand)["total"] <= target_latency_s:
            best = cand
        else:
            break
        nfft *= 2
    if best is None:
        floor = latency_report(
            replace(cfg, fastfir_nfft=MIN_NFFT, fastfir_ntaps=MIN_NFFT // 2 + 1,
                    frames_per_block=1))["total"]
        raise ValueError(
            f"target {target_latency_s * 1e3:.2f} ms unreachable: the "
            f"minimum-size pipeline needs {floor * 1e3:.2f} ms at "
            f"input_rate={cfg.input_rate:.0f} (decimation x{cfg.plan.decimation})")
    return best
