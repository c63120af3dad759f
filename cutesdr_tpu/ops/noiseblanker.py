"""Impulse noise blanker.

Reference analogue: CNoiseProc (dsp/noiseproc.cpp:121-176): magnitude peak →
5 ms moving average → when mag·Ratio exceeds the moving sum, zero the next
``width`` samples of a Width/2-delayed signal path.

Design — everything parallel, no per-sample counter:
  * moving sum via cumulative-sum difference,
  * the reference's countdown ("blank for Width samples after a trigger")
    equals morphological dilation of the trigger sequence: sample n is
    blanked iff any trigger fired in (n-width, n] — a reduce_window max,
  * delay line = static slice of [tail | block].

Exactly reproduces the reference's quirky effective windows: the magnitude
average spans mag_samples+1 entries and the delay is delay_samples+1 (its
ring buffers wrap one slot late) — kept identical on purpose.  The
``SampleRate==SampleRate`` self-compare bug in the reference's change
detection (dsp/noiseproc.cpp:82) is *not* replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cutesdr_tpu.ops.util import moving_sum, sliding_window_max
from cutesdr_tpu.types import complex_zeros

MAX_WIDTH = 4096
MAGAVE_TIME = 0.005


@dataclass(frozen=True)
class BlankerConfig:
    on: bool
    threshold: float        # 0..99 UI scale
    width_usec: float       # impulse blanking width, microseconds
    sample_rate: float

    @property
    def width_samples(self) -> int:
        return max(1, min(int(self.width_usec * 1e-6 * self.sample_rate),
                          MAX_WIDTH))

    @property
    def mag_samples(self) -> int:
        return int(MAGAVE_TIME * self.sample_rate)

    @property
    def delay_samples(self) -> int:
        return self.width_samples // 2

    @property
    def ratio(self) -> float:
        return 0.005 * self.threshold * self.mag_samples


class BlankerCarry(NamedTuple):
    mag_tail: jax.Array     # [mag_samples] magnitude history (window-1 of W+1)
    trig_tail: jax.Array    # [width_samples-1] trigger history
    sig_tail: jax.Array     # [delay_samples+1] input history


def init_carry(cfg: BlankerConfig, cdtype=jnp.complex64,
               rdtype=jnp.float32) -> BlankerCarry:
    return BlankerCarry(
        mag_tail=jnp.zeros(cfg.mag_samples, rdtype),
        trig_tail=jnp.zeros(cfg.width_samples - 1, rdtype),
        sig_tail=complex_zeros(cfg.delay_samples + 1, cdtype))


def history_len(cfg: BlankerConfig) -> int:
    """Raw-sample history needed to compute one output exactly: the delayed
    signal path reaches back delay+1 samples, and the trigger for the oldest
    dilation position needs a further mag-window of history."""
    return max(cfg.delay_samples + 1,
               (cfg.width_samples - 1) + (cfg.mag_samples + 1))


def process_with_history(cfg: BlankerConfig, z: jax.Array,
                         n: int) -> jax.Array:
    """Stateless form over z = [history | block]: emit the last ``n``
    outputs.  Used by the time-sharded receiver, where the history is a
    ppermute'd halo instead of carried tails."""
    if not cfg.on:
        return z[..., z.shape[-1] - n:]
    rdtype = jnp.real(z).dtype
    H = z.shape[-1] - n
    mag = jnp.maximum(jnp.abs(z.real), jnp.abs(z.imag)).astype(rdtype)
    # moving sum over mag window for every position that dilation can see
    need = n + cfg.width_samples - 1
    wm = cfg.mag_samples + 1
    mg = mag[..., z.shape[-1] - (need + wm - 1):]
    c = jnp.cumsum(mg, axis=-1)
    zero = jnp.zeros(c.shape[:-1] + (1,), c.dtype)
    c = jnp.concatenate([zero, c], axis=-1)
    sums = c[..., wm:] - c[..., :-wm]                       # [need]
    cur = mag[..., z.shape[-1] - need:]
    trig = (cur * cfg.ratio > sums).astype(rdtype)
    # dilation via the van Herk sliding max on the trigger sequence
    from cutesdr_tpu.ops.util import sliding_window_max
    blank, _ = sliding_window_max(trig[..., cfg.width_samples - 1:],
                                  cfg.width_samples,
                                  trig[..., :cfg.width_samples - 1])
    delayed = z[..., z.shape[-1] - n - (cfg.delay_samples + 1):
                z.shape[-1] - (cfg.delay_samples + 1)]
    return jnp.where(blank > 0.5, jnp.zeros((), z.dtype), delayed)


def process(cfg: BlankerConfig, carry: BlankerCarry,
            x: jax.Array) -> tuple[BlankerCarry, jax.Array]:
    if not cfg.on:
        return carry, x
    n = x.shape[-1]
    rdtype = jnp.real(x).dtype

    mag = jnp.maximum(jnp.abs(x.real), jnp.abs(x.imag)).astype(rdtype)
    mag_sum, mag_tail = moving_sum(mag, cfg.mag_samples + 1, carry.mag_tail)
    trig = (mag * cfg.ratio > mag_sum).astype(rdtype)
    blank, trig_tail = sliding_window_max(trig, cfg.width_samples,
                                          carry.trig_tail)

    zd = jnp.concatenate([carry.sig_tail, x], axis=-1)
    delayed = zd[..., :n]
    y = jnp.where(blank > 0.5, jnp.zeros((), x.dtype), delayed)
    return BlankerCarry(mag_tail=mag_tail, trig_tail=trig_tail,
                        sig_tail=zd[..., n:]), y
