"""Phase-coherent dual-channel combining (diversity / simple beamforming).

Reference analogue: none executed — the reference *defines* the dual-RX
channel modes (CI_RX_CHAN_SETUP, interface/protocoldefs.h:143-152) and the
radios deliver interleaved two-channel packets, but CuteSDR only ever
demodulates channel 1.  This module is the capability those modes exist
for: combine the two coherent streams before demodulation.

Maximal-ratio combining (MRC): model ch0 = s + n0, ch1 = g·s + n1 with a
slowly-varying complex channel gain g (antenna/cable phase + amplitude
mismatch).  The combiner estimates g from the cross-correlation of the two
streams, EMA-smoothed across blocks (carried state, like every streaming op
here), and outputs

    y = (x0 + conj(g)·x1) / sqrt(1 + |g|^2)

which maximizes output SNR (up to +3 dB for equal-SNR branches) and
self-steers: the estimate tracks the dominant coherent source.  A fixed
steering phase can be applied instead for manual beam steering.

Everything is vectorized (block cross-correlation + elementwise combine) —
no scan; per-block state is a single complex gain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CombinerParams(NamedTuple):
    alpha: jax.Array              # EMA weight for the per-block gain estimate
    manual: jax.Array             # bool: use fixed_gain instead of estimate
    fixed_gain: jax.Array         # complex steering gain when manual


class CombinerCarry(NamedTuple):
    gain: jax.Array               # smoothed complex channel-gain estimate


def init(smoothing_blocks: float = 8.0, rdtype=jnp.float32,
         manual: bool = False, fixed_gain: complex = 1.0 + 0.0j):
    # complex values are formed ON device (lax.complex of f32 scalars)
    fg = complex(fixed_gain)
    params = CombinerParams(
        alpha=jnp.asarray(1.0 / max(1.0, smoothing_blocks), rdtype),
        manual=jnp.asarray(bool(manual)),
        fixed_gain=jax.lax.complex(jnp.asarray(fg.real, rdtype),
                                   jnp.asarray(fg.imag, rdtype)))
    return params, CombinerCarry(
        gain=jax.lax.complex(jnp.ones((), rdtype), jnp.zeros((), rdtype)))


def process(params: CombinerParams, carry: CombinerCarry,
            x: jax.Array) -> tuple[CombinerCarry, jax.Array]:
    """x: [2, N] coherent complex streams -> combined [N]."""
    x0, x1 = x[0], x[1]
    p0 = jnp.sum(jnp.abs(x0) ** 2)
    g_block = jnp.sum(x1 * jnp.conj(x0)) / (p0 + jnp.asarray(1e-12, p0.dtype))
    g = jnp.where(params.manual, params.fixed_gain,
                  (1.0 - params.alpha) * carry.gain + params.alpha * g_block)
    norm = jnp.sqrt(1.0 + jnp.abs(g) ** 2)
    y = (x0 + jnp.conj(g) * x1) / norm.astype(x0.real.dtype)
    return CombinerCarry(gain=g), y


class ArrayCombinerCarry(NamedTuple):
    gains: jax.Array              # [M] smoothed complex gains (gains[0]=1)


def array_init(n_branches: int, smoothing_blocks: float = 8.0,
               rdtype=jnp.float32):
    """M-branch MRC combiner (antenna arrays / StackedReceiver streams):
    branch i's channel gain g_i is estimated against branch 0 and the
    combine is  y = Σ conj(g_i)·x_i / sqrt(Σ|g_i|²)  — the 2-branch
    ``process`` generalized; identical math at M=2."""
    params = CombinerParams(
        alpha=jnp.asarray(1.0 / max(1.0, smoothing_blocks), rdtype),
        manual=jnp.asarray(False),
        fixed_gain=jax.lax.complex(jnp.ones((), rdtype),
                                   jnp.zeros((), rdtype)))
    gains = jax.lax.complex(
        jnp.ones((n_branches,), rdtype), jnp.zeros((n_branches,), rdtype))
    return params, ArrayCombinerCarry(gains=gains)


def array_process(params: CombinerParams, carry: ArrayCombinerCarry,
                  x: jax.Array) -> tuple[ArrayCombinerCarry, jax.Array]:
    """x: [M, N] coherent complex streams -> MRC-combined [N]."""
    x0 = x[0]
    p0 = jnp.sum(jnp.abs(x0) ** 2) + jnp.asarray(1e-12, jnp.real(x).dtype)
    g_block = jnp.sum(x * jnp.conj(x0)[None, :], axis=-1) / p0   # [M]
    g = (1.0 - params.alpha) * carry.gains + params.alpha * g_block
    rd = jnp.real(x).dtype
    # reference branch pinned to 1+0j — formed via lax.complex of real
    # scalars
    g = g.at[0].set(jax.lax.complex(jnp.ones((), rd), jnp.zeros((), rd)))
    norm = jnp.sqrt(jnp.sum(jnp.abs(g) ** 2))
    y = jnp.sum(jnp.conj(g)[:, None] * x, axis=0) / norm.astype(
        jnp.real(x).dtype)
    return ArrayCombinerCarry(gains=g), y


@dataclass
class DiversityReceiver:
    """N coherent IQ streams -> MRC combine -> one receiver chain.

    ``process(iq_stack [n_branches, block_size])`` returns the usual
    StepOutput plus the current gain estimate via ``last_gain`` /
    ``last_gains``.  n_branches=2 is the dual-RX radio case
    (CHAN_SETUP_DUAL_*); larger N serves antenna arrays fed through
    StackedReceiver-style per-element streams.
    """
    cfg: Any                      # ReceiverConfig
    smoothing_blocks: float = 8.0
    rdtype: Any = jnp.float32
    n_branches: int = 2

    def __post_init__(self):
        from cutesdr_tpu.pipeline import receiver as rx

        self._rx = rx
        self.params, self.state = rx.init(self.cfg, self.rdtype)
        if self.n_branches == 2:
            self.comb_params, self.comb_state = init(self.smoothing_blocks,
                                                     self.rdtype)
            combine = process
        else:
            self.comb_params, self.comb_state = array_init(
                self.n_branches, self.smoothing_blocks, self.rdtype)
            combine = array_process
        cfg = self.cfg

        def step(p, cp, s, cs, x):
            cs, y = combine(cp, cs, x)
            s, out = rx.receiver_step(cfg, p, s, y)
            return s, cs, out

        def step_planes(p, cp, s, cs, re, im):
            s, cs, out = step(p, cp, s, cs, jax.lax.complex(re, im))
            return s, cs, rx.split_complex_leaves(out)

        self._step = jax.jit(step)
        self._step_planes = jax.jit(step_planes)

    def process(self, iq_stack):
        self.state, self.comb_state, out = self._step(
            self.params, self.comb_params, self.state, self.comb_state,
            jnp.asarray(iq_stack))
        return out

    def process_host(self, iq_stack):
        """Host path: f32 re/im planes in, complex output leaves split to
        [..., 2] float stacks (the Receiver.process_host contract)."""
        import numpy as np
        self.state, self.comb_state, out = self._step_planes(
            self.params, self.comb_params, self.state, self.comb_state,
            np.ascontiguousarray(np.real(iq_stack), np.float32),
            np.ascontiguousarray(np.imag(iq_stack), np.float32))
        return out

    # --- live controls (shared param-update functions with Receiver) ---
    def set_tune_freq(self, freq_hz: float) -> None:
        self.params = self._rx.tune_params(self.cfg, self.params, freq_hz)

    def set_filter(self, low_cut: float, hi_cut: float) -> None:
        self.params = self._rx.filter_params(self.cfg, self.params,
                                             low_cut, hi_cut)

    def set_volume(self, vol_0_99: int) -> None:
        self.params = self._rx.volume_params(self.params, vol_0_99)

    def set_resample_ratio(self, ratio: float) -> None:
        self.params = self._rx.ratio_params(self.params, ratio)

    def set_dc_offset(self, i_off: float, q_off: float) -> None:
        rd = jnp.real(self.params.dc_offset).dtype
        self.params = self.params._replace(dc_offset=jax.lax.complex(
            jnp.asarray(i_off, rd), jnp.asarray(q_off, rd)))

    @property
    def last_gain(self) -> complex:
        # pull re/im planes separately (the f32-plane host contract)
        if self.n_branches != 2:
            return self.last_gains[1]
        g = self.comb_state.gain
        return complex(float(jnp.real(g)), float(jnp.imag(g)))

    @property
    def last_gains(self) -> list:
        """Per-branch gain estimates (n_branches > 2; gains[0] = 1)."""
        if self.n_branches == 2:
            return [1.0 + 0.0j, self.last_gain]
        g = self.comb_state.gains
        re = np.asarray(jnp.real(g))
        im = np.asarray(jnp.imag(g))
        return [complex(a, b) for a, b in zip(re, im)]

    def set_steering(self, gain: complex | None) -> None:
        """Fix the combining gain (None returns to automatic MRC).
        Pairwise (n_branches=2) only — array mode always tracks."""
        if self.n_branches != 2:
            raise ValueError("manual steering is pairwise-only")
        if gain is None:
            self.comb_params = self.comb_params._replace(
                manual=jnp.asarray(False))
        else:
            rd = jnp.real(self.comb_params.fixed_gain).dtype
            self.comb_params = self.comb_params._replace(
                manual=jnp.asarray(True),
                fixed_gain=jax.lax.complex(jnp.asarray(gain.real, rd),
                                           jnp.asarray(gain.imag, rd)))
