"""Channel-bank parallelism: N independent receivers over one wideband
stream, vmapped and sharded across mesh axis 'ch'.

Reference analogue: none — the reference runs exactly one demod chain.  This
is the "64 channels from one 10 MSPS stream" capability (BASELINE.json
config 4): each channel has its own tune frequency / mode parameters but
shares the static configuration (mode, rates, plan), so one compiled program
serves every channel, batched through vmap (the per-channel convolutions/
FFTs become batched ops) and sharded over devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cutesdr_tpu.ops import nco
from cutesdr_tpu.pipeline import receiver as rx


def _bank_step(cfg: rx.ReceiverConfig, shared_input: bool):
    """Batched step for a bank: bank_receiver_step, whose FM/SAM PLL takes
    one real lax.cond over the whole bank's validity vote instead of a
    per-channel cond→select under vmap (which would execute the sequential
    scan every block even with every channel locked).  Probe taps come back
    with a leading channel axis when cfg.probes is set."""
    return lambda p, s, x: rx.bank_receiver_step(cfg, p, s, x,
                                                 shared_input=shared_input)


def _bank_step_planes(cfg: rx.ReceiverConfig, shared_input: bool):
    """Host contract of Receiver.process_host: f32 re/im planes in, complex
    output leaves split to [..., 2] stacks."""
    base = _bank_step(cfg, shared_input)

    def f(p, s, re, im):
        s2, out = base(p, s, jax.lax.complex(re, im))
        return s2, rx.split_complex_leaves(out)
    return f


@dataclass
class ChannelBank:
    """N channels, same static config, per-channel tune frequencies.

    Input per step: one shared block of cfg.block_size complex samples
    (replicated); output: per-channel audio [n_channels, cap].
    """
    cfg: rx.ReceiverConfig
    tune_freqs: Sequence[float]
    mesh: Mesh | None = None
    axis: str = "ch"
    rdtype: Any = jnp.float32

    def __post_init__(self):
        n = len(self.tune_freqs)
        if self.mesh is not None:
            n_dev = self.mesh.shape[self.axis]
            if n % n_dev:
                raise ValueError(f"{n} channels not divisible by {n_dev} devices")

        # stack per-channel params/state along a leading channel axis
        p0, s0 = rx.init(self.cfg, self.rdtype)
        params = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (n,) + a.shape), p0)
        params = _retune(params, self.cfg, self.tune_freqs)
        state = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (n,) + a.shape), s0)
        self.params, self.state = params, state

        cfg = self.cfg
        step = _bank_step(cfg, shared_input=True)
        planes = _bank_step_planes(cfg, shared_input=True)
        if self.mesh is not None:
            spec = P(self.axis)
            shard = NamedSharding(self.mesh, spec)
            rep = NamedSharding(self.mesh, P())
            self.params = jax.device_put(self.params, shard)
            self.state = jax.device_put(self.state, shard)
            self._step = jax.jit(
                step,
                in_shardings=(shard, shard, rep),
                out_shardings=(shard, shard))
            self._step_planes = jax.jit(
                planes,
                in_shardings=(shard, shard, rep, rep),
                out_shardings=(shard, shard))
        else:
            self._step = jax.jit(step)
            self._step_planes = jax.jit(planes)

    @property
    def n_channels(self) -> int:
        return len(self.tune_freqs)

    def process(self, iq) -> rx.StepOutput:
        self.state, out = self._step(self.params, self.state,
                                     jnp.asarray(iq))
        return out

    def process_host(self, iq) -> rx.StepOutput:
        """Host-plane path (see _bank_step_planes)."""
        import numpy as np
        self.state, out = self._step_planes(
            self.params, self.state,
            np.ascontiguousarray(np.real(iq), np.float32),
            np.ascontiguousarray(np.imag(iq), np.float32))
        return out

    def set_tune_freqs(self, freqs: Sequence[float]) -> None:
        self.params = _retune(self.params, self.cfg, freqs)


def _retune(params, cfg, freqs: Sequence[float]):
    """Per-channel tune: set the NCO increments — and the pallas decimator's
    own oscillator when that kernel is in use (it owns the mixer, mirroring
    Receiver.set_tune_freq)."""
    incs = jnp.asarray(
        [nco.phase_increment(f - cfg.cw_offset, cfg.input_rate)
         for f in freqs])
    params = params._replace(nco=params.nco._replace(phase_inc=incs))
    if cfg.decimator_impl == "pallas":
        params = params._replace(
            dec=params.dec._replace(phase_inc=incs))
    return params


@dataclass
class StackedReceiver:
    """N independent receiver chains over N *separate* streams (e.g. the
    two RX channels of a dual-ADC radio, or antenna-array elements).

    Same static config for every chain, per-chain tune frequencies;
    input per step: [n_chains, block_size] complex samples.  With a mesh,
    chains shard over the 'ch' axis like ChannelBank.
    """
    cfg: rx.ReceiverConfig
    tune_freqs: Sequence[float]
    mesh: Mesh | None = None
    axis: str = "ch"
    rdtype: Any = jnp.float32

    def __post_init__(self):
        n = len(self.tune_freqs)
        p0, s0 = rx.init(self.cfg, self.rdtype)
        params = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (n,) + a.shape), p0)
        params = _retune(params, self.cfg, self.tune_freqs)
        state = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (n,) + a.shape), s0)
        self.params, self.state = params, state

        cfg = self.cfg
        step = _bank_step(cfg, shared_input=False)
        planes = _bank_step_planes(cfg, shared_input=False)
        if self.mesh is not None:
            shard = NamedSharding(self.mesh, P(self.axis))
            self.params = jax.device_put(self.params, shard)
            self.state = jax.device_put(self.state, shard)
            self._step = jax.jit(step, in_shardings=(shard, shard, shard),
                                 out_shardings=(shard, shard))
            self._step_planes = jax.jit(
                planes, in_shardings=(shard, shard, shard, shard),
                out_shardings=(shard, shard))
        else:
            self._step = jax.jit(step)
            self._step_planes = jax.jit(planes)

    def process(self, iq_stack) -> rx.StepOutput:
        self.state, out = self._step(self.params, self.state,
                                     jnp.asarray(iq_stack))
        return out

    def process_host(self, iq_stack) -> rx.StepOutput:
        """Host-plane path (see _bank_step_planes)."""
        import numpy as np
        self.state, out = self._step_planes(
            self.params, self.state,
            np.ascontiguousarray(np.real(iq_stack), np.float32),
            np.ascontiguousarray(np.imag(iq_stack), np.float32))
        return out
