"""Time-axis sharding of one wideband stream over a device mesh.

One superblock of D·S input samples is split so device i owns samples
[i·S, (i+1)·S).  The wideband front-end (NCO → fused decimator → overlap-save
channel filter) carries only bounded history, so sharding is *exact*:

  * NCO: closed-form — device i adds i·S·phase_inc to the uint32 phase
    accumulator; no serial dependency at all.
  * decimator: each device needs the last len(H_eq)-1-d *input* samples of
    its left neighbor — one ring ppermute of a ~1k-sample halo.
  * channel filter: each device needs the last NFIR-1 (=1024) *decimated*
    samples of its left neighbor — a second, smaller ring ppermute.
  * device 0's halos come from the previous superblock (replicated carries);
    the value it receives on the ring (from device D-1) is exactly next
    superblock's halo, recovered replicated via a masked psum.

The audio-rate tail (S-meter/AGC/demod/resampler — inherently sequential
scans, ≤48 kSPS) runs replicated on the all_gathered filtered samples; its
cost is negligible next to the front-end, which is what gives near-linear
weak scaling.  Exactness vs. the single-chip receiver is asserted in
tests/test_shard.py on a CPU mesh.

This is the SDR analogue of sequence parallelism with neighbor exchange —
like ring attention's halo pattern but lossless, because every operator has
finite memory (SURVEY.md section 5, long-context analogy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map as _shard_map   # jax >= 0.7 style

    def shard_map(f, mesh, in_specs, out_specs):
        # check_vma=False: outputs are replicated by construction
        # (all_gather over the axis / masked psum) but the static
        # varying-mesh-axes inference can't prove it
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _old_shard_map

    def shard_map(f, mesh, in_specs, out_specs):
        return _old_shard_map(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_rep=False)

from cutesdr_tpu.ops import fastfir, noiseblanker
from cutesdr_tpu.ops.util import complex_strided_corr
from cutesdr_tpu.pipeline import receiver as rx
from cutesdr_tpu.types import K_2PI

_TWO32 = 4294967296.0


class TimeShardCarry(NamedTuple):
    """Replicated carries of the sharded front-end (device-0 halos)."""
    nco_base: jax.Array     # uint32 phase accumulator at superblock start
    in_tail: jax.Array      # decimator halo for device 0: mixed samples of
                            # length len(H_eq)-1-d (fused) or raw samples of
                            # the same length (pallas mixdec)
    dec_tail: jax.Array     # [NFIR-1] decimated-sample halo for device 0
    nb_tail: Any = None     # raw-sample halo for the noise blanker (if on)


def _replicated_at_zero(i, recv, axis):
    """Extract device 0's received value as a replicated array (masked psum)."""
    zero = jnp.zeros_like(recv)
    return lax.psum(jnp.where(i == 0, recv, zero), axis)


def front_end_sharded(cfg: rx.ReceiverConfig, n_dev: int, axis: str,
                      params: rx.ReceiverParams, carry: TimeShardCarry,
                      x_local: jax.Array):
    """Per-device front end (runs inside shard_map).  x_local: [S].

    With cfg.probes the front-end taps (p1 decimated, p2 filtered, p7
    blanker) are all_gathered to full streams so the testbench probe
    methodology covers the sharded configuration (round-1 VERDICT item 9);
    p3–p5 come from the replicated back_end as usual."""
    probes = {} if cfg.probes else None
    i = lax.axis_index(axis)
    S = x_local.shape[-1]
    ring = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    rdtype = jnp.real(x_local).dtype

    # --- noise blanker (raw-history halo; stateless given the halo) ---
    if cfg.nb_on:
        nb_cfg = noiseblanker.BlankerConfig(cfg.nb_on, cfg.nb_threshold,
                                            cfg.nb_width_us, cfg.input_rate)
        h_nb = carry.nb_tail.shape[-1]
        tail_nb = x_local[..., S - h_nb:]
        recv_nb = lax.ppermute(tail_nb, axis, ring)
        halo_nb = jnp.where(i == 0, carry.nb_tail, recv_nb)
        x_local = noiseblanker.process_with_history(
            nb_cfg, jnp.concatenate([halo_nb, x_local], axis=-1), S)
        new_nb_tail = _replicated_at_zero(i, recv_nb, axis)
        if probes is not None:
            probes["p7_blanker"] = lax.all_gather(x_local, axis, tiled=True)
    else:
        new_nb_tail = carry.nb_tail

    x_local = x_local - params.dc_offset

    if cfg.decimator_impl == "pallas":
        # fused NCO-mix + polyphase decimation in one Pallas kernel.  The
        # halo is RAW (pre-mix) input — the kernel owns the oscillator and
        # back-dates phases into the halo via uint32 wraparound — so the
        # shard offset is absorbed by programming each device's phase_base
        # to nco_base + i*S*phase_inc (kernels/mixdec.py; the closed-form
        # offset mirrors the XLA path below).
        from cutesdr_tpu.kernels.mixdec import MixDecCarry
        from cutesdr_tpu.pipeline.receiver import _make_mixdec
        md = _make_mixdec(cfg)
        h_in = carry.in_tail.shape[-1]
        tail = x_local[..., S - h_in:]
        recv = lax.ppermute(tail, axis, ring)
        halo = jnp.where(i == 0, carry.in_tail, recv)
        base_i = (carry.nco_base
                  + i.astype(jnp.uint32) * jnp.uint32(S) * params.dec.phase_inc)
        _, y_dec = md(params.dec,
                      MixDecCarry(raw_tail=halo, phase_base=base_i), x_local)
        new_in_tail = _replicated_at_zero(i, recv, axis)
    else:
        # --- NCO: exact global phase from the shard index ---
        k = lax.iota(jnp.uint32, S)
        acc = (carry.nco_base
               + (i.astype(jnp.uint32) * jnp.uint32(S) + k)
               * params.nco.phase_inc)
        ang = acc.astype(rdtype) * jnp.asarray(K_2PI / _TWO32, rdtype)
        mixed = x_local * lax.complex(jnp.cos(ang), jnp.sin(ang))

        # --- decimator halo exchange (input rate) ---
        h_in = carry.in_tail.shape[-1]
        tail = mixed[..., S - h_in:]
        recv = lax.ppermute(tail, axis, ring)
        halo = jnp.where(i == 0, carry.in_tail, recv)
        z = jnp.concatenate([halo, mixed], axis=-1)
        y_dec = complex_strided_corr(z, params.dec.h_eq[::-1],
                                     stride=cfg.plan.decimation)
        new_in_tail = _replicated_at_zero(i, recv, axis)

    if probes is not None:
        probes["p1_downconvert"] = lax.all_gather(y_dec, axis, tiled=True)

    # --- channel-filter halo exchange (decimated rate) ---
    nd = y_dec.shape[-1]
    ntaps = carry.dec_tail.shape[-1] + 1
    dtail = y_dec[..., nd - (ntaps - 1):]
    recv2 = lax.ppermute(dtail, axis, ring)
    halo2 = jnp.where(i == 0, carry.dec_tail, recv2)
    z2 = jnp.concatenate([halo2, y_dec], axis=-1)
    y_filt = fastfir.filter_frames(params.chan_filter.h_freq, z2, ntaps)
    new_dec_tail = _replicated_at_zero(i, recv2, axis)

    # --- gather the (audio-rate) filtered stream to every device ---
    y_all = lax.all_gather(y_filt, axis, tiled=True)
    if probes is not None:
        probes["p2_fastfir"] = y_all
    return y_all, new_in_tail, new_dec_tail, new_nb_tail, probes


@dataclass
class ShardedReceiver:
    """Receiver running one stream time-sharded over mesh axis 't'.

    Per-step input: superblock of n_dev·cfg.block_size complex samples.
    Output matches the single-chip Receiver exactly (same audio, same
    meters) — see tests/test_shard.py.
    """
    cfg: rx.ReceiverConfig
    mesh: Mesh
    axis: str = "t"
    rdtype: Any = jnp.float32

    def __post_init__(self):
        if self.cfg.decimator_impl == "cascade":
            # the sharded halo algebra needs the composed-tap form; the
            # cascade computes the same stream, so run it fused here
            from dataclasses import replace
            self.cfg = replace(self.cfg, decimator_impl="fused")
        self.n_dev = self.mesh.shape[self.axis]
        self.params, state = rx.init(self.cfg, self.rdtype)
        self.state = state
        # decimator halo: mixed-sample tail (fused) / raw-sample tail (pallas)
        if self.cfg.decimator_impl == "pallas":
            in_tail = state.dec.raw_tail
            nco_base0 = state.dec.phase_base
        else:
            in_tail = state.dec.tail
            nco_base0 = state.nco.phase_acc
        if self.cfg.nb_on:
            nb_cfg = noiseblanker.BlankerConfig(
                self.cfg.nb_on, self.cfg.nb_threshold, self.cfg.nb_width_us,
                self.cfg.input_rate)
            nb_tail = jnp.zeros(noiseblanker.history_len(nb_cfg),
                                in_tail.dtype)
        else:
            nb_tail = jnp.zeros((0,), in_tail.dtype)
        self.ts_carry = TimeShardCarry(
            nco_base=nco_base0,
            in_tail=in_tail,
            dec_tail=state.chan_filter.tail,
            nb_tail=nb_tail)
        cfg, n_dev, axis, mesh = self.cfg, self.n_dev, self.axis, self.mesh

        def step(params, state, ts_carry, x):
            front = shard_map(
                lambda p, c, xs: front_end_sharded(cfg, n_dev, axis, p, c, xs),
                mesh,
                in_specs=(P(), P(), P(axis)),
                out_specs=(P(), P(), P(), P(), P()))
            y_all, in_tail, dec_tail, nb_tail, probes = front(params,
                                                              ts_carry, x)
            sm_c, agc_c, dm_c, rs_c, out = rx.back_end(cfg, params, state,
                                                       y_all, probes=probes)
            inc = (params.dec.phase_inc if cfg.decimator_impl == "pallas"
                   else params.nco.phase_inc)
            new_ts = TimeShardCarry(
                nco_base=ts_carry.nco_base
                + jnp.uint32(n_dev * cfg.block_size) * inc,
                in_tail=in_tail, dec_tail=dec_tail, nb_tail=nb_tail)
            new_state = state._replace(smeter=sm_c, agc=agc_c, demod=dm_c,
                                       resamp=rs_c)
            return new_state, new_ts, out

        self._step = jax.jit(step)

        def step_planes(params, state, ts_carry, re, im):
            new_state, new_ts, out = step(params, state, ts_carry,
                                          lax.complex(re, im))
            return new_state, new_ts, rx.split_complex_leaves(out)

        self._step_planes = jax.jit(step_planes)
        self._x_sharding = NamedSharding(mesh, P(self.axis))

    @property
    def superblock_size(self) -> int:
        return self.n_dev * self.cfg.block_size

    def process(self, iq) -> rx.StepOutput:
        """Run one superblock.  ``iq`` is either host data (single process —
        device_put shards it over the mesh) or an already globally-sharded
        jax.Array built per-host via :meth:`host_stream` (multi-process,
        where no single host holds the full superblock)."""
        if not (isinstance(iq, jax.Array)
                and iq.sharding.is_equivalent_to(self._x_sharding, iq.ndim)):
            iq = jax.device_put(iq, self._x_sharding)
        self.state, self.ts_carry, out = self._step(
            self.params, self.state, self.ts_carry, iq)
        return out

    def process_host(self, iq) -> rx.StepOutput:
        """Host path: the superblock crosses the host->device boundary as
        float32 re/im planes and complex output leaves come back as
        [..., 2] float stacks (rx.join_complex_pair reassembles) — the
        same contract as Receiver.process_host."""
        import numpy as np
        re = jax.device_put(np.ascontiguousarray(np.real(iq), np.float32),
                            self._x_sharding)
        im = jax.device_put(np.ascontiguousarray(np.imag(iq), np.float32),
                            self._x_sharding)
        self.state, self.ts_carry, out = self._step_planes(
            self.params, self.state, self.ts_carry, re, im)
        return out

    def host_stream(self):
        """Per-host ingest assembler: each process contributes only the time
        slices its local devices own (shard/multihost.py), so a multi-host
        run never gathers the raw stream to one host."""
        from cutesdr_tpu.shard.multihost import HostShardedStream
        return HostShardedStream(self.mesh, block_per_device=self.cfg.block_size)
