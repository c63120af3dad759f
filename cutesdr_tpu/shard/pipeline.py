"""Pipeline parallelism: the receiver's two macro-stages on two devices.

Reference analogue: none — SURVEY §2.4 lists pipeline parallelism as the
one optional capability ("stages on different chips with handoff; likely
unnecessary — document and skip in v1").  Implemented here in v3 so the
capability exists and is testable: useful when the wideband front end
(mix → decimate → channel filter at the input rate) saturates one chip
while the audio-rate tail (S-meter → AGC → demod → resample) rides along,
or when several sessions share chips.

Design (single controller):

  * stage A = front end, compiled and resident on device A;
  * stage B = back end, compiled and resident on device B;
  * each ``process`` call dispatches A(x_t) on device A and
    B(baseband_{t-1}) on device B — XLA's async dispatch runs them
    CONCURRENTLY, giving true 2-stage pipelining with one block of
    latency; the staged baseband moves A→B via ``jax.device_put``
    (device to device), which is itself async;
  * outputs equal the single-chip receiver exactly, delayed by one block
    (tests/test_pipeline_pp.py).

This is deliberately NOT shard_map: the stages are different programs on
different devices with a cross-device stream handoff — a pipeline, not a
data-parallel collective pattern.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

from cutesdr_tpu.pipeline import receiver as rx


@dataclass
class PipelinedReceiver:
    """Two-stage pipelined receiver over two devices.

    ``process(iq_block)`` returns the StepOutput for the PREVIOUS block
    (None for the first call); ``flush()`` drains the last staged block.
    """
    cfg: rx.ReceiverConfig
    device_front: Any = None       # defaults: devices()[0] / devices()[-1]
    device_back: Any = None
    rdtype: Any = jnp.float32

    def __post_init__(self):
        devs = jax.devices()
        if self.device_front is None:
            self.device_front = devs[0]
        if self.device_back is None:
            self.device_back = devs[min(1, len(devs) - 1)]
        cfg = self.cfg
        params, state = rx.init(cfg, self.rdtype)
        self.params = jax.device_put(params, self.device_front)
        # split the state between the stages' homes
        self.front_state = jax.device_put(
            dict(nco=state.nco, blanker=state.blanker, dec=state.dec,
                 chan_filter=state.chan_filter), self.device_front)
        self.back_params = jax.device_put(params, self.device_back)
        self.back_state = jax.device_put(
            dict(agc=state.agc, smeter=state.smeter, demod=state.demod,
                 resamp=state.resamp), self.device_back)

    # each stage builds a ReceiverState with None for the OTHER stage's
    # leaves — never read, never captured (a device-array template would
    # embed cross-device constants)
    def _front_step(self, params, fstate, iq):
        st = rx.ReceiverState(nco=fstate["nco"], blanker=fstate["blanker"],
                              dec=fstate["dec"],
                              chan_filter=fstate["chan_filter"],
                              agc=None, smeter=None, demod=None, resamp=None)
        nb_c, nco_c, dec_c, ff_c, filt = rx._front(self.cfg, params, st, iq)
        return (dict(nco=nco_c, blanker=nb_c, dec=dec_c, chan_filter=ff_c),
                filt)

    def _back_step(self, params, bstate, filt):
        st = rx.ReceiverState(nco=None, blanker=None, dec=None,
                              chan_filter=None, agc=bstate["agc"],
                              smeter=bstate["smeter"], demod=bstate["demod"],
                              resamp=bstate["resamp"])
        sm_c, agc_c, dm_c, rs_c, out = rx.back_end(self.cfg, params, st,
                                                   filt)
        return (dict(agc=agc_c, smeter=sm_c, demod=dm_c, resamp=rs_c), out)

    def __hash__(self):               # jit static_argnums on self
        return id(self)

    def __eq__(self, other):
        return self is other

    def _jits(self):
        if not hasattr(self, "_front_jit"):
            self._front_jit = jax.jit(self._front_step)
            self._back_jit = jax.jit(self._back_step)
        return self._front_jit, self._back_jit

    _staged = None                    # baseband on device_back, or None

    def process(self, iq) -> rx.StepOutput | None:
        """Dispatch front(x_t) on device A and back(baseband_{t-1}) on
        device B concurrently; returns block t-1's output (None first)."""
        front, back = self._jits()
        iq = jax.device_put(jnp.asarray(iq), self.device_front)
        out = None
        if self._staged is not None:
            self.back_state, out = back(self.back_params, self.back_state,
                                        self._staged)
        self.front_state, filt = front(self.params, self.front_state, iq)
        # stream handoff A -> B (async, device to device)
        self._staged = jax.device_put(filt, self.device_back)
        return out

    def flush(self) -> rx.StepOutput | None:
        """Drain the staged block (call after the last process)."""
        if self._staged is None:
            return None
        front, back = self._jits()
        self.back_state, out = back(self.back_params, self.back_state,
                                    self._staged)
        self._staged = None
        return out
