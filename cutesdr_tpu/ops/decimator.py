"""Cascaded decimate-by-2 chain (half-band FIRs + CIC3), vectorized.

Reference analogue: CDownConvert's chain of stateful per-sample DecBy2 stages
(dsp/downconvert.cpp:249-258 driver; CHalfBandDecimateBy2 :286-320,
CHalfBand11TapDecimateBy2 :348-423, CCicN3DecimateBy2 :444-460).

Two mathematically identical implementations:

* ``cascade``: one strided convolution per stage, each with a carried
  (len-1)-sample input tail.  Mirrors the reference's stage structure; used
  as the verification reference and for golden tests.

* ``fused``: the whole cascade composed into one equivalent FIR at the input
  rate — H_eq(z) = prod_k H_k(z^(2^k)) — run as a single stride-D
  correlation.  One conv, one halo, one XLA op for the whole chain; also
  what makes time-sharding trivial (a single
  (len-1)-sample halo instead of per-stage carries).

Stream algebra (see tests/test_decimator.py for the equivalence check):
with full input history x[t], a half-band stage emits y[n] = (h*x)[2n] and
CIC3 emits y[n] = (h*x)[2n+1]; composing K stages gives
y[n] = (H_eq * x)[D·n + d] with D = 2^K and d = sum_i d_i·2^i.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cutesdr_tpu.design.decimation_plan import DecimationPlan
from cutesdr_tpu.ops.util import complex_strided_corr
from cutesdr_tpu.types import complex_zeros


class CascadeCarry(NamedTuple):
    tails: tuple[jax.Array, ...]   # per-stage (L-1)-sample complex input tails


class FusedCarry(NamedTuple):
    tail: jax.Array                # (len(H_eq)-1 + d)-sample complex input tail


def stage_offset(name: str) -> int:
    return 1 if name == "cic3" else 0


def total_offset(plan: DecimationPlan) -> int:
    return sum(stage_offset(name) << i for i, name in enumerate(plan.stages))


# ---------------------------------------------------------------- cascade --

def cascade_init(plan: DecimationPlan, cdtype=jnp.complex64) -> CascadeCarry:
    tails = []
    for name in plan.stages:
        taps = plan.stage_taps(name)
        tails.append(complex_zeros(len(taps) - 1, cdtype))
    return CascadeCarry(tails=tuple(tails))


def cascade_process(plan: DecimationPlan, carry: CascadeCarry,
                    x: jax.Array) -> tuple[CascadeCarry, jax.Array]:
    """Run all stages; len(x) must be divisible by plan.decimation."""
    new_tails = []
    y = x
    for name, tail in zip(plan.stages, carry.tails):
        taps = jnp.asarray(plan.stage_taps(name), jnp.real(y).dtype)
        z = jnp.concatenate([tail, y], axis=-1)
        out = complex_strided_corr(z, taps[::-1], stride=2,
                                   offset=stage_offset(name))
        new_tails.append(z[..., z.shape[-1] - (taps.shape[0] - 1):])
        y = out
    return CascadeCarry(tails=tuple(new_tails)), y


# ------------------------------------------------------------------ fused --

class FusedParams(NamedTuple):
    h_eq: jax.Array      # composed taps, float
    # static ints live on the plan, not in traced params


def fused_init(plan: DecimationPlan, cdtype=jnp.complex64,
               rdtype=jnp.float32) -> tuple[FusedParams, FusedCarry]:
    h = np.asarray(plan.composed_taps())
    d = total_offset(plan)
    tail_len = len(h) - 1 - d
    return (FusedParams(h_eq=jnp.asarray(h, rdtype)),
            FusedCarry(tail=complex_zeros(tail_len, cdtype)))


def fused_process(plan: DecimationPlan, params: FusedParams, carry: FusedCarry,
                  x: jax.Array, compute_dtype=None) -> tuple[FusedCarry, jax.Array]:
    """y[n] = sum_j H[j] x[D·n + d - j]  for n = 0 .. len(x)/D - 1.

    With z = concat(tail, x) and tail holding the last LH-1-d input samples,
    window n covers z[D·n : D·n + LH] under the flipped-tap correlation.

    ``compute_dtype=jnp.bfloat16`` runs the conv in bf16 with f32 accumulation
    (quantization SNR ~50 dB; see ops/util.strided_corr).
    """
    h = params.h_eq
    z = jnp.concatenate([carry.tail, x], axis=-1)
    y = complex_strided_corr(z, h[::-1], stride=plan.decimation,
                             compute_dtype=compute_dtype)
    tail_len = carry.tail.shape[-1]
    return FusedCarry(tail=z[..., z.shape[-1] - tail_len:]), y
