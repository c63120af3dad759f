"""Biquad IIR filter (direct form 2), solved in parallel.

Reference analogue: CIir::ProcessFilter (dsp/iir.cpp:171-201):

    w0 = x[n] - a1*w1 - a2*w2
    y[n] = b0*w0 + b1*w1 + b2*w2 ;  w2 <- w1 ; w1 <- w0

The recurrence is second-order LINEAR: with state s[n] = [w[n], w[n-1]]

    s[n] = A s[n-1] + [x[n], 0],   A = [[-a1, -a2], [1, 0]]

so the whole block is one log-depth associative scan over (A, b) pairs
(2x2 matrix composition) instead of a sequential lax.scan, whose
per-iteration cost dominated the locked-FM chain.  The output is then the
elementwise combination y = b0*w0 + b1*w1 + b2*w2.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from cutesdr_tpu.design.iir_biquad import Biquad


class IirParams(NamedTuple):
    b0: jax.Array
    b1: jax.Array
    b2: jax.Array
    a1: jax.Array
    a2: jax.Array


class IirCarry(NamedTuple):
    w1: jax.Array   # scalar for real, or complex pair handled via dtype
    w2: jax.Array


def init(coefs: Biquad, complex_input: bool = False,
         rdtype=jnp.float32) -> tuple[IirParams, IirCarry]:
    b0, b1, b2, a1, a2 = (jnp.asarray(c, rdtype) for c in coefs)
    zero = jnp.zeros((), rdtype)
    if complex_input:
        zero = jax.lax.complex(zero, zero)
    return IirParams(b0, b1, b2, a1, a2), IirCarry(w1=zero, w2=zero)


def _second_order_recurrence(a1, a2, x, w1_0, w2_0):
    """Parallel solve of w[n] = x[n] - a1*w[n-1] - a2*w[n-2].

    Elements are (A, b) affine maps on the 2-state [w[n], w[n-1]];
    composition is 2x2 matmul + matvec, written out in scalars so complex
    dtypes ride through unchanged."""
    n = x.shape[-1]
    dt = x.dtype
    o = jnp.ones((n,), dt)
    z = jnp.zeros((n,), dt)
    # per-step A = [[-a1, -a2], [1, 0]], b = [x[n], 0]
    A00 = jnp.broadcast_to(jnp.asarray(-a1, dt), (n,))
    A01 = jnp.broadcast_to(jnp.asarray(-a2, dt), (n,))
    elems = (A00, A01, o, z, x, z)        # (a00, a01, a10, a11, b0, b1)

    def combine(f, g):
        # g after f: (A_g A_f, A_g b_f + b_g)
        f00, f01, f10, f11, fb0, fb1 = f
        g00, g01, g10, g11, gb0, gb1 = g
        return (g00 * f00 + g01 * f10, g00 * f01 + g01 * f11,
                g10 * f00 + g11 * f10, g10 * f01 + g11 * f11,
                g00 * fb0 + g01 * fb1 + gb0,
                g10 * fb0 + g11 * fb1 + gb1)

    c00, c01, c10, c11, cb0, cb1 = lax.associative_scan(combine, elems,
                                                        axis=-1)
    w0 = c00 * w1_0 + c01 * w2_0 + cb0    # w[n]
    w1 = c10 * w1_0 + c11 * w2_0 + cb1    # w[n-1]
    return w0, w1


def process(params: IirParams, carry: IirCarry,
            x: jax.Array) -> tuple[IirCarry, jax.Array]:
    """Works elementwise for real or complex x (complex filters each plane
    with the same real coefficients, as the reference's complex overload)."""
    b0, b1, b2, a1, a2 = params
    w0, w1 = _second_order_recurrence(a1, a2, x, carry.w1, carry.w2)
    # w2 series = w[n-2] = w1 shifted; recover from the w1 series
    w2 = jnp.concatenate([jnp.broadcast_to(carry.w2, w1.shape[:-1] + (1,)),
                          w1[..., :-1]], axis=-1)
    y = b0 * w0 + b1 * w1 + b2 * w2
    return IirCarry(w1=w0[..., -1], w2=w1[..., -1]), y
