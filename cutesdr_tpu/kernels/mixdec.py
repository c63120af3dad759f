"""Fused NCO-mix + polyphase decimation: a Pallas kernel through Triton.

The XLA-composed front end (ops.nco.process then ops.decimator.fused_process)
writes the mixed complex stream to device memory and reads it back for a
single-channel strided convolution.  This kernel reads the raw f32 re/im
planes once and writes only the decimated output.

The oscillator is folded out of the per-sample path.  With the exact uint32
DDS phase phi(t) = base + t*inc (ops/nco.py) and the flipped composed taps
hf of length L, the fused decimator computes

    y[n] = sum_j hf[j] * x'[D*n + j - T] * e^{j*phi(D*n + j - T)}

(x' = x - dc, T = L-1-d the carried raw history).  Splitting the phase,
phi(D*n + j - T) = phi(D*n - T) + j*inc (mod 2^32), gives

    y[n] = e^{j*phi(D*n - T)} * (sum_j c[j] * x[D*n + j - T]  -  dc * S)

with complex taps c[j] = hf[j] * e^{j*2pi*(j*inc mod 2^32)/2^32} and
S = sum_j c[j].  Both rotations come from the exact uint32 accumulator, so
the phase stays drift-free; the kernel is a complex FIR with no
transcendentals, and the per-output rotation and DC term are an
output-rate elementwise epilogue that XLA fuses.

Kernel layout: the input block is viewed as rows of D samples
(X[r, p] = x[r*D + p], a free reshape), the taps as Q = H+1 rows of D
(H = ceil(T/D) rows of history, zero-padded at the front), so output n is
sum_q X[n-H+q, :] . C[q, :].  One program owns BM consecutive outputs and
loops over the Q tap rows, accumulating a [BM, D] complex tile in f32 FMAs
(never TF32) and reducing over D at the end.  The first outputs, whose
window reaches into the carried history, are computed by the plain XLA
form on a short slice, so every kernel load is in bounds and unmasked.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cutesdr_tpu.design.decimation_plan import DecimationPlan
from cutesdr_tpu.ops import decimator as dec_ops
from cutesdr_tpu.ops import nco as nco_ops
from cutesdr_tpu.ops.util import complex_strided_corr
from cutesdr_tpu.types import K_2PI, complex_zeros

_TWO32 = 4294967296.0
TILE_ELEMS = 4096         # complex elements of one program's [BM, D] tile
NUM_WARPS = 4


def supported(decimation: int) -> bool:
    """Triton block shapes are powers of two: D = 2 ... 512 (every plan
    decimates by 2^k)."""
    return 2 <= decimation <= 512 and decimation & (decimation - 1) == 0


def block_outputs(decimation: int) -> int:
    """Outputs per program: a [BM, D] tile of TILE_ELEMS elements."""
    return max(1, TILE_ELEMS // decimation)


class MixDecParams(NamedTuple):
    hf: jax.Array            # [L] flipped composed taps (correlation form)
    phase_inc: jax.Array     # uint32


class MixDecCarry(NamedTuple):
    raw_tail: jax.Array      # [T] raw complex input history (T = L-1-d)
    phase_base: jax.Array    # uint32 phase at block start


def _angle(acc: jax.Array) -> jax.Array:
    return acc.astype(jnp.float32) * jnp.float32(K_2PI / _TWO32)


def _fir_kernel(xr_ref, xi_ref, cr_ref, ci_ref, yr_ref, yi_ref, *,
                bm: int, q_rows: int, row_off: int):
    """Outputs [i*bm, (i+1)*bm) of the kernel range; output k reads input
    rows row_off + k + q for q < q_rows."""
    i = pl.program_id(0)
    r0 = row_off + i * bm
    d = xr_ref.shape[1]

    def body(q, acc):
        ar, ai = acc
        xr = xr_ref[pl.ds(r0 + q, bm), :]
        xi = xi_ref[pl.ds(r0 + q, bm), :]
        cr = cr_ref[pl.ds(q, 1), :]
        ci = ci_ref[pl.ds(q, 1), :]
        return ar + xr * cr - xi * ci, ai + xr * ci + xi * cr

    zero = jnp.zeros((bm, d), jnp.float32)
    ar, ai = jax.lax.fori_loop(0, q_rows, body, (zero, zero))
    yr_ref[pl.ds(i * bm, bm)] = jnp.sum(ar, axis=1)
    yi_ref[pl.ds(i * bm, bm)] = jnp.sum(ai, axis=1)


class MixDecimate:
    """Streaming mix + decimate, equivalent to nco.process followed by
    decimator.fused_process.  The carried history is the *raw* input
    (MixDecCarry), so a time shard only needs its neighbour's raw tail and
    its own phase base (shard/timeshard.py)."""

    def __init__(self, plan: DecimationPlan, tune_freq: float,
                 interpret: bool = False):
        D = self.D = plan.decimation
        if not supported(D):
            raise ValueError(f"decimation {D} is not a power of two in "
                             f"2..512")
        self.plan = plan
        hf = np.asarray(plan.composed_taps())[::-1]
        self.L = len(hf)
        self.T = self.L - 1 - dec_ops.total_offset(plan)
        self.H = -(-self.T // D)            # history rows
        self.Q = self.H + 1                 # tap rows (T = L-1-d, d < D)
        self.bm = block_outputs(D)
        self.interpret = interpret
        self.params = MixDecParams(
            hf=jnp.asarray(hf, jnp.float32),
            phase_inc=jnp.asarray(nco_ops.phase_increment(tune_freq,
                                                          plan.in_rate)))

    @property
    def halo(self) -> int:
        return self.T

    def init_carry(self) -> MixDecCarry:
        return MixDecCarry(raw_tail=complex_zeros(self.T, jnp.complex64),
                           phase_base=jnp.zeros((), jnp.uint32))

    def split(self, n: int) -> tuple[int, int]:
        """(outputs computed by the XLA head, programs of the kernel) for
        an n-sample block."""
        n_out = n // self.D
        progs = max(0, n_out - self.H) // self.bm
        return n_out - progs * self.bm, progs

    def _fir(self, cr, ci, re, im, n_head, progs):
        D, H, Q, bm = self.D, self.H, self.Q, self.bm
        pad = H * D - self.T
        cr2 = jnp.pad(cr, (pad, Q * D - pad - self.L)).reshape(Q, D)
        ci2 = jnp.pad(ci, (pad, Q * D - pad - self.L)).reshape(Q, D)
        rows = re.shape[-1] // D
        kernel = functools.partial(_fir_kernel, bm=bm, q_rows=Q,
                                   row_off=n_head - H)
        out = jax.ShapeDtypeStruct((progs * bm,), jnp.float32)
        return pl.pallas_call(
            kernel,
            grid=(progs,),
            out_shape=(out, out),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
            interpret=self.interpret,
            name="mixdec_fir",
        )(re.reshape(rows, D), im.reshape(rows, D), cr2, ci2)

    def process_planes(self, params: MixDecParams, carry: MixDecCarry,
                       re: jax.Array, im: jax.Array,
                       dc_offset: jax.Array) -> tuple[MixDecCarry, jax.Array]:
        """One block given as f32 re/im planes plus the complex NCO-spur DC
        offset.  Returns the new carry and the n/D decimated outputs."""
        n = re.shape[-1]
        D, T, L = self.D, self.T, self.L
        if n % D:
            raise ValueError(f"block {n} not a multiple of {D}")
        n_head, progs = self.split(n)
        inc = params.phase_inc
        ang = _angle(jax.lax.iota(jnp.uint32, L) * inc)
        cr = params.hf * jnp.cos(ang)
        ci = params.hf * jnp.sin(ang)
        c = jax.lax.complex(cr, ci)

        # head: outputs whose window reaches into the carried history
        need = (n_head - 1) * D + L - T
        z = jnp.concatenate([carry.raw_tail,
                             jax.lax.complex(re[:need], im[:need])])
        y = (complex_strided_corr(z, cr, stride=D)
             + 1j * complex_strided_corr(z, ci, stride=D))
        if progs:
            yr, yi = self._fir(cr, ci, re, im, n_head, progs)
            y = jnp.concatenate([y, jax.lax.complex(yr, yi)])

        k = jax.lax.iota(jnp.uint32, n // D)
        rot_ang = _angle(carry.phase_base + (k * jnp.uint32(D) - jnp.uint32(T))
                         * inc)
        rot = jax.lax.complex(jnp.cos(rot_ang), jnp.sin(rot_ang))
        y = (y - dc_offset.astype(y.dtype) * jnp.sum(c)) * rot
        new_tail = (jax.lax.complex(re[n - T:], im[n - T:]) if T
                    else carry.raw_tail)
        return MixDecCarry(raw_tail=new_tail,
                           phase_base=carry.phase_base + jnp.uint32(n) * inc), y

    def __call__(self, params: MixDecParams, carry: MixDecCarry,
                 x: jax.Array) -> tuple[MixDecCarry, jax.Array]:
        """Complex-input form (x already DC-corrected)."""
        return self.process_planes(params, carry, jnp.real(x), jnp.imag(x),
                                   complex_zeros((), x.dtype))
