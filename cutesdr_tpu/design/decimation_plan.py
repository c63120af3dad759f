"""Decimation-chain planning: pick the cascade of decimate-by-2 stages.

Given an input sample rate and the desired maximum output bandwidth, greedily
choose the cheapest decimate-by-2 stage whose alias-free usable bandwidth
still covers the signal at the current rate, halving the rate each step,
until either the rate is inside the 51-tap filter's usable band or the
15.8 kHz output-rate floor is reached.  This is the same stage-selection rule
as the reference chain builder (dsp/downconvert.cpp:114-173, thresholds from
dsp/filtercoef.h:17-28), evaluated once at configure time; the result is a
static plan baked into the compiled pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cutesdr_tpu import coefficients as coef

MIN_OUTPUT_RATE = 7900.0 * 2.0


@dataclass(frozen=True)
class DecimationPlan:
    in_rate: float
    max_bw: float
    stages: tuple[str, ...]          # stage names in order, each decimates by 2
    out_rate: float

    @property
    def decimation(self) -> int:
        return 1 << len(self.stages)

    def stage_taps(self, name: str) -> np.ndarray:
        """FIR taps of a stage (CIC3 via its [1,3,3,1]/8 equivalent)."""
        if name == "cic3":
            return coef.CIC3_EQUIV_H
        return coef.HB_TABLES[name]

    def composed_taps(self) -> np.ndarray:
        """Single equivalent FIR at the *input* rate for the whole cascade.

        Composition rule for cascaded decimators: H_eq(z) = prod_k H_k(z^(2^k)).
        Convolving the zero-stuffed stage responses gives one FIR whose
        stride-``decimation`` polyphase implementation is mathematically
        identical to running the cascade — this powers the fused path.
        """
        h = np.array([1.0])
        for k, name in enumerate(self.stages):
            hk = self.stage_taps(name)
            up = np.zeros((len(hk) - 1) * (1 << k) + 1)
            up[:: 1 << k] = hk
            h = np.convolve(h, up)
        return h


def plan_decimation(in_rate: float, max_bw: float) -> DecimationPlan:
    stages: list[str] = []
    f = in_rate
    while f > max_bw / coef.HB51TAP_MAX and f > MIN_OUTPUT_RATE:
        for name, usable, _ in coef.STAGE_MENU:
            if f >= max_bw / usable:
                stages.append(name)
                break
        else:
            # below even hb51's requirement: cannot be reached because the
            # while-condition guarantees f > max_bw / HB51TAP_MAX
            raise AssertionError("no usable stage")
        f /= 2.0
    return DecimationPlan(in_rate=in_rate, max_bw=max_bw,
                          stages=tuple(stages), out_rate=f)
