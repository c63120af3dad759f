"""Roofline check for the hot front-end ops: achieved device-memory
bandwidth vs the card's published peak, per op, at large batch.

The front-end ops are bandwidth-bound (few FLOPs per byte), so "speed of
light" = moving their bytes at the memory rate.  Prints one JSON line per
op with bytes moved, achieved GB/s and the bandwidth fraction against the
peak of the device JAX reports (PEAK_GBS, keyed by device_kind; a device
not in the table is an error).

Usage: python -m cutesdr_tpu.bench_roofline [--iters N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# Published device-memory bandwidth, GB/s (NVIDIA H100 SXM5 data sheet:
# 80 GB HBM3 at 3.35 TB/s).  Keyed by jax's device_kind.
PEAK_GBS = {"NVIDIA H100 80GB HBM3": 3350.0}


def peak_gbs(device_kind: str) -> float:
    if device_kind not in PEAK_GBS:
        raise KeyError(f"no published memory bandwidth for device "
                       f"{device_kind!r}; add it to PEAK_GBS")
    return PEAK_GBS[device_kind]


def _time_op(fn, *args, iters=100):
    import jax
    r = fn(*args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    r = fn(*args)
    jax.block_until_ready(r)
    t1 = (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(iters + 1):
        r = fn(*args)
    jax.block_until_ready(r)
    tn = time.perf_counter() - t0
    return max((tn - t1) / iters, 1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--out", default="bench_out/roofline.json")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    peak = peak_gbs(jax.devices()[0].device_kind)

    from cutesdr_tpu.design.decimation_plan import plan_decimation
    from cutesdr_tpu.kernels.mixdec import MixDecimate
    from cutesdr_tpu.ops import decimator, fastfir, nco

    rng = np.random.default_rng(5)
    n = 1 << 22                                   # 4M samples
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    xj = jax.device_put(jnp.asarray(x))
    results = []

    def report(name, seconds, bytes_moved, note=""):
        gbs = bytes_moved / seconds / 1e9
        r = {"op": name, "ms": round(seconds * 1e3, 3),
             "GBps": round(gbs, 1),
             "bw_fraction": round(gbs / peak, 3),
             "gsps": round(n / seconds / 1e9, 2), "note": note}
        results.append(r)
        print(json.dumps(r), flush=True)

    # NCO mix: read 8 B/sample, write 8 B/sample
    p, c = nco.init(123456.7, 2e6)
    f = jax.jit(lambda p, c, v: nco.process(p, c, v))
    report("nco_mix", _time_op(f, p, c, xj, iters=args.iters), 16 * n)

    # fused decimator (stride 32): read 8, write 8/32
    plan = plan_decimation(2e6, 20000.0)
    dp, dc = decimator.fused_init(plan)
    g = jax.jit(lambda p, c, v: decimator.fused_process(plan, p, c, v))
    report("fused_decimate_x32", _time_op(g, dp, dc, xj, iters=args.iters),
           int(8.25 * n))

    # fused mix+decimate kernel: same bytes as the decimator alone
    md = MixDecimate(plan, 123456.7)
    k = jax.jit(lambda p, c, v: md(p, c, v))
    report("mixdec_kernel_x32",
           _time_op(k, md.params, md.init_carry(), xj, iters=args.iters),
           int(8.25 * n), "replaces nco+decimate: saves the 16 B/sample "
           "intermediate")

    # overlap-save channel filter: read 8, write 8 (+FFT flops)
    fp, fc = fastfir.init(100.0, 2800.0, 0.0, 62500.0)
    h = jax.jit(lambda p, c, v: fastfir.process(p, c, v))
    report("fastfir_2048", _time_op(h, fp, fc, xj, iters=args.iters), 16 * n,
           "5*N*log2(N) FLOP/frame on top of the bytes")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(results, fo, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
