"""Hand-written kernel against the plain XLA path, on the GPU.

Times, at the benchmark's real shapes, what decides resolve_front_end and
what PERF.md "Kernel decisions" records:

  * the receiver step per block with decimator_impl "fused" (XLA mix +
    strided conv) and "pallas" (kernels/mixdec.py through Triton), steps
    interleaved, and the mix+decimate stage alone on both paths, for the
    2 MSPS x32 flagship (8.4M-sample blocks) and the 20 MSPS x256 plan;
  * the XLA channel filter (cuFFT overlap-save), the S-meter/AGC levels
    stage, and the FM / SAM sequential lax.scan tiers.

Every time is a median over >= 20 calls, each fenced by
block_until_ready; compile time is reported apart.  Requires a GPU.

Usage:  python -m cutesdr_tpu.bench_kernels [--steps N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _stats(ts):
    q1, med, q3 = np.percentile(np.asarray(ts) * 1e3, [25, 50, 75])
    return {"median_ms": float(med), "q1_ms": float(q1), "q3_ms": float(q3),
            "n": len(ts)}


def _time(f, args, steps):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(steps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return {"compile_s": compile_s, **_stats(ts)}


def _planes(n, seed):
    import jax
    rng = np.random.default_rng(seed)
    return (jax.device_put(rng.standard_normal(n).astype(np.float32) * 100),
            jax.device_put(rng.standard_normal(n).astype(np.float32) * 100))


def front_end(input_rate, frames_per_block, steps):
    """Receiver step and mix+decimate stage, fused vs pallas."""
    import jax

    from cutesdr_tpu.pipeline import receiver as rx

    kw = dict(input_rate=input_rate, mode="usb", tune_freq=100_000.0,
              audio_rate=48_000.0, frames_per_block=frames_per_block)
    cfgs = {impl: rx.ReceiverConfig(decimator_impl=impl, **kw)
            for impl in ("fused", "pallas")}
    n = cfgs["fused"].block_size
    re, im = _planes(n, 1)
    res = {"block": n, "decimation": cfgs["fused"].plan.decimation}

    steps_fn, state, compile_s = {}, {}, {}
    for impl, cfg in cfgs.items():
        p, s = rx.init(cfg)
        f = jax.jit(lambda p, s, re, im, cfg=cfg: rx.receiver_step(
            cfg, p, s, jax.lax.complex(re, im)))
        t0 = time.perf_counter()
        s, out = f(p, s, re, im)
        jax.block_until_ready(out)
        compile_s[impl] = time.perf_counter() - t0
        steps_fn[impl], state[impl] = (f, p), s
    ts = {impl: [] for impl in cfgs}
    for k in range(steps):
        order = ("fused", "pallas") if k % 2 == 0 else ("pallas", "fused")
        for impl in order:
            f, p = steps_fn[impl]
            t0 = time.perf_counter()
            state[impl], out = f(p, state[impl], re, im)
            jax.block_until_ready(out)
            ts[impl].append(time.perf_counter() - t0)
    for impl in cfgs:
        res[f"step_{impl}"] = {"compile_s": compile_s[impl],
                               **_stats(ts[impl])}

    for impl, cfg in cfgs.items():
        p, s = rx.init(cfg)
        f = jax.jit(lambda p, s, re, im, cfg=cfg: rx._front_prefilter(
            cfg, p, s, jax.lax.complex(re, im))[3])
        res[f"mixdec_{impl}"] = _time(f, (p, s, re, im), steps)
    return res


def back_stages(steps):
    """Channel filter and levels stage at the flagship's decimated block."""
    import jax
    import jax.numpy as jnp

    from cutesdr_tpu.ops import fastfir
    from cutesdr_tpu.pipeline import receiver as rx

    cfg = rx.ReceiverConfig(input_rate=2_000_000.0, mode="usb",
                            tune_freq=100_000.0, frames_per_block=256,
                            decimator_impl="fused")
    p, s = rx.init(cfg)
    n = cfg.block_size // cfg.plan.decimation
    re, im = _planes(n, 2)
    base = jax.lax.complex(re, im)
    filt = jax.jit(lambda p, s, x: fastfir.process(p.chan_filter,
                                                   s.chan_filter, x)[1])
    res = {"decimated_block": n,
           "channel_filter": _time(filt, (p, s, base), steps)}
    levels = jax.jit(lambda p, s, x: rx._levels(cfg, p, s, x)[2])
    res["levels"] = _time(levels, (p, s, base * jnp.float32(0.01)), steps)
    return res


def scan_tiers(steps):
    """The FM and SAM sequential lax.scan tiers (carrier-less noise)."""
    import jax

    from cutesdr_tpu.demod import fm, sam

    res = {}
    fp, fc = fm.init(62_500.0)
    sp, sc = sam.init(62_500.0)
    for n in (8192, 65536):
        rng = np.random.default_rng(n)
        theta = jax.device_put(
            rng.uniform(-np.pi, np.pi, n).astype(np.float32))
        f = jax.jit(lambda th: fm._pll_scan(fp, fc, th)[3])
        res[f"fm_scan_{n}"] = _time(f, (theta,), max(5, steps // 4))
        g = jax.jit(lambda th: sam._pll_scan(sp, sc, th)[2])
        res[f"sam_scan_{n}"] = _time(g, (theta,), max(5, steps // 4))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--out", default="chiprun_out/bench_kernels.json")
    args = ap.parse_args(argv)

    import jax

    from cutesdr_tpu.cache import enable_compile_cache
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench_kernels needs a GPU")
    enable_compile_cache()
    dev = jax.devices()[0]
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    res["flagship_2msps_x32"] = front_end(2_000_000.0, 256, args.steps)
    print(json.dumps(res["flagship_2msps_x32"]), flush=True)
    res["usb_20msps_x256"] = front_end(20_000_000.0, 16, args.steps)
    print(json.dumps(res["usb_20msps_x256"]), flush=True)
    res["back"] = back_stages(args.steps)
    print(json.dumps(res["back"]), flush=True)
    res["scan"] = scan_tiers(args.steps)
    print(json.dumps(res["scan"]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
