"""Weak-scaling harness for the time-sharded receiver.

For each device count d (1, 2, 4, ... up to what the platform offers) run
the ShardedReceiver with a superblock of d x block_size samples — constant
work per device — and report samples/s plus the weak-scaling efficiency
relative to d=1.  The BASELINE north star asks for >=90% weak-scaling efficiency; run it on a
multi-GPU host to measure that (a virtual CPU mesh exercises the
mechanics, not performance).

Usage: python -m cutesdr_tpu.bench_scaling [--devices 1,2,4,8] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--input-rate", type=float, default=2e6)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cutesdr_tpu.pipeline.receiver import ReceiverConfig
    from cutesdr_tpu.shard import ShardedReceiver, make_mesh

    n_avail = len(jax.devices())
    if args.devices:
        counts = [int(c) for c in args.devices.split(",")]
    else:
        counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]

    cfg = ReceiverConfig(input_rate=args.input_rate, mode="usb",
                         tune_freq=100e3, audio_rate=48000.0)
    rng = np.random.default_rng(11)
    results = []
    base_rate = None
    for d in counts:
        mesh = make_mesh(time=d)
        srx = ShardedReceiver(cfg, mesh)
        x = ((rng.standard_normal(srx.superblock_size)
              + 1j * rng.standard_normal(srx.superblock_size)) * 100
             ).astype(np.complex64)
        # the production host-plane path
        out = srx.process_host(x)                # compile
        jax.block_until_ready(out.audio)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = srx.process_host(x)
        jax.block_until_ready(out.audio)
        dt = (time.perf_counter() - t0) / args.iters
        rate = srx.superblock_size / dt
        if base_rate is None:
            base_rate = rate
        r = {"devices": d, "superblock": srx.superblock_size,
             "ms_per_superblock": round(dt * 1e3, 3),
             "msps": round(rate / 1e6, 1),
             "weak_scaling_efficiency": round(rate / (base_rate * d), 3)}
        results.append(r)
        print(json.dumps(r), flush=True)

    with open("SCALING.json", "w") as f:
        json.dump(results, f, indent=2)
    print("wrote SCALING.json", file=sys.stderr)


if __name__ == "__main__":
    main()
