"""Multi-host execution helpers.

The reference is a single process; this module provides the glue for
running the time-sharded receiver across hosts of a pod slice:

  * ``initialize()`` wraps jax.distributed.initialize (coordinator-based);
  * ``HostShardedStream`` assembles one logical superblock from per-host
    ingest buffers via ``jax.make_array_from_single_device_arrays`` — each
    host contributes the time-slices owned by its local devices, so a
    20 MSPS stream can be split at the ingest level (BASELINE config 5)
    with no host ever holding the full-rate stream;
  * collectives inside the step ride the intra-host interconnect between
    local devices and the network across hosts automatically (mesh order
    puts 't' innermost over local devices).

Testable on one host via multiple processes with
jax.distributed + XLA_FLAGS=--xla_force_host_platform_device_count (see
tests/test_multihost.py which launches subprocess workers).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """Bring up the distributed runtime (call before any jax op)."""
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_time_mesh() -> Mesh:
    """A 1-D 't' mesh over every device of every process, ordered so each
    host's devices own a contiguous run of time shards."""
    return Mesh(np.array(jax.devices()), axis_names=("t",))


@dataclass
class HostShardedStream:
    """Builds globally-sharded superblock arrays from host-local samples.

    Each host ingests only its own slice of the stream (e.g. its radio
    front-end or its portion of a recorded capture).  ``assemble`` forms the
    jax.Array for one superblock without gathering data to any single host.
    """
    mesh: Mesh
    block_per_device: int

    def __post_init__(self):
        self.sharding = NamedSharding(self.mesh, P("t"))
        devs = self.mesh.devices.reshape(-1)
        self.local_devices = [d for d in devs
                              if d.process_index == jax.process_index()]
        self.n_global = len(devs)

    @property
    def local_samples_per_superblock(self) -> int:
        return self.block_per_device * len(self.local_devices)

    @property
    def global_samples_per_superblock(self) -> int:
        return self.block_per_device * self.n_global

    def assemble(self, local_iq: np.ndarray) -> jax.Array:
        """local_iq: this host's contiguous samples for the superblock
        (local_samples_per_superblock complex64)."""
        n = self.block_per_device
        if len(local_iq) != n * len(self.local_devices):
            raise ValueError(
                f"expected {n * len(self.local_devices)} samples, "
                f"got {len(local_iq)}")
        shards = [
            jax.device_put(np.asarray(local_iq[i * n:(i + 1) * n]), d)
            for i, d in enumerate(self.local_devices)
        ]
        global_shape = (self.global_samples_per_superblock,)
        return jax.make_array_from_single_device_arrays(
            global_shape, self.sharding, shards)
