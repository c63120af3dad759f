"""Multi-device execution: time-axis sharding with ppermute halo exchange,
channel-bank sharding, and multi-host helpers.

The reference is strictly single-core (SURVEY.md section 2.4); these
components are new capability, designed around the finite memory of every
operator in the chain: sharding the time axis is *exact* because each stage
only needs a bounded history (FIR tails / overlap-save frames), which
neighbor devices exchange via ppermute.
"""

from cutesdr_tpu.shard.mesh import make_mesh
from cutesdr_tpu.shard.timeshard import ShardedReceiver
from cutesdr_tpu.shard.channels import ChannelBank, StackedReceiver
from cutesdr_tpu.shard.pipeline import PipelinedReceiver
