"""Parallel execution: the (data, sample) mesh over torch.distributed
ranks, the drivers over many batches with checkpoints (the single-DLA
driver, the {0,1,2}-DLA drivers with the fused lean chain and its device
reductions, the classic flow), their one batch loop (pipelined upload /
issue / complete, resume, background checkpoint writes), checkpoint
fingerprints.

Counterpart of ``gp_dla_detection_tpu/parallel/``; the XLA-only
``shard_map_compat`` and ``NamedSharding`` helpers (``data_sharding``,
``sample_sharding``, ``replicated``, ``shard_batch``) are not ported: a
rank is one process with one card.
"""

from .mesh import (
    DATA_AXIS,
    SAMPLE_AXIS,
    Mesh,
    fetch_global,
    initialize_distributed,
    is_coordinator,
    make_mesh,
    shutdown,
)
from .overlap import BackgroundWriter, Transfers, run_pipelined, run_pipelined_split
from .sharded_inference import ShardedRunConfig, process_spectra_sharded, run_fingerprint
from .sharded_multi import (
    FUSED_LEAN_BASE_REPLICATES,
    process_spectra_multi,
    process_spectra_multi_lean,
    process_spectra_multi_sharded,
)
from .streaming import pack_lean

__all__ = [
    "process_spectra_multi_sharded",
    "DATA_AXIS",
    "SAMPLE_AXIS",
    "make_mesh",
    "initialize_distributed",
    "ShardedRunConfig",
    "process_spectra_sharded",
    "FUSED_LEAN_BASE_REPLICATES",
    "Mesh",
    "fetch_global",
    "is_coordinator",
    "pack_lean",
    "process_spectra_multi",
    "process_spectra_multi_lean",
    "run_fingerprint",
    "shutdown",
    "BackgroundWriter",
    "Transfers",
    "run_pipelined",
    "run_pipelined_split",
]
