"""Drivers over many batches on one device: the single-DLA driver, the
{0,1,2}-DLA drivers (the fused lean chain with its device reductions),
checkpoint fingerprints.

Counterpart of ``gp_dla_detection_tpu/parallel/``: the mesh,
``shard_map`` and data parallelism across cards are not ported yet.
"""

from .sharded_inference import ShardedRunConfig, process_spectra_sharded, run_fingerprint
from .sharded_multi import (
    FUSED_LEAN_BASE_REPLICATES,
    process_spectra_multi_lean,
    process_spectra_multi_sharded,
)
from .streaming import pack_lean

__all__ = [
    "FUSED_LEAN_BASE_REPLICATES",
    "ShardedRunConfig",
    "pack_lean",
    "process_spectra_multi_lean",
    "process_spectra_multi_sharded",
    "process_spectra_sharded",
    "run_fingerprint",
]
