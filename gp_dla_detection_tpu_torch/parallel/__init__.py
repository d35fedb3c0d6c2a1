"""Drivers over many batches: the fused lean two-stage chain, its
device reductions and checkpoint fingerprints.

Counterpart of ``gp_dla_detection_tpu/parallel/``, on one device so far:
the mesh, ``shard_map`` and the sharded drivers are not ported yet.
"""

from .sharded_inference import run_fingerprint
from .sharded_multi import FUSED_LEAN_BASE_REPLICATES, process_spectra_multi_lean
from .streaming import pack_lean

__all__ = [
    "FUSED_LEAN_BASE_REPLICATES",
    "pack_lean",
    "process_spectra_multi_lean",
    "run_fingerprint",
]
