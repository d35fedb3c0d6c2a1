"""Entry: the fused lean {0,1,2}-DLA chain of ``multi_lean``, for a
configuration of more Lyman lines than the reference's own three: the
same calls, launches and failures, with the reference's line tables
widened to the whole series (``reference.lyman_series``) when the cell
loads."""

from __future__ import annotations

from gpbench.entries.multi_lean import KERNELS, MULTI, call, failed, launches  # noqa: F401
from gpbench.reference import lyman_series

lyman_series.install()
