"""Shared by the evidence roofline readers: a configuration's share of
its roofline over the traced window."""


def share(run, kind: str):
    """100 x (the frozen count's least time of the ``kind`` evidence
    calls the trace holds) / (their device time, table prologues
    included); None where the trace holds no such call."""
    ts = run.trace_summary
    if ts is None or not run.on_card:
        return None
    calls, us = ts.evidence.get(kind, (0, 0.0))
    work = run.work_per_batch().get(kind)
    if not calls or work is None or us <= 0:
        return None
    return 100.0 * calls * work.least_seconds() / (us * 1e-6)
