"""Shared by the device-trace readers: each reads its quantity from a
traced run on the card, and nothing from any other run."""

from gpbench.opcount import Work


def mfu(run):
    """100 x the frozen count of every kernel of a batch times the
    batches the traced window completed, as least time at the peaks,
    over the window."""
    if not run.on_card or run.trace_summary is None or not run.batches or run.window_s <= 0:
        return None
    total = sum(run.work_per_batch().values(), Work()) * run.batches
    return 100.0 * total.least_seconds() / run.window_s


def idle(run):
    """100 x the share of the traced window no kernel, copy or fill covers."""
    ts = run.trace_summary
    if not run.on_card or ts is None or ts.window_us <= 0:
        return None
    return 100.0 * (1.0 - ts.busy_us / ts.window_us)


def kernels_per_batch(run):
    """Device kernels the traced window launched per batch its calls made."""
    ts = run.trace_summary
    if not run.on_card or ts is None or not run.batches or not ts.kernels:
        return None
    return len(ts.kernels) / run.batches
