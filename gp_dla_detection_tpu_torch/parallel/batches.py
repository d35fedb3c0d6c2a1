"""The drivers' batch loop: super-batches, resume, upload, the pipelined
issue / complete, checkpoints.

Every driver of ``parallel/`` (the single-DLA driver, the fused lean
chain, the classic flow's pair stage) runs its spectra through
:func:`run_batches`: fixed-size super-batches (``per_device_batch`` x
the mesh's data axis) in order, each data rank on its rows; the batches
whose checkpoint the manifest lists are reloaded, the others run as
upload / issue / complete (``overlap.run_pipelined_split``) with
``depth`` batches in flight, pinned host buffers and non-blocking copies
on a copy stream of their own (``overlap.Transfers``).  Each batch's
results are gathered along the data axis, so that every rank holds the
whole result, and the coordinator writes each batch's checkpoint file
and then the JSON manifest listing it on a background writer
(``overlap.BackgroundWriter``), so that an interrupted run resumes from
its completed batches, on this mesh or another.

A driver hands in only what is its own: the host arrays it uploads
beside the spectra, the stages it enqueues on the device, its host
translation of the fetched values into the payload that is
checkpointed and stored, and where it stores it.
"""

from __future__ import annotations

import json
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..utils import ProgressMeter, trace
from ..utils.atomic_io import atomic_savez, atomic_write_json
from ..utils.observability import current_call
from .mesh import DATA_AXIS, Mesh, broadcast_object, fetch_global
from .overlap import BackgroundWriter, Transfers, run_pipelined_split

__all__ = ["BatchLog", "rank_rows", "run_batches"]


def run_batches(spectra, mesh: Mesh, per_device_batch: int, device, dtype, *, issue, complete,
                store, depth: int, progress: bool, ckpt_dir: Path | None, manifest: dict,
                keys, what: str, host_arrays=lambda own: ()) -> None:
    """Run ``spectra`` (a ``PaddedSpectra``) through a driver's stages in
    super-batches on ``mesh``.

    - ``host_arrays(own)``: ``(array, dtype)`` pairs uploaded after the
      five spectrum arrays (``dtype`` the run's, the mask bool);
      ``own(a)`` is this rank's rows of the batch of a per-spectrum host
      array, padded like the spectra (the last row repeated);
    - ``issue(tensors)``: the batch's stages on the device, from the
      uploaded tensors; returns the values to fetch (tensors on the
      device, or host arrays);
    - ``complete(host)``: the fetched values as host arrays, gathered
      along the data axis and cut to the batch's spectra; returns the
      batch's payload, a dict of arrays, which the loop checkpoints and
      hands to ``store``; it must not change after;
    - ``store(start, stop, payload)``: keeps the payload of spectra
      ``start:stop``, computed or reloaded from its checkpoint.

    ``ckpt_dir``: the checkpoint directory (None: none); a batch is
    reloaded when the manifest there matches ``manifest`` (and the run's
    spectra and batch size), and its file holds every one of ``keys``.
    ``what`` names the checkpoints in the warning that ignores another
    run's.
    """
    n = len(spectra)
    super_batch = per_device_batch * mesh.shape[DATA_AXIS]
    rows = rank_rows(mesh, per_device_batch)
    expect = {"num_spectra": n, "batch_size": super_batch, **manifest}
    done = resumable_batches(mesh, ckpt_dir, expect, what, keys)

    log = BatchLog(mesh, n, progress)
    todo = []
    for bi, start in enumerate(range(0, n, super_batch)):
        stop = min(start + super_batch, n)
        if bi in done:
            with np.load(ckpt_dir / f"batch_{bi:06d}.npz") as f:
                store(start, stop, {k: f[k] for k in f.files})
            log.done(bi, stop - start)
        else:
            todo.append((bi, start, stop))

    transfers = Transfers(device)

    def upload(item):
        # host slice/pad and the copy to the card: no collectives
        _, start, stop = item
        batch = spectra.slice(slice(start, stop)).pad_to(super_batch).slice(rows)

        def own(a):
            v = np.asarray(a[start:stop])
            return np.concatenate([v, np.repeat(v[-1:], super_batch - len(v), axis=0)])[rows]

        return transfers.upload(
            (batch.wavelengths, dtype), (batch.flux, dtype), (batch.noise_variance, dtype),
            (batch.mask, torch.bool), (batch.z_qso, dtype), *host_arrays(own),
        )

    def issue_batch(item, uploaded):
        # the batch's work, enqueued; on a sample axis its gathers are
        # collectives, so here, in program order
        values = issue(transfers.take(uploaded))
        with trace("gpdla.stage.fetch"):
            return transfers.to_host(*values)

    def complete_batch(item, fetched):
        bi, start, stop = item
        keep = stop - start
        payload = complete([fetch_global(v, mesh, DATA_AXIS)[:keep]
                            for v in transfers.wait(fetched)])
        with trace("gpdla.batch.checkpoint"):
            # the coordinator's write of the file, then of the manifest
            # listing it; the payload does not change after
            if ckpt_dir and mesh.is_coordinator:
                writer.submit(write_checkpoint, ckpt_dir, bi, done, expect, payload,
                              current_call().id)
        store(start, stop, payload)
        return keep

    with BackgroundWriter() as writer:
        run_pipelined_split(todo, *log.stages(upload, issue_batch, complete_batch), depth=depth)


def resumable_batches(mesh: Mesh, ckpt_dir, expect: dict, what: str, keys) -> set:
    """The batches every rank loads from checkpoints instead of
    computing: those the coordinator's manifest lists when every
    ``expect`` key matches it (otherwise, another run's checkpoints, none
    and a warning) and whose file holds every one of ``keys``, broadcast,
    so that all ranks skip the same batches and issue the same
    collectives.  The coordinator also creates the directory."""
    done = set()
    if ckpt_dir and mesh.is_coordinator:
        path = ckpt_dir / "manifest.json"
        if path.exists():
            manifest = json.loads(path.read_text())
            if all(manifest.get(k) == v for k, v in expect.items()):
                done = {bi for bi in manifest["completed_batches"]
                        if has_keys(ckpt_dir / f"batch_{bi:06d}.npz", keys)}
            else:
                warnings.warn(
                    f"ignoring incompatible {what} checkpoints in {ckpt_dir} "
                    "(run shape or numerics config changed)",
                    stacklevel=5,
                )
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    return broadcast_object(done, mesh)


def has_keys(path: Path, keys) -> bool:
    """Whether the npz at ``path`` exists and holds every one of ``keys``."""
    if not path.exists():
        return False
    with np.load(path) as f:
        return set(keys) <= set(f.files)


def write_checkpoint(ckpt_dir, bi: int, done: set, manifest: dict, payload: dict,
                     call: int) -> None:
    """Batch ``bi``'s npz, then the manifest listing it with every batch
    written before (``done``, which only the writer thread changes once
    the run has begun): a manifest never lists a batch whose file has not
    landed.  ``call``: the driver call's id, for the span."""
    with trace("gpdla.checkpoint.write", call=call, batch=bi):
        atomic_savez(ckpt_dir / f"batch_{bi:06d}.npz", compress=False, **payload)
        done.add(bi)
        atomic_write_json(ckpt_dir / "manifest.json",
                          {**manifest, "completed_batches": sorted(done)})


def rank_rows(mesh: Mesh, per_device_batch: int) -> slice:
    """This data rank's rows of a padded super-batch."""
    d = mesh.data_index
    return slice(d * per_device_batch, (d + 1) * per_device_batch)


class BatchLog:
    """A driver call's batches: the span of each batch's three stages,
    its ``[driver]`` line under ``GPDLA_DRIVER_TIMING=1`` (the JAX
    drivers' lines: upload, dispatch, fetch seconds), read from those
    spans, and the progress meter; the coordinator prints them.  Made in
    a :func:`~..utils.observability.driver_call` right before the
    batches, it ends the call's ``gpdla.call.setup``.

    ``upload`` is ``gpdla.batch.upload`` (the host slice/pad and the
    enqueue of the copy to the card), ``dispatch`` ``gpdla.batch.issue``
    (the enqueue of the batch's work), ``fetch`` the part of
    ``gpdla.batch.complete`` before its ``gpdla.batch.checkpoint``: the
    wait for the results, the gathers and the batch's host
    translation."""

    def __init__(self, mesh: Mesh, total: int, progress: bool):
        call = current_call()
        call.end_setup()
        self.call = call.id
        self.recorder = call.recorder if mesh.is_coordinator else None
        self.meter = ProgressMeter(total, unit="spectra") if progress and mesh.is_coordinator else None
        self.unprinted: dict[int | None, list] = defaultdict(list)

    def stages(self, upload, issue, complete):
        """``upload``, ``issue`` and ``complete`` of the pipelined loop,
        each in its batch's span; ``complete`` returns the rows it kept,
        which :meth:`done` counts once its span closed."""

        def traced_upload(item):
            with trace("gpdla.batch.upload", call=self.call, batch=item[0]):
                return upload(item)

        def traced_issue(item, uploaded):
            with trace("gpdla.batch.issue", call=self.call, batch=item[0]):
                return issue(item, uploaded)

        def traced_complete(item, fetched):
            with trace("gpdla.batch.complete", call=self.call, batch=item[0]):
                rows = complete(item, fetched)
            self.done(item[0], rows)

        return traced_upload, traced_issue, traced_complete

    def done(self, bi: int, n: int) -> None:
        """Batch ``bi`` is in, with ``n`` spectra: its line, the meter."""
        if self.recorder is not None:
            for span in self.recorder.drain():
                self.unprinted[span.ids.get("batch")].append(span)
            line = stage_line(bi, self.unprinted.pop(bi, []))
            if line:
                print(line, flush=True)
        if self.meter is not None:
            self.meter.update(n)


def stage_line(bi: int, spans) -> str | None:
    """Batch ``bi``'s ``[driver]`` line from its spans (None without any:
    a batch resumed from its checkpoint)."""
    by = {s.name: s for s in spans}
    seconds = lambda t0, t1: (t1 - t0) * 1e-9
    steps = [(what, seconds(by[name].t0_ns, by[name].t1_ns))
             for what, name in (("upload", "gpdla.batch.upload"), ("dispatch", "gpdla.batch.issue"))
             if name in by]
    if "gpdla.batch.complete" in by and "gpdla.batch.checkpoint" in by:
        steps.append(("fetch", seconds(by["gpdla.batch.complete"].t0_ns,
                                       by["gpdla.batch.checkpoint"].t0_ns)))
    if not steps:
        return None
    return f"[driver] batch {bi}: " + ", ".join(f"{w} {t:.3f}s" for w, t in steps)
