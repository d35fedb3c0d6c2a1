"""Stage orchestration: the end-to-end pipeline with stage-level resume.

Counterpart of ``gp_dla_detection_tpu/pipeline.py``.  Each
stage checks for its artifact and is skipped when it is complete
(catalog -> preloaded -> model + samples -> processed -> multi -> ascii
-> analysis), with per-batch checkpoints inside the process and multi
stages (``parallel/``).  The artifacts are the JAX package's: a model
either package learned loads in the other; the per-batch checkpoints
carry the port's token in their fingerprint, so the two packages never
resume each other's.

CLI (the one-command release; with no device, dtype or backend flags it
runs float32 on the CUDA device through the kernels, and raises without
a card):

    python -m gp_dla_detection_tpu_torch.pipeline --workdir runs/dr12q \\
        --lean --multi-dla --cddf-inputs \\
        [--stage all|catalog|preload|learn|samples|process|multi|ascii|analysis]

``--device cpu --dtype float64`` runs the plain path on the CPU (parity
with the JAX package).

Across cards, one process per card (``WORLD_SIZE`` > 1: the CLI joins
the process group and builds the data mesh; each rank takes
``cuda:LOCAL_RANK``):

    torchrun --nproc-per-node 4 -m gp_dla_detection_tpu_torch.pipeline \
        --workdir runs/dr12q --lean --multi-dla --cddf-inputs

Training, inference and the multi stage run data parallel on the mesh;
every rank ends each stage with the same result.  Only the coordinator
(rank 0) writes artifacts and checkpoints; for the host-only stages
(catalog, preload, samples, SNRs, ASCII, analysis) the other ranks wait
at a barrier and read what it wrote.  Which stages and batches resume is
the coordinator's decision, broadcast, so that every rank issues the
same collectives.  Without torchrun the CLI runs in one process as on
one device.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .catalog import Catalog, build_catalog
from .params import Parameters
from .samples import DLASamples, generate_dla_samples

from .alias_flag import lyb_alias_suspect
from .ascii_catalog import write_ascii_catalog, write_ascii_multi_results
from .inference import BACKENDS, InferenceResults, correct_prior_dla_flags
from .models.qso_model import GPModel
from .models.training import learn_gp_model, prepare_training_data
from .multi_dla import MultiDLAResults, prior_dla_multiplicity
from .parallel.mesh import (
    Mesh,
    barrier,
    broadcast_object,
    initialize_distributed,
    make_mesh,
    shutdown,
)
from .parallel.sharded_inference import ShardedRunConfig, process_spectra_sharded
from .parallel.sharded_multi import process_spectra_multi_sharded
from .runtime import resolve_backend
from .spectra import RaggedSpectra, preload_qsos

__all__ = ["Pipeline", "PipelineConfig", "main"]


@dataclass
class PipelineConfig:
    workdir: str = "runs/default"
    release: str = "dr12q"
    training_set_name: str = "dr9q_minus_concordance"
    test_set_name: str = "dr12q"
    dla_catalog_name: str = "dr9q_concordance"
    per_device_batch: int = 8
    sample_chunk: int = 2500
    dtype: str = "float32"
    # evidence backend of the process/multi stages: "torch" (plain path,
    # any dtype), "cuda" (the CUDA evidence kernel, float32) or None:
    # "cuda" on a CUDA device, "torch" on the CPU
    backend: str | None = None
    # where every stage's tensors live (training included)
    device: str = "cuda"
    # also write .mat v7.3 copies of the stage artifacts so the
    # reference's own CDDF_analysis code can read them (io/matio.py)
    export_matlab: bool = False
    # additionally run {no DLA, 1, 2}-DLA model selection after the
    # single-DLA pass
    multi_dla: bool = False
    # False = lean catalog-only inference: per-spectrum evidence + MAP
    # are reduced on the device and the (N, num_samples) matrix is never
    # stored (no .mat export; the multi stage runs the fused lean chain)
    store_sample_likelihoods: bool = True
    # base-axis draw replication of the lean multi stage
    # (sharded_multi.process_spectra_multi_lean); None = auto: 4 under
    # "cuda", 1 under "torch"
    base_replicates: int | None = None
    # lean multi-DLA runs only: reduce the CDDF/dN_dX/Omega_DLA inputs on
    # the device, so that the analysis stage runs from the lean result
    cddf_inputs: bool = False

    def __post_init__(self):
        # fail at config time, not hours into the run
        self.backend = resolve_backend(
            self.backend, self.device, getattr(torch, np.dtype(self.dtype).name)
        )
        if self.cddf_inputs and (
            self.store_sample_likelihoods or not self.multi_dla
        ):
            raise ValueError(
                "cddf_inputs=True requires the lean fused two-stage "
                "driver: set store_sample_likelihoods=False and "
                "multi_dla=True (classic full-matrix runs already carry "
                "what the CDDF statistics marginalize)"
            )
        if (
            self.base_replicates not in (None, 1)
            and self.store_sample_likelihoods
        ):
            raise ValueError(
                "base_replicates > 1 requires the lean fused multi-DLA "
                "driver (store_sample_likelihoods=False) — the classic "
                "pair stage resamples on the host"
            )
        if not self.store_sample_likelihoods and self.export_matlab:
            raise ValueError(
                "store_sample_likelihoods=False (lean catalog-only "
                "inference) cannot feed the .mat export — it needs the "
                "sample-likelihood matrix.  (The multi-DLA stage IS "
                "lean-compatible: run_multi switches to the fused "
                "two-stage driver.)"
            )


class Pipeline:
    """End-to-end driver.  All artifacts live under config.workdir.

    ``mesh`` (``parallel.mesh.Mesh``): training, inference and the multi
    stage run data parallel on it, and only its coordinator writes
    artifacts (see the module docstring).  None: one process, as on one
    device."""

    def __init__(
        self,
        params: Parameters | None = None,
        config: PipelineConfig | None = None,
        file_loader=None,
        mesh: Mesh | None = None,
    ):
        self.params = params or Parameters()
        self.config = config or PipelineConfig()
        self.mesh = mesh
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.config.device!r} requested but no CUDA device "
                "is available; pass device='cpu' (with backend='torch') to "
                "run on the CPU"
            )
        self.file_loader = file_loader
        self.workdir = Path(self.config.workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)

    # --- ranks: one writer, shared decisions

    @property
    def writer(self) -> bool:
        """Whether this process writes the artifacts (the coordinator)."""
        return self.mesh is None or self.mesh.is_coordinator

    def agree(self, value):
        """The coordinator's ``value`` on every rank: a decision that sends
        the ranks down one path (resume a stage or compute it)."""
        return broadcast_object(value, self.mesh)

    def once(self, build, load=None):
        """``build()``, which writes a host-only stage's artifacts, on the
        coordinator; the other ranks wait for it, then ``load()`` what it
        wrote (``load`` None: receive its return value).  One process:
        ``build()``."""
        if self.mesh is None or self.mesh.world == 1:
            return build()
        out = build() if self.writer else None
        if load is None:
            return self.agree(out)
        barrier(self.mesh)
        return out if self.writer else load()

    def written(self, write) -> None:
        """``write()`` (a computed stage's artifacts) on the coordinator;
        every rank holds the same result already, and waits here so that
        no rank reads the artifact before it is complete."""
        if self.writer:
            write()
        barrier(self.mesh)

    # --- artifact paths (processed_directory layout, set_parameters.m:82-86)
    @property
    def catalog_path(self) -> Path:
        return self.workdir / "catalog.npz"

    @property
    def preloaded_path(self) -> Path:
        return self.workdir / "preloaded_qsos.npz"

    @property
    def model_path(self) -> Path:
        return self.workdir / f"learned_qso_model_{self.config.training_set_name}.npz"

    @property
    def samples_path(self) -> Path:
        return self.workdir / "dla_samples.npz"

    @property
    def results_path(self) -> Path:
        return self.workdir / f"processed_qsos_{self.config.test_set_name}.npz"

    @property
    def multi_results_path(self) -> Path:
        return (
            self.workdir
            / f"processed_qsos_multi_{self.config.test_set_name}.npz"
        )

    def run_config(self, checkpoint_dir: str, **overrides) -> ShardedRunConfig:
        c = self.config
        return ShardedRunConfig(
            per_device_batch=c.per_device_batch,
            sample_chunk=c.sample_chunk,
            dtype=c.dtype,
            checkpoint_dir=checkpoint_dir,
            backend=c.backend,
            store_sample_likelihoods=c.store_sample_likelihoods,
            base_replicates=c.base_replicates,
            device=str(self.device),
            **overrides,
        )

    # --- stages ---

    def run_catalog(self, force: bool = False) -> Catalog:
        if self.agree(self.catalog_path.exists() and not force):
            return Catalog.load(self.catalog_path)

        def build():
            catalog = build_catalog(self.params)
            catalog.save(self.catalog_path)
            file_list = "\n".join(catalog.file_list()) + "\n"
            (self.workdir / "file_list").write_text(file_list)
            # rsync (download.download_spectra_command) reads it from the
            # release's spectra directory (download_spectra.sh:6-8)
            spectra_dir = self.params.spectra_directory(self.config.release)
            spectra_dir.mkdir(parents=True, exist_ok=True)
            (spectra_dir / "file_list").write_text(file_list)
            return catalog

        return self.once(build, lambda: Catalog.load(self.catalog_path))

    def run_preload(self, catalog: Catalog, force: bool = False) -> RaggedSpectra:
        if self.agree(self.preloaded_path.exists() and not force):
            return RaggedSpectra.load(self.preloaded_path)

        def build():
            spectra = preload_qsos(
                catalog, self.params, file_loader=self.file_loader,
                release=self.config.release,
            )
            spectra.save(self.preloaded_path)
            catalog.save(self.catalog_path)  # filter_flags amended in place
            return spectra

        def load():
            # the coordinator's preload amended its catalog's filter_flags
            catalog.filter_flags[:] = Catalog.load(self.catalog_path).filter_flags
            return RaggedSpectra.load(self.preloaded_path)

        return self.once(build, load)

    def run_learn(
        self,
        catalog: Catalog,
        spectra: RaggedSpectra,
        train_mask=None,
        force: bool = False,
    ) -> GPModel:
        if self.agree(self.model_path.exists() and not force):
            # the artifact's float64; the drivers cast to the run dtype
            return GPModel.load(self.model_path, device=self.device, dtype=torch.float64)
        if force:
            # a forced retrain must not silently resume the previous
            # run's L-BFGS state (iterate + curvature history)
            self.written(lambda: (self.workdir / "training_ckpt.npz").unlink(missing_ok=True))
        model, _ = learn_gp_model(
            self.training_data(catalog, spectra, train_mask),
            self.params,
            checkpoint_path=self.workdir / "training_ckpt.npz",
            device=self.device,
            mesh=self.mesh,
        )
        self.written(lambda: model.save(self.model_path))
        return model

    def training_data(self, catalog: Catalog, spectra: RaggedSpectra, train_mask=None):
        """The learn stage's training matrices (learn_qso_model.m:29-70):
        ``train_mask`` (default: DR9 without concordance DLAs) quasars with
        a loaded spectrum."""
        if train_mask is None:
            train_mask = catalog.train_dr9_no_concordance_dlas()
        idx = np.flatnonzero(train_mask & (spectra.lengths() > 0))
        rows = [spectra.row(int(i)) for i in idx]
        return prepare_training_data(
            [r[0] for r in rows],
            [r[1] for r in rows],
            [r[2] for r in rows],
            [r[3] for r in rows],
            catalog.z_qsos[idx],
            self.params,
        )

    def run_samples(self, catalog: Catalog, force: bool = False) -> DLASamples:
        if self.agree(self.samples_path.exists() and not force):
            return DLASamples.load(self.samples_path)

        def build():
            observed = catalog.dla_catalogs[
                self.config.dla_catalog_name
            ].all_log_nhis()
            samples = generate_dla_samples(observed, self.params)
            samples.save(self.samples_path)
            if self.config.export_matlab:
                from .io.matio import write_dla_samples_mat

                write_dla_samples_mat(samples, self.workdir / "dla_samples.mat")
            return samples

        return self.once(build, lambda: DLASamples.load(self.samples_path))

    def _padded_test_spectra(self, catalog: Catalog, spectra: RaggedSpectra, test_mask):
        test_idx = np.flatnonzero(test_mask)
        return spectra.to_padded(
            indices=test_idx,
            z_qsos=catalog.z_qsos[test_idx],
            pixel_pad=self.params.pixel_pad,
            pixel_spacing=self.params.instrument.pixel_spacing,
        )

    def run_inference(
        self,
        catalog: Catalog,
        spectra: RaggedSpectra,
        model: GPModel,
        samples: DLASamples,
        test_mask=None,
        prior_mask=None,
        force: bool = False,
    ) -> InferenceResults:
        if test_mask is None:
            test_mask = self.default_test_mask(catalog, spectra)
        if prior_mask is None:
            prior_mask = catalog.prior_dr9_concordance()
        cached = None
        if self.writer and self.results_path.exists() and not force:
            # a cached result is only valid for the SAME test selection
            mask_path = self.workdir / "test_mask.npz"
            stale = False
            why = "test selection changed since the cached inference run"
            if mask_path.exists():
                with np.load(mask_path) as f:
                    stale = not np.array_equal(f["test_mask"], test_mask)
            if not stale:
                cached = InferenceResults.load(self.results_path)
                # a full artifact is a strict superset of a lean request;
                # only the lean -> full direction lacks data
                if (
                    cached.sample_log_likelihoods_dla is None
                    and self.config.store_sample_likelihoods
                ):
                    cached = None
            if cached is None:
                if not stale:
                    why = (
                        "cached inference artifact is lean (no sample "
                        "matrix) but this config requests the full form"
                    )
                warnings.warn(
                    f"{why}; recomputing (stale results + batch checkpoints "
                    "dropped)",
                    stacklevel=2,
                )
                force = True
        if self.agree(cached is not None):
            return cached if self.writer else InferenceResults.load(self.results_path)
        if self.agree(force):
            # stale per-batch checkpoints must not survive a forced rerun
            self.written(
                lambda: shutil.rmtree(self.workdir / "inference_ckpt", ignore_errors=True)
            )

        dc = catalog.dla_catalogs[self.config.dla_catalog_name]
        prior_idx = np.flatnonzero(prior_mask)
        prior_flags = correct_prior_dla_flags(
            catalog.z_qsos[prior_idx],
            dc.dla_ind[prior_idx],
            [dc.z_dlas[int(i)] for i in prior_idx],
        )
        results = process_spectra_sharded(
            model,
            samples.offset_samples,
            samples.nhi_samples,
            self._padded_test_spectra(catalog, spectra, test_mask),
            catalog.z_qsos[prior_idx],
            prior_flags,
            params=self.params,
            mesh=self.mesh,
            config=self.run_config(str(self.workdir / "inference_ckpt")),
        )

        def write():
            results.save(self.results_path)
            np.savez_compressed(self.workdir / "test_mask.npz", test_mask=test_mask)
            if self.config.export_matlab:
                from .io.matio import write_processed_mat

                write_processed_mat(
                    results,
                    test_mask,
                    self.workdir
                    / f"processed_qsos_{self.config.test_set_name}.mat",
                )

        self.written(write)
        return results

    def run_multi(
        self,
        catalog: Catalog,
        spectra: RaggedSpectra,
        model: GPModel,
        samples: DLASamples,
        results: InferenceResults,
        test_mask,
        prior_mask=None,
        force: bool = False,
    ) -> MultiDLAResults:
        """{no DLA, 1, 2}-DLA model selection: the fused lean chain
        (lean runs) or the classic pair stage reusing the single-DLA
        stage's sample matrix."""
        if self.agree(self.multi_results_path.exists() and not force):
            return MultiDLAResults.load(self.multi_results_path)
        if force:
            self.written(lambda: shutil.rmtree(self.workdir / "multi_ckpt", ignore_errors=True))
        if prior_mask is None:
            prior_mask = catalog.prior_dr9_concordance()

        dc = catalog.dla_catalogs[self.config.dla_catalog_name]
        prior_idx = np.flatnonzero(prior_mask)
        prior_num = prior_dla_multiplicity(
            catalog.z_qsos[prior_idx],
            dc.dla_ind[prior_idx],
            [dc.z_dlas[int(i)] for i in prior_idx],
        )
        multi = process_spectra_multi_sharded(
            model,
            samples.offset_samples,
            samples.nhi_samples,
            self._padded_test_spectra(catalog, spectra, test_mask),
            catalog.z_qsos[prior_idx],
            prior_num,
            params=self.params,
            mesh=self.mesh,
            config=self.run_config(
                str(self.workdir / "multi_ckpt"), store_cddf_inputs=self.config.cddf_inputs
            ),
            # lean mode recomputes the single stage per batch (a lean
            # `results` has no sample matrix); full mode reuses it
            single=(
                results if self.config.store_sample_likelihoods else None
            ),
        )

        def write():
            multi.save(self.multi_results_path)
            if self.config.export_matlab:
                from .io.matio import write_multi_processed_mat

                write_multi_processed_mat(
                    multi,
                    test_mask,
                    self.workdir
                    / f"processed_qsos_multi_{self.config.test_set_name}.mat",
                    samples=samples,
                )

        self.written(write)
        return multi

    @staticmethod
    def default_test_mask(catalog: Catalog, spectra: RaggedSpectra) -> np.ndarray:
        """The default processing selection: unfiltered quasars with a
        loaded spectrum (the reference's standard test_ind)."""
        return catalog.unfiltered() & (spectra.lengths() > 0)

    def run_snrs(
        self, spectra: RaggedSpectra, results: InferenceResults, test_mask,
        force: bool = False,
    ) -> np.ndarray:
        """SNR per processed spectrum for the analysis layer's cuts
        (calc_cddf.py compute_all_snrs equivalent)."""
        from .analysis.cddf import compute_all_snrs

        path = self.workdir / "snrs.npz"
        idx = np.flatnonzero(test_mask)

        def load():
            with np.load(path) as f:
                # only valid for the same test selection
                if "test_idx" in f and np.array_equal(f["test_idx"], idx):
                    return f["snrs"]
            return None

        cached = load() if self.writer and path.exists() and not force else None
        if self.agree(cached is not None):
            return cached if self.writer else load()

        def build():
            snrs = compute_all_snrs(
                spectra, idx, results.min_z_dlas, results.max_z_dlas
            )
            np.savez_compressed(path, snrs=snrs, test_idx=idx)
            if self.config.export_matlab:
                from .io.matio import write_snrs_mat

                write_snrs_mat(snrs, self.workdir / "snrs.mat")
            return snrs

        return self.once(build, load)

    def run_ascii(self, catalog, samples, results, test_mask, multi=None) -> dict:
        def build():
            paths = write_ascii_catalog(
                self.workdir,
                self.config.test_set_name,
                catalog,
                samples,
                results,
                test_mask,
            )
            if multi is not None:
                paths["multi_results"] = write_ascii_multi_results(
                    self.workdir, self.config.test_set_name, catalog,
                    samples, multi, test_mask,
                )
            return paths

        return self.once(build)

    def run_analysis(self, force: bool = False, plots: bool = True) -> dict:
        """The science statistics stage (calc_cddf.py's deliverable):
        the catalogue from the stage artifacts — lean device-reduced CDDF
        inputs detected — and CDDF / dN_dX / Omega_DLA (both estimators)
        with their confidence intervals as ``analysis/statistics.json``,
        plus the reference figures (analysis/plots.do_data_plots) under
        ``workdir/analysis/`` when matplotlib is installed."""
        out_dir = self.workdir / "analysis"
        stats_path = out_dir / "statistics.json"
        if self.agree(stats_path.exists() and not force):
            return json.loads(stats_path.read_text())
        return self.once(lambda: self._analysis(out_dir, stats_path, plots))

    def _analysis(self, out_dir: Path, stats_path: Path, plots: bool) -> dict:
        from .analysis.cddf import DLACatalogue

        out_dir.mkdir(parents=True, exist_ok=True)
        cat = DLACatalogue.from_run(
            self.workdir, self.config.test_set_name,
            multi=self.config.multi_dla,
        )
        z_lo, z_hi = 2.0, 5.0
        l_cent, cddf, c68, c95, _ = cat.column_density_function(
            z_min=1.0, z_max=6.0
        )
        zc_d, dndx, d68, d95, _ = cat.line_density(z_min=z_lo, z_max=z_hi)
        zc_o, om, om_err, _ = cat.omega_dla(z_min=z_lo, z_max=z_hi)
        zc_c, omc, o68, o95, _ = cat.omega_dla_cddf(z_min=z_lo, z_max=z_hi)
        tol = lambda a: np.asarray(a, np.float64).tolist()
        stats = {
            "lean_inputs": cat.__class__.__name__ != "DLACatalogue",
            "cddf": {"log_nhi": tol(l_cent), "f_N": tol(cddf),
                     "ci68": tol(c68), "ci95": tol(c95)},
            "line_density": {"z": tol(zc_d), "dN_dX": tol(dndx),
                             "ci68": tol(d68), "ci95": tol(d95)},
            "omega_dla_direct": {"z": tol(zc_o), "omega": tol(om),
                                 "err": tol(om_err)},
            "omega_dla_cddf": {"z": tol(zc_c), "omega": tol(omc),
                               "ci68": tol(o68), "ci95": tol(o95)},
        }
        stats_path.write_text(json.dumps(stats, indent=1))
        if plots:
            try:
                import matplotlib  # noqa: F401
            except ImportError:
                warnings.warn(
                    "matplotlib is not installed: statistics.json is written, "
                    "the figures are not",
                    stacklevel=2,
                )
            else:
                from .analysis.plots import do_2dla_plots, do_data_plots

                do_data_plots(cat, out_dir)
                if getattr(cat, "second_dla", False):
                    do_2dla_plots(cat, out_dir)
        return stats

    def run_all(self) -> dict:
        catalog = self.run_catalog()
        spectra = self.run_preload(catalog)
        model = self.run_learn(catalog, spectra)
        samples = self.run_samples(catalog)
        test_mask = self.default_test_mask(catalog, spectra)
        results = self.run_inference(catalog, spectra, model, samples, test_mask)
        self.run_snrs(spectra, results, test_mask)
        multi = None
        if self.config.multi_dla:
            multi = self.run_multi(
                catalog, spectra, model, samples, results, test_mask
            )
        paths = self.run_ascii(catalog, samples, results, test_mask, multi)
        summary = {
            "num_quasars": int(len(catalog)),
            "num_processed": int(test_mask.sum()),
            "num_p_dla_gt_0.9": int((results.p_dlas > 0.9).sum()),
            "artifacts": {k: str(v) for k, v in paths.items()},
        }
        if multi is not None:
            summary["num_p_2dla_gt_0.9"] = int(
                (multi.model_posteriors[:, 2] > 0.9).sum()
            )
            summary["num_lyb_alias_suspect"] = int(
                (
                    (np.argmax(multi.model_posteriors, axis=1) == 2)
                    & lyb_alias_suspect(
                        multi, samples.offset_samples,
                        samples.log_nhi_samples,
                    )
                ).sum()
            )
            summary["artifacts"]["multi"] = str(self.multi_results_path)
        # the statistics run whenever their inputs exist: classic
        # full-matrix runs always; lean runs with device-reduced CDDF
        # inputs (the one-command release path)
        if self.config.multi_dla and (
            self.config.store_sample_likelihoods or self.config.cddf_inputs
        ):
            self.run_analysis()
            summary["artifacts"]["analysis"] = str(
                self.workdir / "analysis" / "statistics.json"
            )
        if self.writer:
            (self.workdir / "summary.json").write_text(json.dumps(summary, indent=2))
        return summary


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--base-directory", default="data")
    p.add_argument(
        "--stage",
        default="all",
        choices=[
            "all", "catalog", "preload", "learn", "samples", "process",
            "multi", "ascii", "analysis",
        ],
    )
    p.add_argument(
        "--multi-dla", action="store_true",
        help="also run {0,1,2}-DLA model selection in --stage all",
    )
    p.add_argument(
        "--backend", default=None, choices=list(BACKENDS),
        help="evidence backend (cuda = the CUDA evidence kernel, float32; "
        "default: cuda on a CUDA device, torch on the CPU)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device of every stage (cuda, cuda:1, cpu, ...)",
    )
    p.add_argument(
        "--per-device-batch", type=int, default=8,
        help="spectra per batch",
    )
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64"],
        help="compute dtype (float64 = plain-path parity mode, with "
        "--device cpu or --backend torch)",
    )
    p.add_argument(
        "--lean", action="store_true",
        help="catalog-only inference: device-reduced evidence + MAP, no "
        "(N, num_samples) matrices stored (no .mat export); the multi "
        "stage runs the fused one-pass two-stage chain",
    )
    p.add_argument(
        "--base-replicates", type=int, default=None,
        help="--lean multi stage: share each posterior base draw between "
        "R columns of a 256-column tile (default: 4 under cuda, else 1)",
    )
    p.add_argument(
        "--cddf-inputs", action="store_true",
        help="--lean --multi-dla only: device-reduce the CDDF/dN_dX/"
        "Omega_DLA inputs so the science statistics run from the lean "
        "result",
    )
    p.add_argument(
        "--export-matlab", action="store_true",
        help="also write .mat v7.3 stage artifacts for the reference's "
        "CDDF_analysis code",
    )
    args = p.parse_args(argv)

    # under torchrun: one rank per card, a data mesh over all of them
    mesh = None
    device = args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_distributed(None, int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
        mesh = make_mesh()
        if device == "cuda" and mesh.device is not None:
            device = str(mesh.device)
    try:
        run_stages(args, device, mesh)
    finally:
        if mesh is not None:
            shutdown()


def run_stages(args, device: str, mesh: Mesh | None) -> None:
    """The CLI's stages (``--stage``); the coordinator prints."""
    params = Parameters(base_directory=args.base_directory)
    pipe = Pipeline(
        params,
        PipelineConfig(
            workdir=args.workdir, multi_dla=args.multi_dla,
            backend=args.backend,
            device=device,
            per_device_batch=args.per_device_batch,
            dtype=args.dtype,
            store_sample_likelihoods=not args.lean,
            base_replicates=args.base_replicates,
            cddf_inputs=args.cddf_inputs,
            export_matlab=args.export_matlab,
        ),
        mesh=mesh,
    )
    say = print if pipe.writer else (lambda *a, **kw: None)
    if args.stage == "all":
        say(json.dumps(pipe.run_all(), indent=2))
        return
    catalog = pipe.run_catalog()
    if args.stage == "catalog":
        return
    spectra = pipe.run_preload(catalog)
    if args.stage == "preload":
        return
    if args.stage == "learn":
        pipe.run_learn(catalog, spectra)
        return
    if args.stage == "samples":
        pipe.run_samples(catalog)
        return
    model = pipe.run_learn(catalog, spectra)
    samples = pipe.run_samples(catalog)
    test_mask = pipe.default_test_mask(catalog, spectra)
    results = pipe.run_inference(catalog, spectra, model, samples, test_mask)
    if args.stage == "multi":
        pipe.run_multi(catalog, spectra, model, samples, results, test_mask)
    if args.stage == "ascii":
        pipe.run_ascii(catalog, samples, results, test_mask)
    if args.stage == "analysis":
        say(json.dumps(pipe.run_analysis(), indent=1)[:2000])


if __name__ == "__main__":
    main()
