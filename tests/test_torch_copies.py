"""The port's own copies of the JAX package's numpy modules equal their
originals on the same inputs, bit for bit.

The port imports nothing of the JAX package (tests/test_torch_imports.py
scans for it); it carries copies of the modules it needs.  Each case here
feeds one copied module and its JAX original the same numpy inputs, or
writes a file with one package and reads it with the other.
"""

import contextlib
import dataclasses
import io
import tarfile

import numpy as np
import pytest
import torch

import gp_dla_detection_tpu.analysis.cddf as j_cddf
import gp_dla_detection_tpu.analysis.tables as j_tables
import gp_dla_detection_tpu.catalog as j_catalog
import gp_dla_detection_tpu.download as j_download
import gp_dla_detection_tpu.io.fits as j_fits
import gp_dla_detection_tpu.io.matio as j_matio
import gp_dla_detection_tpu.params as j_params
import gp_dla_detection_tpu.samples as j_samples
import gp_dla_detection_tpu.utils.observability as j_obs
import gp_dla_detection_tpu.utils.synthetic as j_synthetic
import gp_dla_detection_tpu_torch.analysis.cddf as p_cddf
import gp_dla_detection_tpu_torch.analysis.tables as p_tables
import gp_dla_detection_tpu_torch.catalog as p_catalog
import gp_dla_detection_tpu_torch.download as p_download
import gp_dla_detection_tpu_torch.io.fits as p_fits
import gp_dla_detection_tpu_torch.io.matio as p_matio
import gp_dla_detection_tpu_torch.params as p_params
import gp_dla_detection_tpu_torch.samples as p_samples
import gp_dla_detection_tpu_torch.utils.observability as p_obs
import gp_dla_detection_tpu_torch.utils.synthetic as p_synthetic
from gp_dla_detection_tpu_torch.spectra import RaggedSpectra

torch.set_num_threads(1)


def assert_same(a, b, where="value"):
    """Bit-equal numpy arrays (NaN where the other has NaN), equal
    scalars, strings, and containers of them, recursively."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, (where, a, b)


def params_fields_and_derived(tmp_path, release):
    pj, pp = j_params.Parameters(), p_params.Parameters()
    assert_same(dataclasses.asdict(pj), dataclasses.asdict(pp), "Parameters")
    rng = np.random.default_rng(0)
    wmin = rng.uniform(3600.0, 4200.0, 16)
    z_qso = rng.uniform(2.2, 4.0, 16)
    for name in ("min_z_cut", "max_z_cut"):
        assert getattr(pj, name) == getattr(pp, name), name
    assert_same(pj.max_z_dla_from_wmax(wmin), pp.max_z_dla_from_wmax(wmin))
    assert_same(np.asarray(pj.min_z_dla_from_wmin(wmin, z_qso)),
                np.asarray(pp.min_z_dla_from_wmin(wmin, z_qso)))
    # the copy's torch branch rounds as its numpy branch
    assert_same(np.asarray(pp.min_z_dla_from_wmin(wmin, z_qso)),
                pp.min_z_dla_from_wmin(torch.as_tensor(wmin), torch.as_tensor(z_qso)).numpy())
    assert_same(pj.null_model.rest_wavelengths(), pp.null_model.rest_wavelengths())
    assert_same(pj.instrument.profile(), pp.instrument.profile())
    for fn in ("kms_to_z",):
        assert getattr(j_params, fn)(3000.0) == getattr(p_params, fn)(3000.0)
    assert_same(j_params.emitted_wavelengths(wmin, z_qso), p_params.emitted_wavelengths(wmin, z_qso))
    assert_same(j_params.observed_wavelengths(wmin, z_qso), p_params.observed_wavelengths(wmin, z_qso))
    assert str(pj.spectra_directory("dr12q")) == str(pp.spectra_directory("dr12q"))


def build_catalog(tmp_path, release):
    base = release.base_directory
    ours = p_catalog.build_catalog(p_params.Parameters(base_directory=base))
    ref = j_catalog.build_catalog(j_params.Parameters(base_directory=base))
    assert len(ours) == len(ref) > 0
    assert_same(ref, ours, "Catalog")
    # each package loads the other's artifact
    ours.save(tmp_path / "port.npz")
    ref.save(tmp_path / "jax.npz")
    for load in (j_catalog.Catalog.load, p_catalog.Catalog.load):
        assert_same(load(tmp_path / "port.npz"), load(tmp_path / "jax.npz"), "loaded")


def generate_dla_samples(tmp_path, release):
    rng = np.random.default_rng(1)
    log_nhis = rng.normal(20.7, 0.4, 300).clip(20.05, 22.4)
    pp = p_params.Parameters(dla_sampling=p_params.DLASamplingParams(num_dla_samples=500))
    pj = j_params.Parameters(dla_sampling=j_params.DLASamplingParams(num_dla_samples=500))
    ours = p_samples.generate_dla_samples(log_nhis, pp)
    ref = j_samples.generate_dla_samples(log_nhis, pj)
    assert_same(ref, ours, "DLASamples")
    ours.save(tmp_path / "samples.npz")
    assert_same(j_samples.DLASamples.load(tmp_path / "samples.npz"), ref, "jax<-port")


def fits_round_trip(tmp_path, release):
    rng = np.random.default_rng(2)
    names = ["FLUX", "LOGLAM", "IVAR", "AND_MASK", "NAME"]
    cols = [rng.normal(size=50).astype(np.float32), rng.uniform(3.5, 3.7, 50),
            rng.uniform(size=50).astype(np.float32), rng.integers(0, 2**20, 50, dtype=np.int32),
            np.array([f"J{i:05d}" for i in range(50)], dtype="S6")]
    p_fits.write_bintable(tmp_path / "port.fits", names, cols)
    j_fits.write_bintable(tmp_path / "jax.fits", names, cols)
    assert (tmp_path / "port.fits").read_bytes() == (tmp_path / "jax.fits").read_bytes()
    for reader, path in ((j_fits.read_bintable, "port.fits"), (p_fits.read_bintable, "jax.fits")):
        table = reader(tmp_path / path, hdu=1)
        for name, col in zip(names, cols):
            assert_same(np.asarray(table[name]), col, name)


def mat_round_trip(tmp_path, release):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    data = {"p_dlas": rng.uniform(size=(1, 40)), "sample_log_likelihoods_dla": rng.normal(size=(40, 7)),
            "min_z_dlas": rng.uniform(2, 3, (1, 40))}
    p_matio.write_mat(tmp_path / "port.mat", data)
    j_matio.write_mat(tmp_path / "jax.mat", data)
    back_j = j_matio.read_mat(tmp_path / "port.mat")
    back_p = p_matio.read_mat(tmp_path / "jax.mat")
    for k, v in data.items():
        assert_same(np.asarray(back_j[k]), np.asarray(back_p[k]), k)


def compute_all_snrs(tmp_path, release):
    rng = np.random.default_rng(4)
    waves, fluxes, noises, masks = [], [], [], []
    for _ in range(12):
        n = int(rng.integers(200, 400))
        w = 3600.0 * 10 ** (1e-4 * np.arange(n)) * rng.uniform(1.0, 1.3)
        waves.append(w)
        fluxes.append(rng.normal(1.0, 0.4, n))
        noises.append(np.where(rng.uniform(size=n) < 0.05, np.inf, rng.uniform(0.01, 0.1, n)))
        masks.append(rng.uniform(size=n) < 0.05)
    spectra = RaggedSpectra.from_lists(waves, fluxes, noises, masks, np.ones(12))
    idx = np.arange(12)
    min_z, max_z = rng.uniform(2.0, 2.1, 12), rng.uniform(2.1, 2.3, 12)
    assert_same(j_cddf.compute_all_snrs(spectra, idx, min_z, max_z),
                p_cddf.compute_all_snrs(spectra, idx, min_z, max_z))


def dla_catalogue_statistics(tmp_path, release):
    rng = np.random.default_rng(5)
    n, S = 120, 300
    p_dla = rng.uniform(size=n) ** 3
    z_min, z_max = rng.uniform(2.0, 2.4, n), rng.uniform(3.0, 3.6, n)
    sll = rng.normal(-5.0, 3.0, (n, S))
    ll_dla = np.log(np.mean(np.exp(sll), axis=1))
    offsets, lnhi = rng.uniform(size=S), rng.uniform(20.0, 22.5, S)
    snrs = rng.uniform(1.0, 10.0, n)
    cats = [mod.DLACatalogue(p_dla, z_min, z_max, sll, ll_dla, offsets, lnhi, snrs=snrs)
            for mod in (j_cddf, p_cddf)]
    for stat in ("column_density_function", "line_density", "omega_dla_cddf", "omega_dla"):
        a, b = (getattr(c, stat)() for c in cats)
        assert_same(a, b, stat)


def synthetic_workload(tmp_path, release):
    kw = dict(pixels=300, k=5, seed=7, dtype=np.float64)
    ref = j_synthetic.synthetic_workload(6, 40, **kw)
    ours = p_synthetic.synthetic_workload(6, 40, **kw)
    params = (ref.pop("params"), ours.pop("params"))
    assert_same(dataclasses.asdict(params[0]), dataclasses.asdict(params[1]), "params")
    assert_same(ref, ours, "workload")


def latex_tables(tmp_path, release):
    rng = np.random.default_rng(6)
    for x in (0.0, np.inf, 3.1e4, 0.0123, -2.5e-6, 7.0):
        assert j_tables.format_latex_num(x) == p_tables.format_latex_num(x)
    for a, b in ((0.0, 3e-4), (1.5, 2.5), (2e-6, 9e-6)):
        assert j_tables.format_latex_two_num(a, b) == p_tables.format_latex_two_num(a, b)
    lo = rng.uniform(0.1, 1.0, 5)
    table = np.stack([np.linspace(2.0, 4.0, 5), lo, lo * 0.9, lo * 1.1, lo * 0.8, lo * 1.2])
    np.savetxt(tmp_path / "dndx_all.txt", table)
    np.savetxt(tmp_path / "omega_dla_all.txt", table * 1e-3)
    cddf = table.copy()
    cddf[0] = np.linspace(20.0, 22.0, 5)
    cddf[1:, -1] = 0.0  # an empty last bin ends the CDDF table
    np.savetxt(tmp_path / "cddf_all.txt", cddf)
    np.savetxt(tmp_path / "cddf_one_bin.txt", cddf[:, :1])
    with contextlib.redirect_stdout(io.StringIO()):
        assert j_tables.print_all_tables(tmp_path) == p_tables.print_all_tables(tmp_path)


def fake_fetcher(log):
    """Writes each planned file as a small fixture (tests/test_download.py's
    layouts), logging what was asked for; nothing is fetched."""

    def fetch(url, destination):
        log.append((url, str(destination)))
        destination.parent.mkdir(parents=True, exist_ok=True)
        name = destination.name
        if name == "BOSSLyaDR9_cat.txt":
            rows = ["# header"]
            for tid, z, n in ((101, 2.5, 20.6), (102, -1.0, 0.0), (103, 3.0, 21.2)):
                row = ["x"] * 16
                row[3], row[14], row[15] = str(tid), str(z), str(n)
                rows.append(" ".join(row))
            destination.write_text("\n".join(rows) + "\n")
        elif name.endswith(".tgz"):
            src = destination.parent / "src"
            src.mkdir(exist_ok=True)
            (src / "DLA_DR12_v2.dat").write_text("h1\nh2\n201 0 0 0 0 0 0 0 0 2.2 20.9\n")
            (src / "LOS_DR12_v2.dat").write_text("h1\nh2\n201 0 0 0 2.5 1\n202 0 0 0 3.0 0\n")
            with tarfile.open(destination, "w:gz") as tf:
                for f in ("DLA_DR12_v2.dat", "LOS_DR12_v2.dat"):
                    tf.add(src / f, arcname=f)
        else:
            destination.write_bytes(b"fits")

    return fetch


def download_plan_and_extraction(tmp_path, release):
    from gp_dla_detection_tpu.params import Parameters as JParams
    from gp_dla_detection_tpu_torch.params import Parameters as PParams

    outs = {}
    for name, mod, params_cls in (("jax", j_download, JParams), ("port", p_download, PParams)):
        params = params_cls(base_directory=str(tmp_path / name))
        plan = mod.download_plan(params)
        log = []
        mod.download_catalogs(params, fetcher=fake_fetcher(log))
        outs[name] = {
            "plan": [(i.url, str(i.destination.relative_to(tmp_path / name))) for i in plan],
            "fetched": [u for u, _ in log],
            "spectra": [str(c).replace(str(tmp_path / name), "") for c in
                        mod.download_spectra_command(params)],
            "catalogs": {
                str(f.relative_to(tmp_path / name)): f.read_text()
                for f in sorted((tmp_path / name).rglob("*_catalog"))
            },
        }
    assert outs["jax"]["catalogs"] and outs["jax"]["plan"]
    assert_same(outs["jax"], outs["port"], "download")
    assert p_download.CATALOG_URLS == j_download.CATALOG_URLS
    assert p_download.SPECTRA_RSYNC_ROOT == j_download.SPECTRA_RSYNC_ROOT


def observability(tmp_path, release):
    import os

    assert j_obs.__all__ == p_obs.__all__
    for value in (None, "", "0", "1", "yes"):
        os.environ.pop("GPDLA_X", None)
        if value is not None:
            os.environ["GPDLA_X"] = value
        assert j_obs.env_flag("GPDLA_X") == p_obs.env_flag("GPDLA_X")
    os.environ.pop("GPDLA_X", None)
    printed = {}
    for name, mod in (("jax", j_obs), ("port", p_obs)):
        err, reports = io.StringIO(), []
        with contextlib.redirect_stderr(err):
            mod.set_debug(True)
            mod.debug_print("batch %d of %d", 3, 7)
            mod.debug_print("plain")
            mod.set_debug(False)
            mod.debug_print("hidden")
            with mod.Timer("stage", report=reports.append) as t:
                pass
            meter = mod.ProgressMeter(4, unit="spectra", every=1e9, stream=err)
            meter.update(2)
            meter.update(2)
        assert t.elapsed >= 0 and reports[0].startswith("stage took ")
        lines = err.getvalue().splitlines()
        printed[name] = lines[:2] + [line.split("]")[0] for line in lines[2:]]
        with pytest.raises(KeyError):
            with mod.trace("span"):
                raise KeyError("propagates")
    assert printed["jax"] == printed["port"] == [
        "batch 3 of 7", "plain", "[4/4",
    ]


@pytest.mark.parametrize(
    "case",
    [params_fields_and_derived, build_catalog, generate_dla_samples, fits_round_trip,
     mat_round_trip, compute_all_snrs, dla_catalogue_statistics, synthetic_workload,
     latex_tables, download_plan_and_extraction, observability],
    ids=lambda f: f.__name__,
)
def test_copy_equals_the_jax_module(case, tmp_path, synthetic_release):
    case(tmp_path, synthetic_release)
