"""The port's device-reduced CDDF inputs against the JAX package.

- the host side (``CDDFReductionSpec``, ``CDDFInputs``) equal to JAX's;
- the lean chain with ``store_cddf_inputs`` (torch, float64) against
  JAX's fused lean driver with ``store_cddf_inputs`` (XLA, float64):
  ``hist`` at 1e-9, the exact entries' indices and the counters equal,
  their probabilities at 1e-9; at R = 1 and at R = 4 (replicated base
  draws, with second DLAs);
- the lean statistics (``LeanDLACatalogue``: CDDF, dN/dX, both Omega_DLA
  estimators, a bootstrap draw) against JAX's at 1e-9, at R = 1 and 4;
- float32 runs of both packages against JAX's float64 reduction, and on
  broad posteriors the second DLA's float32 exact entries against JAX's
  float32 ones and both float64 ones;
- the mass identity, the z-sorted pair axis (the reducer and the
  driver), top-k tie order, resume, the artifact round trip and the
  refusals.
"""

import dataclasses
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gp_dla_detection_tpu import cddf_inputs as jci
from gp_dla_detection_tpu.analysis.lean_catalogue import LeanDLACatalogue as JaxLeanCatalogue
from gp_dla_detection_tpu.multi_dla import MultiDLAResults as JaxMultiDLAResults
from gp_dla_detection_tpu.parallel import ShardedRunConfig as JaxRunConfig
from gp_dla_detection_tpu.parallel import make_mesh
from gp_dla_detection_tpu.parallel.sharded_multi import (
    process_spectra_multi_sharded as jax_multi_sharded,
)
from gp_dla_detection_tpu_torch import cddf_inputs as pci
from gp_dla_detection_tpu_torch.analysis import DLACatalogue, LeanDLACatalogue
from gp_dla_detection_tpu_torch.inference import PaddedSpectra
from gp_dla_detection_tpu_torch.models.qso_model import GPModel
from gp_dla_detection_tpu_torch.multi_dla import MultiDLAResults
from gp_dla_detection_tpu_torch.parallel.sharded_inference import (
    ShardedRunConfig,
    process_spectra_sharded,
)
from gp_dla_detection_tpu_torch.parallel.sharded_multi import (
    process_spectra_multi_lean,
    process_spectra_multi_sharded,
)

from synthetic_problem import make_problem

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "validation"))
from _universe import inject_dlas, injection_bounds  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's thread pool oversubscribes the cores against them
torch.set_num_threads(1)

STATS = {
    "cddf": lambda c: c.column_density_function(z_min=1.0, z_max=6.0),
    "line_density": lambda c: c.line_density(z_min=2.0, z_max=4.0),
    "omega_direct": lambda c: c.omega_dla(z_min=2.0, z_max=4.0),
    "omega_cddf": lambda c: c.omega_dla_cddf(z_min=2.0, z_max=4.0, lnhi_nbins=30),
}


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def test_constants_and_spec_equal_jax():
    for name in ("CH_SMALL_A", "CH_P", "CH_P_NU", "CH_P_VAR", "CH_P_VAR_NU2", "CH_SMALL_B",
                 "CH_SMALL2_A", "CH_SMALL2_B", "N_CHANNELS", "EX_W0", "EX_NBIG1",
                 "EX_NBIG2", "EX_ZOVER", "N_EX_SCALARS"):
        assert getattr(pci, name) == getattr(jci, name), name
    assert pci.CDDFReductionSpec().token() == jci.CDDFReductionSpec().token()
    custom = dict(n_z_window=9, top_k=5, lnhi_b_width=0.18)
    assert pci.CDDFReductionSpec(**custom).token() == jci.CDDFReductionSpec(**custom).token()


@pytest.mark.parametrize("grid", ["a", "b"])
def test_lnhi_bins_equal_jax(grid):
    rng = np.random.default_rng(5)
    lnhi = np.concatenate([rng.uniform(19.5, 23.5, 500), [20.0, 20.3, 23.0, 22.99, 20.7]])
    ours, ref = pci.CDDFReductionSpec(), jci.CDDFReductionSpec()
    np.testing.assert_array_equal(ours.lnhi_bin_index(lnhi, grid), ref.lnhi_bin_index(lnhi, grid))
    for q in (np.linspace(20.0, 23.0, 31), np.linspace(20.3, 23.0, 31),
              np.linspace(20.3, 23.0, 16), np.linspace(20.05, 23.0, 11), [20.3, 23.0]):
        a, b = ours.match_lnhi_bins(q), ref.match_lnhi_bins(q)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
    assert ours.match_z_edge(2.5) == ref.match_z_edge(2.5)
    with pytest.raises(ValueError, match="not aligned"):
        ours.match_z_edge(2.05)


def test_inputs_container_equals_jax():
    rng = np.random.default_rng(2)
    spec = pci.CDDFReductionSpec(top_k=3)
    hist = rng.uniform(size=(4, 8, spec.n_z_window, spec.n_lnhi + 1))
    ex = rng.uniform(size=(4, 5 * 3 + 4))
    ex[:, -4:] = 0.0
    ours = pci.CDDFInputs(spec, hist, ex)
    ref = jci.CDDFInputs(jci.CDDFReductionSpec(top_k=3), hist, ex)
    a, b = ours.to_npz_dict(), ref.to_npz_dict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    back = pci.CDDFInputs.from_npz_dict(b)
    assert back.spec == spec and back.second
    for name in ("ex1_p", "ex1_idx", "ex2_p", "ex2_idx", "ex2_base"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    ours.validate()
    ex[1, 5 * 3 + pci.EX_ZOVER] = 2
    with pytest.raises(ValueError, match="redshift window"):
        ours.validate()


def test_top_k_orders_ties_as_lax():
    # rows with fewer than top_k non-zero entries: all ties at 0, and
    # ties among non-zero values too
    p = np.zeros((4, 40))
    p[0, [3, 17]] = [0.5, 0.2]
    p[1, [9, 2, 30]] = 0.25
    p[2] = np.random.default_rng(1).uniform(size=40)
    vals, idx = pci._top_k(torch.as_tensor(p), 8)
    jvals, jidx = lax.top_k(jnp.asarray(p), 8)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# ---------------------------------------------------------------------------
# the lean chain's reduction against JAX's
# ---------------------------------------------------------------------------


def injected_problem(second_dlas: bool = False):
    """The shared synthetic problem with absorbers injected into half the
    sightlines (tests/test_lean_cddf.py): the statistics are vacuous
    unless some spectra clear the p_dla > 0.05 catalogue filter.
    ``second_dlas``: a second absorber in every fourth sightline, half
    the searched range from the first, so that p(2 DLAs) is ~1 there."""
    params, model, spectra, offsets, nhis, prior_z, _ = make_problem()
    rng = np.random.default_rng(42)
    inj = []
    for i in range(0, len(spectra), 2):
        zmin, zmax = injection_bounds(
            spectra.wavelengths[i, 0], spectra.wavelengths[i, -1], spectra.z_qso[i], params
        )
        if zmax > zmin:
            inj.append((i, rng.uniform(zmin, zmax), rng.uniform(20.6, 21.6)))
    if second_dlas:
        rng2 = np.random.default_rng(43)
        for i, z1, _ in list(inj):
            if i % 4 == 0:
                zmin, zmax = injection_bounds(
                    spectra.wavelengths[i, 0], spectra.wavelengths[i, -1], spectra.z_qso[i], params
                )
                z2 = zmin + (z1 - zmin + 0.5 * (zmax - zmin)) % (zmax - zmin)
                inj.append((i, z2, rng2.uniform(20.8, 21.4)))
    inject_dlas(spectra.wavelengths, spectra.flux, inj, params, chunk=16)
    prior_num = np.random.default_rng(7).choice([0, 0, 0, 0, 0, 1, 1, 2], 200)
    return params, model, spectra, offsets, nhis, prior_z, prior_num


@pytest.fixture(scope="module")
def problem():
    return injected_problem()


def port_inputs(problem):
    params, jmodel, spectra, offsets, nhis, prior_z, prior_num = problem
    model = GPModel.from_numpy(
        jmodel.rest_wavelengths, jmodel.mu, jmodel.M, jmodel.log_omega,
        jmodel.log_c_0, jmodel.log_tau_0, jmodel.log_beta, device="cpu", dtype=torch.float64,
    )
    padded = PaddedSpectra(spectra.wavelengths, spectra.flux, spectra.noise_variance,
                           spectra.mask, spectra.z_qso)
    return params, model, padded, offsets, nhis, prior_z, prior_num


def run_port(problem, dtype=torch.float64, sample_chunk=32, **kw):
    params, model, padded, offsets, nhis, prior_z, prior_num = port_inputs(problem)
    return process_spectra_multi_lean(
        model, offsets, nhis, padded, prior_z, prior_num, params=params,
        batch_size=4, sample_chunk=sample_chunk, dtype=dtype, store_cddf_inputs=True, **kw, device="cpu",
    )


def run_jax(problem, dtype="float64", sample_chunk=32, base_replicates=None):
    params, model, spectra, offsets, nhis, prior_z, prior_num = problem
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jax_multi_sharded(
            model, offsets, nhis, spectra, prior_z, prior_num, params=params,
            mesh=make_mesh(num_devices=1),
            config=JaxRunConfig(
                per_device_batch=4, sample_chunk=sample_chunk, dtype=dtype, backend="xla",
                store_sample_likelihoods=False, store_cddf_inputs=True,
                base_replicates=base_replicates,
            ),
        )


@pytest.fixture(scope="module")
def jax_lean(problem):
    return run_jax(problem)


@pytest.fixture(scope="module")
def port_lean(problem):
    return run_port(problem)


@pytest.fixture(scope="module")
def port_lean32(problem):
    return run_port(problem, dtype=torch.float32)


def assert_reduction_matches(ours, ref):
    """``hist`` at 1e-9, the exact entries' indices and the counters
    equal, their probabilities at 1e-9."""
    assert ours.spec.token() == ref.spec.token()
    assert ours.hist.dtype == np.float64 and ours.hist.shape == ref.hist.shape
    np.testing.assert_allclose(ours.hist, ref.hist, rtol=1e-9, atol=1e-300)
    K = ours.spec.top_k
    for blk in (1, 3, 4):   # ex1_idx, ex2_pair_idx, ex2_base_idx
        np.testing.assert_array_equal(
            ours.ex[:, blk * K : (blk + 1) * K], ref.ex[:, blk * K : (blk + 1) * K]
        )
    np.testing.assert_array_equal(ours.ex[:, 5 * K :], ref.ex[:, 5 * K :])  # w0 + counters
    for blk in (0, 2):      # ex1_p, ex2_p
        np.testing.assert_allclose(
            ours.ex[:, blk * K : (blk + 1) * K], ref.ex[:, blk * K : (blk + 1) * K],
            rtol=1e-9, atol=1e-300,
        )


def test_reduction_matches_jax(port_lean, jax_lean):
    ours = port_lean.cddf_inputs
    assert_reduction_matches(ours, jax_lean.cddf_inputs)
    # the exact-entry regime is not vacuous
    assert (ours.ex1_p >= ours.spec.p_switch).sum() >= 3


def samples_320():
    rng = np.random.default_rng(17)
    return rng.uniform(size=320), 10 ** rng.uniform(20, 22, 320)


@pytest.fixture(scope="module")
def replicated():
    """Both packages at R = 4 (the kernel path's default) on the XLA
    layout: 320 samples, wider than the 256-column tile the replicated
    draws are laid out on (tests/test_torch_lean_multi.py's R = 2 case),
    and a second absorber in every fourth sightline, so that the
    base-column scatter of p2 and the second-DLA exact entries carry
    mass.  Returns (problem, port results, JAX results)."""
    problem = injected_problem(second_dlas=True)
    problem = (*problem[:3], *samples_320(), *problem[5:])
    with pytest.warns(UserWarning, match="base_replicates=4"):
        ours = run_port(problem, base_replicates=4)
    ref = run_jax(problem, base_replicates=4)
    return problem, ours, ref


def test_replicated_reduction_matches_jax(replicated):
    _, ours, ref = replicated
    inputs = ours.cddf_inputs
    assert_reduction_matches(inputs, ref.cddf_inputs)
    # not vacuous: second-DLA mass in the small-p channels (the base
    # scatter) and second-DLA exact entries
    assert inputs.hist[:, pci.CH_SMALL2_A].sum() > 0.01
    assert (inputs.ex2_p >= inputs.spec.p_switch).sum() >= 2


@pytest.fixture(scope="module")
def replicated_catalogues(replicated):
    problem, ours, ref = replicated
    offsets, lnhi = problem[3], np.log10(problem[4])
    return (LeanDLACatalogue.from_results(ours, offsets, lnhi),
            JaxLeanCatalogue.from_results(ref, offsets, lnhi))


@pytest.mark.parametrize("stat", sorted(STATS))
def test_replicated_lean_statistics_match_jax(replicated_catalogues, stat):
    ours, ref = replicated_catalogues
    assert ref.filter_dla_spectra().size >= 3
    for a, b in zip(STATS[stat](ours), STATS[stat](ref)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


def test_kernel_pair_layout_reduces_the_same(problem, port_lean, monkeypatch):
    """The driver on the kernel path's pair layout, run on the plain
    path: the fresh axis z-sorted, reduced with ``order``, the second-DLA
    pair indices translated back on the host.  At R = 1 the draws do not
    depend on the column order, so the result is the unsorted run's."""
    import gp_dla_detection_tpu_torch.parallel.sharded_multi as sharded_multi

    columns = sharded_multi.lean_base_columns
    monkeypatch.setattr(
        sharded_multi, "lean_base_columns",
        lambda offsets, seed, R, sorted_axis: columns(offsets, seed, R, True),
    )
    ours, ref = run_port(problem).cddf_inputs, port_lean.cddf_inputs
    np.testing.assert_allclose(ours.hist, ref.hist, rtol=1e-12, atol=1e-300)
    np.testing.assert_array_equal(ours.ex1_idx, ref.ex1_idx)
    np.testing.assert_allclose(ours.ex2_p, ref.ex2_p, rtol=1e-12, atol=1e-300)
    # ties at p2 = 0 order by column position, which the sort changes
    live = ref.ex2_p > 0
    assert live.sum() >= 10
    np.testing.assert_array_equal(ours.ex2_idx[live], ref.ex2_idx[live])
    np.testing.assert_array_equal(ours.ex2_base[live], ref.ex2_base[live])
    K = ref.spec.top_k
    np.testing.assert_array_equal(ours.ex[:, 5 * K :], ref.ex[:, 5 * K :])


def test_float32_reduction_against_jax(problem, port_lean32, jax_lean):
    """Float32 runs of both packages against JAX's float64 reduction.
    The port reduces in float64 from its float32 evidences, the JAX
    package at float32: both hists lie within 1e-3 of the float64 one
    per channel (max |a - b| over the channel's max), the rounding of the
    float32 evidences both share.  The mass channel differs: the port's
    matches its p_DLA to 1e-6, the JAX package's weights, normalized by a
    float32 evidence, to ~1e-5 (2.2e-6 on this problem), and the two
    packages' masses agree to 1e-3."""
    jax32 = run_jax(problem, dtype="float32")
    ref = jax_lean.cddf_inputs.hist
    for run in (port_lean32, jax32):
        h = run.cddf_inputs.hist.astype(np.float64)
        for ch in range(pci.N_CHANNELS):
            scale = max(np.abs(ref[:, ch]).max(), 1e-300)
            assert np.abs(h[:, ch] - ref[:, ch]).max() / scale < 1e-3, ch
    mass = {}
    for name, run in (("port", port_lean32), ("jax", jax32)):
        m = run.cddf_inputs.hist[:, pci.CH_P].astype(np.float64).sum((1, 2))
        keep = run.single.p_dlas > 0.05
        mass[name] = m[keep], np.abs(m[keep] / run.single.p_dlas[keep] - 1).max()
    assert mass["port"][1] < 1e-6
    assert mass["port"][1] < mass["jax"][1] < 1e-5
    np.testing.assert_allclose(mass["port"][0], mass["jax"][0], rtol=1e-3)
    # the exact entries: the same samples, away from knife edges (an
    # entry within 10 % of p_switch may fall on either side)
    p_switch = jax_lean.cddf_inputs.spec.p_switch
    exact = lambda r, i, cut: {
        int(k) for k, p in zip(r.ex1_idx[i], r.ex1_p[i]) if p >= cut * p_switch
    }
    a, b = port_lean32.cddf_inputs, jax32.cddf_inputs
    assert (b.ex1_p >= p_switch).sum() >= 3
    for i in range(len(a.ex1_p)):
        assert exact(a, i, 1.1) <= exact(b, i, 1.0) and exact(b, i, 1.1) <= exact(a, i, 1.0), i


def with_noise(problem, scale: float, seed: int = 11):
    """``problem`` with its noise raised ``scale`` times (flux and noise
    variance), which broadens the absorbers' posteriors."""
    params, model, spectra, *rest = problem
    rng = np.random.default_rng(seed)
    extra = rng.normal(size=spectra.flux.shape) * np.sqrt(spectra.noise_variance * (scale**2 - 1))
    spectra = dataclasses.replace(
        spectra, flux=spectra.flux + extra, noise_variance=spectra.noise_variance * scale**2
    )
    return (params, model, spectra, *rest)


@pytest.fixture(scope="module")
def broad_runs():
    """The float32 second-DLA question: the R = 4 case's problem (second
    DLAs in every fourth sightline, 320 samples) with the noise doubled,
    through both packages at R = 1 in float64 and float32."""
    problem = with_noise(injected_problem(second_dlas=True), 2.0)
    problem = (*problem[:3], *samples_320(), *problem[5:])
    return {
        "jax64": run_jax(problem), "jax32": run_jax(problem, dtype="float32"),
        "port64": run_port(problem), "port32": run_port(problem, dtype=torch.float32),
    }


def test_float32_second_dla_exact_entries_equal_jax(broad_runs):
    """The second DLA's exact CDDF entries ((pair sample, base sample) at
    p2 >= p_switch) and every top-k entry above p2 = 1e-3: the port's
    float32 run gives JAX's float32 entries entry for entry.  On this
    problem float32 moves no base draw, so both also give the float64
    entries; the misses float32 does make on broad posteriors at
    production shapes (2 of 7 on the card) are held by chip_smoke.py's
    phase 7, for the kernel and the float32 plain path alike."""
    spec = broad_runs["jax64"].cddf_inputs.spec
    for cut in (spec.p_switch, 1e-3):
        entries = {
            name: [
                {(int(a), int(b)) for a, b, p in zip(c.ex2_idx[i], c.ex2_base[i], c.ex2_p[i]) if p >= cut}
                for i in range(len(c.ex2_p))
            ]
            for name, c in ((n, r.cddf_inputs) for n, r in broad_runs.items())
        }
        assert entries["port32"] == entries["jax32"], cut
        assert entries["port32"] == entries["port64"] == entries["jax64"], cut
    exact = broad_runs["jax64"].cddf_inputs
    assert (exact.ex2_p >= spec.p_switch).sum() >= 3
    # broad first-DLA posteriors: in no DLA sightline does one sample
    # hold 0.9 of the first DLA (0.31-0.82 here)
    dla = broad_runs["jax64"].single.p_dlas > 0.5
    assert dla.sum() >= 4 and (exact.ex1_p[dla].max(axis=1) < 0.9).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mass_identity(problem, port_lean, port_lean32, dtype):
    """tests/test_lean_cddf.py::test_mass_accounting: the all-sample
    mass channel with its dump bin integrates to p_dla, in a float32 run
    too (the reduction normalizes the weights in float64)."""
    lean = port_lean if dtype == torch.float64 else port_lean32
    assert lean.cddf_inputs.hist.dtype == {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    mass = lean.cddf_inputs.hist[:, pci.CH_P].astype(np.float64).sum((1, 2))
    p_dla = lean.single.p_dlas
    keep = p_dla > 0.05
    assert keep.any()
    np.testing.assert_allclose(mass[keep], p_dla[keep], rtol=1e-6)


@pytest.fixture(scope="module")
def catalogues(problem, port_lean, jax_lean):
    offsets, lnhi = problem[3], np.log10(problem[4])
    ours = LeanDLACatalogue.from_results(port_lean, offsets, lnhi)
    ref = JaxLeanCatalogue.from_results(jax_lean, offsets, lnhi)
    assert ref.filter_dla_spectra().size >= 3
    return ours, ref


@pytest.mark.parametrize("stat", sorted(STATS))
def test_lean_statistics_match_jax(catalogues, stat):
    ours, ref = catalogues
    for a, b in zip(STATS[stat](ours), STATS[stat](ref)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


def test_bootstrap_matches_jax(catalogues):
    ours, ref = catalogues
    ours.resample(True, seed=4)
    ref.resample(True, seed=4)
    try:
        for a, b in zip(STATS["line_density"](ours), STATS["line_density"](ref)):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    finally:
        ours.resample(False)
        ref.resample(False)


def test_sorted_pair_axis_reduces_the_same(problem, port_lean):
    """The reducer with ``order`` (the kernel path's z-sorted pair axis)
    on permuted pair columns gives the unsorted result, with the pair
    indices in sorted numbering."""
    params, model, padded, offsets, nhis, *_ = port_inputs(problem)
    rng = np.random.default_rng(9)
    B, S = 3, len(offsets)
    order = np.argsort(offsets, kind="stable")
    args = dict(
        sll=torch.as_tensor(rng.normal(-50, 3, (B, S))),
        ev1=torch.as_tensor(rng.normal(-48, 1, B)),
        ll_null=torch.as_tensor(rng.normal(-49, 1, B)),
        min_z=torch.as_tensor(rng.uniform(2.0, 2.2, B)),
        max_z=torch.as_tensor(rng.uniform(2.8, 3.0, B)),
    )
    priors = [torch.as_tensor(np.log(rng.uniform(0.1, 0.5, B))) for _ in range(5)]
    ll2 = rng.normal(-49, 3, (B, S))
    ll2[:, ::7] = np.nan
    base = rng.integers(0, S, (B, S))
    ev2 = torch.as_tensor(rng.normal(-48, 1, B))
    spec = pci.CDDFReductionSpec()
    red, consts = pci.make_cddf_reducer(spec, offsets, np.log10(nhis))
    red_s, consts_s = pci.make_cddf_reducer(spec, offsets, np.log10(nhis), order=order)
    h, ex = red(consts, *args.values(), *priors, torch.as_tensor(ll2), ev2, torch.as_tensor(base))
    hs, exs = red_s(consts_s, *args.values(), *priors, torch.as_tensor(ll2[:, order]), ev2,
                    torch.as_tensor(base[:, order]))
    np.testing.assert_allclose(hs.numpy(), h.numpy(), rtol=1e-12, atol=1e-300)
    K = spec.top_k
    ex, exs = ex.numpy(), exs.numpy()
    np.testing.assert_array_equal(exs[:, :3 * K], ex[:, :3 * K])
    np.testing.assert_array_equal(exs[:, 4 * K:], ex[:, 4 * K:])
    p2 = ex[:, 2 * K : 3 * K]
    big = p2 > 0   # ties at zero order by column position, which differs
    np.testing.assert_array_equal(order[exs[:, 3 * K : 4 * K].astype(int)][big],
                                  ex[:, 3 * K : 4 * K][big])


def test_one_sample_posterior_has_no_negative_variance(problem):
    """A posterior concentrated on one sample with p_DLA = 1 makes that
    sample's p round to 1 + 1 ulp; its Bernoulli variance p (1 - p) is
    clamped at 0, so the direct Omega_DLA error bar stays finite."""
    offsets, nhis = problem[3], problem[4]
    B, S = 40, len(offsets)
    rng = np.random.default_rng(3)
    sll = np.full((B, S), -1e4)
    sll[np.arange(B), rng.integers(0, S, B)] = np.round(rng.uniform(10, 500, B), 3)
    sll = torch.as_tensor(sll)
    ev1 = sll.amax(dim=1) - np.log(S)    # pack_lean's evidence, to the ulp
    # the case in point: some rows' one weight rounds above 1
    assert (torch.exp(sll - ev1[:, None] - np.log(S)).amax(dim=1) > 1).any()
    one = torch.ones(B, dtype=torch.float64)
    red, consts = pci.make_cddf_reducer(pci.CDDFReductionSpec(), offsets, np.log10(nhis))
    hist, _ = red(
        consts, sll, ev1, ev1 - 1e3, 2.0 * one, 2.9 * one, *(torch.log(0.5 * one),) * 5,
        sll, ev1, torch.as_tensor(rng.integers(0, S, (B, S))),
    )
    assert (hist[:, pci.CH_P].sum((1, 2)) >= 1 - 1e-12).all()
    assert (hist[:, [pci.CH_P_VAR, pci.CH_P_VAR_NU2]] >= 0).all()


def test_resume_is_bit_identical(problem, port_lean, tmp_path):
    fresh = run_port(problem, checkpoint_dir=tmp_path)
    (tmp_path / "fused" / "batch_000001.npz").unlink()
    resumed = run_port(problem, checkpoint_dir=tmp_path)
    for r in (fresh, resumed):
        np.testing.assert_array_equal(r.cddf_inputs.hist, port_lean.cddf_inputs.hist)
        np.testing.assert_array_equal(r.cddf_inputs.ex, port_lean.cddf_inputs.ex)
    # a run without the reduction does not resume these checkpoints
    params, model, padded, offsets, nhis, prior_z, prior_num = port_inputs(problem)
    with pytest.warns(UserWarning, match="ignoring incompatible"):
        plain = process_spectra_multi_lean(
            model, offsets, nhis, padded, prior_z, prior_num, params=params, batch_size=4,
            sample_chunk=32, dtype=torch.float64, checkpoint_dir=tmp_path, device="cpu",
        )
    assert plain.cddf_inputs is None


def test_artifact_round_trip_and_catalogue_from_run(problem, port_lean, tmp_path):
    offsets, lnhi = problem[3], np.log10(problem[4])
    path = tmp_path / "processed_qsos_multi_dr12q.npz"
    port_lean.save(path)
    back = MultiDLAResults.load(path)
    np.testing.assert_array_equal(back.cddf_inputs.hist, port_lean.cddf_inputs.hist)
    np.testing.assert_array_equal(back.cddf_inputs.ex, port_lean.cddf_inputs.ex)
    assert back.single.sample_log_likelihoods_dla is None
    # the JAX package reads the port's artifact
    jback = JaxMultiDLAResults.load(path)
    np.testing.assert_array_equal(jback.cddf_inputs.ex, port_lean.cddf_inputs.ex)
    np.savez(tmp_path / "dla_samples.npz", offset_samples=offsets, log_nhi_samples=lnhi)
    cat = DLACatalogue.from_run(tmp_path, multi=True)
    assert isinstance(cat, LeanDLACatalogue)
    direct = LeanDLACatalogue.from_results(port_lean, offsets, lnhi)
    for a, b in zip(STATS["line_density"](cat), STATS["line_density"](direct)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not aligned"):
        cat.line_density(z_min=2.05, z_max=4.0)


def test_refusals(problem):
    params, model, padded, offsets, nhis, prior_z, prior_num = port_inputs(problem)
    classic = ShardedRunConfig(dtype="float64", store_cddf_inputs=True, device="cpu")
    with pytest.raises(ValueError, match="lean-mode feature"):
        process_spectra_multi_sharded(
            model, offsets, nhis, padded, prior_z, prior_num, params=params, config=classic
        )
    with pytest.raises(ValueError, match="lean-mode feature"):
        process_spectra_sharded(model, offsets, nhis, padded, prior_z, prior_num >= 1,
                                params=params, config=classic)
    lean = ShardedRunConfig(dtype="float64", store_sample_likelihoods=False,
                            store_cddf_inputs=True, device="cpu")
    with pytest.raises(NotImplementedError, match="fused"):
        process_spectra_sharded(model, offsets, nhis, padded, prior_z, prior_num >= 1,
                                params=params, config=lean)
