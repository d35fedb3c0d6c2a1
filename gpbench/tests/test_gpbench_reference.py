"""The plain reference against the program's float64 plain path at a
golden size: the same evidences, draws, MAP pairs and CDDF inputs."""

import numpy as np
import pytest
import torch

from gpbench import check, harness


@pytest.mark.parametrize("cell", ["multi_b1024", "single_b1024"])
def test_reference_matches_the_programs_float64_plain_path(cell):
    c = harness.sized_cell(harness.load_cell(cell), pool_size=5, samples=400,
                           driver={"per_device_batch": 2, "pipeline_depth": 1})
    r = harness.Run(c, 2147483777, 0.0, False, torch.device("cpu"), "torch", "float64")
    harness.make_inputs(r)
    from gpbench import program

    r.params = program.parameters(c.cfg)
    r.gp_model = program.gp_model(r.model, r.device, torch.float64)
    rows = np.arange(5)
    got = c.entry.call(r, rows, None)
    ref = check.reference_for(c.cfg, r.model, r.samples, "cpu", plain_program=True)
    priors = check.priors_of(c.cfg, r.catalogue, r.pool["z_qso"][rows])
    want = check.reference_outputs(ref, r.pool, rows, priors, c.entry.MULTI,
                                   log_nhis=r.samples[2], spec=check.cddf_spec(),
                                   full="sll" in got)
    for key in ("ll0", "ev1", "p_dla"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=1e-9)
    if "sll" in got:
        np.testing.assert_allclose(got["sll"], want["sll"], rtol=1e-9, atol=1e-8)
    else:
        np.testing.assert_array_equal(got["map1"], want["map1"])
    if c.entry.MULTI:
        np.testing.assert_allclose(got["ev2"], want["ev2"], rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(got["map2"], want["map2"])
        np.testing.assert_array_equal(got["map_base"], want["map_base"])
        np.testing.assert_allclose(got["post"], want["post"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got["hist"], want["hist"], rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(got["ex"], want["ex"], rtol=1e-9, atol=1e-14)
    nums = check.compare(ref, got, want, c.entry.MULTI, spec=check.cddf_spec())
    assert all(v < 1e-6 for v in nums.values()), nums


def test_the_redraw_follows_the_replicated_layout():
    from gpbench.reference.model import pair_columns

    off = np.random.default_rng(0).uniform(size=1000)
    order, cols, G = pair_columns(off, 4, 0, True)
    assert G == 4 * 64 - 3 * 64 + (1000 - 768) // 4 * 1 + 0 or G == int(cols.max()) + 1
    tiles = cols[:768].reshape(3, 4, 64)
    assert (tiles == tiles[:, :1]).all()      # lanes l and l + 64 share a draw
    np.testing.assert_array_equal(order, np.argsort(off, kind="stable"))


def _one_row(p, offsets, min_z=2.0):
    """A row whose first-DLA masses are ``p`` (p(DLA) = 1 to rounding)."""
    single = {"sll": torch.log(torch.as_tensor(p, dtype=torch.float64)), "ll_null": 0.0,
              "ev1": 0.0, "min_z": min_z, "max_z": min_z + 1.0}
    return single, {"lp_no": -100.0, "lp_dla": 0.0}


def test_a_mass_within_rounding_of_a_cut_or_an_edge_may_fall_either_side():
    from gpbench.reference import cddf as ref_cddf

    spec = check.cddf_spec()
    rng = np.random.default_rng(3)
    S = 200
    p = np.r_[0.2502, 0.2, 0.3, 0.01, np.full(S - 4, 0.2398 / (S - 4))]
    offsets = rng.uniform(0.3, 0.7, size=S)
    offsets[3] = 1.0 / 6.0 + 1e-9          # z = 2 + 1/6 + 1e-9: just over a bin edge
    log_nhis = rng.uniform(20.3, 22.0, size=S)
    single, priors = _one_row(p, offsets)
    hist, _ = ref_cddf.reduce_row(spec, offsets, log_nhis, single, None, priors)
    lo, hi = ref_cddf.first_dla_bounds(spec, offsets, log_nhis, single, priors,
                                       check.CUT_REL, check.Z_EDGE)
    plain = ref_cddf.first_dla_bounds(spec, offsets, log_nhis, single, priors, 0.0, 0.0)
    for b in plain:
        np.testing.assert_array_equal(b, hist[:6])      # no tolerance: the plain histogram
    lh = spec.lnhi_bin(log_nhis, "a")
    zloc = np.floor((2.0 + offsets) * spec.z_bins_per_unit).astype(int) - 12
    gap = lambda g: float(check.hist_gap(g[None], lo[None, 0], hi[None, 0], hist[None, 0])[0])

    flipped = hist[0].copy()                # 0.2502 read as 0.2499: under p_switch
    flipped[zloc[0], lh[0]] += 0.2499
    moved = hist[0].copy()                  # the sample over the edge in the bin below
    moved[zloc[3], lh[3]] -= p[3]
    moved[zloc[3] - 1, lh[3]] += p[3]
    dropped = hist[0].copy()                # 0.2 left out: no rounding does that
    dropped[zloc[1], lh[1]] -= 0.2
    assert gap(hist[0]) == 0.0 and gap(flipped) == 0.0 and gap(moved) == 0.0
    assert gap(dropped) == pytest.approx(0.2 / hist[0].sum(), rel=1e-9)
    exact = lambda g: float(check.hist_gap(g[None], hist[None, 0], hist[None, 0], hist[None, 0])[0])
    assert exact(flipped) > 0.5 and exact(moved) > 0.02
