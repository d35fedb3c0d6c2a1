"""Device-reduced CDDF inputs for lean (catalog-only) runs, in PyTorch.

Counterpart of ``gp_dla_detection_tpu/cddf_inputs.py``.  The column
density distribution f(N), the line density dN/dX and Omega_DLA
(CDDF_analysis/calc_cddf.py:440-464, 490-507, 521-560) marginalize each
spectrum's normalized sample probabilities.  The fused lean chain never
holds the (N, S) matrices on the host, so it reduces on the device,
per batch, everything those statistics consume:

  - binned small-probability masses on fixed (z, log N_HI) grids whose
    cells the default statistics' bins are unions of;
  - exact entries (sample indices) for every sample with p >= p_switch,
    rebound to float64 (z, log N_HI) on the host;
  - moment histograms sum(p), sum(p N_HI), sum(p (1-p)),
    sum(p (1-p) N_HI^2) for the direct Omega_DLA estimator.

The host side (the channel layout, :class:`CDDFReductionSpec` and
:class:`CDDFInputs`) is a copy of the JAX package's, held equal to it by
the tests; the quantization contract is the JAX module's docstring.
The device side, :func:`make_cddf_reducer`, runs in float64 (inputs of
a float32 run upcast, results returned at the run dtype): a stable
descending sort where the JAX package runs ``lax.top_k``, so that ties
(every row with fewer than top_k non-zero p) keep the lower index first,
as ``lax.top_k`` orders them, and its two sums, the second-DLA masses
gathered onto their base samples and every channel's masses binned on
the (z, log N_HI) grids, in :func:`cddf_sums`:

- :func:`cddf_sums` is the wrapper.  On CUDA tensors it launches
  ``csrc/cddf.cu``, which adds in a fixed order, so that a row's sums
  depend on that row alone in every run, or raises; on CPU tensors it
  runs the plain version.  It never falls back on the card.
- :func:`cddf_sums_reference` is the plain version: two ``scatter_add_``
  over the base samples and over the flat index ``zloc * (n_lnhi + 1) +
  lnhi_bin``, where the JAX package runs one masked matmul per z bin.
  On the card their atomics add in an order that changes from run to run.
- :func:`cddf_chunk_plan` is the kernel's split of a row into chunks
  (a function of S and, for the runs of equal bases, of the row's bases
  alone), and :func:`cddf_sums_chunked` the plain version in the
  kernel's order of additions, for the tests.
- ``launch_count`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math

import numpy as np
import torch

__all__ = [
    "CDDFReductionSpec",
    "CDDFInputs",
    "CDDFChunkPlan",
    "cddf_chunk_plan",
    "cddf_sums",
    "cddf_sums_chunked",
    "cddf_sums_reference",
    "launch_count",
    "make_cddf_reducer",
]

# channel layout of the (B, 8, n_z_window, n_lnhi+1) histogram tensor;
# the final lnhi column is the dump bin (samples outside the grid's
# open interval — the classic range cuts exclude them, but they must
# still be accounted for so sum(P_CHANNEL) == p_dla holds per spectrum)
CH_SMALL_A = 0      # sum p,         1e-4 < p < 0.25, grid A
CH_P = 1            # sum p,         all samples,     grid A
CH_P_NU = 2         # sum p*nu,      all samples,     grid A
CH_P_VAR = 3        # sum p*(1-p),   all samples,     grid A
CH_P_VAR_NU2 = 4    # sum p*(1-p)*nu^2, all,          grid A
CH_SMALL_B = 5      # sum p,         small,           grid B
CH_SMALL2_A = 6     # sum p2,        small, 2nd DLA,  grid A (by base z/N)
CH_SMALL2_B = 7     # sum p2,        small, 2nd DLA,  grid B
N_CHANNELS = 8

launch_count = 0   # cddf_sums kernel launches

# The kernel's split of a row: at most CHUNKS_MAX chunks (the blocks of one
# thread block cluster, the portable size), each of at least CHUNK_MIN
# samples.  Fixed by S alone, so that a row's sums never depend on the
# batch, the card or the stream.
CHUNKS_MAX = 8
CHUNK_MIN = 256


@dataclasses.dataclass(frozen=True)
class CDDFReductionSpec:
    """Static geometry of the device reduction.

    The two log-N_HI grids cover every binning the reference's
    statistics use by default: grid A (width 0.1 from 20.0) nests the
    CDDF's 30 bins over [20, 23] (calc_cddf.py:440-464) and the 20.3
    line-density cut; grid B (width 0.09 from 20.3) nests
    Omega_DLA(CDDF)'s 30 bins over [20.3, 23] and the 15-bin bootstrap
    variant (width 0.18).  The redshift grid at 1/6 per bin nests every
    ``bins_per_z = 6`` statistic with integer z endpoints
    (calc_cddf.py:49).
    """

    z_bins_per_unit: int = 6
    # per-spectrum z window, in fine z bins: must cover the widest DLA
    # search range (max_z - min_z <= ~1.2 for any z_QSO <= 7 given the
    # Lyb..Lya forest bounds, = ~8 bins); violations are counted on
    # device and raised loudly on the host
    n_z_window: int = 12
    lnhi_a_start: float = 20.0
    lnhi_a_width: float = 0.1
    lnhi_b_start: float = 20.3
    lnhi_b_width: float = 0.09
    n_lnhi: int = 30
    top_k: int = 8
    # thresholds mirror calc_cddf.py:42-56 (DLACatalogue)
    p_sample_min: float = 1e-4
    p_switch: float = 0.25
    # N_HI moment weights are stored as nu = 10^(lnhi - nu_log_offset)
    # so nu^2 sums stay in f32 range; the host multiplies the offset back
    nu_log_offset: float = 20.0

    def token(self) -> str:
        """Fingerprint component: any field change invalidates stored
        reductions."""
        return "cddf_inputs:v1:" + json.dumps(
            dataclasses.asdict(self), sort_keys=True
        )

    # ---- host-side grid helpers (shared with LeanDLACatalogue) ----

    def lnhi_bin_index(self, lnhi, grid: str) -> np.ndarray:
        """float64 bin index on grid 'a'|'b'; n_lnhi = the dump bin.

        Outer bounds are STRICT (samples at exactly the grid start/end
        are dumped), matching the classic open-interval range cuts."""
        start, width = (
            (self.lnhi_a_start, self.lnhi_a_width)
            if grid == "a"
            else (self.lnhi_b_start, self.lnhi_b_width)
        )
        lnhi = np.asarray(lnhi, np.float64)
        idx = np.floor((lnhi - start) / width).astype(np.int64)
        end = start + width * self.n_lnhi
        out = np.where(
            (lnhi > start) & (lnhi < end),
            np.clip(idx, 0, self.n_lnhi - 1),
            self.n_lnhi,
        )
        return out

    def match_lnhi_bins(self, q_bins) -> tuple[str, int] | None:
        """If ``q_bins`` is a contiguous run of one grid's edges,
        return (grid, first bin index); else None."""
        q = np.asarray(q_bins, np.float64)
        for grid, start, width in (
            ("a", self.lnhi_a_start, self.lnhi_a_width),
            ("b", self.lnhi_b_start, self.lnhi_b_width),
        ):
            j = (q - start) / width
            jr = np.round(j)
            if (
                np.all(np.abs(j - jr) < 1e-6)
                and np.all(np.diff(jr) >= 1)
                and jr[0] >= 0
                and jr[-1] <= self.n_lnhi
            ):
                return grid, jr.astype(np.int64)
        return None

    def match_z_edge(self, z: float) -> int:
        """Global fine z-bin index of an aligned z edge, or raise."""
        j = float(z) * self.z_bins_per_unit
        jr = round(j)
        if abs(j - jr) > 1e-6:
            raise ValueError(
                f"z edge {z} is not aligned with the lean reduction's "
                f"1/{self.z_bins_per_unit} redshift grid — lean-reduced "
                "CDDF inputs only support statistics whose bins are "
                "unions of the reduction grid cells (all defaults are); "
                "rerun with store_sample_likelihoods=True for arbitrary "
                "bins"
            )
        return int(jr)


# per-spectrum scalar row layout of CDDFInputs.ex beyond the 5 top-k
# blocks [ex1_p, ex1_idx, ex2_p, ex2_pair_idx, ex2_base_idx]
EX_W0 = 0          # window start (global fine z bin)
EX_NBIG1 = 1       # count of first-DLA p >= p_switch (must be <= top_k)
EX_NBIG2 = 2       # count of second-DLA p2 >= p_switch
EX_ZOVER = 3       # mass-carrying samples outside the z window (must be 0)
N_EX_SCALARS = 4


@dataclasses.dataclass
class CDDFInputs:
    """Host-side container for the fetched reductions.

    hist: (N, 8, n_z_window, n_lnhi+1) float32/float64 (run dtype).
    ex:   (N, 5*top_k + 4): [ex1_p | ex1_idx | ex2_p | ex2_pair_idx |
          ex2_base_idx | w0, nbig1, nbig2, zover].  Indices are exact
          (< 2**24 guard in the lean driver); pair indices are in
          ORIGINAL sample numbering (the driver translates sorted pair
          columns before storing).  second=False runs store -1/0 blocks.
    """

    spec: CDDFReductionSpec
    hist: np.ndarray
    ex: np.ndarray
    second: bool = True

    # ---- field accessors ----
    def _blk(self, i):
        k = self.spec.top_k
        return self.ex[:, i * k : (i + 1) * k]

    @property
    def ex1_p(self):
        return self._blk(0)

    @property
    def ex1_idx(self):
        return self._blk(1).astype(np.int64)

    @property
    def ex2_p(self):
        return self._blk(2)

    @property
    def ex2_idx(self):
        return self._blk(3).astype(np.int64)

    @property
    def ex2_base(self):
        return self._blk(4).astype(np.int64)

    def scalar(self, which: int):
        return self.ex[:, 5 * self.spec.top_k + which]

    def validate(self) -> None:
        """Loud integrity checks on the device counters."""
        zover = self.scalar(EX_ZOVER)
        if np.any(zover > 0):
            bad = int(np.flatnonzero(zover > 0)[0])
            raise ValueError(
                f"{int((zover > 0).sum())} spectra (first: row {bad}) "
                "have posterior mass outside the lean reduction's "
                f"{self.spec.n_z_window}-bin redshift window — increase "
                "CDDFReductionSpec.n_z_window (the DLA search range is "
                "wider than the spec assumed)"
            )
        for name, n in (("first", EX_NBIG1), ("second", EX_NBIG2)):
            nbig = self.scalar(n)
            if np.any(nbig > self.spec.top_k):
                raise ValueError(
                    f"a spectrum has {int(nbig.max())} {name}-DLA samples "
                    f"above p_switch but the reduction stored only "
                    f"top_k={self.spec.top_k} exact entries — increase "
                    "CDDFReductionSpec.top_k (normalized probabilities "
                    "bound this by 1/p_switch = 4, so this indicates "
                    "corrupt inputs)"
                )

    # ---- persistence (flat npz-compatible dict, "cddf_" prefix) ----
    def to_npz_dict(self, prefix: str = "cddf_") -> dict:
        return {
            prefix + "hist": self.hist,
            prefix + "ex": self.ex,
            prefix + "spec": np.frombuffer(
                json.dumps(dataclasses.asdict(self.spec)).encode(), np.uint8
            ),
            prefix + "second": np.asarray(self.second),
        }

    @classmethod
    def from_npz_dict(cls, d, prefix: str = "cddf_") -> "CDDFInputs":
        spec = CDDFReductionSpec(
            **json.loads(bytes(np.asarray(d[prefix + "spec"])).decode())
        )
        return cls(
            spec=spec,
            hist=np.asarray(d[prefix + "hist"]),
            ex=np.asarray(d[prefix + "ex"]),
            second=bool(np.asarray(d[prefix + "second"])),
        )

    @classmethod
    def npz_present(cls, files, prefix: str = "cddf_") -> bool:
        return prefix + "hist" in files


def _top_k(x, k: int):
    """The k largest entries of each row and their indices, largest
    first; among equal values the lower index comes first (the order
    ``lax.top_k`` gives)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def cddf_sums_reference(
    p, p2s, base, zloc, base_order, lh_a, lh_b, nu, nu2,
    p_sample_min: float, p_switch: float, n_z_window: int, n_lnhi: int,
):
    """The plain version of :func:`cddf_sums` (``base_order`` unused)."""
    B, S = p.shape
    W, nl = n_z_window, n_lnhi
    zero = torch.zeros((), dtype=torch.float64, device=p.device)
    small1 = (p > p_sample_min) & (p < p_switch)
    ps = torch.where(small1, p, zero)
    # a posterior on one sample gives p = 1 + 1 ulp, and a negative
    # variance there a NaN Omega_DLA error bar: the Bernoulli variance
    # is clamped at 0 (the JAX package's is not)
    pvar = p * torch.clamp(1.0 - p, min=0.0)
    acc = torch.zeros((B, S), dtype=torch.float64, device=p.device)
    acc.scatter_add_(1, base, p2s)
    # every channel's masses in one scatter over the flat (z, lnhi)
    # index; samples outside the window go to a slot that is dropped
    vals = torch.stack([ps, p, p * nu, pvar, pvar * nu2, ps, acc, acc], dim=1)  # (B, 8, S)
    ch = torch.arange(N_CHANNELS, device=p.device)
    grid_b = (ch == CH_SMALL_B) | (ch == CH_SMALL2_B)   # the grids each channel bins on
    lh = torch.where(grid_b[:, None], lh_b[None, :], lh_a[None, :])  # (8, S)
    flat = zloc[:, None, :] * (nl + 1) + lh[None, :, :]
    dump = W * (nl + 1)
    in_win = (zloc >= 0) & (zloc < W)
    flat = torch.where(in_win[:, None, :], flat, torch.full_like(flat, dump))
    hist = torch.zeros((B, N_CHANNELS, dump + 1), dtype=torch.float64, device=p.device)
    hist.scatter_add_(2, flat, vals)
    return acc, hist


@dataclasses.dataclass(frozen=True)
class CDDFChunkPlan:
    """How the CDDF sums kernel splits a row of S samples.

    ``n_chunks`` chunks of ``chunk_len`` samples (the last may be
    shorter); ``sample_bounds`` (n_chunks + 1,) their edges on the sample
    axis, where chunk c bins samples [sample_bounds[c],
    sample_bounds[c + 1]).  ``run_bounds`` (B, n_chunks + 1), given the
    bases: chunk c sums acc's runs of equal bases that start at the
    ``base_order`` positions [run_bounds[b, c], run_bounds[b, c + 1]),
    each edge moved from c * chunk_len to the next run start, so that no
    run straddles two chunks (None without the bases)."""

    n_chunks: int
    chunk_len: int
    sample_bounds: np.ndarray
    run_bounds: np.ndarray | None = None


def cddf_chunk_plan(S: int, base=None, base_order=None) -> CDDFChunkPlan:
    """The CDDF sums kernel's chunks for rows of ``S`` samples: chunk_len
    = max(CHUNK_MIN, ceil(S / CHUNKS_MAX)), n_chunks = ceil(S /
    chunk_len).  With ``base`` (B, S) and ``base_order`` (S,), also each
    row's run edges along ``base_order`` (:class:`CDDFChunkPlan`); a row's
    edges depend on that row's bases alone."""
    if S < 1:
        raise ValueError(f"S must be >= 1, got {S}")
    chunk_len = max(CHUNK_MIN, -(-S // CHUNKS_MAX))
    n_chunks = -(-S // chunk_len)
    sample_bounds = np.minimum(np.arange(n_chunks + 1, dtype=np.int64) * chunk_len, S)
    run_bounds = None
    if base is not None:
        keys = np.asarray(torch.as_tensor(base).cpu())[:, np.asarray(torch.as_tensor(base_order).cpu())]
        run_bounds = np.full((keys.shape[0], n_chunks + 1), S, np.int64)
        for b, row in enumerate(keys):
            first = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])   # the row's run starts
            at = np.searchsorted(first, sample_bounds[:-1])
            run_bounds[b, :-1] = np.where(at < len(first), first[np.minimum(at, len(first) - 1)], S)
    return CDDFChunkPlan(n_chunks, chunk_len, sample_bounds, run_bounds)


def cddf_sums_chunked(
    p, p2s, base, zloc, base_order, lh_a, lh_b, nu, nu2,
    p_sample_min: float, p_switch: float, n_z_window: int, n_lnhi: int,
):
    """:func:`cddf_sums_reference` in the kernel's order of additions, on
    the CPU (where ``scatter_add_`` adds each slot's values in index
    order): acc's columns along ``base_order``; each chunk's samples of a
    bin in ascending order from 0, the chunks' partials added in chunk
    order."""
    plan = cddf_chunk_plan(p.shape[1])
    acc = torch.zeros_like(p)
    acc.scatter_add_(1, base[:, base_order], p2s[:, base_order])
    W, nl = n_z_window, n_lnhi
    zero = torch.zeros((), dtype=torch.float64, device=p.device)
    ps = torch.where((p > p_sample_min) & (p < p_switch), p, zero)
    pvar = p * torch.clamp(1.0 - p, min=0.0)
    vals = torch.stack([ps, p, p * nu, pvar, pvar * nu2, ps, acc, acc], dim=1)
    ch = torch.arange(N_CHANNELS, device=p.device)
    grid_b = (ch == CH_SMALL_B) | (ch == CH_SMALL2_B)
    lh = torch.where(grid_b[:, None], lh_b[None, :], lh_a[None, :])
    dump = W * (nl + 1)
    in_win = (zloc >= 0) & (zloc < W)
    flat = torch.where(in_win[:, None, :], zloc[:, None, :] * (nl + 1) + lh[None, :, :],
                       torch.full_like(zloc[:, None, :], dump))
    hist = None
    for lo, hi in zip(plan.sample_bounds[:-1], plan.sample_bounds[1:]):
        part = torch.zeros((p.shape[0], N_CHANNELS, dump + 1), dtype=torch.float64,
                           device=p.device)
        part.scatter_add_(2, flat[:, :, lo:hi], vals[:, :, lo:hi])
        hist = part if hist is None else hist + part
    return acc, hist


def cddf_sums(
    p, p2s, base, zloc, base_order, lh_a, lh_b, nu, nu2,
    p_sample_min: float, p_switch: float, n_z_window: int, n_lnhi: int,
):
    """The reduction's two float64 sums for one batch.

    Args (float64 unless said): p (B, S) the first-DLA sample
      probabilities; p2s (B, S) the small second-DLA probabilities of the
      pair columns; base (B, S) int64 each pair column's base sample;
      zloc (B, S) int64 each sample's z row in the window (outside
      [0, n_z_window): the dump slot); base_order (S,) int64 the pair
      columns by ascending (grid position, column); lh_a, lh_b (S,) int64
      each sample's log N_HI bin on grid A and B (n_lnhi: the row's dump
      bin); nu, nu2 (S,).

    Returns ``(acc, hist)``: acc (B, S), the p2s of the pair columns on
    each base sample; hist (B, 8, n_z_window (n_lnhi + 1) + 1), the CH_*
    channels' masses binned, the last slot the dump.

    CUDA tensors: ``csrc/cddf.cu``.  It adds each acc entry's columns in
    ``base_order`` (in one run each when ``base`` ascends along it, as the
    redraw's bases do), and each bin's samples in ascending order within
    each of :func:`cddf_chunk_plan`'s chunks, the chunks' partials in
    chunk order (:func:`cddf_sums_chunked`), so the result does not
    depend on the batch or the run; anything it cannot
    take (another dtype, shape or device, a grid whose bins exceed shared
    memory) raises, as does a failed build or launch, and a base outside
    [0, S) stops the kernel, as an index outside a tensor does in PyTorch.
    CPU tensors: :func:`cddf_sums_reference`.
    """
    args = (p, p2s, base, zloc, base_order, lh_a, lh_b, nu, nu2,
            p_sample_min, p_switch, n_z_window, n_lnhi)
    if not p.is_cuda:
        return cddf_sums_reference(*args)
    B, S = p.shape
    W, nl = n_z_window, n_lnhi
    shapes = ((p, (B, S), torch.float64), (p2s, (B, S), torch.float64),
              (base, (B, S), torch.int64), (zloc, (B, S), torch.int64),
              (base_order, (S,), torch.int64), (lh_a, (S,), torch.int64),
              (lh_b, (S,), torch.int64), (nu, (S,), torch.float64), (nu2, (S,), torch.float64))
    for t, shape, dtype in shapes:
        if t.device != p.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"the CUDA CDDF sums take {shape} {dtype} tensors on {p.device}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    plan = cddf_chunk_plan(max(S, 1))
    if not 1 <= S < 1 << 31 or B * plan.n_chunks > (1 << 31) - 1:
        raise ValueError(f"(B, S) = {(B, S)} outside the kernel's grid")
    built = _sums_library()
    if plan.n_chunks > built.lib.gpdla_cddf_max_chunks():
        raise ValueError(f"{plan.n_chunks} chunks a row, beyond the kernel's cluster")
    with torch.cuda.device(p.device):
        need = built.lib.gpdla_cddf_shared_bytes(W, nl)
        room = built.lib.gpdla_cddf_max_shared_bytes()
    if need > room:
        raise ValueError(
            f"the CUDA CDDF sums hold a chunk's partial {N_CHANNELS} x {W * (nl + 1) + 1} bins "
            f"and a tile's sort in shared memory: {need} bytes, beyond the {room} a block may take"
        )
    acc = torch.empty((B, S), dtype=torch.float64, device=p.device)
    hist = torch.empty((B, N_CHANNELS, W * (nl + 1) + 1), dtype=torch.float64, device=p.device)
    if B:
        tensors = [t.contiguous() for t, _, _ in shapes]
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            err = built.lib.gpdla_cddf_sums_f64(
                *[t.data_ptr() for t in tensors], acc.data_ptr(), hist.data_ptr(), B, S, W, nl,
                plan.n_chunks, plan.chunk_len, float(p_sample_min), float(p_switch), stream,
            )
        if err != 0:
            msg = built.lib.gpdla_cddf_error_string(err).decode()
            raise RuntimeError(f"CDDF sums kernel launch failed: {msg} (cudaError {err})")
        global launch_count
        launch_count += 1
    return acc, hist


@functools.lru_cache(maxsize=None)
def _sums_library():
    from . import _build

    built = _build.load_library("cddf")
    built.lib.gpdla_cddf_sums_f64.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
    )
    built.lib.gpdla_cddf_sums_f64.restype = ctypes.c_int
    built.lib.gpdla_cddf_shared_bytes.argtypes = [ctypes.c_int] * 2
    built.lib.gpdla_cddf_shared_bytes.restype = ctypes.c_size_t
    for name in ("max_shared_bytes", "max_chunks"):
        getattr(built.lib, f"gpdla_cddf_{name}").argtypes = []
        getattr(built.lib, f"gpdla_cddf_{name}").restype = ctypes.c_int
    built.lib.gpdla_cddf_error_string.argtypes = [ctypes.c_int]
    built.lib.gpdla_cddf_error_string.restype = ctypes.c_char_p
    return built


def make_cddf_reducer(
    spec: CDDFReductionSpec,
    offset_samples,
    log_nhi_samples,
    order=None,
    device=None,
    base_order=None,
    kernels: bool = False,
):
    """Build the device reduction of one batch of the lean chain.

    Args:
      offset_samples, log_nhi_samples: the (S,) QMC prior tables
        (ORIGINAL sample order).
      order: z-sort permutation of the pair stage's fresh axis (the
        ``"cuda"`` backend), or None when pair columns ride original
        order.
      device: where the constant tables live.
      base_order: the pair columns by ascending (grid position, column)
        of the redraw that gives ``base_cols`` (None: column order), the
        order in which the kernel adds a base sample's pair columns.
      kernels: the sums through :func:`cddf_sums` (the kernel on the
        card, the ``"cuda"`` backend), else :func:`cddf_sums_reference`.

    Returns ``(reduce_fn, consts)``; ``reduce_fn(consts, sll, ev1,
    ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m, ll2_pair,
    ev2, base_cols) -> (hist, ex)``, all (B, ...) tensors on one device,
    returned at the dtype of ``sll`` (the run dtype).  The reduction
    itself runs in float64 whatever the run dtype, one pass over (B, S)
    next to the kernels' (B, S, P): the float32 run's weights then sum to
    1 (its evidence, at ~1e3, is off by ~1e-4 in float32), its masses
    depend little on the order the card's atomics add in, and its redshift
    bins are the float64 host's.  A float64 run computes exactly what the
    JAX package's float64 run does.  With ``kernels`` on the card, its
    sums add in a fixed order: the reduction of a row does not depend on
    the batch or the run.
    """
    offsets = np.asarray(offset_samples, np.float64)
    lnhis = np.asarray(log_nhi_samples, np.float64)
    S = len(offsets)
    nl = spec.n_lnhi
    W = spec.n_z_window
    K = spec.top_k
    put = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), device=device).to(dt)

    nu = 10.0 ** (lnhis - spec.nu_log_offset)
    consts = {
        "off": put(offsets),
        "lh_a": put(spec.lnhi_bin_index(lnhis, "a"), torch.int64),
        "lh_b": put(spec.lnhi_bin_index(lnhis, "b"), torch.int64),
        "nu": put(nu),
        "nu2": put(nu**2),
        "order": None if order is None else put(order, torch.int64),
        "base_order": put(np.arange(S) if base_order is None else base_order, torch.int64),
    }
    sums = cddf_sums if kernels else cddf_sums_reference

    def reduce_fn(
        c, sll, ev1, ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m,
        ll2_pair, ev2, base_cols,
    ):
        dt = sll.dtype
        B = sll.shape[0]
        (sll, ev1, ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m, ll2_pair, ev2) = (
            x.to(torch.float64)
            for x in (sll, ev1, ll_null, min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m,
                      ll2_pair, ev2)
        )
        f64 = torch.float64
        zero = torch.zeros((), dtype=f64, device=sll.device)
        neg_inf = torch.full((), -math.inf, dtype=f64, device=sll.device)
        nan_to_0 = lambda x: torch.where(torch.isnan(x), zero, x)

        # p_dla mirrors inference.posteriors_from_evidence exactly
        # (including the 1 - p0 form), from the evidence the host keeps
        a = lp_no + ll_null
        b = lp_dla + ev1
        m2 = torch.maximum(a, b)
        e0, e1 = torch.exp(a - m2), torch.exp(b - m2)
        p_dla = nan_to_0(1.0 - e0 / (e0 + e1))

        # the weights' normalizer, pack_lean's evidence recomputed from the
        # samples in float64: a float32 evidence of magnitude ~1e3 is off
        # by ~1e-4, and so would be the sum of the float32 run's weights
        # (in a float64 run this is ev1, bit for bit)
        row_max = torch.amax(sll, dim=1)
        norm = row_max + torch.log(torch.mean(torch.exp(sll - row_max[:, None]), dim=1))
        logw = sll - norm[:, None] - torch.log(torch.full((), S, dtype=f64, device=sll.device))
        p = nan_to_0(torch.exp(logw) * p_dla[:, None])

        bpz = torch.full((), spec.z_bins_per_unit, dtype=f64, device=sll.device)
        zf = min_z[:, None] + (max_z - min_z)[:, None] * c["off"][None, :]
        w0 = torch.floor(min_z * bpz)
        w0 = torch.where(torch.isfinite(w0), w0, zero).to(torch.int64)
        zloc_f = torch.floor(zf * bpz)
        zloc = (
            torch.where(torch.isfinite(zloc_f), zloc_f, -torch.ones_like(zloc_f)).to(torch.int64)
            - w0[:, None]
        )
        in_win = (zloc >= 0) & (zloc < W)

        z_over = ((~in_win) & (p > 0)).sum(dim=1)

        ex1_p, ex1_i = _top_k(p, K)
        nbig1 = (p >= spec.p_switch).sum(dim=1)

        # p(2 DLAs) mirrors multi_dla._multi_posteriors
        posts = torch.stack([lp0m + ll_null, lp1m + ev1, lp2m + ev2], dim=1)
        pmax = torch.amax(posts, dim=1, keepdim=True)
        e = torch.exp(posts - pmax)
        p_dla2 = nan_to_0(e[:, 2] / e.sum(dim=1))

        lw_pair = logw if c["order"] is None else logw[:, c["order"]]
        comb = ll2_pair + lw_pair
        comb = torch.where(torch.isfinite(comb), comb, neg_inf)
        cmax = torch.amax(comb, dim=1)
        safe = torch.where(torch.isfinite(cmax), cmax, zero)
        lse = safe + torch.log(torch.exp(comb - safe[:, None]).sum(dim=1))
        p2 = nan_to_0(torch.exp(comb - lse[:, None]) * p_dla2[:, None])

        small2 = (p2 > spec.p_sample_min) & (p2 < spec.p_switch)
        p2s = torch.where(small2, p2, zero)
        # bin by the SECOND component's (z, lnhi) = the base draw's:
        # group pair columns by base sample first, then the base
        # sample's zloc/lnhi bins are the first stage's own tables
        base = base_cols.to(torch.int64)

        ex2_p, ex2_i = _top_k(p2, K)
        ex2_b = torch.gather(base, 1, ex2_i)
        nbig2 = (p2 >= spec.p_switch).sum(dim=1)

        _, hist = sums(
            p, p2s, base, zloc, c["base_order"], c["lh_a"], c["lh_b"], c["nu"], c["nu2"],
            spec.p_sample_min, spec.p_switch, W, nl,
        )
        hist = hist[:, :, : W * (nl + 1)].reshape(B, N_CHANNELS, W, nl + 1).to(dt)

        col = lambda x: x.to(f64)[:, None]
        ex = torch.cat(
            [
                ex1_p, ex1_i.to(f64), ex2_p, ex2_i.to(f64), ex2_b.to(f64),
                col(w0), col(nbig1), col(nbig2), col(z_over),
            ],
            dim=1,
        )
        return hist, ex.to(dt)

    return reduce_fn, consts
