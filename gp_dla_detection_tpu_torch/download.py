"""Data acquisition (L1: data/scripts/download_catalogs.sh,
download_spectra.sh).

Pythonic replacement for the reference's bash+wget+gawk scripts: URL
manifests for the three SDSS quasar catalogs and the raw DLA catalogs,
the column-extraction rules that turn each raw catalog into the
processed ``(thing_id, z_dla, log_nhi)`` / line-of-sight text files
(download_catalogs.sh:41-80), and the rsync invocation for the ~35 GB
of DR12Q spectra (download_spectra.sh:6-8).

Every step separates *planning* (pure: returns commands/URLs, testable
offline) from *execution* (subprocess), so air-gapped environments can
still exercise the extraction logic on local files.

A copy of ``gp_dla_detection_tpu/download.py`` (standard library only).
"""

from __future__ import annotations

import subprocess
import tarfile
from dataclasses import dataclass
from pathlib import Path


from .params import Parameters

__all__ = [
    "CATALOG_URLS",
    "SPECTRA_RSYNC_ROOT",
    "download_plan",
    "download_catalogs",
    "extract_dla_catalog",
    "extract_all_dla_catalogs",
    "download_spectra_command",
    "download_spectra",
]

CATALOG_URLS = {
    # release -> (filename, URL) (download_catalogs.sh:9-34)
    "dr9q": (
        "DR9Q.fits",
        "http://data.sdss3.org/sas/dr9/env/BOSS_QSO/DR9Q/DR9Q.fits",
    ),
    "dr10q": (
        "DR10Q_v2.fits",
        "http://data.sdss3.org/sas/dr10/boss/qso/DR10Q/DR10Q_v2.fits",
    ),
    "dr12q": (
        "DR12Q.fits",
        "http://data.sdss3.org/sas/dr12/boss/qso/DR12Q/DR12Q.fits",
    ),
}

DLA_CATALOG_SOURCES = {
    # name -> (filename, URL) (download_catalogs.sh:41-67)
    "dr9q_concordance": (
        "BOSSLyaDR9_cat.txt",
        "http://data.sdss3.org/sas/dr9/boss/lya/cat/BOSSLyaDR9_cat.txt",
    ),
    "dr12q_noterdaeme": (
        "DLA_DR12_v2.tgz",
        "http://www2.iap.fr/users/noterdae/DLA/DLA_DR12_v2.tgz",
    ),
    "dr12q_visual": (
        "DLA_DR12_v2.tgz",
        "http://www2.iap.fr/users/noterdae/DLA/DLA_DR12_v2.tgz",
    ),
}

SPECTRA_RSYNC_ROOT = "rsync://data.sdss.org/dr12/boss/spectro/redux/"


@dataclass
class FetchItem:
    url: str
    destination: Path


def download_plan(params: Parameters | None = None) -> list[FetchItem]:
    """All catalog files to fetch and where they land."""
    if params is None:
        params = Parameters()
    items = []
    for release, (filename, url) in CATALOG_URLS.items():
        items.append(
            FetchItem(url, params.distfiles_directory(release) / filename)
        )
    seen = set()
    for name, (filename, url) in DLA_CATALOG_SOURCES.items():
        dest = (
            params.dla_catalog_directory(name).parent / "distfiles" / filename
        )
        if url not in seen:
            items.append(FetchItem(url, dest))
            seen.add(url)
    return items


def download_catalogs(params: Parameters | None = None, fetcher=None) -> None:
    """Fetch all catalog files (wget equivalent) and run the extractions.

    ``fetcher(url, destination)`` defaults to wget via subprocess;
    injectable for testing/air-gapped use.
    """
    if params is None:
        params = Parameters()
    if fetcher is None:

        def fetcher(url: str, destination: Path):
            destination.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["wget", "-q", url, "-O", str(destination)], check=True
            )

    for item in download_plan(params):
        if not item.destination.exists():
            fetcher(item.url, item.destination)
    extract_all_dla_catalogs(params)


def _parse_table(path: Path, skip: int) -> list[list[str]]:
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            if lineno <= skip:
                continue
            fields = line.split()
            if fields:
                rows.append(fields)
    return rows


def _gawk_num(fields: list[str], i: int) -> float:
    """gawk's numeric coercion of ``$i``: a missing field or a
    non-numeric token is 0 — a short or malformed catalog row must be
    skipped by its own predicate (as the shell pipeline did), not crash
    the whole extraction with an IndexError/ValueError."""
    if i >= len(fields):
        return 0.0
    try:
        return float(fields[i])
    except ValueError:
        return 0.0


def extract_dla_catalog(
    name: str, source_path: Path, out_dir: Path
) -> tuple[Path, Path]:
    """Raw catalog file -> processed dla_catalog / los_catalog text files.

    Mirrors the gawk programs (download_catalogs.sh:48-80):
      dr9q_concordance: BOSSLyaDR9_cat.txt, skip 1 header row; DLA rows
        have column 15 (z_dla) > 0; emit (col4=thing_id, col15, col16).
      dr12q_noterdaeme: DLA_DR12_v2.dat, skip 2; emit (col1, col10=z,
        col11=log_nhi); LOS from LOS_DR12_v2.dat col1.
      dr12q_visual: LOS_DR12_v2.dat, skip 2; DLA rows have col6 != 0;
        z and N are unavailable in the visual survey, so fill z with
        col5 (z_QSO) and log_nhi with the DLA threshold 20.3.
    """
    out_dir.mkdir(parents=True, exist_ok=True)
    dla_path = out_dir / "dla_catalog"
    los_path = out_dir / "los_catalog"

    if name == "dr9q_concordance":
        rows = _parse_table(source_path, skip=1)
        dla = [
            (r[3], r[14], r[15])
            for r in rows
            if len(r) > 15 and _gawk_num(r, 14) > 0
        ]
        los = [r[3] for r in rows if len(r) > 3]
    elif name == "dr12q_noterdaeme":
        dla_rows = _parse_table(source_path / "DLA_DR12_v2.dat", skip=2)
        los_rows = _parse_table(source_path / "LOS_DR12_v2.dat", skip=2)
        dla = [(r[0], r[9], r[10]) for r in dla_rows if len(r) > 10]
        los = [r[0] for r in los_rows]
    elif name == "dr12q_visual":
        los_rows = _parse_table(source_path / "LOS_DR12_v2.dat", skip=2)
        dla = [
            (r[0], r[4], "20.3")
            for r in los_rows
            if _gawk_num(r, 5) != 0
        ]
        los = [r[0] for r in los_rows]
    else:
        raise ValueError(f"unknown DLA catalog {name!r}")

    with open(dla_path, "w") as f:
        for row in dla:
            f.write(" ".join(row) + "\n")
    with open(los_path, "w") as f:
        f.write("\n".join(los) + ("\n" if los else ""))
    return dla_path, los_path


def extract_all_dla_catalogs(params: Parameters | None = None) -> None:
    if params is None:
        params = Parameters()
    untarred: set[Path] = set()
    for name, (filename, _) in DLA_CATALOG_SOURCES.items():
        dist = params.dla_catalog_directory(name).parent / "distfiles"
        src = dist / filename
        if not src.exists():
            # download_plan dedups shared archives (the Noterdaeme tgz
            # serves two catalogs): fall back to any sibling catalog's
            # copy of the same file
            for other in DLA_CATALOG_SOURCES:
                alt = (
                    params.dla_catalog_directory(other).parent
                    / "distfiles"
                    / filename
                )
                if alt.exists():
                    src = alt
                    dist = alt.parent
                    break
        if filename.endswith(".tgz") and src.exists():
            if src not in untarred:  # shared archives untar once
                untarred.add(src)
                with tarfile.open(src) as tf:
                    # the "data" safety filter landed in 3.10.12/3.11.4;
                    # older interpreters reject the kwarg
                    if hasattr(tarfile, "data_filter"):
                        tf.extractall(dist, filter="data")
                    else:  # pragma: no cover - old-interpreter fallback
                        tf.extractall(dist)
            src = dist  # extractors read the .dat files from the dir
        extract_dla_catalog(name, src, params.dla_catalog_directory(name))


def download_spectra_command(
    params: Parameters | None = None, release: str = "dr12q"
) -> list[str]:
    """The rsync invocation for the spectra (download_spectra.sh:6-8)."""
    if params is None:
        params = Parameters()
    spectra_dir = params.spectra_directory(release)
    return [
        "rsync",
        "--info=progress2",
        "-h",
        "--no-motd",
        f"--files-from={spectra_dir / 'file_list'}",
        SPECTRA_RSYNC_ROOT,
        str(spectra_dir),
    ]


def download_spectra(
    params: Parameters | None = None, release: str = "dr12q"
) -> None:
    subprocess.run(download_spectra_command(params, release), check=True)
