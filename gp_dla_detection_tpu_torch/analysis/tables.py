"""LaTeX table generation (CDDF_analysis/make_tables.py rebuild).

Loads the .txt tables written by analysis/plots.py (columns:
x, value, low68, high68, low95, high95) and emits LaTeX tables of
dN/dX, Omega_DLA, and the CDDF with 68/95% credible limits.

A copy of ``gp_dla_detection_tpu/analysis/tables.py`` (numpy only).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "format_latex_num",
    "format_latex_two_num",
    "load_table",
    "load_cddf_table",
    "print_all_tables",
]


def format_latex_num(number: float, prec: int = 3, trans: int = -3) -> str:
    """'31000' -> '$ 3.10 \\times 10^{ 4 }$'; plain for exponents in
    (trans, 1] (make_tables.py:6-15)."""
    if number == 0.0:
        return "$0$"
    if not np.isfinite(number):
        return "--"
    exponent = int(np.floor(np.log10(abs(number))))
    if 1 >= exponent > trans:
        return f"$ {number:.{prec}f} $"
    return f"$ {number / 10**exponent:.2f} \\times 10^{{ {exponent:d} }}$"


def format_latex_two_num(a: float, b: float, prec: int = 3, trans: int = -3) -> str:
    """Range 'a - b' with a shared power of ten (make_tables.py:17-26)."""
    if a == 0.0:
        return "$0 - " + format_latex_num(b)[1:]
    exponent = int(np.min(np.floor(np.log10(np.abs([a, b])))))
    if 1 >= exponent > trans:
        return f"$ {a:.{prec}f} - {b:.{prec}f} $"
    return (
        f"$ [{a / 10**exponent:.2f}  - {b / 10**exponent:.2f} ]"
        f"\\times 10^{{ {exponent:d} }}$"
    )


def _table_shell(ncol: int, headers: list[str], body: str, caption: str,
                 label: str) -> str:
    out = "\\begin{table*} \n \\centering \n"
    out += "\\begin{tabular}{" + "c" * ncol + "}\n\\hline\n"
    out += " & ".join(headers) + " \\\\ \n \\hline \n"
    out += body
    out += "\\hline \n  \\end{tabular}\n "
    out += "\\caption{" + caption + "}\n"
    out += "\\label{tab:" + label + "}\n \\end{table*}\n"
    return out



def _load_bins(txtname) -> np.ndarray:
    """Read a statistic .txt (stat-component rows x bin columns) into
    (bins, components).  A single-bin file loads 1-D from np.loadtxt,
    which a bare .T would leave un-transposed."""
    raw = np.loadtxt(txtname)
    return raw[None, :] if raw.ndim == 1 else raw.T


def _half_bin_width(table: np.ndarray) -> float:
    """Half the bin spacing from the first two bin centers; a
    single-bin table carries no spacing information, so its interval
    collapses to the center instead of crashing."""
    return float(table[1, 0] - table[0, 0]) / 2.0 if len(table) > 1 else 0.0


def load_table(txtname: str | Path, colheaders, caption: str = "",
               omega: bool = False) -> str:
    """z-binned statistic table (dN/dX or Omega_DLA; make_tables.py:28-60)."""
    table = _load_bins(txtname)
    prec = 4
    if omega:
        table[:, 2:] *= 1000
        prec = 3
    nrow, ncol = table.shape
    assert ncol == len(colheaders) + 4
    xerr = _half_bin_width(table)
    body = ""
    for row in table:
        cells = [
            format_latex_two_num(row[0] - xerr, row[0] + xerr, prec=2),
            format_latex_num(row[1], prec=prec),
            format_latex_two_num(row[2], row[3], prec=prec),
            format_latex_two_num(row[4], row[5], prec=prec),
        ]
        body += " & ".join(cells) + "  \\\\ \n"
    headers = list(colheaders) + ["$68$\\% limits", "$95$\\% limits"]
    return _table_shell(ncol, headers, body, caption, str(txtname))


def load_cddf_table(txtname: str | Path, caption: str = "") -> str:
    """CDDF table in units of 1e-21 (make_tables.py:62-90)."""
    table = _load_bins(txtname)
    ncol = table.shape[1]
    scalefact = 1e-21
    scalestr = " $( 10^{ -21 } )$"
    headers = [
        "$\\log_{10} \\mathrm{N}_\\mathrm{HI}$",
        "$f(N_\\mathrm{HI})$ " + scalestr,
        "$68$\\% limits" + scalestr,
        "$95$\\% limits" + scalestr,
    ]
    xerr = _half_bin_width(table)
    body = ""
    for row in table:
        if row[1] == row[3] == row[5] == 0.0:
            break
        cells = [
            format_latex_two_num(row[0] - xerr, row[0] + xerr, prec=1),
            format_latex_num(row[1] / scalefact, trans=-2),
            format_latex_two_num(row[2] / scalefact, row[3] / scalefact, trans=-2),
            format_latex_two_num(row[4] / scalefact, row[5] / scalefact, trans=-2),
        ]
        body += " & ".join(cells) + "  \\\\ \n"
    return _table_shell(ncol, headers, body, caption, str(txtname))


def print_all_tables(subdir: str | Path = "DR12") -> str:
    """All tables for a results directory (make_tables.py:95-101)."""
    subdir = Path(subdir)
    out = []
    out.append(
        load_table(
            subdir / "dndx_all.txt",
            colheaders=("$z$", "dN/dX"),
            caption="Table of dN/dX values",
        )
    )
    out.append(
        load_table(
            subdir / "omega_dla_all.txt",
            colheaders=("$z$", "$\\Omega_\\mathrm{DLA} (10^{-3}) $"),
            caption="$\\Omega_\\mathrm{DLA}$ values",
            omega=True,
        )
    )
    for ctxt in sorted(subdir.glob("cddf_*.txt")):
        out.append(load_cddf_table(ctxt, caption="CDDF"))
    text = "\n".join(out)
    print(text)
    return text
