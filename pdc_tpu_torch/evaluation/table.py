"""A columnar table with a CSV reader and writer in pandas' layout.

The JAX package's evaluation returns pandas DataFrames and reads and writes
their CSVs with pandas. The port does not need pandas: every function that
returns a DataFrame in :mod:`pdc_tpu.evaluation` returns a :class:`Table`
here, whatever is installed, and :meth:`Table.to_pandas` gives the
DataFrame to a caller that has pandas.

A table holds ordered named columns, each a numpy array whose type follows
pandas' inference from the same rows: int64 for ints, float64 for floats
(and for ints with a missing value, which reads as NaN), bool for bools, and
object otherwise, with ``None`` for an empty cell. Its CSV is pandas'
``to_csv`` layout: a first index column with an empty header, ``True`` and
``False``, floats written as ``repr`` writes them, and an empty cell for
``None`` and NaN; :func:`read_csv` reads that layout (and the JAX package's
CSVs) back with the same inference.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

_INT_TEXT = re.compile(r"[-+]?[0-9]+$")


def _column_array(values: Sequence) -> np.ndarray:
    """One column's numpy array, typed as pandas types the same values."""
    present = [v.item() if isinstance(v, np.generic) else v for v in values]
    kinds = {type(v) for v in present if v is not None}
    missing = any(v is None for v in present)
    if not kinds:
        return np.array(present, dtype=object)
    if kinds == {bool}:
        return np.array(present, dtype=object if missing else bool)
    if kinds <= {int}:
        if missing:
            return np.array([np.nan if v is None else v for v in present], np.float64)
        return np.array(present, np.int64)
    if kinds <= {int, float}:
        return np.array([np.nan if v is None else v for v in present], np.float64)
    return np.array(present, dtype=object)


class Table:
    """Ordered named columns of equal length (see the module docstring)."""

    def __init__(self, columns: Iterable[str], data: Optional[Dict[str, Sequence]] = None):
        self._columns = list(columns)
        data = data or {}
        n = len(next(iter(data.values()))) if data else 0
        self._data = {}
        for c in self._columns:
            col = data.get(c)
            arr = (np.array([None] * n, dtype=object) if col is None
                   else col if isinstance(col, np.ndarray) else _column_array(col))
            if len(arr) != n:
                raise ValueError(f"column {c!r} has {len(arr)} rows, not {n}")
            self._data[c] = arr

    @staticmethod
    def from_rows(rows: Sequence[dict], columns: Iterable[str]) -> "Table":
        """A table of ``rows`` (dicts; a missing key is an empty cell), its
        columns in the order of ``columns``."""
        columns = list(columns)
        return Table(columns, {c: [r.get(c) for r in rows] for c in columns})

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return len(self._data[self._columns[0]]) if self._columns else 0

    def __contains__(self, column: str) -> bool:
        return column in self._data

    def __getitem__(self, column: str) -> np.ndarray:
        return self._data[column]

    def where(self, mask) -> "Table":
        """The rows where ``mask`` (a bool array of ``len(self)``) holds."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (len(self),):
            raise ValueError(f"mask of shape {mask.shape} for {len(self)} rows")
        return Table(self._columns, {c: self._data[c][mask] for c in self._columns})

    def rows(self) -> List[dict]:
        """Each row as a dict of Python values (None for an empty object
        cell, NaN for an empty float one)."""
        cols = [(c, self._data[c].tolist()) for c in self._columns]
        return [{c: vals[i] for c, vals in cols} for i in range(len(self))]

    def to_csv(self, path: str):
        """Write pandas' ``DataFrame.to_csv`` layout (see the module
        docstring)."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + self._columns)
            cols = [self._data[c] for c in self._columns]
            for i in range(len(self)):
                w.writerow([str(i)] + [_cell_text(col[i]) for col in cols])

    def to_pandas(self):
        """The table as a pandas DataFrame (imports pandas)."""
        import pandas as pd

        return pd.DataFrame({c: self._data[c] for c in self._columns}, columns=self._columns)

    def __repr__(self):
        return f"Table({len(self)} rows, columns={self._columns})"


def _cell_text(v) -> str:
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        return ""
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def _parse_column(cells: List[str]) -> np.ndarray:
    """One CSV column's array, inferred as pandas' ``read_csv`` infers it."""
    present = [c for c in cells if c != ""]
    missing = len(present) != len(cells)
    if not present:
        return np.full(len(cells), np.nan)
    if all(c in ("True", "False") for c in present):
        vals = [None if c == "" else c == "True" for c in cells]
        return np.array(vals, dtype=object if missing else bool)
    if all(_INT_TEXT.match(c) for c in present):
        if missing:
            return np.array([np.nan if c == "" else float(int(c)) for c in cells])
        return np.array([int(c) for c in cells], np.int64)
    try:
        return np.array([np.nan if c == "" else float(c) for c in cells], np.float64)
    except ValueError:
        return np.array([None if c == "" else c for c in cells], dtype=object)


def read_csv(path: str, index_col: Optional[int] = 0) -> Table:
    """Read a CSV in pandas' layout into a :class:`Table`; ``index_col=0``
    drops the first column as pandas' index, ``None`` keeps it."""
    if index_col not in (0, None):
        raise ValueError("index_col must be 0 or None")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path} is empty")
    header, body = rows[0], rows[1:]
    first = 1 if index_col == 0 else 0
    columns = header[first:]
    for r in body:
        if len(r) != len(header):
            raise ValueError(f"{path}: a row has {len(r)} cells for {len(header)} columns")
    if not body:
        return Table(columns, {c: np.array([], dtype=object) for c in columns})
    return Table(columns, {c: _parse_column([r[first + j] for r in body])
                           for j, c in enumerate(columns)})
