"""A CSV table read as ``pandas.read_csv`` reads it, for the columns the
datasets use, on the standard library's ``csv``.

The datasets of the JAX package read their corpus with ``pd.read_csv`` and
take columns with ``tolist()``; the machine with the card has no pandas.
``read_csv`` gives each column pandas' type:

* int64 when every field parses as an integer;
* float64 when every field parses as a float, or as an integer with some
  fields missing (NaN there), or when every field is missing;
* else str, with the missing fields as ``float('nan')``.

A field is missing when it is one of pandas' default NA strings
(``NA_STRINGS``), quoted or not. A float is parsed as pandas' C parser
parses it by default (``precise_xstrtod``: at most 17 significant digits
accumulated in a double, then one multiplication or division by a power of
ten), which is not always the correctly rounded value that ``float()``
gives. Blank lines are skipped. Booleans and dates are not inferred (no
column the datasets read holds them).

``Table`` keeps pandas' row order through ``filter`` (a boolean mask) and
``take`` (row positions, as ``DataFrame.sample`` selects them).
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, List

import numpy as np

# pandas._libs.parsers.STR_NA_VALUES (pandas 2.x and 3.x)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_SPACE = " \t\n\v\f\r"
_INT = re.compile(r"[+-]?[0-9]+\Z")
_FLOAT = re.compile(r"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?)([0-9]+))?\Z")
_INFINITE = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
             "+infinity": math.inf, "-infinity": -math.inf}
_POW10 = [float(f"1e{i}") for i in range(309)]
_MAX_DIGITS = 17


def parse_float(field: str):
    """The float pandas reads from ``field``, or None where it reads none:
    ``precise_xstrtod`` of pandas' tokenizer, step for step."""
    text = field.strip(_SPACE)
    if text.lower() in _INFINITE:
        return _INFINITE[text.lower()]
    m = _FLOAT.match(text)
    if m is None or len(m.group(5) or "") > _MAX_DIGITS:
        return None
    sign, whole, frac, exp_sign, exp_digits = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    decimals = 0
    for ch in frac or "":
        if digits >= _MAX_DIGITS:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        decimals += 1
    exponent -= decimals
    if digits == 0:
        return None
    if sign == "-":
        number = -number
    if exp_digits:
        exponent += -int(exp_digits) if exp_sign == "-" else int(exp_digits)
    if exponent > 308:
        return None
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(fields: List[str]) -> np.ndarray:
    present = [f for f in fields if f not in NA_STRINGS]
    if not present:
        return np.full(len(fields), np.nan)
    if len(present) == len(fields) and all(_INT.match(f.strip(_SPACE)) for f in present):
        return np.array([int(f.strip(_SPACE)) for f in fields], dtype=np.int64)
    floats = [math.nan if f in NA_STRINGS else parse_float(f) for f in fields]
    if all(v is not None for v in floats):
        return np.array(floats, dtype=np.float64)
    out = np.empty(len(fields), dtype=object)
    out[:] = [math.nan if f in NA_STRINGS else f for f in fields]
    return out


class Table:
    """Named numpy columns of equal length; ``table.<name>`` or
    ``table[name]`` is a column."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = dict(columns)

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __getattr__(self, name: str) -> np.ndarray:
        try:
            return self.__dict__["columns"][name]
        except KeyError:
            raise AttributeError(name) from None

    def filter(self, mask) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        return Table({k: v[mask] for k, v in self.columns.items()})

    def take(self, rows) -> "Table":
        rows = np.asarray(rows, dtype=np.intp)
        return Table({k: v[rows] for k, v in self.columns.items()})

    def rows(self):
        """Each row as a dict of its fields, in order."""
        names = list(self.columns)
        for i in range(len(self)):
            yield {k: self.columns[k][i] for k in names}


def read_csv(path) -> Table:
    """The table of the CSV file at ``path``: a header row, then one row per
    record (quoted fields may hold commas and newlines)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        records = [r for r in reader if r]
    for i, r in enumerate(records):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the header "
                             f"{len(header)}")
        r.extend([""] * (len(header) - len(r)))
    return Table({name: _column([r[j] for r in records])
                  for j, name in enumerate(header)})
