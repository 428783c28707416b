"""Streaming, section-based MPS linear-program reader.

Capability parity with the reference reader (read-mps.lisp:272-293 ``read-mps``
and its section readers), including its dialect choices:

- Sections, in order: ``NAME`` (read-mps.lisp:57), optional ``OBJSENSE``
  (:64), ``ROWS`` (:79), ``COLUMNS`` (:118), ``RHS`` (:159), optional
  ``RANGES`` (:188), optional ``BOUNDS`` (:217), ``ENDATA``.
- ``N`` (free) rows get negative indices; the *first* N row is the objective
  row (index -1), later free rows are parsed but dropped (read-mps.lisp:93-100,
  139-147).
- RHS/RANGES values may be set at most once per row (read-mps.lisp:170,199).
- Bound types ``LO UP FX FR MI PL`` with the reference's semantics — note the
  dialect quirk that ``MI`` sets the upper bound to 0 (read-mps.lisp:249-253,
  matching the lpsolve MPS documentation the reference cites at :1).
- Post-processing turns row types + RHS + RANGES into row intervals
  ``[lb, ub]`` with the RANGES sign conventions of read-mps.lisp:306-318, and
  defaults column bounds to ``[0, +inf)`` (:321-326).

Extensions over the reference (safe for all reference-accepted inputs):

- ``*`` comment lines and blank lines are skipped (Netlib files contain them;
  the reference reader would trip on them).
- Numeric literals accept Fortran ``D`` exponents (``1.5D+2``).
"""

from __future__ import annotations

import dataclasses
import io
import math
from typing import Iterator, Optional


def mps_float(token: str) -> float:
    """Parse an MPS numeric literal (read-mps.lisp:110-116 ``mps-float``)."""
    t = token.strip()
    # Fortran-style exponents: 1.5D+2 / 1D0.
    if "D" in t or "d" in t:
        t = t.replace("D", "E").replace("d", "e")
    return float(t)


@dataclasses.dataclass
class RowData:
    """Per-constraint-row record (read-mps.lisp:5-6 ``row-data``)."""

    name: str
    type: str  # one of '=', '<=', '>='
    rhs: Optional[float] = None
    range: Optional[float] = None
    lb: float = -math.inf
    ub: float = math.inf


@dataclasses.dataclass
class ColData:
    """Per-variable record; default bounds [0, inf) (read-mps.lisp:8-10)."""

    name: str
    lb: Optional[float] = None
    ub: Optional[float] = None


@dataclasses.dataclass
class Triplet:
    """One nonzero of the constraint matrix (read-mps.lisp:12-13)."""

    col: int
    row: int
    value: float


@dataclasses.dataclass
class MPSData:
    """Parsed MPS program (read-mps.lisp:15-33 ``mps-data``)."""

    name: Optional[str] = None
    sense: Optional[str] = None  # 'min' | 'max' | None (defaults to min)
    rows: dict[str, int] = dataclasses.field(default_factory=dict)
    row_data: list[RowData] = dataclasses.field(default_factory=list)
    obj_row: list[tuple[int, float]] = dataclasses.field(default_factory=list)
    columns: dict[str, int] = dataclasses.field(default_factory=dict)
    col_data: list[ColData] = dataclasses.field(default_factory=list)
    triplets: list[Triplet] = dataclasses.field(default_factory=list)


class _Lines:
    """Tokenized line stream distinguishing section headers from data lines.

    A section header is a non-empty line whose first character is not a space
    (read-mps.lisp:37-41 ``tokenize-line``).  Comment (``*``) and blank lines
    are skipped.
    """

    def __init__(self, stream: Iterator[str]):
        self._stream = stream

    def next(self) -> tuple[Optional[list[str]], bool]:
        for line in self._stream:
            line = line.rstrip("\n").rstrip("\r")
            if not line.strip() or line.lstrip().startswith("*"):
                continue
            is_section = line[0] not in (" ", "\t")
            tokens = line.split()
            return tokens, is_section
        return None, True  # EOF behaves like a section boundary

    def next_section(self) -> Optional[list[str]]:
        tokens, is_section = self.next()
        if not is_section:
            raise ValueError(f"expected a section header, got data line {tokens}")
        return tokens


def _read_name(data: MPSData, header: list[str], lines: _Lines) -> Optional[list[str]]:
    # read-mps.lisp:57-62
    assert header[0].lower() == "name"
    data.name = " ".join(header[1:]) if len(header) > 1 else ""
    return lines.next_section()


def _read_sense(data: MPSData, header: list[str], lines: _Lines) -> Optional[list[str]]:
    # read-mps.lisp:64-77
    assert header[0].lower() == "objsense"
    tokens, is_section = lines.next()
    if is_section or tokens is None or len(tokens) != 1:
        raise ValueError("OBJSENSE section must contain exactly one data line")
    word = tokens[0].lower()
    if word in ("max", "maximize"):
        data.sense = "max"
    elif word in ("min", "minimize"):
        data.sense = "min"
    else:
        raise ValueError(f"unknown objective sense {word!r}")
    return lines.next_section()


_ROW_TYPES = {"n": None, "e": "=", "g": ">=", "l": "<="}


def _read_rows(data: MPSData, header: list[str], lines: _Lines) -> Optional[list[str]]:
    # read-mps.lisp:79-108
    assert header[0].lower() == "rows"
    nfree = 0
    while True:
        tokens, is_section = lines.next()
        if is_section:
            return tokens
        if len(tokens) != 2:
            raise ValueError(f"malformed ROWS line: {tokens}")
        type_tok, name = tokens
        if name in data.rows:
            raise ValueError(f"duplicate row {name!r}")
        rtype = _ROW_TYPES[type_tok.lower()]
        if rtype is None:
            # Free (N) rows get negative indices; the first is the objective.
            nfree += 1
            data.rows[name] = -nfree
        else:
            data.rows[name] = len(data.row_data)
            data.row_data.append(RowData(name=name, type=rtype))


def _read_columns(data: MPSData, header: list[str], lines: _Lines) -> Optional[list[str]]:
    # read-mps.lisp:118-157
    assert header[0].lower() == "columns"

    def ensure_column(name: str) -> int:
        idx = data.columns.get(name)
        if idx is None:
            idx = len(data.col_data)
            data.columns[name] = idx
            data.col_data.append(ColData(name=name))
        return idx

    def insert(col_name: str, row_name: str, value_tok: str) -> None:
        col = ensure_column(col_name)
        if row_name not in data.rows:
            raise ValueError(f"unknown row {row_name!r}")
        row = data.rows[row_name]
        value = mps_float(value_tok)
        if row < -1:
            return  # non-objective free row: dropped (read-mps.lisp:139)
        if row == -1:
            data.obj_row.append((col, value))
        else:
            data.triplets.append(Triplet(col=col, row=row, value=value))

    while True:
        tokens, is_section = lines.next()
        if is_section:
            return tokens
        # Integrality markers (MARKER/INTORG/INTEND) are not LPs; the
        # reference rejects them via its 3-or-5-token assert, we do likewise.
        if len(tokens) not in (3, 5):
            raise ValueError(f"malformed COLUMNS line: {tokens}")
        insert(tokens[0], tokens[1], tokens[2])
        if len(tokens) == 5:
            insert(tokens[0], tokens[3], tokens[4])


def _read_rhs(data: MPSData, header: list[str], lines: _Lines) -> Optional[list[str]]:
    # read-mps.lisp:159-186
    assert header[0].lower() == "rhs"
    rhs_name: Optional[str] = None

    def add(row_name: str, value_tok: str) -> None:
        if row_name not in data.rows:
            raise ValueError(f"unknown row {row_name!r}")
        row = data.rows[row_name]
        value = mps_float(value_tok)
        if row < 0:
            return  # RHS on the objective/free rows: ignored (read-mps.lisp:167-169)
        rd = data.row_data[row]
        if rd.rhs is not None:
            raise ValueError(f"duplicate RHS for row {row_name!r}")
        rd.rhs = value

    while True:
        tokens, is_section = lines.next()
        if is_section:
            return tokens
        if len(tokens) not in (3, 5):
            raise ValueError(f"malformed RHS line: {tokens}")
        if rhs_name is None:
            rhs_name = tokens[0]
        elif rhs_name.lower() != tokens[0].lower():
            raise ValueError("multiple RHS vectors are not supported")
        add(tokens[1], tokens[2])
        if len(tokens) == 5:
            add(tokens[3], tokens[4])


def _read_ranges(data: MPSData, header: list[str], lines: _Lines) -> Optional[list[str]]:
    # read-mps.lisp:188-215
    assert header[0].lower() == "ranges"
    range_name: Optional[str] = None

    def add(row_name: str, value_tok: str) -> None:
        if row_name not in data.rows:
            raise ValueError(f"unknown row {row_name!r}")
        row = data.rows[row_name]
        value = mps_float(value_tok)
        if row < 0:
            return
        rd = data.row_data[row]
        if rd.range is not None:
            raise ValueError(f"duplicate RANGES entry for row {row_name!r}")
        rd.range = value

    while True:
        tokens, is_section = lines.next()
        if is_section:
            return tokens
        if len(tokens) not in (3, 5):
            raise ValueError(f"malformed RANGES line: {tokens}")
        if range_name is None:
            range_name = tokens[0]
        elif range_name.lower() != tokens[0].lower():
            raise ValueError("multiple RANGES vectors are not supported")
        add(tokens[1], tokens[2])
        if len(tokens) == 5:
            add(tokens[3], tokens[4])


def _read_bounds(data: MPSData, header: list[str], lines: _Lines) -> Optional[list[str]]:
    # read-mps.lisp:217-270
    assert header[0].lower() == "bounds"
    bound_name: Optional[str] = None

    def add(col_name: str, btype: str, value_tok: Optional[str]) -> None:
        if col_name not in data.columns:
            raise ValueError(f"unknown column {col_name!r}")
        cd = data.col_data[data.columns[col_name]]
        value = mps_float(value_tok) if value_tok is not None else None
        bt = btype.upper()
        if bt == "LO":
            cd.lb = _require(value, bt)
        elif bt == "UP":
            cd.ub = _require(value, bt)
        elif bt == "FX":
            cd.lb = cd.ub = _require(value, bt)
        elif bt == "FR":
            cd.lb, cd.ub = -math.inf, math.inf
        elif bt == "MI":
            # Reference dialect (read-mps.lisp:249-253): MI also caps ub at 0.
            cd.lb, cd.ub = -math.inf, 0.0
        elif bt == "PL":
            cd.lb, cd.ub = 0.0, math.inf
        else:
            raise ValueError(f"unsupported bound type {btype!r}")

    def _require(value: Optional[float], bt: str) -> float:
        if value is None:
            raise ValueError(f"bound type {bt} requires a value")
        return value

    while True:
        tokens, is_section = lines.next()
        if is_section:
            return tokens
        if len(tokens) not in (3, 4):
            raise ValueError(f"malformed BOUNDS line: {tokens}")
        btype, bname, col = tokens[0], tokens[1], tokens[2]
        value = tokens[3] if len(tokens) == 4 else None
        if bound_name is None:
            bound_name = bname
        elif bound_name.lower() != bname.lower():
            raise ValueError("multiple BOUNDS vectors are not supported")
        add(col, btype, value)


def read_mps(stream) -> MPSData:
    """Parse an MPS program from a text stream (read-mps.lisp:272-289)."""
    lines = _Lines(iter(stream))
    data = MPSData()
    header = lines.next_section()
    if header is None:
        raise ValueError("empty MPS file")
    header = _read_name(data, header, lines)
    if header and header[0].lower() == "objsense":
        header = _read_sense(data, header, lines)
    if header is None or header[0].lower() != "rows":
        raise ValueError("expected ROWS section")
    header = _read_rows(data, header, lines)
    if header is None or header[0].lower() != "columns":
        raise ValueError("expected COLUMNS section")
    header = _read_columns(data, header, lines)
    if header is None or header[0].lower() != "rhs":
        raise ValueError("expected RHS section")
    header = _read_rhs(data, header, lines)
    if header and header[0].lower() == "ranges":
        header = _read_ranges(data, header, lines)
    if header and header[0].lower() == "bounds":
        header = _read_bounds(data, header, lines)
    if header is None or header[0].lower() != "endata":
        raise ValueError(f"expected ENDATA, got {header}")
    return data


def read_mps_file(path) -> MPSData:
    """Parse an MPS program from a file path (read-mps.lisp:291-293)."""
    with open(path, "r", encoding="utf-8") as f:
        return read_mps(f)


def read_mps_string(text: str) -> MPSData:
    """Parse an MPS program from a string (convenience for tests)."""
    return read_mps(io.StringIO(text))


def post_process_mps(data: MPSData) -> MPSData:
    """Resolve row/column intervals in place (read-mps.lisp:295-326).

    Row ``[lb, ub]`` from type + RHS + RANGES, with the RANGES sign
    conventions of read-mps.lisp:306-318; column bounds default to
    ``[0, +inf)`` (:321-326).  Idempotent.
    """
    if data.sense is None:
        data.sense = "min"
    for row in data.row_data:
        rhs = row.rhs if row.rhs is not None else 0.0
        rng = row.range
        if rng is not None:
            arange = abs(rng)
            if row.type == "<=":
                row.lb, row.ub = rhs - arange, rhs
            elif row.type == ">=":
                row.lb, row.ub = rhs, rhs + arange
            else:  # '='
                if rng < 0:
                    row.lb, row.ub = rhs + rng, rhs
                else:
                    row.lb, row.ub = rhs, rhs + rng
        else:
            if row.type == "<=":
                row.lb, row.ub = -math.inf, rhs
            elif row.type == ">=":
                row.lb, row.ub = rhs, math.inf
            else:
                row.lb, row.ub = rhs, rhs
        if not row.lb <= row.ub:
            raise ValueError(f"row {row.name!r} has empty interval [{row.lb}, {row.ub}]")
    for col in data.col_data:
        if col.lb is None:
            col.lb = 0.0
        if col.ub is None:
            col.ub = math.inf
    return data
