"""The reported hits against the copies the genome was made with.

Every embedded copy of a profile's protein has to be covered by a
reported hit of that profile, and every reported hit at an E-value of
at most ``STRONG_E`` has to cover a copy of its own profile: in a
uniform random genome a hit that strong is due by chance about once
in 10^5 searches.  A copy made with a frameshift has to be covered by
a hit of its profile that reads at least one (``shifts``, the column
that ``--fs`` adds to the table).
"""

from __future__ import annotations

STRONG_E = 1e-5


def read_tblout(path: str) -> list[tuple[str, int, int, float]]:
    """(query name, first, last, full-sequence E-value) of every row of
    a ``--tblout`` table, the coordinates on the plus strand."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            c = line.split()
            a, b = int(c[9]), int(c[10])
            rows.append((c[3], min(a, b), max(a, b), float(c[11])))
    return rows


def hits_off(rows, copies: dict) -> tuple[int, int]:
    """(copies that no hit of their profile covers, strong hits that
    cover no copy of their profile); <copies>: {profile name:
    [(first, last), ...]}."""
    missed = sum(not any(q == name and a <= e and b >= s
                         for q, a, b, _ in rows)
                 for name, spans in copies.items() for s, e in spans)
    stray = sum(ev <= STRONG_E and not any(
        a <= e and b >= s for s, e in copies.get(q, ()))
        for q, a, b, ev in rows)
    return missed, stray


def read_shifts(path: str) -> list[tuple[str, int, int, int]] | None:
    """(query name, first, last, shifts) of every row of a ``--tblout``
    table written with ``--fs``, the coordinates on the plus strand;
    None for a table without the ``shifts`` column."""
    rows, at = [], None
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                if "shifts" in line:
                    at = 15          # after E-value, score, bias and PID
                continue
            if not line.strip():
                continue
            if at is None:
                return None
            c = line.split()
            a, b = int(c[9]), int(c[10])
            rows.append((c[3], min(a, b), max(a, b), int(c[at])))
    return rows if at is not None else None


def shifts_missed(rows, shifted: dict) -> int:
    """The copies of <shifted> ({profile name: [(first, last), ...]})
    that no row of <rows> (``read_shifts``) of their profile covers
    with a frameshift."""
    return sum(not any(q == name and a <= e and b >= s and n >= 1
                       for q, a, b, n in rows)
               for name, spans in shifted.items() for s, e in spans)
