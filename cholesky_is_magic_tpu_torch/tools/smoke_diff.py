"""Iteration counts, gaps, statuses and launches of two ``chip_smoke.py``
logs, line by line.

    python -m cholesky_is_magic_tpu_torch.tools.smoke_diff OLD.log NEW.log

Takes from every tagged line (``[tag] ...``) of each log what a kernel that
rounds as before must leave as it was: counts (``27 + 16``, ``iterations
47``, ``phase1 95``, ranges ``9-15``), gaps, statuses, certificates and
launch counts; times are left out.  Lines are paired by tag and their order
under it.  Prints each pair that carries such fields, ``same`` or ``DIFF``,
and the number of differences; exits 1 if there is any.  Needs no card.
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict

FIELDS = [
    r"(?<![\d.])\d+ \+ \d+(?![\d.])",
    r"\biterations:? \d+(?:-\d+)?",
    r"\bphase1 \d+",
    r"\bgaps? \[?-?\d\.\d+e[-+]\d+(?:, -?\d\.\d+e[-+]\d+)*\]?",
    r"\bworst gap -?\d\.\d+e[-+]\d+",
    r"\bstatus(?:es)? \[?[\w, ()]+\]?",
    r"\bcertified \w+",
    r"\brepairs \d+",
    r"\bn_basic \d+",
    r"'[\w|]+': \d+",
]
PATTERN = re.compile("|".join(f"(?:{f})" for f in FIELDS))
TAG = re.compile(r"^\[([^\]]+)\]")


def fields(path: str) -> dict:
    """(tag, n-th line under it) -> the line's fields, in order."""
    out, seen = {}, defaultdict(int)
    with open(path, errors="replace") as f:
        for line in f:
            m = TAG.match(line)
            if not m:
                continue
            found = PATTERN.findall(line)
            if found:
                key = (m.group(1), seen[m.group(1)])
                seen[m.group(1)] += 1
                out[key] = found
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    old, new = (fields(p) for p in argv)
    diffs = 0
    for key in list(old) + [k for k in new if k not in old]:
        a, b = old.get(key), new.get(key)
        same = a == b
        diffs += not same
        tag = f"[{key[0]}]" + (f" #{key[1] + 1}" if key[1] else "")
        print(f"{'same' if same else 'DIFF'} {tag}: {'; '.join(a or ['(none)'])}"
              + ("" if same else f"  ->  {'; '.join(b or ['(none)'])}"))
    print(f"{diffs} lines differ")
    return 1 if diffs else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
