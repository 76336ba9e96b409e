"""Compare two logs of `chip_smoke.py` (its standard output) for what
must not move between two trees: the GLM duality-gap readings and the
LM serving runs.

    python3 tools/smoke_compare.py NEW.log OLD.log

A gap reading is every number, at any depth of a JSON line, under a key
that names a gap (``gap``, ``gaps``, ``twin_gap``, ``gap_after_2``):
keys holding a time (``...seconds...``) or a relative difference
(``..._diff``) are not readings, nor are booleans.  The LM serving runs
are the ``"phase": "lm"`` prefill and decode lines, compared by config,
launches and the first row's greedy tokens.  Prints one JSON line with
the counts and whether each part is equal; exits 1 if either part
differs.  Needs no device.
"""
from __future__ import annotations

import json
import sys


def records(path: str) -> list[dict]:
    out = []
    for line in open(path):
        line = line.strip()
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def is_gap_key(key: str) -> bool:
    return "gap" in key and "seconds" not in key and not key.endswith("_diff")


def gap_readings(recs: list[dict]) -> list[tuple]:
    """(phase, path, key, value) of every gap reading, in log order."""
    out = []

    def walk(x, rec, key):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, rec, k)
        elif isinstance(x, list):
            for v in x:
                walk(v, rec, key)
        elif (key is not None and is_gap_key(key)
              and isinstance(x, (int, float)) and not isinstance(x, bool)):
            out.append((rec.get("phase"), rec.get("path"), key, x))

    for rec in recs:
        walk(rec, rec, None)
    return out


def lm_serving(recs: list[dict]) -> list[tuple]:
    return [(d["config"], d.get("launches"), d.get("ids_row0"))
            for d in recs if d.get("phase") == "lm"
            and d.get("step") in ("prefill", "decode")]


def main(new: str, old: str) -> int:
    a, b = records(new), records(old)
    ga, gb = gap_readings(a), gap_readings(b)
    la, lb = lm_serving(a), lm_serving(b)
    out = {"gap_readings": [len(ga), len(gb)], "gaps_equal": ga == gb,
           "lm_serving_lines": [len(la), len(lb)],
           "lm_serving_equal": la == lb}
    print(json.dumps(out))
    return 0 if out["gaps_equal"] and out["lm_serving_equal"] else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
