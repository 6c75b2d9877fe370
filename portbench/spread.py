#!/usr/bin/env python3
"""Spreads of a cell's runs, the way the bounds are set from them.

    python3 portbench/spread.py SET_A_RESULTS... -- SET_B_RESULTS...

Each argument is a file whose last line is a run's JSON result (the
standard output of ``run.py``). For every metric, prints each set's
median and spread (the distance between the first and third quartile,
``statistics.quantiles(values, n=4)``, over the median) and five times
the wider spread, the bound the rule suggests (at least 1 %).
"""
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib.stats import spread  # noqa: E402


def _values(paths):
    out = {}
    for p in paths:
        res = json.loads(Path(p).read_text().strip().splitlines()[-1])
        for name, m in res["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if "--" not in args:
        print(__doc__, file=sys.stderr)
        return 2
    cut = args.index("--")
    sets = [_values(args[:cut]), _values(args[cut + 1:])]
    for name in sets[0]:
        rows = [(statistics.median(s[name]), spread(s[name]))
                for s in sets if len(s.get(name, ())) >= 2]
        wide = max(r[1] for r in rows)
        print(json.dumps({"metric": name,
                          "medians": [r[0] for r in rows],
                          "spreads": [r[1] for r in rows],
                          "bound_5x": max(0.01, 5 * wide)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
