#!/usr/bin/env python3
"""Run chip_smoke.py of two checkouts on one card, in turns (A, B, B, A),
and print each run's kernel lines, engine lines and exit code.

    python3 scripts/ab_chip_smoke.py A_DIR B_DIR [--timeout S]

Each directory holds a checkout with its own chip_smoke.py (for example
the parent commit, unpacked with `git archive` into a directory that
.gitignore lists, and this tree).  Runs in turns put both versions under
the same card, power limit and neighbours, so their times compare.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

KEEP = ("kernel ", "engine ", "stacked ", "build:", "NVIDIA", "{")


def run(tree: Path, timeout: float) -> int:
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith(KEEP):
            print(f"  {line}")
    if proc.returncode:
        print(proc.stderr[-3000:])
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    rcs = []
    for label, tree in (("A", args.a), ("B", args.b), ("B", args.b),
                        ("A", args.a)):
        print(f"== {label}: {tree}", flush=True)
        rcs.append(run(tree.resolve(), args.timeout))
        print(f"   exit {rcs[-1]}", flush=True)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
