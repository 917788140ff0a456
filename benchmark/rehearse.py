"""Rehearse one cell on the CPU: ``run.py`` without its look for a card,
for the tests and for a dry run of a new cell at a tiny size.

    python3 benchmark/rehearse.py --workload NAME --seed N --seconds S [--trace 1]

Prints the result line as ``run.py`` does; its device is the CPU, so it
states no device time.
"""

import sys

import run

if __name__ == "__main__":
    sys.exit(run.main(device="cpu"))
