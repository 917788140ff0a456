"""Readings that set a cell's limits and its traffic's rate, on the card.

    python3 benchmark/calibrate.py readings --workload NAME --seeds 1,2,3 --seconds S
        [--control] [--fault NAME ...]
    python3 benchmark/calibrate.py knee --workload NAME --rates 4,5,6 --seconds S --seed N

``readings``: one editor in one process; per seed, a run's own steps
(``harness.reseed``, ``harness.drive``, ``harness.judge``): the seed's
weights written in, the driver's warm-up, a window of ``--seconds``, the
sample drawn as a run draws it, and the plain reference over it.  With
``--control``, the control judged by the same comparison in the program's
place: the reference in the precision below the configuration's
(``control`` in its file).  With ``--fault NAME`` (``faults.py``), a second
window with the fault planted, judged so.  The program's readings give a
limit its lower end, the control's and the faults' its upper end.

``knee``: the serving driver at each rate in turn for ``--seconds`` on one
warmed-up editor; per rate the requests' median and 95th percentile, the
failed ones, the generator's lateness and the median wait in each third of
the window, which grows from third to third where the backlog grows.

Prints one JSON line per reading to standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _reading(run, samples, control=None) -> dict:
    from benchmark import harness

    checks = harness.judge(run, samples, control)
    c = checks["worst_lsb"]
    return dict(value=c["value"], limit=c["limit"], correct=harness.verdict(checks),
                mean=sum(c["per_image"]) / len(c["per_image"]), images=len(c["per_image"]))


def readings(a) -> None:
    import torch

    from benchmark import faults, harness

    seeds = [int(s) for s in a.seeds.split(",")]
    run = harness.setup(a.workload, seeds[0], a.seconds, t_start=T_START)
    for seed in seeds:
        t0 = time.perf_counter()
        harness.reseed(run, seed)
        samples = harness.drive(run)
        run.editor.clear_memory()  # the graphs' pools freed for the reference
        t1 = time.perf_counter()
        out = dict(seed=seed, window_s=run.window["window_s"], program=_reading(run, samples),
                   run_s=t1 - t0, reference_s=time.perf_counter() - t1)
        if a.control:
            out["control"] = dict(_reading(run, samples, run.cfg["control"]),
                                  mode=run.cfg["control"])
        for name in a.fault:
            mend = faults.FAULTS[name](run.editor)
            try:
                samples = harness.drive(run)
            finally:
                mend()
            run.editor.clear_memory()
            out[name] = _reading(run, samples)
        torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)


def knee(a) -> None:
    import numpy as np

    from benchmark import drivers, harness

    run = harness.setup(a.workload, a.seed, a.seconds, t_start=T_START)
    driver = drivers.KINDS[run.traffic["kind"]](run)
    driver.warm_up()
    for rate in [float(r) for r in a.rates.split(",")]:
        run.traffic = dict(run.traffic, rate_per_s=rate)
        w = driver.window(a.seconds)
        lat = np.asarray(w["latencies_s"])
        thirds = [float(np.median(part)) * 1e3 for part in np.array_split(lat, 3)]
        print(json.dumps(dict(rate=rate, requests=w["attempted"], failed=w["failed"],
                              p50_ms=float(np.percentile(lat, 50)) * 1e3,
                              p95_ms=float(np.percentile(lat, 95)) * 1e3,
                              median_ms_by_third=thirds,
                              lateness_max_ms=float(np.nanmax(w["lateness_s"])) * 1e3,
                              batch_hist=w["batch_hist"])), flush=True)
    driver.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("readings", "knee"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="1")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", default="4")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", action="append", default=[])
    a = p.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [root] + [d for d in sys.path if os.path.abspath(d or ".") != here]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    (readings if a.mode == "readings" else knee)(a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
