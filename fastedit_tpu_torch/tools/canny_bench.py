"""Time the Canny kernel's entries of this tree and of another tree of this
repository on the card, in turns in one process.

    python fastedit_tpu_torch/tools/canny_bench.py [--root DIR] [--dtype bf16|fp32]
        [--out FILE]

``--root`` is the other checkout (unpack it with ``git archive`` into a
directory that ``.gitignore`` lists, e.g. ``build/parent``); without it only
this tree is read.  Both trees' ``fastedit_tpu_torch`` are imported in one
process, each with its own modules, and every measurement is taken in the
order other, this, this, other, so both see the same card at the same clocks.
Per tree it prints, at 1024² and batches 1, 2 and 4, the device µs of
``prepare``, ``canny_front`` and ``canny_hysteresis`` (the three entries
every tree since the kernels came to the card has) from a CUDA graph of 20
calls (``graph_ms``) and eagerly (10 back-to-back calls), on
``chip_smoke.test_image``'s images at (100, 200), beside the bound (each
input byte read once, each output byte written once, at 3.35 TB/s:
prepare reads 3 bytes a pixel and writes the control and the VAE input;
the front writes a class map byte and the VAE input; the hysteresis reads
a class map byte and writes the control); then the hysteresis on random
candidate maps at densities 0.1 to 0.6 (batches 1 and 4) and on the 1024²
serpentine (``tools/conformance``), each checked against the plain version
first.  One JSON object, also written to ``--out``.  It needs a CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

PEAK_HBM_BYTES_PER_S = 3.35e12
HERE = Path(__file__).resolve().parents[2]
PACKAGE = "fastedit_tpu_torch"
SIZE = 1024
BATCHES = (1, 2, 4)


def _ours(name: str) -> bool:
    return name == PACKAGE or name.startswith(PACKAGE + ".")


def load_tree(root: Path) -> dict:
    """The modules of ``root``'s package that the bench calls, imported
    apart from any other tree's (sys.modules as it was before, after)."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if _ours(k)}
    sys.path.insert(0, str(root))
    try:
        import fastedit_tpu_torch.ops.build  # noqa: F401
        import fastedit_tpu_torch.ops.canny  # noqa: F401
        import fastedit_tpu_torch.tools.conformance  # noqa: F401

        return {k: sys.modules[k] for k in list(sys.modules) if _ours(k)}
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


@contextlib.contextmanager
def tree(modules: dict):
    """``modules`` as the package while the body runs: the wrappers import
    their build module at call time."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if _ours(k)}
    sys.modules.update(modules)
    try:
        yield modules[f"{PACKAGE}.ops.canny"]
    finally:
        for k in modules:
            sys.modules.pop(k, None)
        sys.modules.update(saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="the other tree (e.g. build/parent)")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("canny_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from timing import card_line, graph_ms, time_ms  # this tree's

    sys.path.insert(0, str(HERE))
    import chip_smoke  # this tree's test images

    trees = {"this": load_tree(HERE)}
    if args.root:
        trees = {"other": load_tree(Path(args.root).resolve()), **trees}
    order = ["other", "this", "this", "other"] if args.root else ["this", "this"]
    card = card_line()
    dtype, isz = (torch.float32, 4) if args.dtype == "fp32" else (torch.bfloat16, 2)
    print(card, "torch", torch.__version__, "dtype", args.dtype, flush=True)

    def measure(what: str, make) -> dict:
        """make(canny) -> the call; its graph and eager µs per tree, in turns."""
        reads = {name: {"graph_us": [], "eager_us": []} for name in trees}
        for name in order:
            with tree(trees[name]) as canny:
                fn = make(canny)
                reads[name]["graph_us"].append(1e3 * graph_ms(fn))
                reads[name]["eager_us"].append(1e3 * time_ms(fn))
        out = {name: {k: float(np.mean(v)) for k, v in r.items()} | {"reads": r}
               for name, r in reads.items()}
        print(f"{what:36s}", "  ".join(
            f"{name} {o['graph_us']:8.2f} (eager {o['eager_us']:8.2f})"
            for name, o in out.items()), flush=True)
        return out

    rows = []
    for b in BATCHES:
        img = torch.from_numpy(np.stack([np.asarray(chip_smoke.test_image(70 + i))
                                         for i in range(b)])).cuda()
        px = b * SIZE * SIZE
        for name in trees:  # every tree right before timing it
            with tree(trees[name]) as canny:
                lo, hi = canny.threshold_tensors(100, 200, "cuda")
                cls_p, _ = canny.canny_front_plain(img, lo, hi, dtype)
                got = canny.prepare(img, lo, hi, dtype)
                want = canny.prepare_plain(img, lo, hi, dtype)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{name} tree: prepare differs from the plain version")
        for entry, nbytes in (("prepare", px * (3 + 6 * isz) + 8),
                              ("canny_front", px * (3 + 1 + 3 * isz) + 8),
                              ("canny_hysteresis", px * (1 + 3 * isz))):
            def make(canny, entry=entry):
                lo, hi = canny.threshold_tensors(100, 200, "cuda")
                fn = getattr(canny, entry)
                if entry == "canny_hysteresis":
                    return lambda: fn(cls_p, dtype)
                return lambda: fn(img, lo, hi, dtype)

            res = measure(f"{entry} b{b}", make)
            rows.append(dict(entry=entry, batch=b, input="photos (100, 200)",
                             bound_us=1e6 * nbytes / PEAK_HBM_BYTES_PER_S, bytes=nbytes, **res))
        del img

    masks = {}
    for b in (1, 4):
        with tree(trees["this"]):
            from fastedit_tpu_torch.tools.conformance import serpentine, stress_classes

            for name, m in stress_classes(seed=b, size=SIZE):
                if name.startswith("random"):
                    masks[(name, b)] = np.stack([m] * b)
            if b == 1:
                chain = serpentine(SIZE, SIZE)
                cls = chain.astype(np.uint8)
                cls[tuple(np.argwhere(chain)[0])] = 2
                masks[("serpentine", 1)] = cls[None]
    for (name, b), m in masks.items():
        cls = torch.from_numpy(m).cuda()
        with tree(trees["this"]) as canny:
            want = canny.canny_hysteresis_plain(cls, dtype)
        for t in trees:
            with tree(trees[t]) as canny:
                if not torch.equal(canny.canny_hysteresis(cls, dtype), want):
                    raise AssertionError(f"{t} tree: the hysteresis differs on {name}")
        nbytes = b * SIZE * SIZE * (1 + 3 * isz)
        res = measure(f"canny_hysteresis {name} b{b}",
                      lambda canny, c=cls: (lambda: canny.canny_hysteresis(c, dtype)))
        rows.append(dict(entry="canny_hysteresis", batch=b, input=name,
                         bound_us=1e6 * nbytes / PEAK_HBM_BYTES_PER_S, bytes=nbytes, **res))
    record = dict(card=card, torch=torch.__version__, dtype=args.dtype, size=SIZE,
                  trees={"this": str(HERE), "other": args.root}, rows=rows)
    text = json.dumps(record, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
