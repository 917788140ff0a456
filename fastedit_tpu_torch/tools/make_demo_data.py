"""Generate a tiny synthetic PIE-Bench-style dataset for smoke runs (a copy
of the JAX package's tool: the same bytes for the same arguments).

The real PIE-Bench v1 must be obtained separately (no downloads at
runtime); this tool creates a structurally-identical miniature so the whole
run_batch -> evaluate -> compare_methods workflow can be exercised anywhere
(tests, demos, CI).

Usage:
    python -m fastedit_tpu_torch.tools.make_demo_data --out data/demo --n 6
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image, ImageDraw


def make_demo_dataset(out_dir: str, n: int = 6, size: int = 128, seed: int = 0):
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(out_dir, "annotation_images")
    mapping = {}
    shapes = ["square", "circle", "triangle"]
    colors = [("red", (200, 40, 40)), ("blue", (40, 60, 200)), ("green", (40, 180, 60))]
    for i in range(n):
        category = str(i % 3)
        rel = os.path.join(f"{category}_shapes", f"img_{i:03d}.jpg")
        path = os.path.join(img_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)

        base = rng.integers(120, 200, 3)
        img = Image.new("RGB", (size, size), tuple(int(c) for c in base))
        draw = ImageDraw.Draw(img)
        name, rgb = colors[i % 3]
        shape = shapes[(i // 3) % 3]
        lo, hi = size // 4, 3 * size // 4
        if shape == "square":
            draw.rectangle([lo, lo, hi, hi], fill=rgb)
        elif shape == "circle":
            draw.ellipse([lo, lo, hi, hi], fill=rgb)
        else:
            draw.polygon([(size // 2, lo), (lo, hi), (hi, hi)], fill=rgb)
        img.save(path, quality=95)

        target = colors[(i + 1) % 3][0]
        mapping[f"{i:012d}"] = {
            "image_path": rel.replace(os.sep, "/"),
            "editing_prompt": f"a {target} {shape}",
            "editing_type_id": category,
        }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "mapping_file.json"), "w") as f:
        json.dump(mapping, f, indent=2)
    return mapping


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a synthetic mini PIE-Bench")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=6)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    mapping = make_demo_dataset(args.out, args.n, args.size, args.seed)
    print(f"Wrote {len(mapping)} entries under {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
