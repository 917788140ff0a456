"""Side-by-side comparison figures across method configs (the counterpart
of the JAX package's ``plotting/compare_methods.py``: the same flags,
``METHODS`` registry and file names, drawn with PIL).

Usage:
    python -m fastedit_tpu_torch.plotting.compare_methods --image_id 000000000001
    python -m fastedit_tpu_torch.plotting.compare_methods --image_id 000000000001 \\
        --methods sdxl_fp16 ssd-1b_fp16
"""

import argparse
import os

from PIL import Image

# The reference's 4-config registry (plotting/compare_methods.py:33-38),
# plus the tiny smoke config.
METHODS = {
    "sdxl_fp32": "SDXL (FP32)",
    "sdxl_fp16": "SDXL (FP16)",
    "ssd-1b_fp32": "SSD-1B (FP32)",
    "ssd-1b_fp16": "SSD-1B (FP16)",
    "tiny_fp16": "Tiny (smoke)",
    "tiny_fp32": "Tiny (smoke, FP32)",
}


def build_parser():
    p = argparse.ArgumentParser(description="Compare edited outputs across methods")
    p.add_argument("--image_id", type=str, required=True)
    p.add_argument("--methods", nargs="+", default=None,
                   help=f"Subset of {list(METHODS)} (default: all present)")
    p.add_argument("--mapping_file", type=str,
                   default="data/PIE-Bench_v1/mapping_file.json")
    p.add_argument("--source_dir", type=str,
                   default="data/PIE-Bench_v1/annotation_images")
    p.add_argument("--outputs_dir", type=str, default="outputs/batch/edited")
    p.add_argument("--figures_dir", type=str, default="figures")
    return p


def plot_comparison(args) -> str | None:
    from fastedit_tpu_torch import harness

    mapping = harness.load_mapping(args.mapping_file)
    if args.image_id not in mapping:
        print(f"Error: image_id {args.image_id} not in mapping file")
        return None
    entry = mapping[args.image_id]
    rel = entry["image_path"]
    prompt = entry.get("editing_prompt", "")

    source_path = os.path.join(args.source_dir, rel)
    if not os.path.exists(source_path):
        print(f"Error: source image not found: {source_path}")
        return None
    panels = [("Source", Image.open(source_path).convert("RGB"))]

    methods = args.methods or list(METHODS)
    found = []
    for m in methods:
        path = os.path.join(args.outputs_dir, m, rel)
        if os.path.exists(path):
            panels.append((METHODS.get(m, m), Image.open(path).convert("RGB")))
            found.append(m)
        elif args.methods:
            print(f"Warning: no output for method {m}: {path}")
    if len(panels) == 1:
        print("Error: no method outputs found for this image")
        return None

    short = prompt if len(prompt) <= 80 else prompt[:80] + "..."
    fig = harness.panel_figure(panels, suptitle=f'"{short}"')

    os.makedirs(args.figures_dir, exist_ok=True)
    # Naming scheme from the reference (compare_methods.py:104-113).
    if args.methods and len(found) == 2:
        name = f"comparison_{found[0]}_vs_{found[1]}_{args.image_id}.png"
    else:
        name = f"comparison_all_{args.image_id}.png"
    out = os.path.join(args.figures_dir, name)
    fig.save(out)
    print(f"Saved comparison to: {out}")
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    return 0 if plot_comparison(args) else 1


if __name__ == "__main__":
    raise SystemExit(main())
