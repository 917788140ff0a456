"""Evaluate edited images against PIE-Bench sources (the counterpart of the
JAX package's ``evaluate.py``, with the same flags; ``--device`` defaults to
the card, ``cuda``).

Writes the same ``metrics.csv`` / ``summary.json`` artifacts
(``harness.py``).  The pairs are scored in batches
(``MetricsCalculator.calculate_all_metrics_batch``, both images at 512²
LANCZOS); a batch that fails is scored again image by image, so one corrupt
file costs one row.  ``FASTEDIT_PLATFORM=cpu`` or ``--device cpu`` runs on
the CPU.

Usage:
    python -m fastedit_tpu_torch.evaluate --outputs_dir outputs/batch/edited/ssd-1b_fp16
"""

import argparse
import os
import time

from PIL import Image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate edited images")
    p.add_argument("--mapping_file", type=str,
                   default="data/PIE-Bench_v1/mapping_file.json")
    p.add_argument("--source_dir", type=str,
                   default="data/PIE-Bench_v1/annotation_images")
    p.add_argument("--outputs_dir", type=str, required=True)
    p.add_argument("--results_file", type=str, default=None)
    p.add_argument("--summary_file", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--metrics_weights", type=str, default=None,
                   help="Converted metric-model weights dir "
                        "(default checkpoints/metrics)")
    p.add_argument("--tiny_metrics", action="store_true",
                   help="Random tiny metric backbones (smoke testing)")
    p.add_argument("--allow_random_metrics", action="store_true",
                   help="Emit LPIPS/CLIP/DINO from RANDOM backbone weights "
                        "when no converted checkpoints exist (values are "
                        "meaningless; without this flag they are NaN)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="Images per metric batch (1 = reference-style "
                        "strictly per-image evaluation)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from fastedit_tpu_torch import MetricsCalculator, harness

    device = harness.entry_device(args.device)
    suffix = harness.detect_model_suffix(args.outputs_dir)
    results_file = args.results_file or (
        f"results/{suffix}/metrics.csv" if suffix else "results/metrics.csv"
    )
    summary_file = args.summary_file or (
        f"results/{suffix}/summary.json" if suffix else "results/summary.json"
    )

    print(f"\n[1/3] Loading mapping file from {args.mapping_file}")
    mapping = harness.load_mapping(args.mapping_file)
    print(f"      Found {len(mapping)} entries in mapping file")

    print(f"\n[2/3] Scanning outputs directory: {args.outputs_dir}")
    if not os.path.isdir(args.outputs_dir):
        print(f"Error: Outputs directory not found: {args.outputs_dir}")
        return 1

    print("\n[3/3] Computing metrics...")
    calc = MetricsCalculator(
        device=device,
        weights_dir=args.metrics_weights,
        tiny=args.tiny_metrics,
        allow_random=args.allow_random_metrics,
    )
    if not calc.learned_enabled:
        print(
            "      WARNING: no converted LPIPS/CLIP/DINO weights — those "
            "columns will be NaN (use --allow_random_metrics to override)."
        )

    # Collect the evaluable pairs first, then run metric batches.
    work = []
    skipped = 0
    for image_id, entry in mapping.items():
        rel = entry["image_path"]
        source_path = os.path.join(args.source_dir, rel)
        output_path = os.path.join(args.outputs_dir, rel)
        if not (os.path.exists(output_path) and os.path.exists(source_path)):
            skipped += 1
            continue
        work.append((image_id, entry, source_path, output_path))

    def load_512(path):
        # Metrics convention: both at 512x512 LANCZOS (reference
        # evaluate.py:127-130).
        return Image.open(path).convert("RGB").resize((512, 512), Image.LANCZOS)

    def row(image_id, entry, m):
        return {
            "image_id": image_id,
            "image_path": entry["image_path"],
            "editing_type_id": entry.get("editing_type_id", "unknown"),
            "editing_prompt": entry.get("editing_prompt", ""),
            **m,
        }

    def eval_one(image_id, entry, sp, op):
        m = calc.calculate_all_metrics(
            load_512(sp), load_512(op), entry.get("editing_prompt", "")
        )
        return row(image_id, entry, m)

    rows = []
    bs = max(1, args.batch_size)
    t_eval = time.time()
    for start in range(0, len(work), bs):
        chunk = work[start : start + bs]
        chunk_rows = None
        if bs > 1:
            try:
                sources, editeds, prompts = [], [], []
                for _, entry, sp, op in chunk:
                    sources.append(load_512(sp))
                    editeds.append(load_512(op))
                    prompts.append(entry.get("editing_prompt", ""))
                metrics = calc.calculate_all_metrics_batch(sources, editeds, prompts)
                chunk_rows = [
                    row(image_id, entry, m)
                    for (image_id, entry, _, _), m in zip(chunk, metrics)
                ]
            except Exception as e:
                # Per-image isolation (reference evaluate.py:113-119): one
                # corrupt file must cost one row, not the whole chunk.
                print(f"\n      Error processing batch at {start}: {e} — "
                      f"retrying this chunk per image")
        if chunk_rows is None:
            chunk_rows = []
            for item in chunk:
                try:
                    chunk_rows.append(eval_one(*item))
                except Exception as e:
                    print(f"\n      Error processing {item[0]}: {e}")
                    skipped += 1
        rows.extend(chunk_rows)
        print(f"Evaluating: {start + len(chunk)}/{len(work)} pairs, "
              f"{time.time() - t_eval:.1f} s", flush=True)

    print(f"\n      Processed: {len(rows)} images\n      Skipped:   {skipped} images")
    if not rows:
        print("\n      No images were processed. Exiting.")
        return 1

    print("\n[4/4] Saving results...")
    harness.write_metrics_csv(results_file, rows)
    print(f"      Saved detailed metrics to: {results_file}")
    summary = harness.summarize(rows)
    harness.write_summary(summary_file, summary)
    print(f"      Saved summary statistics to: {summary_file}")

    o = summary["overall"]
    print(f"\n{'='*60}\nEVALUATION SUMMARY\n{'='*60}")
    print(f"\nTotal Images Evaluated: {summary['total_images']}")
    print("\nOverall Metrics:")
    print(f"  SSIM:       {o['ssim']['mean']:.4f} ± {o['ssim']['std']:.4f}")
    print(f"  LPIPS:      {o['lpips']['mean']:.4f} ± {o['lpips']['std']:.4f}")
    print(f"  PSNR:       {o['psnr']['mean']:.2f} ± {o['psnr']['std']:.2f} dB")
    print(f"  MSE:        {o['mse']['mean']:.6f} ± {o['mse']['std']:.6f}")
    print(f"  CLIP Score: {o['clip_score']['mean']:.2f} ± {o['clip_score']['std']:.2f}")
    print(f"  DINO Dist.: {o['dino_distance']['mean']:.4f} ± {o['dino_distance']['std']:.4f}")
    print("\nMetrics by Category:")
    for cat in sorted(summary["by_category"]):
        c = summary["by_category"][cat]
        print(f"\n  Category {cat} ({c['count']} images):")
        print(f"    SSIM:       {c['ssim']['mean']:.4f} ± {c['ssim']['std']:.4f}")
        print(f"    LPIPS:      {c['lpips']['mean']:.4f} ± {c['lpips']['std']:.4f}")
        print(f"    PSNR:       {c['psnr']['mean']:.2f} ± {c['psnr']['std']:.2f} dB")
        print(f"    MSE:        {c['mse']['mean']:.6f} ± {c['mse']['std']:.6f}")
        print(f"    CLIP Score: {c['clip_score']['mean']:.2f} ± {c['clip_score']['std']:.2f}")
        print(f"    DINO Dist.: {c['dino_distance']['mean']:.4f} ± {c['dino_distance']['std']:.4f}")
    print(f"\n{'='*60}\n\nDone!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
