"""Run fast image editing on a single image (the counterpart of the JAX
package's ``run_single_image.py``, with the same flags and defaults).

On the card unless ``FASTEDIT_PLATFORM=cpu`` asks for the CPU.
``--profile DIR`` runs one edit first (kernel builds and graph capture), then
traces one edit with ``torch.profiler`` into DIR; ``--debug_nans`` checks
every stage's output for NaN and infinity (``utils/profiling.py``).

Usage:
    python -m fastedit_tpu_torch.run_single_image --image path/to/image.jpg \\
        --prompt "a rusty bicycle" --model ssd-1b
"""

import argparse
import os
import time
from datetime import datetime

from PIL import Image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fast image editing on a single image")
    p.add_argument("--image", type=str, required=True, help="Path to input image")
    p.add_argument("--prompt", type=str, required=True, help="Editing prompt")
    p.add_argument(
        "--model", type=str, default="sdxl", choices=["sdxl", "ssd-1b", "tiny"]
    )
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--guidance", type=float, default=1.5)
    p.add_argument("--control_scale", type=float, default=0.5)
    p.add_argument("--strength", type=float, default=0.80,
                   help="img2img strength (reference hardcodes 0.80)")
    p.add_argument("--canny_low", type=int, default=100)
    p.add_argument("--canny_high", type=int, default=200)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--no_cpu_offload", action="store_true",
                   help="No-op: the weights always stay in the card's memory")
    p.add_argument("--quality_mode", action="store_true",
                   help="fp32 (TF32 off, the kernels' fp32 instances) + full ControlNet")
    p.add_argument("--full_precision", action="store_true",
                   help="fp32 weights and activations (TF32 off)")
    p.add_argument("--full_controlnet", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Converted checkpoint dir (default checkpoints/<model>)")
    p.add_argument("--compute_metrics", action="store_true")
    p.add_argument("--show_plot", action="store_true")
    p.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                   help="Write a torch.profiler Chrome trace of the edit to LOGDIR")
    p.add_argument("--debug_nans", action="store_true",
                   help="Check every stage's output for NaN/inf (eager, no CUDA graphs)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.quality_mode:
        args.full_precision = True
        args.full_controlnet = True
        args.no_cpu_offload = True
        print("quality mode: fp32 weights + full-size ControlNet")

    if not os.path.exists(args.image):
        print(f"Error: Image not found at {args.image}")
        return 1

    from fastedit_tpu_torch import harness
    from fastedit_tpu_torch.pipeline.editor import FastEditor
    from fastedit_tpu_torch.utils import profiling

    device = harness.entry_device()
    suffix = harness.model_suffix(args.model, args.full_precision)
    edited_dir = os.path.join(args.output_dir, "single", "edited", suffix)
    comparisons_dir = os.path.join(args.output_dir, "single", "comparisons", suffix)
    os.makedirs(edited_dir, exist_ok=True)
    os.makedirs(comparisons_dir, exist_ok=True)

    print(f"\n[load]    {args.image}")
    source_img = Image.open(args.image).convert("RGB")
    print(f"          {source_img.size[0]}x{source_img.size[1]} px")

    print("\n[init]    building FastEditor (the first edit builds the kernels "
          "and captures the graphs)")
    editor = FastEditor(
        model_name=args.model,
        device=device,
        use_full_precision=args.full_precision,
        use_full_controlnet=args.full_controlnet,
        checkpoint_dir=args.checkpoint_dir,
    )

    def memory_line():
        mem = editor.get_memory_usage()
        print(f"          device memory {mem['allocated_gb']:.2f} GB allocated of "
              f"{mem['reserved_gb']:.2f} GB reserved")

    memory_line()
    print("\n[edit]    " + args.prompt)
    print(
        f"          steps={args.steps} guidance={args.guidance} "
        f"control={args.control_scale} strength={args.strength}"
    )
    nan_checks = profiling.nan_checks_enabled()  # restored for in-process callers
    if args.debug_nans:
        profiling.enable_nan_checks(True)

    def run_edit():
        return editor.edit(
            image=source_img,
            prompt=args.prompt,
            negative_prompt=args.negative_prompt,
            strength=args.strength,
            num_inference_steps=args.steps,
            guidance_scale=args.guidance,
            controlnet_conditioning_scale=args.control_scale,
            canny_low_threshold=args.canny_low,
            canny_high_threshold=args.canny_high,
            seed=args.seed,
        )

    try:
        if args.profile:
            run_edit()  # kernel builds and graph capture outside the trace
            t0 = time.time()
            with profiling.trace(args.profile):
                edited_img = run_edit()
            elapsed = time.time() - t0
            print(f"          profiler trace -> {args.profile}")
        else:
            t0 = time.time()
            edited_img = run_edit()
            elapsed = time.time() - t0
    finally:
        profiling.enable_nan_checks(nan_checks)
    print(f"          done in {elapsed:.2f} s (includes kernel builds and graph "
          "capture on a first edit)")
    memory_line()

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    output_path = os.path.join(edited_dir, f"edited_{timestamp}.jpg")
    edited_img.save(output_path)
    print(f"\n[save]    {output_path}")

    if args.compute_metrics:
        print("\n[metrics]")
        from fastedit_tpu_torch import MetricsCalculator

        calc = MetricsCalculator(device=device, tiny=args.model == "tiny")
        metrics = calc.calculate_all_metrics(source_img, edited_img, args.prompt)
        for label, key, fmt in (
            ("ssim", "ssim", ".4f"),
            ("lpips", "lpips", ".4f"),
            ("psnr", "psnr", ".2f"),
            ("mse", "mse", ".6f"),
            ("clip_score", "clip_score", ".2f"),
            ("dino_distance", "dino_distance", ".4f"),
        ):
            print(f"          {label:14s}{metrics[key]:{fmt}}")

        metrics_path = os.path.join(edited_dir, f"metrics_{timestamp}.txt")
        with open(metrics_path, "w") as f:
            f.write(f"image: {args.image}\nprompt: {args.prompt}\n")
            f.write(f"model: {args.model}\nedit_seconds: {elapsed:.2f}\n")
            for k in ("ssim", "lpips", "psnr", "mse", "clip_score",
                      "dino_distance"):
                f.write(f"{k}: {metrics[k]:.6f}\n")
        print(f"          metrics -> {metrics_path}")

    if args.compute_metrics or args.show_plot:
        plot_path = os.path.join(comparisons_dir, f"comparison_{timestamp}.png")
        harness.save_comparison(plot_path, source_img, edited_img, args.model, args.prompt)
        print(f"          comparison plot -> {plot_path}")

    print("\nfinished.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
