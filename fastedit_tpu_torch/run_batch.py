"""Run fast image editing on a batch of PIE-Bench images (the counterpart of
the JAX package's ``run_batch.py``, with the same flags and defaults).

On the card unless ``FASTEDIT_PLATFORM=cpu`` asks for the CPU.
``--data_parallel`` splits the sweep over one editor replica per local card
(``parallel/batch.py``); ``--num_processes``, ``--process_id`` and
``--coordinator_address`` join several processes into one sweep, each
on its share of the host's cards and saving its own rows
(``parallel/multihost.py``).  ``--model_parallel k`` (tensor parallelism,
``parallel/tp.py``) splits each replica's transformer linears over a group
of ``k`` devices and implies ``--data_parallel``; on the CPU the group is
the CPU ``k`` times.

Usage:
    python -m fastedit_tpu_torch.run_batch --num_images 50 --editing_types 0 1 2
    FASTEDIT_PLATFORM=cpu python -m fastedit_tpu_torch.run_batch --model tiny \\
        --mapping_file data/demo/mapping_file.json --source_dir data/demo/annotation_images
"""

import argparse
import json
import os
import time

import torch
from PIL import Image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch image editing on PIE-Bench")
    p.add_argument("--mapping_file", type=str,
                   default="data/PIE-Bench_v1/mapping_file.json")
    p.add_argument("--source_dir", type=str,
                   default="data/PIE-Bench_v1/annotation_images")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--model", type=str, default="sdxl",
                   choices=["sdxl", "ssd-1b", "tiny"])
    p.add_argument("--num_images", type=int, default=None)
    p.add_argument("--editing_types", nargs="+", type=str, default=None)
    p.add_argument("--image_ids", nargs="+", type=str, default=None)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--guidance", type=float, default=1.5)
    p.add_argument("--control_scale", type=float, default=0.5)
    p.add_argument("--strength", type=float, default=0.80)
    p.add_argument("--canny_low", type=int, default=100)
    p.add_argument("--canny_high", type=int, default=200)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--no_cpu_offload", action="store_true",
                   help="No-op: the weights always stay in the card's memory")
    p.add_argument("--quality_mode", action="store_true",
                   help="fp32 (TF32 off, the kernels' fp32 instances) + full ControlNet")
    p.add_argument("--full_precision", action="store_true",
                   help="fp32 weights and activations (TF32 off)")
    p.add_argument("--full_controlnet", action="store_true")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--save_comparisons", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--data_parallel", action="store_true",
                   help="Split the sweep over one replica per local card")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="Tensor-parallel group size over the 'model' axis "
                        "(implies --data_parallel)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (multi-process sweep, "
                        "torch.distributed over gloo)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="Total processes in the multi-process sweep")
    p.add_argument("--process_id", type=int, default=None,
                   help="This process's rank in [0, num_processes)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model_parallel > 1:
        args.data_parallel = True
    if args.quality_mode:
        args.full_precision = True
        args.full_controlnet = True
        print("[Quality Mode] Enabled: fp32 + full ControlNet")

    from fastedit_tpu_torch import harness
    from fastedit_tpu_torch.parallel import multihost

    device = harness.entry_device()
    if args.num_processes and args.num_processes > 1:
        # Multi-process DP: join the group before the sweep.  Each process
        # runs this same CLI with its own --process_id; every process builds
        # the same chunks and saves only its rows.
        if args.coordinator_address is None or args.process_id is None:
            raise SystemExit(
                "--num_processes requires --coordinator_address and "
                "--process_id"
            )
        multihost.initialize(
            args.coordinator_address, args.num_processes, args.process_id
        )
        args.data_parallel = True
        if device is None and torch.cuda.is_available():
            # This process's share of the host's cards: its editor loads on
            # the first, its replicas take the rest.
            torch.cuda.set_device(multihost.local_devices()[0])
        print(
            f"[multi-process] process {args.process_id}/{args.num_processes} "
            f"joined {args.coordinator_address}"
        )
    try:
        return _run(args, device)
    finally:
        multihost.shutdown()


def _run(args, device) -> int:
    from fastedit_tpu_torch import harness
    from fastedit_tpu_torch.pipeline.editor import FastEditor

    suffix = harness.model_suffix(args.model, args.full_precision)
    edited_dir = os.path.join(args.output_dir, "batch", "edited", suffix)
    comparisons_dir = os.path.join(args.output_dir, "batch", "comparisons", suffix)
    os.makedirs(edited_dir, exist_ok=True)
    if args.save_comparisons:
        os.makedirs(comparisons_dir, exist_ok=True)

    print(f"\n[1/3] Loading mapping file from {args.mapping_file}")
    mapping = harness.load_mapping(args.mapping_file)
    print(f"      Total entries in mapping file: {len(mapping)}")

    selected = harness.select_entries(
        mapping, args.image_ids, args.editing_types, args.num_images
    )
    print(f"\n[2/3] Selected {len(selected)} images")
    if not selected:
        print("      No images selected. Exiting.")
        return 0

    print(f"\n[3/3] Initializing FastEditor ({suffix})...")
    editor = FastEditor(
        model_name=args.model,
        device=device,
        use_full_precision=args.full_precision,
        use_full_controlnet=args.full_controlnet,
        checkpoint_dir=args.checkpoint_dir,
    )
    mem = editor.get_memory_usage()
    print(
        f"      Device memory: {mem['allocated_gb']:.2f}GB allocated / "
        f"{mem['reserved_gb']:.2f}GB reserved"
    )
    print(
        f"      Parameters: steps={args.steps}, guidance={args.guidance}, "
        f"control_scale={args.control_scale}, strength={args.strength}"
    )

    # Record the fully-resolved run config next to the outputs.
    with open(os.path.join(edited_dir, "run_config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    if args.data_parallel:
        from fastedit_tpu_torch.parallel.batch import run_batch_data_parallel

        return run_batch_data_parallel(
            args, editor, selected, edited_dir,
            comparisons_dir if args.save_comparisons else None)

    processed = skipped = failed = 0
    t_sweep = time.time()
    # Lag-1 software pipeline (as parallel/batch.py): image i's copy to the
    # host streams while image i+1 loads and computes.
    pending = None  # (image_id, rel_path, source_img, output_path, prompt, handle)

    def finalize(p):
        nonlocal processed, failed
        image_id, rel_path, source_img, output_path, prompt, handle = p
        try:
            edited_img = handle.result()[0]
            edited_img.save(output_path)
            processed += 1
        except Exception as e:  # keep the sweep alive (reference behavior)
            print(f"\n      Error processing {image_id} ({type(e).__name__}): {e}")
            failed += 1
            return
        if args.save_comparisons:
            # A comparison failure must not mark the already-saved edited
            # image as failed (processed + failed would overcount).
            try:
                cmp_path = os.path.join(
                    comparisons_dir, rel_path.replace(".jpg", ".png")
                )
                os.makedirs(os.path.dirname(cmp_path), exist_ok=True)
                harness.save_comparison(
                    cmp_path, source_img, edited_img, args.model, prompt
                )
            except Exception as e:
                print(f"\n      Error saving comparison for {image_id} "
                      f"({type(e).__name__}): {e}")

    for n, (image_id, entry) in enumerate(selected, 1):
        print(f"Editing {n}/{len(selected)}: {image_id}, {time.time() - t_sweep:.2f} s",
              flush=True)
        try:
            source_path = harness.safe_join(args.source_dir, entry["image_path"])
            output_path = os.path.join(edited_dir, entry["image_path"])
            if args.skip_existing and os.path.exists(output_path):
                skipped += 1
                continue
            if not os.path.exists(source_path):
                failed += 1
                continue
            prompt = entry.get("editing_prompt", "")
            if not prompt:
                failed += 1
                continue
            os.makedirs(os.path.dirname(output_path), exist_ok=True)
            source_img = Image.open(source_path).convert("RGB")

            handle = editor.edit_batch_async(
                [source_img],
                [prompt],
                negative_prompt=args.negative_prompt,
                strength=args.strength,
                num_inference_steps=args.steps,
                guidance_scale=args.guidance,
                controlnet_conditioning_scale=args.control_scale,
                canny_low_threshold=args.canny_low,
                canny_high_threshold=args.canny_high,
                seed=args.seed,
            )
        except ValueError as e:
            print(f"\n      Invalid path for {image_id}: {e}")
            failed += 1
            continue
        except FileNotFoundError as e:
            print(f"\n      File not found for {image_id}: {e}")
            failed += 1
            continue
        except Exception as e:
            print(f"\n      Error dispatching {image_id} ({type(e).__name__}): {e}")
            failed += 1
            continue
        if pending is not None:
            finalize(pending)
        pending = (
            image_id, entry["image_path"], source_img, output_path, prompt, handle
        )
    if pending is not None:
        finalize(pending)
    total_time = time.time() - t_sweep

    print(f"\n{'='*60}\nBATCH PROCESSING SUMMARY\n{'='*60}")
    print(f"\nProcessed:  {processed} images")
    print(f"Skipped:    {skipped} images")
    print(f"Failed:     {failed} images")
    if processed:
        print(f"\nAverage time per image: {total_time / processed:.2f}s "
              f"(pipelined load/edit/readback, amortized)")
        print(f"Total time: {total_time:.2f}s ({total_time / 60:.1f} minutes)")
    print(f"\nOutputs saved to:\n  - Edited images: {edited_dir}")
    if args.save_comparisons:
        print(f"  - Comparisons: {comparisons_dir}")
    print(f"{'='*60}")
    print("\nDone! Next steps:")
    print(f"  python -m fastedit_tpu_torch.evaluate --outputs_dir {edited_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
