"""The full PIE-Bench benchmark workflow (the counterpart of the JAX
package's ``run_benchmark.sh``, in Python, with the same steps and
environment variables): batch edit with the shipped-results configuration
(4 steps, guidance 1.0, ControlNet 0.5, Canny 100/200, seed 42), evaluate,
render comparison figures and archive the results.  Each step is the port's
own entry point, called in this process.

``tiny`` runs the whole artifact chain without weights: with no dataset at
``PIEBENCH_DIR`` it first writes a synthetic mini-dataset, and it evaluates
with the tiny metric backbones on the CPU.

Usage:
    python -m fastedit_tpu_torch.run_benchmark [model] [extra run_batch args...]
    python -m fastedit_tpu_torch.run_benchmark ssd-1b --checkpoint_dir checkpoints/ssd-1b
    FASTEDIT_PLATFORM=cpu python -m fastedit_tpu_torch.run_benchmark tiny

Environment:
    PIEBENCH_DIR   dataset root (default data/PIE-Bench_v1)
    OUTPUT_DIR     outputs root (default outputs)
    RESULTS_DIR    results root (default results)
    FIGURES_DIR    figures root (default figures)
    N_FIGURES      comparison figures to render (default 3)

The archive ``results_<model>_<fp16|fp32>.tar.gz`` is written to the
current directory.
"""

import os
import sys
import tarfile


def main(argv=None) -> int:
    from fastedit_tpu_torch import evaluate, run_batch
    from fastedit_tpu_torch.harness import load_mapping
    from fastedit_tpu_torch.plotting import compare_methods
    from fastedit_tpu_torch.tools import make_demo_data

    argv = list(sys.argv[1:] if argv is None else argv)
    model, extra = (argv[0], argv[1:]) if argv else ("ssd-1b", [])
    env = os.environ
    piebench_dir = env.get("PIEBENCH_DIR", "data/PIE-Bench_v1")
    output_dir = env.get("OUTPUT_DIR", "outputs")
    results_dir = env.get("RESULTS_DIR", "results")
    figures_dir = env.get("FIGURES_DIR", "figures")
    n_figures = int(env.get("N_FIGURES", "3"))

    mapping = os.path.join(piebench_dir, "mapping_file.json")
    sources = os.path.join(piebench_dir, "annotation_images")
    extra_eval = []
    if not os.path.isfile(mapping):
        if model != "tiny":
            print(f"PIE-Bench mapping file not found at {mapping}\n"
                  f"Place the PIE-Bench_v1 dataset under {piebench_dir}", file=sys.stderr)
            return 1
        print(f"=== [0/4] No dataset at {piebench_dir}: generating synthetic demo data")
        make_demo_data.main(["--out", piebench_dir, "--n", "6", "--size", "64"])
    if model == "tiny":
        # random-weight smoke model: the learned metric backbones fail closed,
        # the tiny ones keep the chain whole, on the CPU
        extra_eval += ["--tiny_metrics", "--device", "cpu"]

    print(f"=== [1/4] Batch editing ({model}) ===")
    rc = run_batch.main([
        "--mapping_file", mapping, "--source_dir", sources, "--output_dir", output_dir,
        "--model", model, "--steps", "4", "--guidance", "1.0", "--control_scale", "0.5",
        "--canny_low", "100", "--canny_high", "200", "--seed", "42",
        "--skip_existing", "--save_comparisons", *extra,
    ])
    if rc:
        return rc
    full = any(a in ("--full_precision", "--quality_mode") for a in extra)
    suffix = f"{model}_{'fp32' if full else 'fp16'}"

    print("=== [2/4] Evaluation ===")
    rc = evaluate.main([
        "--mapping_file", mapping, "--source_dir", sources,
        "--outputs_dir", os.path.join(output_dir, "batch", "edited", suffix),
        "--results_file", os.path.join(results_dir, suffix, "metrics.csv"),
        "--summary_file", os.path.join(results_dir, suffix, "summary.json"),
        *extra_eval,
    ])
    if rc:
        return rc

    print("=== [3/4] Comparison figures ===")
    for image_id in sorted(load_mapping(mapping))[:n_figures]:
        rc = compare_methods.main([
            "--image_id", image_id, "--mapping_file", mapping, "--source_dir", sources,
            "--outputs_dir", os.path.join(output_dir, "batch", "edited"),
            "--figures_dir", figures_dir, "--methods", suffix,
        ])
        if rc:
            return rc

    print("=== [4/4] Archive results ===")
    archive = f"results_{suffix}.tar.gz"
    with tarfile.open(archive, "w:gz") as tar:
        tar.add(os.path.join(results_dir, suffix),
                arcname=os.path.join(os.path.basename(os.path.normpath(results_dir)), suffix))
    print(f"Wrote {archive}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
