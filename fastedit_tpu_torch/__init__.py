"""fastedit_tpu_torch — the fast image editor in PyTorch and CUDA.

A port of the JAX package ``fastedit_tpu`` to one NVIDIA H100: SDXL /
SSD-1B with a 4-step LCM sampler and ControlNet-Canny img2img.  It mirrors
the JAX package's structure and public names; every Pallas kernel on the
ported path is a hand-written CUDA kernel under ``csrc/``, built at first
use.  Plain tensor code is PyTorch.  It imports neither JAX nor the JAX
package.

Layer map:
    ops/       dispatchers, CUDA kernel wrappers with their plain versions,
               GroupNorm, Canny, the kernel flags and the kernel build.
    models/    nn.Modules with diffusers state-dict names (NHWC activations):
               UNet, ControlNet, VAE, CLIP text and vision towers.
    sched/     LCM scheduler tables and step.
    pipeline/  stage functions, their CUDA graphs and the ``FastEditor``
               facade.
    metrics/   ``MetricsCalculator``: SSIM, PSNR, MSE, LPIPS, CLIP score and
               DINO distance.
    text/      CLIP BPE tokenizer (a copy of the JAX package's).
    tools/     ``convert_checkpoint``: HF snapshots to the checkpoint layout
               both packages read (with ``hf_config``, ``hf_mapping``,
               ``lora``); ``from_jax``: that layout's parameters as state
               dicts; profiling and kernel benches.
    utils/     checkpoint I/O and a safetensors reader and writer, logging,
               image helpers, analytic FLOPs.
    bench.py   ``python -m fastedit_tpu_torch.bench``: seconds per edit on
               the card.
"""

__version__ = "0.1.0"

__all__ = ["FastEditor", "__version__"]


def __getattr__(name):  # lazy: importing a submodule stays light
    if name == "FastEditor":
        from fastedit_tpu_torch.pipeline.editor import FastEditor

        return FastEditor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
