"""LCM (Latent Consistency Model) scheduler — host tables + two tensor ops.

Every per-step quantity is precomputed on the host into small fp32 numpy
tables (:class:`LCMSchedule`), and copied once into one fp32 tensor
(``LCMSchedule.table``) on the device the denoise loop runs on, which reads
step ``i``'s values from it as 0-dim tensors: the JAX package traces the
schedule as arrays, so one program serves every strength with the same
number of run steps, and so does one CUDA graph (``pipeline/graphs.py``).
Only ``is_last`` stays on the host; it depends on the number of run steps
alone.  Semantics, as in the JAX package:

  * scaled-linear beta schedule, 1000 train steps (SDXL scheduler config);
  * LCM timesteps from ``original_inference_steps`` (= 50) evenly spaced
    origin timesteps, reversed, strided by
    ``original_inference_steps // num_inference_steps``;
  * img2img strength truncation: keep the last
    ``min(int(steps * strength), steps)`` timesteps — 4 steps at strength
    0.8 run 3 steps from t = 759;
  * LCM step: epsilon -> x0 prediction, consistency boundary scalings, and
    fresh noise between steps; the step marked ``is_last`` returns the
    denoised sample.

Table math is fp32 on the host; the step runs in fp32 on the latents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LCMSchedulerConfig:
    """Static scheduler hyperparameters (SDXL defaults)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "scaled_linear" | "linear"
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5
    set_alpha_to_one: bool = True
    prediction_type: str = "epsilon"


def alphas_cumprod(config: LCMSchedulerConfig) -> np.ndarray:
    """Cumulative product of (1 - beta_t), fp32, shape [num_train_timesteps]."""
    T = config.num_train_timesteps
    if config.beta_schedule == "scaled_linear":
        betas = (
            np.linspace(
                config.beta_start**0.5, config.beta_end**0.5, T, dtype=np.float32
            )
            ** 2
        )
    elif config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, T, dtype=np.float32)
    else:
        raise ValueError(f"Unsupported beta_schedule: {config.beta_schedule}")
    return np.cumprod(1.0 - betas, axis=0).astype(np.float32)


def lcm_timesteps(
    config: LCMSchedulerConfig,
    num_inference_steps: int,
    original_inference_steps: Optional[int] = None,
) -> np.ndarray:
    """The full (untruncated) LCM timestep sequence, descending, shape [steps].

    E.g. 4 steps from 50 origin steps over 1000 train steps: [999, 759, 519, 279].
    """
    origin_steps = original_inference_steps or config.original_inference_steps
    if num_inference_steps > origin_steps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) > "
            f"original_inference_steps ({origin_steps})"
        )
    k = config.num_train_timesteps // origin_steps
    # Origin timesteps: k-1, 2k-1, ..., origin_steps*k - 1  (ascending).
    origin_timesteps = (np.arange(1, origin_steps + 1, dtype=np.int64) * k) - 1
    skipping_step = len(origin_timesteps) // num_inference_steps
    timesteps = origin_timesteps[::-1][::skipping_step][:num_inference_steps]
    return timesteps.astype(np.int32)


def truncate_timesteps_for_img2img(
    timesteps: np.ndarray, num_inference_steps: int, strength: float
) -> tuple[np.ndarray, int]:
    """img2img strength truncation; returns (run timesteps, t_start offset).

    Mirrors the SDXL img2img pipelines' ``get_timesteps``:
    ``init_timestep = min(int(steps * strength), steps)``;
    ``t_start = max(steps - init_timestep, 0)``; keep ``timesteps[t_start:]``.
    """
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_timestep, 0)
    return timesteps[t_start:], t_start


# The rows of ``LCMSchedule.table``, in order.
ROWS = ("timesteps", "sqrt_alpha", "sqrt_one_minus_alpha", "sqrt_alpha_prev",
        "sqrt_one_minus_alpha_prev", "c_skip", "c_out")


@dataclasses.dataclass(frozen=True, eq=False)
class LCMSchedule:
    """Per-step tables for one denoising run; every array has leading dim
    ``num_steps`` (the steps actually run after strength truncation).
    ``table`` [7, num_steps] fp32 holds :data:`ROWS` (the timesteps exactly,
    as small integers) on one device."""

    timesteps: np.ndarray  # [S] int32, descending
    sqrt_alpha: np.ndarray  # [S] fp32 sqrt(alphas_cumprod[t])
    sqrt_one_minus_alpha: np.ndarray  # [S] fp32
    sqrt_alpha_prev: np.ndarray  # [S] fp32 (unused on the last step)
    sqrt_one_minus_alpha_prev: np.ndarray  # [S] fp32
    c_skip: np.ndarray  # [S] fp32
    c_out: np.ndarray  # [S] fp32
    is_last: np.ndarray  # [S] bool — final step returns `denoised`
    num_steps: int
    table: torch.Tensor  # [7, S] fp32, ROWS

    def to(self, device) -> "LCMSchedule":
        """This schedule with its table on ``device``."""
        return dataclasses.replace(self, table=self.table.to(device))

    def value(self, name: str, i: int) -> torch.Tensor:
        """Row ``name`` at step ``i``: a 0-dim fp32 view of the table."""
        return self.table[ROWS.index(name), i]


def make_schedule(
    config: LCMSchedulerConfig,
    num_inference_steps: int,
    strength: float = 1.0,
    original_inference_steps: Optional[int] = None,
) -> LCMSchedule:
    """Build the per-step tables for ``num_inference_steps`` at ``strength``."""
    if config.prediction_type != "epsilon":
        raise ValueError(
            f"Unsupported prediction_type: {config.prediction_type!r} "
            "(only 'epsilon' is implemented)"
        )
    acp = alphas_cumprod(config)
    full = lcm_timesteps(config, num_inference_steps, original_inference_steps)
    run, t_start = truncate_timesteps_for_img2img(full, num_inference_steps, strength)
    n_full = len(full)
    S = len(run)
    if S == 0:
        raise ValueError(
            f"strength={strength} with {num_inference_steps} steps leaves no "
            "timesteps to run"
        )
    alpha_t = acp[run]
    # prev timestep: the next entry of the FULL sequence (unused on the
    # overall last step, which is_last masks).
    prev_ts = np.empty_like(run)
    for i in range(S):
        j = t_start + i + 1
        prev_ts[i] = full[j] if j < n_full else run[i]
    alpha_prev = acp[prev_ts]

    scaled_t = run.astype(np.float32) * config.timestep_scaling
    sd2 = config.sigma_data**2
    c_skip = sd2 / (scaled_t**2 + sd2)
    c_out = scaled_t / np.sqrt(scaled_t**2 + sd2)

    is_last = np.zeros(S, dtype=bool)
    is_last[-1] = t_start + S - 1 == n_full - 1
    if not is_last[-1]:
        raise ValueError("truncation must preserve the tail of the sequence")

    f32 = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    tables = dict(
        timesteps=run.astype(np.int32),
        sqrt_alpha=f32(np.sqrt(alpha_t)),
        sqrt_one_minus_alpha=f32(np.sqrt(1.0 - alpha_t)),
        sqrt_alpha_prev=f32(np.sqrt(alpha_prev)),
        sqrt_one_minus_alpha_prev=f32(np.sqrt(1.0 - alpha_prev)),
        c_skip=f32(c_skip),
        c_out=f32(c_out),
    )
    table = torch.from_numpy(np.stack([tables[r].astype(np.float32) for r in ROWS]))
    return LCMSchedule(**tables, is_last=is_last, num_steps=S, table=table)


def add_noise(schedule: LCMSchedule, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """sqrt(acp[t0]) * x0 + sqrt(1 - acp[t0]) * noise, in x0's dtype (the
    stages pass fp32)."""
    a = schedule.value("sqrt_alpha", 0)
    b = schedule.value("sqrt_one_minus_alpha", 0)
    return a * x0 + b * noise.to(x0.dtype)


def lcm_step(
    schedule: LCMSchedule,
    i: int,
    sample: torch.Tensor,
    eps: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """One LCM step (epsilon parameterisation) in fp32; returns the sample
    at the previous timestep in ``sample``'s dtype.  ``noise`` is ignored on
    the last step."""
    s = sample.float()
    e = eps.float()
    v = lambda name: schedule.value(name, i)  # noqa: E731
    pred_x0 = (s - v("sqrt_one_minus_alpha") * e) / v("sqrt_alpha")
    denoised = v("c_out") * pred_x0 + v("c_skip") * s
    if schedule.is_last[i]:
        return denoised.to(sample.dtype)
    stepped = v("sqrt_alpha_prev") * denoised + v("sqrt_one_minus_alpha_prev") * noise.float()
    return stepped.to(sample.dtype)
