"""The LCM sampler's tables for an img2img edit, from the scheduler settings
of the configuration file (diffusers' ``LCMScheduler`` with SDXL's
scaled-linear betas): the run timesteps after strength truncation and, per
run step, the values the noising and the consistency step read.  Host
arithmetic in fp32, as the sampler's tables are made."""

from __future__ import annotations

import numpy as np


def tables(sched: dict, num_steps: int, strength: float) -> list:
    """One dict per run step: ``t``, ``sqrt_a``, ``sqrt_1ma``, ``sqrt_a_prev``,
    ``sqrt_1ma_prev``, ``c_skip``, ``c_out``, ``last``."""
    n = sched["num_train_timesteps"]
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n,
                        dtype=np.float32) ** 2
    acp = np.cumprod(1.0 - betas).astype(np.float32)
    origin = sched["original_inference_steps"]
    k = n // origin
    origin_ts = np.arange(1, origin + 1) * k - 1
    full = origin_ts[::-1][::origin // num_steps][:num_steps]
    keep = min(int(num_steps * strength), num_steps)
    start = num_steps - keep
    run = full[start:]
    prev = np.array([full[start + i + 1] if start + i + 1 < len(full) else t
                     for i, t in enumerate(run)])
    scaled = run.astype(np.float32) * sched["timestep_scaling"]
    sd2 = sched["sigma_data"] ** 2
    rows = dict(sqrt_a=np.sqrt(acp[run]), sqrt_1ma=np.sqrt(1.0 - acp[run]),
                sqrt_a_prev=np.sqrt(acp[prev]), sqrt_1ma_prev=np.sqrt(1.0 - acp[prev]),
                c_skip=sd2 / (scaled ** 2 + sd2), c_out=scaled / np.sqrt(scaled ** 2 + sd2))
    return [dict(t=float(t), last=i == len(run) - 1,
                 **{k: float(np.float32(v[i])) for k, v in rows.items()})
            for i, t in enumerate(run)]
