"""The six metrics: SSIM, PSNR, MSE (``functional``), LPIPS-Squeeze
(``lpips``), CLIP score and DINO distance, behind ``MetricsCalculator``."""

from fastedit_tpu_torch.metrics import functional  # noqa: F401
from fastedit_tpu_torch.metrics.calculator import MetricsCalculator  # noqa: F401
