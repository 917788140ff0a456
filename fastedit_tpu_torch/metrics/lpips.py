"""LPIPS with the SqueezeNet 1.1 backbone (a port of the JAX package's
``metrics/lpips.py``).

The reference's ``LearnedPerceptualImagePatchSimilarity(net_type='squeeze')``
(src/metrics.py:179-181): SqueezeNet 1.1 features tapped after 7 stages,
unit-normalised over channels, squared differences through learned 1x1
heads, spatial mean, summed over stages.  ``torchvision`` is not needed:
SqueezeNet is written out, with torchvision's ``features`` indices as names
(``net.features.{i}``) and the lpips package's heads (``lin{i}.model.1``),
so converted weights load by name (``tools/from_jax.lpips_state_dict``).
Pooling is the JAX package's (3x3, stride 2, no padding, floor).

Inputs: [B, H, W, 3] in [-1, 1]; output [B].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# LPIPS' input shift and scale, applied to [-1, 1] input.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# SqueezeNet 1.1 feature-tap channel widths, one per LPIPS stage.
SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
# (torchvision features index, input channels, squeeze, expand) per fire module.
FIRES = ((3, 64, 16, 64), (4, 128, 16, 64), (6, 128, 32, 128), (7, 256, 32, 128),
         (9, 256, 48, 192), (10, 384, 48, 192), (11, 384, 64, 256), (12, 512, 64, 256))


class Fire(nn.Module):
    """SqueezeNet fire module: 1x1 squeeze, then parallel 1x1 and 3x3
    expands, concatenated (NCHW)."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)), F.relu(self.expand3x3(x))], dim=1)


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet 1.1's features, returning the 7 LPIPS taps (NCHW)."""

    def __init__(self):
        super().__init__()
        layers = {"0": nn.Conv2d(3, 64, 3, stride=2)}
        layers.update({str(i): Fire(cin, s, e) for i, cin, s, e in FIRES})
        self.features = nn.ModuleDict(layers)

    def forward(self, x):
        f = self.features
        x = F.relu(f["0"](x))
        taps = [x]
        for i in (3, 4, 6, 7, 9, 10, 11, 12):
            if i in (3, 6, 9):
                x = F.max_pool2d(x, 3, 2)
            x = f[str(i)](x)
            if i not in (3, 6):
                taps.append(x)
        return taps


class _Head(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """LPIPS distance per image [B]; inputs NHWC in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = SqueezeNetFeatures()
        for i, c in enumerate(SQUEEZE_CHANNELS):
            setattr(self, f"lin{i}", _Head(c))

    def _features(self, img):
        shift = torch.tensor(_SHIFT, device=img.device)
        scale = torch.tensor(_SCALE, device=img.device)
        img = ((img.float() - shift) / scale).permute(0, 3, 1, 2)
        return [f / (f.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
                for f in self.net(img)]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(self._features(x), self._features(y))):
            head = getattr(self, f"lin{i}").model[1]
            total = total + head((a - b).square()).mean(dim=(1, 2, 3))
        return total
