"""The benchmark's inputs: seeded scenes and prompts.

A scene is a photo-like uint8 RGB image: three gradients, mild noise and 16
flat rectangles of random colour, so Canny at the default thresholds finds
edges along the rectangles and little in the noise (the pattern of the
port's chip smoke test).  Scene ``i`` of a run depends on the run's seed and
``i`` alone.  The noise is a roll of one of a few fields drawn once per run,
so a scene costs a few milliseconds of host time and a serving run can make
each request's scene just before it is due.

Prompts are new in every request: four words drawn without replacement from
the product of four word lists, so no two prompts of a run are equal and
every one misses the program's prompt cache.
"""

from __future__ import annotations

import numpy as np

NOISE_FIELDS = 4
_ADJ = ("red", "blue", "green", "golden", "silver", "misty", "sunny", "snowy", "rusty",
        "wooden", "glass", "ancient", "modern", "tiny", "giant", "quiet", "stormy", "bright",
        "dark", "painted")
_NOUN = ("fox", "castle", "bicycle", "lighthouse", "forest", "teapot", "robot", "garden",
         "bridge", "harbor", "owl", "tower", "river", "cabin", "violin", "dragon", "lantern",
         "meadow", "train", "kite")
_PLACE = ("at dawn", "at night", "in winter", "in the rain", "by the sea", "in a city",
          "on a hill", "under stars", "in autumn", "in fog", "at noon", "in spring",
          "near a lake", "in a desert", "in a valley", "on a street", "in a field",
          "at sunset", "in a cave", "on an island")
_STYLE = ("oil painting", "watercolor", "photograph", "pencil sketch", "pixel art",
          "anime style", "charcoal drawing", "studio photo", "film still", "ink drawing",
          "pastel art", "mosaic", "poster art", "linocut print", "cinematic shot",
          "vintage photo", "digital art", "matte painting", "comic style", "glass art")
WORDS = (_ADJ, _NOUN, _PLACE, _STYLE)


class Scenes:
    """The scenes and prompts of one run (``seed``) at ``size`` pixels."""

    def __init__(self, seed: int, size: int):
        self.seed, self.size = int(seed), int(size)
        rng = np.random.default_rng([self.seed, 0])
        n = self.size
        yy, xx = np.mgrid[:n, :n]
        self._base = np.stack([xx * 255 // n, yy * 255 // n, (xx + yy) * 255 // (2 * n)],
                              -1).astype(np.int16)
        self._noise = rng.integers(-12, 13, (NOISE_FIELDS, n, n, 3), dtype=np.int16)
        total = int(np.prod([len(w) for w in WORDS]))
        self._order = rng.permutation(total)

    def image(self, i: int) -> np.ndarray:
        """Scene ``i``: uint8 [size, size, 3]."""
        n = self.size
        rng = np.random.default_rng([self.seed, 1, int(i)])
        k, dy, dx = rng.integers(0, NOISE_FIELDS), *rng.integers(0, n, 2)
        img = self._base + np.roll(self._noise[k], (dy, dx), axis=(0, 1))
        for _ in range(16):
            y0, x0 = rng.integers(0, n - n // 8, 2)
            h, w = rng.integers(n // 32, n // 8, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256, 3)
        return np.clip(img, 0, 255).astype(np.uint8)

    def images(self, first: int, count: int) -> np.ndarray:
        return np.stack([self.image(first + j) for j in range(count)])

    def prompt(self, i: int) -> str:
        """Prompt ``i``: distinct for every ``i`` below 160,000."""
        code = int(self._order[int(i) % len(self._order)])
        words = []
        for choices in WORDS:
            code, k = divmod(code, len(choices))
            words.append(choices[k])
        return "a {} {} {} {}".format(*words)

    def prompts(self, first: int, count: int) -> list:
        return [self.prompt(first + j) for j in range(count)]
