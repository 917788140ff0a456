"""PIE-Bench harness: mapping-file handling, selection, results artifacts
(a copy of the JAX package's ``harness.py``).

The CLIs share these helpers: the mapping file, ``safe_join``, entry
selection, ``metrics.csv`` and ``summary.json`` (the same columns and
schema, byte for byte, so either package's results directories compare
directly), the ``{model}_{fp16|fp32}`` suffixes, and the device an entry
point runs on.  One function differs: :func:`save_comparison` draws its
two panels with PIL, since the card's machine has no matplotlib.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

METRIC_NAMES = ("ssim", "lpips", "clip_score", "psnr", "mse", "dino_distance")
CSV_FIELDS = (
    "image_id",
    "image_path",
    "editing_type_id",
    "editing_prompt",
) + METRIC_NAMES


def entry_device(requested: Optional[str] = None) -> Optional[str]:
    """The device an entry point runs on: ``"cpu"`` where the caller asks
    for it through ``FASTEDIT_PLATFORM=cpu`` (the JAX package's switch),
    else ``requested`` (``None``: the card).  Any other value of
    ``FASTEDIT_PLATFORM`` raises: the port runs on the card or, when asked,
    on the CPU, and on nothing else."""
    platform = os.environ.get("FASTEDIT_PLATFORM", "")
    if platform not in ("", "cpu"):
        raise ValueError(
            f"FASTEDIT_PLATFORM={platform!r}: the PyTorch port runs on the CUDA card "
            "by default; set FASTEDIT_PLATFORM=cpu for the CPU, or leave it unset"
        )
    return "cpu" if platform == "cpu" else requested


def load_mapping(mapping_path: str) -> Dict[str, dict]:
    """Load a PIE-Bench mapping_file.json: {image_id: {image_path,
    editing_prompt, editing_type_id, ...}}."""
    with open(mapping_path, "r") as f:
        return json.load(f)


def safe_join(base_dir: str, user_path: str) -> str:
    """Join a dataset-relative path onto base_dir, rejecting traversal."""
    norm = os.path.normpath(user_path)
    if os.path.isabs(norm) or norm.startswith(".."):
        raise ValueError(f"Invalid path: {user_path}")
    full = os.path.abspath(os.path.join(base_dir, norm))
    if not full.startswith(os.path.abspath(base_dir)):
        raise ValueError(f"Path traversal detected: {user_path}")
    return full


def select_entries(
    mapping: Dict[str, dict],
    image_ids: Optional[Sequence[str]] = None,
    editing_types: Optional[Sequence[str]] = None,
    num_images: Optional[int] = None,
) -> List[Tuple[str, dict]]:
    """Filter mapping entries by explicit ids, else by editing type + count."""
    if image_ids:
        return [(i, mapping[i]) for i in image_ids if i in mapping]
    if editing_types:
        selected = [
            (i, e)
            for i, e in mapping.items()
            if e.get("editing_type_id") in set(editing_types)
        ]
    else:
        selected = list(mapping.items())
    if num_images is not None and num_images < len(selected):
        selected = selected[:num_images]
    return selected


def write_metrics_csv(path: str, rows: Iterable[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(CSV_FIELDS))
        writer.writeheader()
        writer.writerows(rows)


def _stats(values: Sequence[float], with_median: bool) -> dict:
    out = {"mean": float(np.mean(values)), "std": float(np.std(values))}
    if with_median:
        out["median"] = float(np.median(values))
    return out


def summarize(rows: Sequence[dict]) -> dict:
    """summary.json schema: total_images + overall mean/std/median + per
    editing-type-category mean/std (+count), the reference evaluate.py's."""
    summary = {
        "total_images": len(rows),
        "overall": {
            m: _stats([r[m] for r in rows], with_median=True) for m in METRIC_NAMES
        },
        "by_category": {},
    }
    categories: Dict[str, List[dict]] = {}
    for r in rows:
        categories.setdefault(str(r["editing_type_id"]), []).append(r)
    for cat, cat_rows in categories.items():
        summary["by_category"][cat] = {
            "count": len(cat_rows),
            **{
                m: _stats([r[m] for r in cat_rows], with_median=False)
                for m in METRIC_NAMES
            },
        }
    return summary


def write_summary(path: str, summary: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)


def model_suffix(model: str, full_precision: bool) -> str:
    """Output-directory naming shared by all CLIs: {model}_{fp16|fp32}
    (bf16 fills the reference's "fp16" slot; the naming is kept)."""
    return f"{model}_{'fp32' if full_precision else 'fp16'}"


def detect_model_suffix(outputs_dir: str) -> Optional[str]:
    """Recover '{model}_{precision}' from an outputs dir path tail."""
    tail = os.path.basename(outputs_dir.rstrip("/"))
    parts = tail.rsplit("_", 1)
    if len(parts) == 2 and parts[1] in ("fp16", "fp32"):
        return tail
    return None


PANEL = 768  # a panel's image side in pixels
MARGIN = 24


def panel_figure(panels: Sequence[Tuple[str, Image.Image]],
                 suptitle: Optional[str] = None) -> Image.Image:
    """Panels side by side on white, each image fitted into a
    ``PANEL``-pixel square under its (multi-line) title, and ``suptitle``
    above them all: the layout of the matplotlib figures the JAX package
    draws, in PIL alone."""
    font = ImageFont.load_default()
    measure = ImageDraw.Draw(Image.new("RGB", (1, 1)))

    def height(text: str) -> int:
        if not text:
            return 0
        box = measure.multiline_textbbox((0, 0), text, font=font, align="center")
        return box[3] - box[1] + MARGIN // 2

    title_h = max(height(title) for title, _ in panels)
    top = MARGIN + (height(suptitle) if suptitle else 0)
    fig = Image.new("RGB", (len(panels) * (PANEL + MARGIN) + MARGIN,
                            top + title_h + PANEL + MARGIN), "white")
    draw = ImageDraw.Draw(fig)
    if suptitle:
        draw.multiline_text((fig.width // 2, MARGIN), suptitle, fill="black", font=font,
                            anchor="ma", align="center")
    for i, (title, img) in enumerate(panels):
        x = MARGIN + i * (PANEL + MARGIN)
        draw.multiline_text((x + PANEL // 2, top), title, fill="black", font=font,
                            anchor="ma", align="center")
        shown = (img if isinstance(img, Image.Image)
                 else Image.fromarray(np.asarray(img, dtype=np.uint8))).convert("RGB")
        scale = PANEL / max(shown.size)
        shown = shown.resize((max(1, round(shown.width * scale)),
                              max(1, round(shown.height * scale))), Image.LANCZOS)
        fig.paste(shown, (x + (PANEL - shown.width) // 2, top + title_h))
    return fig


def save_comparison(
    path: str, source, edited, model: str, prompt: str
) -> None:
    """Two-panel source/edited PNG in the reference layout: the source left,
    the edited image right, titled with the model and the prompt (cut at 60
    characters)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    short = prompt if len(prompt) <= 60 else prompt[:60] + "..."
    panel_figure([("Source Image", source),
                  (f'Edited ({model.upper()})\n"{short}"', edited)]).save(path)
