"""The plain reference against the program's tiny editor on the CPU, on the
same seeded weights, scenes, prompts and seed; the controls at that size;
the reference's pieces against the program's."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import scenes, weights
from benchmark.reference import schedule, text
from benchmark.reference.pipeline import Reference, to_uint8
from fastedit_tpu_torch.pipeline.editor import FastEditor
from fastedit_tpu_torch.sched.lcm import LCMSchedulerConfig, make_schedule
from fastedit_tpu_torch.text.tokenizer import CLIPTokenizer

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 11  # more than 32 signed bits hold, as a run's seed may


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(BENCH, "tests", "fixtures", "tiny-fp32.json")) as f:
        cfg = json.load(f)
    editor = FastEditor("tiny", device="cpu", use_full_precision=True)
    weights.fill_program(editor, cfg, SEED)
    ref = Reference(cfg, weights.draw(cfg, SEED, "cpu"), "cpu")
    return cfg, editor, ref


def _edit(tiny, guidance, batch):
    cfg, editor, ref = tiny
    s = scenes.Scenes(SEED, cfg["resolution"])
    imgs, prompts = s.images(0, batch), s.prompts(0, batch)
    got = np.stack([np.asarray(im) for im in editor.edit_batch(
        imgs, prompts, guidance_scale=guidance, seed=123)])
    want = ref.edit(torch.from_numpy(imgs), prompts, guidance, 123, tile_noise=True)
    return imgs, prompts, got, want


@pytest.mark.parametrize("guidance,batch", [(1.5, 2), (1.0, 2), (1.5, 1)])
def test_reference_matches_the_tiny_editor(tiny, guidance, batch):
    _, _, got, want = _edit(tiny, guidance, batch)
    d = np.abs(got.astype(int) - to_uint8(want).numpy().astype(int))
    assert d.max() <= 1 and d.mean() < 1e-3
    assert 0.05 < (got > 0).mean() and (got < 255).mean() > 0.05  # not saturated


@pytest.mark.parametrize("mode", ["tf32", "fp8"])
def test_control_fails_the_limit(tiny, mode):
    """The reference in the precision below the configuration's reads
    above the limit the sound program reads below."""
    cfg, editor, ref = tiny
    imgs, prompts, got, want = _edit(tiny, 1.5, 2)
    ref.set_mode(mode)
    try:
        low = ref.edit(torch.from_numpy(imgs), prompts, 1.5, 123, tile_noise=True)
    finally:
        ref.set_mode("fp32")
    base = to_uint8(want).numpy().astype(int)

    def worst(x):  # the worst image's mean |difference|
        return np.abs(x.astype(int) - base).reshape(len(base), -1).mean(axis=1).max()

    assert worst(got) <= cfg["limits"]["worst_lsb"] < worst(to_uint8(low).numpy())


def test_tokens_equal_the_programs():
    s = scenes.Scenes(4, 64)
    for vocab, pad in ((49408, None), (49408, 0), (1000, 0)):
        tok = CLIPTokenizer.synthetic(vocab_size=vocab, pad_token_id=pad)
        for p in s.prompts(0, 20) + [""]:
            assert text.encode(p, vocab, pad) == tok.encode(p).tolist()


@pytest.mark.parametrize("steps,strength", [(4, 0.8), (4, 1.0), (8, 0.5)])
def test_schedule_equals_the_programs(steps, strength):
    with open(os.path.join(BENCH, "configs", "ssd1b-bf16.json")) as f:
        cfg = json.load(f)
    port = make_schedule(LCMSchedulerConfig(), steps, strength=strength)
    mine = schedule.tables(cfg["scheduler"], steps, strength)
    assert len(mine) == port.num_steps
    names = dict(t="timesteps", sqrt_a="sqrt_alpha", sqrt_1ma="sqrt_one_minus_alpha",
                 sqrt_a_prev="sqrt_alpha_prev", sqrt_1ma_prev="sqrt_one_minus_alpha_prev",
                 c_skip="c_skip", c_out="c_out")
    for i, row in enumerate(mine):
        for k, v in names.items():
            assert row[k] == float(np.float32(getattr(port, v)[i])), (i, k)
        assert row["last"] == bool(port.is_last[i])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ssd1b-bf16.sweep-b4", "ssd1b-fp32.sweep-b4-g1"])
def test_control_fails_the_limit_at_the_cells_size(workload):
    """On the card, at the cell's own sizes: the program reads within the
    configuration's limit, the control (``calibrate.py readings --control``,
    judged in the program's place) beyond it, and so does a half-batch fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import subprocess
    import sys

    root = os.path.dirname(BENCH)
    p = subprocess.run([sys.executable, "benchmark/calibrate.py", "readings", "--workload",
                        workload, "--seeds", "97", "--seconds", "3", "--control",
                        "--fault", "rows_mixed"], cwd=root,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    reading = json.loads(p.stdout.strip().splitlines()[-1])
    assert reading["program"]["correct"] is True, reading
    assert reading["control"]["correct"] is False, reading
    assert reading["rows_mixed"]["correct"] is False, reading
