"""Tensor-parallel groups that span processes, on the CPU with the tiny model
(``parallel/multihost.members``, ``parallel/tp.GroupComm``,
``tools/multihost_dryrun.py``).

The layout against the JAX package: for layouts where ``k`` divides a
process's devices, where the device count divides ``k``, and where neither
does, each rank's owned rows equal ``fastedit_tpu.parallel.multihost.local_rows``
on a ``make_mesh``-shaped grid of fake devices that carry ``process_index``,
and the members of each group are the grid's row.  Then, in processes joined
over gloo (every spawn under a time limit that fails the test, the workers
killed with it): two processes of one device each as one group of two, whose
owner's images and final latents equal the in-process ``["cpu", "cpu"]``
group's bit for bit (which ``tests/test_torch_tp.py`` holds to the JAX
package's TP edit), whose other member owns no row but computed the same
image, and whose bytes sent equal the reckoning for the tiny model; the
unseeded edit, on rank 0's draw in both; two processes of three devices
(``k = 2``: a process holds one group and half of another) against the
in-process group over six; members with different weights, which raise
naming the rank; parts of unequal size (three processes of two devices,
``k = 3``: one member holds two shards of a group, the other one, padded
to two); and ``run_batch --num_processes 2 --model_parallel 2`` against the
one-process ``--model_parallel 2`` sweep, byte for byte.
"""

import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fastedit_tpu.parallel import multihost as jmultihost

from fastedit_tpu_torch.parallel import multihost
from fastedit_tpu_torch.parallel.replicas import ReplicaGroup
from fastedit_tpu_torch.tools import make_demo_data
from fastedit_tpu_torch.tools.multihost_dryrun import reckoned_bytes
from fastedit_tpu_torch.models import configs as C

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                FASTEDIT_PLATFORM="cpu")


@pytest.mark.parametrize("world,local,k", [
    (2, 1, 2), (4, 1, 2), (2, 2, 4),  # a group spans whole processes
    (2, 3, 2), (3, 2, 3), (3, 4, 6),  # a process holds parts of two groups
    (2, 2, 2), (1, 4, 2),  # every group in one process
])
def test_layout_matches_jax(monkeypatch, world, local, k):
    devices = np.array([types.SimpleNamespace(process_index=r)
                        for r in range(world) for _ in range(local)])
    grid = devices.reshape(world * local // k, k)  # make_mesh's row-major grid
    mesh = types.SimpleNamespace(shape={"data": grid.shape[0]}, devices=grid)
    layout = multihost.members(world, local, k)
    assert [[r for r, _, _ in m] for m in layout] == [[d.process_index for d in row]
                                                      for row in grid]
    assert all([s for _, _, s in m] == list(range(k)) for m in layout)
    for batch in (grid.shape[0], 2 * grid.shape[0]):
        owners = []
        for rank in range(world):
            monkeypatch.setattr(jmultihost.jax, "process_index", lambda rank=rank: rank)
            mine = [g for g, m in enumerate(layout) if rank in multihost.ranks_of(m)]
            group = ReplicaGroup([object()] * len(mine), rank, world, k, local=local,
                                 groups=mine)
            assert group.shape == {"data": grid.shape[0], "model": k}
            rows = multihost.local_rows(group, batch)
            assert rows == jmultihost.local_rows(mesh, batch)
            assert set(rows) <= set(multihost.computed_rows(group, batch))
            owners += rows
        assert sorted(owners) == list(range(batch))  # every row saved once
    assert multihost.groups_span(world, local, k) == any(
        len({d.process_index for d in row}) > 1 for row in grid)
    with pytest.raises(ValueError, match="does not divide"):
        multihost.members(world, local, world * local + 1)


def _dryrun(tmp_path, *argv) -> list:
    """``tools/multihost_dryrun.py`` on the CPU; each rank's JSON."""
    out = tmp_path / "dryrun"
    proc = subprocess.run(
        [sys.executable, "-m", "fastedit_tpu_torch.tools.multihost_dryrun", "--device", "cpu",
         "--model", "tiny", "--timeout", str(SPAWN_TIMEOUT_S - 20), "--out", str(out), *argv],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("[multihost_dryrun] OK")
    return [json.loads(p.read_text()) for p in sorted(out.glob("rank*.json"),
                                                      key=lambda p: int(p.stem[4:]))]


def test_two_processes_edit_as_the_in_process_group(tmp_path):
    owner, other = _dryrun(tmp_path, "--processes", "2", "--local_devices", "1",
                           "--model_parallel", "2", "--dtype", "fp32")
    assert owner["owned_rows"] == [0] and owner["computed_rows"] == [0]
    assert owner["one_process_max_abs"] == {"image_lsb": 0, "latents": 0.0}
    assert other["owned_rows"] == [] and other["computed_rows"] == [0]
    assert other["computed_sha256"] == owner["computed_sha256"]
    # tiny at 64² (latents 8²), CFG (2 rows), 3 steps run of 4 at strength 0.8, fp32:
    # level 1 (16 tokens x 64) holds 3 UNet + 1 ControlNet blocks, level 2 (4 x 128)
    # 7 + 3; three row-parallel layers a block
    want = 3 * (4 * 3 * 2 * 16 * 64 * 4 + 10 * 3 * 2 * 4 * 128 * 4)
    assert want == 663552 == reckoned_bytes(C.TINY_UNET, C.TINY_CONTROLNET, 8, 1, True, 3, 4,
                                            2, 1)
    assert owner["bytes_sent"] == other["bytes_sent"] == want
    assert owner["without_tp"]["image_max_abs_lsb"] <= 1


def test_the_unseeded_edit_takes_rank_0s_draw(tmp_path):
    ranks = _dryrun(tmp_path, "--processes", "2", "--local_devices", "1", "--model_parallel",
                    "2", "--unseeded", "--batch", "2")
    assert [r["owned_rows"] for r in ranks] == [[0, 1], []]
    assert ranks[0]["computed_sha256"] == ranks[1]["computed_sha256"]
    assert len(set(ranks[0]["computed_sha256"].values())) == 2  # untiled: the rows differ


def test_a_process_holding_one_group_and_half_of_another(tmp_path):
    ranks = _dryrun(tmp_path, "--processes", "2", "--local_devices", "3", "--model_parallel",
                    "2", "--batch", "3")
    assert [r["owned_rows"] for r in ranks] == [[0, 1], [2]]
    assert [r["computed_rows"] for r in ranks] == [[0, 1], [1, 2]]
    assert [r["groups"] for r in ranks] == [[0, 1], [1, 2]]
    assert ranks[0]["computed_sha256"]["1"] == ranks[1]["computed_sha256"]["1"]
    for r in ranks:
        assert r["one_process_max_abs"] == {"image_lsb": 0, "latents": 0.0}
        assert r["bytes_sent"] == r["bytes_reckoned"] > 0


def _spawn(code: str, world: int, *args) -> list:
    """``python -c code <port> <rank> args`` for every rank; their outputs."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(port), str(rank), *map(str, args)],
                              env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, [o[-3000:] for o in outs]
    return outs


DIFFERENT_WEIGHTS = """
import sys, torch
from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch.parallel import multihost
port, rank = sys.argv[1], int(sys.argv[2])
editor = FastEditor("tiny", device="cpu", dtype=torch.float32, init_seed=rank)
multihost.initialize(f"localhost:{port}", 2, rank)
try:
    editor.enable_data_parallel(["cpu"], model_parallel=2)
except ValueError as e:
    print("RAISED", e)
finally:
    multihost.shutdown()
"""


def test_members_with_different_weights_raise_naming_the_rank():
    for out in _spawn(DIFFERENT_WEIGHTS, 2):
        assert "RAISED" in out and "rank(s) [1]" in out, out[-2000:]


UNEQUAL_PARTS = """
import sys, torch
from fastedit_tpu_torch.models.layers import Attention, FeedForward
from fastedit_tpu_torch.parallel import multihost, tp
port, rank = sys.argv[1], int(sys.argv[2])
torch.manual_seed(0)
attn, ff = Attention(48, 6, 8, context_dim=40), FeedForward(48)
x, ctx = torch.randn(2, 10, 48), torch.randn(2, 7, 40)
want = [tp.TPAttention(attn, ["cpu"] * 3)(x, ctx), tp.TPFeedForward(ff, ["cpu"] * 3)(x)]
multihost.initialize(f"localhost:{port}", 3, rank)
layout = multihost.members(3, 2, 3)
pgs = multihost.subgroups(3, 2, 3, rank)
for g in sorted(pgs):
    comm = tp.GroupComm(pgs[g], layout[g], rank)
    place = tp.Placement(3, tuple((s, "cpu") for r, _, s in layout[g] if r == rank), comm)
    got = [tp.TPAttention(attn, place)(x, ctx), tp.TPFeedForward(ff, place)(x)]
    assert all(torch.equal(a, b) for a, b in zip(got, want)), g
    assert comm.slots == 2 and comm.bytes_sent == 2 * 2 * 2 * 10 * 48 * 4, comm.bytes_sent
    print("GROUP", g, place.shards)
multihost.shutdown()
"""


def test_parts_of_unequal_size_are_padded():
    """Three processes of two devices, groups of three: rank 0 holds shards 0
    and 1 of group 0, rank 1 shard 2 of it and shard 0 of group 1, rank 2
    shards 1 and 2 of group 1; each part padded to two slots."""
    outs = _spawn(UNEQUAL_PARTS, 3)
    assert ["GROUP" in o for o in outs] == [True] * 3
    assert "GROUP 0 [0, 1]" in outs[0]
    assert "GROUP 0 [2]" in outs[1] and "GROUP 1 [0]" in outs[1]
    assert "GROUP 1 [1, 2]" in outs[2]


def _decoded(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.jpg"))}


def test_run_batch_over_two_processes_with_a_group_across_them(tmp_path):
    demo = tmp_path / "demo"
    make_demo_data.main(["--out", str(demo), "--n", "3", "--size", "64"])
    common = ["--mapping_file", str(demo / "mapping_file.json"),
              "--source_dir", str(demo / "annotation_images"), "--model", "tiny",
              "--seed", "5", "--model_parallel", "2"]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fastedit_tpu_torch.run_batch", *common,
         "--output_dir", str(tmp_path / "two"), "--num_processes", "2", "--process_id",
         str(rank), "--coordinator_address", f"localhost:{port}"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[-3000:] for o in outs]
    # one group over both processes: rank 0 owns and saves every row
    assert [int(o.split("Processed:  ")[1].split(" ")[0]) for o in outs] == [3, 0]
    one = subprocess.run([sys.executable, "-m", "fastedit_tpu_torch.run_batch", *common,
                          "--output_dir", str(tmp_path / "one")], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert one.returncode == 0, one.stdout[-3000:]
    sub = Path("batch") / "edited" / "tiny_fp16"
    got, ref = _decoded(tmp_path / "two" / sub), _decoded(tmp_path / "one" / sub)
    assert len(got) == 3 and got == ref
    assert all(np.asarray(Image.open(tmp_path / "two" / sub / rel)).shape == (64, 64, 3)
               for rel in got)
