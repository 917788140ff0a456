"""The multi-process sweep of the port: ``run_batch`` as two processes joined
by ``torch.distributed`` over gloo, on the CPU (the tiny model, four 64²
demo images, one output planted beforehand, one replica per process), as
``tests/test_multihost.py`` runs the JAX package's.  Both ranks exit 0 and
skip the planted row; the three fresh rows form chunks of two, one row per
process: rank 0 saves rows 0 and 2, rank 1 row 1 (the padding row of the
last chunk is dropped), so they process [1, 2]; and the images equal the
single-process sweep's bit for bit (a seeded sweep gives every row the
same noise stream, and each process edits its rows at batch 1).

Also the row ownership against the JAX package's ``multihost.local_rows``,
and a group that holds one rank of two: its ``local_result`` is its own
rows, equal to one editor's, and ``result`` refuses the batch it lacks.
The device choice: the processes of a host split its cards (two gloo
processes each take half of four), and a process never holds another's
share.  The dispatch: a process's only replica runs on the calling thread,
several replicas each on a worker thread of its own, kept from call to
call, under the caller's kernel flags.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from fastedit_tpu.parallel import multihost as jmultihost

from fastedit_tpu_torch import run_batch as trun_batch
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.parallel import multihost
from fastedit_tpu_torch.parallel.replicas import ReplicaGroup
from fastedit_tpu_torch.pipeline.editor import FastEditor, PendingEdit
from fastedit_tpu_torch.tools import make_demo_data

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model gains nothing from more, and the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _decoded(root: Path) -> dict:
    return {str(p.relative_to(root)): np.asarray(Image.open(p))
            for p in sorted(root.rglob("*.jpg"))}


def test_two_process_sweep_saves_every_row(tmp_path, monkeypatch):
    demo, out = tmp_path / "demo", tmp_path / "out"
    make_demo_data.main(["--out", str(demo), "--n", "4", "--size", "64"])
    mapping = json.loads((demo / "mapping_file.json").read_text())
    sub = Path("batch") / "edited" / "tiny_fp16"
    planted = out / sub / next(iter(mapping.values()))["image_path"]
    planted.parent.mkdir(parents=True)
    planted.write_bytes(b"placeholder")
    common = ["--mapping_file", str(demo / "mapping_file.json"),
              "--source_dir", str(demo / "annotation_images"), "--model", "tiny",
              "--seed", "7", "--guidance", "1.0"]
    env = dict(os.environ, FASTEDIT_PLATFORM="cpu", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")  # the two processes share the cores
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fastedit_tpu_torch.run_batch", *common,
         "--output_dir", str(out), "--skip_existing", "--coordinator_address",
         f"localhost:{port}", "--num_processes", "2", "--process_id", str(rank)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[-3000:] for o in outs]
    for o in outs:
        assert "Skipped:    1 images" in o, o[-2000:]
    assert [int(o.split("Processed:  ")[1].split(" ")[0]) for o in outs] == [2, 1]
    assert planted.read_bytes() == b"placeholder"
    planted.unlink()

    monkeypatch.setenv("FASTEDIT_PLATFORM", "cpu")
    assert trun_batch.main([*common, "--output_dir", str(tmp_path / "single")]) == 0
    got, ref = _decoded(out / sub), _decoded(tmp_path / "single" / sub)
    assert len(got) == 3 and set(got) < set(ref)
    for rel, img in got.items():
        np.testing.assert_array_equal(img, ref[rel], err_msg=rel)


@pytest.mark.parametrize("world,local,batch", [(1, 1, 1), (1, 4, 8), (2, 1, 2), (2, 2, 4),
                                               (4, 2, 16), (3, 1, 3)])
def test_local_rows_match_jax(monkeypatch, world, local, batch):
    """Rank r of ``world`` processes with ``local`` replicas each owns the
    rows the JAX package's ``P('data')`` sharding gives process r's devices
    (mesh order: process 0's devices first)."""
    devices = np.array([[types.SimpleNamespace(process_index=r)]
                        for r in range(world) for _ in range(local)])
    mesh = types.SimpleNamespace(shape={"data": world * local}, devices=devices)
    for rank in range(world):
        monkeypatch.setattr(jmultihost.jax, "process_index", lambda rank=rank: rank)
        group = ReplicaGroup([object()] * local, rank=rank, world=world)
        assert multihost.local_rows(group, batch) == jmultihost.local_rows(mesh, batch)
        assert multihost.spans_processes(group) == (world > 1)


def test_one_rank_of_two_holds_its_own_rows():
    editor = FastEditor("tiny", device="cpu")
    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
              for _ in range(2)]
    prompts = ["a cat", "a dog"]
    ref = editor.edit_batch(images[1:], prompts[1:], seed=3)[0]
    editor._group = ReplicaGroup([editor], rank=1, world=2)
    pending = editor.edit_batch_async(images, prompts, seed=3)
    ((row, img),) = pending.local_result()
    assert row == 1
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))
    with pytest.raises(RuntimeError, match="local_result"):
        pending.result()
    assert multihost.rank_and_world() == (0, 1)


@pytest.mark.parametrize("cards,local_world,shares", [
    (1, 1, [[0]]),
    (1, 2, [[0], [0]]),  # the two processes of a one-card host share it
    (4, 1, [[0, 1, 2, 3]]),
    (4, 2, [[0, 1], [2, 3]]),
    (4, 4, [[0], [1], [2], [3]]),
    (4, 3, [[0], [1], [2]]),  # a card left over stays idle
    (2, 3, [[0], [1], [0]]),
    (8, 4, [[0, 1], [2, 3], [4, 5], [6, 7]]),
])
def test_processes_of_a_host_share_its_cards(cards, local_world, shares):
    got = [multihost.share_cards(cards, r, local_world) for r in range(local_world)]
    assert got == shares
    assert multihost.layout([("h", cards)] * local_world) == shares


def test_layout_over_hosts():
    """Ranks share the cards of the host they name, in rank order; hosts
    that would give processes different replica counts are refused."""
    hosts = [("a", 4), ("b", 4), ("a", 4), ("b", 4)]
    assert multihost.layout(hosts) == [[0, 1], [0, 1], [2, 3], [2, 3]]
    with pytest.raises(ValueError, match="replicas"):
        multihost.layout([("a", 4), ("b", 2)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.layout([("a", 0)])


def test_two_processes_take_their_own_cards():
    """Two gloo processes on one host, four cards between them: each takes
    its half (``local_devices`` gathers every rank's host and card count)."""
    code = ("import sys; from fastedit_tpu_torch.parallel import multihost as m; "
            "m.initialize(sys.argv[1], 2, int(sys.argv[2])); "
            "print('CARDS', [d.index for d in m.local_devices(cards=4)]); m.shutdown()")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, f"localhost:{port}", str(rank)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.split("CARDS ")[1].strip() for o in outs] == ["[0, 1]", "[2, 3]"]


class _Replica:
    """A stand-in replica: records the thread and the kernel flags each
    dispatch ran under, and returns its rows' first indices as images."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def _dispatch(self, part, prompts, kw, first_row=0):
        self.calls.append((threading.current_thread(), flags.current().plain_versions))
        rows = torch.arange(first_row, first_row + len(prompts), dtype=torch.uint8)
        return PendingEdit(rows.view(-1, 1, 1, 1).expand(-1, 2, 2, 3).contiguous(), first_row)


@pytest.mark.parametrize("n", [1, 3])
def test_replica_dispatch_threads(n):
    replicas = [_Replica() for _ in range(n)]
    group = ReplicaGroup(replicas)
    images = np.zeros((2 * n, 2, 2, 3), np.uint8)
    for _ in range(2):
        with flags.override(plain_versions=True):
            out = group.edit_batch_async(images, ["p"] * 2 * n, {}).result()
        assert [np.asarray(img)[0, 0, 0] for img in out] == list(range(2 * n))
    threads = [{t for t, _ in r.calls} for r in replicas]
    assert all(len(r.calls) == 2 and all(p for _, p in r.calls) for r in replicas)
    assert all(len(t) == 1 for t in threads)  # one thread per replica, kept
    if n == 1:
        assert threads[0] == {threading.current_thread()}
    else:
        assert len(set.union(*threads)) == n
        assert threading.current_thread() not in set.union(*threads)
