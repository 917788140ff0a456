"""A tensor-parallel group over processes, end to end: the counterpart of the
root ``tools/multihost_dryrun.py``.

It spawns ``--processes`` workers (they re-enter this file), joined by
``torch.distributed`` over gloo, each with ``--local_devices`` devices (on
the CPU, ``cpu`` that many times; on the card, this process's share of the
host's cards, repeated to that many: on a one-card host every worker's
devices are ``cuda:0``).  Every worker builds the same editor (the tiny
model, or SSD-1B at full width with seeded random weights, never zeros),
then, before it joins the others:

* the one-process recompute of the same layout: the in-process group over
  ``processes x local_devices`` devices with the same ``--model_parallel``,
  run eagerly (``cuda_graphs=False``);
* the same edit without tensor parallelism, eagerly.

Then it joins the process group, builds the group over every process's
devices (``FastEditor.enable_data_parallel``; unlike the JAX tool, a group
may span processes) and runs one ``edit_batch`` with a fixed seed
(``--reps`` times; ``--unseeded``: rank 0's draw) on eagerly, as such a
group runs.  Each worker checks:

* its owned rows, images and final latents, bit for bit against the
  recompute (seeded), and that every row of the batch is owned by exactly
  one process;
* that every process that computed a row computed the same image;
* the bytes it handed to its groups' all-gathers against the reckoning from
  the model's configuration (:func:`reckoned_bytes`).

It prints its rows, its bytes sent, its seconds per ``edit_batch`` and its
peak memory, writes them with the launch counts and the distances to the
edit without tensor parallelism to ``--out``/rank<r>.json, and the parent
exits 0 with a final ``OK`` line, or 1 where a worker failed or outlived
``--timeout`` (every worker is then killed).

    python -m fastedit_tpu_torch.tools.multihost_dryrun --device cpu --model tiny \\
        --processes 2 --local_devices 1 --model_parallel 2
    python -m fastedit_tpu_torch.tools.multihost_dryrun --model ssd-1b --dtype bf16 \\
        --processes 2 --local_devices 1 --model_parallel 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_RANK_ENV = "FASTEDIT_TP_DRYRUN_RANK"
ROOT = Path(__file__).resolve().parents[2]
# the edit: the editor's defaults (4 steps at strength 0.8, 3 run; CFG 1.5)
EDIT = dict(num_inference_steps=4, strength=0.8, guidance_scale=1.5)


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--local_devices", type=int, default=1)
    p.add_argument("--model_parallel", type=int, default=2,
                   help="tensor-parallel group size; may span processes")
    p.add_argument("--model", choices=("tiny", "ssd-1b"), default="tiny")
    p.add_argument("--resolution", type=int, default=None,
                   help="image side (default: the model's)")
    p.add_argument("--dtype", choices=("bf16", "fp32"), default="fp32")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--batch", type=int, default=None,
                   help="rows of the edit_batch (default: one per group)")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--unseeded", action="store_true",
                   help="edit without a seed: every member takes rank 0's draw; the "
                        "recompute is skipped, the members are held to each other")
    p.add_argument("--init_seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--reps", type=int, default=1, help="edit_batch calls over the group")
    p.add_argument("--images", type=str, default=None,
                   help=".npy of uint8 [batch, r, r, 3] (default: seeded noise images)")
    p.add_argument("--prompts", nargs="+", default=None)
    p.add_argument("--port", type=int, default=None, help="default: a free port")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", type=str, default=None, help="directory for rank<r>.json")
    return p.parse_args(argv)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_parent(args, argv) -> int:
    """Start the workers, wait for all of them, kill the rest the moment
    one fails or the time runs out."""
    port = args.port or _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.processes)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv,
                               "--port", str(port)],
                              env={**env, _RANK_ENV: str(rank)}, cwd=ROOT)
             for rank in range(args.processes)]
    deadline = time.monotonic() + args.timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank(s) {bad} exited with {[procs[r].returncode for r in bad]}"
                break
            if time.monotonic() > deadline:
                failed = f"a worker outlived the time limit of {args.timeout:.0f} s"
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if failed is None and any(rcs):
        failed = f"worker rcs {rcs}"
    if failed:
        print(f"[multihost_dryrun] FAILED: {failed}", flush=True)
        return 1
    print(f"[multihost_dryrun] OK: {args.processes} processes x {args.local_devices} "
          f"{args.device} devices, tensor-parallel x{args.model_parallel}, one edit_batch "
          "over the global group", flush=True)
    return 0


def reckoned_bytes(unet_cfg, cn_cfg, latent: int, rows: int, cfg: bool, steps: int,
                   itemsize: int, k: int, slots: int) -> int:
    """The bytes a process hands to one group's all-gathers over an edit of
    the group's ``rows`` rows: per denoise step, per transformer block of
    the UNet and of the ControlNet, one part of ``slots`` partials for each
    row-parallel layer that ``k`` splits (``to_out.0`` of both attentions
    where ``k`` divides the heads, ``ff.net.2`` where ``2 k`` divides GEGLU's
    projection), each partial ``rows x (2 under CFG) x tokens x width x
    itemsize`` at its level's tokens and width."""
    b = rows * (2 if cfg else 1)
    total = 0
    for net, up in ((unet_cfg, True), (cn_cfg.unet, False)):
        n = len(net.block_out_channels)
        depth = [sum(d) for d in net.down_transformer_layers]
        if net.mid_transformer_layers:
            depth[-1] += net.mid_transformer_layers
        if up:
            for j, d in enumerate(net.up_transformer_layers):
                depth[n - 1 - j] += sum(d)
        for i, (width, heads) in enumerate(zip(net.block_out_channels,
                                               net.num_attention_heads)):
            layers = 2 * (heads % k == 0) + ((8 * width) % (2 * k) == 0)
            total += depth[i] * layers * b * (latent >> i) ** 2 * width * itemsize * slots
    return total * steps


def _editor(args, device):
    """The editor every worker builds: the same weights on every process."""
    import torch

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.pipeline.editor import _seeded_init_

    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    if args.model == "tiny":
        editor = FastEditor("tiny", device=device, dtype=dtype, init_seed=args.init_seed)
    else:
        editor = FastEditor(args.model, device=device, dtype=dtype, random_weights=True)
        gen = torch.Generator(device=device).manual_seed(args.init_seed)
        mod = editor.modules
        for model in (mod.unet, mod.controlnet, mod.vae, mod.text_encoder, mod.text_encoder_2):
            _seeded_init_(model, gen)
    if args.resolution and args.resolution != editor.resolution:
        editor._control_res = editor._control_res * args.resolution // editor.resolution
        editor.resolution = args.resolution
    return editor


def _inputs(args, resolution: int, batch: int):
    import numpy as np

    if args.images:
        images = np.load(args.images)
        if images.shape != (batch, resolution, resolution, 3) or images.dtype != np.uint8:
            raise ValueError(f"--images holds {images.dtype} {images.shape}, expected uint8 "
                             f"{(batch, resolution, resolution, 3)}")
    else:
        rng = np.random.default_rng(0)  # the same inputs on every process
        images = rng.integers(0, 256, (batch, resolution, resolution, 3), dtype=np.uint8)
    prompts = args.prompts or [f"a photo {i}" for i in range(batch)]
    if len(prompts) != batch:
        raise ValueError(f"{len(prompts)} prompts for {batch} rows")
    return images, prompts


def _arrays(rows) -> dict:
    import numpy as np

    return {r: np.asarray(img) for r, img in rows}


def _run_worker(args, rank: int) -> None:
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.parallel import multihost, tp
    from fastedit_tpu_torch.sched.lcm import LCMSchedulerConfig, make_schedule
    from fastedit_tpu_torch.tools.inventory import launch_counts, reset_launch_counts

    world, local, k = args.processes, args.local_devices, args.model_parallel
    layout = multihost.members(world, local, k)
    batch = args.batch or len(layout)
    first = "cpu" if args.device == "cpu" else "cuda:0"
    if args.device == "cuda":
        torch.cuda.set_device(0)
    editor = _editor(args, first)
    images, prompts = _inputs(args, editor.resolution, batch)
    kw = dict(seed=None if args.unseeded else args.seed, **EDIT)
    res: dict = dict(rank=rank, world=world, local=local, model_parallel=k, batch=batch,
                     model=args.model, dtype=args.dtype, resolution=editor.resolution)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    with flags.override(cuda_graphs=False):
        ref = ref_latents = None
        if not args.unseeded:
            # the one-process recompute of the same layout, before joining
            group = editor.enable_data_parallel([first] * (world * local), model_parallel=k)
            t = time.perf_counter()
            ref = _arrays(editor.edit_batch_async(images, prompts, **kw).local_result())
            sync()
            res["one_process_s"] = time.perf_counter() - t
            ref_latents = {g: r.last_latents.cpu() for g, r in zip(group.groups, group.replicas)}
            editor._group = None
            del group
            # the same edit without tensor parallelism
            t = time.perf_counter()
            plain = np.stack([np.asarray(o) for o in editor.edit_batch(images, prompts, **kw)])
            sync()
            res["without_tp_s"] = time.perf_counter() - t
            plain_latents = editor.last_latents.cpu()
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        multihost.initialize(f"localhost:{args.port}", world, rank)
        try:
            if args.device == "cpu":
                devices = ["cpu"] * local
            else:
                share = multihost.local_devices()
                devices = [share[i % len(share)] for i in range(local)]
            t = time.perf_counter()
            group = editor.enable_data_parallel(devices, model_parallel=k)
            res["group_build_s"] = time.perf_counter() - t
            reset_launch_counts()
            seconds = []
            for _ in range(args.reps):
                t = time.perf_counter()
                handle = editor.edit_batch_async(images, prompts, **kw)
                owned, computed = handle.local_result(), handle.computed_result()
                sync()
                seconds.append(time.perf_counter() - t)
            launches = {name: n for name, n in launch_counts().items() if n}
            comms = tp.comms(m for r in group.replicas
                             for m in (r.modules.unet, r.modules.controlnet))
            sent = sum(c.bytes_sent for c in comms)
            # every row owned once, every computed row the same on every process
            digests = {r: hashlib.sha256(np.asarray(img).tobytes()).hexdigest()
                       for r, img in computed}
            everyone = [None] * world
            dist.all_gather_object(everyone, ([r for r, _ in owned], digests))
        finally:
            multihost.shutdown()

    steps = make_schedule(LCMSchedulerConfig(), EDIT["num_inference_steps"],
                          strength=EDIT["strength"]).num_steps
    per = batch // len(layout)
    itemsize = 4 if args.dtype == "fp32" else 2
    reckoned = sum(
        reckoned_bytes(editor.modules.unet.cfg, editor.modules.controlnet.config,
                       editor.resolution // 8, per, EDIT["guidance_scale"] > 1.0, steps,
                       itemsize, k,
                       max(sum(r == rr for rr, _, _ in layout[g]) for r in multihost.ranks_of(
                           layout[g])))
        for g in group.groups if len(multihost.ranks_of(layout[g])) > 1) * args.reps
    mine = {g: r for g, r in zip(group.groups, group.replicas)}
    owned_groups = [g for g in group.groups if multihost.owner(layout[g]) == rank]
    got = _arrays(owned)
    res.update(
        owned_rows=sorted(got), computed_rows=sorted(r for r, _ in computed),
        computed_sha256={str(r): d for r, d in digests.items()},
        groups=group.groups, owned_groups=owned_groups, bytes_sent=sent,
        bytes_reckoned=reckoned, seconds_per_edit_batch=seconds,
        stage_s=sum(c.stage_s for c in comms), exchange_s=sum(c.exchange_s for c in comms),
        peak_gib=(torch.cuda.max_memory_allocated() / 2**30 if args.device == "cuda" else None),
        launches=launches)
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    if got:
        mine_img = np.stack([got[r] for r in sorted(got)])
        lat = torch.cat([mine[g].last_latents.cpu().float() for g in owned_groups])
        if out:  # the owned rows, for a caller to hold against its own edits
            np.savez(out / f"rank{rank}_rows.npz", rows=np.array(sorted(got)), images=mine_img,
                     latents=lat.numpy())
    if got and ref is not None:
        diff = np.abs(mine_img.astype(np.int32) - plain[sorted(got)].astype(np.int32))
        plain_lat = torch.cat([plain_latents[g * per:(g + 1) * per].float()
                               for g in owned_groups])
        res["without_tp"] = dict(
            latent_rel_l2=float((lat - plain_lat).norm() / plain_lat.norm()),
            image_mean_abs_lsb=float(diff.mean()), image_max_abs_lsb=int(diff.max()))
        res["one_process_max_abs"] = dict(
            image_lsb=int(max(np.abs(got[r].astype(np.int32) - ref[r].astype(np.int32)).max()
                              for r in got)),
            latents=float(max((mine[g].last_latents.cpu().float()
                               - ref_latents[g].float()).abs().max() for g in owned_groups)))
    if out:
        (out / f"rank{rank}.json").write_text(json.dumps(res, indent=1))
    print(f"[multihost_dryrun] rank {rank}: owns rows {res['owned_rows']}, computed "
          f"{res['computed_rows']}; bytes sent {sent} (reckoned {reckoned}); seconds per "
          f"edit_batch {seconds}, of them staging {res['stage_s']:.3f} and all-gathers "
          f"{res['exchange_s']:.3f} in all; peak GiB {res['peak_gib']}; against one process "
          f"{res.get('one_process_max_abs')}; against no TP {res.get('without_tp')}", flush=True)

    owners = [row for rows, _ in everyone for row in rows]
    if sorted(owners) != list(range(batch)):
        raise AssertionError(f"the rows' owners over every process: {sorted(owners)}, "
                             f"expected each of {batch} rows once")
    for row in range(batch):
        seen = {d[row] for _, d in everyone if row in d}
        if len(seen) != 1:
            raise AssertionError(f"row {row}: the processes that computed it disagree")
    if sent != reckoned:
        raise AssertionError(f"rank {rank} sent {sent} bytes, the configuration reckons "
                             f"{reckoned}")
    diff = res.get("one_process_max_abs")
    if diff and (diff["image_lsb"] or diff["latents"]):
        raise AssertionError(f"rank {rank}: its rows differ from the one-process recompute: "
                             f"{diff}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse_args(argv)
    rank = os.environ.get(_RANK_ENV)
    if rank is None:
        return _spawn_parent(args, argv)
    sys.path.insert(0, str(ROOT))
    _run_worker(args, int(rank))
    return 0


if __name__ == "__main__":
    sys.exit(main())
