"""Data-parallel PIE-Bench sweep: chunks of the replica group's size (the
counterpart of the JAX package's ``parallel/batch.py``).

The reference runs a sequential single-device loop (run_batch.py:176-261).
Here the sweep runs chunks of ``group.shape["data"]`` images, one row per
replica, through ``edit_batch_async``; per-chunk and per-image error
isolation and the ``--skip_existing`` resume keep the reference's
behaviour (outputs stay keyed by the dataset-relative path).

Host work is pipelined off the card's critical path in both directions: a
loader thread decodes, LANCZOS-resizes and stages chunk i + 1 on the
devices while chunk i computes, and JPEG encodes of finished images run on
a writer pool, so finishing a chunk waits only for its copy to the host.
Across processes (``multihost.py``) every process builds the same chunk
list and saves only the rows it owns; where a tensor-parallel group spans
processes, every member of the group dispatches the group's rows and its
owner saves them.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from fastedit_tpu_torch import harness
from fastedit_tpu_torch.parallel import multihost
from fastedit_tpu_torch.utils.image import resize


def _load_chunk(padded, resolution: int, stage=None):
    """Decode+resize one padded chunk to a uint8 batch on a worker thread.

    Per-image isolation: a failed decode is recorded in ``bad`` and its slot
    filled with a neighbor image so the batch shape is unaffected (the
    slot's output is simply never saved).  Returns ``(None, bad)`` if every
    image in the chunk failed.

    When ``stage`` (editor.stage_inputs) is given, the chunk is also placed
    on the devices here on the loader thread, so chunk i + 1's upload
    overlaps chunk i's compute.
    """
    arrs: List[Optional[np.ndarray]] = []
    bad = {}
    for idx, (_, _, source_path, _) in enumerate(padded):
        try:
            img = Image.open(source_path).convert("RGB")
            arrs.append(np.asarray(resize(img, resolution), dtype=np.uint8))
        except Exception as e:  # noqa: BLE001 - per-image isolation
            bad[idx] = e
            arrs.append(None)
    fill = next((a for a in arrs if a is not None), None)
    if fill is None:
        return None, bad
    batch = np.stack([a if a is not None else fill for a in arrs])
    if stage is not None:
        try:
            return stage(batch), bad
        except Exception:  # noqa: BLE001 - staging ahead is an optimization
            # A failed upload must not kill the sweep: hand back the host
            # batch; the editor uploads it at dispatch time (losing only the
            # overlap for this chunk).
            pass
    return batch, bad


def run_batch_data_parallel(args, editor, selected: List[Tuple[str, dict]],
                            edited_dir: str, comparisons_dir: Optional[str] = None) -> int:
    """The sweep over ``editor``'s replica group; with ``comparisons_dir``
    the writer pool also draws each saved image's comparison figure there,
    as the sequential sweep does (``--save_comparisons``)."""
    group = editor.enable_data_parallel(model_parallel=getattr(args, "model_parallel", 1) or 1)
    chunk_size = int(group.shape["data"])

    multi = multihost.spans_processes(group)
    spanning = multihost.groups_span(group.world, group.local, group.model_parallel)
    # Under multi-process DP each process owns a fixed set of chunk rows (its
    # replicas'); it edits and saves exactly those, so no decoded pixels
    # ever cross processes.
    my_rows = (
        set(multihost.local_rows(group, chunk_size)) if multi
        else set(range(chunk_size))
    )

    # Resolve work items up front (skip/missing accounting identical to the
    # sequential path).  Everything deterministic from the shared mapping
    # file (path validity, empty prompts) is decided inline; filesystem
    # checks are collected as bits first because they can differ between
    # processes (each host's disk may hold only the rows it saved), and every
    # process must build the SAME chunk list, or the rows' owners diverge.
    candidates = []
    skipped = failed = 0
    for image_id, entry in selected:
        try:
            source_path = harness.safe_join(args.source_dir, entry["image_path"])
        except ValueError as e:
            print(f"Invalid path for {image_id}: {e}")
            failed += 1
            continue
        if not entry.get("editing_prompt"):
            failed += 1
            continue
        output_path = os.path.join(edited_dir, entry["image_path"])
        skip_bit = bool(args.skip_existing and os.path.exists(output_path))
        missing_bit = not os.path.exists(source_path)
        candidates.append(
            (image_id, entry, source_path, output_path, skip_bit, missing_bit)
        )
    if multi and candidates:
        # Global agreement: skip a row if ANY process already has its output
        # (it exists somewhere); treat the source as missing if it is
        # missing on ANY process (conservative but deterministic: the row's
        # owner is not known until after chunking).
        agreed = multihost.agree_bits([[c[4], c[5]] for c in candidates])
        candidates = [
            c[:4] + (bool(a[0]), bool(a[1]))
            for c, a in zip(candidates, agreed)
        ]
    work = []
    for image_id, entry, source_path, output_path, skip_bit, missing_bit in (
        candidates
    ):
        if skip_bit:
            skipped += 1
        elif missing_bit:
            failed += 1
        else:
            work.append((image_id, entry, source_path, output_path))

    chunks = [work[s : s + chunk_size] for s in range(0, len(work), chunk_size)]
    processed = 0
    done = 0
    t_sweep = time.time()
    pending = None  # (chunk, real, bad, PendingEdit): lag-1 software pipeline
    loader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="chunk-load")
    writer = ThreadPoolExecutor(max_workers=2, thread_name_prefix="chunk-save")
    save_futures = []

    def progress(n: int) -> None:
        nonlocal done
        done += n
        print(f"Editing (DP x{chunk_size}): {done}/{len(work)} images, "
              f"{time.time() - t_sweep:.2f} s", flush=True)

    def save_one(image_id, entry, source_path, output_path, img):
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        img.save(output_path)
        if comparisons_dir is None:
            return
        # A comparison failure must not mark the saved image as failed.
        try:
            cmp_path = os.path.join(
                comparisons_dir, entry["image_path"].replace(".jpg", ".png")
            )
            os.makedirs(os.path.dirname(cmp_path), exist_ok=True)
            source = Image.open(source_path).convert("RGB")
            harness.save_comparison(
                cmp_path, source, img, args.model, entry["editing_prompt"]
            )
        except Exception as e:  # noqa: BLE001 - as the sequential sweep
            print(f"\nError saving comparison for {image_id} "
                  f"({type(e).__name__}): {e}")

    def drain_saves(block: bool) -> None:
        """Tally finished writer futures so save errors (disk full, bad
        path) surface promptly during the sweep, not only at the end."""
        nonlocal processed, failed
        remaining = []
        for image_id, fut in save_futures:
            if not block and not fut.done():
                remaining.append((image_id, fut))
                continue
            try:
                fut.result()
                processed += 1
            except Exception as e:  # noqa: BLE001 - per-image isolation
                print(f"\nError saving {image_id} ({type(e).__name__}): {e}")
                failed += 1
        save_futures[:] = remaining

    def finalize(p) -> int:
        """Copy a finished chunk's images to the host; hand saves to the
        writer.

        Accounting: ``bad`` slots were load failures (already isolated);
        a device or copy failure counts only the slots not already failed;
        save failures are tallied per image as the writer futures drain
        (completed ones per chunk, the rest at the end of the sweep).
        """
        nonlocal failed
        chunk, real, bad, handle = p
        try:
            # Multi-process: only this process's rows were edited here.
            pairs = (
                handle.local_result() if multi
                else list(enumerate(handle.result()))
            )
        except Exception as e:  # chunk-level isolation
            print(f"\nError processing chunk {chunk[0][0]}.. "
                  f"({type(e).__name__}): {e}")
            failed += sum(
                1 for i in my_rows if i < real and i not in bad
            )
            return real
        for i, img in pairs:
            if i >= real or i in bad:
                continue  # padding rows / load-failed slots
            save_futures.append(
                (chunk[i][0], writer.submit(save_one, *chunk[i], img))
            )
        return real

    for ci, chunk in enumerate(chunks):
        real = len(chunk)
        padded = chunk + [chunk[-1]] * (chunk_size - real)  # pad, drop later
        if ci == 0:
            load_fut = loader.submit(
                _load_chunk, padded, editor.resolution, editor.stage_inputs
            )
        images, bad = load_fut.result()
        for idx, e in bad.items():
            if idx < real:
                print(f"\nError loading {padded[idx][0]} "
                      f"({type(e).__name__}): {e}")
                failed += 1
        if ci + 1 < len(chunks):  # prefetch chunk i+1 before dispatching i
            nxt = chunks[ci + 1]
            load_fut = loader.submit(
                _load_chunk,
                nxt + [nxt[-1]] * (chunk_size - len(nxt)),
                editor.resolution,
                editor.stage_inputs,
            )
        if images is None and spanning:
            # every member of a group must dispatch its rows (the others wait
            # in its collectives): a blank chunk, none of whose rows is saved
            images = np.zeros((chunk_size, editor.resolution, editor.resolution, 3), np.uint8)
        if images is None:  # every image in the chunk failed to load
            progress(real)
            continue
        try:
            prompts = [e["editing_prompt"] for _, e, _, _ in padded]
            # Dispatch chunk i (upload, the replicas' edits, the copy back) ...
            handle = editor.edit_batch_async(
                images,
                prompts,
                negative_prompt=args.negative_prompt,
                strength=args.strength,
                num_inference_steps=args.steps,
                guidance_scale=args.guidance,
                controlnet_conditioning_scale=args.control_scale,
                canny_low_threshold=args.canny_low,
                canny_high_threshold=args.canny_high,
                seed=args.seed,
            )
        except Exception as e:  # dispatch-side isolation (bad prompt etc.)
            print(f"\nError dispatching chunk {ci} ({type(e).__name__}): {e}")
            failed += real - sum(1 for i in bad if i < real)
            progress(real)
            continue
        # ... then wait for chunk i-1: its copy to the host streamed while
        # chunk i was uploading and computing.
        if pending is not None:
            progress(finalize(pending))
            drain_saves(block=False)
        pending = (chunk, real, bad, handle)
    if pending is not None:
        progress(finalize(pending))
    drain_saves(block=True)
    loader.shutdown()
    writer.shutdown()
    total_time = time.time() - t_sweep

    host = (
        f", process {group.rank}/{group.world}: counts are this process's rows"
        if multi else ""
    )
    print(f"\n{'='*60}\nBATCH PROCESSING SUMMARY (data-parallel{host})\n{'='*60}")
    print(f"\nProcessed:  {processed} images")
    print(f"Skipped:    {skipped} images")
    print(f"Failed:     {failed} images")
    if processed:
        print(f"\nThroughput: {processed / total_time:.2f} images/s "
              f"({total_time / processed:.2f}s/image amortized)")
        print(f"Sweep wall time (pipelined load/edit/readback): {total_time:.2f}s")
    print(f"\nOutputs saved to:\n  - Edited images: {edited_dir}")
    if comparisons_dir is not None:
        print(f"  - Comparisons: {comparisons_dir}")
    print(f"{'='*60}")
    return 0
