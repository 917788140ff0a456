"""Faults planted under the timed path, to show that ``correct`` catches
them at a cell's own size (``calibrate.py readings --fault NAME``).

Each takes the editor, breaks it where the benchmark's drivers reach it,
and returns a function that mends it.  They act at the facade's entry, so
they hold in CUDA graph replays too.
"""

from __future__ import annotations


def rows_mixed(editor):
    """Half of every dispatched batch computed for other requests: the
    first half of its rows given the prompts of its second half."""
    own = editor.__dict__.get("edit_batch_async")
    call = editor.edit_batch_async

    def edit_batch_async(images, prompts, **kw):
        p, h = list(prompts), len(prompts) // 2
        p[:h] = p[h:2 * h]
        return call(images, p, **kw)

    editor.edit_batch_async = edit_batch_async

    def mend():
        if own is None:
            del editor.edit_batch_async
        else:
            editor.edit_batch_async = own

    return mend


FAULTS = {"rows_mixed": rows_mixed}
