"""Seconds from the process's start to the window's opening: imports, the
kernel libraries, the editor, the seeded weights and the warm-up of the
cell's shapes (the captures of its CUDA graphs)."""


def read(run):
    return run.setup_s
