"""``ops/build.py`` names a kernel library after everything it is compiled
from: the source, the headers of ``csrc/`` it includes (followed through)
and the flags.  Held on the CPU, without ``nvcc``: only the names are
computed here."""

import pytest

from fastedit_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n  #  include "sub/g.cuh"\n#include <cuda.h>\nint a;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "i.cuh"\n')
    (tmp_path / "i.cuh").write_text('#pragma once\n#include "h.cuh"\n')  # a cycle ends
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "g.cuh").write_text("// nothing\n")
    (tmp_path / "b.cu").write_text("int b;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_sources_follow_quoted_includes(csrc):
    names = sorted(p.relative_to(csrc).as_posix() for p in build.sources("a"))
    assert names == ["a.cu", "h.cuh", "i.cuh", "sub/g.cuh"]
    assert [p.name for p in build.sources("b")] == ["b.cu"]


@pytest.mark.parametrize("edited", ["a.cu", "h.cuh", "i.cuh", "sub/g.cuh"])
def test_an_edit_to_any_compiled_file_renames_the_library(csrc, edited):
    before_a, before_b = build.library_path("a"), build.library_path("b")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert build.library_path("a") != before_a
    assert build.library_path("b") == before_b  # b includes none of them


def test_the_flags_are_part_of_the_name(csrc, monkeypatch):
    before = build.library_path("a")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-DX",))
    assert build.library_path("a") != before


def test_the_ports_kernels_share_one_header():
    """Both Hopper kernels include ``hopper.cuh``; GroupNorm includes nothing
    of ``csrc/``.  Every C function the wrappers call is declared."""
    by_name = {n: sorted(p.name for p in build.sources(n)) for n in build.KERNELS}
    assert by_name == {
        "conv3x3": ["conv3x3.cu", "hopper.cuh"],
        "flash_attention": ["flash_attention.cu", "hopper.cuh"],
        "group_norm": ["group_norm.cu"],
    }
    for name, symbols in build.KERNELS.items():
        text = (build.CSRC / f"{name}.cu").read_text()
        for symbol in symbols:
            assert f'extern "C" int {symbol}(' in text, symbol


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_argument_counts_match_the_c_signatures(name):
    """``ctypes`` checks nothing: a wrapper that passes one int too few
    shifts every later argument.  Count the parameters of each ``extern "C"``
    function against the argument types declared for it."""
    text = (build.CSRC / f"{name}.cu").read_text()
    for symbol, argtypes in build.KERNELS[name].items():
        start = text.index(f'extern "C" int {symbol}(') + len(f'extern "C" int {symbol}(')
        params = text[start:text.index(")", start)]
        assert len([p for p in params.split(",") if p.strip()]) == len(argtypes), symbol
