"""``ops/build.py`` names a kernel library after everything it is compiled
from: the source, the headers of ``csrc/`` it includes (followed through)
and the flags.  Held on the CPU, without ``nvcc``: only the names are
computed here."""

from pathlib import Path

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
    """The three bf16 kernel libraries include ``hopper.cuh`` (GroupNorm for
    its mbarriers and 1-D bulk copies; its fp32 instances live in the same
    library), the fp32 SIMT library ``simt_f32.cuh``, the two fp32
    tensor-core (3xTF32) libraries ``tf32x3.cuh`` and through it
    ``hopper.cuh``.  Every C function the wrappers call is declared."""
    by_name = {n: sorted(p.name for p in build.sources(n)) for n in build.KERNELS}
    assert by_name == {
        "conv3x3": ["conv3x3.cu", "hopper.cuh"],
        "flash_attention": ["flash_attention.cu", "hopper.cuh"],
        "group_norm": ["group_norm.cu", "hopper.cuh"],
        "conv3x3_f32": ["conv3x3_f32.cu", "simt_f32.cuh"],
        "conv3x3_tf32x3": ["conv3x3_tf32x3.cu", "hopper.cuh", "tf32x3.cuh"],
        "flash_attention_tf32x3": ["flash_attention_tf32x3.cu", "hopper.cuh", "tf32x3.cuh"],
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


def test_the_changed_c_functions_take_the_plans_ints():
    """The upsample conv takes its channel tile and grid from the plan (eight
    ints in all), the attention call its q tile, KV tile and grid; the
    shared-memory mirrors take one int."""
    conv, attn = build.KERNELS["conv3x3"], build.KERNELS["flash_attention"]
    assert len(conv["conv3x3_up2_bf16"]) == 4 + 8 + 1  # x, folded w, bias, out; ints; stream
    assert conv["conv3x3_up2_bf16"].count(build._I) == 8
    assert conv["conv3x3_up2_smem_bytes"] == [build._I]
    assert len(attn["flash_attention_bf16"]) == 4 + 5 + 6 + 1 + 3 + 1
    assert attn["flash_attention_geometry"] == [build._I] * 3
    for lib in ("conv3x3", "flash_attention"):  # the old kernels are gone from the sources
        text = (build.CSRC / f"{lib}.cu").read_text()
        assert "mma.sync" not in text and "ldmatrix_x" not in text  # the instruction, its helper


def test_kernel_variants_replace_text_that_is_there():
    """``tools/kernel_variants.py`` builds copies of a kernel source with parts
    replaced.  A replacement whose text is gone from the source is an error,
    and the spec that ships with it is in step with the source."""
    from fastedit_tpu_torch.tools import kernel_variants as kv

    assert kv.apply("a b a", [("a", "c"), ("b", "d")]) == "c d c"
    with pytest.raises(ValueError):
        kv.apply("a b", [("x", "y")])
    spec: dict = {}
    path = Path(kv.__file__).with_name("variants_flash_d512.py")
    exec(compile(path.read_text(), str(path), "exec"), spec)
    source = (build.CSRC / f"{spec['LIBRARY']}.cu").read_text()
    assert spec["LIBRARY"] in build.KERNELS and spec["VARIANTS"]["as_built"] == []
    for name, replacements in spec["VARIANTS"].items():
        assert (kv.apply(source, replacements) != source) == bool(replacements), name
    log = ("ptxas info    : Used 168 registers\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "    16 bytes stack frame, 32 bytes spill stores, 68 bytes spill loads\n"
           "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async ...\n")
    assert len(kv.ptxas_notes(log)) == 2


def test_the_group_norm_variants_spec_is_in_step():
    """``tools/variants_group_norm.py`` (parts of the GroupNorm statistics
    kernel taken out, ``%globaltimer`` stamps) replaces text that is in
    ``csrc/group_norm.cu``."""
    from fastedit_tpu_torch.tools import kernel_variants as kv

    spec: dict = {}
    path = Path(kv.__file__).with_name("variants_group_norm.py")
    exec(compile(path.read_text(), str(path), "exec"), spec)
    source = (build.CSRC / f"{spec['LIBRARY']}.cu").read_text()
    assert spec["LIBRARY"] == "group_norm" and spec["VARIANTS"]["as_built"] == []
    for name, replacements in spec["VARIANTS"].items():
        assert (kv.apply(source, replacements) != source) == bool(replacements), name


def test_the_fp32_c_functions_take_the_plans_ints():
    """The SIMT fp32 conv entries (the fused and the upsample conv) take the
    plan's channel tile (the grid is one block per tile, computed in C); the
    3xTF32 stride-1 and stride-2 entries both weight copies, the channel tile
    and the grid (stride 2: its padding too); both 3xTF32 attention entries the
    strides, the scale, a scratch pointer and the grid; every GroupNorm entry
    has a bf16 and an fp32 twin of one signature; the SIMT fp32 source issues
    no tensor-core instruction (TF32 alone is not fp32; ``chip_smoke.py``
    counts every built kernel's HMMA and HGMMA), and the SIMT stride-1 conv and
    D = 64 attention are gone from the build."""
    conv, gn = build.KERNELS["conv3x3_f32"], build.KERNELS["group_norm"]
    tc_conv, tc_attn = build.KERNELS["conv3x3_tf32x3"], build.KERNELS["flash_attention_tf32x3"]
    assert set(conv) == {"conv3x3_f32_smem_bytes", "conv3x3_fused_f32", "conv3x3_up2_f32"}
    assert "flash_attention_f32" not in build.KERNELS
    assert not (build.CSRC / "flash_attention_f32.cu").exists()
    assert tc_conv["conv3x3_tf32x3"].count(build._I) == 8  # ..., silu, bn, grid
    assert tc_conv["conv3x3_tf32x3"].count(build._P) == 6  # x, w hi, w lo, bias, out, stream
    assert tc_conv["conv3x3_down2_tf32x3"].count(build._I) == 9  # ..., silu, pad, bn, grid
    assert tc_conv["conv3x3_down2_tf32x3"].count(build._P) == 6  # x, w hi, w lo, bias, out
    assert tc_conv["conv3x3_tf32x3_geometry"] == [build._I] * 3  # stride, bn, which
    assert conv["conv3x3_fused_f32"].count(build._P) == 8  # 7 tensors and the stream
    for d in (64, 512):
        entry = tc_attn[f"flash_attention_d{d}_tf32x3"]
        assert entry.count(build._L) == 6 and entry.count(build._P) == 6  # q, k, v, out, scratch
        assert tc_attn[f"flash_d{d}_tf32x3_geometry"] == [build._I]
    for name, args in gn.items():
        twin = name.replace("_bf16", "_f32") if name.endswith("_bf16") else name.replace(
            "_f32", "_bf16")
        assert gn[twin] == args
    text = (build.CSRC / "conv3x3_f32.cu").read_text()
    assert "mma." not in text and "mma_async" not in text  # no mma.sync, no wgmma
    assert "CONV = 0" not in text and 'extern "C" int conv3x3_f32(' not in text


def test_the_conv_f32_variants_spec_is_in_step():
    """``tools/variants_conv_f32.py`` (launch bounds of the fp32 conv kernel)
    replaces text that is in ``csrc/conv3x3_f32.cu``."""
    from fastedit_tpu_torch.tools import kernel_variants as kv

    spec: dict = {}
    path = Path(kv.__file__).with_name("variants_conv_f32.py")
    exec(compile(path.read_text(), str(path), "exec"), spec)
    source = (build.CSRC / f"{spec['LIBRARY']}.cu").read_text()
    assert spec["LIBRARY"] == "conv3x3_f32" and spec["VARIANTS"]["as_built"] == []
    for name, replacements in spec["VARIANTS"].items():
        assert (kv.apply(source, replacements) != source) == bool(replacements), name
