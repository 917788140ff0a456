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
    library), the two fp32 tensor-core (3xTF32) libraries ``tf32x3.cuh`` and
    through it ``hopper.cuh``; the Canny, LayerNorm and timestamp libraries
    include neither.  Every C function the wrappers call is declared."""
    by_name = {n: sorted(p.name for p in build.sources(n)) for n in build.KERNELS}
    assert by_name == {
        "conv3x3": ["conv3x3.cu", "hopper.cuh"],
        "flash_attention": ["flash_attention.cu", "hopper.cuh"],
        "group_norm": ["group_norm.cu", "hopper.cuh"],
        "conv3x3_tf32x3": ["conv3x3_tf32x3.cu", "hopper.cuh", "tf32x3.cuh"],
        "flash_attention_tf32x3": ["flash_attention_tf32x3.cu", "hopper.cuh", "tf32x3.cuh"],
        "canny": ["canny.cu"],
        "layer_norm": ["layer_norm.cu"],
        "stamp": ["stamp.cu"],
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


def test_the_cross_attention_variants_spec_is_in_step():
    """``tools/variants_flash_cross.py`` (a deeper Q ring, the exps and the
    products taken out of the cross-attention kernel) replaces text that is
    in ``csrc/flash_attention.cu``."""
    from fastedit_tpu_torch.tools import kernel_variants as kv

    spec: dict = {}
    path = Path(kv.__file__).with_name("variants_flash_cross.py")
    exec(compile(path.read_text(), str(path), "exec"), spec)
    source = (build.CSRC / f"{spec['LIBRARY']}.cu").read_text()
    assert spec["LIBRARY"] == "flash_attention" and spec["VARIANTS"]["as_built"] == []
    for name, replacements in spec["VARIANTS"].items():
        assert (kv.apply(source, replacements) != source) == bool(replacements), name


def test_the_fp32_c_functions_take_the_plans_ints():
    """The 3xTF32 conv entries take both weight copies, the channel tile and
    the grid (stride 2: its padding too; the fused conv: the prologue's scale
    and shift, the skip and the bias rows); both 3xTF32 attention entries the
    strides, the scale, a scratch pointer and the grid; every GroupNorm entry
    has a bf16 and an fp32 twin of one signature; the SIMT fp32 convs and D =
    64 attention are gone from the build, and every fp32 conv form is an
    instance of the 3xTF32 core."""
    gn = build.KERNELS["group_norm"]
    tc_conv, tc_attn = build.KERNELS["conv3x3_tf32x3"], build.KERNELS["flash_attention_tf32x3"]
    assert "conv3x3_f32" not in build.KERNELS and "flash_attention_f32" not in build.KERNELS
    for gone in ("flash_attention_f32.cu", "conv3x3_f32.cu", "simt_f32.cuh"):
        assert not (build.CSRC / gone).exists()
    assert set(tc_conv) == {"conv3x3_tf32x3_geometry", "split_tf32", "conv3x3_tf32x3",
                            "conv3x3_fused_tf32x3", "conv3x3_up2_tf32x3", "conv3x3_down2_tf32x3"}
    assert tc_conv["conv3x3_tf32x3"].count(build._I) == 8  # ..., silu, bn, grid
    assert tc_conv["conv3x3_tf32x3"].count(build._P) == 6  # x, w hi, w lo, bias, out, stream
    assert tc_conv["conv3x3_down2_tf32x3"].count(build._I) == 9  # ..., silu, pad, bn, grid
    assert tc_conv["conv3x3_down2_tf32x3"].count(build._P) == 6  # x, w hi, w lo, bias, out
    assert tc_conv["conv3x3_tf32x3_geometry"] == [build._I] * 3  # form, bn, which
    for d in (64, 512):
        entry = tc_attn[f"flash_attention_d{d}_tf32x3"]
        assert entry.count(build._L) == 6 and entry.count(build._P) == 6  # q, k, v, out, scratch
        assert tc_attn[f"flash_d{d}_tf32x3_geometry"] == [build._I]
    for name, args in gn.items():
        twin = name.replace("_bf16", "_f32") if name.endswith("_bf16") else name.replace(
            "_f32", "_bf16")
        assert gn[twin] == args
    assert not Path(build.CSRC.parent / "tools" / "variants_conv_f32.py").exists()


@pytest.mark.parametrize("symbol,tensors,ints", [
    ("conv3x3_fused_tf32x3", 7, 9),  # x, w hi, w lo, bias, scale, shift, skip; out below
    ("conv3x3_up2_tf32x3", 4, 8),  # x, w hi, w lo (the phase weights'), bias
])
def test_the_fused_and_up2_fp32_entries_take_the_plans_ints(symbol, tensors, ints):
    """The fused and the upsample conv's 3xTF32 entries: their pointers, the
    output, the shape and flags, the plan's channel tile and grid last, then
    the stream; the C signature has as many parameters, and the kernel each
    launches is the form's instance of the one core."""
    args = build.KERNELS["conv3x3_tf32x3"][symbol]
    assert args == [build._P] * (tensors + 1) + [build._I] * ints + [build._P]
    text = (build.CSRC / "conv3x3_tf32x3.cu").read_text()
    start = text.index(f'extern "C" int {symbol}(') + len(f'extern "C" int {symbol}(')
    params = [p.split()[-1] for p in text[start:text.index(")", start)].split(",")]
    assert len(params) == len(args) and params[-3:] == ["bn", "grid", "stream"]
    form = "FUSED" if "fused" in symbol else "UP2"
    kernel = symbol.replace("_tf32x3", "_tf32x3_kernel")
    assert f"conv_tiles<BN, {form}>(maps_x, map_w_hi, map_w_lo, p);" in text
    assert f"return &{kernel}<BN>;" in text
