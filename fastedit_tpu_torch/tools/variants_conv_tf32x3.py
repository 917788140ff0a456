"""A spec for ``tools/kernel_variants.py``: the fp32 stride-1 and stride-2
convs (3xTF32 on wgmma, one core for both) as built (each tap's products
summed in fresh accumulators and added in with rounding to nearest), with
every product summed in the tile's accumulators instead
(``tensor_core_sums``), single-pass TF32 (the two small products dropped), and
(stride 1) two halo stages instead of three, which leaves room for an eighth
80-channel weight stage (``halo_stages_2``), each held against an fp64 conv on
the card beside the plain fp32 conv (TF32 off) and timed, at fp32 edit shapes
of both convs.

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_conv_tf32x3.py
"""

LIBRARY = "conv3x3_tf32x3"
_SMALL = ("          wgmma_tf32_rs(part, lo[ks], dhi + 2 * ks, ks > 0);\n"
          "          wgmma_tf32_rs(part, hi[ks], dlo + 2 * ks);\n")
_SPLIT_SUMS = (
    "        // the tap's products in a fresh accumulator, the small ones first\n"
    "#pragma unroll\n"
    "        for (int ks = 0; ks < 4; ++ks) {\n"
    + _SMALL +
    "        }\n"
    "#pragma unroll\n"
    "        for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs(part, hi[ks], dhi + 2 * ks);\n"
    "        wgmma_commit();\n"
    "        wgmma_wait<0>();  // the fragments' registers and the stages are free again\n"
    "#pragma unroll\n"
    "        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];\n")
_TENSOR_CORE_SUMS = (
    "#pragma unroll\n"
    "        for (int ks = 0; ks < 4; ++ks) {  // the small products first\n"
    "          wgmma_tf32_rs(acc, lo[ks], dhi + 2 * ks);\n"
    "          wgmma_tf32_rs(acc, hi[ks], dlo + 2 * ks);\n"
    "          wgmma_tf32_rs(acc, hi[ks], dhi + 2 * ks);\n"
    "        }\n"
    "        wgmma_commit();\n"
    "        wgmma_wait<0>();  // the fragments' registers and the stages are free again\n")
VARIANTS = {
    "as_built": [],
    "tensor_core_sums": [(_SPLIT_SUMS, _TENSOR_CORE_SUMS)],
    "halo_stages_2": [("constexpr int a_stages(bool down2) { return down2 ? 2 : 3; }",
                       "constexpr int a_stages(bool down2) { return down2 ? 2 : 2; }")],
    "single_pass": [(_SMALL, "          if (ks == 0) {\n"
                             "            for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;\n"
                             "            wgmma_fence();\n"
                             "          }\n")],
}
# (B, H, W, Cin, Cout, asymmetric): the default fp32 edit's three stride-2
# calls, and the opt-in configuration's VAE encoder call with the most channels
SHAPES = [(1, 256, 256, 96, 256, False), (2, 128, 128, 320, 320, False),
          (2, 64, 64, 640, 640, False), (1, 256, 256, 512, 512, True)]
# (B, H, W, Cin, Cout): stride-1 calls of the fp32 edit, each of the UNet's three
# widths, the tower's Cout 96 and the UNet's Cout 4 tail
STRIDE1_SHAPES = [(2, 128, 128, 320, 320), (2, 64, 64, 640, 640), (2, 32, 32, 1280, 1280),
                  (1, 256, 256, 96, 96), (2, 128, 128, 320, 4)]
ROUNDS = 2


def run(use):
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv3x3 as k
    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.tools.timing import graph_ms
    from fastedit_tpu_torch.utils.precision import true_fp32

    gen = torch.Generator(device="cuda").manual_seed(0)
    with true_fp32():
        for shape in [(*s, None) for s in STRIDE1_SHAPES] + SHAPES:
            b, h, w, cin, cout, asym = shape
            stride = 1 if asym is None else 2
            x = torch.randn((b, h, w, cin), generator=gen, device="cuda")
            wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
                  ).contiguous(memory_format=torch.channels_last)
            bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
            pad = (1, 1, 1, 1) if not asym else (0, 1, 0, 1)
            ref = F.conv2d(F.pad(x.double().permute(0, 3, 1, 2), pad), wt.double(), stride=stride)
            ref = (ref.permute(0, 2, 3, 1) + bias.double()).float().double()
            if stride == 1:
                plain_out = k.conv3x3_plain(x, wt, bias)
            else:
                plain_out = cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asym)
            plain = float((plain_out.double() - ref).abs().max())
            flops = 2.0 * b * (h // stride) * (w // stride) * cout * 9 * cin
            print(f"shape {shape[:5]} stride {stride}{' (0, 1)' if asym else ''}: plain fp32 "
                  f"max|err| vs fp64 {plain:.3e}", flush=True)
            for _ in range(ROUNDS):
                for name in use.names:
                    use(name)
                    w_split = cf.split_tf32(wt)
                    if stride == 1:
                        def call():
                            return k.conv3x3(x, wt, bias, w_split=w_split)
                    else:
                        def call():
                            return cf.conv3x3_down2(x, wt, bias, asymmetric=asym,
                                                    w_split=w_split)
                    err = float((call().double() - ref).abs().max())
                    ms = graph_ms(call, reps=3, calls=10)
                    print(f"  {name:16s} max|err| {err:.3e} = {err / plain:7.2f} x plain  "
                          f"{ms:.4f} ms  {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
