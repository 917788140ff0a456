"""A spec for ``tools/kernel_variants.py``: the fp32 convs (3xTF32 on wgmma, one
core for the stride-1, fused, upsample and stride-2 forms) as built (each
tap's products summed in fresh accumulators and added in with rounding to
nearest), with every product summed in the tile's accumulators instead
(``tensor_core_sums``, every form), single-pass TF32 (the two small products
dropped), two halo stages instead of three, which leaves room for an eighth
80-channel weight stage (``halo_stages_2``), the fused prologue applied to the
consumers' fragments once per tap instead of once per staged element by the
prologue warps (``prologue_in_registers``), and the upsample conv's next halo
asked for after the first of its four taps' weights instead of the third
(``up2_window_at_tap_1``), each held against an fp64 conv on the card beside
the plain fp32 version (TF32 off) and timed, at fp32 edit shapes of every
form.

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
# The prologue warps only arrive; each consumer thread maps the values of its
# fragments, in-image pixels and channels below Cin, as it loads them.
_XFORM = "          if (ch < p.Cin) {  // channels past Cin stay the zeros TMA wrote\n"
_SPLIT = "            split(v, hi[ks][e], lo[ks][e]);\n"
_SPLIT_MAPPED = (
    "            if (prenorm) {\n"
    "              const int hy = pix / HALO_W, hx = pix - hy * HALO_W;\n"
    "              const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;\n"
    "              const int ch = c * KC + 8 * ks + q + 4 * (e >> 1);\n"
    "              if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && ch < p.Cin)\n"
    "                v = silu_f(fmaf(v, __ldg(p.scale + (long long)b * p.Cin + ch),\n"
    "                                __ldg(p.shift + (long long)b * p.Cin + ch)));\n"
    "            }\n" + _SPLIT)
VARIANTS = {
    "as_built": [],
    "tensor_core_sums": [(_SPLIT_SUMS, _TENSOR_CORE_SUMS)],
    "halo_stages_2": [("constexpr int a_stages(int form) { return form == DOWN2 ? 2 : 3; }",
                       "constexpr int a_stages(int form) { return form == DOWN2 ? 2 : 2; }")],
    "single_pass": [(_SMALL, "          if (ks == 0) {\n"
                             "            for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;\n"
                             "            wgmma_fence();\n"
                             "          }\n")],
    "prologue_in_registers": [(_XFORM, "          if (false) {\n"), (_SPLIT, _SPLIT_MAPPED)],
    "up2_window_at_tap_1": [
        ("constexpr int ask_tap(int form) { return form == UP2 ? 3 : 1; }",
         "constexpr int ask_tap(int form) { return form == UP2 ? 1 : 1; }")],
}
# (form, B, H, W, Cin, Cout): the default fp32 edit's stride-1 calls at each of
# the UNet's three widths, the tower's Cout 96 and the UNet's Cout 4 tail; its
# three stride-2 calls and the VAE encoder's stride-2 conv with the most
# channels (a shape the plan leaves to cuDNN); the VAE decoder's fused calls
# at each of its widths (with the skip) and the UNet's and the VAE's upsample
# calls at their widest and largest
SHAPES = [("conv", 2, 128, 128, 320, 320), ("conv", 2, 64, 64, 640, 640),
          ("conv", 2, 32, 32, 1280, 1280), ("conv", 1, 256, 256, 96, 96),
          ("conv", 2, 128, 128, 320, 4),
          ("down2", 1, 256, 256, 96, 256), ("down2", 2, 128, 128, 320, 320),
          ("down2", 2, 64, 64, 640, 640), ("down2_asym", 1, 256, 256, 512, 512),
          ("fused", 1, 128, 128, 512, 512), ("fused", 1, 512, 512, 256, 256),
          ("fused", 1, 1024, 1024, 128, 128),
          ("up2", 2, 32, 32, 1280, 1280), ("up2", 1, 512, 512, 256, 256)]
ROUNDS = 2


def run(use):
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv3x3 as k
    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.ops import tf32x3
    from fastedit_tpu_torch.tools.timing import graph_ms
    from fastedit_tpu_torch.utils.precision import true_fp32

    gen = torch.Generator(device="cuda").manual_seed(0)
    with true_fp32():
        for form, b, h, w, cin, cout in SHAPES:
            x = torch.randn((b, h, w, cin), generator=gen, device="cuda")
            wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
                  ).contiguous(memory_format=torch.channels_last)
            bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
            pre = (torch.rand((b, cin), generator=gen, device="cuda") + 0.5,
                   torch.randn((b, cin), generator=gen, device="cuda") * 0.5)
            skip = torch.randn((b, h, w, cout), generator=gen, device="cuda")
            asym = form == "down2_asym"
            x64, w64 = x.double().permute(0, 3, 1, 2), wt.double()
            if form == "conv":
                ref = F.conv2d(x64, w64, padding=1)
                plain_out, flops = k.conv3x3_plain(x, wt, bias), 9 * b * h * w
            elif form == "fused":
                xin = F.silu(x64 * pre[0].double()[:, :, None, None]
                             + pre[1].double()[:, :, None, None])
                ref = F.conv2d(xin, w64, padding=1)
                plain_out = cf.conv3x3_fused_plain(x, wt, bias, pre, skip=skip)
                flops = 9 * b * h * w
            elif form == "up2":
                up = x64.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                ref = F.conv2d(up, w64, padding=1)
                plain_out, flops = cf.conv3x3_up2_plain(x, wt, bias), 16 * b * h * w
            else:
                pad = (0, 1, 0, 1) if asym else (1, 1, 1, 1)
                ref = F.conv2d(F.pad(x64, pad), w64, stride=2)
                plain_out = cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asym)
                flops = 9 * b * (h // 2) * (w // 2)
            ref = ref.permute(0, 2, 3, 1) + bias.double()
            if form == "fused":
                ref = ref + skip.double()
            plain = float((plain_out.double() - ref).abs().max())
            flops *= 2.0 * cin * cout
            single = {"conv": lambda: tf32x3.conv3x3_plain(x, wt, bias, passes=1),
                      "fused": lambda: tf32x3.conv3x3_fused_plain(x, wt, bias, pre, skip=skip,
                                                                  passes=1),
                      "up2": lambda: tf32x3.conv3x3_up2_plain(x, wt, bias, passes=1)}.get(
                form, lambda: tf32x3.conv3x3_down2_plain(x, wt, bias, asymmetric=asym,
                                                         passes=1))()
            print(f"{form} {(b, h, w, cin, cout)}: plain fp32 max|err| vs fp64 {plain:.3e}, "
                  f"single-pass TF32 {float((single.double() - ref).abs().max()) / plain:.1f} x",
                  flush=True)
            del single
            for _ in range(ROUNDS):
                for name in use.names:
                    use(name)
                    if form == "up2":
                        w_split = cf.split_up2(wt)
                    else:
                        w_split = cf.split_tf32(wt)
                    call = {
                        "conv": lambda: k.conv3x3(x, wt, bias, w_split=w_split),
                        "fused": lambda: cf.conv3x3_fused(x, wt, bias, pre, skip=skip,
                                                          w_split=w_split),
                        "up2": lambda: cf.conv3x3_up2(x, wt, bias, w_split=w_split),
                    }.get(form, lambda: cf.conv3x3_down2(x, wt, bias, asymmetric=asym,
                                                         w_split=w_split))
                    err = float((call().double() - ref).abs().max())
                    ms = graph_ms(call, reps=3, calls=5)
                    print(f"  {name:22s} max|err| {err:.3e} = {err / plain:7.2f} x plain  "
                          f"{ms:.4f} ms  {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
