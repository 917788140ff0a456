"""A spec for ``tools/kernel_variants.py``: the fp32 SIMT conv kernel of the
fused and the upsample conv (``csrc/conv3x3_f32.cu``) as built (two blocks per
SM, one for the 128-channel tile), with two blocks per SM for every tile, and
with one for every tile, at main-path shapes of each mode.

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_conv_f32.py

Under the 128-register cap of two blocks per SM the 128-channel instances
spill a few bytes (ptxas, which ``chip_smoke.py`` refuses); one block per SM
lifts the cap and halves the warps that hide latency.
"""

LIBRARY = "conv3x3_f32"

_AS_BUILT = "__launch_bounds__(THREADS, TN == 8 ? 1 : 2) conv_f32_kernel"
VARIANTS = {
    "as_built": [],
    "two_blocks": [(_AS_BUILT, "__launch_bounds__(THREADS, 2) conv_f32_kernel")],
    "one_block": [(_AS_BUILT, "__launch_bounds__(THREADS, 1) conv_f32_kernel")],
}
# (mode, B, H, W, Cin, Cout): the VAE decoder's fused calls at two widths, two
# upsample calls (the stride-1 and stride-2 convs are the 3xTF32 kernel's:
# tools/variants_conv_tf32x3.py)
SHAPES = [("fused", 1, 256, 256, 512, 256), ("fused", 1, 1024, 1024, 128, 128),
          ("up2", 1, 512, 512, 256, 256), ("up2", 2, 32, 32, 1280, 1280)]
ROUNDS = 2


def run(use):
    import torch

    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.tools.timing import graph_ms

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for mode, n, h, w, cin, cout in SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda")
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
              ).contiguous(memory_format=torch.channels_last)
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        pre = (torch.rand((n, cin), generator=gen, device="cuda") + 0.5,
               torch.randn((n, cin), generator=gen, device="cuda"))
        phases = cf.fold_up2(wt)
        call, plain, flops = {
            "fused": (lambda: cf.conv3x3_fused(x, wt, bias, pre),
                      lambda: cf.conv3x3_fused_plain(x, wt, bias, pre), 9),
            "up2": (lambda: cf.conv3x3_up2(x, wt, bias, phases=phases),
                    lambda: cf.conv3x3_up2_plain(x, wt, bias), 16),
        }[mode]
        ref = plain()
        flops *= 2.0 * n * h * w * cin * cout
        for _ in range(ROUNDS):
            for name in use.names:
                use(name)
                err = float((call() - ref).abs().max())
                ms = graph_ms(call, reps=3, calls=5)
                print(f"{mode} {(n, h, w, cin, cout)} {name:18s} err {err:.3g}  {ms:.4f} ms  "
                      f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)
