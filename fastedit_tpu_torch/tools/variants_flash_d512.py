"""A spec for ``tools/kernel_variants.py``: the D = 512 attention kernel with one,
two (as built) and four accumulators for S, and with other depths of its K and
V rings in the same shared memory, at the VAE mid block's shape.

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_flash_d512.py
"""

LIBRARY = "flash_attention"


def _chains(n):
    return [("constexpr int S_CHAINS = 2;", f"constexpr int S_CHAINS = {n};")]


def _rings(k_stages, v_stages):  # 8 KB a stage either way: 6 + 2 x 6 = 8 + 2 x 5 = 10 + 2 x 4
    return [("constexpr int K_STAGES = 6;", f"constexpr int K_STAGES = {k_stages};"),
            ("constexpr int V_ROWS = 16, V_STAGES = 6;",
             f"constexpr int V_ROWS = 16, V_STAGES = {v_stages};")]


VARIANTS = {
    "as_built": [],
    "one_accumulator": _chains(1),
    "four_accumulators": _chains(4),
    "rings_8_5": _rings(8, 5),
    "rings_10_4": _rings(10, 4),
}
SHAPE = (1, 16384, 16384, 1, 512)  # B, Sq, Skv, H, D
ROUNDS = 2


def run(use):
    import torch

    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools.timing import graph_ms

    b, sq, skv, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
               for s in (sq, skv, skv))
    ref = fa.attention_plain(q, k, v).float()
    rms = float(ref.square().mean().sqrt())
    for _ in range(ROUNDS):
        for name in use.names:
            use(name)
            out = fa.flash_attention(q, k, v).float()
            # what is left of the error after the tolerance's relative term, over rms(ref)
            err = float(((out - ref).abs() - 2.0 ** -7 * ref.abs()).max().clamp(min=0)) / rms
            ms = graph_ms(lambda: fa.flash_attention(q, k, v))
            print(f"{name:18s} err/rms {err:.4f}  {ms:.4f} ms  "
                  f"{4.0 * b * h * sq * skv * d / ms / 1e9:.1f} TFLOP/s", flush=True)
