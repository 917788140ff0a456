"""The work of one edit, counted from the configuration's sizes.

:func:`edit_flops` is a frozen copy of the program's ``utils/flops.py``
(matmul and conv multiply-adds x 2 of the pixel path: VAE encode, the
ControlNet's conditioning tower once per edit, the run steps' ControlNet and
UNet at 2B rows under CFG, VAE decode; prompt encoding left out), written
over the configuration files' dicts.  :func:`edit_ops` lists the same work
call by call, each with its family (``conv`` for spatial convolutions,
``linear`` for dense products: projections, feed-forwards, time embeddings,
1x1 convs; ``attention`` for the two products of each attention), its
operations and the least bytes it moves: each input read once, each weight
once per call, each output written once, at the configuration's item size.
The ops' ``flops`` sum to :func:`edit_flops`.  ``needed`` is what the inputs
need where that is less: an upsample conv needs 4 of its 9 taps per output,
since nearest upsampling repeats each input pixel in a 2 x 2 block.
:func:`prompt_ops` counts the text encoders' dense products per prompt.
"""

from __future__ import annotations

import dataclasses

ITEMSIZE = {"bfloat16": 2, "float32": 4}


# ------------------------------------------------- frozen copy: edit_flops


def _conv(hw, cin, cout, k=3):
    return 2.0 * hw * hw * cin * cout * k * k


def _dense(tokens, cin, cout):
    return 2.0 * tokens * cin * cout


def _resnet(hw, cin, cout, temb):
    f = _conv(hw, cin, cout) + _conv(hw, cout, cout)
    if cin != cout:
        f += _conv(hw, cin, cout, k=1)
    if temb:
        f += _dense(1, temb, cout)
    return f


def _transformer2d(hw, c, depth, cross, seq_text=77):
    s = hw * hw
    f = 2 * _dense(s, c, c)
    per_block = (
        4 * _dense(s, c, c) + 2 * (2.0 * s * s * c)
        + 2 * _dense(s, c, c)
        + 2 * _dense(seq_text, cross, c)
        + 2 * (2.0 * s * seq_text * c)
        + _dense(s, c, 8 * c) + _dense(s, 4 * c, c)
    )
    return f + depth * per_block


def unet_flops(u, latent_hw, seq_text=77):
    chans = list(u["block_out_channels"])
    n = len(chans)
    temb = 4 * chans[0]
    cross = u["cross_attention_dim"]
    f = _conv(latent_hw, u["in_channels"], chans[0])
    f += _dense(1, chans[0], temb) + _dense(1, temb, temb)
    f += _dense(1, u["projection_class_embeddings_input_dim"], temb)
    f += _dense(1, temb, temb)
    hw = latent_hw
    out_ch = chans[0]
    for i in range(n):
        in_ch, out_ch = out_ch, chans[i]
        for j, depth in enumerate(u["down_transformer_layers"][i]):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, temb)
            if depth > 0:
                f += _transformer2d(hw, out_ch, depth, cross, seq_text)
        if i < n - 1:
            hw //= 2
            f += _conv(hw, out_ch, out_ch)
    if u["mid_transformer_layers"] is not None:
        c = chans[-1]
        f += 2 * _resnet(hw, c, c, temb)
        if u["mid_transformer_layers"] > 0:
            f += _transformer2d(hw, c, u["mid_transformer_layers"], cross, seq_text)
    rev = list(reversed(chans))
    out_ch = rev[0]
    for i in range(n):
        prev, out_ch = out_ch, rev[i]
        skip_res = rev[min(i + 1, n - 1)]
        L = u["layers_per_block"] + 1
        for j, depth in enumerate(u["up_transformer_layers"][i]):
            skip = skip_res if j == L - 1 else out_ch
            cin = (prev if j == 0 else out_ch) + skip
            f += _resnet(hw, cin, out_ch, temb)
            if depth > 0:
                f += _transformer2d(hw, out_ch, depth, cross, seq_text)
        if i < n - 1:
            hw *= 2
            f += _conv(hw, out_ch, out_ch)
    f += _conv(latent_hw, chans[0], u["out_channels"])
    return f


def controlnet_encoder_flops(c, latent_hw, seq_text=77):
    u = c["unet"]
    chans = list(u["block_out_channels"])
    n = len(chans)
    temb = 4 * chans[0]
    f = _conv(latent_hw, u["in_channels"], chans[0])
    f += _dense(1, chans[0], temb) + _dense(1, temb, temb)
    f += _dense(1, u["projection_class_embeddings_input_dim"], temb)
    f += _dense(1, temb, temb)
    hw = latent_hw
    out_ch = chans[0]
    zero_convs = _conv(hw, chans[0], chans[0], k=1)
    for i in range(n):
        in_ch, out_ch = out_ch, chans[i]
        for j, depth in enumerate(u["down_transformer_layers"][i]):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, temb)
            if depth > 0:
                f += _transformer2d(hw, out_ch, depth, u["cross_attention_dim"], seq_text)
            zero_convs += _conv(hw, out_ch, out_ch, k=1)
        if i < n - 1:
            hw //= 2
            f += _conv(hw, out_ch, out_ch)
            zero_convs += _conv(hw, out_ch, out_ch, k=1)
    if u["mid_transformer_layers"] is not None:
        ch = chans[-1]
        f += 2 * _resnet(hw, ch, ch, temb)
        if u["mid_transformer_layers"] > 0:
            f += _transformer2d(hw, ch, u["mid_transformer_layers"], u["cross_attention_dim"],
                                seq_text)
        zero_convs += _conv(hw, ch, ch, k=1)
    return f + zero_convs


def controlnet_cond_tower_flops(c, pixel_hw):
    ch = list(c["conditioning_embedding_channels"])
    hw = pixel_hw
    f = _conv(hw, c["conditioning_channels"], ch[0])
    for i in range(len(ch) - 1):
        f += _conv(hw, ch[i], ch[i])
        hw //= 2
        f += _conv(hw, ch[i], ch[i + 1])
    f += _conv(hw, ch[-1], c["unet"]["block_out_channels"][0])
    return f


def _vae_mid(hw, c):
    s = hw * hw
    attn = 4 * _dense(s, c, c) + 2 * (2.0 * s * s * c)
    return 2 * _resnet(hw, c, c, None) + attn


def vae_encoder_flops(v, pixel_hw):
    chans = list(v["block_out_channels"])
    n = len(chans)
    hw = pixel_hw
    f = _conv(hw, v["in_channels"], chans[0])
    out_ch = chans[0]
    for i in range(n):
        in_ch, out_ch = out_ch, chans[i]
        for j in range(v["layers_per_block"]):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, None)
        if i < n - 1:
            hw //= 2
            f += _conv(hw, out_ch, out_ch)
    f += _vae_mid(hw, chans[-1])
    f += _conv(hw, chans[-1], 2 * v["latent_channels"])
    f += _conv(hw, 2 * v["latent_channels"], 2 * v["latent_channels"], k=1)
    return f


def vae_decoder_flops(v, pixel_hw):
    chans = list(v["block_out_channels"])
    n = len(chans)
    rev = list(reversed(chans))
    hw = pixel_hw // 2 ** (n - 1)
    f = _conv(hw, v["latent_channels"], v["latent_channels"], k=1)
    f += _conv(hw, v["latent_channels"], rev[0])
    f += _vae_mid(hw, rev[0])
    out_ch = rev[0]
    for i in range(n):
        in_ch, out_ch = out_ch, rev[i]
        for j in range(v["layers_per_block"] + 1):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, None)
        if i < n - 1:
            hw *= 2
            f += _conv(hw, out_ch, out_ch)
    f += _conv(hw, chans[0], v["in_channels"])
    return f


def edit_flops(cfg: dict, do_cfg: bool, batch: int = 1) -> float:
    """Matmul and conv FLOPs of ``batch`` edits' pixel path."""
    v, r = cfg["vae"], cfg["resolution"]
    lat_hw = r // 2 ** (len(v["block_out_channels"]) - 1)
    steps = _run_steps(cfg)
    per_step = unet_flops(cfg["unet"], lat_hw) + controlnet_encoder_flops(cfg["controlnet"],
                                                                         lat_hw)
    return batch * (vae_encoder_flops(v, r)
                    + controlnet_cond_tower_flops(cfg["controlnet"], cfg["control_resolution"])
                    + vae_decoder_flops(v, r)) + steps * (2 if do_cfg else 1) * batch * per_step


def _run_steps(cfg: dict) -> int:
    e = cfg["edit"]
    n = e["num_inference_steps"]
    return min(int(n * e["strength"]), n)


# ------------------------------------------------------ the ops, call by call


@dataclasses.dataclass(frozen=True)
class Op:
    family: str  # "conv", "linear" or "attention"
    flops: float  # as edit_flops counts it
    needed: float  # what the inputs need (< flops for an upsample conv)
    bytes: float  # least bytes moved: inputs and weights read once, outputs written once


class _Ops:
    """Collects the ops of one model call over ``rows`` rows."""

    def __init__(self, rows: int, itemsize: int):
        self.rows, self.item, self.ops = rows, itemsize, []

    def conv(self, hw_out, cin, cout, k=3, hw_in=None, up2=False):
        hw_in = hw_out if hw_in is None else hw_in
        f = self.rows * _conv(hw_out, cin, cout, k)
        byt = self.item * (self.rows * (hw_in * hw_in * cin + hw_out * hw_out * cout)
                           + cin * cout * k * k + cout)
        family = "conv" if k > 1 else "linear"
        self.ops.append(Op(family, f, f * 4 / 9 if up2 else f, byt))

    def dense(self, tokens, cin, cout, bias=True):
        f = self.rows * _dense(tokens, cin, cout)
        byt = self.item * (self.rows * tokens * (cin + cout) + cin * cout + (cout if bias else 0))
        self.ops.append(Op("linear", f, f, byt))

    def attn(self, sq, skv, c):
        f = self.rows * 2 * (2.0 * sq * skv * c)
        byt = self.item * self.rows * (2 * sq * c + 2 * skv * c)
        self.ops.append(Op("attention", f, f, byt))

    def resnet(self, hw, cin, cout, temb):
        self.conv(hw, cin, cout)
        if temb:
            self.dense(1, temb, cout)
        self.conv(hw, cout, cout)
        if cin != cout:
            self.conv(hw, cin, cout, k=1)

    def transformer(self, hw, c, depth, cross, seq=77):
        s = hw * hw
        self.dense(s, c, c)
        for _ in range(depth):
            for _ in range(3):
                self.dense(s, c, c, bias=False)
            self.attn(s, s, c)
            self.dense(s, c, c)
            self.dense(s, c, c, bias=False)
            self.dense(seq, cross, c, bias=False)
            self.dense(seq, cross, c, bias=False)
            self.attn(s, seq, c)
            self.dense(s, c, c)
            self.dense(s, c, 8 * c)
            self.dense(s, 4 * c, c)
        self.dense(s, c, c)

    def embed(self, u):
        c0 = u["block_out_channels"][0]
        temb = 4 * c0
        self.dense(1, c0, temb)
        self.dense(1, temb, temb)
        self.dense(1, u["projection_class_embeddings_input_dim"], temb)
        self.dense(1, temb, temb)

    def down_path(self, u, hw, zero_convs: bool):
        chans = list(u["block_out_channels"])
        temb, cross = 4 * chans[0], u["cross_attention_dim"]
        if zero_convs:
            self.conv(hw, chans[0], chans[0], k=1)
        out_ch = chans[0]
        for i in range(len(chans)):
            in_ch, out_ch = out_ch, chans[i]
            for j, depth in enumerate(u["down_transformer_layers"][i]):
                self.resnet(hw, in_ch if j == 0 else out_ch, out_ch, temb)
                if depth > 0:
                    self.transformer(hw, out_ch, depth, cross)
                if zero_convs:
                    self.conv(hw, out_ch, out_ch, k=1)
            if i < len(chans) - 1:
                self.conv(hw // 2, out_ch, out_ch, hw_in=hw)
                hw //= 2
                if zero_convs:
                    self.conv(hw, out_ch, out_ch, k=1)
        if u["mid_transformer_layers"] is not None:
            c = chans[-1]
            self.resnet(hw, c, c, temb)
            if u["mid_transformer_layers"] > 0:
                self.transformer(hw, c, u["mid_transformer_layers"], cross)
            self.resnet(hw, c, c, temb)
            if zero_convs:
                self.conv(hw, c, c, k=1)
        return hw

    def unet(self, u, lat_hw):
        chans = list(u["block_out_channels"])
        n, temb = len(chans), 4 * chans[0]
        self.conv(lat_hw, u["in_channels"], chans[0])
        self.embed(u)
        hw = self.down_path(u, lat_hw, zero_convs=False)
        rev = list(reversed(chans))
        out_ch = rev[0]
        for i in range(n):
            prev, out_ch = out_ch, rev[i]
            skip_res = rev[min(i + 1, n - 1)]
            L = u["layers_per_block"] + 1
            for j, depth in enumerate(u["up_transformer_layers"][i]):
                skip = skip_res if j == L - 1 else out_ch
                self.resnet(hw, (prev if j == 0 else out_ch) + skip, out_ch, temb)
                if depth > 0:
                    self.transformer(hw, out_ch, depth, u["cross_attention_dim"])
            if i < n - 1:
                self.conv(hw * 2, out_ch, out_ch, hw_in=hw, up2=True)
                hw *= 2
        self.conv(lat_hw, chans[0], u["out_channels"])

    def controlnet(self, c, lat_hw):
        u = c["unet"]
        self.conv(lat_hw, u["in_channels"], u["block_out_channels"][0])
        self.embed(u)
        self.down_path(u, lat_hw, zero_convs=True)

    def cond_tower(self, c, hw):
        ch = list(c["conditioning_embedding_channels"])
        self.conv(hw, c["conditioning_channels"], ch[0])
        for i in range(len(ch) - 1):
            self.conv(hw, ch[i], ch[i])
            self.conv(hw // 2, ch[i], ch[i + 1], hw_in=hw)
            hw //= 2
        self.conv(hw, ch[-1], c["unet"]["block_out_channels"][0])

    def vae_mid(self, hw, c):
        self.resnet(hw, c, c, None)
        for _ in range(3):
            self.dense(hw * hw, c, c)
        self.attn(hw * hw, hw * hw, c)
        self.dense(hw * hw, c, c)
        self.resnet(hw, c, c, None)

    def vae_encoder(self, v, hw):
        chans = list(v["block_out_channels"])
        lc = v["latent_channels"]
        self.conv(hw, v["in_channels"], chans[0])
        out_ch = chans[0]
        for i in range(len(chans)):
            in_ch, out_ch = out_ch, chans[i]
            for j in range(v["layers_per_block"]):
                self.resnet(hw, in_ch if j == 0 else out_ch, out_ch, None)
            if i < len(chans) - 1:
                self.conv(hw // 2, out_ch, out_ch, hw_in=hw)
                hw //= 2
        self.vae_mid(hw, chans[-1])
        self.conv(hw, chans[-1], 2 * lc)
        self.conv(hw, 2 * lc, 2 * lc, k=1)

    def vae_decoder(self, v, pixel_hw):
        chans = list(v["block_out_channels"])
        rev, lc = list(reversed(chans)), v["latent_channels"]
        hw = pixel_hw // 2 ** (len(chans) - 1)
        self.conv(hw, lc, lc, k=1)
        self.conv(hw, lc, rev[0])
        self.vae_mid(hw, rev[0])
        out_ch = rev[0]
        for i in range(len(rev)):
            in_ch, out_ch = out_ch, rev[i]
            for j in range(v["layers_per_block"] + 1):
                self.resnet(hw, in_ch if j == 0 else out_ch, out_ch, None)
            if i < len(rev) - 1:
                self.conv(hw * 2, out_ch, out_ch, hw_in=hw, up2=True)
                hw *= 2
        self.conv(hw, chans[0], v["in_channels"])


def edit_ops(cfg: dict, do_cfg: bool, batch: int) -> list:
    """Every product of ``batch`` edits' pixel path, call by call: the
    encoder and the tower at ``batch`` rows, each run step's ControlNet and
    UNet at ``2 * batch`` rows under CFG, the decoder one image at a time."""
    item = ITEMSIZE[cfg["dtype"]]
    v, r = cfg["vae"], cfg["resolution"]
    lat_hw = r // 2 ** (len(v["block_out_channels"]) - 1)
    ops = []
    enc = _Ops(batch, item)
    enc.vae_encoder(v, r)
    enc.cond_tower(cfg["controlnet"], cfg["control_resolution"])
    ops += enc.ops
    for _ in range(_run_steps(cfg)):
        step = _Ops((2 if do_cfg else 1) * batch, item)
        step.controlnet(cfg["controlnet"], lat_hw)
        step.unet(cfg["unet"], lat_hw)
        ops += step.ops
    for _ in range(batch):
        dec = _Ops(1, item)
        dec.vae_decoder(v, r)
        ops += dec.ops
    return ops


def prompt_ops(cfg: dict, prompts: int) -> list:
    """The dense products of both text towers over ``prompts`` prompts of
    77 tokens (the attention products left out, 77 x 77 per head)."""
    item = ITEMSIZE[cfg["dtype"]]
    o = _Ops(prompts, item)
    for name in ("text_encoder", "text_encoder_2"):
        t = cfg[name]
        d, inter = t["hidden_size"], t["intermediate_size"]
        for _ in range(t["num_layers"]):
            for _ in range(4):
                o.dense(77, d, d)
            o.dense(77, d, inter)
            o.dense(77, inter, d)
        if t["projection_dim"] is not None:
            o.dense(1, d, t["projection_dim"], bias=False)
    return o.ops


def least_seconds(ops: list, peak_flops: float, bytes_per_s: float) -> float:
    """Sum over the ops of each one's least time: the larger of its needed
    operations at the peak rate and its bytes at the memory bandwidth."""
    return sum(max(op.needed / peak_flops, op.bytes / bytes_per_s) for op in ops)


def family_flops(ops: list) -> dict:
    out = {}
    for op in ops:
        out[op.family] = out.get(op.family, 0.0) + op.flops
    return out
