"""The edit's five models in plain PyTorch: NCHW, fp32, ``F.conv2d``,
``F.linear``, SDPA and the norms written out, with no kernel, graph or cache.

The architectures are those of diffusers and transformers, as the
configuration files under ``benchmark/configs/`` give their sizes: the
SDXL-family ``UNet2DConditionModel`` (per-layer transformer depths, so SSD-1B's
pruned and mid-less topology too), the SDXL ControlNet (a copy of the UNet's
down path, a conditioning tower and zero convs), the ``AutoencoderKL`` of the
SDXL VAE and the two CLIP text towers.  Parameter names and shapes are the
published checkpoints' (OIHW convs), so one name addresses a weight in the
program and here.  Every product goes through a :class:`~.numerics.Numerics`,
which the control swaps for a lower precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.numerics import Numerics

# what a parameter is made from, by the module that owns it
KIND_FAN_IN, KIND_EMBED, KIND_ONE, KIND_ZERO = "fan_in", "embed", "one", "zero"


class _Op(nn.Module):
    """A module whose products run through the model's numerics."""

    num: Numerics = Numerics()


class Linear(_Op):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return self.num.linear(x, self.weight, self.bias)


class Conv(_Op):
    """k x k conv, stride 1 or 2; ``asymmetric`` pads (0, 1) as the VAE
    encoder's downsamplers do."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 asymmetric: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.asymmetric = stride, asymmetric
        self.padding = 0 if asymmetric else k // 2

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.num.conv(x, self.weight, self.bias, self.stride, self.padding)


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float, silu: bool = False):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        b, c, h, w = x.shape
        g = x.float().reshape(b, self.groups, c // self.groups, h, w)
        mean = g.mean(dim=(2, 3, 4), keepdim=True)
        var = (g - mean).square().mean(dim=(2, 3, 4), keepdim=True)
        y = ((g - mean) / torch.sqrt(var + self.eps)).reshape(b, c, h, w)
        y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return F.silu(y) if self.silu else y


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


def param_kinds(model: nn.Module) -> dict:
    """``{name: (shape, kind)}`` of every parameter: fan-in-scaled normal
    for product weights, 0.02 normal for embeddings, ones for norm scales,
    zeros for every bias and norm shift."""
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(m, (GroupNorm, LayerNorm)):
                kind = KIND_ONE if pname == "weight" else KIND_ZERO
            elif isinstance(m, Embedding):
                kind = KIND_EMBED
            else:
                kind = KIND_FAN_IN if pname == "weight" else KIND_ZERO
            out[name] = (tuple(p.shape), kind)
    return out


def set_numerics(model: nn.Module, num: Numerics) -> None:
    for m in model.modules():
        if isinstance(m, _Op):
            m.num = num


# ------------------------------------------------------------- UNet family


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cosines first (diffusers' flip_sin_to_cos)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear_1 = Linear(cin, cout)
        self.linear_2 = Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int | None, groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, silu=True)
        self.conv1 = Conv(cin, cout)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(groups, cout, eps, silu=True)
        self.conv2 = Conv(cout, cout)
        self.conv_shortcut = Conv(cin, cout, k=1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int | None = None):
        super().__init__()
        self.heads = heads
        kv = context_dim or dim
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(kv, dim, bias=False)
        self.to_v = Linear(kv, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, s, c = x.shape

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, c // self.heads).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx))
        out = self.to_q.num.attention(q, k, v).transpose(1, 2).reshape(b, s, c)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # diffusers' names: net.0 (GEGLU), net.1 (dropout, no parameters), net.2
        self.net = nn.ModuleDict({"0": GEGLU(dim, 4 * dim), "2": Linear(4 * dim, dim)})

    def forward(self, x):
        return self.net["2"](self.net["0"](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = LayerNorm(dim, 1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm, linear proj_in, the blocks, linear proj_out, residual."""

    def __init__(self, ch: int, heads: int, depth: int, context_dim: int):
        super().__init__()
        self.norm = GroupNorm(32, ch, 1e-6)
        self.proj_in = Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, context_dim) for _ in range(depth)])
        self.proj_out = Linear(ch, ch)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).reshape(b, c, h * w).transpose(1, 2))
        for block in self.transformer_blocks:
            t = block(t, context)
        return self.proj_out(t).transpose(1, 2).reshape(b, c, h, w) + x


def _attentions(depths, ch, heads, ctx) -> nn.ModuleDict:
    return nn.ModuleDict({str(j): Transformer2D(ch, heads, d, ctx)
                          for j, d in enumerate(depths) if d > 0})


class DownBlock(nn.Module):
    def __init__(self, cin, cout, depths, heads, down: bool, u: dict):
        super().__init__()
        temb = 4 * u["block_out_channels"][0]
        self.resnets = nn.ModuleList([
            Resnet(cin if j == 0 else cout, cout, temb, u["norm_groups"], u["norm_eps"])
            for j in range(len(depths))])
        self.attentions = _attentions(depths, cout, heads, u["cross_attention_dim"])
        self.downsamplers = nn.ModuleList(
            [nn.ModuleDict({"conv": Conv(cout, cout, stride=2)})] if down else [])

    def forward(self, x, temb, context):
        skips = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if str(j) in self.attentions:
                x = self.attentions[str(j)](x, context)
            skips.append(x)
        for d in self.downsamplers:
            x = d["conv"](x)
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    def __init__(self, ch, depth, heads, u: dict):
        super().__init__()
        temb = 4 * u["block_out_channels"][0]
        self.resnets = nn.ModuleList([
            Resnet(ch, ch, temb, u["norm_groups"], u["norm_eps"]) for _ in range(2)])
        self.attentions = _attentions((depth,), ch, heads, u["cross_attention_dim"])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        if "0" in self.attentions:
            x = self.attentions["0"](x, context)
        return self.resnets[1](x, temb)


class UpBlock(nn.Module):
    def __init__(self, prev, cout, skip_chs, depths, heads, up: bool, u: dict):
        super().__init__()
        temb = 4 * u["block_out_channels"][0]
        self.resnets = nn.ModuleList([
            Resnet((prev if j == 0 else cout) + skip_chs[j], cout, temb, u["norm_groups"],
                   u["norm_eps"]) for j in range(len(depths))])
        self.attentions = _attentions(depths, cout, heads, u["cross_attention_dim"])
        self.upsamplers = nn.ModuleList([nn.ModuleDict({"conv": Conv(cout, cout)})]
                                        if up else [])

    def forward(self, x, skips, temb, context):
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[j]], dim=1), temb)
            if str(j) in self.attentions:
                x = self.attentions[str(j)](x, context)
        for u in self.upsamplers:
            x = u["conv"](F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


def skip_channels(u: dict) -> list:
    chans = list(u["block_out_channels"])
    out = [chans[0]]
    for i, ch in enumerate(chans):
        out += [ch] * u["layers_per_block"]
        if i < len(chans) - 1:
            out.append(ch)
    return out


class _Embedder(nn.Module):
    """Time and added-condition embeddings of the UNet and the ControlNet."""

    def __init__(self, u: dict):
        super().__init__()
        self.u = u
        c0 = u["block_out_channels"][0]
        self.time_embedding = TimestepEmbedding(c0, 4 * c0)
        self.add_embedding = TimestepEmbedding(u["projection_class_embeddings_input_dim"],
                                               4 * c0)

    def embed(self, t, text_embeds, time_ids):
        u = self.u
        emb = self.time_embedding(timestep_embedding(t, u["block_out_channels"][0]))
        b, n = time_ids.shape
        ids = timestep_embedding(time_ids.reshape(-1), u["addition_time_embed_dim"])
        add = torch.cat([text_embeds, ids.reshape(b, n * u["addition_time_embed_dim"])], -1)
        return emb + self.add_embedding(add)

    def _down(self, with_mid: bool):
        u = self.u
        chans = list(u["block_out_channels"])
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.down_blocks.append(DownBlock(prev, ch, u["down_transformer_layers"][i],
                                              u["num_attention_heads"][i],
                                              i < len(chans) - 1, u))
            prev = ch
        self.mid_block = (MidBlock(chans[-1], u["mid_transformer_layers"],
                                   u["num_attention_heads"][-1], u)
                          if u["mid_transformer_layers"] is not None else None)

    def _run_down(self, x, temb, context):
        skips = [x]
        for block in self.down_blocks:
            x, s = block(x, temb, context)
            skips += s
        return x, skips


class UNet(_Embedder):
    def __init__(self, u: dict):
        super().__init__(u)
        chans = list(u["block_out_channels"])
        n = len(chans)
        self.conv_in = Conv(u["in_channels"], chans[0])
        self._down(True)
        skips = skip_channels(u)
        self.up_blocks = nn.ModuleList()
        prev = chans[-1]
        for i, ch in enumerate(reversed(chans)):
            L = u["layers_per_block"] + 1
            block_skips = skips[-L:][::-1]
            del skips[-L:]
            self.up_blocks.append(UpBlock(prev, ch, block_skips, u["up_transformer_layers"][i],
                                          u["num_attention_heads"][n - 1 - i], i < n - 1, u))
            prev = ch
        self.conv_norm_out = GroupNorm(u["norm_groups"], chans[0], u["norm_eps"], silu=True)
        self.conv_out = Conv(chans[0], u["out_channels"])

    def forward(self, x, t, context, text_embeds, time_ids, down_res, mid_res):
        temb = self.embed(t, text_embeds, time_ids)
        x, skips = self._run_down(self.conv_in(x), temb, context)
        skips = [s + r for s, r in zip(skips, down_res, strict=True)]
        if self.mid_block is not None:
            x = self.mid_block(x, temb, context)
        x = x + mid_res
        L = self.u["layers_per_block"] + 1
        for block in self.up_blocks:
            block_skips = skips[-L:][::-1]
            del skips[-L:]
            x = block(x, block_skips, temb, context)
        return self.conv_out(self.conv_norm_out(x))


class CondEmbedding(nn.Module):
    def __init__(self, cin: int, chans: list, cout: int):
        super().__init__()
        self.conv_in = Conv(cin, chans[0])
        blocks = []
        for i in range(len(chans) - 1):
            blocks += [Conv(chans[i], chans[i]), Conv(chans[i], chans[i + 1], stride=2)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv(chans[-1], cout)

    def forward(self, x):
        x = F.silu(self.conv_in(x))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNet(_Embedder):
    def __init__(self, c: dict):
        u = c["unet"]
        super().__init__(u)
        chans = list(u["block_out_channels"])
        self.conv_in = Conv(u["in_channels"], chans[0])
        self.controlnet_cond_embedding = CondEmbedding(
            c["conditioning_channels"], list(c["conditioning_embedding_channels"]), chans[0])
        self._down(True)
        self.controlnet_down_blocks = nn.ModuleList([Conv(ch, ch, k=1)
                                                     for ch in skip_channels(u)])
        self.controlnet_mid_block = Conv(chans[-1], chans[-1], k=1)

    def forward(self, x, t, context, text_embeds, time_ids, cond_feat, scale):
        temb = self.embed(t, text_embeds, time_ids)
        x, skips = self._run_down(self.conv_in(x) + cond_feat, temb, context)
        if self.mid_block is not None:
            x = self.mid_block(x, temb, context)
        down = [conv(s) * scale for conv, s in zip(self.controlnet_down_blocks, skips)]
        return down, self.controlnet_mid_block(x) * scale


# ---------------------------------------------------------------------- VAE


class VAEAttention(nn.Module):
    """One head of width C over every position, with a residual."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = Linear(ch, ch), Linear(ch, ch), Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = (m(t)[:, None] for m in (self.to_q, self.to_k, self.to_v))
        out = self.to_q.num.attention(q, k, v)[:, 0]
        return self.to_out[0](out).transpose(1, 2).reshape(b, c, h, w) + x


class VAEMid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _VAEBlock(nn.Module):
    def __init__(self, cin, cout, layers, groups, resample: str | None):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(cin if j == 0 else cout, cout, None, groups, 1e-6)
                                      for j in range(layers)])
        name = {"down": "downsamplers", "up": "upsamplers"}
        self.resample = resample
        for kind in ("down", "up"):
            conv = ([nn.ModuleDict({"conv": Conv(cout, cout, stride=2, asymmetric=True)
                                    if kind == "down" else Conv(cout, cout)})]
                    if resample == kind else [])
            setattr(self, name[kind], nn.ModuleList(conv))

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for d in self.downsamplers:
            x = d["conv"](x)
        for u in self.upsamplers:
            x = u["conv"](F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


class Encoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        chans, g = list(v["block_out_channels"]), v["norm_groups"]
        self.conv_in = Conv(v["in_channels"], chans[0])
        self.down_blocks = nn.ModuleList([
            _VAEBlock(chans[max(i - 1, 0)], ch, v["layers_per_block"], g,
                      "down" if i < len(chans) - 1 else None) for i, ch in enumerate(chans)])
        self.mid_block = VAEMid(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], 1e-6, silu=True)
        self.conv_out = Conv(chans[-1], 2 * v["latent_channels"])

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


class Decoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        rev, g = list(reversed(v["block_out_channels"])), v["norm_groups"]
        self.conv_in = Conv(v["latent_channels"], rev[0])
        self.mid_block = VAEMid(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _VAEBlock(rev[max(i - 1, 0)], ch, v["layers_per_block"] + 1, g,
                      "up" if i < len(rev) - 1 else None) for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6, silu=True)
        self.conv_out = Conv(rev[-1], v["in_channels"])

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class VAE(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        lc = v["latent_channels"]
        self.encoder = Encoder(v)
        self.decoder = Decoder(v)
        self.quant_conv = Conv(2 * lc, 2 * lc, k=1)
        self.post_quant_conv = Conv(lc, lc, k=1)

    def moments(self, x):
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# --------------------------------------------------------------------- CLIP


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(dim, dim), Linear(dim, dim)
        self.v_proj, self.out_proj = Linear(dim, dim), Linear(dim, dim)

    def forward(self, x):
        b, s, c = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, c // self.heads).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        out = self.q_proj.num.attention(q, k, v, causal=True)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class CLIPLayer(nn.Module):
    def __init__(self, t: dict):
        super().__init__()
        d = t["hidden_size"]
        self.self_attn = CLIPAttention(d, t["num_heads"])
        self.layer_norm1 = LayerNorm(d, t["layer_norm_eps"])
        self.mlp = nn.ModuleDict({"fc1": Linear(d, t["intermediate_size"]),
                                  "fc2": Linear(t["intermediate_size"], d)})
        self.layer_norm2 = LayerNorm(d, t["layer_norm_eps"])
        self.act = t["hidden_act"]

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.mlp["fc1"](self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp["fc2"](h)


class CLIPText(nn.Module):
    """Returns (penultimate hidden state, pooled output): the input of the
    last layer, and the final-normed state at the first EOS token through
    the projection where the tower has one."""

    def __init__(self, t: dict):
        super().__init__()
        self.t = t
        d = t["hidden_size"]
        self.text_model = nn.Module()
        self.text_model.embeddings = nn.Module()
        self.text_model.embeddings.token_embedding = Embedding(t["vocab_size"], d)
        self.text_model.embeddings.position_embedding = Embedding(t["max_positions"], d)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList([CLIPLayer(t)
                                                        for _ in range(t["num_layers"])])
        self.text_model.final_layer_norm = LayerNorm(d, t["layer_norm_eps"])
        if t["projection_dim"] is not None:
            self.text_projection = Linear(d, t["projection_dim"], bias=False)

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding.weight[ids] + tm.embeddings.position_embedding.weight[:s]
        layers = tm.encoder.layers
        for layer in layers[:-1]:
            x = layer(x)
        penultimate = x
        x = tm.final_layer_norm(layers[-1](x))
        eos = (ids == self.t["eos_token_id"]).int().argmax(dim=-1)
        pooled = x[torch.arange(ids.shape[0], device=ids.device), eos]
        if self.t["projection_dim"] is not None:
            pooled = self.text_projection(pooled)
        return penultimate, pooled


def build(cfg: dict) -> dict:
    """The five models of a configuration file, on the meta device."""
    with torch.device("meta"):
        return {
            "unet": UNet(cfg["unet"]),
            "controlnet": ControlNet(cfg["controlnet"]),
            "vae": VAE(cfg["vae"]),
            "text_encoder": CLIPText(cfg["text_encoder"]),
            "text_encoder_2": CLIPText(cfg["text_encoder_2"]),
        }
