"""3D KL-VAE over one primitive payload (counterpart of
``topiaxl/models/vae3d.py``), in torch's NCDHW layout, which is the
reference's own.

The decoder turns a [B, 1, 4, 4, 4] latent into a [B, 6, 8, 8, 8]
payload: conv_in -> mid block (ResNet, volume attention, ResNet) -> up
blocks (ResNets, a stride-2 ConvTranspose3d between them) ->
GroupNorm/SiLU -> ``ConvTranspose3d(k=3, s=1, p=1)``. Convolutions run in
the compute dtype ``dtype``, GroupNorm, the (post-)quant convs and
residual sums in f32. Weights are held in ``param_dtype`` (default: the
compute dtype, as serving holds them) and cast to ``dtype`` at each call,
as flax's ``nn.Conv`` does: training holds f32 master weights
(``param_dtype=torch.float32``) and computes in bf16. The volume attention
(64 tokens) takes the einsum form of ``multi_head_attention``.

``encode`` returns the ``DiagonalGaussian`` posterior; ``forward`` encodes,
samples (or takes the mode) and decodes, as the JAX ``VAE3D.__call__``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import META, SelfAttention, default_init_, materialize_

SKIP = math.sqrt(0.5)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` with weights in ``param_dtype`` computing in ``dtype``
    (weight, bias and input cast at each call; no-ops when they agree)."""

    def __init__(self, cin, cout, k, stride=1, padding=0,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         dtype=param_dtype or dtype, device=META)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` with weights in ``param_dtype`` computing in
    ``dtype``."""

    def __init__(self, cin, cout, k, stride=1, padding=0,
                 dtype=torch.bfloat16, param_dtype=None):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         dtype=param_dtype or dtype, device=META)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose3d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def _conv(cin, cout, k=3, stride=1, dtype=torch.bfloat16, param_dtype=None):
    return Conv3d(cin, cout, k, stride=stride, padding=k // 2, dtype=dtype,
                  param_dtype=param_dtype)


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, c), c, eps=1e-5, device=META)


def _norm_act(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.silu(norm(x.float()))


class ResnetBlock3D(nn.Module):
    """norm-act-conv x2 + (1x1x1-projected) skip, scaled sum in f32."""

    def __init__(self, cin, cout, skip_scale=SKIP, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.skip_scale = skip_scale
        self.norm1 = _gn(cin)
        self.conv1 = _conv(cin, cout, **kw)
        self.norm2 = _gn(cout)
        self.conv2 = _conv(cout, cout, **kw)
        self.shortcut = _conv(cin, cout, k=1, **kw) if cin != cout else None

    def forward(self, x):
        h = self.conv1(_norm_act(self.norm1, x))
        h = self.conv2(_norm_act(self.norm2, h))
        res = x if self.shortcut is None else self.shortcut(x)
        return (h.float() + res.float()) * self.skip_scale


class VolumeAttention3D(nn.Module):
    """GroupNorm + full-volume self-attention + scaled residual."""

    def __init__(self, c, num_heads=8, skip_scale=SKIP, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        self.skip_scale = skip_scale
        self.norm = _gn(c)
        self.attn = SelfAttention(c, num_heads, qkv_bias=False,
                                  proj_bias=True, dtype=dtype,
                                  param_dtype=param_dtype)

    def forward(self, x):
        B, C, D, H, W = x.shape
        h = self.norm(x.float()).flatten(2).transpose(1, 2)   # [B, DHW, C]
        h = self.attn(h).transpose(1, 2).reshape(B, C, D, H, W)
        return (h.float() + x.float()) * self.skip_scale


class MidBlock3D(nn.Module):
    def __init__(self, c, num_layers=1, attention=True, attention_heads=8,
                 skip_scale=SKIP, dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.nets = nn.ModuleList(
            ResnetBlock3D(c, c, skip_scale, dtype, param_dtype)
            for _ in range(num_layers + 1))
        self.attns = nn.ModuleList(
            VolumeAttention3D(c, attention_heads, skip_scale, dtype,
                              param_dtype)
            for _ in range(num_layers if attention else 0))

    def forward(self, x):
        x = self.nets[0](x)
        for i, net in enumerate(self.nets[1:]):
            if i < len(self.attns):
                x = self.attns[i](x)
            x = net(x)
        return x


class UpBlock3D(nn.Module):
    def __init__(self, cin, cout, num_layers=2, upsample=True,
                 skip_scale=SKIP, dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.nets = nn.ModuleList(
            ResnetBlock3D(cin if i == 0 else cout, cout, skip_scale, dtype,
                          param_dtype)
            for i in range(num_layers))
        self.upsample = (ConvTranspose3d(cout, cout, 2, stride=2, dtype=dtype,
                                         param_dtype=param_dtype)
                         if upsample else None)

    def forward(self, x):
        for net in self.nets:
            x = net(x)
        if self.upsample is not None:
            x = self.upsample(x)
        return x


class DownBlock3D(nn.Module):
    def __init__(self, cin, cout, num_layers=2, downsample=True,
                 skip_scale=SKIP, dtype=torch.bfloat16, param_dtype=None):
        super().__init__()
        self.nets = nn.ModuleList(
            ResnetBlock3D(cin if i == 0 else cout, cout, skip_scale, dtype,
                          param_dtype)
            for i in range(num_layers))
        self.downsample = (_conv(cout, cout, 3, stride=2, dtype=dtype,
                                 param_dtype=param_dtype)
                           if downsample else None)

    def forward(self, x):
        for net in self.nets:
            x = net(x)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class Encoder3D(nn.Module):
    def __init__(self, in_channels, out_channels, down_channels=(32, 256),
                 mid_attention=True, layers_per_block=2, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.conv_in = _conv(in_channels, down_channels[0], **kw)
        chans = [down_channels[0], *down_channels]
        self.down_blocks = nn.ModuleList(
            DownBlock3D(chans[i], chans[i + 1], layers_per_block,
                        downsample=i != len(down_channels) - 1, **kw)
            for i in range(len(down_channels)))
        self.mid_block = MidBlock3D(down_channels[-1], attention=mid_attention,
                                    **kw)
        self.norm_out = _gn(down_channels[-1])
        self.conv_out = _conv(down_channels[-1], out_channels, **kw)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(_norm_act(self.norm_out, x))


class Decoder3D(nn.Module):
    def __init__(self, in_channels, out_channels, up_channels=(256, 32),
                 mid_attention=True, layers_per_block=2, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.conv_in = _conv(in_channels, up_channels[0], **kw)
        self.mid_block = MidBlock3D(up_channels[0], attention=mid_attention,
                                    **kw)
        chans = [up_channels[0], *up_channels]
        self.up_blocks = nn.ModuleList(
            UpBlock3D(chans[i], chans[i + 1], layers_per_block,
                      upsample=i != len(up_channels) - 1, **kw)
            for i in range(len(up_channels)))
        self.norm_out = _gn(up_channels[-1])
        self.conv_out = ConvTranspose3d(up_channels[-1], out_channels, 3,
                                        stride=1, padding=1, **kw)

    def forward(self, x):
        x = self.conv_in(x)
        x = self.mid_block(x)
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(_norm_act(self.norm_out, x))


class DiagonalGaussian:
    """The posterior (reference models/vae3d_dib.py:50-90) over moments
    [B, 2L, ...] (mean | logvar on axis 1, NCDHW); ``logvar`` is clipped to
    [-30, 20]. ``kl`` takes the mean over the non-batch axes and ``nll``
    the sum, so both read the same in either layout."""

    def __init__(self, parameters: torch.Tensor):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """mean + std * eps, eps drawn from ``generator`` unless given as
        ``noise`` (shaped like ``mean``)."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def kl(self) -> torch.Tensor:
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * (self.mean ** 2 + self.var - 1.0 - self.logvar).mean(dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * (math.log(2.0 * math.pi) + self.logvar
                      + (sample - self.mean) ** 2 / self.var).sum(dims)

    def mode(self) -> torch.Tensor:
        return self.mean


class VAE3D(nn.Module):
    """KL-VAE; keys follow the reference's VAE state_dict. ``param_dtype``
    (default ``dtype``) holds the conv and attention weights, e.g. f32
    masters for training in bf16."""

    def __init__(self, in_channels: int = 6, latent_channels: int = 1,
                 out_channels: int = 6,
                 down_channels: Sequence[int] = (32, 256),
                 mid_attention: bool = True,
                 up_channels: Sequence[int] = (256, 32),
                 layers_per_block: int = 2, dtype=torch.bfloat16,
                 param_dtype=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = Encoder3D(in_channels, 2 * latent_channels,
                                 tuple(down_channels), mid_attention,
                                 layers_per_block, dtype, param_dtype)
        self.decoder = Decoder3D(latent_channels, out_channels,
                                 tuple(up_channels), mid_attention,
                                 layers_per_block, dtype, param_dtype)
        self.quant_conv = nn.Conv3d(2 * latent_channels, 2 * latent_channels,
                                    1, device=META)
        self.post_quant_conv = nn.Conv3d(latent_channels, latent_channels, 1,
                                         device=META)
        materialize_(self, device, generator, default_init_)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """[B, C, S, S, S] payload -> the posterior over [B, L, s, s, s]
        latents (f32 moments)."""
        return DiagonalGaussian(self.quant_conv(self.encoder(x).float()))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, L, s, s, s] latent -> [B, C, S, S, S] payload, f32."""
        return self.decoder(self.post_quant_conv(z.float())).float()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                sample: bool = True):
        """(reconstruction, posterior): decodes a draw from the posterior
        (from ``generator``) or, with ``sample=False``, its mode."""
        p = self.encode(x)
        z = p.sample(generator) if sample else p.mode()
        return self.decode(z), p
