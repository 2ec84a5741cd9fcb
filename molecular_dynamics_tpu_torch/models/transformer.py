"""Transformer over a history window of flat frames: a stack of post-norm
encoder blocks, the next frame from the last token.

flax's defaults, which torch's differ from, are kept: ``LayerNorm`` epsilon
1e-6, the tanh approximation of GELU, and ``SelfAttention``'s layout, its
query, key and value kernels ``(D, heads, head_dim)`` with ``(heads,
head_dim)`` biases and its output kernel ``(heads, head_dim, D)``, the query
divided by ``sqrt(head_dim)``. The attention is an explicit einsum and
softmax. The learnt position embedding ``pos_embed (history, D)`` ties the
model to its history length.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from molecular_dynamics_tpu_torch.convert import resolve_device
from molecular_dynamics_tpu_torch.models.common import TRUNCATED_NORMAL_STD, dense

Tensor = torch.Tensor

#: flax's ``LayerNorm`` epsilon (torch's default is 1e-5)
LAYER_NORM_EPS = 1e-6


class DenseGeneral(nn.Module):
    """flax's ``DenseGeneral`` over the trailing ``len(in_shape)`` axes: a
    ``kernel in_shape + out_shape`` in flax's layout and a ``bias
    out_shape``, the kernel LeCun-normal over ``fan_in = prod(in_shape)``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int], generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        shape = tuple(in_shape) + tuple(out_shape)
        std = math.sqrt(1.0 / math.prod(in_shape)) / TRUNCATED_NORMAL_STD
        kernel = torch.empty(shape, device=device, dtype=dtype)
        nn.init.trunc_normal_(kernel, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(tuple(out_shape), device=device, dtype=dtype))


class SelfAttention(nn.Module):
    """flax's ``nn.SelfAttention(num_heads)`` with its default widths
    (query, key, value and output all ``D``)."""

    def __init__(self, d_model: int, n_heads: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} must be divisible by n_heads {n_heads}")
        self.head_dim = d_model // n_heads
        heads = (n_heads, self.head_dim)
        self.query = DenseGeneral((d_model,), heads, generator, device, dtype)
        self.key = DenseGeneral((d_model,), heads, generator, device, dtype)
        self.value = DenseGeneral((d_model,), heads, generator, device, dtype)
        self.out = DenseGeneral(heads, (d_model,), generator, device, dtype)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """``x (..., T, D)``; ``mask (T, T)`` bool, True where a query may
        attend a key."""
        def project(p):
            return torch.einsum("...td,dhk->...thk", x, p.kernel) + p.bias

        q = project(self.query) / math.sqrt(self.head_dim)
        logits = torch.einsum("...qhk,...shk->...hqs", q, project(self.key))
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        heads = torch.einsum("...hqs,...shk->...qhk", weights, project(self.value))
        return torch.einsum("...qhk,hkd->...qd", heads, self.out.kernel) + self.out.bias


class EncoderBlock(nn.Module):
    """Post-norm block: ``LN(x + attn(x))``, then ``LN(x + W0 gelu(W1 x))``.
    ``layers`` keeps flax's numbering, which counts the outer ``Dense``
    first: ``layers.0`` is ``d_ff -> D``, ``layers.1`` is ``D -> d_ff``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.attention = nn.ModuleList([SelfAttention(d_model, n_heads, generator, device, dtype)])
        self.norms = nn.ModuleList(
            nn.LayerNorm(d_model, eps=LAYER_NORM_EPS, device=device, dtype=dtype)
            for _ in range(2))
        self.layers = nn.ModuleList([dense(d_ff, d_model, generator, device, dtype),
                                     dense(d_model, d_ff, generator, device, dtype)])

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        x = self.norms[0](x + self.attention[0](x, mask))
        ff = self.layers[0](F.gelu(self.layers[1](x), approximate="tanh"))
        return self.norms[1](x + ff)


class TrajectoryTransformer(nn.Module):
    """``(..., history, in_features)`` -> ``(..., out_dim)``: a dense
    embedding plus ``pos_embed`` (``normal(0.02)``), ``n_layers`` encoder
    blocks, a dense head on the last token; ``causal`` masks the future."""

    def __init__(self, in_features: int, out_dim: int, d_model: int = 64, n_heads: int = 4,
                 n_layers: int = 6, d_ff: int = 128, history: int = 11, causal: bool = False,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.causal = causal
        self.layers = nn.ModuleList([dense(in_features, d_model, generator, device, dtype),
                                     dense(d_model, out_dim, generator, device, dtype)])
        pos = torch.empty((history, d_model), device=device, dtype=dtype)
        self.pos_embed = nn.Parameter(nn.init.normal_(pos, std=0.02, generator=generator))
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, d_ff, generator, device, dtype)
            for _ in range(n_layers))

    def forward(self, window: Tensor) -> Tensor:
        h = self.layers[0](window.to(self.pos_embed.dtype)) + self.pos_embed
        mask = None
        if self.causal:
            t = window.shape[-2]
            mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=window.device))
        for block in self.blocks:
            h = block(h, mask)
        return self.layers[1](h[..., -1, :])
