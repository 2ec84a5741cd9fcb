"""Dense graph attention over spatial kNN graphs.

- ``DenseGATLayer``: single-head GAT attention over a dense boolean
  adjacency: three bias-free dense maps, ``leaky_relu(., 0.2)`` logits, a
  ``-1e9`` fill off the graph, a softmax, the mask applied again (a row
  with no edge is all zero).
- ``GATSimulator``: encoder, a GAT layer and residual GAT processors,
  decoder; nodes carry position and velocity history, the output is an
  acceleration (GNS). ``gns_rollout`` is its semi-implicit Euler rollout.
- ``LSTMGAT``: a per-atom LSTM over a history window, refined over the kNN
  graph of the latest frame.
- ``GraphSeq2Seq``: a per-atom LSTM encoder into a noise-fed LSTM decoder
  whose every decoded frame is refined by GAT attention over the kNN graph of
  its own predicted positions; the decoder feeds back its output, so it
  runs a step at a time.

The adjacency is ``features.knn_graph_mask`` (ties kept), a boolean that
carries no gradient: it is built from detached positions. Any leading axes
of the inputs are batch axes. The LSTM models round their window to
float32 first, as the reference's do (``models.seq.float32_input``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from molecular_dynamics_tpu_torch.features import knn_graph_mask
from molecular_dynamics_tpu_torch.models.common import dense
from molecular_dynamics_tpu_torch.models.seq import LSTMLayer, float32_input, last_hidden

Tensor = torch.Tensor


def graph(pos: Tensor, k: int) -> Tensor:
    """The kNN adjacency ``(..., N, N)`` of ``pos (..., N, 3)``, ``k`` capped
    at ``N - 1``."""
    return knn_graph_mask(pos.detach(), min(k, pos.shape[-2] - 1))


class DenseGATLayer(nn.Module):
    """``h (..., N, in)``, ``adj (..., N, N)`` -> ``(..., N, out_dim)``."""

    def __init__(self, in_features: int, out_dim: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            dense(in_features, out_dim, generator, device, dtype, bias=False),
            dense(out_dim, 1, generator, device, dtype, bias=False),
            dense(out_dim, 1, generator, device, dtype, bias=False)])

    def forward(self, h: Tensor, adj: Tensor) -> Tensor:
        w = self.layers[0](h)
        a_src = self.layers[1](w)[..., 0]
        a_dst = self.layers[2](w)[..., 0]
        logits = F.leaky_relu(a_src[..., :, None] + a_dst[..., None, :], 0.2)
        logits = torch.where(adj, logits, torch.full_like(logits, -1e9))
        attn = torch.where(adj, torch.softmax(logits, dim=-1), torch.zeros_like(logits))
        return attn @ w


class GATSimulator(nn.Module):
    """``nodes (..., N, node_in)``, ``pos (..., N, 3)`` -> ``(..., N,
    node_out)``: ``relu(dense)``, a GAT layer, ``n_processors`` residual
    ``relu(GAT)`` blocks, ``relu(dense)``, dense."""

    def __init__(self, node_in: int, node_out: int = 3, latent: int = 128,
                 n_processors: int = 3, k: int = 40, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.k = k
        self.layers = nn.ModuleList([dense(node_in, latent, generator, device, dtype),
                                     dense(latent, latent, generator, device, dtype),
                                     dense(latent, node_out, generator, device, dtype)])
        self.gat = nn.ModuleList(DenseGATLayer(latent, latent, generator, device, dtype)
                                 for _ in range(n_processors + 1))

    def forward(self, nodes: Tensor, pos: Tensor) -> Tensor:
        adj = graph(pos, self.k)
        h = self.gat[0](F.relu(self.layers[0](nodes.to(self.layers[0].weight.dtype))), adj)
        for layer in self.gat[1:]:
            h = h + F.relu(layer(h, adj))
        return self.layers[2](F.relu(self.layers[1](h)))


class LSTMGAT(nn.Module):
    """``history (..., N, T, in_features)``, ``pos (..., N, 3)`` -> ``(...,
    N, out_dim)``: each atom's series through one LSTM, its last hidden state
    through ``relu(dense)`` and ``n_processors`` residual GAT blocks over the
    kNN graph of ``pos``, then a dense head."""

    def __init__(self, in_features: int = 3, out_dim: int = 3, hidden_size: int = 64,
                 latent: int = 64, n_processors: int = 2, k: int = 10, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.k = k
        self.lstm = nn.ModuleList([LSTMLayer(in_features, hidden_size, generator, device, dtype)])
        self.layers = nn.ModuleList([dense(hidden_size, latent, generator, device, dtype),
                                     dense(latent, out_dim, generator, device, dtype)])
        self.gat = nn.ModuleList(DenseGATLayer(latent, latent, generator, device, dtype)
                                 for _ in range(n_processors))

    def forward(self, history: Tensor, pos: Tensor) -> Tensor:
        adj = graph(pos, self.k)
        h = F.relu(self.layers[0](last_hidden(
            self.lstm[0], float32_input(history, self.layers[0].weight))))
        for layer in self.gat:
            h = h + F.relu(layer(h, adj))
        return self.layers[1](h)


def gns_rollout(model: GATSimulator, pos0: Tensor, vel_history: Tensor, n_steps: int,
                dt: float = 1.0) -> Tensor:
    """Semi-implicit Euler rollout with a shifting velocity history:
    ``pos0 (..., N, 3)``, ``vel_history (H, ..., N, 3)`` (oldest first) ->
    positions ``(n_steps, ..., N, 3)``. Node features are the position and
    the history, oldest first."""
    pos, hist, out = pos0, list(vel_history), []
    for _ in range(n_steps):
        acc = model(torch.cat([pos] + hist, dim=-1), pos)
        vel = hist[-1] + acc * dt
        pos = pos + vel * dt
        hist = hist[1:] + [vel]
        out.append(pos)
    return torch.stack(out)


class GraphSeq2Seq(nn.Module):
    """Per-atom LSTM encoder -> noise-fed LSTM decoder -> residual GAT
    refinement of each decoded frame over the kNN graph of its own
    predicted positions (the first three feature channels).

    ``window (..., N, T, F)``, ``noise (..., L, N, F)`` -> ``(..., N, L, F)``.
    Each decode step feeds ``out + noise_scale * noise`` (``out`` the encoder
    head's frame, then the previous decoded frame) to the decoder."""

    def __init__(self, feat_dim: int = 5, hidden_size: int = 64, k: int = 6,
                 noise_scale: float = 0.5, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.feat_dim, self.k, self.noise_scale = feat_dim, k, noise_scale
        self.lstm = nn.ModuleList([LSTMLayer(feat_dim, hidden_size, generator, device, dtype),
                                   LSTMLayer(feat_dim, hidden_size, generator, device, dtype)])
        self.layers = nn.ModuleList([dense(hidden_size, feat_dim, generator, device, dtype),
                                     dense(hidden_size, feat_dim, generator, device, dtype)])
        self.gat = nn.ModuleList([DenseGATLayer(feat_dim, feat_dim, generator, device, dtype)])

    def forward(self, window: Tensor, noise: Tensor) -> Tensor:
        enc, carry = self.lstm[0](float32_input(window, self.layers[0].weight))
        out = self.layers[0](enc[..., -1, :])
        outs = []
        for i in range(noise.shape[-3]):
            step = (out + self.noise_scale * noise[..., i, :, :])[..., None, :]
            h, carry = self.lstm[1](step, carry)
            out = self.layers[1](h[..., 0, :])
            out = out + self.gat[0](out, graph(out[..., :3], self.k))
            outs.append(out)
        return torch.stack(outs, dim=-2)
