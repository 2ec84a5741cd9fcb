"""Sequence predictors: windowed LSTM, Gaussian-NLL LSTM, Seq2Seq.

- ``LSTMPredictor``: a history window ``(..., T, F)`` -> the next frame
  ``(..., out_dim)``, trained with the composite geometric loss of
  ``train.losses``.
- ``LSTMNLLPredictor``: a (mu, sigma) head for the constrained-Gaussian NLL
  (``gaussian_nll``).
- ``SequenceDiscriminator``: an LSTM critic scoring a decoded sequence (the
  adversarial Seq2Seq's discriminator).
- ``Seq2Seq`` / ``Seq2SeqNLL``: an LSTM encoder into an LSTM decoder fed by
  noise (no teacher forcing), decoding ``L`` frames.

Every LSTM is ``LSTMLayer``: flax's ``OptimizedLSTMCell`` scanned over time,
one bias a gate (``torch.nn.LSTM`` carries two, whose gradients are equal:
trained together they move the gate's bias twice as fast under Adam and
count twice in the global-norm clip). The layer runs ``torch.lstm`` with a
zero input bias that is no parameter, with cuDNN switched off for the call:
on an H100 (TF32 off) cuDNN's float32 LSTM left the per-atom LSTM-GAT's
gradients 1.8e-5 to 4.6e-3 off float64 in direction, where PyTorch's own
CUDA LSTM (a GEMM and a fused cell kernel a time step) stayed near 1e-6
(``scripts/sequence_cudnn_check.py``).

The JAX models draw their decoder noise from a key inside the call; here
the caller passes it (``noise``), drawn from its own ``torch.Generator``
or carried in from elsewhere. flax infers input widths at
the first call; a torch module takes them when it is built.

The reference's LSTM models round their input to float32, their compute
dtype, whatever it came as (``float32_input``); a module built in float64
computes in float64 from that rounded input, as the reference's does with
its weights cast up. In float32 the rounding is no operation.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from molecular_dynamics_tpu_torch.convert import resolve_device
from molecular_dynamics_tpu_torch.models.common import dense, lecun_normal_, orthogonal_

Tensor = torch.Tensor
Carry = Tuple[Tensor, Tensor]


@contextlib.contextmanager
def _without_cudnn():
    """cuDNN off for the block, as it was after it."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


class LSTMLayer(nn.Module):
    """flax's ``nn.RNN(nn.OptimizedLSTMCell(hidden))``: gates i, f, g, o
    (``torch.nn.LSTM``'s order), ``c' = f c + i g``, ``h' = o tanh(c')``,
    from a zero carry unless one is given.

    Parameters: ``weight_ih`` ``(4H, in)`` (flax's ``ii/if/ig/io`` kernels,
    no bias), ``weight_hh`` ``(4H, H)`` and ``bias`` ``(4H,)`` (``hi/hf/hg/ho``
    kernels and biases). Initialised as flax does: each gate's input kernel
    LeCun-normal, each recurrent kernel orthogonal, zero biases. Any leading
    axes of the input are batch axes."""

    def __init__(self, in_features: int, hidden: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features, device=device,
                                                  dtype=dtype))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(4 * hidden, device=device, dtype=dtype))
        self.register_buffer("zero_bias", torch.zeros(4 * hidden, device=device, dtype=dtype),
                             persistent=False)
        for g in range(4):
            lecun_normal_(self.weight_ih.data[g * hidden: (g + 1) * hidden], generator)
            orthogonal_(self.weight_hh.data[g * hidden: (g + 1) * hidden], generator)

    def forward(self, x: Tensor, carry: Optional[Carry] = None) -> Tuple[Tensor, Carry]:
        """``x (..., T, in)`` -> (outputs ``(..., T, H)``, carry ``(h, c)``
        each ``(..., H)``)."""
        x = x.to(self.weight_ih.dtype)
        batch, (t, width), h = x.shape[:-2], x.shape[-2:], self.hidden
        flat = x.reshape(-1, t, width)
        if carry is None:
            zero = flat.new_zeros((1, flat.shape[0], h))
            carry = (zero, zero)
        else:
            carry = tuple(c.reshape(1, -1, h) for c in carry)
        with _without_cudnn():
            out, h_n, c_n = torch.lstm(
                flat, carry, [self.weight_ih, self.weight_hh, self.zero_bias, self.bias],
                True, 1, 0.0, torch.is_grad_enabled(), False, True)
        return out.reshape(*batch, t, h), (h_n.reshape(*batch, h), c_n.reshape(*batch, h))


def float32_input(x: Tensor, like: Tensor) -> Tensor:
    """``x`` rounded to float32, then in ``like``'s dtype."""
    return x.to(torch.float32).to(like.dtype)


def last_hidden(lstm: LSTMLayer, x: Tensor) -> Tensor:
    """The layer's output at the last time step, ``(..., H)``."""
    return lstm(x)[0][..., -1, :]


class LSTMPredictor(nn.Module):
    """``(..., history, in_features)`` -> ``(..., out_dim)``: ``n_layers``
    stacked LSTMs, a dense head on the last step."""

    def __init__(self, in_features: int, out_dim: int, hidden_size: int = 256,
                 n_layers: int = 1, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        widths = [in_features] + [hidden_size] * n_layers
        self.lstm = nn.ModuleList(
            LSTMLayer(widths[i], hidden_size, generator, device, dtype) for i in range(n_layers))
        self.layers = nn.ModuleList([dense(hidden_size, out_dim, generator, device, dtype)])

    def forward(self, window: Tensor) -> Tensor:
        x = float32_input(window, self.layers[0].weight)
        for lstm in self.lstm:
            x = lstm(x)[0]
        return self.layers[0](x[..., -1, :])


class LSTMNLLPredictor(nn.Module):
    """The next frame as a Gaussian: ``(mu, sigma)``, ``sigma = softplus(.)
    + min_sigma``."""

    def __init__(self, in_features: int, out_dim: int, hidden_size: int = 256,
                 min_sigma: float = 1e-3, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.min_sigma = min_sigma
        self.lstm = nn.ModuleList([LSTMLayer(in_features, hidden_size, generator, device, dtype)])
        self.layers = nn.ModuleList(
            dense(hidden_size, out_dim, generator, device, dtype) for _ in range(2))

    def forward(self, window: Tensor) -> Tuple[Tensor, Tensor]:
        h = last_hidden(self.lstm[0], float32_input(window, self.layers[0].weight))
        return self.layers[0](h), F.softplus(self.layers[1](h)) + self.min_sigma


def gaussian_nll(mu: Tensor, sigma: Tensor, target: Tensor) -> Tensor:
    """Constrained-Gaussian negative log likelihood, the mean over entries."""
    var = sigma ** 2
    return torch.mean(0.5 * torch.log(2 * math.pi * var) + 0.5 * (target - mu) ** 2 / var)


class SequenceDiscriminator(nn.Module):
    """LSTM critic: ``(..., T, in_features)`` -> one logit ``(...,)``."""

    def __init__(self, in_features: int, hidden_size: int = 128, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.lstm = nn.ModuleList([LSTMLayer(in_features, hidden_size, generator, device, dtype)])
        self.layers = nn.ModuleList([dense(hidden_size, 1, generator, device, dtype)])

    def forward(self, seq: Tensor) -> Tensor:
        h = last_hidden(self.lstm[0], float32_input(seq, self.layers[0].weight))
        return self.layers[0](h)[..., 0]


class Seq2Seq(nn.Module):
    """Encode a history window; decode ``L`` frames from the encoder's
    carry, the decoder fed one noise vector a step (``noise (..., L,
    noise_dim)``). The decoder reads only noise, so the whole decode is one
    LSTM call."""

    def __init__(self, in_features: int, out_dim: int, hidden_size: int = 256,
                 noise_dim: int = 16, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.noise_dim = noise_dim
        self.lstm = nn.ModuleList([LSTMLayer(in_features, hidden_size, generator, device, dtype),
                                   LSTMLayer(noise_dim, hidden_size, generator, device, dtype)])
        self.layers = nn.ModuleList([dense(hidden_size, out_dim, generator, device, dtype)])

    def noise_shape(self, batch_shape, decode_len: int) -> tuple:
        """The decoder noise's shape: ``batch_shape + (L, noise_dim)``."""
        return tuple(batch_shape) + (decode_len, self.noise_dim)

    def decode(self, window: Tensor, noise: Tensor) -> Tensor:
        _, carry = self.lstm[0](float32_input(window, self.layers[0].weight))
        return self.lstm[1](noise, carry)[0]

    def forward(self, window: Tensor, noise: Tensor) -> Tensor:
        """``window (..., T, in)``, ``noise (..., L, noise_dim)`` -> ``(..., L,
        out_dim)``."""
        return self.layers[0](self.decode(window, noise))


class Seq2SeqNLL(Seq2Seq):
    """Seq2Seq with a Gaussian ``(mu, sigma)`` head a decoded step."""

    def __init__(self, in_features: int, out_dim: int, hidden_size: int = 256,
                 noise_dim: int = 16, min_sigma: float = 1e-3, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(in_features, out_dim, hidden_size, noise_dim, generator, device, dtype)
        self.min_sigma = min_sigma
        self.layers.append(dense(hidden_size, out_dim, generator, device, dtype))

    def forward(self, window: Tensor, noise: Tensor) -> Tuple[Tensor, Tensor]:
        h = self.decode(window, noise)
        return self.layers[0](h), F.softplus(self.layers[1](h)) + self.min_sigma
