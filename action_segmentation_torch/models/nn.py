"""Small neural-net building blocks.

Twin of ``action_segmentation_tpu/models/nn.py`` as ``nn.Module``s with
PyTorch's layouts: a linear layer's weight is (out, in), the transpose of
the JAX package's ``w`` (``bridge.py`` transposes). Initial weights come
from an explicit CPU ``torch.Generator`` and are then moved to the
device, so a seed gives the same model on the CPU and on the card; the
draws follow the JAX package's distributions, not its stream.

The reference overrides only parameters of dim > 1 with xavier-uniform
(semimarkov_modules.py:814-816), so every bias keeps torch's default,
U(-1/sqrt(in), 1/sqrt(in)), on the xavier path too.
"""

import math

import torch
from torch import nn


def uniform(shape, bound, generator):
    """U(-bound, bound) float32 draws on the CPU from `generator`."""
    return (torch.rand(shape, generator=generator, dtype=torch.float32) * 2 - 1) * bound


def xavier_uniform(shape, generator):
    """Xavier-uniform over (fan_in, fan_out) = (shape[0], shape[-1]), the
    JAX package's convention; torch's (out, in) layout has the same sum."""
    return uniform(shape, math.sqrt(6.0 / (shape[0] + shape[-1])), generator)


def linear(in_f, out_f, generator, xavier=False, zero=False, device=None):
    """``nn.Linear(in_f, out_f)`` with the JAX package's ``linear_init``
    draws: torch-default bias; weight xavier-uniform or torch-default
    U(-1/sqrt(in), 1/sqrt(in)); all zeros with `zero` (no draws)."""
    layer = nn.Linear(in_f, out_f, device="meta")
    if zero:
        w, b = torch.zeros(out_f, in_f), torch.zeros(out_f)
    else:
        bound = 1.0 / math.sqrt(in_f)
        b = uniform((out_f,), bound, generator)
        w = xavier_uniform((out_f, in_f), generator) if xavier else uniform(
            (out_f, in_f), bound, generator)
    layer.weight = nn.Parameter(w.to(device))
    layer.bias = nn.Parameter(b.to(device))
    return layer


class MLP(nn.Module):
    """Plain ReLU MLP over dims = [in, h1, ..., out]."""

    def __init__(self, dims, generator, xavier=False, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            linear(a, b, generator, xavier, device=device) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x, final_activation=False):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        x = self.layers[-1](x)
        return torch.relu(x) if final_activation else x


class ResidualLayer(nn.Module):
    """relu(lin2(relu(lin1(h)))) + h (semimarkov_modules.py:42-49)."""

    def __init__(self, dim, generator, xavier=True, device=None):
        super().__init__()
        self.lin1 = linear(dim, dim, generator, xavier, device=device)
        self.lin2 = linear(dim, dim, generator, xavier, device=device)

    def forward(self, h):
        return torch.relu(self.lin2(torch.relu(self.lin1(h)))) + h


def residual_mlp(in_dim, hidden, out_dim, n_residual, generator, xavier=True, device=None):
    """[Linear, n x ResidualLayer, Linear]: the reference's Sequential, so
    its state dict carries the reference's names (``0.weight``,
    ``1.lin1.weight``, ..., ``{n+1}.weight``)."""
    return nn.Sequential(
        linear(in_dim, hidden, generator, xavier, device=device),
        *(ResidualLayer(hidden, generator, xavier, device) for _ in range(n_residual)),
        linear(hidden, out_dim, generator, xavier, device=device),
    )
