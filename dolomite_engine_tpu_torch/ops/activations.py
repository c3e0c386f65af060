"""Activation registry (base + GLU family), functional PyTorch versions.

Counterpart of `dolomite_engine_tpu/ops/activations.py`: the same names and the same GLU
semantics — the last dim splits as ``[up | gate]`` and the result is
``up * act(gate)`` — so the fused ``c_fc`` weight layout is shared with the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def _laplace(x, mu: float = 0.707107, sigma: float = 0.282095):
    return 0.5 * (1.0 + torch.erf((x - mu) / (sigma * math.sqrt(2.0))))


def _relu2(x):
    return F.relu(x).square()


def _hard_shrink(x, lambd: float = 0.5):
    return torch.where(x.abs() > lambd, x, torch.zeros_like(x))


def _soft_shrink(x, lambd: float = 0.5):
    return torch.sign(x) * torch.clamp(x.abs() - lambd, min=0.0)


def _tanh_shrink(x):
    return x - torch.tanh(x)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


_BASE_ACTIVATIONS: dict[str, Activation] = {
    "celu": F.celu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "selu": F.selu,
    "hard_shrink": _hard_shrink,
    # jax.nn.hard_sigmoid / hard_swish: relu6(x + 3) / 6 (torch's own equals it)
    "hard_sigmoid": lambda x: F.relu6(x + 3.0) / 6.0,
    "hard_swish": lambda x: x * F.relu6(x + 3.0) / 6.0,
    "hard_tanh": F.hardtanh,
    "laplace": _laplace,
    "leaky_reLU": lambda x: F.leaky_relu(x, 0.01),
    "log_sigmoid": F.logsigmoid,
    "mish": _mish,
    "prelu": lambda x: torch.where(x >= 0, x, 0.25 * x),
    "relu": F.relu,
    "relu2": _relu2,
    "relu_squared": _relu2,
    "relu6": F.relu6,
    "rrelu": lambda x: torch.where(x >= 0, x, (1.0 / 8 + 1.0 / 3) / 2 * x),  # eval-mode rrelu
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "softplus": F.softplus,
    "soft_plus": F.softplus,
    "soft_shrink": _soft_shrink,
    "soft_sign": F.softsign,
    "tanh": torch.tanh,
    "tanh_shrink": _tanh_shrink,
}

_GLU_BASE_MAPPING = {
    "ceglu": "celu",
    "eglu": "elu",
    "geglu": "gelu",
    "miglu": "mish",
    "mishglu": "mish",
    "preglu": "prelu",
    "reglu": "relu",
    "rreglu": "rrelu",
    "seglu": "selu",
    "swiglu": "swish",
}


def is_glu(name: str) -> bool:
    return name.endswith("glu")


def get_base_activation(name: str) -> Activation:
    if name in _BASE_ACTIVATIONS:
        return _BASE_ACTIVATIONS[name]
    raise ValueError(f"invalid activation function '{name}'")


def get_glu_activation(name: str) -> Activation:
    if name in ("glu", "sigmoid_glu"):
        base = torch.sigmoid
    else:
        if name in _GLU_BASE_MAPPING:
            name = _GLU_BASE_MAPPING[name]
        elif name.endswith("_glu"):
            name = name[: -len("_glu")]
        else:
            raise ValueError(f"invalid activation function '{name}'")
        base = get_base_activation(name)

    def glu(x: torch.Tensor) -> torch.Tensor:
        up, gate = x.chunk(2, dim=-1)
        return up * base(gate)

    return glu


def get_activation_function(name: str) -> Activation:
    return get_glu_activation(name) if is_glu(name) else get_base_activation(name)
