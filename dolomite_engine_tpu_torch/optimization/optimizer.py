"""AdamW with optax semantics, and the optimizer factory with µP groups.

Counterpart of `dolomite_engine_tpu/optimization/optimizer.py`, whose Adam-family names
all build ``optax.adamw``: bias-corrected moments, weight decay on every parameter (no
mask), ``update = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``. The first moment may be
stored in bf16 (`mu_dtype`) while the arithmetic stays fp32: the moment is read to fp32,
updated, used, and only then rounded for storage, as optax does. `torch.optim.AdamW`
keeps its moments in the parameter dtype, so the port carries its own update, in
`torch._foreach` ops over groups of parameters bounded in bytes (the temporaries of
one group, not of the whole model, are live at a time).
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import Callable

import torch
from torch import nn

from ..enums import ParamsGroupMethod
from ..utils.mixed_precision import string_to_dtype

# every optimizer name of the JAX package that builds optax.adamw
ADAMW_NAMES = (
    "TorchAdamW",
    "ApexFusedAdam",
    "DeepSpeedCPUAdam",
    "DeepSpeedFusedAdam",
    "DeepSpeedOnebitAdam",
    "DeepSpeedZeroOneAdam",
)

_GROUP_BYTES = 1 << 29  # fp32 bytes of parameters updated per foreach group


class TorchAdamW:
    """optax ``adamw(lr_schedule, b1, b2, eps, weight_decay, mu_dtype)`` over `params`.

    Two counters, as optax's state has: `count` (``ScaleByAdamState.count``, the bias
    correction's) and `schedule_count` (``ScaleByScheduleState.count``): the update that
    follows `schedule_count` scheduled updates takes ``lr_schedule(schedule_count)``. Both
    start at 0 and advance together; a resume without the learning rate zeroes only the
    schedule's (`checkpointing.load_checkpoint_for_training`). `lr_multipliers` scale the
    lr per parameter (µP groups)."""

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        lr_schedule: Callable[[int], float],
        betas: tuple[float, float] = (0.9, 0.95),
        eps: float = 1e-10,
        weight_decay: float = 0.1,
        mu_dtype: torch.dtype | str | None = None,
        lr_multipliers: Iterable[float] | None = None,
    ) -> None:
        self.params = list(params)
        self.lr_schedule = lr_schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        mu_dtype = string_to_dtype(mu_dtype)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.schedule_count = 0
        multipliers = [1.0] * len(self.params) if lr_multipliers is None else list(lr_multipliers)
        self._groups = self._make_groups(multipliers)

    def _make_groups(self, multipliers: list[float]) -> list[tuple[float, list[int]]]:
        """Index lists of parameters that share an lr multiplier, each under _GROUP_BYTES."""
        groups = []
        for multiplier in sorted(set(multipliers)):
            indices, size = [], 0
            for i, m in enumerate(multipliers):
                if m != multiplier:
                    continue
                nbytes = self.params[i].numel() * 4
                if indices and size + nbytes > _GROUP_BYTES:
                    groups.append((multiplier, indices))
                    indices, size = [], 0
                indices.append(i)
                size += nbytes
            if indices:
                groups.append((multiplier, indices))
        return groups

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """Apply one update with fp32 `grads` (one per parameter, in order)."""
        lr = float(self.lr_schedule(self.schedule_count))
        self.schedule_count += 1
        self.count += 1
        bias1 = 1 - self.b1**self.count
        bias2 = 1 - self.b2**self.count
        for multiplier, indices in self._groups:
            params = [self.params[i] for i in indices]
            g = [grads[i] for i in indices]
            mu = [self.mu[i] for i in indices]
            nu = [self.nu[i] for i in indices]
            # m = (1 - b1) g + b1 m and v = (1 - b2) g^2 + b2 v; as in optax, b1 m is taken
            # in the moment's storage dtype (b1 rounded to it too) and the sum in fp32
            b1 = torch.tensor(self.b1, dtype=mu[0].dtype).item()
            m32 = torch._foreach_mul(g, 1 - self.b1)
            torch._foreach_add_(m32, [m.float() for m in torch._foreach_mul(mu, b1)])
            g_sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(g_sq, 1 - self.b2)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, g_sq)
            del g_sq
            # u = m_hat / (sqrt(v_hat) + eps) + wd p; p += -lr u
            denom = torch._foreach_div(nu, bias2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(m32, bias1)
            torch._foreach_div_(update, denom)
            del denom
            if self.weight_decay:
                torch._foreach_add_(update, torch._foreach_mul(params, self.weight_decay))
            torch._foreach_mul_(update, -lr * multiplier)
            torch._foreach_add_(params, update)
            for m, new in zip(mu, m32):
                m.copy_(new)  # rounded to the moment's storage dtype after use


    def state_dict(self) -> dict:
        """The moments (in their storage dtypes, in parameter order) and both counters."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count, "schedule_count": self.schedule_count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` (or one restored from a checkpoint) into this optimizer."""
        for name in ("mu", "nu"):
            if len(state[name]) != len(self.params):
                raise ValueError(f"{name} holds {len(state[name])} tensors for {len(self.params)} parameters")
            for live, saved in zip(getattr(self, name), state[name]):
                live.copy_(saved)
        self.count = int(state["count"])
        self.schedule_count = int(state["schedule_count"])


def mup_lr_multipliers(named_params: Iterable[tuple[str, nn.Parameter]], m_width: float) -> list[float]:
    """``1 / m_width`` for the non-bias weights of attention / MLP modules, 1 elsewhere
    (the JAX package's `get_mup_label_tree` over the same module names)."""
    multipliers = []
    for name, _ in named_params:
        parts = name.split(".")
        in_mup_module = any(part in ("attn", "mlp", "moe") for part in parts)
        multipliers.append(1.0 / m_width if in_mup_module and parts[-1] != "bias" else 1.0)
    return multipliers


def get_optimizer(
    optimizer_class_name: str,
    optimizer_class_args: dict,
    lr_schedule: Callable[[int], float],
    named_params: Iterable[tuple[str, nn.Parameter]],
    params_group_method: ParamsGroupMethod | str | None = None,
    model_config=None,
) -> TorchAdamW:
    """The optimizer over `named_params` (``model.named_parameters()``)."""
    if optimizer_class_name not in ADAMW_NAMES:
        raise NotImplementedError(
            f"optimizer '{optimizer_class_name}' is not ported yet (the AdamW family is): "
            "ROADMAP.md Queue A, 'Other optimizers'"
        )
    named_params = list(named_params)
    multipliers = None
    if params_group_method is not None:
        if ParamsGroupMethod(params_group_method) != ParamsGroupMethod.mup:
            raise ValueError(f"unexpected params_group_method ({params_group_method})")
        assert model_config is not None and model_config.init_method == "mup", (
            "both init method for model and params group method for optimizer should be set to mup"
        )
        multipliers = mup_lr_multipliers(named_params, model_config.m_width)
    args = optimizer_class_args
    return TorchAdamW(
        [p for _, p in named_params],
        lr_schedule,
        betas=tuple(args.get("betas", (0.9, 0.95))),
        eps=args.get("eps", 1e-10),
        weight_decay=args.get("weight_decay", 0.1),
        mu_dtype=args.get("mu_dtype"),
        lr_multipliers=multipliers,
    )


def build_optimizer_from_args(args, model) -> tuple[TorchAdamW, Callable[[int], float]]:
    """(optimizer, lr schedule) from `TrainingArgs` over a model wrapper's parameters (the
    JAX package's `finetune.build_optimizer_from_args`)."""
    from .scheduler import get_scheduler

    lr_scheduler_args = args.lr_scheduler_args
    lr_schedule = get_scheduler(
        num_warmup_steps=lr_scheduler_args.num_warmup_steps,
        num_constant_steps=lr_scheduler_args.num_constant_steps,
        num_decay_steps=lr_scheduler_args.num_decay_steps,
        num_training_steps=args.training_parameters.num_training_steps,
        lr_decay_style=lr_scheduler_args.lr_decay_style,
        lr_decay_factor=lr_scheduler_args.lr_decay_factor,
        extra_lr_scheduler_args=lr_scheduler_args.extra_lr_scheduler_args,
        base_lr=args.optimizer_args.class_args.get("lr", 1e-5),
    )
    optimizer = get_optimizer(
        optimizer_class_name=args.optimizer_args.class_name,
        optimizer_class_args=args.optimizer_args.class_args,
        lr_schedule=lr_schedule,
        named_params=model.model.named_parameters(),
        params_group_method=args.optimizer_args.params_group_method,
        model_config=model.config,
    )
    return optimizer, lr_schedule
