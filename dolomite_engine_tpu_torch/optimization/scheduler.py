"""LR schedules: linear warmup -> constant -> decay, as plain functions of the step.

Counterpart of `dolomite_engine_tpu/optimization/scheduler.py`, with the same boundaries:
warmup over `num_warmup_steps` (step 0 of a warmup has lr 0, as under optax, whose
schedules see the count of updates already applied), flat until `num_warmup_steps +
num_constant_steps`, decay until `num_training_steps` (or the constant boundary plus
`num_decay_steps`), floored at `lr_decay_factor`.
"""

from __future__ import annotations

import math
from typing import Callable

from ..enums import LRDecaySchedule

Schedule = Callable[[int], float]


def get_scheduler_factor(
    num_warmup_steps: int,
    num_constant_steps: int,
    num_decay_steps: int | None,
    num_training_steps: int,
    lr_decay_style: LRDecaySchedule,
    lr_decay_factor: float,
    extra_lr_scheduler_args: dict | None = None,
    base_lr: float | None = None,
) -> Schedule:
    """f(step) in [0, 1]; multiply with the base lr."""
    extra = extra_lr_scheduler_args or {}
    warmup_boundary = num_warmup_steps
    constant_boundary = warmup_boundary + num_constant_steps
    decay_boundary = num_training_steps
    if num_decay_steps is not None:
        decay_boundary = constant_boundary + num_decay_steps
    decay_span = max(decay_boundary - constant_boundary, 1)

    def in_warmup(step) -> bool:
        return warmup_boundary > 0 and step <= warmup_boundary

    def with_warmup(step, decay: Callable[[int], float]) -> float:
        if in_warmup(step):
            return step / max(warmup_boundary, 1)
        if step <= constant_boundary:
            return 1.0
        return decay(step)

    def clipped(step) -> int:
        return min(max(step - constant_boundary, 0), decay_span)

    if lr_decay_style == LRDecaySchedule.constant:
        return lambda step: step / max(warmup_boundary, 1) if in_warmup(step) else 1.0
    if lr_decay_style == LRDecaySchedule.cosine:
        return lambda step: with_warmup(
            step,
            lambda s: (1 - lr_decay_factor) * (1 + math.cos(math.pi * clipped(s) / decay_span)) / 2
            + lr_decay_factor,
        )
    if lr_decay_style == LRDecaySchedule.linear:
        return lambda step: with_warmup(
            step, lambda s: 1 + (lr_decay_factor - 1) * clipped(s) / decay_span
        )
    if lr_decay_style == LRDecaySchedule.exponential:
        # the whole decay phase, normalized so f(0) = 1 and f(decay_span) = lr_decay_factor
        a = (1 - lr_decay_factor) * math.e / (math.e - 1)
        b = (lr_decay_factor * math.e - 1) / (math.e - 1)
        return lambda step: with_warmup(
            step, lambda s: a * math.exp(-max(s - constant_boundary, 0) / decay_span) + b
        )
    if lr_decay_style == LRDecaySchedule.power:
        assert num_constant_steps == 0, "num_constant_steps should be 0 for power law scheduler"
        assert base_lr is not None, "power schedule needs the base lr to normalize `a`"
        pa, pb, pc = extra["a"], extra["b"], extra["c"]
        max_warmup_factor = min(1.0, (pa / base_lr) * (max(num_warmup_steps, 1) * pc) ** pb)

        def power(step) -> float:
            if in_warmup(step):
                return max_warmup_factor * step / max(warmup_boundary, 1)
            return min(1.0, (pa / base_lr) * max(step * pc, 1e-30) ** pb)

        return power
    raise ValueError(f"invalid lr_decay_style ({lr_decay_style})")


def get_scheduler(
    num_warmup_steps: int,
    num_constant_steps: int,
    num_decay_steps: int | None,
    num_training_steps: int,
    lr_decay_style: LRDecaySchedule | str,
    lr_decay_factor: float,
    extra_lr_scheduler_args: dict | None = None,
    base_lr: float = 1.0,
) -> Schedule:
    """f(step) -> absolute lr."""
    factor = get_scheduler_factor(
        num_warmup_steps,
        num_constant_steps,
        num_decay_steps,
        num_training_steps,
        LRDecaySchedule(lr_decay_style),
        lr_decay_factor,
        extra_lr_scheduler_args,
        base_lr=base_lr,
    )
    return lambda step: base_lr * factor(step)
