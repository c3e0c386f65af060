"""The train step: gradient accumulation, global-norm clipping, non-finite skip; the
analytic FLOPs model.

Counterpart of `dolomite_engine_tpu/train_utils.py`. The JAX step scans micro-batches
and accumulates ``acc + g / n`` in fp32; here each parameter's gradient is folded into
its fp32 accumulator the moment autograd has finished it (a post-accumulate hook) and
then released, so one model's worth of gradients is live, as in the JAX program.
"""

from __future__ import annotations

import logging
import os
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from .ops.activations import is_glu
from .optimization.optimizer import TorchAdamW
from .utils import get_telemetry, log_rank_0


@dataclass
class TrainState:
    """The JAX `TrainState`'s fields: the step counter, the parameters (the model's) and
    the optimizer state (the optimizer's)."""

    model: nn.Module
    optimizer: TorchAdamW
    step: int = 0

    def state_dict(self, with_optimizer: bool = True) -> dict:
        """The checkpoint's tree, all tensors: the step, the model's state by name and,
        `with_optimizer`, the AdamW moments by parameter name (in their storage dtypes)
        and both of its counters. The model's and the moments' tensors are the live ones,
        so a restore into this tree writes the state in place; `load_state_dict` then takes
        the counters back."""
        tree = {"step": torch.tensor(self.step), "model": self.model.state_dict()}
        if with_optimizer:
            names = [name for name, _ in self.model.named_parameters()]
            state = self.optimizer.state_dict()
            tree["optimizer"] = {
                "mu": dict(zip(names, state["mu"], strict=True)),
                "nu": dict(zip(names, state["nu"], strict=True)),
                "count": torch.tensor(state["count"]),
                "schedule_count": torch.tensor(state["schedule_count"]),
            }
        return tree

    def load_state_dict(self, tree: dict) -> None:
        """Take the step and the optimizer's counters from a restored `state_dict` tree
        (its tensors were restored in place)."""
        self.step = int(tree["step"])
        if "optimizer" in tree:
            self.optimizer.count = int(tree["optimizer"]["count"])
            self.optimizer.schedule_count = int(tree["optimizer"]["schedule_count"])


def clip_grad_norm(grads: list[torch.Tensor], max_norm: float | None):
    """Global-norm clip in place; returns (grads, fp32 grad norm)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    grad_norm = torch.linalg.vector_norm(torch.stack(norms))
    if max_norm is None:
        return grads, grad_norm
    scale = torch.clamp(max_norm / (grad_norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, grad_norm


def make_train_step(
    loss_fn: Callable[[dict], torch.Tensor],
    optimizer: TorchAdamW,
    gradient_accumulation_steps: int = 1,
    gradient_clipping: float | None = 1.0,
    skip_nonfinite: bool = False,
    offload_optimizer: bool = False,
    collect_health: bool = False,
    fp8: bool = False,
):
    """Build ``train_step(state, batch) -> metrics``.

    `loss_fn(micro_batch)` returns the scalar loss of one micro-batch; every tensor of
    `batch` has a leading ``[gradient_accumulation_steps]`` axis. `skip_nonfinite`:
    when the loss or the global grad-norm is not finite, the parameters and the
    optimizer state stay as they were, ``metrics["skipped"]`` is 1, and the step still
    advances."""
    if offload_optimizer:
        raise NotImplementedError("cpu_offload is not ported yet: ROADMAP.md Queue A, 'CPU offload'")
    if collect_health:
        raise NotImplementedError(
            "training health metrics are not ported yet: ROADMAP.md Queue A, 'Training health metrics'"
        )
    if fp8:
        raise NotImplementedError("fp8 training is not ported yet: ROADMAP.md Queue A, 'fp8 training'")
    n = gradient_accumulation_steps
    params = optimizer.params

    def micro_batch(batch: dict, i: int) -> dict:
        return {name: value[i] for name, value in batch.items()}

    def train_step(state: TrainState, batch: dict) -> dict:
        for p in params:
            p.grad = None
        if n == 1:
            loss = loss_fn(micro_batch(batch, 0))
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad.float() for p in params]
            loss = loss.detach().float()
        else:
            acc: list[torch.Tensor | None] = [None] * len(params)

            def fold(i: int):
                def hook(p: torch.Tensor) -> None:
                    g = p.grad.float().div_(n)  # in place when the gradient is already fp32
                    acc[i] = g if acc[i] is None else acc[i].add_(g)
                    p.grad = None

                return hook

            handles = [p.register_post_accumulate_grad_hook(fold(i)) for i, p in enumerate(params)]
            try:
                loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
                for i in range(n):
                    micro_loss = loss_fn(micro_batch(batch, i))
                    micro_loss.backward()
                    loss = loss + micro_loss.detach().float() / n
            finally:
                for handle in handles:
                    handle.remove()
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, acc)]

        grads, grad_norm = clip_grad_norm(grads, gradient_clipping)
        step_ok = True
        if skip_nonfinite:
            step_ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if step_ok:
            optimizer.step(grads)
        state.step += 1
        metrics = {"loss": loss.item(), "grad_norm": grad_norm.item()}
        if skip_nonfinite:
            metrics["skipped"] = int(not step_ok)
        return metrics

    return train_step


def handle_nonfinite_step(skipped: bool, consecutive: int, global_step: int, max_consecutive: int) -> int:
    """Host-side consecutive-skip accounting of the train loop (the JAX package's).

    Returns the updated consecutive-skip count; raises RuntimeError once `max_consecutive`
    non-finite steps occur back to back."""
    if not skipped:
        return 0
    consecutive += 1
    get_telemetry().count("nan_skips", event=True, step=global_step)
    log_rank_0(
        logging.WARNING,
        f"non-finite loss/grad-norm at step {global_step}: optimizer update skipped "
        f"({consecutive} consecutive, abort at {max_consecutive})",
    )
    if consecutive >= max_consecutive:
        raise RuntimeError(
            f"aborting: {consecutive} consecutive non-finite training steps (threshold "
            f"fault_tolerance_args.max_consecutive_nonfinite_steps={max_consecutive}) — "
            "loss has diverged or a data shard is poisoned; resume from the last "
            "checkpoint with a lower LR or different data skip"
        )
    return consecutive


def track_train_metrics(
    global_step: int,
    train_loss_step: float,
    grad_norm: float,
    current_lr: float,
    experiments_tracker,
    loss_running_mean: float,
    flops: float | None = None,
    billion_tokens_per_day: float | None = None,
    step_time: float | None = None,
    mfu: float | None = None,
) -> None:
    """Log (and track) one step's metrics under the JAX package's names."""
    metrics = {"loss_step": train_loss_step, "loss_running_mean": loss_running_mean, "learning_rate": current_lr}
    if grad_norm is not None:
        metrics["grad_norm"] = grad_norm
    if flops is not None:
        metrics["FLOPS"] = flops
    if mfu is not None:
        metrics["MFU (%)"] = mfu
    if billion_tokens_per_day is not None:
        metrics["throughput (B tokens/day)"] = billion_tokens_per_day
    if step_time is not None:
        metrics["step time (sec)"] = step_time
    if experiments_tracker is not None:
        experiments_tracker.track(metrics, step=global_step, context="train")
    message = f"step = {global_step}, " + ", ".join(
        f"{k} = {v:.4g}" if isinstance(v, float) else f"{k} = {v}" for k, v in metrics.items()
    )
    log_rank_0(logging.INFO, message)


def get_profiler_context(trace_path: str | None, global_step: int, wait: int = 5, active: int = 1):
    """A `torch.profiler` trace of the absolute global steps (wait, wait + active], as the
    JAX package schedules its trace: each such step is written as a Chrome trace
    ``<trace_path>/step<N>.json``; a run resumed past the window traces nothing."""
    if trace_path is None or not wait < global_step <= wait + active:
        return nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_path, exist_ok=True)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=lambda prof: prof.export_chrome_trace(os.path.join(trace_path, f"step{global_step}.json")),
    )


def resolve_checkpointing_args(
    gradient_checkpointing_method, gradient_checkpointing_args: dict | None
) -> tuple[int, str]:
    """``(checkpoint_every, policy)`` from the gradient-checkpointing knobs, as the JAX
    package reads them."""
    args = gradient_checkpointing_args or {}
    every = 0
    if gradient_checkpointing_method is not None or args:
        every = max(int(args.get("checkpoint_every", args.get("block_frequency", 1))), 1)
    policy = args.get("policy", args.get("checkpoint_policy")) or "full"
    return every, policy


def get_model_tflops(
    config,
    batch_size: int,
    sequence_length: int,
    gradient_checkpointing_method=None,
    gradient_checkpointing_args: dict | None = None,
) -> float:
    """Analytic model TFLOPs per step (the JAX package's formula): attention
    ``4bsh(h(1 + k/n) + s)``, MLP ``4bshf`` (+ ``2bshf`` for GLU) times the
    ``num_experts_per_tok`` experts each token runs in an MoE model, LM head ``6bshv``,
    backward twice the forward, plus one forward per block the ``full`` remat policy
    reruns. The port's remat has only that policy; router FLOPs are left out, as there."""
    b, s, h = batch_size, sequence_length, config.n_embd
    f, n, k = config.n_inner, config.n_head, config.num_key_value_heads
    attention_flops = 4 * b * s * h * (h * (1 + k / n) + s)
    mlp_flops = 4 * b * s * h * f
    if is_glu(config.activation_function):
        mlp_flops += 2 * b * s * h * f
    active_experts = getattr(config, "num_experts_per_tok", None)
    if active_experts:
        mlp_flops *= active_experts
    forward = config.n_layer * (attention_flops + mlp_flops)
    every, policy = resolve_checkpointing_args(gradient_checkpointing_method, gradient_checkpointing_args)
    recompute = 0.0
    if every:
        if policy != "full":
            raise NotImplementedError(
                f"remat policy '{policy}' is not ported yet: ROADMAP.md Queue A, 'Remat policies'"
            )
        recompute = config.n_layer * (attention_flops + mlp_flops) / every
    lm_head = 6 * b * s * h * config.vocab_size
    return (forward + 2 * forward + recompute + lm_head) / 1e12
