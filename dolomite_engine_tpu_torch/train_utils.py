"""The train step: gradient accumulation, global-norm clipping, non-finite skip; the
analytic FLOPs model.

Counterpart of `dolomite_engine_tpu/train_utils.py`. The JAX step scans micro-batches
and accumulates ``acc + g / n`` in fp32; here the micro-batches' gradients add up in each
parameter's own ``.grad`` (autograd's accumulation, or FSDP2's, which adds each
micro-batch's reduced shards into the sharded ``.grad``), and the sum is divided by n once
after the last backward. The trainable parameters are fp32 (the master weights), so the
sum is fp32 and one model's worth of gradients is live, as in the JAX program (a separate
accumulator folded after each backward would hold two at its end: 13.9 GB more for
granite-3b-code, past the card's budget); for n a power of two it is JAX's ``acc + g / n``
bit for bit, since halving commutes with fp32 rounding, and otherwise within one rounding
of it.

Over data-parallel ranks every statistic is global: the grad norm, the health statistics
and the optimizers' per-tensor norms sum the local shards' squares and all-reduce them
over the shard group (`parallel/sharding.py`); the logged loss is the mean over the ranks,
so the non-finite verdict is the same on every rank. There each rank's loss is its share
of the global batch's (the model's losses divide by the global token count, `ops/loss.py`)
and FSDP2 sums the gradients: the logged loss is the sum over the ranks.
"""

from __future__ import annotations

import logging
import os
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from .ops.activations import is_glu
from .ops.fp8 import Fp8State
from .optimization.optimizer import Optimizer
from .parallel.sharding import all_reduce_, like, local, shard_group
from .utils import get_telemetry, log_rank_0
from .utils.diagnostics import group_health, health_groups, squared_norms


@dataclass
class TrainState:
    """The JAX `TrainState`'s fields: the step counter, the parameters (the model's), the
    optimizer state (the optimizer's) and, in an fp8 run, the delayed-scaling state
    (`ops/fp8.Fp8State`, JAX's ``TrainState.fp8``)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    fp8: Fp8State | None = None

    def state_dict(self, with_optimizer: bool = True) -> dict:
        """The checkpoint's tree, all tensors: the step, the model's state by name, the
        fp8 state and, `with_optimizer`, the optimizer's state lists by the names of the
        trainable parameters, the ones it updates (in their storage dtypes), and both of its
        counters. The tensors are the live ones, so a
        restore into this tree writes the state in place; `load_state_dict` then takes the
        counters back."""
        tree = {"step": torch.tensor(self.step), "model": self.model.state_dict()}
        if self.fp8 is not None:
            tree["fp8"] = dict(self.fp8.tensors)
        if with_optimizer:
            # only the trainable parameters hold state (PEFT freezes the base)
            names = [name for name, p in self.model.named_parameters() if p.requires_grad]
            state = self.optimizer.state_dict()
            trainable = [p for p in self.model.parameters() if p.requires_grad]
            tree["optimizer"] = {
                **{
                    key: {name: like(p, t) for name, p, t in zip(names, trainable, state[key], strict=True)}
                    for key in self.optimizer.state_names
                },
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


def clip_grad_norm(grads: list[torch.Tensor], max_norm: float | None, group=None):
    """Global-norm clip in place; returns (grads, fp32 grad norm). On a card the norm is one
    fused ``_foreach_norm`` pass; elsewhere it is the JAX package's formula, the summed fp32
    squares (the CPU's ``_foreach_norm`` loses ~1e-4 relative on a 4 M-element tensor).
    `grads` are local shards when `group` is given: their summed squares are all-reduced
    over it before the root."""
    if grads and grads[0].device.type == "cuda":
        norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
        if group is None:
            grad_norm = torch.linalg.vector_norm(norms)
        else:
            grad_norm = all_reduce_(norms.square().sum(), group).sqrt()
    else:
        grad_norm = all_reduce_(torch.stack(squared_norms(grads)).sum(), group).sqrt()
    if max_norm is None:
        return grads, grad_norm
    scale = torch.clamp(max_norm / (grad_norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, grad_norm


_CPU_OFFLOAD_WARNED = False


def resolve_cpu_offload(args, device: torch.device | str) -> bool:
    """``distributed_args.cpu_offload``: the optimizer state in pinned host memory, streamed
    to the card for each update. Off a CUDA device there is nothing to offload from: warn
    once and ignore the option, as the JAX package does off the TPU."""
    if not args.distributed_args.cpu_offload:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        return True
    global _CPU_OFFLOAD_WARNED
    if not _CPU_OFFLOAD_WARNED:
        _CPU_OFFLOAD_WARNED = True
        log_rank_0(
            logging.WARNING,
            f"cpu_offload ignored on device '{device.type}' (pinned-host optimizer streaming "
            "requires a CUDA device)",
        )
    return False


def make_train_step(
    loss_fn: Callable[[dict], torch.Tensor],
    optimizer: Optimizer,
    gradient_accumulation_steps: int = 1,
    gradient_clipping: float | None = 1.0,
    skip_nonfinite: bool = False,
    offload_optimizer: bool = False,
    collect_health: bool = False,
):
    """Build ``train_step(state, batch) -> metrics``.

    `loss_fn(micro_batch)` returns the scalar loss of one micro-batch; every tensor of
    `batch` has a leading ``[gradient_accumulation_steps]`` axis. `skip_nonfinite`:
    when the loss or the global grad-norm is not finite, the parameters, the optimizer
    state and the fp8 state stay as they were, ``metrics["skipped"]`` is 1, and the step
    still advances.

    `offload_optimizer` (``cpu_offload``): the optimizer state lives in pinned host memory
    and streams to the card for the update (`Optimizer.offload_state`); `resolve_cpu_offload`
    turns the option off, with a warning, for a CPU model. `collect_health` (``health.interval > 0``):
    ``metrics["health"]`` holds `per_group_health`'s statistics, still on the device.

    With ``state.fp8`` (an fp8 run) the delayed-scaling state threads through the
    micro-batches as JAX's scan carries it: each micro-batch quantizes with the state the
    previous one left, and its forward and backward stage the next state, committed after
    its backward (`ops/fp8.Fp8State`); a skipped step restores the state the step began
    with."""
    n = gradient_accumulation_steps
    params = optimizer.params
    if offload_optimizer:
        optimizer.offload_state()
    groups = health_groups(optimizer.param_names, len(params)) if collect_health else None
    group = shard_group(params[0]) if params else None
    world = dist.get_world_size() if dist.is_initialized() else 1

    def micro_batch(batch: dict, i: int) -> dict:
        return {name: value[i] for name, value in batch.items()}

    def reduced(squares: list[torch.Tensor]) -> list[torch.Tensor]:
        """Per-tensor squared norms of the shards -> of the whole tensors."""
        if group is None or not squares:
            return squares
        return list(all_reduce_(torch.stack(squares), group).unbind())

    def train_step(state: TrainState, batch: dict) -> dict:
        fp8 = state.fp8
        fp8_before = fp8.snapshot() if fp8 is not None else None
        for p in params:
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for i in range(n):
            micro_loss = loss_fn(micro_batch(batch, i))
            micro_loss.backward()  # adds into each parameter's .grad
            if fp8 is not None:
                fp8.commit()  # the next micro-batch quantizes with this one's state
            loss = loss + micro_loss.detach().float() / n
        grads = [torch.zeros_like(local(p)) if p.grad is None else local(p.grad).float().div_(n) for p in params]
        for p in params:
            p.grad = None  # the gradients live on in `grads` until the step ends

        if world > 1:  # the ranks' shares of the global batch's loss
            loss = all_reduce_(loss, dist.group.WORLD)
        grads, grad_norm = clip_grad_norm(grads, gradient_clipping, group)
        step_ok = True
        if skip_nonfinite:
            step_ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        param_sq = reduced(squared_norms([local(p) for p in params])) if collect_health else None  # before the update
        update_sq = None
        if step_ok:
            update_sq = optimizer.step(grads, track_update=collect_health)
            if update_sq is not None:
                update_sq = reduced(update_sq)
        elif fp8 is not None:
            fp8.restore(fp8_before)  # the stepped state saw the non-finite values
        state.step += 1
        metrics = {"loss": loss.item(), "grad_norm": grad_norm.item()}
        if skip_nonfinite:
            metrics["skipped"] = int(not step_ok)
        if collect_health:
            metrics["health"] = group_health(param_sq, reduced(squared_norms(grads)), update_sq, groups)
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
    backward twice the forward, plus the recompute the remat policy buys: one forward per
    checkpointed block under ``full`` (and the raw names outside the dots family), ~0 when
    the policy keeps every product (``save_dots``, ``offload_dots``, the dots and
    everything names), the block less its attention out-projection (``4bsh^2``) under
    ``save_attention_out``. Router FLOPs are left out, as there."""
    b, s, h = batch_size, sequence_length, config.n_embd
    f, n, k = config.n_inner, config.n_head, config.num_key_value_heads
    attention_flops = 4 * b * s * h * (h * (1 + k / n) + s)
    mlp_flops = 4 * b * s * h * f
    if is_glu(config.activation_function):
        mlp_flops += 2 * b * s * h * f
    active_experts = getattr(config, "num_experts_per_tok", None)
    if getattr(config, "model_type", None) == "dense_moe":
        active_experts = config.num_experts
    if active_experts:
        mlp_flops *= active_experts
    forward = config.n_layer * (attention_flops + mlp_flops)
    every, policy = resolve_checkpointing_args(gradient_checkpointing_method, gradient_checkpointing_args)
    recompute = 0.0
    if every:
        block = attention_flops + mlp_flops
        if policy in _DOTS_KEPT:
            block_recompute = 0.0  # only elementwise ops replay, ~0 in this matmul model
        elif policy == "save_attention_out":
            block_recompute = block - 4 * b * s * h * h
        else:
            block_recompute = block
        recompute = config.n_layer * block_recompute / max(every, 1)
    lm_head = 6 * b * s * h * config.vocab_size
    return (forward + 2 * forward + recompute + lm_head) / 1e12


# the policies that keep every product's output (or park it on the host)
_DOTS_KEPT = {
    "save_dots",
    "offload_dots",
    "dots_saveable",
    "checkpoint_dots",
    "dots_with_no_batch_dims_saveable",
    "checkpoint_dots_with_no_batch_dims",
    "everything_saveable",
}


def estimate_remat_activation_bytes(
    config,
    batch_size: int,
    sequence_length: int,
    gradient_checkpointing_method=None,
    gradient_checkpointing_args: dict | None = None,
    dtype_bytes: int = 4,
) -> dict:
    """The JAX package's analytic estimate of the activation bytes each remat policy keeps
    between the forward and the backward (block-boundary carries plus the policy's kept
    values per checkpointed block; scratch and the unrematted blocks' activations left
    out, so a floor), the host bytes ``offload_dots`` parks, and the delta against
    ``full``. The ``model_report`` record carries it."""
    every, policy = resolve_checkpointing_args(gradient_checkpointing_method, gradient_checkpointing_args)
    b, s, h = batch_size, sequence_length, config.n_embd
    f, n, kvh, layers = config.n_inner, config.n_head, config.num_key_value_heads, config.n_layer

    token_bytes = b * s * dtype_bytes
    boundary = layers // max(every, 1) * token_bytes * h if every else layers * token_bytes * h

    per_block_extra = 0.0
    if every:
        if policy in ("save_dots", "offload_dots") or "saveable" in policy:
            # every dot output: fused qkv, attention scores, context, out proj, c_fc (2f
            # for GLU) and c_proj
            glu = 2 if "glu" in str(config.activation_function) else 1
            per_block_extra = token_bytes * (h * (1 + 2 * kvh / n) + n * s + 3 * h + glu * f)
        elif policy == "save_attention_out":
            per_block_extra = token_bytes * h
    checkpointed_blocks = (layers // max(every, 1)) if every else 0
    extra = checkpointed_blocks * per_block_extra

    device_bytes = boundary + (0.0 if policy == "offload_dots" else extra)
    host_bytes = extra if policy == "offload_dots" else 0.0
    return {
        "checkpoint_every": every,
        "policy": policy,
        "activation_bytes_per_replica": float(device_bytes),
        "host_offload_bytes_per_replica": float(host_bytes),
        "delta_vs_full_bytes": float(device_bytes - boundary),
    }
