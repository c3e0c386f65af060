"""The optimizers of the JAX package's registry, with optax semantics, and the factory with
µP groups.

Counterpart of `dolomite_engine_tpu/optimization/optimizer.py`, which maps the 23
reference optimizer names onto 11 optax transforms (`OPTIMIZER_CLASSES`): adamw, adam,
nadam, sgd (with its momentum trace), lamb, adagrad, adadelta, adamax, radam, rmsprop and
novograd; ``TorchLBFGS`` raises, and ``TorchRprop`` builds optax's ``rprop``, which takes
a float learning rate only, so under the factory's schedule it raises as it does there.
Each update follows optax's definitions, not `torch.optim`'s: adagrad's accumulator starts
at 0.1, rmsprop takes ``rsqrt(nu + eps)`` (eps inside the root) and its momentum trace
after the learning rate, lamb scales adam's update plus the decay by its own trust ratio,
rprop keeps its own step sizes and applies the previous step's signed steps, nadam is
adam's Nesterov form and novograd keeps one second moment per tensor.

Every optimizer runs in fp32 over fp32 gradients, in ``torch._foreach`` or per-tensor ops
over groups of parameters bounded in bytes (the temporaries of one group, not of the whole
model, are live at a time). The update that follows `schedule_count` scheduled updates
takes ``lr_schedule(schedule_count)``; µP groups scale it per parameter
(`mup_lr_multipliers`). `offload_state` keeps the state in pinned host memory: each group's
state is copied to the card for its update (the next group's copy on a side stream,
overlapping this group's update) and back after it, and the arithmetic is the same.

Over FSDP2's sharded parameters (DTensors) every optimizer works on this rank's shards
(`parallel.sharding.local`): the state is sharded as the parameters are, the elementwise
arithmetic is that of the whole tensor, and a per-tensor statistic (lamb's trust ratio,
novograd's gradient norm) all-reduces its shards' sum of squares over the shard group, so
it is the whole tensor's. `TrainState.state_dict` gives the state back as DTensors for the
checkpoint.
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..enums import ParamsGroupMethod
from ..parallel.sharding import all_reduce_, local, shard_group
from ..utils.mixed_precision import string_to_dtype

_GROUP_BYTES = 1 << 29  # fp32 bytes of parameters updated per foreach group


class Optimizer:
    """The shared part: the parameters, both of optax's counters, the state (one list of
    tensors per name in `state_names`, in parameter order), the lr groups and the host
    offload.

    `count` is the transform's own counter (``ScaleByAdamState.count``, the bias
    correction's) and `schedule_count` the schedule's (``ScaleByScheduleState.count``);
    both start at 0 and advance together; a resume without the learning rate zeroes only
    the schedule's (`checkpointing.load_checkpoint_for_training`). `lr_multipliers` scale
    the lr per parameter (µP groups). `param_names` (optional) name the parameters in the
    checkpoint and group them for the health statistics."""

    state_names: tuple[str, ...] = ()

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        lr_schedule: Callable[[int], float],
        lr_multipliers: Iterable[float] | None = None,
        param_names: list[str] | None = None,
    ) -> None:
        self.params = list(params)
        # the group over which a parameter's shards are split (None: whole on every rank)
        self.reduce_group = shard_group(self.params[0]) if self.params else None
        self.lr_schedule = lr_schedule
        self.param_names = param_names
        self.count = 0
        self.schedule_count = 0
        multipliers = [1.0] * len(self.params) if lr_multipliers is None else list(lr_multipliers)
        self._groups = self._make_groups(multipliers)
        self.state = {name: [self._init_state(name, local(p)) for p in self.params] for name in self.state_names}
        self.offloaded = False
        self._copy_stream = None
        self.offload_seconds = {"h2d": 0.0, "d2h": 0.0}
        self.offload_bytes = {"h2d": 0, "d2h": 0}
        self._copy_events: list = []

    def _init_state(self, name: str, param: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(param)

    def _make_groups(self, multipliers: list[float]) -> list[tuple[float, list[int]]]:
        """Index lists of parameters that share an lr multiplier, each under _GROUP_BYTES."""
        groups = []
        for multiplier in sorted(set(multipliers)):
            indices, size = [], 0
            for i, m in enumerate(multipliers):
                if m != multiplier:
                    continue
                nbytes = local(self.params[i]).numel() * 4
                if indices and size + nbytes > _GROUP_BYTES:
                    groups.append((multiplier, indices))
                    indices, size = [], 0
                indices.append(i)
                size += nbytes
            if indices:
                groups.append((multiplier, indices))
        return groups

    # ------------------------------------------------------------------ the update

    def _update(
        self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict, lr: float
    ) -> list[torch.Tensor]:
        """The group's update (the values added to `params`, learning rate included);
        writes the group's new `state` in place. `self.count` is already advanced."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], track_update: bool = False) -> list[torch.Tensor] | None:
        """Apply one update with fp32 `grads` (one per parameter, in order). With
        `track_update`, returns each parameter's ``sum((p' - p)^2)`` in fp32 (the health
        statistics' update norm, from the parameters before and after)."""
        lr = float(self.lr_schedule(self.schedule_count))
        self.schedule_count += 1
        self.count += 1
        deltas = [None] * len(self.params) if track_update else None
        for multiplier, indices, state in self._group_states():
            params = [local(self.params[i]) for i in indices]
            update = self._update(params, [grads[i] for i in indices], state, lr * multiplier)
            old = [p.detach().clone() for p in params] if track_update else None
            torch._foreach_add_(params, update)
            del update
            if track_update:
                torch._foreach_sub_(old, params)
                for i, d in zip(indices, old):
                    deltas[i] = d.square().sum()
                del old
        return deltas

    # ------------------------------------------------------------------ state

    def state_tensors(self) -> list[torch.Tensor]:
        self.synchronize()
        return [t for name in self.state_names for t in self.state[name]]

    def state_dict(self) -> dict:
        """The state lists (in their storage dtypes, in parameter order) and both counters."""
        self.synchronize()
        return {**self.state, "count": self.count, "schedule_count": self.schedule_count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` (or one restored from a checkpoint) into this optimizer."""
        self.synchronize()
        for name in self.state_names:
            if len(state[name]) != len(self.params):
                raise ValueError(f"{name} holds {len(state[name])} tensors for {len(self.params)} parameters")
            for live, saved in zip(self.state[name], state[name]):
                live.copy_(saved)
        self.count = int(state["count"])
        self.schedule_count = int(state["schedule_count"])

    # ------------------------------------------------------------------ host offload

    @torch.no_grad()
    def offload_state(self) -> None:
        """Keep the state on the host from now on, pinned when the parameters are on a card.
        Each update then copies a group's state to the parameters' device and back; the
        arithmetic is unchanged, so the parameters are bit-identical to those of an
        unoffloaded run."""
        if self.offloaded:
            return
        pin_memory = self.params[0].device.type == "cuda"
        for name in self.state_names:
            self.state[name] = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=pin_memory).copy_(t) for t in self.state[name]
            ]
        self.offloaded = True

    def synchronize(self) -> None:
        """Wait for the write-back of the last offloaded update (the host reads the state)."""
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
            for kind, start, end in self._copy_events:
                self.offload_seconds[kind] += start.elapsed_time(end) / 1e3
            self._copy_events = []

    def _group_states(self):
        """(lr multiplier, indices, the group's state on the parameters' device) per group.
        Offloaded: the next group's host-to-device copy is queued before this group's
        update, on a side stream for a card, and each group's state is written back once
        its update is done."""
        if not self.offloaded:
            for multiplier, indices in self._groups:
                yield multiplier, indices, {name: [self.state[name][i] for i in indices] for name in self.state_names}
            return
        device = self.params[0].device
        cuda = device.type == "cuda"
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        copy_stream = self._copy_stream

        def timed(kind, copies):
            if not cuda:
                for dst, src in copies:
                    dst.copy_(src)
                return
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            copy_stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(copy_stream):
                start.record()
                for dst, src in copies:
                    dst.copy_(src, non_blocking=True)
                end.record()
            self._copy_events.append((kind, start, end))

        def fetch(indices):
            on_device = {
                name: [torch.empty_like(self.state[name][i], device=device) for i in indices]
                for name in self.state_names
            }
            copies = [(d, self.state[name][i]) for name in self.state_names for d, i in zip(on_device[name], indices)]
            timed("h2d", copies)
            self.offload_bytes["h2d"] += sum(d.nbytes for d, _ in copies)
            return on_device

        pending = fetch(self._groups[0][1])
        for k, (multiplier, indices) in enumerate(self._groups):
            state = pending
            if cuda:
                torch.cuda.current_stream(device).wait_stream(copy_stream)
                for tensors in state.values():
                    for t in tensors:
                        t.record_stream(copy_stream)
            if k + 1 < len(self._groups):
                pending = fetch(self._groups[k + 1][1])
            yield multiplier, indices, state
            copies = [(self.state[name][i], d) for name in self.state_names for d, i in zip(state[name], indices)]
            timed("d2h", copies)
            self.offload_bytes["d2h"] += sum(d.nbytes for _, d in copies)
            del state, copies


def _norm(x: torch.Tensor, scratch: torch.Tensor, group=None) -> torch.Tensor:
    """``sqrt(sum(x^2))``, jnp.linalg.norm's definition, the squares in `scratch`: a summed
    reduction (the CPU's ``vector_norm`` loses ~1 % on a 100 M-element fp32 tensor; ``sum``
    does not). `x` is a shard when `group` is given: the sums are all-reduced over it."""
    return all_reduce_(torch.mul(x, x, out=scratch).sum(), group).sqrt()


def _decay_(moment: torch.Tensor, fresh: torch.Tensor, decay: float) -> None:
    """optax's ``update_moment`` in place: ``moment = fresh + decay * moment``, where
    `fresh` is ``(1 - decay) * g^order``, each product rounded as optax rounds it."""
    moment.mul_(decay).add_(fresh)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in fp32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class TorchAdamW(Optimizer):
    """optax ``adamw(lr_schedule, b1, b2, eps, weight_decay, mu_dtype)``: bias-corrected
    moments, weight decay on every parameter (no mask), ``update = -lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)``. The first moment may be stored in bf16 (`mu_dtype`)
    while the arithmetic stays fp32: it is read to fp32, updated, used, and only then
    rounded for storage, as optax does (`torch.optim.AdamW` keeps its moments in the
    parameter dtype). With ``weight_decay=0`` it is optax's ``adam``; with `nesterov`,
    ``nadam``."""

    state_names = ("mu", "nu")

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        lr_schedule: Callable[[int], float],
        betas: tuple[float, float] = (0.9, 0.95),
        eps: float = 1e-10,
        weight_decay: float = 0.1,
        mu_dtype: torch.dtype | str | None = None,
        lr_multipliers: Iterable[float] | None = None,
        param_names: list[str] | None = None,
        nesterov: bool = False,
    ) -> None:
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.mu_dtype = string_to_dtype(mu_dtype)
        self.nesterov = nesterov
        super().__init__(params, lr_schedule, lr_multipliers, param_names)

    def _init_state(self, name, param):
        if name == "mu":
            return torch.zeros_like(param, dtype=self.mu_dtype or param.dtype)
        return torch.zeros_like(param)

    @property
    def mu(self) -> list[torch.Tensor]:
        return self.state["mu"]

    @property
    def nu(self) -> list[torch.Tensor]:
        return self.state["nu"]

    def _update(self, params, g, state, lr):
        mu, nu = state["mu"], state["nu"]
        bias1 = 1 - self.b1**self.count
        bias2 = 1 - self.b2**self.count
        # m = (1 - b1) g + b1 m and v = (1 - b2) g^2 + b2 v; as in optax, b1 m is taken in
        # the moment's storage dtype (b1 rounded to it too) and the sum in fp32
        b1 = torch.tensor(self.b1, dtype=mu[0].dtype).item()
        m32 = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(m32, [m.float() for m in torch._foreach_mul(mu, b1)])
        g_sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(g_sq, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g_sq)
        del g_sq
        # u = m_hat / (sqrt(v_hat) + eps) + wd p; the update is -lr u
        denom = torch._foreach_div(nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        if self.nesterov:  # b1 m / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)
            update = torch._foreach_div(m32, _bias_correction(self.b1, self.count + 1))
            torch._foreach_mul_(update, self.b1)
            torch._foreach_add_(update, torch._foreach_mul(torch._foreach_div(g, _bias_correction(self.b1, self.count)), 1 - self.b1))
        else:
            update = torch._foreach_div(m32, bias1)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(update, -lr)
        for m, new in zip(mu, m32):
            m.copy_(new)  # rounded to the moment's storage dtype after use
        return update


class Lamb(Optimizer):
    """optax ``lamb``: adam's bias-corrected update plus ``wd * p``, scaled per tensor by
    the trust ratio ``||p|| / ||u||`` (1 where either norm is 0)."""

    state_names = ("mu", "nu")

    def __init__(self, params, lr_schedule, betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1, **kwargs):
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        super().__init__(params, lr_schedule, **kwargs)

    def _update(self, params, grads, state, lr):
        bias1, bias2 = _bias_correction(self.b1, self.count), _bias_correction(self.b2, self.count)
        updates = []
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            _decay_(mu, torch.mul(g, 1 - self.b1), self.b1)
            _decay_(nu, torch.mul(g, g).mul_(1 - self.b2), self.b2)
            u = torch.div(mu, bias1)
            scratch = torch.div(nu, bias2).sqrt_().add_(self.eps)
            u.div_(scratch).add_(scratch.copy_(p).mul_(self.weight_decay))
            param_norm, update_norm = _norm(p, scratch, self.reduce_group), _norm(u, scratch, self.reduce_group)
            ratio = torch.where((param_norm == 0) | (update_norm == 0), 1.0, param_norm / update_norm)
            updates.append(u.mul_(ratio).mul_(-lr))
        return updates


class Sgd(Optimizer):
    """optax ``sgd(lr, momentum, nesterov)``: the momentum trace ``t = g + momentum * t``
    (kept also at momentum 0, as the JAX factory passes 0.0), then ``-lr``."""

    state_names = ("trace",)

    def __init__(self, params, lr_schedule, momentum=0.0, nesterov=False, **kwargs):
        self.momentum = momentum
        self.nesterov = nesterov
        super().__init__(params, lr_schedule, **kwargs)

    def _update(self, params, grads, state, lr):
        updates = []
        for g, trace in zip(grads, state["trace"]):
            trace.copy_(g + self.momentum * trace)
            u = g + self.momentum * trace if self.nesterov else trace.clone()
            updates.append(u * -lr)
        return updates


class Adagrad(Optimizer):
    """optax ``adagrad``: the sum of squares starts at 0.1; ``u = g * rsqrt(s + eps)``
    where ``s > 0``."""

    state_names = ("sum_of_squares",)

    def __init__(self, params, lr_schedule, eps=1e-10, initial_accumulator_value=0.1, **kwargs):
        self.eps = eps
        self.initial_accumulator_value = initial_accumulator_value
        super().__init__(params, lr_schedule, **kwargs)

    def _init_state(self, name, param):
        return torch.full_like(param, self.initial_accumulator_value)

    def _update(self, params, grads, state, lr):
        updates = []
        for g, s in zip(grads, state["sum_of_squares"]):
            s.add_(torch.mul(g, g))
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0)
            updates.append(inv.mul_(g).mul_(-lr))
        return updates


class Adadelta(Optimizer):
    """optax ``adadelta`` (weight decay 0): ``u = sqrt(e_x + eps) / sqrt(e_g + eps) * g``
    over the decayed squared gradients and updates."""

    state_names = ("e_g", "e_x")

    def __init__(self, params, lr_schedule, rho=0.9, eps=1e-6, weight_decay=0.0, **kwargs):
        self.rho = rho
        self.eps = eps
        self.weight_decay = weight_decay
        super().__init__(params, lr_schedule, **kwargs)

    def _update(self, params, grads, state, lr):
        updates = []
        for p, g, e_g, e_x in zip(params, grads, state["e_g"], state["e_x"]):
            g = torch.mul(p, self.weight_decay).add_(g)
            _decay_(e_g, torch.mul(g, g).mul_(1 - self.rho), self.rho)
            u = torch.add(e_x, self.eps).sqrt_().div_(torch.add(e_g, self.eps).sqrt_()).mul_(g)
            _decay_(e_x, g.copy_(u).mul_(u).mul_(1 - self.rho), self.rho)
            updates.append(u.mul_(-lr))
        return updates


class Adamax(Optimizer):
    """optax ``adamax``: the infinity moment ``max(|g| + eps, b2 * nu)``, no bias
    correction on it."""

    state_names = ("mu", "nu")

    def __init__(self, params, lr_schedule, betas=(0.9, 0.95), eps=1e-10, **kwargs):
        self.b1, self.b2 = betas
        self.eps = eps
        super().__init__(params, lr_schedule, **kwargs)

    def _update(self, params, grads, state, lr):
        bias1 = _bias_correction(self.b1, self.count)
        updates = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            _decay_(mu, torch.mul(g, 1 - self.b1), self.b1)
            torch.maximum(g.abs().add_(self.eps), nu.mul_(self.b2), out=nu)
            updates.append(torch.div(mu, bias1).div_(nu).mul_(-lr))
        return updates


class RAdam(Optimizer):
    """optax ``radam`` (threshold 5): the rectified adam update once the variance's
    degrees of freedom ``ro`` reach the threshold, the bias-corrected momentum before."""

    state_names = ("mu", "nu")

    def __init__(self, params, lr_schedule, betas=(0.9, 0.95), eps=1e-10, threshold=5.0, **kwargs):
        self.b1, self.b2 = betas
        self.eps = eps
        self.threshold = threshold
        super().__init__(params, lr_schedule, **kwargs)

    def _update(self, params, grads, state, lr):
        f32 = np.float32
        ro_inf = f32(2.0 / (1.0 - self.b2) - 1.0)
        b2t = f32(self.b2) ** f32(self.count)
        ro = ro_inf - f32(2 * self.count) * b2t / (f32(1) - b2t)
        rectified = bool(ro >= self.threshold)
        r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro)) if rectified else 0.0
        bias1, bias2 = _bias_correction(self.b1, self.count), _bias_correction(self.b2, self.count)
        updates = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            _decay_(mu, torch.mul(g, 1 - self.b1), self.b1)
            _decay_(nu, torch.mul(g, g).mul_(1 - self.b2), self.b2)
            u = torch.div(mu, bias1)
            if rectified:
                u.mul_(float(r)).div_(torch.div(nu, bias2).sqrt_().add_(self.eps))
            updates.append(u.mul_(-lr))
        return updates


class RMSprop(Optimizer):
    """optax ``rmsprop`` (not centered): ``u = g * rsqrt(nu + eps)``, eps inside the root,
    then ``-lr``, then the momentum trace (kept at momentum 0, as the JAX factory passes
    0.0)."""

    state_names = ("nu", "trace")

    def __init__(self, params, lr_schedule, alpha=0.99, eps=1e-8, momentum=0.0, **kwargs):
        self.decay = alpha
        self.eps = eps
        self.momentum = momentum
        super().__init__(params, lr_schedule, **kwargs)

    def _update(self, params, grads, state, lr):
        updates = []
        for g, nu, trace in zip(grads, state["nu"], state["trace"]):
            _decay_(nu, torch.mul(g, g).mul_(1 - self.decay), self.decay)
            u = torch.add(nu, self.eps).rsqrt_().mul_(g).mul_(-lr)
            trace.mul_(self.momentum).add_(u)
            updates.append(u.copy_(trace))
        return updates


class Rprop(Optimizer):
    """optax ``rprop(learning_rate)``: per-element step sizes, grown by `eta_plus` where
    the gradient keeps its sign and shrunk by `eta_minus` where it flips, clipped to
    [`min_step_size`, `max_step_size`]; the update applies the previous step's signed
    steps (0 where the sign flipped), as optax does. optax starts the step sizes at the
    learning rate, so it must be a float: a schedule raises TypeError, as optax's
    ``full_like`` does."""

    state_names = ("step_sizes", "prev_updates")

    def __init__(self, params, learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6, max_step_size=50.0, **kwargs):
        if callable(learning_rate):
            raise TypeError(
                "rprop's learning rate starts its step sizes, so it must be a float, not a schedule "
                "(optax.rprop raises the same way)"
            )
        self.learning_rate = float(learning_rate)
        self.eta_minus, self.eta_plus = eta_minus, eta_plus
        self.min_step_size, self.max_step_size = min_step_size, max_step_size
        super().__init__(params, lambda step: self.learning_rate, **kwargs)

    def _init_state(self, name, param):
        if name == "step_sizes":
            return torch.full_like(param, self.learning_rate)
        return torch.zeros_like(param)

    def _update(self, params, grads, state, lr):
        updates = []
        for g, step, prev in zip(grads, state["step_sizes"], state["prev_updates"]):
            sign = g * prev
            grown = torch.clamp(
                step * torch.where(sign > 0, self.eta_plus, self.eta_minus), min=self.min_step_size, max=self.max_step_size
            )
            step.copy_(torch.where(sign == 0, step, grown))
            updates.append(torch.where(sign < 0, 0.0, prev) * -1.0)
            prev.copy_(torch.where(sign < 0, 0.0, step * torch.sign(g)))
        return updates


class NovoGrad(Optimizer):
    """optax ``novograd``: one second moment per tensor (the squared gradient norm, decayed
    by `b2` after the first step), ``mu = b1 * mu + g / (sqrt(nu) + eps) + wd * p``."""

    state_names = ("mu", "nu")

    def __init__(self, params, lr_schedule, betas=(0.9, 0.95), eps=1e-10, weight_decay=0.0, **kwargs):
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        super().__init__(params, lr_schedule, **kwargs)

    def _init_state(self, name, param):
        if name == "nu":
            return torch.zeros((), dtype=param.dtype, device=param.device)
        return torch.zeros_like(param)

    def _update(self, params, grads, state, lr):
        updates = []
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            norm_sq = _norm(g, torch.empty_like(g), self.reduce_group) ** 2
            nu.copy_(norm_sq if self.count == 1 else (1 - self.b2) * norm_sq + self.b2 * nu)
            u = g / (nu.sqrt() + self.eps) + self.weight_decay * p
            mu.copy_(u if self.count == 1 else self.b1 * mu + u)
            updates.append(mu * -lr)
        return updates


def _betas(args):
    return tuple(args.get("betas", (0.9, 0.95)))


def _adamw(args):
    return TorchAdamW, dict(
        betas=_betas(args), eps=args.get("eps", 1e-10), weight_decay=args.get("weight_decay", 0.1),
        mu_dtype=args.get("mu_dtype"),
    )


def _adam(args, nesterov=False):
    return TorchAdamW, dict(betas=_betas(args), eps=args.get("eps", 1e-10), weight_decay=0.0, nesterov=nesterov)


def _nadam(args):
    return _adam(args, nesterov=True)


def _sgd(args):
    return Sgd, dict(momentum=args.get("momentum", 0.0), nesterov=args.get("nesterov", False))


def _lamb(args):
    return Lamb, dict(betas=_betas(args), eps=args.get("eps", 1e-10), weight_decay=args.get("weight_decay", 0.1))


def _adagrad(args):
    return Adagrad, dict(eps=args.get("eps", 1e-10))


def _adadelta(args):
    return Adadelta, dict(rho=args.get("rho", 0.9), eps=args.get("eps", 1e-6))


def _adamax(args):
    return Adamax, dict(betas=_betas(args), eps=args.get("eps", 1e-10))


def _radam(args):
    return RAdam, dict(betas=_betas(args), eps=args.get("eps", 1e-10))


def _rmsprop(args):
    return RMSprop, dict(alpha=args.get("alpha", 0.99), eps=args.get("eps", 1e-8), momentum=args.get("momentum", 0.0))


def _rprop(args):
    return Rprop, {}


def _novograd(args):
    return NovoGrad, dict(betas=_betas(args), eps=args.get("eps", 1e-10), weight_decay=args.get("weight_decay", 0.0))


# every reference optimizer name -> (class, its arguments from class_args), as the JAX
# package's `_OPTIMIZER_FACTORIES`; None: the name raises
OPTIMIZER_CLASSES: dict[str, Callable | None] = {
    "ApexFusedAdam": _adamw,
    "ApexFusedLAMB": _lamb,
    "ApexFusedNovoGrad": _novograd,
    "ApexFusedSGD": _sgd,
    "DeepSpeedCPUAdagrad": _adagrad,
    "DeepSpeedCPUAdam": _adamw,
    "DeepSpeedFusedAdam": _adamw,
    "DeepSpeedFusedLAMB": _lamb,
    "DeepSpeedOnebitAdam": _adamw,
    "DeepSpeedOnebitLAMB": _lamb,
    "DeepSpeedZeroOneAdam": _adamw,
    "TorchAdadelta": _adadelta,
    "TorchAdagrad": _adagrad,
    "TorchAdam": _adam,
    "TorchAdamax": _adamax,
    "TorchAdamW": _adamw,
    "TorchASGD": _sgd,
    "TorchLBFGS": None,  # no batch second-order optimizer
    "TorchNAdam": _nadam,
    "TorchRAdam": _radam,
    "TorchRMSprop": _rmsprop,
    "TorchRprop": _rprop,
    "TorchSGD": _sgd,
}


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
) -> Optimizer:
    """The optimizer over the trainable parameters of `named_params`
    (``model.named_parameters()``): one frozen with ``requires_grad_(False)`` (a PEFT
    run's base weights) gets no state and no update."""
    if optimizer_class_name not in OPTIMIZER_CLASSES:
        raise ValueError(f"invalid optimizer class '{optimizer_class_name}'")
    factory = OPTIMIZER_CLASSES[optimizer_class_name]
    if factory is None:
        raise ValueError(f"optimizer '{optimizer_class_name}' is not supported on TPU")
    named_params = [(name, p) for name, p in named_params if p.requires_grad]
    multipliers = None
    if params_group_method is not None:
        if ParamsGroupMethod(params_group_method) != ParamsGroupMethod.mup:
            raise ValueError(f"unexpected params_group_method ({params_group_method})")
        assert model_config is not None and model_config.init_method == "mup", (
            "both init method for model and params group method for optimizer should be set to mup"
        )
        multipliers = mup_lr_multipliers(named_params, model_config.m_width)
    cls, kwargs = factory(optimizer_class_args)
    return cls(
        [p for _, p in named_params],
        lr_schedule,
        lr_multipliers=multipliers,
        param_names=[name for name, _ in named_params],
        **kwargs,
    )


def build_optimizer_from_args(args, model) -> tuple[Optimizer, Callable[[int], float]]:
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
