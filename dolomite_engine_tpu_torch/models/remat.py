"""Activation checkpointing (remat) of the decoder's blocks under the JAX package's policies.

Counterpart of the policy half of `dolomite_engine_tpu/models/gpt_dolomite.py`
(`REMAT_POLICY_NAMES`, the raw `jax.checkpoint_policies` names, `resolve_remat_policy`)
and of the ``checkpoint_name`` tag on each block's attention output. A checkpointed
block runs under `torch.utils.checkpoint` (non-reentrant); a policy that keeps some of
the block's values runs it under a pair of dispatch modes (`_SaveMode` in the forward,
`_ReplayMode` in the backward's recompute), the selective-checkpoint scheme of
`torch.utils.checkpoint.create_selective_checkpoint_contexts` with one addition: a
policy may park what it keeps in pinned host memory (``offload_dots``).

What each policy keeps, as JAX's policies decide it per primitive:

- ``full`` / ``nothing_saveable``: nothing; the backward reruns the whole block.
- ``save_dots`` / ``dots_saveable`` / ``checkpoint_dots``: the output of every product
  (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm`` and ``_scaled_mm``, JAX's
  ``dot_general`` and ``scaled_matmul``).
- ``dots_with_no_batch_dims_saveable`` / ``checkpoint_dots_with_no_batch_dims``: the
  products without a batch dimension (``mm``, ``addmm``, ``_scaled_mm``).
- ``save_attention_out``: only the tagged attention-sublayer output (`checkpoint_name`).
- ``offload_dots``: the products without a batch dimension, in pinned host memory, for a
  block on a CUDA device; on another device ``save_dots``, with the warning JAX gives
  where the backend has no pinned host memory.
- ``everything_saveable``: everything, so the block is not checkpointed at all.

The hand-written kernels are launched through ``ctypes`` inside `autograd.Function` s, so
the dispatch modes never see them: a checkpointed block reruns its kernels under every
policy, as JAX reruns a ``pallas_call`` (no policy names it). A rerun kernel sees the
inputs the forward saw, so a deterministic kernel rebuilds the same bits.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..utils import log_rank_0

# the named policies (`gradient_checkpointing_args.policy`)
REMAT_POLICY_NAMES = ("full", "save_dots", "save_attention_out", "offload_dots")
# the raw `jax.checkpoint_policies` names the legacy ``checkpoint_policy`` key takes
RAW_REMAT_POLICIES = (
    "checkpoint_dots",
    "checkpoint_dots_with_no_batch_dims",
    "dots_saveable",
    "dots_with_no_batch_dims_saveable",
    "everything_saveable",
    "nothing_saveable",
)
# the tag each block puts on its attention-sublayer output
ATTENTION_OUT_CHECKPOINT_NAME = "attention_out"

_aten = torch.ops.aten
DOT_OPS = frozenset(
    (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default, _aten._scaled_mm.default)
)
NO_BATCH_DOT_OPS = frozenset((_aten.mm.default, _aten.addmm.default, _aten._scaled_mm.default))
# ops whose count differs between the forward and the recompute (torch's own list)
_IGNORED_OPS = frozenset(getattr(torch.utils.checkpoint, "SAC_IGNORED_OPS", {_aten.detach.default}))


@torch.library.custom_op("dolomite::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """`jax.ad_checkpoint.checkpoint_name`: `x` (a copy: one op whose output a policy can
    keep) under `name`."""
    return x.clone()


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))
_CHECKPOINT_NAME_OP = torch.ops.dolomite.checkpoint_name.default


@dataclass(frozen=True)
class RematPolicy:
    """What a checkpointed block keeps: the outputs of `save_ops`, or of the
    `checkpoint_name` tags in `save_names`; `offload` parks them in pinned host memory;
    `checkpoint` False keeps everything (no remat)."""

    name: str
    save_ops: frozenset = frozenset()
    save_names: frozenset = frozenset()
    offload: bool = False
    checkpoint: bool = True

    @property
    def selective(self) -> bool:
        return bool(self.save_ops or self.save_names)

    def keeps(self, func, args) -> bool:
        if func is _CHECKPOINT_NAME_OP:
            return args[1] in self.save_names
        return func in self.save_ops


FULL = RematPolicy("full")
SAVE_DOTS = RematPolicy("save_dots", save_ops=DOT_OPS)


def resolve_named_remat_policy(policy: str | None, device: torch.device | str | None = None) -> RematPolicy:
    """A named policy (`REMAT_POLICY_NAMES`); None is ``full``. ``offload_dots`` needs
    pinned host memory, which only a CUDA `device` has: elsewhere it warns and falls
    back to ``save_dots``."""
    if policy is None or policy == "full":
        return FULL
    if policy == "save_dots":
        return SAVE_DOTS
    if policy == "save_attention_out":
        return RematPolicy(policy, save_names=frozenset((ATTENTION_OUT_CHECKPOINT_NAME,)))
    if policy == "offload_dots":
        if device is None or torch.device(device).type != "cuda":
            log_rank_0(
                logging.WARNING,
                "gradient_checkpointing_args.policy=offload_dots needs a pinned_host "
                "memory space, which this backend does not expose — falling back to "
                "save_dots (same recompute point, dots stay in HBM)",
            )
            return SAVE_DOTS
        return RematPolicy(policy, save_ops=NO_BATCH_DOT_OPS, offload=True)
    raise ValueError(f"unknown remat policy '{policy}' (expected one of {REMAT_POLICY_NAMES})")


def resolve_remat_policy(name: str | None, device: torch.device | str | None = None) -> RematPolicy:
    """Either vocabulary: a named policy or a raw `jax.checkpoint_policies` name. None is
    the ``full`` policy."""
    if name is None or name in REMAT_POLICY_NAMES:
        return resolve_named_remat_policy(name, device)
    if name in ("dots_saveable", "checkpoint_dots"):
        return RematPolicy(name, save_ops=DOT_OPS)
    if name in ("dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"):
        return RematPolicy(name, save_ops=NO_BATCH_DOT_OPS)
    if name == "nothing_saveable":
        return RematPolicy(name)
    if name == "everything_saveable":
        return RematPolicy(name, checkpoint=False)
    raise ValueError(
        f"unknown checkpoint_policy '{name}' (expected a named policy "
        f"{REMAT_POLICY_NAMES} or one of {RAW_REMAT_POLICIES})"
    )


class OffloadStats:
    """Pinned host bytes the ``offload_dots`` policy holds now, at most, and in all."""

    held = peak = total = 0

    @classmethod
    def reset(cls) -> None:
        cls.held = cls.peak = cls.total = 0


class _Kept:
    """One kept output: the tensor itself, or its pinned host copy."""

    def __init__(self, tensor: torch.Tensor, offload: bool) -> None:
        self.version = tensor._version
        self.device = tensor.device
        if offload:
            host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            self.tensor = host
            OffloadStats.held += host.nbytes
            OffloadStats.total += host.nbytes
            OffloadStats.peak = max(OffloadStats.peak, OffloadStats.held)
        else:
            self.tensor = tensor.detach()
        self.offload = offload

    def get(self) -> torch.Tensor:
        if self.offload:
            OffloadStats.held -= self.tensor.nbytes
            return self.tensor.to(self.device, non_blocking=True)
        if self.tensor._version != self.version:
            raise RuntimeError("a kept output was changed in place after the forward kept it")
        return self.tensor


class _SaveMode(TorchDispatchMode):
    """The checkpointed forward: keeps the outputs the policy names, in call order per op."""

    def __init__(self, policy: RematPolicy, storage: dict) -> None:
        super().__init__()
        self.policy = policy
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _IGNORED_OPS:
            kept = None
            if self.policy.keeps(func, args):
                kept = tree_map(
                    lambda x: _Kept(x, self.policy.offload) if isinstance(x, torch.Tensor) else x, out
                )
            self.storage.setdefault(func, []).append(kept)
        return out


class _ReplayMode(TorchDispatchMode):
    """The backward's recompute: hands back what the forward kept, reruns the rest."""

    def __init__(self, storage: dict) -> None:
        super().__init__()
        self.storage = storage
        self.calls: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _IGNORED_OPS:
            return func(*args, **(kwargs or {}))
        index = self.calls.get(func, 0)
        self.calls[func] = index + 1
        entries = self.storage.get(func)
        if entries is None or index >= len(entries):
            raise RuntimeError(f"{func} ran in the recompute but not in the checkpointed forward")
        kept = entries[index]
        if kept is None:
            return func(*args, **(kwargs or {}))
        entries[index] = None
        return tree_map(lambda x: x.get() if isinstance(x, _Kept) else x, kept)


def remat_call(policy: RematPolicy, fn, *args):
    """``fn(*args)`` checkpointed under `policy`."""
    if not policy.checkpoint:
        return fn(*args)
    if not policy.selective:
        return checkpoint(fn, *args, use_reentrant=False)

    def contexts():
        storage: dict = {}
        return _SaveMode(policy, storage), _ReplayMode(storage)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)
