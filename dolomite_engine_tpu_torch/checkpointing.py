"""Checkpoint save / load / resume.

Counterpart of `dolomite_engine_tpu/checkpointing.py`, with its layout:

    <save_path>/global_step<N>/
        state/                      torch.distributed.checkpoint: the TrainState tree
        rng_state-0.json            python, numpy, torch CPU / CUDA and the loop's generator
        dataloader/process-0.json   dataloader state (when the loader has one)
        experiments_tracker.json    tracker resume info
        metadata.json               consumed samples etc.
        training_config.yml         the full args snapshot
    <save_path>/latest_checkpointed_iteration.json

`state/` is written by `torch.distributed.checkpoint` (DCP) (up to 8 writer threads, a
file each), where the JAX package writes orbax: DCP keys every tensor by its path
(``model.transformer.h.0.attn.c_attn.weight``, ``optimizer.mu.<parameter>``). Over more
than one rank every rank writes its shards of the FSDP2 (DTensor) parameters and
optimizer state, and a load at the same or another world size reshards them, as orbax
does; a world of one writes with no collectives (``no_dist``). Each rank keeps its own
RNG state; the finetuning loader's state is rank 0's, as JAX saves process 0's, and every
rank restores its own sampler from it. The tree
(`TrainState.state_dict`) holds the step, the model, an fp8 run's delayed-scaling state
(``fp8.<module>.<variable>``; restored only when both the run and the checkpoint have one,
as in JAX) and, with ``save_optimizer``, the optimizer's state lists in their storage
dtypes (AdamW's bf16 first moment stays bf16; an offloaded state is read from the host)
and both of its counters.

Every load toggle of `LoadArgs` is honoured. ``resume_learning_rate: false`` (or
``load_lr_scheduler: false``) restores the moments and zeroes only the schedule's counter,
as the JAX package's `_zero_schedule_step` does to optax's schedule state.

``async_checkpointing``: `save_checkpoint` copies the tree to the host and starts the
write on a background thread, whose collectives run on a gloo group of their own
(`utils.distributed.checkpoint_group`), apart from the training step's;
`finish_pending_checkpoint` joins it and commits. A commit
validates the written state (its DCP metadata must read and be non-empty) before the
`latest` pointer advances, then prunes to ``keep_last_n``, never the checkpoint `latest`
names. Every durable-path operation retries transient I/O errors with bounded backoff
(`FaultToleranceArgs.checkpoint_io_*`).
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor

from .device import resolve_device
from .enums import Mode, TuningMethod
from .parallel.sharding import like
from .train_utils import TrainState
from .utils import dump_yaml, get_telemetry, log_rank_0, process_index, retry_io, trace_annotation

_TRAINING_CONFIG = "training_config.yml"
_LATEST = "latest_checkpointed_iteration.json"
_CHECKPOINT_DIR_RE = re.compile(r"global_step(\d+)")
# DCP writer threads (one file each): chip_smoke.py's 13.9 GB pretraining checkpoint commits
# in 14.4 s on 8 threads against 20.7 s on one, on an H100 machine (PERF.md §6)
_WRITE_THREADS = min(8, os.cpu_count() or 1)


def _retry_kwargs(args) -> dict:
    """Checkpoint-I/O retry policy from FaultToleranceArgs; the defaults when the args tree
    has none (InferenceArgs)."""
    ft = getattr(args, "fault_tolerance_args", None)
    if ft is None:
        return {}
    return dict(
        attempts=ft.checkpoint_io_attempts,
        base_delay_seconds=ft.checkpoint_io_backoff_seconds,
        max_delay_seconds=ft.checkpoint_io_max_backoff_seconds,
    )


def _read_latest_iteration(path: str, retry_kwargs: dict | None = None) -> int:
    def _read() -> int:
        with open(os.path.join(path, _LATEST)) as f:
            return json.load(f)["latest_checkpointed_iteration"]

    return retry_io(_read, description=f"read {_LATEST}", **(retry_kwargs or {}))


def _get_base_path(path: str, iteration: int) -> str:
    return os.path.join(path, f"global_step{iteration}")


def _state_path(base: str) -> str:
    return os.path.join(base, "state")


def _is_primary() -> bool:
    return process_index() == 0


def _dcp_kwargs() -> dict:
    """DCP's collectives: none in a world of one, else over the checkpoint's own group."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return {"no_dist": True}
    from .utils.distributed import checkpoint_group

    return {"process_group": checkpoint_group()}


# --------------------------------------------------------------------------------- rng


def get_rng_state(generator: torch.Generator | None) -> dict:
    """Every RNG stream of the process, as JSON: python's, numpy's, torch's CPU and CUDA
    generators, and the train loop's own generator (the JAX loop's PRNG key)."""
    state = {
        "random_rng_state": list(random.getstate()[1]),
        "random_rng_version": random.getstate()[0],
        "np_rng_state": np.random.get_state()[1].tolist(),
        "np_rng_pos": list(np.random.get_state()[2:]),
        "torch_rng_state": torch.get_rng_state().tolist(),
    }
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["torch_cuda_rng_states"] = [s.tolist() for s in torch.cuda.get_rng_state_all()]
    if generator is not None:
        state["loop_rng_state"] = generator.get_state().tolist()
    return state


def set_rng_state(state: dict) -> torch.Generator | None:
    """Restore what `get_rng_state` saved; returns the loop's generator (None if the
    checkpoint has none)."""
    random.setstate((state["random_rng_version"], tuple(state["random_rng_state"]), None))
    np.random.set_state(
        (
            "MT19937",
            np.array(state["np_rng_state"], dtype=np.uint32),
            int(state["np_rng_pos"][0]),
            int(state["np_rng_pos"][1]),
            float(state["np_rng_pos"][2]),
        )
    )
    torch.set_rng_state(torch.tensor(state["torch_rng_state"], dtype=torch.uint8))
    if "torch_cuda_rng_states" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all([torch.tensor(s, dtype=torch.uint8) for s in state["torch_cuda_rng_states"]])
    if "loop_rng_state" not in state:
        return None
    generator = torch.Generator()
    generator.set_state(torch.tensor(state["loop_rng_state"], dtype=torch.uint8))
    return generator


# --------------------------------------------------------------------------------- save


class _PendingSave:
    """An async save in flight: the write thread and what its commit needs."""

    def __init__(self, target, save_path: str, iteration: int, retry_kwargs: dict, keep_last_n: int | None):
        self.save_path = save_path
        self.iteration = iteration
        self.retry_kwargs = retry_kwargs
        self.keep_last_n = keep_last_n
        self.error: BaseException | None = None

        def run() -> None:
            try:
                target()
            except BaseException as error:  # re-raised by finish_pending_checkpoint
                self.error = error

        self.thread = threading.Thread(target=run, name=f"checkpoint-write[global_step{iteration}]", daemon=True)
        self.thread.start()


# the async save in flight; its `latest` pointer is written by finish_pending_checkpoint()
# once the write is durable
_PENDING: _PendingSave | None = None


def finish_pending_checkpoint() -> None:
    """Wait for an in-flight async save, then commit it (validate, advance `latest`,
    prune). Called at the start of the next save (at most one save is in flight), at the
    end of training and before any restore. A write that failed re-raises here, and
    `latest` keeps naming the previous checkpoint."""
    global _PENDING
    if _PENDING is None:
        return
    pending, _PENDING = _PENDING, None
    pending.thread.join()
    if pending.error is not None:
        raise pending.error
    _commit_checkpoint(pending.save_path, pending.iteration, pending.retry_kwargs, pending.keep_last_n)


def _state_metadata(state_path: str):
    return dcp.FileSystemReader(state_path).read_metadata().state_dict_metadata


def _validate_checkpoint(base: str) -> None:
    """Integrity gate before the `latest` pointer may name `base`: the DCP state dir must
    exist and its metadata must read and name at least one entry."""
    state_path = _state_path(base)
    if not os.path.isdir(state_path):
        raise FileNotFoundError(f"checkpoint state dir missing at {state_path} — torn or incomplete save")
    if not _state_metadata(state_path):
        raise ValueError(f"checkpoint at {base} has empty state metadata — refusing to advance the latest pointer to it")


def _commit_checkpoint(save_path: str, iteration: int, retry_kwargs: dict, keep_last_n: int | None) -> None:
    """Validate -> advance `latest` -> prune old checkpoints, each with bounded retry."""
    retry_io(
        lambda: _validate_checkpoint(_get_base_path(save_path, iteration)),
        description=f"validate global_step{iteration}",
        **retry_kwargs,
    )
    retry_io(lambda: _write_latest(save_path, iteration), description=f"write {_LATEST}", **retry_kwargs)
    get_telemetry().count("checkpoints_saved")
    _prune_old_checkpoints(save_path, keep_last_n)


def _prune_old_checkpoints(save_path: str, keep_last_n: int | None) -> None:
    """Keep the newest `keep_last_n` global_step* dirs, never the one `latest` names. A
    prune failure is logged, not raised: disk housekeeping must not end training."""
    if keep_last_n is None or not _is_primary():
        return
    try:
        latest_iteration = None
        if os.path.isfile(os.path.join(save_path, _LATEST)):
            latest_iteration = _read_latest_iteration(save_path, {"attempts": 1})
        iterations = sorted(
            int(m.group(1))
            for name in os.listdir(save_path)
            if (m := _CHECKPOINT_DIR_RE.fullmatch(name)) and os.path.isdir(os.path.join(save_path, name))
        )
        keep = set(iterations[-keep_last_n:])
        if latest_iteration is not None:
            keep.add(latest_iteration)
        for iteration in iterations:
            if iteration not in keep:
                shutil.rmtree(_get_base_path(save_path, iteration), ignore_errors=True)
                get_telemetry().count("checkpoints_pruned")
                log_rank_0(logging.INFO, f"pruned checkpoint global_step{iteration} (keep_last_n={keep_last_n})")
    except OSError as error:
        log_rank_0(logging.WARNING, f"checkpoint pruning skipped: {error!r}")


def _write_latest(save_path: str, iteration: int) -> None:
    if not _is_primary():
        return
    # tmp + rename + fsync: a crash mid-write never leaves a torn pointer
    target = os.path.join(save_path, _LATEST)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"latest_checkpointed_iteration": iteration}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    dir_fd = os.open(save_path, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _to_host(tree):
    """A host copy of every tensor of `tree` (a copy also of CPU tensors: training goes on
    while an async write reads it)."""
    if isinstance(tree, dict):
        return {key: _to_host(value) for key, value in tree.items()}
    if isinstance(tree, DTensor):  # this rank's shard, with its place in the whole
        return like(tree, tree.to_local().detach().to("cpu", copy=True))
    return tree.detach().to("cpu", copy=True)


def save_checkpoint(
    args,
    model,
    state: TrainState,
    train_dataloader,
    experiments_tracker,
    iteration: int,
    metadata: dict | None = None,
    rng_generator: torch.Generator | None = None,
) -> None:
    """Save a full training checkpoint (the JAX package's `save_checkpoint`)."""
    global _PENDING
    save_path = args.save_args.save_path
    is_async = args.save_args.async_checkpointing
    keep_last_n = args.save_args.keep_last_n
    retry_kwargs = _retry_kwargs(args)
    finish_pending_checkpoint()  # at most one save in flight
    base = _get_base_path(save_path, iteration)
    os.makedirs(base, exist_ok=True)

    with trace_annotation("checkpoint_save"):
        host_tree = _to_host(state.state_dict(with_optimizer=args.save_args.save_optimizer))
        state_path = os.path.abspath(_state_path(base))
        dcp_kwargs = _dcp_kwargs()  # the group is made here, on the main thread of every rank

        def write() -> None:
            retry_io(
                lambda: dcp.save(
                    host_tree,
                    storage_writer=dcp.FileSystemWriter(state_path, overwrite=True, thread_count=_WRITE_THREADS),
                    **dcp_kwargs,
                ),
                description=f"checkpoint write global_step{iteration}",
                **retry_kwargs,
            )

        if is_async:
            pending = _PendingSave(write, save_path, iteration, retry_kwargs, keep_last_n)
        else:
            write()

    with open(os.path.join(base, f"rng_state-{process_index()}.json"), "w") as f:
        json.dump(get_rng_state(rng_generator), f)

    if train_dataloader is not None and _is_primary():  # rank 0's, as JAX saves process 0's
        dl_dir = os.path.join(base, "dataloader")
        os.makedirs(dl_dir, exist_ok=True)
        with open(os.path.join(dl_dir, "process-0.json"), "w") as f:
            json.dump(train_dataloader.state_dict(), f)

    if _is_primary():
        if experiments_tracker is not None:
            with open(os.path.join(base, "experiments_tracker.json"), "w") as f:
                json.dump(experiments_tracker.state_dict(), f)
        if metadata is not None:
            with open(os.path.join(base, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        save_args(args, base)

    if is_async:
        _PENDING = pending  # `latest` advances (and old checkpoints are pruned) at the commit
    else:
        _commit_checkpoint(save_path, iteration, retry_kwargs, keep_last_n)

    log_rank_0(logging.INFO, f"checkpoint saved at {base}" + (" (async)" if is_async else ""))


def save_args(args, base: str, mode: Mode = Mode.training) -> None:
    """Snapshot the full args into the checkpoint."""
    if _is_primary():
        name = _TRAINING_CONFIG if mode == Mode.training else "inference_config.yml"
        dump_yaml(args.to_dict(), os.path.join(base, name))


# --------------------------------------------------------------------------------- load


def load_checkpoint_for_training(
    args,
    state: TrainState,
    train_dataloader=None,
    experiments_tracker=None,
    iteration: int | None = None,
) -> tuple[TrainState, int, dict | None, torch.Generator | None]:
    """Restore a training checkpoint into `state` in place (the JAX package's
    `load_checkpoint_for_training`, with its per-piece toggles).

    Returns (state, starting_iteration, metadata, the loop's generator or None)."""
    load_args = args.load_args
    if load_args is None:
        return state, 0, None, None

    finish_pending_checkpoint()  # an in-flight async save may be the one being restored
    retry_kwargs = _retry_kwargs(args)
    load_path = load_args.load_path
    if iteration is None:
        iteration = load_args.iteration
    if iteration is None:
        iteration = _read_latest_iteration(load_path, retry_kwargs)
    base = _get_base_path(load_path, iteration)
    state_path = os.path.abspath(_state_path(base))

    saved_keys = retry_io(lambda: _state_metadata(state_path), description="read checkpoint metadata", **retry_kwargs)
    if load_args.load_optimizer and not any(key.startswith("optimizer.") for key in saved_keys):
        raise ValueError(
            f"checkpoint at {base} was saved with save_optimizer=False; "
            "resume it with load_args.load_optimizer=false"
        )
    # the live tensors: DCP restores into them; without load_optimizer the fresh moments stay
    tree = state.state_dict(with_optimizer=load_args.load_optimizer)
    if "fp8" in tree and not any(key.startswith("fp8.") for key in saved_keys):
        # a checkpoint without fp8 state (a bf16 run's) keeps the fresh state, as in JAX
        del tree["fp8"]
    dcp_kwargs = _dcp_kwargs()
    retry_io(
        lambda: dcp.load(tree, checkpoint_id=state_path, **dcp_kwargs),
        description="checkpoint restore",
        **retry_kwargs,
    )
    state.load_state_dict(tree)

    # the schedule's only state is its counter: "don't load the lr scheduler" and "don't
    # resume the learning rate" both restore the moments and restart the schedule at 0
    if load_args.load_optimizer and not (load_args.resume_learning_rate and load_args.load_lr_scheduler):
        state.optimizer.schedule_count = 0

    generator = None
    if load_args.load_rng_state:
        rng_path = os.path.join(base, f"rng_state-{process_index()}.json")
        if not os.path.isfile(rng_path):
            rng_path = os.path.join(base, "rng_state-0.json")
        with open(rng_path) as f:
            generator = set_rng_state(json.load(f))

    if load_args.load_dataloader_state and train_dataloader is not None:
        # rank 0's state: the samplers of all ranks share their epoch and cursor, and each
        # keeps its own rank
        dl_path = os.path.join(base, "dataloader", "process-0.json")
        if os.path.isfile(dl_path):
            with open(dl_path) as f:
                train_dataloader.load_state_dict(json.load(f))

    if load_args.load_experiments_tracker_state and experiments_tracker is not None:
        tracker_path = os.path.join(base, "experiments_tracker.json")
        if os.path.isfile(tracker_path):
            with open(tracker_path) as f:
                experiments_tracker.load_state_dict(json.load(f))

    metadata = None
    metadata_path = os.path.join(base, "metadata.json")
    if os.path.isfile(metadata_path):
        with open(metadata_path) as f:
            metadata = json.load(f)

    starting_iteration = iteration if load_args.load_starting_iteration else 0
    if not load_args.load_starting_iteration:
        state.step = 0

    log_rank_0(logging.INFO, f"checkpoint loaded from {base}")
    return state, starting_iteration, metadata, generator


class _TimedLoadPlanner(dcp.DefaultLoadPlanner):
    """DCP's default load planner, timing the reads apart from the copies: the storage
    reader reads each tensor to the host before `resolve_tensor`, and copies it into its
    target (onto the device, cast to the target's dtype) between `resolve_tensor` and
    `commit_tensor`."""

    def __init__(self) -> None:
        super().__init__()
        self.read_s = self.copy_s = 0.0
        self._t = time.perf_counter()

    def finish_plan(self, new_plan):
        self._t = time.perf_counter()  # the reads start
        return super().finish_plan(new_plan)

    def resolve_tensor(self, read_item):
        now = time.perf_counter()
        self.read_s += now - self._t
        self._t = now
        return super().resolve_tensor(read_item)

    def commit_tensor(self, read_item, tensor) -> None:
        now = time.perf_counter()
        self.copy_s += now - self._t
        self._t = now
        super().commit_tensor(read_item, tensor)


def load_checkpoint_for_inference(
    args, mode: Mode = Mode.inference, device: str | torch.device = "cuda", seconds: dict | None = None
):
    """Rebuild the model of a training checkpoint for inference or unsharding (the JAX
    package's `load_checkpoint_for_inference`): the wrapper from the checkpoint's own
    `training_config.yml` (`get_model(training_args, mode)`: a LoRA checkpoint's
    `ModelWrapperForPEFT` with its adapters in place), built on the meta device and given
    uninitialised storage on `device`, so no random init runs; then ONLY the model's
    weights from `state/`: `dcp.load` gets a tree of the model's own tensors alone (LoRA's
    ``lora_a`` / ``lora_b`` among them), so the optimizer moments are never read. For
    inference each saved tensor is cast to the wrapper's dtype on the way (the compute
    dtype; norms and adapters fp32); under `Mode.unsharding` each keeps the dtype the
    checkpoint holds, as JAX restores its params as saved and writes them as they are.

    A prompt-tuning checkpoint is refused for inference: the JAX package's serving engine
    cannot serve its `PromptTuningCausalLM`, which has no ``init_kv_caches`` and refuses
    the ``position_ids`` every engine program passes.

    `seconds`, when given, is filled with the load's parts: ``build`` (the wrapper, its
    tokenizer and the device storage), ``read`` (the files to host tensors) and ``cast``
    (the host tensors onto the device in their dtype).

    Returns (model_wrapper, training_args)."""
    from .arguments import args_from_dict
    from .model_wrapper import get_model
    from .utils import load_yaml

    device = resolve_device(device)
    finish_pending_checkpoint()  # an in-flight async save may be the one being restored
    retry_kwargs = _retry_kwargs(args)
    load_path = args.load_args.load_path
    iteration = args.load_args.iteration
    if iteration is None:
        iteration = _read_latest_iteration(load_path, retry_kwargs)
    base = _get_base_path(load_path, iteration)
    t0 = time.perf_counter()
    training_args = args_from_dict(load_yaml(os.path.join(base, _TRAINING_CONFIG)), Mode.training)
    if mode == Mode.inference and training_args.tuning_args.tuning_method == TuningMethod.prompt_tuning:
        raise NotImplementedError(
            "generation from a prompt-tuning checkpoint is refused: the JAX package's serving engine "
            "cannot serve PromptTuningCausalLM (it has no init_kv_caches, and its __call__ refuses the "
            "position_ids every engine program passes), so there is no reference to hold the port to"
        )
    model = get_model(training_args, mode, device="meta")
    model.model.to_empty(device=device)
    state_path = os.path.abspath(_state_path(base))
    if mode == Mode.unsharding:  # each weight in the dtype the checkpoint holds
        saved = dcp.FileSystemReader(state_path).read_metadata().state_dict_metadata
        for name, param in model.model.named_parameters():
            dtype = saved[f"model.{name}"].properties.dtype
            if param.dtype != dtype:
                param.data = torch.empty(param.shape, dtype=dtype, device=device)
    t1 = time.perf_counter()

    planner = _TimedLoadPlanner()
    dcp_kwargs = _dcp_kwargs()

    def restore():
        planner.read_s = planner.copy_s = 0.0  # a retry starts over
        dcp.load({"model": model.model.state_dict()}, checkpoint_id=state_path, planner=planner, **dcp_kwargs)

    retry_io(restore, description="inference weights restore", **retry_kwargs)
    t2 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the last casts
    if seconds is not None:
        seconds.update(build=t1 - t0, read=planner.read_s, cast=planner.copy_s + time.perf_counter() - t2)
    log_rank_0(logging.INFO, f"model weights loaded for {mode.value} from {base}")
    return model, training_args


def get_experiments_tracker_checkpoint_metadata(args) -> dict:
    """The saved tracker resume info, so a tracker can resume the original run."""
    load_args = args.load_args
    if load_args is None or not load_args.load_experiments_tracker_state:
        return {}
    iteration = load_args.iteration
    if iteration is None:
        if not os.path.isfile(os.path.join(load_args.load_path, _LATEST)):
            return {}
        iteration = _read_latest_iteration(load_args.load_path, _retry_kwargs(args))
    tracker_path = os.path.join(_get_base_path(load_args.load_path, iteration), "experiments_tracker.json")
    if not os.path.isfile(tracker_path):
        return {}
    with open(tracker_path) as f:
        return json.load(f)
