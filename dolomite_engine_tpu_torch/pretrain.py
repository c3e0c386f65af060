"""Pretraining entry point: ``python -m dolomite_engine_tpu_torch.pretrain --config cfg.yml``.

Counterpart of `dolomite_engine_tpu/pretrain.py`: `main` wires args -> model -> optimizer
-> (resume) -> megatron dataloaders -> `train`; `train` is the step loop with
consumed-samples accounting, eval at step 0, every ``eval_interval`` steps and on the
test split at the end, throughput and MFU logging, the telemetry windows, the health
monitor (its per-group statistics every ``health.interval`` steps) and flight recorder,
checkpoints every ``save_interval`` steps and at the last step, a preemption notice's
save-and-exit, and the shutdown of every worker on every exit path. Step batches come from a `StepPrefetcher` that stacks the accumulation micro-batches
and copies them to the card on a side stream, up to ``prefetch_depth`` steps ahead.

The JAX loop splits a PRNG key each step for dropout; here the loop draws each step's
seed from its own `torch.Generator` (seeded from ``random_args.seed``, saved in the
checkpoint) and seeds torch's generators with it, so a resumed run draws the same
dropout masks as an unbroken one (each rank offsets the seed by its rank). `main` joins
the process group (`utils.init_distributed`: the ``torchrun`` job's, else a group of one),
builds the mesh and shards the model under the ZeRO stage with FSDP2
(`distributed.wrap_model_for_distributed_training`); each rank reads its share of every
global batch, the consumed samples and tokens count all ranks, and the eval losses, the
logged loss and a preemption notice are agreed over the ranks. ``python -m
dolomite_engine_tpu_torch.pretrain --config cfg.yml`` runs one rank, ``torchrun
--nproc-per-node N -m ...`` N (`check_ported_options` lists what the port refuses);
`main(args, device="cuda")` runs on the card (``cuda:LOCAL_RANK`` under torchrun), and
the tests pass ``device="cpu"`` (gloo). The training options run as in the JAX loop: remat policies (the model's),
any optimizer of the registry, ``cpu_offload`` (the optimizer state in pinned host memory;
warned about and ignored off a card), ``health.interval`` and ``mixed_precision_args.dtype:
fp8`` (the state on `TrainState.fp8`, checkpointed with the model).
"""

from __future__ import annotations

import logging
import random
import time

import numpy as np
import torch

from .arguments import TrainingArgs, check_ported_options, get_args
from .checkpointing import (
    finish_pending_checkpoint,
    get_experiments_tracker_checkpoint_metadata,
    load_checkpoint_for_training,
    save_checkpoint,
)
from .data import StepPrefetcher
from .data.megatron import get_megatron_gpt_dataloaders
from .device import resolve_device
from .distributed import get_data_parallel_world_size, wrap_model_for_distributed_training
from .enums import Mode, TuningMethod
from .model_wrapper import get_model, log_model
from .optimization import build_optimizer_from_args
from .train_utils import (
    TrainState,
    estimate_remat_activation_bytes,
    get_model_tflops,
    get_profiler_context,
    handle_nonfinite_step,
    make_train_step,
    resolve_cpu_offload,
    track_train_metrics,
)
from .utils import (
    ExperimentsTracker,
    ProgressBar,
    StallWatchdog,
    any_rank,
    build_health_monitor,
    build_telemetry,
    crash_reason,
    emit_model_report,
    init_distributed,
    install_preemption_handler,
    install_telemetry,
    log_rank_0,
    preemption_requested,
    process_index,
    register_crash_hook,
    step_annotation,
    sum_over_ranks,
    trace_annotation,
    uninstall_preemption_handler,
    uninstall_telemetry,
    unregister_crash_hook,
)


def track_val_metrics(global_step: int, val_loss: float, experiments_tracker, group_name: str | None = None) -> None:
    message = f"step = {global_step}, val_loss = {val_loss:.4f}"
    if group_name is not None:
        message += f", group_name = {group_name}"
    log_rank_0(logging.INFO, message)
    if experiments_tracker is not None:
        key = "loss" if group_name is None else f"loss-{group_name}"
        experiments_tracker.track({key: val_loss}, step=global_step, context="val")


def evaluate(
    val_dataloaders: list,
    model,
    global_step: int,
    experiments_tracker,
    eval_steps: int,
    group_names: list | None = None,
) -> float | None:
    """`eval_steps` batches from each val group, reported under the group names of
    `*_weighted_split_paths` (else the group's index); returns the last group's loss."""
    if not val_dataloaders or all(dl is None for dl in val_dataloaders):
        return None

    group_loss = None
    for group_index, loader in enumerate(val_dataloaders):
        if loader is None:
            continue
        loss_sum, count = 0.0, 0
        for _ in range(eval_steps):
            try:
                batch = next(loader)
            except StopIteration:
                break
            with torch.no_grad():
                loss_sum += float(model.loss(batch["text"], train=False))
            count += 1
        if count == 0:
            continue
        # each rank's batch loss is its share of the global batch's (`ops/loss.py`)
        group_loss = sum_over_ranks(loss_sum) / count
        name = group_names[group_index] if group_names and group_index < len(group_names) else str(group_index)
        track_val_metrics(
            global_step, group_loss, experiments_tracker, group_name=name if len(val_dataloaders) > 1 else None
        )
    return group_loss


def get_group_names(args: TrainingArgs, key: str) -> list | None:
    """Validation / test group names from the dataset's `val_weighted_split_paths` /
    `test_weighted_split_paths` (a list of single-key {group_name: entries} dicts)."""
    paths = args.datasets[0].class_args.get(key) if args.datasets else None
    if not paths:
        return None
    return [list(group.keys())[0] for group in paths if isinstance(group, dict) and group]


def train(
    args: TrainingArgs,
    model,
    state: TrainState,
    lr_schedule,
    train_dataloader,
    val_dataloaders: list,
    test_dataloaders: list,
    experiments_tracker,
    starting_iteration: int = 0,
    consumed_samples: int = 0,
    rng_generator: torch.Generator | None = None,
) -> dict:
    """The pretraining loop. Returns what it ran: per step the loss, grad norm, lr, step
    and data-wait seconds; the eval losses by step; the test loss; the seconds the last
    async checkpoint took to commit."""
    device = model.model.device
    num_training_steps = args.training_parameters.num_training_steps
    gradient_accumulation_steps = args.training_parameters.gradient_accumulation_steps
    micro_batch_size = args.training_parameters.micro_batch_size
    sequence_length = args.datasets[0].class_args.get("sequence_length")
    eval_during_training = args.training_parameters.eval_during_training
    eval_interval = args.training_parameters.eval_interval
    eval_steps = args.datasets[0].class_args.get("eval_steps", 0) or 0
    save_interval = args.save_args.save_interval
    log_interval = args.logging_args.log_interval
    ft_args = args.fault_tolerance_args

    # the global batch; the FLOPs are one rank's (its share), so the MFU is the world's
    samples_per_step = micro_batch_size * gradient_accumulation_steps * get_data_parallel_world_size(args)
    tokens_per_step = samples_per_step * sequence_length
    step_tflops = get_model_tflops(
        model.config,
        batch_size=micro_batch_size * gradient_accumulation_steps,
        sequence_length=sequence_length,
        gradient_checkpointing_method=args.distributed_args.gradient_checkpointing_method,
        gradient_checkpointing_args=args.distributed_args.gradient_checkpointing_args,
    )

    telemetry = build_telemetry(args, experiments_tracker, model_tflops_per_step=step_tflops, device=device)
    install_telemetry(telemetry)
    monitor = build_health_monitor(args, telemetry)
    register_crash_hook(monitor.dump_flight_record)
    emit_model_report(
        telemetry,
        state,
        model_tflops_per_step=step_tflops,
        remat=estimate_remat_activation_bytes(
            model.config,
            batch_size=micro_batch_size,
            sequence_length=sequence_length,
            gradient_checkpointing_method=args.distributed_args.gradient_checkpointing_method,
            gradient_checkpointing_args=args.distributed_args.gradient_checkpointing_args,
            dtype_bytes=torch.tensor([], dtype=model.dtype).element_size(),
        ),
    )

    train_step = make_train_step(
        lambda micro: model.loss(micro["text"], train=True),
        state.optimizer,
        gradient_accumulation_steps=gradient_accumulation_steps,
        gradient_clipping=args.training_parameters.gradient_clipping,
        skip_nonfinite=ft_args.skip_nonfinite_steps,
        offload_optimizer=resolve_cpu_offload(args, device),
        collect_health=monitor.wants_step_metrics,
    )

    if rng_generator is None:
        rng_generator = torch.Generator().manual_seed(args.random_args.seed)

    # the step batch ({"text": [accum, B, S + 1]}) is stacked and copied to the device by
    # the prefetch worker up to prefetch_depth steps ahead. Megatron loaders resume through
    # consumed_samples, so batches buffered but not consumed are regenerated on restart
    prefetch_depth = args.training_parameters.prefetch_depth
    prefetcher = train_dataloader
    if not isinstance(prefetcher, StepPrefetcher):
        prefetcher = StepPrefetcher(
            train_dataloader,
            depth=prefetch_depth,
            micros_per_step=gradient_accumulation_steps,
            assemble_fn=lambda micros: {"text": torch.stack([m["text"] for m in micros])},
            device=device,
            description="megatron train dataloader",
        )
    # eval loaders are consumed eval_steps batches at a time: one persistent prefetcher
    # per group keeps the next eval's batches warm
    val_dataloaders = [
        dl if dl is None or isinstance(dl, StepPrefetcher)
        else StepPrefetcher(dl, depth=prefetch_depth, device=device, description="val dataloader")
        for dl in val_dataloaders
    ]
    test_dataloaders = [
        dl if dl is None or isinstance(dl, StepPrefetcher)
        else StepPrefetcher(dl, depth=prefetch_depth, device=device, description="test dataloader")
        for dl in test_dataloaders
    ]

    val_group_names = get_group_names(args, "val_weighted_split_paths")
    summary: dict = {"steps": [], "val_losses": {}, "test_loss": None, "checkpoint_commit_seconds": None}

    def run_eval(step: int) -> None:
        with telemetry.timer("eval"), trace_annotation("eval"):
            loss = evaluate(val_dataloaders, model, step, experiments_tracker, eval_steps, group_names=val_group_names)
        summary["val_losses"][step] = loss

    if eval_during_training and starting_iteration == 0 and eval_steps:
        run_eval(0)

    # the watchdog wraps the prefetcher's next(): a wedged prefetch worker still trips it
    batch_iter = prefetcher
    if ft_args.dataloader_stall_timeout_seconds is not None:
        batch_iter = StallWatchdog(
            batch_iter, ft_args.dataloader_stall_timeout_seconds, description="megatron train dataloader"
        )
    if ft_args.preemption_checkpointing:
        install_preemption_handler()

    loss_running_sum = 0.0
    loss_running_count = 0
    progress = ProgressBar(starting_iteration, num_training_steps)

    def checkpoint(step: int) -> None:
        with telemetry.timer("checkpoint"):
            save_checkpoint(
                args,
                model,
                state,
                None,  # megatron loaders resume through the consumed_samples metadata
                experiments_tracker,
                step,
                metadata={"consumed_samples": consumed_samples},
                rng_generator=rng_generator,
            )

    global_step = starting_iteration
    last_saved_step = None
    consecutive_nonfinite = 0
    preempted = False
    exit_status = "ok"
    try:
        while global_step < num_training_steps:
            global_step += 1

            # the data bucket charges only the time the loop waited on data
            batch = next(batch_iter)
            data_seconds = prefetcher.last_wait_seconds

            step_start = time.perf_counter()
            # this step's dropout, other masks on each rank's rows
            torch.manual_seed(int(torch.randint(0, 2**62, (), generator=rng_generator)) + process_index())
            with get_profiler_context(args.logging_args.torch_profiler_trace_path, global_step), step_annotation(
                global_step
            ):
                # ends in the host's read of the loss and grad norm: the step's device work is done
                metrics = train_step(state, batch)
            step_seconds = time.perf_counter() - step_start

            consumed_samples += samples_per_step
            loss, grad_norm = metrics["loss"], metrics["grad_norm"]
            step_skipped = bool(metrics.get("skipped", 0))
            if not step_skipped:  # a skipped step's loss is non-finite; keep the mean clean
                loss_running_sum += loss
                loss_running_count += 1

            telemetry.record_step(global_step, data_seconds, step_seconds)
            # feeds the flight recorder before the nonfinite abort can fire
            monitor.observe_step(
                global_step,
                loss=loss,
                grad_norm=grad_norm,
                step_seconds=step_seconds,
                data_seconds=data_seconds,
                skipped=step_skipped,
            )
            if monitor.health_due(global_step) and "health" in metrics:
                monitor.emit_health(global_step, metrics["health"])
            if ft_args.skip_nonfinite_steps:
                consecutive_nonfinite = handle_nonfinite_step(
                    step_skipped, consecutive_nonfinite, global_step, ft_args.max_consecutive_nonfinite_steps
                )
            # the lr this step's update used
            lr = float(lr_schedule(max(state.optimizer.schedule_count - 1, 0)))
            summary["steps"].append(
                {
                    "step": global_step,
                    "loss": loss,
                    "grad_norm": grad_norm,
                    "lr": lr,
                    "step_seconds": step_seconds,
                    "data_seconds": data_seconds,
                    "skipped": step_skipped,
                }
            )

            logging_step = global_step % log_interval == 0
            if logging_step:
                step_time = data_seconds + step_seconds
                track_train_metrics(
                    global_step=global_step,
                    train_loss_step=loss,
                    grad_norm=grad_norm,
                    current_lr=lr,
                    experiments_tracker=experiments_tracker,
                    loss_running_mean=loss_running_sum / max(loss_running_count, 1),
                    flops=step_tflops / step_time,
                    billion_tokens_per_day=tokens_per_step * 86400 / step_time / 1e9,
                    step_time=step_time,
                    mfu=telemetry.current_mfu(),
                )
                progress.set_postfix(loss=loss, tok_day_B=tokens_per_step * 86400 / step_time / 1e9, step_s=step_time)
            progress.track(global_step)

            if eval_during_training and eval_interval and eval_steps and global_step % eval_interval == 0:
                run_eval(global_step)

            if global_step % save_interval == 0 or global_step == num_training_steps:
                checkpoint(global_step)
                last_saved_step = global_step

            # the window record comes after eval / checkpoint, so their buckets land in the
            # window of the step that paid for them
            if logging_step:
                telemetry.emit_window(global_step)

            if any_rank(preemption_requested()):  # one rank's notice makes every rank save
                preempted = True
                log_rank_0(
                    logging.WARNING, f"preemption notice: saving final checkpoint at step {global_step} and exiting"
                )
                if last_saved_step != global_step:
                    checkpoint(global_step)
                break

        commit_start = time.perf_counter()
        finish_pending_checkpoint()  # commit an in-flight async save before exiting
        summary["checkpoint_commit_seconds"] = time.perf_counter() - commit_start
    except BaseException as error:
        exit_status = f"error:{type(error).__name__}"
        # the last-N-steps flight record before unwinding (a no-op if a fault-tolerance
        # hook already dumped it)
        monitor.dump_flight_record(crash_reason(error), error=error)
        raise
    finally:
        if ft_args.preemption_checkpointing:
            uninstall_preemption_handler()
        unregister_crash_hook(monitor.dump_flight_record)
        if isinstance(batch_iter, StallWatchdog):
            batch_iter.close()
        prefetcher.close()
        for dl in val_dataloaders:
            if isinstance(dl, StepPrefetcher):
                dl.close()
        progress.close()
        telemetry.close("preempted" if preempted else exit_status)
        uninstall_telemetry()

    # the test split after training; a preempted run skips it (the grace window is for saving)
    if not preempted and eval_during_training and eval_steps:
        try:
            test_loss = evaluate(
                test_dataloaders,
                model,
                global_step,
                None,
                eval_steps,
                group_names=get_group_names(args, "test_weighted_split_paths"),
            )
        finally:
            for dl in test_dataloaders:
                if isinstance(dl, StepPrefetcher):
                    dl.close()
        summary["test_loss"] = test_loss
        if test_loss is not None:
            if experiments_tracker is not None:
                experiments_tracker.track({"loss": test_loss}, step=global_step, context="test")
            log_rank_0(logging.INFO, f"step = {global_step}, test_loss = {test_loss:.4f}")
    else:
        for dl in test_dataloaders:
            if isinstance(dl, StepPrefetcher):
                dl.close()
    summary["preempted"] = preempted
    return summary


def main(args: TrainingArgs | None = None, device: str | torch.device = "cuda") -> dict:
    """Build everything from `args` (or ``--config``) and pretrain on `device`; returns
    `train`'s summary."""
    device = resolve_device(device)
    if args is None:
        args = get_args(Mode.training)
    if args.tuning_args.tuning_method != TuningMethod.pretraining:
        raise ValueError("pretraining requires tuning_method = pretraining")
    check_ported_options(args)
    init_distributed(args.distributed_args.timeout_minutes, device)

    seed = args.random_args.seed
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    model = get_model(args, Mode.training, device=device)
    log_model(model)
    wrap_model_for_distributed_training(args, model)
    optimizer, lr_schedule = build_optimizer_from_args(args, model)  # over the sharded parameters
    state = TrainState(model.model, optimizer, fp8=model.fp8)

    starting_iteration = 0
    consumed_samples = 0
    rng_generator = None
    if args.load_args is not None:
        state, starting_iteration, metadata, rng_generator = load_checkpoint_for_training(args, state)
        if metadata is not None:
            consumed_samples = metadata.get("consumed_samples", 0)

    train_dataloader, val_dataloaders, test_dataloaders = get_megatron_gpt_dataloaders(
        args, model.tokenizer, consumed_samples
    )

    experiments_tracker = ExperimentsTracker(
        experiment_name="dolomite-pretrain",
        tracker_name=args.logging_args.experiments_tracker_name,
        aim_args=args.logging_args.aim_args,
        wandb_args=args.logging_args.wandb_args,
        checkpoint_metadata=get_experiments_tracker_checkpoint_metadata(args),
    )
    experiments_tracker.log_args(args)

    summary = train(
        args,
        model,
        state,
        lr_schedule,
        train_dataloader,
        val_dataloaders,
        test_dataloaders,
        experiments_tracker,
        starting_iteration=starting_iteration,
        consumed_samples=consumed_samples,
        rng_generator=rng_generator,
    )
    experiments_tracker.finish()
    return summary


if __name__ == "__main__":
    main()
