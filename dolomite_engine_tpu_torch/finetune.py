"""Finetuning entry point: ``python -m dolomite_engine_tpu_torch.finetune --config cfg.yml``.

Counterpart of `dolomite_engine_tpu/finetune.py`: `main` wires args -> model (full
finetuning, LoRA or prompt tuning) -> the blended finetuning dataloaders -> optimizer and
schedule -> (resume) -> `train`; `train` is the step loop with eval at step 0, every
``eval_interval`` steps and at the end (a full pass over the validation split, through a
`PrefetchingIterable`), the telemetry windows, the health monitor and flight recorder,
checkpoints every ``save_interval`` steps and at the last step (with the train loader's
state, through the `StepPrefetcher`, so a resume continues the batch stream exactly), a
preemption notice's save-and-exit, and the shutdown of every worker on every exit path.
As in JAX there is no MFU: finetuning batches vary in length, so no analytic FLOPs model.

Step batches come from a `StepPrefetcher` that gathers the accumulation micro-batches
(each keeps its own padded length) and copies them to the card on a side stream. Each step's dropout seed comes from the loop's own
`torch.Generator` (seeded from ``random_args.seed``, saved in the checkpoint), as in
`pretrain.py`. Under LoRA and prompt tuning only the adapters train
(`model_wrapper/peft.py`); ``research_args.neft_alpha`` adds no noise, as in JAX (ROADMAP.md
Queue C). `main` joins the process group and shards the model under the ZeRO stage, as
`pretrain.main` does; each rank reads its strided shard of every global batch (or, with
``dispatching_dataloader``, its rows of the batch rank 0 broadcasts), the losses divide
by the global batch's token count (`ops/loss.py`), and the eval loss and a preemption
notice are agreed over the ranks. `main(args, device="cuda")` runs on the card; the tests
pass ``device="cpu"``.
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
from .data import PrefetchingIterable, StepPrefetcher, get_dataloader
from .device import resolve_device
from .distributed import wrap_model_for_distributed_training
from .enums import DatasetSplit, Mode, TuningMethod
from .model_wrapper import get_model, log_model
from .optimization import build_optimizer_from_args
from .train_utils import (
    TrainState,
    get_profiler_context,
    handle_nonfinite_step,
    make_train_step,
    resolve_checkpointing_args,
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

FINETUNING_METHODS = (TuningMethod.full_finetuning, TuningMethod.prompt_tuning, TuningMethod.lora)


def stack_micro_batches(micros: list[dict]) -> dict:
    """The step batch: for every key of the collated micro-batches (numpy arrays), the
    list of their tensors, one a micro-batch (``batch[key][i]``, as the train step reads
    them). A list, not a stacked tensor: padded micro-batches keep their own lengths,
    where the JAX package's ``jnp.stack`` raises on micro-batches of different lengths.
    Keys that are None are left out."""
    return {
        key: [torch.as_tensor(m[key]) for m in micros]
        for key, value in micros[0].items()
        if value is not None
    }


def evaluate(val_dataloader, model, global_step: int, experiments_tracker) -> float | None:
    """A full pass over the validation loader: the mean of its batches' losses (over the
    ranks, each rank's batch loss its share of the global batch's)."""
    if val_dataloader is None:
        return None
    loss_sum, count = 0.0, 0
    for batch in val_dataloader:
        with torch.no_grad():
            loss_sum += float(model.loss(batch, train=False))
        count += 1
    if count == 0:
        return None
    loss = sum_over_ranks(loss_sum) / count
    if experiments_tracker is not None:
        experiments_tracker.track({"loss": loss}, step=global_step, context="val")
    log_rank_0(logging.INFO, f"step = {global_step}, val loss = {loss:.4f}")
    return loss


def train(
    args: TrainingArgs,
    model,
    state: TrainState,
    lr_schedule,
    train_dataloader,
    val_dataloader,
    experiments_tracker,
    starting_iteration: int = 0,
    rng_generator: torch.Generator | None = None,
) -> dict:
    """The finetuning loop. Returns what it ran: per step the loss, grad norm, lr, step
    and data-wait seconds; the eval losses by step; the seconds the last async checkpoint
    took to commit; whether a preemption notice ended it."""
    device = model.model.device
    num_training_steps = args.training_parameters.num_training_steps
    gradient_accumulation_steps = args.training_parameters.gradient_accumulation_steps
    eval_during_training = args.training_parameters.eval_during_training
    eval_interval = args.training_parameters.eval_interval
    save_interval = args.save_args.save_interval
    log_interval = args.logging_args.log_interval
    ft_args = args.fault_tolerance_args

    telemetry = build_telemetry(args, experiments_tracker, device=device)
    install_telemetry(telemetry)
    monitor = build_health_monitor(args, telemetry)
    register_crash_hook(monitor.dump_flight_record)
    # batch shapes come from the data, so no activation estimate: the report names the policy
    ckpt_every, ckpt_policy = resolve_checkpointing_args(
        args.distributed_args.gradient_checkpointing_method, args.distributed_args.gradient_checkpointing_args
    )
    emit_model_report(
        telemetry, state, remat={"checkpoint_every": ckpt_every, "policy": ckpt_policy} if ckpt_every else None
    )

    train_step = make_train_step(
        lambda micro: model.loss(micro, train=True),
        state.optimizer,
        gradient_accumulation_steps=gradient_accumulation_steps,
        gradient_clipping=args.training_parameters.gradient_clipping,
        skip_nonfinite=ft_args.skip_nonfinite_steps,
        offload_optimizer=resolve_cpu_offload(args, device),
        collect_health=monitor.wants_step_metrics,
    )

    if rng_generator is None:
        rng_generator = torch.Generator().manual_seed(args.random_args.seed)

    summary: dict = {"steps": [], "val_losses": {}, "checkpoint_commit_seconds": None}

    def run_eval(step: int) -> None:
        with telemetry.timer("eval"), trace_annotation("eval"):
            summary["val_losses"][step] = evaluate(val_dataloader, model, step, experiments_tracker)

    if eval_during_training and starting_iteration == 0:
        run_eval(0)

    # `main` wraps the loader before the checkpoint load, so its resume state flows through
    # the prefetcher; a bare loader (tests driving train() directly) is wrapped here
    prefetcher = train_dataloader
    if not isinstance(prefetcher, StepPrefetcher):
        prefetcher = StepPrefetcher(
            train_dataloader,
            depth=args.training_parameters.prefetch_depth,
            micros_per_step=gradient_accumulation_steps,
            assemble_fn=stack_micro_batches,
            loop=True,
            device=device,
            description="train dataloader",
        )
    batch_iter = prefetcher
    if ft_args.dataloader_stall_timeout_seconds is not None:
        batch_iter = StallWatchdog(batch_iter, ft_args.dataloader_stall_timeout_seconds, description="train dataloader")
    if ft_args.preemption_checkpointing:
        install_preemption_handler()

    loss_running_sum = 0.0
    loss_running_count = 0
    progress = ProgressBar(starting_iteration, num_training_steps)

    def checkpoint(step: int) -> None:
        with telemetry.timer("checkpoint"):
            # the PREFETCHER's state: the loader runs ahead of what the loop consumed
            save_checkpoint(args, model, state, prefetcher, experiments_tracker, step, rng_generator=rng_generator)

    global_step = starting_iteration
    last_saved_step = None
    consecutive_nonfinite = 0
    preempted = False
    exit_status = "ok"
    try:
        while global_step < num_training_steps:
            global_step += 1

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

            loss, grad_norm = metrics["loss"], metrics["grad_norm"]
            step_skipped = bool(metrics.get("skipped", 0))
            if not step_skipped:  # a skipped step's loss is non-finite; keep the mean clean
                loss_running_sum += loss
                loss_running_count += 1

            telemetry.record_step(global_step, data_seconds, step_seconds)
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
            lr = float(lr_schedule(max(state.optimizer.schedule_count - 1, 0)))  # this step's
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
                track_train_metrics(
                    global_step=global_step,
                    train_loss_step=loss,
                    grad_norm=grad_norm,
                    current_lr=lr,
                    experiments_tracker=experiments_tracker,
                    loss_running_mean=loss_running_sum / max(loss_running_count, 1),
                    step_time=data_seconds + step_seconds,
                )
                progress.set_postfix(loss=loss, step_s=data_seconds + step_seconds)
            progress.track(global_step)

            if eval_during_training and eval_interval and global_step % eval_interval == 0:
                run_eval(global_step)

            if global_step % save_interval == 0 or global_step == num_training_steps:
                checkpoint(global_step)
                last_saved_step = global_step

            # after eval / checkpoint, so their buckets land in the window that paid for them
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
        monitor.dump_flight_record(crash_reason(error), error=error)
        raise
    finally:
        if ft_args.preemption_checkpointing:
            uninstall_preemption_handler()
        unregister_crash_hook(monitor.dump_flight_record)
        if isinstance(batch_iter, StallWatchdog):
            batch_iter.close()
        prefetcher.close()
        progress.close()
        telemetry.close("preempted" if preempted else exit_status)
        uninstall_telemetry()

    # the final eval, unless the loop just ran one or a preemption ended it
    if not preempted and eval_during_training and (not eval_interval or global_step % eval_interval != 0):
        run_eval(global_step)
    summary["preempted"] = preempted
    return summary


def main(args: TrainingArgs | None = None, device: str | torch.device = "cuda") -> dict:
    """Build everything from `args` (or ``--config``) and finetune on `device`; returns
    `train`'s summary."""
    device = resolve_device(device)
    if args is None:
        args = get_args(Mode.training)
    assert args.tuning_args.tuning_method in FINETUNING_METHODS, "finetune requires a finetuning tuning method"
    check_ported_options(args)
    init_distributed(args.distributed_args.timeout_minutes, device)

    seed = args.random_args.seed
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    model = get_model(args, Mode.training, device=device)
    log_model(model)
    wrap_model_for_distributed_training(args, model)

    train_dataloader = get_dataloader(
        args, DatasetSplit.train, Mode.training, model.tokenizer, is_encoder_decoder=model.is_encoder_decoder
    )
    val_dataloader = None
    if args.training_parameters.eval_during_training:
        val_dataloader = get_dataloader(
            args, DatasetSplit.val, Mode.training, model.tokenizer, is_encoder_decoder=model.is_encoder_decoder
        )

    # wrapped BEFORE the checkpoint load, so the loader's resume state flows through the
    # prefetcher (which accounts for batches buffered but not consumed)
    prefetch_depth = args.training_parameters.prefetch_depth
    if train_dataloader is not None:
        train_dataloader = StepPrefetcher(
            train_dataloader,
            depth=prefetch_depth,
            micros_per_step=args.training_parameters.gradient_accumulation_steps,
            assemble_fn=stack_micro_batches,
            loop=True,
            device=device,
            description="train dataloader",
        )
    if val_dataloader is not None:
        # restartable per-pass prefetch: each eval is one full pass
        val_dataloader = PrefetchingIterable(val_dataloader, prefetch_depth, description="val dataloader")

    optimizer, lr_schedule = build_optimizer_from_args(args, model)  # the trainable parameters only
    state = TrainState(model.model, optimizer, fp8=model.fp8)

    starting_iteration = 0
    rng_generator = None
    if args.load_args is not None:
        state, starting_iteration, _, rng_generator = load_checkpoint_for_training(args, state, train_dataloader)

    experiments_tracker = ExperimentsTracker(
        experiment_name="dolomite-finetune",
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
        val_dataloader,
        experiments_tracker,
        starting_iteration=starting_iteration,
        rng_generator=rng_generator,
    )
    experiments_tracker.finish()
    return summary


if __name__ == "__main__":
    main()
