"""Config/flag system: one YAML -> typed pydantic tree, per-mode roots.

Counterpart of `dolomite_engine_tpu/arguments.py`: the same class names, field names,
defaults and cross-field validation, so the repo's YAMLs parse unchanged. A YAML parses
whatever it asks for; `check_ported_options` (called by the port's entry points) then
refuses, naming the ROADMAP item, each option the port does not run: tensor, context,
expert and sequence parallelism, the aim / wandb trackers, on-demand profiling and
program signatures; and it refuses a pinned `kernel_args` family, since the port has no
backend switch (the tensor's device picks the kernel or its plain version). Every ZeRO
stage, ``data_parallel_size`` (held to the world), ``zero_topology`` and
``dispatching_dataloader`` run, as do the remat policies, fp8, CPU offload and the
health statistics. ``scan_layers`` is accepted: it changes only the compiled program of
the JAX package, and the port runs its blocks in a Python loop.
`check_ported_inference_options` refuses a ``model_name`` without ``load_args``: the
JAX package loads that directory's weights, which the port does not read yet.
"""

from __future__ import annotations

import logging
import os
from argparse import ArgumentParser
from enum import Enum
from typing import Any

from pydantic import model_validator

from .defaults import INPUT_FORMAT, OUTPUT_FORMAT
from .enums import (
    AttentionImplementation,
    DistributedBackend,
    ExperimentsTrackerName,
    FP8Backend,
    GradientCheckpointingMethod,
    KernelBackend,
    LossMask,
    LRDecaySchedule,
    Mode,
    MOE_IMPLEMENTATIONS,
    ParamsGroupMethod,
    TuningMethod,
)
from .utils import BaseArgs, load_yaml, log_rank_0, normalize_dtype_string, run_rank_n, set_logger
from .utils.hf_hub import HUB_NOT_PORTED


def _check_not_None(object_name_list: list[tuple[Any, str]]) -> None:
    for obj, name in object_name_list:
        assert obj is not None, f"{name} cannot be None"


class PromptTuningInit(Enum):
    RANDOM = "RANDOM"
    TEXT = "TEXT"


class RandomArgs(BaseArgs):
    # seed for all RNG streams (python/numpy/torch)
    seed: int = 42


class TokenizerArgs(BaseArgs):
    # tokenizer path/hub id taking precedence over the model's own
    tokenizer_name: str | None = None
    # extra special tokens appended to the tokenizer (may grow the embedding)
    additional_special_tokens: list[str] | None = None


class ModelArgs(BaseArgs):
    # HF hub id or local checkpoint dir to load
    model_name: str | None = None
    # inline config dict for from-scratch construction (mutually exclusive with model_name)
    pretrained_config: dict | None = None
    # model family class: AutoModelForCausalLM / AutoModelForSeq2SeqLM
    model_class: str = None
    # trust remote code (accepted for config compat; unused by the JAX registry)
    trust_remote_code: bool = False
    # attention backend: eager/sdpa/flash_attention_2 (+ ring/ulysses CP extensions)
    attention_implementation: AttentionImplementation | None = None
    # padding-free transformer: packed sequences + segment-ids attention
    use_padding_free_transformer: bool = False
    # low-memory init (JAX always does abstract init + sharded materialization; accepted no-op)
    efficient_initialization: bool = False
    # whether to reset attention masks at document boundaries for pretraining
    reset_attention_mask: bool = False
    # whether to reset position ids at document boundaries for pretraining
    reset_position_ids: bool = False
    # extra config fields merged over the model config (reference configs e.g.
    # instruction_tuning/bloom-3b-slimorca-training.yml use this shape)
    config_extras: dict | None = None
    # MoE compute path: scattermoe/scatter (ragged grouped GEMM), eager, auto
    # (reference configs/testing/scattermoe.yml)
    moe_implementation: str | None = None
    # TPU extension (no reference counterpart): nn.scan over one transformer block instead
    # of unrolling n_layer copies — ~n_layer-fold faster trace+compile for deep models.
    # gpt_dolomite training only; with gradient checkpointing EVERY block remats
    # (every-k-th is not expressible under one scanned layer)
    scan_layers: bool = False

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.model_class, "model_class")])

        if self.model_name is None:
            _check_not_None([(self.pretrained_config, "pretrained_config")])
        else:
            assert self.pretrained_config is None, (
                "pretrained_config shouldn't be specified with model_name"
            )

        assert self.model_class in ["AutoModelForCausalLM", "AutoModelForSeq2SeqLM"], (
            f"unexpected model_class ({self.model_class})"
        )

        assert self.moe_implementation is None or self.moe_implementation in MOE_IMPLEMENTATIONS, (
            f"unexpected moe_implementation ({self.moe_implementation})"
        )


class PromptTuningArgs(BaseArgs):
    # how prompt-tuning virtual tokens initialize (random or from text)
    prompt_tuning_init: PromptTuningInit = None
    # seed text whose token embeddings initialize the virtual tokens
    prompt_tuning_init_text: str | None = None
    # virtual-token count prepended by prompt tuning
    num_virtual_tokens: int | None = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.prompt_tuning_init, "prompt_tuning_init")])

        if self.prompt_tuning_init == PromptTuningInit.RANDOM:
            assert self.prompt_tuning_init_text is None, (
                f"prompt_tuning_init_text '{self.prompt_tuning_init_text}' was specified "
                "with RANDOM init method"
            )
        elif self.prompt_tuning_init == PromptTuningInit.TEXT:
            assert self.prompt_tuning_init_text is not None, (
                "prompt_tuning_init_text needs to be specified with TEXT init method"
            )


class LoRAArgs(BaseArgs):
    # rank of the LoRA update matrices
    lora_rank: int = None
    # LoRA alpha: update scaled by alpha/rank
    lora_alpha: float = 32.0
    # dropout applied to LoRA adapter inputs
    lora_dropout: float = 0.1
    # linear-module name fragments that grow adapters; None selects per-architecture
    # defaults (fused c_attn; encoder-decoder models additionally adapt the
    # cross-attention c_q/c_kv projections, the most task-specific part of a seq2seq tune)
    lora_target_modules: list[str] | None = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.lora_rank, "lora_rank")])


class TuningArgs(BaseArgs):
    # training regime: pretraining, full_finetuning, lora, prompt_tuning
    tuning_method: TuningMethod = None
    # knobs for prompt tuning (used when tuning_method selects it)
    prompt_tuning_args: PromptTuningArgs | None = None
    # knobs for LoRA (used when tuning_method selects it)
    lora_args: LoRAArgs | None = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.tuning_method, "tuning_method")])

        if self.tuning_method in [TuningMethod.full_finetuning, TuningMethod.pretraining]:
            assert self.prompt_tuning_args is None, (
                "prompt_tuning_args should not be specified with full_finetuning or pretraining"
            )
            assert self.lora_args is None, (
                "lora_args should not be specified with full_finetuning or pretraining"
            )
        elif self.tuning_method == TuningMethod.prompt_tuning:
            assert self.lora_args is None, "lora_args should not be specified with prompt_tuning"
        elif self.tuning_method == TuningMethod.lora:
            assert self.prompt_tuning_args is None, (
                "prompt_tuning_args should not be specified with lora"
            )

    def get_num_virtual_tokens(self) -> int:
        return (
            self.prompt_tuning_args.num_virtual_tokens
            if self.tuning_method == TuningMethod.prompt_tuning
            else 0
        )


class TrainingParameters(BaseArgs):
    # validation iterates in corpus order instead of shuffling
    ignore_sampling_proportion_for_validation: bool = False
    # total optimizer steps to run
    num_training_steps: int | None = None
    # micro-steps folded into one optimizer step (lax.scan in the jitted step)
    gradient_accumulation_steps: int = 1
    # evaluate every this many steps
    eval_interval: int | None = None
    # per-data-parallel-replica micro batch size
    micro_batch_size: int = None
    # run in-loop validation
    eval_during_training: bool = True
    # which tokens contribute loss (output_only masks the prompt)
    loss_mask: LossMask = LossMask.output_only
    # global-norm gradient clipping threshold
    gradient_clipping: float | None = 1
    # async input pipeline (data/prefetch.py): step batches assembled and placed on device
    # by a background thread, up to this many buffered ahead of the loop so host data work
    # and H2D transfer overlap the previous jitted step. 0 = fully synchronous path
    # (byte-identical batch order, no thread). Resume stays exact at any depth: the
    # prefetcher's checkpoint state replays batches buffered but not yet consumed
    prefetch_depth: int = 2

    def model_post_init(self, __context: Any) -> None:
        _check_not_None(
            [
                (self.num_training_steps, "num_training_steps"),
                (self.micro_batch_size, "micro_batch_size"),
            ]
        )

        if self.eval_during_training:
            _check_not_None([(self.eval_interval, "eval_interval")])

        assert self.prefetch_depth >= 0, (
            f"prefetch_depth must be >= 0 (got {self.prefetch_depth}); 0 disables the "
            "async input pipeline"
        )


class SaveArgs(BaseArgs):
    # checkpoint output directory
    save_path: str = None
    # save every this many steps
    save_interval: int = None
    # include optimizer state in checkpoints (skip to shrink them)
    save_optimizer: bool = True
    # overlap checkpoint disk writes with training (TPU-native extension, not in the
    # reference): the device->host copy is synchronous, the serialization+write runs in a
    # background thread; the `latest` pointer is only advanced once the write commits
    async_checkpointing: bool = False
    # retention: after each COMMITTED save, prune global_step* dirs beyond the newest N;
    # the checkpoint named by the `latest` pointer is never deleted. None keeps everything
    # (current behavior)
    keep_last_n: int | None = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.save_path, "save_path"), (self.save_interval, "save_interval")])

        assert self.keep_last_n is None or self.keep_last_n >= 1, (
            f"keep_last_n must be >= 1 (got {self.keep_last_n}); use None to keep everything"
        )


class LoadArgs(BaseArgs):
    # path to load checkpoints
    load_path: str = None
    # iteration to load
    iteration: int | None = None
    # whether to load optimizer
    load_optimizer: bool = True
    # whether to load lr_scheduler
    load_lr_scheduler: bool = True
    # whether to load rng state
    load_rng_state: bool = True
    # whether to resume dataloader
    load_dataloader_state: bool = True
    # whether to resume experiments tracker
    load_experiments_tracker_state: bool = True
    # whether to load starting iteration
    load_starting_iteration: bool = True
    # whether to resume learning rate during training (NO-OP when loading lr scheduler)
    resume_learning_rate: bool = True

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.load_path, "load_path")])

        if not self.load_optimizer:
            assert not self.load_lr_scheduler, (
                "lr_scheduler loading doesn't make sense if you aren't loading optimizer"
            )

        if self.load_lr_scheduler:
            assert self.resume_learning_rate, (
                "resume learning rate needs to be True when reloading LR scheduler"
            )


class DatasetArgs(BaseArgs):
    # dataset class
    class_name: str = None
    # class args for dataset
    class_args: dict = {}
    # dataset name
    data_name: str = None
    # formatting to use for input
    input_format: str = INPUT_FORMAT
    # formatting to use for output
    output_format: str = OUTPUT_FORMAT
    # data sampling proportions
    data_sampling_ratio: int | None = None
    # max tokens for input text
    max_input_tokens: int | None = None
    # max tokens for output text
    max_output_tokens: int | None = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.class_name, "dataset class_name"), (self.data_name, "data_name")])

        if self.data_sampling_ratio is not None:
            assert self.data_sampling_ratio > 0, "data_sampling_ratio should be a positive integer"


class OptimizerArgs(BaseArgs):
    # optimizer class
    class_name: str = "TorchAdamW"
    # how to create param groups
    params_group_method: ParamsGroupMethod | None = None
    # class args for optimizer
    class_args: dict = {
        "lr": 1e-5,
        "weight_decay": 0.1,
        "betas": [0.9, 0.95],
        "eps": 1e-10,
    }

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.class_name, "optimizer class_name")])


class LRSchedulerArgs(BaseArgs):
    @model_validator(mode="before")
    @classmethod
    def _alias_lr_schedule(cls, data):
        # older reference configs (e.g. instruction_tuning/bloom-3b-slimorca-training.yml)
        # spell lr_decay_style as lr_schedule
        if isinstance(data, dict) and "lr_schedule" in data and "lr_decay_style" not in data:
            data = dict(data)
            data["lr_decay_style"] = data.pop("lr_schedule")
        return data

    # warmup steps
    num_warmup_steps: int = 200
    # constant steps after warmup and before decay
    num_constant_steps: int = 0
    # decay steps after constant steps, if None then all remaining steps are for decay
    num_decay_steps: int | None = None
    # lr scheduler for decay
    lr_decay_style: LRDecaySchedule = LRDecaySchedule.cosine
    # decay factor * max_lr = min_lr
    lr_decay_factor: float = 0.1
    # coefficients for advanced LR schedules (power: {"a", "b", "c"})
    extra_lr_scheduler_args: dict = {}


class MixedPrecisionArgs(BaseArgs):
    # dtype to use for training / inference
    dtype: str = "fp32"
    # fp8 backend (accepted for config compat; TPU fp8 rides XLA fp8 dots)
    fp8_backend: FP8Backend | None = None  # dolint: disable=config-dead-field (compat knob; TPU fp8 always rides XLA fp8 dots)

    def model_post_init(self, __context: Any) -> None:
        self.dtype = normalize_dtype_string(self.dtype)

        if self.dtype != "fp8":
            assert self.fp8_backend is None, "fp8_backend specified without fp8 dtype"


class ZeroTopologyArgs(BaseArgs):
    # devices to use for replication
    data_parallel_replication_world_size: int | None = None
    # devices to use for sharding
    data_parallel_sharding_world_size: int | None = None

    def model_post_init(self, __context: Any) -> None:
        if self.data_parallel_replication_world_size is None:
            assert self.data_parallel_sharding_world_size is None, (
                "data_parallel_replication_world_size needs to be specified with "
                "data_parallel_sharding_world_size"
            )
        else:
            assert self.data_parallel_sharding_world_size is not None, (
                "data_parallel_sharding_world_size needs to be specified with "
                "data_parallel_replication_world_size"
            )


class DistributedArgs(BaseArgs):
    # ZeRO stage (0 = DDP, 1/2 = opt-state sharding, 3 = full param sharding)
    stage: int = 3
    # distributed backend name, parsed and kept (the port trains in one process)
    distributed_backend: DistributedBackend = DistributedBackend.jax
    # overlap communication with computation (XLA latency-hiding scheduler)
    overlap_comm: bool = False  # dolint: disable=config-dead-field (XLA's latency-hiding scheduler already overlaps; accepted no-op)
    # accepted no-op (GPU memory layout knob)
    contiguous_gradients: bool = False  # dolint: disable=config-dead-field (GPU memory-layout knob; accepted no-op)
    # CPU offloading: optimizer state lives in pinned host memory (ZeRO-Offload
    # equivalent; distributed/__init__.py get_state_shardings)
    cpu_offload: bool = False
    # gradient checkpointing method
    gradient_checkpointing_method: GradientCheckpointingMethod | None = None
    # gradient checkpointing args: {"checkpoint_every": k, "policy": full|save_dots|
    # save_attention_out|offload_dots}; legacy keys block_frequency and
    # checkpoint_policy (raw jax.checkpoint_policies names) stay accepted. Keys and
    # policy values are validated below (and by the dolo-lint config-drift checker)
    # so a YAML typo fails at parse time, not after a pod claim
    gradient_checkpointing_args: dict = {}
    # zero topology
    zero_topology: ZeroTopologyArgs = ZeroTopologyArgs()
    # ZeRO++ knobs: accepted no-ops on TPU
    zero_quantized_weights: bool = False  # dolint: disable=config-dead-field (ZeRO++ knob; accepted no-op on TPU)
    zero_quantized_gradients: bool = False  # dolint: disable=config-dead-field (ZeRO++ knob; accepted no-op on TPU)
    # communication dtype
    communication_dtype: str | None = None  # dolint: disable=config-dead-field (GSPMD chooses collective dtypes; normalized + accepted for compat)
    # accepted no-op: XLA always compiles
    torch_compile: bool = False  # dolint: disable=config-dead-field (XLA always compiles; accepted no-op)
    # single-host-storage mode: only process 0 reads the corpus; batches broadcast over
    # the interconnect (data/dataloader.py DispatchingDataLoader). Default: per-host
    # sharded feed (ShardedDataLoader), which is strictly better on shared storage
    dispatching_dataloader: bool = False
    # tensor parallel world size
    tensor_parallel_size: int = 1
    # tensor parallel embeddings (vocab-parallel lm head + sharded loss)
    tensor_parallel_word_embeddings: bool = False
    # Megatron-style sequence parallel (activation seq sharding inside TP region)
    sequence_parallel: bool = False
    # context parallel world size (ring/all-gather KV sequence parallelism; TPU extension)
    context_parallel_size: int = 1
    # expert parallel world size for MoE (TPU extension; reference only TP-shards experts)
    expert_parallel_size: int = 1
    # data parallel world size
    data_parallel_size: int | None = None
    # distributed timeout in minutes
    timeout_minutes: int | None = None
    # accepted no-op (FSDP1 vs FSDP2 is meaningless under GSPMD)
    fsdp_algorithm: int = 1  # dolint: disable=config-dead-field (FSDP1-vs-2 is meaningless under GSPMD; accepted no-op)

    def model_post_init(self, __context: Any) -> None:
        if self.communication_dtype is not None:
            self.communication_dtype = normalize_dtype_string(self.communication_dtype)

        if self.sequence_parallel:
            assert self.tensor_parallel_size > 1, (
                "tensor parallel needs to be enabled for sequence parallel"
            )

        if self.gradient_checkpointing_args:
            known_keys = {"checkpoint_every", "block_frequency", "checkpoint_policy", "policy"}
            unknown = set(self.gradient_checkpointing_args) - known_keys
            if unknown:
                raise ValueError(
                    f"unknown gradient_checkpointing_args key(s) {sorted(unknown)} "
                    f"(expected one of {sorted(known_keys)})"
                )
            policy = self.gradient_checkpointing_args.get("policy")
            if policy is not None:
                # deferred: the named-policy vocabulary lives next to its implementation
                from .models.gpt_dolomite import REMAT_POLICY_NAMES

                if policy not in REMAT_POLICY_NAMES:
                    raise ValueError(
                        f"unknown gradient_checkpointing_args.policy '{policy}' "
                        f"(expected one of {REMAT_POLICY_NAMES}; raw "
                        "jax.checkpoint_policies names go under 'checkpoint_policy')"
                    )


class AimArgs(BaseArgs):
    # aim repo, experiment logs are saved here
    repo: str = None
    # name of the experiment
    experiment: str = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.repo, "repo"), (self.experiment, "experiment")])


class WandBArgs(BaseArgs):
    # wandb project
    project: str = None
    # name of the experiment
    name: str = None
    # wandb entity
    entity: str | None = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.project, "project"), (self.name, "name")])


class HealthArgs(BaseArgs):
    """Training health monitor (docs/OBSERVABILITY.md, `utils/diagnostics.py`): per-layer-group
    tensor stats computed inside the jitted step, rolling anomaly detection over
    loss/grad-norm/step-time, and a crash flight recorder."""

    # steps between `health` records (per-group grad/param norms + update/param ratios,
    # computed inside the jitted step). 0 (default) disables: the step HLO is unchanged and
    # no per-step host sync is added. Any value > 0 syncs loss/grad-norm every step (same
    # cost as fault_tolerance_args.skip_nonfinite_steps)
    interval: int = 0
    # EWMA smoothing factor for the loss/grad-norm running moments
    ewma_alpha: float = 0.05
    # |z-score| at which a loss/grad-norm sample is flagged as an `anomaly` event
    zscore_threshold: float = 6.0
    # samples per signal before z-scoring starts (cold moments are meaningless)
    warmup_steps: int = 20
    # rolling window of steady step times for the straggler median
    straggler_window: int = 50
    # flag a step slower than this multiple of the rolling-median step time
    straggler_factor: float = 2.0
    # escalate to the fault-tolerance abort path (RuntimeError + flight-record dump) after
    # this many CONSECUTIVE anomalous steps; None (default) only reports
    abort_after_consecutive_anomalies: int | None = None
    # ring-buffer capacity of the crash flight recorder: the last N step records dumped to
    # <save_path>/telemetry/flight-record-rank-<N>.json on crash/stall/NaN-abort; 0 disables
    flight_recorder_steps: int = 256

    def model_post_init(self, __context: Any) -> None:
        assert self.interval >= 0, "health.interval must be >= 0 (0 disables)"
        assert 0.0 < self.ewma_alpha <= 1.0, "health.ewma_alpha must be in (0, 1]"
        assert self.zscore_threshold > 0, "health.zscore_threshold must be positive"
        assert self.warmup_steps >= 1, "health.warmup_steps must be >= 1"
        assert self.straggler_window >= 2, "health.straggler_window must be >= 2"
        assert self.straggler_factor > 1.0, "health.straggler_factor must be > 1"
        assert (
            self.abort_after_consecutive_anomalies is None
            or self.abort_after_consecutive_anomalies >= 1
        ), "health.abort_after_consecutive_anomalies must be >= 1 or None"
        assert self.flight_recorder_steps >= 0, (
            "health.flight_recorder_steps must be >= 0 (0 disables)"
        )


class TelemetryArgs(BaseArgs):
    """Always-on structured telemetry (docs/OBSERVABILITY.md): goodput breakdown, MFU,
    device-memory gauges, and fault-tolerance counters land in a per-host JSONL sink with no
    optional deps; on-demand profiling captures a labeled N-step trace mid-run."""

    # rank-tagged JSONL metrics sink: per-step timings, per-window goodput breakdown + MFU +
    # memory gauges, cumulative counters
    jsonl_sink: bool = True
    # sink path; None derives <save_args.save_path>/telemetry/rank-<process>.jsonl
    jsonl_path: str | None = None
    # poll for a profile trigger each step; touching the trigger file (or SIGUSR1) captures
    # a labeled trace of the next profile_steps steps without restarting the run
    on_demand_profiling: bool = False
    # trigger file polled each step; None derives <save_path>/telemetry/PROFILE_TRIGGER
    profile_trigger_path: str | None = None
    # also arm the capture on SIGUSR1 (only installed when on_demand_profiling is on)
    profile_on_sigusr1: bool = True
    # train steps covered by each on-demand capture
    profile_steps: int = 3
    # trace output dir; None derives <save_path>/telemetry/traces
    profile_output_path: str | None = None
    # per-device peak TFLOPs for MFU; None auto-detects from the card's name
    # (utils/telemetry.py), or set DOLOMITE_PEAK_TFLOPS_PER_DEVICE
    peak_tflops_per_device: float | None = None
    # capture the jitted train step's compiled-program perf signature at run start and
    # write it as a `program_signature` record (utils/program_signature.py): cost flops,
    # memory_analysis buffer breakdown, donation count, HLO features. Costs ONE extra
    # AOT compile of the train step before the loop, hence off by default
    program_signatures: bool = False
    # training health monitor: per-layer-group tensor stats, anomaly detection, crash
    # flight recorder (stats collection off by default; flight recorder on)
    health: HealthArgs = HealthArgs()

    def model_post_init(self, __context: Any) -> None:
        assert self.profile_steps >= 1, "profile_steps must be >= 1"
        assert self.peak_tflops_per_device is None or self.peak_tflops_per_device > 0, (
            "peak_tflops_per_device must be positive or None"
        )


class LoggingArgs(BaseArgs):
    # logging level
    logging_level: str = "INFO"
    # log interval
    log_interval: int = 1
    # arguments if using aim
    aim_args: AimArgs | None = None
    # arguments if using wandb
    wandb_args: WandBArgs | None = None
    # experiment tracker to use (aim or wandb)
    experiments_tracker_name: ExperimentsTrackerName | None = None
    # whether to use colored logs
    use_colored_logs: bool = False
    # profiler trace path; specifying a path writes a torch.profiler trace of global step 6
    # (train_utils.get_profiler_context)
    torch_profiler_trace_path: str | None = None
    # always-on telemetry: JSONL metrics sink, goodput/MFU accounting, on-demand profiling
    telemetry: TelemetryArgs = TelemetryArgs()

    def model_post_init(self, __context: Any) -> None:
        if self.experiments_tracker_name == ExperimentsTrackerName.aim:
            _check_not_None([(self.aim_args, "aim_args")])
        elif self.experiments_tracker_name == ExperimentsTrackerName.wandb:
            _check_not_None([(self.wandb_args, "wandb_args")])


class ResearchArgs(BaseArgs):
    # scalar of noise to inject into input embeddings (NEFTune, arxiv 2310.05914)
    neft_alpha: float | None = None


class FaultToleranceArgs(BaseArgs):
    """Long-run survival knobs (no reference counterpart — the reference engine dies on the
    first SIGTERM, NaN step, or storage blip). Defaults preserve prior behavior except
    preemption handling, which is purely additive: it only changes what happens when the
    process is being killed anyway."""

    # SIGTERM/SIGINT (TPU maintenance-event and spot-reclaim notices, ^C) trigger a final
    # synchronous checkpoint at the end of the current step and a clean exit
    preemption_checkpointing: bool = True
    # skip the optimizer update on steps whose loss or grad-norm is non-finite (lax.cond
    # inside the jitted step returns params/opt-state unchanged); costs one host sync per
    # step for the skip counter
    skip_nonfinite_steps: bool = False
    # abort the run after this many CONSECUTIVE skipped steps (divergence, bad data shard)
    max_consecutive_nonfinite_steps: int = 10
    # wall-clock seconds one next(train_dataloader) may take before the run aborts with a
    # clear error instead of hanging forever; None disables the watchdog
    dataloader_stall_timeout_seconds: float | None = None
    # bounded exponential backoff for checkpoint save/load and `latest`-pointer I/O
    # (transient GCS/NFS errors): total tries, initial delay, delay cap
    checkpoint_io_attempts: int = 3
    checkpoint_io_backoff_seconds: float = 1.0
    checkpoint_io_max_backoff_seconds: float = 30.0

    def model_post_init(self, __context: Any) -> None:
        assert self.max_consecutive_nonfinite_steps >= 1, (
            "max_consecutive_nonfinite_steps must be >= 1"
        )
        assert self.checkpoint_io_attempts >= 1, "checkpoint_io_attempts must be >= 1"
        assert (
            self.dataloader_stall_timeout_seconds is None
            or self.dataloader_stall_timeout_seconds > 0
        ), "dataloader_stall_timeout_seconds must be positive or None"


class KernelArgs(BaseArgs):
    """The JAX package's per-op-family lowering choice, parsed as it is. The port takes
    only ``auto`` (`check`): a CUDA tensor launches the family's hand-written kernel and a
    CPU tensor runs its plain version."""

    # full-sequence causal attention: GQA-native splash kernel vs legacy flash/sdpa
    splash_attention: KernelBackend = KernelBackend.auto
    # serving decode/verify attention straight off the paged KV pool's page table
    paged_attention: KernelBackend = KernelBackend.auto
    # chunked-prefill flash attention through the page table (online softmax) — the
    # serving engine's prefill chunks skip the worst-case gathered view
    prefill_attention: KernelBackend = KernelBackend.auto
    # per-page KV quantization encode (int8/fp8 paged pools' quantize-on-scatter)
    paged_kv_quant: KernelBackend = KernelBackend.auto
    # fused RMSNorm(+residual add) inside the transformer block
    rmsnorm: KernelBackend = KernelBackend.auto
    # grouped-GEMM MoE dispatch (sort-by-expert segment GEMMs) for the dense + EP paths
    moe_dispatch: KernelBackend = KernelBackend.auto
    # vocab-tiled online-logsumexp chunk reduction inside the chunked fused LM-head
    # loss (config.fused_lm_head_loss; the XLA chunked path is already the memory win)
    fused_ce: KernelBackend = KernelBackend.auto
    # fused QKV-split + rotary embedding at the shared attention entry (training
    # forward and every serving program)
    fused_rope_qkv: KernelBackend = KernelBackend.auto

    def check(self) -> None:
        """The port has no backend switch: a CUDA tensor takes the hand-written kernel and a
        CPU tensor its plain version, so every family must be ``auto``."""
        pinned = {name: value.value for name, value in self if value != KernelBackend.auto}
        if pinned:
            raise ValueError(
                f"kernel_args pins {pinned}: the port has no backend switch (the tensor's "
                "device picks the kernel or its plain version); leave every family 'auto'"
            )


class TrainingArgs(BaseArgs):
    # randomization related arguments
    random_args: RandomArgs = RandomArgs()
    # tokenizer related arguments
    tokenizer_args: TokenizerArgs = TokenizerArgs()
    # model related arguments
    model_args: ModelArgs = None
    # tuning related arguments
    tuning_args: TuningArgs = None
    # optimizer related arguments
    optimizer_args: OptimizerArgs = OptimizerArgs()
    # lr_scheduler related arguments
    lr_scheduler_args: LRSchedulerArgs = LRSchedulerArgs()
    # list of datasets to use
    datasets: list[DatasetArgs] = []
    # save related arguments
    save_args: SaveArgs = None
    # load related arguments
    load_args: LoadArgs | None = None
    # training parameters
    training_parameters: TrainingParameters | None = None
    # logging related arguments
    logging_args: LoggingArgs = LoggingArgs()
    # mixed precision related arguments
    mixed_precision_args: MixedPrecisionArgs = MixedPrecisionArgs()
    # distributed training related arguments
    distributed_args: DistributedArgs = DistributedArgs()
    # research args
    research_args: ResearchArgs = ResearchArgs()
    # fault tolerance: preemption checkpointing, NaN/stall guards, checkpoint I/O retry
    fault_tolerance_args: FaultToleranceArgs = FaultToleranceArgs()
    # per-op-family kernel backend selection (Pallas tier; docs/PERFORMANCE.md)
    kernel_args: KernelArgs = KernelArgs()

    def model_post_init(self, __context: Any) -> None:
        _check_not_None(
            [
                (self.model_args, "model_args"),
                (self.tuning_args, "tuning_args"),
                (self.save_args, "save_args"),
                (self.datasets, "datasets"),
            ]
        )

        _check_datasets(self.datasets)


class GenerationParameters(BaseArgs):
    # batch size
    batch_size: int = None
    # sample or greedy
    do_sample: bool | None = None
    # max new tokens to generate
    max_new_tokens: int = None
    # temperature
    temperature: float | None = None
    # top k
    top_k: int | None = None
    # top p
    top_p: float | None = None
    # prompt width bucket for static-shape compilation: prompts are padded to the next
    # multiple so the jitted prefill/decode compiles once per bucket instead of once per
    # batch (generate.py, serving/engine.py). Must be a positive multiple of 8 (TPU lane
    # alignment; 64 keeps compile counts low for typical prompt spreads).
    prompt_bucket_multiple: int = 64
    # ---- serving KV memory model (serving/kv_cache.py, docs/SERVING.md) ----
    # paged KV pool (vLLM-style block tables with static shapes) vs the dense
    # [num_slots, max_len] slot pool; paged is the default and enables prefix caching
    # and chunked prefill
    paged_kv_cache: bool = True
    # tokens per KV page; must be a positive multiple of 8 (TPU lane alignment)
    kv_page_size: int = 16
    # physical pages in the pool (None = dense-parity capacity); set to the HBM budget
    # to oversubscribe slots — admission reserves worst-case pages, so decode never OOMs
    kv_num_pages: int | None = None
    # per-engine-step prefill token budget (chunked prefill): long prompts are computed
    # in chunks interleaved with decode steps; positive multiple of 8
    prefill_chunk_tokens: int = 512
    # paged-pool page storage format (serving/kv_cache.KV_DTYPES): "bf16" halves page
    # bytes vs fp32; "int8"/"fp8" store quantized pages + per-(page, kv-head) fp32
    # scales — ~2x sustainable slots again at fixed KV HBM, tolerance-level accuracy.
    # None keeps the model/cache dtype
    kv_dtype: str | None = None
    # share page-aligned resident prompt prefixes across requests (RadixAttention-style)
    prefix_caching: bool = True
    # ---- scheduling under contention (serving/scheduler.py, docs/SERVING.md) ----
    # priority tier stamped on every request this run submits: 0 is the top tier;
    # admission, the chunked-prefill budget, and preemption-victim selection are all
    # ordered tier-then-FCFS
    priority: int = 0
    # paged-KV preemption of lower-tier slots when a higher-tier request cannot admit
    # (or an oversubscribed pool runs physically dry): "off" never evicts; "swap" parks
    # the victim's pages in a host-memory pool (byte-identical restore); "recompute"
    # releases pages and rebuilds through the radix prefix cache. Resumed requests are
    # token-for-token identical to an unpreempted run
    preemption: str = "off"
    # admission may promise up to ratio * allocatable pages (>= 1.0): worst-case
    # reservations strand capacity, so oversubscribing admits more concurrent work;
    # ratio > 1 requires preemption != "off" (the shortfall must be reclaimable)
    oversubscribe_ratio: float = 1.0
    # multi-turn session retention window: a finished request with a session id pins
    # its prefix pages against LRU eviction until the session idles this long
    session_ttl_s: float = 300.0
    # ---- speculative decoding (serving/engine.py, docs/SERVING.md) ----
    # n-gram / prompt-lookup self-drafting: propose draft tokens by matching the slot's
    # recent suffix against its own prompt+generation history (no extra model; strongest
    # on repetitive workloads — code edits, summarization, RAG over the prompt)
    speculate_ngram: bool = False
    # draft-model checkpoint (dolomite-format path or hub id): a smaller supported model
    # drafts greedily for the target. Mutually exclusive with speculate_ngram; must share
    # the target's tokenizer/vocab
    draft_model: str | None = None
    # draft tokens proposed per engine step (K >= 1); the jitted verify step scores K+1
    # positions per slot and compiles once
    draft_k: int = 4
    # ---- distributed serving (serving/cluster/, docs/SERVING.md) ----
    # tensor-parallel size per engine replica: the engine's jitted prefill/decode/verify
    # programs run over a TP mesh with params and KV heads sharded (must divide the
    # visible device count; 1 = single-device engine)
    tensor_parallel_size: int = 1
    # engine replicas behind the telemetry-driven router (serving/cluster/router.py):
    # each owns its own KV pool and queue; prefix-affinity + least-loaded routing
    replicas: int = 1
    # prefill/decode disaggregation (serving/cluster/disagg.py): each replica becomes a
    # prefill worker feeding a decode worker through an explicit KV page handoff
    disaggregate: bool = False
    # ---- per-request distributed tracing (utils/tracing.py, docs/OBSERVABILITY.md) ----
    # every request carries a span tree (queue wait, admission, prefill chunks,
    # decode/verify, preemption park/resume, router placement, disaggregated handoff)
    # and emits one `trace` telemetry record at finish; tools/trace_export.py renders
    # Perfetto timelines, tools/trace_analyze.py the critical-path TTFT attribution.
    # Off by default and zero-cost when off (outputs, records, and compile counts are
    # byte-identical to an untraced run)
    trace_requests: bool = False

    def model_post_init(self, __context: Any) -> None:
        _check_not_None(
            [(self.batch_size, "batch_size"), (self.max_new_tokens, "max_new_tokens")]
        )
        if self.prompt_bucket_multiple <= 0 or self.prompt_bucket_multiple % 8 != 0:
            raise ValueError(
                f"prompt_bucket_multiple must be a positive multiple of 8, got "
                f"{self.prompt_bucket_multiple}"
            )
        if self.kv_page_size <= 0 or self.kv_page_size % 8 != 0:
            raise ValueError(
                f"kv_page_size must be a positive multiple of 8, got {self.kv_page_size}"
            )
        if self.prefill_chunk_tokens <= 0 or self.prefill_chunk_tokens % 8 != 0:
            raise ValueError(
                f"prefill_chunk_tokens must be a positive multiple of 8, got "
                f"{self.prefill_chunk_tokens}"
            )
        if self.kv_num_pages is not None and self.kv_num_pages < 2:
            raise ValueError(
                f"kv_num_pages must be >= 2 (page 0 is the trash page), got "
                f"{self.kv_num_pages}"
            )
        if self.kv_dtype is not None:
            from .serving.kv_cache import KV_DTYPES

            if self.kv_dtype not in KV_DTYPES:
                raise ValueError(
                    f"kv_dtype must be one of {sorted(KV_DTYPES)}, got {self.kv_dtype!r}"
                )
            if not self.paged_kv_cache:
                raise ValueError("kv_dtype requires paged_kv_cache=True")
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0 (0 is the top tier), got {self.priority}")
        if self.preemption not in ("off", "swap", "recompute"):
            raise ValueError(
                f"preemption must be 'off', 'swap', or 'recompute', got {self.preemption!r}"
            )
        if self.preemption != "off" and not self.paged_kv_cache:
            raise ValueError("preemption requires paged_kv_cache=True")
        if self.oversubscribe_ratio < 1.0:
            raise ValueError(
                f"oversubscribe_ratio must be >= 1.0, got {self.oversubscribe_ratio}"
            )
        if self.oversubscribe_ratio > 1.0 and self.preemption == "off":
            raise ValueError(
                "oversubscribe_ratio > 1.0 promises pages that are not physically "
                "backed; enable preemption ('swap' or 'recompute') to make that safe"
            )
        if self.session_ttl_s <= 0:
            raise ValueError(f"session_ttl_s must be positive, got {self.session_ttl_s}")
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if self.speculate_ngram and self.draft_model is not None:
            raise ValueError(
                "speculate_ngram and draft_model are mutually exclusive draft sources"
            )
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.tensor_parallel_size < 1:
            raise ValueError(
                f"tensor_parallel_size must be >= 1, got {self.tensor_parallel_size}"
            )
        if self.tensor_parallel_size > 1:
            import torch

            device_count = torch.cuda.device_count()
            if device_count % self.tensor_parallel_size != 0:
                raise ValueError(
                    f"tensor_parallel_size={self.tensor_parallel_size} does not divide "
                    f"the visible device count ({device_count})"
                )


class InferenceArgs(BaseArgs):
    # randomization related arguments
    random_args: RandomArgs = RandomArgs()
    # tokenizer related arguments
    tokenizer_args: TokenizerArgs = TokenizerArgs()
    # model related arguments
    model_args: ModelArgs | None = None
    # list of datasets to use
    datasets: list[DatasetArgs] = []
    # load related arguments
    load_args: LoadArgs | None = None
    # generation parameters
    generation_parameters: GenerationParameters = None
    # mixed precision related arguments
    mixed_precision_args: MixedPrecisionArgs = MixedPrecisionArgs()
    # logging related arguments
    logging_args: LoggingArgs = LoggingArgs()
    # per-op-family kernel backend selection (Pallas tier; docs/PERFORMANCE.md)
    kernel_args: KernelArgs = KernelArgs()
    # output dir
    output_dir: str = None

    def model_post_init(self, __context: Any) -> None:
        _check_not_None(
            [
                (self.datasets, "datasets"),
                (self.generation_parameters, "generation_parameters"),
                (self.output_dir, "output_dir"),
            ]
        )

        if self.load_args is None:
            assert self.model_args is not None, (
                "model_args need to be specified if load_args are not specified"
            )
        else:
            assert self.model_args is None, "model_args can't be specified with load_args"

        _check_datasets(self.datasets)


class UnshardingArgs(BaseArgs):
    # load related arguments
    load_args: LoadArgs = None
    # unsharded path
    unsharded_path: str = None
    # mixed precision related arguments
    mixed_precision_args: MixedPrecisionArgs = MixedPrecisionArgs()
    # logging related arguments
    logging_args: LoggingArgs = LoggingArgs()

    def model_post_init(self, __context: Any) -> None:
        _check_not_None([(self.load_args, "load_args"), (self.unsharded_path, "unsharded_path")])


_MODE_ARGS_MAP = {
    Mode.training: TrainingArgs,
    Mode.inference: InferenceArgs,
    Mode.unsharding: UnshardingArgs,
}


def args_from_dict(config: dict, mode: Mode):
    """Build the per-mode args tree from an already-loaded dict (checkpoint config snapshots)."""
    return _MODE_ARGS_MAP[mode](**config)


def get_args(mode: Mode = Mode.training, config_path: str | None = None):
    """Parse `--config path.yml` (or an explicit path) into the per-mode args tree."""
    if config_path is None:
        parser = ArgumentParser()
        parser.add_argument("--config", type=str, required=True, help="path for the config")
        config_path = parser.parse_args().config

    config: dict = load_yaml(config_path)
    args = args_from_dict(config, mode)

    set_logger(
        getattr(logging, args.logging_args.logging_level),
        colored_log=args.logging_args.use_colored_logs,
    )
    log_args(args)
    return args


@run_rank_n
def log_args(args) -> None:
    """Sorted pretty-print of the whole arg tree (reference `arguments.py:550-595`)."""

    def _iterate(node, prefix: str = "") -> list[str]:
        result = []
        if isinstance(node, BaseArgs):
            node = dict(node)
        p = len(prefix)
        for k, v in node.items():
            suffix = "." * max(48 - len(str(k)) - p, 3)
            if isinstance(v, (BaseArgs, dict)):
                if isinstance(v, dict) and len(v) == 0:
                    result.append(f"{prefix}{k} {suffix} {{}}")
                else:
                    sub = _iterate(v, prefix + " " * 4)
                    result.append(f"{prefix}{k}:\n" + "\n".join(sub))
            elif isinstance(v, list) and all(isinstance(x, (BaseArgs, dict)) for x in v):
                subs = ["\n".join(_iterate(x, prefix + " " * 4)) for x in v]
                sep = "\n" + " " * (p + 4) + "*" * (44 - p) + "\n"
                result.append(f"{prefix}{k}:\n" + sep.join(subs))
            else:
                result.append(f"{prefix}{k} {suffix} {v}")
        result.sort(key=lambda x: x.lower())
        return result

    log_rank_0(logging.INFO, "------------------------ arguments ------------------------")
    for line in _iterate(args):
        for sub_line in line.split("\n"):
            log_rank_0(logging.INFO, sub_line)
    log_rank_0(logging.INFO, "-------------------- end of arguments ---------------------")


def _check_datasets(datasets: list[DatasetArgs]) -> None:
    assert len(datasets) != 0, "datasets cannot be an empty list"
    assert len(datasets) == len({d.data_name for d in datasets}), (
        "data_name should be unique for each dataset"
    )


_DISTRIBUTION = "is not ported yet: ROADMAP.md Queue A, 'Distribution' (the port runs data parallelism only)"


def _check_model_name(model_name: str | None, field: str = "model_args.model_name") -> None:
    """A local checkpoint directory gives the config, tokenizer and (for generation) the
    weights; a hub id is not ported."""
    if model_name is not None and not os.path.isdir(model_name):
        raise NotImplementedError(f"{field} '{model_name}' (a hub id, not a local directory): {HUB_NOT_PORTED}")


def check_ported_options(args: TrainingArgs) -> None:
    """Refuse, naming its ROADMAP item, each option of `args` the port does not run."""
    dist = args.distributed_args
    for name in ("tensor_parallel_size", "context_parallel_size", "expert_parallel_size"):
        if getattr(dist, name) > 1:
            raise NotImplementedError(f"distributed_args.{name} {getattr(dist, name)} {_DISTRIBUTION}")
    for name in ("sequence_parallel", "tensor_parallel_word_embeddings"):
        if getattr(dist, name):
            raise NotImplementedError(f"distributed_args.{name} {_DISTRIBUTION}")
    _check_model_name(args.model_args.model_name)
    telemetry = args.logging_args.telemetry
    for name in ("on_demand_profiling", "program_signatures"):
        if getattr(telemetry, name):
            raise NotImplementedError(
                f"logging_args.telemetry.{name} is not ported yet: ROADMAP.md Queue A, "
                "'Serving fleet and observability'"
            )
    args.kernel_args.check()
    if args.model_args.scan_layers:
        log_rank_0(
            logging.INFO,
            "scan_layers: accepted; the port runs its blocks in a Python loop and keeps the "
            "unrolled layout the JAX checkpoints use",
        )


def check_ported_inference_options(args: InferenceArgs) -> None:
    """Refuse, naming its ROADMAP item, each generation option of `args` the port does not
    run."""
    gp = args.generation_parameters
    _check_model_name(gp.draft_model, "generation_parameters.draft_model")
    if gp.tensor_parallel_size > 1:
        raise NotImplementedError(
            f"generation_parameters.tensor_parallel_size {gp.tensor_parallel_size} is not ported "
            "yet: ROADMAP.md Queue A, 'Distribution' (the port serves from one device)"
        )
    if args.model_args is not None:
        _check_model_name(args.model_args.model_name)
    args.kernel_args.check()
