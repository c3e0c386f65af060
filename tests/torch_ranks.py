"""Runs the port's data-parallel path in spawned CPU processes (gloo), for the
`test_torch_distributed*.py` files.

`run_ranks(world, tmp_path, jobs)` starts `world` processes that join one gloo group
through a ``file://`` rendezvous in `tmp_path` (no TCP port, so parallel test workers
cannot collide), hold torch to one thread, run each ``(scenario, kwargs)`` of `jobs` in
order and return every rank's results: ``results[rank][i]`` is job i's. A job that
raises fails the call with the rank's traceback; a group that does not finish within
`timeout` seconds is killed and fails it too. This module imports no JAX, so the
processes start fast: the tests compute their JAX references in their own process.
"""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SMALL = dict(
    model_type="gpt_dolomite", vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4,
    attention_head_type="gqa", num_key_value_heads=2, position_embedding_type="rope",
    activation_function="swiglu", normalization_function="rmsnorm", add_bias=False, resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2, tie_word_embeddings=True,
    fused_lm_head_loss=True, loss_chunk_size=16,
)


def run_ranks(world: int, tmp_path, jobs: list[tuple[str, dict]], timeout: float = 400.0) -> list[list]:
    tmp_path = str(tmp_path)
    os.makedirs(tmp_path, exist_ok=True)
    tag = f"w{world}-{time.monotonic_ns()}"
    init_file = os.path.join(tmp_path, f"init-{tag}")
    out = os.path.join(tmp_path, f"out-{tag}")
    context = mp.start_processes(
        _worker, args=(world, init_file, out, jobs), nprocs=world, join=False, start_method="spawn"
    )
    deadline = time.monotonic() + timeout
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            raise TimeoutError(f"{world} ranks did not finish {[name for name, _ in jobs]} in {timeout} s")
    results = []
    for rank in range(world):
        with open(f"{out}-{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _worker(rank: int, world: int, init_file: str, out: str, jobs) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world, timeout=timedelta(seconds=300)
    )
    from dolomite_engine_tpu_torch.parallel.mesh import MeshManager

    results = []
    try:
        for name, kwargs in jobs:
            results.append(SCENARIOS[name](rank, world, **kwargs))
            MeshManager.destroy()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{out}-{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


# ------------------------------------------------------------------------------ helpers


def dist_args(stage: int, topology: tuple[int, int] | None = None, **kwargs):
    from dolomite_engine_tpu_torch.arguments import DistributedArgs

    if topology is not None:
        kwargs["zero_topology"] = dict(
            data_parallel_replication_world_size=topology[0], data_parallel_sharding_world_size=topology[1]
        )
    return SimpleNamespace(distributed_args=DistributedArgs(stage=stage, **kwargs))


def rows(array: np.ndarray, rank: int, world: int, axis: int = -2) -> np.ndarray:
    """Rank `rank`'s rows of a global batch (JAX's device `rank` of a `world`-way fsdp axis)."""
    per = array.shape[axis] // world
    return np.take(array, np.arange(rank * per, (rank + 1) * per), axis=axis)


def wrapped(config: dict, stage: int, params=None, topology=None, dtype: str = "fp32", finetuning: bool = False):
    """The wrapper with `params` (a JAX tree) or seed-0 weights, sharded by the real wrap."""
    from dolomite_engine_tpu_torch.distributed import wrap_model_for_distributed_training
    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.models import load_jax_params

    if finetuning:
        model = ModelWrapperForFinetuning(config, dtype=dtype, device="cpu", seed=0)
    else:
        model = ModelWrapperForPretraining(
            config, dtype=dtype, device="cpu", seed=0, reset_attention_mask=True, reset_position_ids=True
        )
    if params is not None:
        load_jax_params(model.model, params, device="cpu")
    wrap_model_for_distributed_training(dist_args(stage, topology), model)
    return model


def full_params(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """Every parameter gathered whole (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in module.named_parameters():
        value = p.full_tensor() if isinstance(p, DTensor) else p
        out[name] = value.detach().float().numpy().copy()
    return out


def full_grads(module: torch.nn.Module) -> dict[str, np.ndarray]:
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in module.named_parameters():
        g = p.grad
        value = g.full_tensor() if isinstance(g, DTensor) else g
        out[name] = value.detach().float().numpy().copy()
    return out


# ------------------------------------------------------------------------------ scenarios


def mesh_accessors(rank, world, topologies):
    from dolomite_engine_tpu_torch.parallel.mesh import MeshManager

    out = {}
    for topology in topologies:
        try:
            MeshManager(
                data_parallel_replication_world_size=topology and topology[0],
                data_parallel_sharding_world_size=topology and topology[1],
                device_type="cpu",
            )
        except ValueError as error:
            out[topology] = f"ValueError: {error}"
            continue
        mesh = MeshManager.get_mesh()
        out[topology] = dict(
            shape=tuple(mesh.shape), names=mesh.mesh_dim_names, dp=MeshManager.axis_size("dp"),
            fsdp=MeshManager.axis_size("fsdp"), data_parallel=MeshManager.get_data_parallel_world_size(),
            tp=MeshManager.get_tensor_parallel_world_size(), sp=MeshManager.get_sequence_parallel_world_size(),
            ep=MeshManager.get_expert_parallel_world_size(), replicated=tuple(MeshManager.replicated_mesh().shape),
            initialized=MeshManager.is_initialized(), rank=MeshManager.get_global_rank(),
        )
        MeshManager.destroy()
        out[topology]["after_destroy"] = MeshManager.is_initialized()
    return out


def stage_layout(rank, world, stage):
    """Where a block's and the root's parameters are whole: at rest, between the forward
    and the backward, and after the backward."""
    from torch.distributed.tensor import DTensor

    from dolomite_engine_tpu_torch.parallel.sharding import local

    model = wrapped(SMALL, stage)
    block = model.model.transformer.h[0].mlp.c_fc
    wte = model.model.transformer.wte

    def state():
        weight, table = block.weight, wte.weight
        return dict(
            block_dtensor=isinstance(weight, DTensor), block_local=tuple(local(weight).shape),
            root_dtensor=isinstance(table, DTensor), root_local=tuple(local(table).shape),
        )

    text = torch.from_numpy(np.random.RandomState(0).randint(3, 64, (2, 17)))
    at_rest = state()
    loss = model.loss(text)
    after_forward = state()
    loss.backward()
    after_backward = state()
    grad = block.weight.grad
    return dict(
        at_rest=at_rest, after_forward=after_forward, after_backward=after_backward,
        global_shape=tuple(block.weight.shape), grad_local=tuple(local(grad).shape),
    )


def train_steps(rank, world, stage, batches, params=None, config=SMALL, topology=None, accum=None,
                optimizer="TorchAdamW", optimizer_args=None, schedule=(2, 0, None, 10, "cosine", 0.1, 3e-3),
                dtype="fp32", health=False, gather=True):
    """`batches` [steps, accum, B, S + 1] global; this rank trains on its rows. Returns the
    metrics, the gathered parameters, an fp8 run's state and the health statistics."""
    from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
    from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step

    model = wrapped(config, stage, params, topology, dtype=dtype)
    warmup, constant, decay, total, style, factor, lr = schedule
    opt = get_optimizer(
        optimizer, dict(optimizer_args or dict(lr=lr, betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1)),
        get_scheduler(warmup, constant, decay, total, style, factor, base_lr=lr), model.model.named_parameters(),
    )
    state = TrainState(model.model, opt, fp8=model.fp8)
    step = make_train_step(
        lambda micro: model.loss(micro["text"]), opt, gradient_accumulation_steps=accum or batches.shape[1],
        gradient_clipping=1.0, skip_nonfinite=True, collect_health=health,
    )
    metrics = []
    for t in range(batches.shape[0]):
        m = step(state, {"text": torch.from_numpy(rows(batches[t], rank, world))})
        if health:
            m["health"] = {kind: {k: float(v) for k, v in by_group.items()} for kind, by_group in m["health"].items()}
        metrics.append(m)
    out = dict(metrics=metrics, count=opt.count)
    if gather:
        out["params"] = full_params(model.model)
    if model.fp8 is not None:
        out["fp8"] = {k: v.numpy().copy() for k, v in model.fp8.tensors.items()}
    return out


def optimizers(rank, world, names, batches, stage=3):
    """Each optimizer name for 2 steps: the losses and the gathered parameters, or the
    error it raised."""
    out = {}
    for name in names:
        try:
            out[name] = train_steps(
                rank, world, stage, batches, optimizer=name, optimizer_args=dict(lr=1e-2),
                schedule=(0, 0, None, 10, "constant", 0.0, 1e-2),
            )
        except Exception as error:  # both worlds must raise the same
            out[name] = f"{type(error).__name__}: {error}"
    return out


def finetuning_loss(rank, world, examples, padding_free, stage=3):
    """The finetuning loss and its gradients over this rank's examples of the global
    batch (each rank collates its own), summed and gathered."""
    from dolomite_engine_tpu_torch.data.utils import collate_fn
    from dolomite_engine_tpu_torch.enums import LossMask, Mode

    model = wrapped(SMALL, stage, finetuning=True)
    per = len(examples) // world
    batch = collate_fn(
        examples[rank * per : (rank + 1) * per], mode=Mode.training, loss_mask=LossMask.output_only,
        eos_token_id=1, is_encoder_decoder=False, use_padding_free_transformer=padding_free,
    )
    loss = model.loss(batch)
    loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total)
    return dict(loss=float(total), local_loss=float(loss), grads=full_grads(model.model))


def megatron_rows(rank, world, args_config, consumed, steps):
    """This rank's megatron train and val rows for `steps` micro-batches, and the index
    cache files this rank wrote (``np.save`` counted)."""
    from dolomite_engine_tpu_torch.arguments import TrainingArgs
    from dolomite_engine_tpu_torch.data.megatron import get_megatron_gpt_dataloaders

    saved, save = [], np.save

    def counting(file, *args, **kwargs):
        saved.append(os.path.basename(str(file)))
        return save(file, *args, **kwargs)

    np.save = counting
    try:
        train, val, _ = get_megatron_gpt_dataloaders(TrainingArgs(**args_config), None, consumed)
    finally:
        np.save = save
    return dict(
        train=[next(train)["text"].numpy() for _ in range(steps)], val=[next(val[0])["text"].numpy()], saved=saved
    )


def finetuning_loader(rank, world, args_config, steps, tokenizer_path):
    from transformers import AutoTokenizer

    from dolomite_engine_tpu_torch.arguments import TrainingArgs
    from dolomite_engine_tpu_torch.data import get_dataloader
    from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode

    tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)
    loader = get_dataloader(TrainingArgs(**args_config), DatasetSplit.train, Mode.training, tokenizer)
    it = iter(loader)
    batches = []
    for _ in range(steps):
        batch = next(it)
        batches.append({k: None if v is None else np.asarray(v) for k, v in batch.items()})
    return dict(kind=type(loader).__name__, length=len(loader), batches=batches, state=loader.state_dict())


class _FakeLoader:
    """Three [8, 6] int32 batches with a None key (JAX's `tests/data/test_multihost.py`)."""

    def __init__(self, kind="plain", n=3):
        self.kind, self.n = kind, n

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if self.kind == "float64":
                yield {"weights": np.ones((8, 6), np.float64)}
            elif self.kind == "int64":
                yield {"ids": np.arange(48, dtype=np.int64).reshape(8, 6) + i}
            elif self.kind == "overflow":
                yield {"ids": np.full((8, 6), 2**40, np.int64)}
            elif self.kind == "deep":
                yield {"deep": np.ones((4, 1, 1, 1, 1, 1, 2), np.int32)}
            else:
                yield {
                    "input_ids": np.full((8, 6), i, np.int32), "labels": np.full((8, 6), 100 + i, np.int32),
                    "mask": np.arange(8 * 6).reshape(8, 6) % 3 == 0, "position_ids": None,
                }

    def state_dict(self):
        return {"cursor": 7}

    def load_state_dict(self, state):
        self.loaded = state


def dispatching(rank, world, kind):
    """Rank 0 owns a `_FakeLoader` of `kind`; every rank iterates the dispatching loader.
    Returns the length seen before the first batch, the batches (each array with its
    dtype) and the state."""
    from dolomite_engine_tpu_torch.data.dataloader import DispatchingDataLoader

    loader = DispatchingDataLoader(_FakeLoader(kind) if rank == 0 else None)
    length = len(loader)
    batches = [{k: None if v is None else (v.numpy().copy(), str(v.dtype)) for k, v in b.items()} for b in loader]
    return dict(length=length, batches=batches, state=loader.state_dict())


def _training_args(config):
    """`config`: a YAML's path (read as the entry point's ``--config``) or a dict."""
    from dolomite_engine_tpu_torch.arguments import TrainingArgs, get_args
    from dolomite_engine_tpu_torch.enums import Mode

    return get_args(Mode.training, config) if isinstance(config, str) else TrainingArgs(**config)


def pretrain_main(rank, world, config, params=None):
    """`pretrain.main` on the CPU from `config` (`_training_args`), optionally from JAX's
    initial weights; returns its summary."""
    from dolomite_engine_tpu_torch import pretrain
    from dolomite_engine_tpu_torch.models import load_jax_params

    if params is not None:
        get_model = pretrain.get_model

        def with_params(*args, **kwargs):
            model = get_model(*args, **kwargs)
            load_jax_params(model.model, params, device="cpu")
            return model

        pretrain.get_model = with_params
    try:
        summary = pretrain.main(_training_args(config), device="cpu")
    finally:
        if params is not None:
            pretrain.get_model = get_model
    return summary


def pretrain_preempted(rank, world, config, notified_rank, at_step):
    """`pretrain.main` where only `notified_rank` receives a preemption notice, during step
    `at_step`; returns the summary."""
    from dolomite_engine_tpu_torch import pretrain

    calls = {"n": 0}

    def notice():
        calls["n"] += 1
        return rank == notified_rank and calls["n"] >= at_step

    requested = pretrain.preemption_requested
    pretrain.preemption_requested = notice
    try:
        return pretrain.main(_training_args(config), device="cpu")
    finally:
        pretrain.preemption_requested = requested


def finetune_main(rank, world, config):
    from dolomite_engine_tpu_torch import finetune

    return finetune.main(_training_args(config), device="cpu")


def checkpoint_weights(rank, world, config, stage=3):
    """The weights and optimizer moments of the checkpoint `config` loads, restored into a
    wrapped model of this world (the training restore), and the model alone into a plain,
    unwrapped one (the inference restore)."""
    from dolomite_engine_tpu_torch.arguments import TrainingArgs
    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_inference, load_checkpoint_for_training
    from dolomite_engine_tpu_torch.enums import Mode
    from dolomite_engine_tpu_torch.model_wrapper import get_model
    from dolomite_engine_tpu_torch.optimization import build_optimizer_from_args
    from dolomite_engine_tpu_torch.train_utils import TrainState
    from dolomite_engine_tpu_torch.utils import init_distributed

    args = TrainingArgs(**config)
    init_distributed(None, "cpu")
    model = get_model(args, Mode.training, device="cpu")
    from dolomite_engine_tpu_torch.distributed import wrap_model_for_distributed_training

    wrap_model_for_distributed_training(args, model)
    optimizer, _ = build_optimizer_from_args(args, model)
    state = TrainState(model.model, optimizer)
    state, step, metadata, _ = load_checkpoint_for_training(args, state)
    weights = full_params(model.model)
    from torch.distributed.tensor import DTensor

    names = [n for n, p in model.model.named_parameters()]
    mu = {}
    for name, p, m in zip(names, optimizer.params, optimizer.state["mu"]):
        whole = DTensor.from_local(m, p.device_mesh, p.placements, run_check=False, shape=p.shape, stride=p.stride()).full_tensor() if isinstance(p, DTensor) else m
        mu[name] = whole.float().numpy().copy()
    inference_args = SimpleNamespace(load_args=args.load_args, fault_tolerance_args=args.fault_tolerance_args)
    plain, _ = load_checkpoint_for_inference(inference_args, Mode.inference, device="cpu")
    plain_weights = {n: p.detach().float().numpy().copy() for n, p in plain.model.named_parameters()}
    return dict(weights=weights, mu=mu, step=step, metadata=metadata, plain=plain_weights)


SCENARIOS = {
    f.__name__: f
    for f in (
        mesh_accessors, stage_layout, train_steps, optimizers, finetuning_loss, megatron_rows, finetuning_loader,
        dispatching, pretrain_main, pretrain_preempted, finetune_main, checkpoint_weights,
    )
}
