"""What FSDP2 at a world of one costs the train step: granite-3b-code's width at 8 layers.

Usage (a GPU machine, from the repository root): ``python scripts/fsdp_one_rank_probe.py``
(``--device cpu`` rehearses the control flow at a tiny width). Prints one JSON line a
measurement and, first, the card's name and power limit:

- ``step``: the dense train step (accumulation 2 x [1, 4096], AdamW with a bf16 first moment),
  unwrapped and through FSDP2 at ZeRO stage 3 on the process group of one rank, in turns
  (unwrapped, FSDP2, unwrapped, FSDP2), under the pretraining YAML's every-2 ``save_dots`` and
  under ``full`` remat of every block: each run's 4 step times and its device peak.
- ``end_of_run``: the finetuning step at accumulation 1 (its gradients stay allocated until the
  next step), then the calls that end a finetuning run, each with its device memory before and
  after and its peak: a loss under no_grad, `finetune.evaluate`, `checkpointing.save_checkpoint`;
  then, under FSDP2, an offloaded optimizer's second moments saved and restored into its pinned
  host state (``offloaded_moments_restored``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dolomite_engine_tpu_torch import finetune  # noqa: E402
from dolomite_engine_tpu_torch.arguments import DistributedArgs, TrainingArgs  # noqa: E402
from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_training, save_checkpoint  # noqa: E402
from dolomite_engine_tpu_torch.distributed import wrap_model_for_distributed_training  # noqa: E402
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, ModelWrapperForPretraining  # noqa: E402
from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler  # noqa: E402
from dolomite_engine_tpu_torch.parallel.mesh import MeshManager  # noqa: E402
from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step  # noqa: E402
from dolomite_engine_tpu_torch.utils import init_distributed  # noqa: E402

LAYERS = 8
POLICIES = ({"checkpoint_every": 2, "policy": "save_dots"}, {"checkpoint_every": 1, "policy": "full"})


def _gb(device, peak=False):
    if device.type != "cuda":
        return None
    return round((torch.cuda.max_memory_allocated() if peak else torch.cuda.memory_allocated()) / 1e9, 3)


def _reset(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _shard(wrapper):
    wrap_model_for_distributed_training(SimpleNamespace(distributed_args=DistributedArgs(stage=3)), wrapper)


def step_costs(device, config, seq):
    text = chip_smoke._packed_text(np.random.RandomState(0), 2, seq, config["vocab_size"], config["eos_token_id"])
    batch = {"text": torch.as_tensor(text).reshape(2, 1, -1).to(device)}
    for remat in POLICIES:
        for wrapped in (False, True, False, True):
            _reset(device)
            wrapper = ModelWrapperForPretraining(
                config, dtype="bf16", param_dtype="fp32", attention_implementation="flash_attention_2",
                gradient_checkpointing_args=remat, reset_attention_mask=True, reset_position_ids=True, device=device,
                seed=0,
            )
            if wrapped:
                _shard(wrapper)
            optimizer = get_optimizer(
                "TorchAdamW", chip_smoke.TRAIN_OPTIMIZER, get_scheduler(2, 0, None, 10, "cosine", 0.1, base_lr=3e-4),
                wrapper.model.named_parameters(),
            )
            state = TrainState(wrapper.model, optimizer)
            step = make_train_step(lambda m, w=wrapper: w.loss(m["text"]), optimizer, gradient_accumulation_steps=2)
            times = []
            for _ in range(4):
                t0 = time.perf_counter()
                metrics = step(state, batch)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            print(json.dumps({"step": {"policy": remat["policy"], "fsdp2_stage3": wrapped, "step_s": times,
                                       "peak_gb": _gb(device, peak=True), "loss": metrics["loss"]}}), flush=True)
            del wrapper, optimizer, state, step
            MeshManager.destroy()


def end_of_run(device, config, seq):
    rs = np.random.RandomState(0)
    ids = rs.randint(1, config["vocab_size"], (8, seq // 4))
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": np.where(rs.rand(*ids.shape) < 0.5, ids, -100)}
    work = tempfile.mkdtemp(prefix="fsdp-probe-")
    common = dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=config),
        tuning_args=dict(tuning_method="full_finetuning"),
        datasets=[dict(class_name="DebugDataset", data_name="d", class_args={"num_examples": 1})],
    )
    save = os.path.join(work, "save")
    for wrapped in (False, True):
        _reset(device)
        wrapper = ModelWrapperForFinetuning(
            config, dtype="bf16", attention_implementation="flash_attention_2",
            gradient_checkpointing_args={"checkpoint_every": 1, "policy": "full"}, device=device, seed=0,
        )
        if wrapped:
            _shard(wrapper)
        optimizer = get_optimizer("TorchAdamW", dict(lr=1e-5), get_scheduler(1, 0, None, 10, "cosine", 0.1, base_lr=1e-5), wrapper.model.named_parameters())
        state = TrainState(wrapper.model, optimizer)
        step = make_train_step(lambda m, w=wrapper: w.loss(m, train=True), optimizer)
        step_batch = {k: [torch.as_tensor(v, device=device)] for k, v in batch.items()}
        step(state, step_batch)
        args = TrainingArgs(**common, save_args=dict(save_path=save, save_interval=1, save_optimizer=False))
        record = {"fsdp2_stage3": wrapped, "after_step_gb": _gb(device)}

        def no_grad_loss(w=wrapper):
            with torch.no_grad():
                float(w.loss(batch, train=False))

        for name, call in (
            ("no_grad_loss", no_grad_loss),
            ("evaluate", lambda w=wrapper: finetune.evaluate([batch], w, 1, None)),
            ("save_checkpoint", lambda: save_checkpoint(args, wrapper.model, state, None, None, 1)),
        ):
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            before = _gb(device)
            call()
            record[name] = {"before_gb": before, "after_gb": _gb(device), "peak_gb": _gb(device, peak=True)}
        shutil.rmtree(save, ignore_errors=True)
        if wrapped:
            optimizer.offload_state()
            step(state, step_batch)
            want = [t.clone() for t in optimizer.state["nu"]]
            with_optimizer = dict(save_path=save, save_interval=1, save_optimizer=True)
            save_checkpoint(TrainingArgs(**common, save_args=with_optimizer), wrapper.model, state, None, None, 2)
            for t in optimizer.state["nu"]:
                t.zero_()
            load_checkpoint_for_training(TrainingArgs(**common, save_args=with_optimizer, load_args=dict(load_path=save)), state)
            record["offloaded_moments_restored"] = all(torch.equal(a, b) for a, b in zip(optimizer.state["nu"], want))
            record["offloaded_state_pinned"] = all(t.is_pinned() for t in optimizer.state["nu"]) if device.type == "cuda" else None
        print(json.dumps({"end_of_run": record}), flush=True)
        del wrapper, optimizer, state, step
        MeshManager.destroy()
    shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    device = torch.device(parser.parse_args().device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("fsdp_one_rank_probe: no CUDA device is available", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
        config, seq = dict(chip_smoke.TRAIN_CONFIG, n_layer=LAYERS), 4096
    else:
        config, seq = dict(chip_smoke.TRAIN_CONFIG, n_layer=LAYERS, n_embd=64, n_head=4, n_inner=128, vocab_size=512), 128
    init_distributed(None, device)
    step_costs(device, config, seq)
    end_of_run(device, config, seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
