"""``cpu_offload`` on the CPU.

- On a CPU model the option warns and changes nothing, as the JAX package ignores it off
  the TPU: `pretrain.main`'s losses, grad norms and final parameters equal a run without
  it bit for bit.
- The offload path itself (`Optimizer.offload_state`), driven with its device side on the
  CPU (the host state then unpinned), over several parameter groups so that the next group's
  copy is queued before this group's update: parameters and state bit-identical to an
  unoffloaded optimizer's over 4 updates, and the offloaded state survives a checkpoint
  round trip (`torch.distributed.checkpoint`, as `save_checkpoint` writes it).
"""

import logging

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from dolomite_engine_tpu_torch import pretrain
from dolomite_engine_tpu_torch.optimization import get_optimizer, optimizer as optimizer_module
from dolomite_engine_tpu_torch.train_utils import TrainState
from tests.test_torch_pretrain import _curve, _training_args, _write_corpus


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's spinning thread pool,
    oversubscribed, slows these small steps and the workers running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cpu_model_warns_and_ignores_the_option(tmp_path, monkeypatch):
    from dolomite_engine_tpu_torch import train_utils

    monkeypatch.setattr(train_utils, "_CPU_OFFLOAD_WARNED", False)  # the warning comes once a process
    warnings = []
    # the port's logger may not propagate to pytest's handler: record the call itself
    monkeypatch.setattr(train_utils, "log_rank_0", lambda level, message: warnings.append((level, message)))
    prefix = _write_corpus(tmp_path)
    plain = pretrain.main(_training_args(tmp_path, prefix, save_path="plain"), device="cpu")
    offloaded = pretrain.main(
        _training_args(tmp_path, prefix, save_path="offload", distributed_args=dict(stage=0, cpu_offload=True)),
        device="cpu",
    )
    assert _curve(offloaded) == _curve(plain)
    assert [level for level, message in warnings if "cpu_offload ignored" in message] == [logging.WARNING]


def _params(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"transformer.wte.weight": (64, 16), "transformer.h.0.attn.c_attn.weight": (48, 16),
              "transformer.h.0.mlp.c_fc.weight": (32, 16), "transformer.ln_f.weight": (16,)}
    return {n: torch.nn.Parameter(torch.from_numpy(rs.randn(*s).astype(np.float32))) for n, s in shapes.items()}


@pytest.mark.parametrize("name, args", [("TorchAdamW", dict(mu_dtype="bf16")), ("ApexFusedLAMB", {}), ("TorchRMSprop", {})])
def test_offloaded_updates_are_bit_identical(tmp_path, monkeypatch, name, args):
    monkeypatch.setattr(optimizer_module, "_GROUP_BYTES", 4 * 48 * 16)  # a group per weight
    rs = np.random.RandomState(1)
    runs = []
    for offload in (False, True):
        params = _params()
        opt = get_optimizer(name, dict(args, lr=1e-2), lambda step: 1e-2 * (step + 1), list(params.items()))
        assert len(opt._groups) >= 3
        if offload:
            opt.offload_state()
            assert all(t.device.type == "cpu" for t in opt.state_tensors())
        rs = np.random.RandomState(1)
        for _ in range(4):
            opt.step([torch.from_numpy(rs.randn(*p.shape).astype(np.float32)) for p in params.values()])
        runs.append((params, opt))
    (plain, plain_opt), (params, opt) = runs
    for n in plain:
        assert torch.equal(plain[n], params[n]), n
    for a, b in zip(plain_opt.state_tensors(), opt.state_tensors()):
        assert torch.equal(a, b)
    assert opt.offload_bytes["h2d"] == opt.offload_bytes["d2h"] == 4 * sum(t.nbytes for t in opt.state_tensors())

    # the offloaded state through a checkpoint round trip
    model = torch.nn.Module()
    for n, p in params.items():
        model.register_parameter(n.replace(".", "_"), p)
    state = TrainState(model, opt)
    dcp.save(state.state_dict(), checkpoint_id=str(tmp_path / "state"), no_dist=True)
    fresh = get_optimizer(name, dict(args, lr=1e-2), lambda step: 1e-2, list(model.named_parameters()))
    fresh.offload_state()
    restored = TrainState(model, fresh)
    tree = restored.state_dict()
    dcp.load(tree, checkpoint_id=str(tmp_path / "state"), no_dist=True)
    restored.load_state_dict(tree)
    assert fresh.count == opt.count == 4
    for a, b in zip(fresh.state_tensors(), opt.state_tensors()):
        assert torch.equal(a, b)
