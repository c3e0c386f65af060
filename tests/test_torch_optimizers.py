"""The port's optimizer registry against the JAX package's (optax), on the CPU.

- Every one of the 23 reference names through both `get_optimizer`s over the same fp32
  parameters and gradients for 5 updates, with a cosine schedule (2 warm-up steps) and
  with µP groups: parameters within 1e-6 relative (+1e-7 absolute for values near 0; fp32
  reassociated). ``TorchLBFGS`` raises ValueError on both sides; ``TorchRprop`` raises
  TypeError on both, as optax's ``rprop`` takes a float learning rate only, and its update
  is held against ``optax.rprop`` with a float one.
- A state_dict round trip after 2 of 5 updates gives the unbroken run's parameters bit for
  bit, for every name.
- `pretrain.main` saves and resumes non-AdamW optimizers (novograd's per-tensor second
  moment among them) bit for bit.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.enums import ParamsGroupMethod as JaxGroups
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.optimization.optimizer import _OPTIMIZER_FACTORIES
from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.optimization.optimizer import OPTIMIZER_CLASSES, Rprop


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's spinning thread pool,
    oversubscribed, slows these small steps and the workers running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# a params tree shaped like a model's: µP puts attn / mlp non-bias weights in its group
SHAPES = {
    "transformer.wte.weight": (11, 6),
    "transformer.h.0.attn.c_attn.weight": (9, 6),
    "transformer.h.0.attn.c_attn.bias": (9,),
    "transformer.h.0.mlp.c_fc.weight": (8, 6),
    "transformer.h.0.ln_1.weight": (6,),
}
ARGS = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, momentum=0.9)
STEPS = 5
NAMES = sorted(OPTIMIZER_CLASSES)


def _jax_tree(values: dict) -> dict:
    tree: dict = {}
    for name, value in values.items():
        *parents, leaf = name.replace("h.0", "h_0").split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _data(seed=0):
    rs = np.random.RandomState(seed)
    params = {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()} for _ in range(STEPS)]
    grads[2]["transformer.h.0.ln_1.weight"][:] = 0.0  # a zero gradient (trust ratio, rprop sign)
    return params, grads


def _schedules():
    return (
        jax_get_scheduler(2, 0, None, 8, JaxSchedule.cosine, 0.1, base_lr=ARGS["lr"]),
        get_scheduler(2, 0, None, 8, "cosine", 0.1, base_lr=ARGS["lr"]),
    )


def _port(name, params, schedule, mup):
    tensors = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in params.items()}
    config = SimpleNamespace(init_method="mup", m_width=4.0)
    opt = get_optimizer(
        name, ARGS, schedule, list(tensors.items()), params_group_method="mup" if mup else None, model_config=config
    )
    return tensors, opt


def test_registry_holds_the_jax_names():
    assert set(OPTIMIZER_CLASSES) == set(_OPTIMIZER_FACTORIES) and len(NAMES) == 23


@pytest.mark.parametrize("mup", [False, True], ids=["plain", "mup"])
@pytest.mark.parametrize("name", NAMES)
def test_five_updates_match_optax(name, mup):
    params, grads = _data()
    jax_schedule, schedule = _schedules()
    config = SimpleNamespace(init_method="mup", m_width=4.0)
    tree = _jax_tree({n: jnp.asarray(v) for n, v in params.items()})
    jax_kwargs = dict(params_group_method=JaxGroups.mup, model_config=config, params=tree) if mup else {}
    if name in ("TorchLBFGS", "TorchRprop"):
        error = ValueError if name == "TorchLBFGS" else TypeError
        with pytest.raises(error):
            tx = jax_get_optimizer(name, ARGS, jax_schedule, **jax_kwargs)
            tx.init(tree)
        with pytest.raises(error):
            _port(name, params, schedule, mup)
        return
    tx = jax_get_optimizer(name, ARGS, jax_schedule, **jax_kwargs)
    state = tx.init(tree)
    tensors, opt = _port(name, params, schedule, mup)
    for step_grads in grads:
        updates, state = tx.update(_jax_tree({n: jnp.asarray(g) for n, g in step_grads.items()}), state, tree)
        tree = optax.apply_updates(tree, updates)
        opt.step([torch.from_numpy(step_grads[n]) for n in tensors])
    flat = {".".join(str(p.key) for p in path).replace("h_0", "h.0"): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for n, tensor in tensors.items():
        np.testing.assert_allclose(tensor.detach().numpy(), flat[n], rtol=1e-6, atol=1e-7, err_msg=n)
    assert opt.count == opt.schedule_count == STEPS


def test_rprop_matches_optax_with_a_float_learning_rate():
    params, grads = _data(1)
    tree = _jax_tree({n: jnp.asarray(v) for n, v in params.items()})
    tx = optax.rprop(1e-2)
    state = tx.init(tree)
    tensors = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    opt = Rprop(list(tensors.values()), 1e-2)
    for step_grads in grads:
        updates, state = tx.update(_jax_tree({n: jnp.asarray(g) for n, g in step_grads.items()}), state, tree)
        tree = optax.apply_updates(tree, updates)
        opt.step([torch.from_numpy(step_grads[n]) for n in tensors])
    flat = {".".join(str(p.key) for p in path).replace("h_0", "h.0"): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for n, tensor in tensors.items():
        np.testing.assert_allclose(tensor.numpy(), flat[n], rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("name", [n for n in NAMES if n not in ("TorchLBFGS", "TorchRprop")])
def test_state_dict_round_trip_mid_run_is_bit_identical(name):
    params, grads = _data(2)
    _, schedule = _schedules()
    tensors, opt = _port(name, params, schedule, mup=False)
    for step_grads in grads:
        opt.step([torch.from_numpy(step_grads[n]) for n in tensors])
    unbroken = {n: t.detach().clone() for n, t in tensors.items()}

    tensors, opt = _port(name, params, schedule, mup=False)
    for step_grads in grads[:2]:
        opt.step([torch.from_numpy(step_grads[n]) for n in tensors])
    saved = {key: [t.clone() for t in value] if isinstance(value, list) else value for key, value in opt.state_dict().items()}
    resumed_tensors = {n: torch.nn.Parameter(t.detach().clone()) for n, t in tensors.items()}
    resumed = get_optimizer(name, ARGS, schedule, list(resumed_tensors.items()))
    resumed.load_state_dict(saved)
    for step_grads in grads[2:]:
        resumed.step([torch.from_numpy(step_grads[n]) for n in resumed_tensors])
    for n, t in resumed_tensors.items():
        assert torch.equal(t.detach(), unbroken[n]), n


@pytest.mark.parametrize("name", ["ApexFusedNovoGrad", "TorchRMSprop"])
def test_pretrain_resumes_a_non_adamw_optimizer(tmp_path, name):
    from tests.test_torch_pretrain import _curve, _training_args, _write_corpus

    from dolomite_engine_tpu_torch import pretrain

    prefix = _write_corpus(tmp_path)
    optimizer_args = {"optimizer_args": dict(class_name=name, class_args=dict(lr=1e-3))}
    unbroken = pretrain.main(_training_args(tmp_path, prefix, num_steps=4, save_path="a", **optimizer_args), device="cpu")
    pretrain.main(_training_args(tmp_path, prefix, num_steps=2, save_path="b", **optimizer_args), device="cpu")
    resumed = pretrain.main(
        _training_args(tmp_path, prefix, num_steps=4, save_path="b", load_args=dict(load_path=str(tmp_path / "b")), **optimizer_args),
        device="cpu",
    )
    assert _curve(resumed) == _curve(unbroken)[2:]
