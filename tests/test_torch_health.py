"""The port's training health statistics against the JAX package's, on the CPU.

- `per_group_health` over a params tree with a `transformer` and an `lm_head` group: the
  same group names and the same parameter norms, gradient norms and update ratios as JAX's
  within 1e-6 relative (fp32 sums reassociated).
- `make_train_step(collect_health=True)`: the update ratio it reports equals ``||p' - p||
  / ||p||`` from the parameters saved before and after the step (1e-6 relative); a skipped
  step reports 0; the step's losses and parameters are those of a step without health.
- `pretrain.main` with ``telemetry.health.interval`` writes a ``health`` record on every
  due step with the JAX loop's keys (the record's and its statistics').
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.utils.diagnostics import per_group_health as jax_per_group_health
from dolomite_engine_tpu_torch import pretrain
from dolomite_engine_tpu_torch.optimization import get_optimizer
from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step
from dolomite_engine_tpu_torch.utils.diagnostics import per_group_health


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's spinning thread pool,
    oversubscribed, slows these small steps and the workers running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NAMES = ["lm_head.weight", "transformer.h.0.attn.c_attn.weight", "transformer.ln_f.weight", "transformer.wte.weight"]
SHAPES = [(10, 6), (9, 6), (6,), (10, 6)]


def _tree(values):
    tree = {}
    for name, value in zip(NAMES, values):
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def test_per_group_health_matches_jax():
    rs = np.random.RandomState(0)
    params = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    new = [p - 1e-3 * g for p, g in zip(params, grads)]
    want = jax_per_group_health(*(_tree([jnp.asarray(v) for v in values]) for values in (params, grads, new)))
    got = per_group_health(*([torch.from_numpy(v) for v in values] for values in (params, grads, new)), names=NAMES)
    assert set(got) == set(want)
    for metric in want:
        assert list(got[metric]) == list(want[metric]) == ["lm_head", "transformer"]
        for group, value in want[metric].items():
            np.testing.assert_allclose(got[metric][group].item(), float(value), rtol=1e-6, err_msg=f"{metric}/{group}")


def _model():
    torch.manual_seed(0)
    return torch.nn.ModuleDict(
        {"transformer": torch.nn.Linear(6, 5), "lm_head": torch.nn.Linear(5, 3, bias=False)}
    )


def _loss(model, micro):
    return model["lm_head"](torch.tanh(model["transformer"](micro["x"]))).square().mean()


@pytest.mark.parametrize("health", [False, True])
def test_train_step_health_is_the_parameters_own_update(health):
    model = _model()
    opt = get_optimizer("TorchAdamW", {}, lambda step: 1e-2, model.named_parameters())
    step = make_train_step(lambda micro: _loss(model, micro), opt, gradient_accumulation_steps=2,
                           skip_nonfinite=True, collect_health=health)
    state = TrainState(model, opt)
    batch = {"x": torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(1))}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step(state, batch)
    reference = _model()
    ref_opt = get_optimizer("TorchAdamW", {}, lambda step: 1e-2, reference.named_parameters())
    ref_metrics = make_train_step(lambda micro: _loss(reference, micro), ref_opt, gradient_accumulation_steps=2)(
        TrainState(reference, ref_opt), batch
    )
    assert metrics["loss"] == ref_metrics["loss"]
    for (name, p), q in zip(model.named_parameters(), reference.parameters()):
        assert torch.equal(p, q), name
    if not health:
        assert "health" not in metrics
        return
    for group in ("lm_head", "transformer"):
        old = [before[n] for n in before if n.startswith(group)]
        new = [p.detach() for n, p in model.named_parameters() if n.startswith(group)]
        delta = torch.stack([(a - b).square().sum() for a, b in zip(new, old)]).sum().sqrt()
        norm = torch.stack([b.square().sum() for b in old]).sum().sqrt()
        np.testing.assert_allclose(metrics["health"]["update_ratio"][group].item(), (delta / norm).item(), rtol=1e-6)
        np.testing.assert_allclose(metrics["health"]["param_norm"][group].item(), norm.item(), rtol=1e-6)
    # a skipped step updates nothing: ratio 0
    skipped = step(state, {"x": batch["x"] * float("nan")})
    assert skipped["skipped"] == 1
    assert all(v.item() == 0.0 for v in skipped["health"]["update_ratio"].values())


def _jax_health_record(tmp_path):
    """One ``health`` record of the JAX loop (`tests/test_diagnostics.py`'s tiny run)."""
    from tests.test_diagnostics import _read_sink, _run_loop, _train_args

    args = _train_args(tmp_path, num_steps=2, health={"interval": 2})
    _run_loop(args)
    return [r for r in _read_sink(tmp_path / "ckpt" / "telemetry" / "rank-00000.jsonl") if r["kind"] == "health"][0]


def test_pretrain_writes_health_records_with_the_jax_keys(tmp_path):
    from tests.test_torch_pretrain import _training_args, _write_corpus

    prefix = _write_corpus(tmp_path)
    args = _training_args(tmp_path, prefix, num_steps=4, logging_args=dict(telemetry=dict(health=dict(interval=2))))
    summary = pretrain.main(args, device="cpu")
    sink = tmp_path / "ckpt" / "telemetry" / "rank-00000.jsonl"
    records = [json.loads(line) for line in sink.read_text().splitlines() if line.strip()]
    health = [r for r in records if r["kind"] == "health"]
    assert [r["step"] for r in health] == [2, 4] and len(summary["steps"]) == 4
    want = _jax_health_record(tmp_path / "jax")
    assert set(health[0]) == set(want)
    assert set(health[0]["stats"]) == set(want["stats"])
    for metric, groups in health[0]["stats"].items():
        assert list(groups) == ["transformer"]  # tied embeddings: one top-level group
        assert all(np.isfinite(v) and v > 0 for v in groups.values()), metric
