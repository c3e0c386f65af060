"""The port's data-parallel layer against the JAX package's, on the CPU over gloo.

- **Repair**: `generate.main` from a local ``model_name`` without ``load_args`` reads that
  directory's weights, as the JAX package does; a directory without them is refused.
- **Mesh**: `mesh_sizes` against JAX's `MeshManager` over 1, 2, 4 and 8 of the virtual
  CPU devices under each ``zero_topology`` (the same axis sizes, the same ValueErrors);
  the built `MeshManager` and its accessors at 1 and 2 ranks; the ``data_parallel_size``
  assertion and its message, as JAX's.
- **Stage semantics**: which parameters are sharded at rest and which stay whole from the
  forward to the backward, at each stage (JAX keeps a stage 1-2 model replicated at rest:
  ROADMAP.md Queue C).
- **The step**: `make_train_step` at 2 ranks, stages 0, 1 and 3 and a 1 x 2 HSDP mesh,
  accumulation 2, packed documents (so the ranks' label counts differ), the fused LM-head
  loss, clipping, AdamW: 3 steps from JAX's initial weights against the port's 1-rank
  step on the global batch and JAX's step on a 2-device ``fsdp`` mesh: losses and grad
  norms within 1e-5 relative (the fp32 sums reassociate), parameters within 1e-5
  absolute (about lr x 2^-8: Adam divides by sqrt(v), which turns a last-bit difference
  in the summed gradient of an element whose gradient is near zero into a larger step).
  Two runs that shard alike (stages 1 and 3; stage 0 and the 2 x 1 replicated mesh) are
  bit-identical; stage 0 against stage 3 within 1e-6, since the grad norm sums two
  shards' squares where stage 0 sums whole tensors'. The MoE family at stage 3 likewise
  (its router statistics over the global batch).
- **The 23 optimizer names** at 2 ranks (stage 3) against 1 rank: the same losses (1e-5
  relative) and parameters (1e-5 absolute, 1e-4 of the largest step: rmsprop's first
  update is lr x g / sqrt(0.01 g^2) = 10 lr), the same errors (lbfgs, rprop's schedule).
- **fp8**: after a step at accumulation 2 the delayed-scaling state (amax histories and
  scales) is bit-identical on both ranks and equal to the 1-rank run's.
- **Health statistics**: equal at 1 and 2 ranks within 1e-5.

Each world's jobs run in one spawn (`tests/torch_ranks.py`), shared by the module.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.distributed import create_sharded_train_state
from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxWrapper
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.parallel.mesh import MeshManager as JaxMeshManager
from dolomite_engine_tpu.parallel.mesh import named_sharding
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu_torch import generate
from dolomite_engine_tpu_torch.arguments import InferenceArgs, TrainingArgs
from dolomite_engine_tpu_torch.optimization.optimizer import OPTIMIZER_CLASSES
from dolomite_engine_tpu_torch.parallel.mesh import mesh_sizes
from tests.torch_ranks import SMALL, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "LOSS_PARITY.json")) as f:
    DENSE = dict(json.load(f)["config"], fused_lm_head_loss=True, loss_chunk_size=16, z_loss_coef=1e-4)
with open(os.path.join(REPO, "LOSS_PARITY_moe_dolomite.json")) as f:
    MOE = dict(json.load(f)["config"], fused_lm_head_loss=True, loss_chunk_size=16)
SEQ, STEPS, ACCUM, BATCH = 40, 3, 2, 4
ADAM = dict(betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1)
SCHEDULE = (2, 0, None, 10, "cosine", 0.1, 3e-3)
OPTIMIZERS = sorted(OPTIMIZER_CLASSES)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _packed_batches(seed, config, steps=STEPS, accum=ACCUM, batch=BATCH, seq=SEQ):
    """[steps, accum, B, seq + 1] tokens with EOS (id 1) every 5-20 tokens."""
    rs = np.random.RandomState(seed)
    text = rs.randint(3, config["vocab_size"], (steps, accum, batch, seq + 1))
    for row in text.reshape(-1, seq + 1):
        pos = rs.randint(4, 15)
        while pos < seq:
            row[pos] = config["eos_token_id"]
            pos += rs.randint(5, 20)
    return text


def _flat_jax_params(params):
    """{port parameter name: numpy array} of a JAX params tree (kernels transposed)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1]).replace("h_", "h.")
        value = np.asarray(leaf)
        if keys[-1] == "kernel" and value.ndim == 2:
            value = value.T
        out[f"{name}.weight" if keys[-1] in ("kernel", "embedding", "weight") else f"{name}.{keys[-1]}"] = value
    return out


def _jax_sharded_run(config, batches):
    """JAX's sharded step on a 2-device fsdp mesh (`tests/parallel/test_sharding.py`'s
    build): the initial weights, the losses and grad norms, the final parameters."""
    JaxMeshManager.destroy()
    JaxMeshManager(devices=jax.devices()[:2])
    try:
        mesh = JaxMeshManager.get_mesh()
        wrapper = JaxWrapper(
            mode=JaxMode.training, pretrained_config=config, dtype="fp32", sequence_length=SEQ,
            reset_attention_mask=True, reset_position_ids=True, zero_stage=3,
            attention_implementation=JaxImpl.flash_attention_2,
        )
        warmup, constant, decay, total, style, factor, lr = SCHEDULE
        tx = jax_get_optimizer(
            "TorchAdamW", dict(ADAM), jax_get_scheduler(warmup, constant, decay, total, JaxSchedule(style), factor, base_lr=lr)
        )
        state, _ = create_sharded_train_state(wrapper, tx, mesh, jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, state.params)
        step = jax.jit(
            jax_make_train_step(
                lambda p, micro, rng: wrapper.loss(p, micro["text"], train=True), tx,
                gradient_accumulation_steps=ACCUM, gradient_clipping=1.0, skip_nonfinite=True,
            )
        )
        losses, norms = [], []
        with mesh:
            for t in range(STEPS):
                batch = {"text": jax.device_put(jnp.asarray(batches[t]), named_sharding(None, ("dp", "fsdp")))}
                state, metrics = step(state, batch, jax.random.PRNGKey(t))
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        final = _flat_jax_params(state.params)
    finally:
        JaxMeshManager.destroy()
    return dict(params=params, losses=losses, norms=norms, final=final)


TOPOLOGIES = [None, (1, 2), (2, 1), (3, 1)]
STEPS_STAGES = (1, 3)  # at 2 ranks, beside the stage-0 run every world makes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's references, then every job of this file at 1 and at 2 ranks."""
    tmp = tmp_path_factory.mktemp("ranks")
    dense_batches, moe_batches = _packed_batches(0, DENSE), _packed_batches(1, MOE)
    jax_dense, jax_moe = _jax_sharded_run(DENSE, dense_batches), _jax_sharded_run(MOE, moe_batches)
    small = _packed_batches(2, SMALL, steps=2, accum=1, seq=16)
    fp8_batches = _packed_batches(3, SMALL, steps=1, accum=2, seq=16)

    def step_job(stage, config, params, batches, **kwargs):
        return ("train_steps", dict(stage=stage, config=config, params=params, batches=batches, schedule=SCHEDULE, **kwargs))

    common = [
        ("mesh_accessors", dict(topologies=TOPOLOGIES)),
        ("optimizers", dict(names=OPTIMIZERS, batches=small)),
        ("train_steps", dict(stage=3, batches=fp8_batches, dtype="fp8", gather=False)),
        ("train_steps", dict(stage=3, batches=small, health=True, gather=False)),
        step_job(0, DENSE, jax_dense["params"], dense_batches),
        step_job(3, MOE, jax_moe["params"], moe_batches),
    ]
    two = common + [step_job(stage, DENSE, jax_dense["params"], dense_batches) for stage in STEPS_STAGES] + [
        step_job(3, DENSE, jax_dense["params"], dense_batches, topology=(1, 2)),
        step_job(1, DENSE, jax_dense["params"], dense_batches, topology=(2, 1)),
    ] + [("stage_layout", dict(stage=stage)) for stage in range(4)]
    one = run_ranks(1, tmp / "one", common)[0]
    ranks = run_ranks(2, tmp / "two", two)
    names = ["mesh", "optimizers", "fp8", "health", "dense", "moe"]
    out = {"jax_dense": jax_dense, "jax_moe": jax_moe, "one": dict(zip(names, one)), "ranks": ranks}
    two_names = names + [f"dense_stage{s}" for s in STEPS_STAGES] + ["dense_hsdp_1x2", "dense_hsdp_2x1"] + [
        f"layout{s}" for s in range(4)
    ]
    out["two"] = [dict(zip(two_names, r)) for r in ranks]
    return out


# ------------------------------------------------------------------------------ repair


def test_generation_from_model_name_without_load_args_is_refused(tmp_path):
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(SMALL))
    args = InferenceArgs(
        datasets=[dict(class_name="JSONLinesDataset", data_name="p", class_args={"data_path": str(tmp_path)})],
        generation_parameters=dict(batch_size=1, max_new_tokens=2),
        output_dir=str(tmp_path / "out"),
        model_args=dict(model_class="AutoModelForCausalLM", model_name=str(model_dir)),
    )
    # the directory's weights are read now; one without them is refused (JAX's reader
    # finds no tensor there either)
    with pytest.raises(ValueError, match="holds no safetensors weights"):
        generate.main(args, device="cpu")


# ------------------------------------------------------------------------------ mesh


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("topology", [None, (1, "w"), ("w", 1), (2, "w/2"), (3, 1)], ids=str)
def test_mesh_sizes_match_jax(world, topology, eight_devices):
    resolve = {"w": world, "w/2": world // 2}
    replicate, shard = (None, None) if topology is None else (resolve.get(topology[0], topology[0]), resolve.get(topology[1], topology[1]))
    JaxMeshManager.destroy()
    try:
        try:
            JaxMeshManager(
                devices=jax.devices()[:world], data_parallel_replication_world_size=replicate,
                data_parallel_sharding_world_size=shard,
            )
            want, want_error = dict(JaxMeshManager._sizes), None
        except ValueError as error:
            want, want_error = None, str(error)
    finally:
        JaxMeshManager.destroy()
    if want_error is not None:
        with pytest.raises(ValueError) as raised:
            mesh_sizes(world, data_parallel_replication_world_size=replicate, data_parallel_sharding_world_size=shard)
        assert str(raised.value) == want_error
    else:
        got = mesh_sizes(world, data_parallel_replication_world_size=replicate, data_parallel_sharding_world_size=shard)
        assert got == want


def test_mesh_manager_at_one_and_two_ranks(runs):
    one, two = runs["one"]["mesh"], [r["mesh"] for r in runs["two"]]
    assert one[None]["shape"] == (1, 1) and one[(1, 2)].startswith("ValueError")
    for rank, mesh in enumerate(two):
        assert mesh[None]["shape"] == (1, 2) and mesh[(1, 2)]["shape"] == (1, 2) and mesh[(2, 1)]["shape"] == (2, 1)
        for topology in (None, (1, 2), (2, 1)):
            m = mesh[topology]
            assert m["names"] == ("dp", "fsdp") and m["data_parallel"] == 2 and (m["tp"], m["sp"], m["ep"]) == (1, 1, 1)
            assert m["replicated"] == (2, 1) and m["initialized"] and not m["after_destroy"] and m["rank"] == rank
        assert mesh[(3, 1)] == "ValueError: replication (3) x sharding (1) != data parallel size (2)"


def test_data_parallel_size_is_held_to_the_world(monkeypatch, tmp_path):
    from dolomite_engine_tpu.distributed import build_mesh_from_args as jax_build_mesh
    from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
    from dolomite_engine_tpu_torch.distributed import build_mesh_from_args
    from dolomite_engine_tpu_torch.parallel.mesh import MeshManager
    from dolomite_engine_tpu_torch.utils import init_distributed

    config = dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=SMALL),
        tuning_args=dict(tuning_method="pretraining"),
        datasets=[dict(class_name="MegatronDataset", data_name="m", class_args={})],
        save_args=dict(save_path=str(tmp_path), save_interval=1),
        distributed_args=dict(stage=3, data_parallel_size=2),
    )
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    with pytest.raises(ValueError) as want:
        jax_build_mesh(JaxTrainingArgs(**config))
    init_distributed(None, "cpu")  # this process's group of one
    with pytest.raises(ValueError) as got:
        build_mesh_from_args(TrainingArgs(**config), "cpu")
    assert str(got.value) == str(want.value)
    config["distributed_args"]["data_parallel_size"] = 1
    build_mesh_from_args(TrainingArgs(**config), "cpu")
    assert MeshManager.get_data_parallel_world_size() == 1
    MeshManager.destroy()


# ------------------------------------------------------------------------------ stages


@pytest.mark.parametrize("stage", range(4))
def test_stage_layout(runs, stage):
    """At rest: stage 0 whole, 1-3 sharded (half of the rows here). From the forward to the
    backward: stages 0-2 whole (a plain tensor registered), stage 3 sharded again (re-gathered
    in the backward). After the backward every unit is at rest; the root (the tied table) is
    whole from the forward to the backward at every stage."""
    for layout in (r[f"layout{stage}"] for r in runs["two"]):
        rows = layout["global_shape"][0]
        at_rest = layout["at_rest"]
        assert at_rest["block_dtensor"] and at_rest["root_dtensor"]
        assert at_rest["block_local"][0] == (rows if stage == 0 else rows // 2)
        assert layout["after_forward"]["block_dtensor"] == (stage == 3)
        assert not layout["after_forward"]["root_dtensor"]
        assert layout["after_backward"]["block_dtensor"] and layout["after_backward"]["root_dtensor"]
        assert layout["grad_local"] == at_rest["block_local"]


# ------------------------------------------------------------------------------ the step


def _metrics(run):
    return [m["loss"] for m in run["metrics"]], [m["grad_norm"] for m in run["metrics"]]


def _assert_params(got, want, atol=1e-5):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", ["dense_stage0", "dense_stage1", "dense_stage3", "dense_hsdp_1x2", "dense_hsdp_2x1"])
def test_two_rank_step_matches_one_rank_and_jax(runs, name):
    ranks = [r[name if name != "dense_stage0" else "dense"] for r in runs["two"]]
    one, jax_run = runs["one"]["dense"], runs["jax_dense"]
    losses, norms = _metrics(ranks[0])
    assert _metrics(ranks[1]) == (losses, norms)  # every rank logs the reduced values
    np.testing.assert_allclose(losses, _metrics(one)[0], rtol=1e-5)
    np.testing.assert_allclose(norms, _metrics(one)[1], rtol=1e-5)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    np.testing.assert_allclose(norms, jax_run["norms"], rtol=1e-5)
    _assert_params(ranks[0]["params"], one["params"])
    _assert_params(ranks[0]["params"], jax_run["final"])
    # runs that shard alike compute the same bits; stage 0 sums whole tensors' squares
    alike = {"dense_stage0": "dense_hsdp_2x1", "dense_hsdp_2x1": "dense", "dense_stage1": "dense_stage3"}
    alike.update({"dense_stage3": "dense_hsdp_1x2", "dense_hsdp_1x2": "dense_stage1"})
    twin = runs["two"][0][alike[name]]
    assert _metrics(ranks[0]) == _metrics(twin)
    for key, value in twin["params"].items():
        np.testing.assert_array_equal(ranks[0]["params"][key], value, err_msg=key)
    base = runs["two"][0]["dense"]
    np.testing.assert_allclose(_metrics(ranks[0]), _metrics(base), rtol=1e-6)


def test_moe_step_at_stage_3_matches_one_rank_and_jax(runs):
    ranks = [r["moe"] for r in runs["two"]]
    one, jax_run = runs["one"]["moe"], runs["jax_moe"]
    losses, norms = _metrics(ranks[0])
    np.testing.assert_allclose(losses, _metrics(one)[0], rtol=1e-5)
    np.testing.assert_allclose(norms, _metrics(one)[1], rtol=1e-5)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    np.testing.assert_allclose(norms, jax_run["norms"], rtol=1e-5)
    _assert_params(ranks[0]["params"], one["params"])
    _assert_params(ranks[0]["params"], jax_run["final"])


# ------------------------------------------------------------------------------ optimizers


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_at_two_ranks_matches_one_rank(runs, name):
    one = runs["one"]["optimizers"][name]
    two = [r["optimizers"][name] for r in runs["two"]]
    if isinstance(one, str):
        assert two == [one, one]  # lbfgs and rprop under a schedule raise, as in JAX
        return
    losses = _metrics(two[0])[0]
    assert _metrics(two[1])[0] == losses
    np.testing.assert_allclose(losses, _metrics(one)[0], rtol=1e-5)
    _assert_params(two[0]["params"], one["params"])
    assert two[0]["count"] == one["count"] == 2


# ------------------------------------------------------------------------------ fp8 and health


def test_fp8_state_is_the_global_batch_state_on_every_rank(runs):
    one = runs["one"]["fp8"]["fp8"]
    two = [r["fp8"]["fp8"] for r in runs["two"]]
    assert one.keys() == two[0].keys() == two[1].keys() and any(k.endswith("output_grad_amax_history") for k in one)
    for key, value in one.items():
        np.testing.assert_array_equal(two[0][key], two[1][key], err_msg=key)
        np.testing.assert_array_equal(two[0][key], value, err_msg=key)


def test_health_statistics_match_one_rank(runs):
    one = runs["one"]["health"]["metrics"]
    for ranked in (r["health"]["metrics"] for r in runs["two"]):
        for got, want in zip(ranked, one, strict=True):
            for kind, by_group in want["health"].items():
                assert got["health"][kind].keys() == by_group.keys()
                for group, value in by_group.items():
                    np.testing.assert_allclose(got["health"][kind][group], value, rtol=1e-5, err_msg=f"{kind} {group}")
