"""The port's remat policies against the JAX package's, on the CPU.

- Every named policy (`full`, `save_dots`, `save_attention_out`, `offload_dots`, which
  falls back to `save_dots` off a card as JAX's does without pinned host memory) and every
  raw `jax.checkpoint_policies` name, remat of every block, on the dense and the MoE
  model: the loss and every gradient equal the JAX model's under the same policy (loss
  2e-6 relative, gradients 1e-6 absolute + 1e-4 relative: fp32 reassociated), and the
  port's own run without remat bit for bit.
- The JAX side runs once per distinct JAX policy function: the names that resolve to the
  same one (``save_dots``, ``dots_saveable``, ``checkpoint_dots`` and, off a TPU,
  ``offload_dots`` all resolve to `dots_saveable`; ``checkpoint_dots_with_no_batch_dims``
  to `dots_with_no_batch_dims_saveable`) share its run, which JAX computes identically.
- What each policy reruns, counted by a dispatch mode over the backward: `full` reruns
  the products of the checkpointed blocks, `save_dots` none, `everything_saveable`
  nothing.
- `get_model_tflops` and `estimate_remat_activation_bytes` equal JAX's for each policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch.utils._python_dispatch import TorchDispatchMode

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.enums import Mode
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxWrapper
from dolomite_engine_tpu.models.config import CommonConfig as JaxConfig
from dolomite_engine_tpu.models.gpt_dolomite import resolve_remat_policy as jax_resolve_remat_policy
from dolomite_engine_tpu.train_utils import estimate_remat_activation_bytes as jax_estimate
from dolomite_engine_tpu.train_utils import get_model_tflops as jax_get_model_tflops
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
from dolomite_engine_tpu_torch.models import CommonConfig, load_jax_params
from dolomite_engine_tpu_torch.models.remat import RAW_REMAT_POLICIES, REMAT_POLICY_NAMES
from dolomite_engine_tpu_torch.train_utils import estimate_remat_activation_bytes, get_model_tflops

SEQ = 32
DENSE = dict(
    model_type="gpt_dolomite", vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=4,
    num_key_value_heads=2, attention_head_type="gqa", position_embedding_type="rope", add_bias=False,
    activation_function="swiglu", normalization_function="rmsnorm", resid_pdrop=0.0, embd_pdrop=0.0,
    attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2, fused_lm_head_loss=True, loss_chunk_size=16,
)
MOE = dict(DENSE, model_type="moe_dolomite", num_experts=4, num_experts_per_tok=2, router_aux_loss_coef=0.01)
POLICIES = [("policy", name) for name in REMAT_POLICY_NAMES] + [("checkpoint_policy", name) for name in RAW_REMAT_POLICIES]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's spinning thread pool,
    oversubscribed, slows these small steps and the workers running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _text(seed=0, batch=2):
    rs = np.random.RandomState(seed)
    text = rs.randint(3, DENSE["vocab_size"], (batch, SEQ + 1))
    text[:, 9] = DENSE["eos_token_id"]  # two documents a row
    return text


@pytest.fixture(scope="module", params=["dense", "moe"])
def family(request):
    config = DENSE if request.param == "dense" else MOE
    wrapper = JaxWrapper(
        mode=Mode.training, pretrained_config=config, dtype="fp32", sequence_length=SEQ,
        reset_attention_mask=True, reset_position_ids=True, zero_stage=0,
        attention_implementation=JaxImpl.flash_attention_2,
    )
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    port = _port(config, params, None)
    text = torch.from_numpy(_text())
    loss = port.loss(text)
    loss.backward()
    reference = (loss.detach(), {n: p.grad.clone() for n, p in port.model.named_parameters()})
    return config, params, reference, {}


def _port(config, params, gc_args):
    wrapper = ModelWrapperForPretraining(
        config, dtype="fp32", attention_implementation="flash_attention_2", gradient_checkpointing_args=gc_args,
        reset_attention_mask=True, reset_position_ids=True, device="cpu",
    )
    load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
    return wrapper


def _flat(grads):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1]).replace("h_", "h.")
        value = np.asarray(leaf)
        if keys[-1] == "kernel" and value.ndim == 2:
            value = value.T
        out[f"{name}.weight" if keys[-1] in ("kernel", "embedding", "weight") else f"{name}.{keys[-1]}"] = value
    return out


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default):
            self.products += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("key, policy", POLICIES, ids=[p for _, p in POLICIES])
def test_policy_matches_jax_and_no_remat(family, key, policy):
    config, params, (ref_loss, ref_grads), jax_runs = family
    gc_args = {"checkpoint_every": 1, key: policy}
    text = _text()
    # the JAX policy function this name resolves to (save_only_these_names builds a new one
    # each call: keyed by its name)
    jax_policy = policy if policy == "save_attention_out" else jax_resolve_remat_policy(policy)
    if jax_policy not in jax_runs:
        jax_wrapper = JaxWrapper(
            mode=Mode.training, pretrained_config=config, dtype="fp32", sequence_length=SEQ,
            reset_attention_mask=True, reset_position_ids=True, zero_stage=0,
            attention_implementation=JaxImpl.flash_attention_2, gradient_checkpointing_args=gc_args,
        )
        jax_runs[jax_policy] = jax.value_and_grad(lambda p: jax_wrapper.loss(p, jnp.asarray(text), train=True))(params)
    want_loss, want_grads = jax_runs[jax_policy]
    port = _port(config, params, gc_args)
    loss = port.loss(torch.from_numpy(text))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-6)
    want = _flat(want_grads)
    got = {n: p.grad for n, p in port.model.named_parameters()}
    assert set(got) == set(want)
    for name, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want[name], rtol=1e-4, atol=1e-6, err_msg=name)
    # bit for bit the port's run without remat
    assert torch.equal(loss.detach(), ref_loss)
    for name, grad in got.items():
        assert torch.equal(grad, ref_grads[name]), name


def _products_in_backward(policy, every=1, key="policy"):
    port = _port(DENSE, _jax_params(), {"checkpoint_every": every, key: policy} if policy else None)
    loss = port.loss(torch.from_numpy(_text()))
    counter = _CountProducts()
    with counter:
        loss.backward()
    return counter.products


_PARAMS = {}


def _jax_params():
    if "dense" not in _PARAMS:
        wrapper = JaxWrapper(
            mode=Mode.training, pretrained_config=DENSE, dtype="fp32", sequence_length=SEQ, zero_stage=0,
        )
        _PARAMS["dense"] = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    return _PARAMS["dense"]


def test_what_each_policy_reruns():
    """The backward's products beyond the no-remat backward's are the recompute: per block
    c_attn, the attention's two batched products (plain attention on the CPU), its c_proj
    and c_fc; the MLP's c_proj, the block's last product, is not rerun, since torch stops
    the recompute once the last value the backward needs is rebuilt."""
    base = _products_in_backward(None)
    layers = DENSE["n_layer"]
    rerun = {
        policy: _products_in_backward(policy) - base
        for policy in ("full", "save_dots", "save_attention_out", "offload_dots")
    }
    rerun["everything_saveable"] = _products_in_backward("everything_saveable", key="checkpoint_policy") - base
    assert rerun["full"] == rerun["save_attention_out"] == 5 * layers
    assert rerun["save_dots"] == rerun["offload_dots"] == 0
    assert rerun["everything_saveable"] == 0
    # every second block only
    assert _products_in_backward("full", every=2) - base == 5 * (layers // 2)


@pytest.mark.parametrize("every", [0, 1, 2])
@pytest.mark.parametrize("key, policy", POLICIES, ids=[p for _, p in POLICIES])
def test_tflops_and_activation_bytes_match_jax(every, key, policy):
    config = dict(DENSE, n_embd=2560, n_layer=32, n_head=32, num_key_value_heads=32, n_inner=10240, vocab_size=49152)
    args = {"checkpoint_every": every, key: policy} if every else None
    jax_config, port_config = JaxConfig(**config), CommonConfig.from_dict(config)
    want = jax_get_model_tflops(jax_config, 2, 4096, "block" if every else None, args)
    assert get_model_tflops(port_config, 2, 4096, "block" if every else None, args) == pytest.approx(want, rel=1e-12)
    for dtype_bytes in (2, 4):
        want = jax_estimate(jax_config, 1, 4096, "block" if every else None, args, dtype_bytes)
        assert estimate_remat_activation_bytes(port_config, 1, 4096, "block" if every else None, args, dtype_bytes) == want
