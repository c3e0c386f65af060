"""T5's relative bias and the flash kernel's query-bias form, on the CPU.

- `relative_position_bucket`: the JAX package's bucket ids, exactly, for the
  bidirectional and the causal stack, over distances from -400 to 400 (past
  ``max_distance`` on both sides), at several bucket counts and distances.
- `RelativePositionBias`: the JAX module's ``[1, H, q, k]`` bias from the same table,
  exactly, for a full pass and a decode step at a query offset; the table's gradient
  through a loss within 1e-6.
- The query-bias form's plain version (what a CPU tensor takes): forward, dQ / dK / dV
  and dBias against jax's own flash kernel (`_tpu_flash_attention`, the TPU path of the
  decoder's self-attention) in interpret mode, fed ``bias / scale`` as `test_torch_alibi.py`
  feeds it (jax's kernel adds ``ab`` before the scale; its ``ds`` is the gradient of that
  ``ab``, which the vjp through the division scales back), for a shared ``[1, H, S, S]``
  bias (its gradient summed over the batch) causal over segments and a per-row bias not
  causal; 2e-5 / 5e-5 (forward / gradients, the alibi comparison's tolerances). And
  against the JAX dispatch's XLA path (`attention(..., flash_attention_2, alibi_bias=)`),
  1e-5.
- `attention` dispatch with a query bias: every implementation on the CPU takes masked
  attention with the bias, the JAX function's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.ops import attention as jax_attention
from dolomite_engine_tpu.ops import relative_bias as jax_relative_bias
from dolomite_engine_tpu_torch.ops import attention as torch_attention
from dolomite_engine_tpu_torch.ops import relative_bias
from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

SEQ = 256


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 12), (16, 50)])
def test_buckets_match_jax(bidirectional, num_buckets, max_distance):
    distances = np.arange(-400, 401)
    want = jax_relative_bias.relative_position_bucket(
        jnp.asarray(distances), bidirectional=bidirectional, num_buckets=num_buckets, max_distance=max_distance
    )
    got = relative_bias.relative_position_bucket(
        torch.from_numpy(distances), bidirectional=bidirectional, num_buckets=num_buckets, max_distance=max_distance
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() >= 0 and got.max() == num_buckets - 1


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_bias_and_table_gradient_match_jax(bidirectional):
    heads, q_len, k_len = 4, 9, 40
    module = jax_relative_bias.RelativePositionBias(num_heads=heads, num_buckets=16, max_distance=20, bidirectional=bidirectional)
    params = module.init(jax.random.PRNGKey(0), q_len, k_len)
    table = np.array(jax.tree.leaves(params)[0])
    port = relative_bias.RelativePositionBias(heads, 16, 20, bidirectional=bidirectional)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(table))
    for q, k, offset in ((q_len, k_len, 0), (1, k_len, 17)):
        want = module.apply(params, q, k, query_offset=offset)
        got = port(q, k, query_offset=offset)
        assert tuple(got.shape) == (1, heads, q, k)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    weights = np.random.RandomState(1).randn(1, heads, q_len, k_len).astype(np.float32)
    want_grad = jax.grad(lambda p: (module.apply(p, q_len, k_len) ** 2 * weights).sum())(params)
    (port(q_len, k_len) ** 2 * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(jax.tree.leaves(want_grad)[0]), atol=1e-6, rtol=1e-6)


def _inputs(seed, batch, hq, hkv, head_dim, bias_batch):
    rs = np.random.RandomState(seed)
    q = rs.randn(batch, SEQ, hq, head_dim).astype(np.float32)
    k = rs.randn(batch, SEQ, hkv, head_dim).astype(np.float32)
    v = rs.randn(batch, SEQ, hkv, head_dim).astype(np.float32)
    dout = rs.randn(batch, SEQ, hq, head_dim).astype(np.float32)
    bias = rs.randn(bias_batch, hq, SEQ, SEQ).astype(np.float32)
    return q, k, v, dout, bias


def _port_flash(q, k, v, dout, seg, scale, bias, causal):
    tensors = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = fa.flash_attention(*tensors[:3], None if seg is None else torch.from_numpy(seg), scale, tensors[3], causal)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in tensors]


# (label, batch, query heads, kv heads, head dim, the bias's batch, causal, segments)
FORMS = [
    ("shared-causal-segments", 2, 4, 2, 64, 1, True, [100, 156]),
    ("per-row-noncausal", 2, 4, 4, 64, 2, False, None),
]


@pytest.mark.parametrize("label,batch,hq,hkv,head_dim,bias_batch,causal,lengths", FORMS, ids=[f[0] for f in FORMS])
def test_query_bias_plain_matches_jax_flash_kernel_interpret(label, batch, hq, hkv, head_dim, bias_batch, causal, lengths):
    from jax.experimental.pallas import tpu as pltpu

    from dolomite_engine_tpu.ops.attention import _tpu_flash_attention

    q, k, v, dout, bias = _inputs(len(label), batch, hq, hkv, head_dim, bias_batch)
    seg = None if lengths is None else np.repeat(
        np.concatenate([np.full(n, i + 1) for i, n in enumerate(lengths)]).astype(np.int32)[None], batch, 0
    )
    scale = head_dim**-0.5

    def kernel(a, b, c, ab):
        # jax's kernel computes (q.k + ab) * scale: ab = bias / scale gives q.k scale + bias
        return _tpu_flash_attention(a, b, c, ab / scale, None if seg is None else jnp.asarray(seg), causal, scale)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(kernel, *(jnp.asarray(a) for a in (q, k, v, bias)))
        want_grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
        want = np.asarray(want)
    got, grads = _port_flash(q, k, v, dout, seg, scale, bias, causal)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert grads[3].shape == bias.shape
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, want_grads):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_query_bias_plain_matches_jax_xla(causal):
    q, k, v, dout, bias = _inputs(4, 2, 4, 2, 64, 1)
    scale = 0.125

    def jax_fn(a, b, c, ab):
        return jax_attention.attention(
            a, b, c, implementation=JaxImpl.flash_attention_2, causal=causal, softmax_scale=scale, alibi_bias=ab,
        )

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(dout))
    got, grads = _port_flash(q, k, v, dout, None, scale, bias, causal)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("implementation", ["eager", "sdpa", "flash_attention_2"])
def test_query_bias_dispatch_matches_jax(implementation):
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 16, 4, 16).astype(np.float32) for _ in range(3))
    bias = rs.randn(1, 4, 16, 16).astype(np.float32)
    want = jax_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), implementation=JaxImpl(implementation), alibi_bias=jnp.asarray(bias)
    )
    got = torch_attention.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), implementation=implementation,
        alibi_bias=torch.from_numpy(bias),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
