"""The port's delta rule (`ops/deltanet.py`) against the JAX package's, on the CPU.

The recurrent and the chunked forms (chunks 16, 32 and 64, with and without an initial
state) against JAX's; beta 0 leaves the state as it is; the two forms agree; the short
convolution and its rolling state; the qk maps; the chunked form's gradients against
`jax.grad`. The chunk's triangular solve runs in fp32 because torch has no bf16 form
of it (pinned below), so a bf16 call is held to the fp32 result at bf16's tolerance.

Tolerances: fp32 atol = rtol = 1e-5 (outputs, states and gradients: the same products,
summed in another order); bf16 against fp32 5e-2 (bf16 carries 8 bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops import deltanet as jax_deltanet
from dolomite_engine_tpu_torch.ops import deltanet

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, L, D = 2, 3, 128, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, length=L, zero_beta_from=None):
    rs = np.random.RandomState(seed)
    q, k = (rs.randn(B, H, length, D).astype(np.float32) for _ in range(2))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rs.randn(B, H, length, D).astype(np.float32)
    beta = (1 / (1 + np.exp(-rs.randn(B, H, length)))).astype(np.float32)
    if zero_beta_from is not None:
        beta[..., zero_beta_from:] = 0.0
    state = (0.1 * rs.randn(B, H, D, D)).astype(np.float32)
    return q, k, v, beta, state


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_matches_jax(chunk, with_state):
    q, k, v, beta, state = _inputs()
    init = state if with_state else None
    want_o, want_s = jax_deltanet.delta_rule_chunked(*_jax((q, k, v, beta)), chunk, None if init is None else jnp.asarray(init))
    got_o, got_s = deltanet.delta_rule_chunked(*_torch((q, k, v, beta)), chunk, None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_recurrent_matches_jax_and_the_chunked_form():
    q, k, v, beta, state = _inputs(1, length=40)
    want_o, want_s = jax_deltanet.delta_rule_recurrent(*_jax((q, k, v, beta, state)))
    got_o, got_s = deltanet.delta_rule_recurrent(*_torch((q, k, v, beta, state)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    head = _torch((q[:, :, :32], k[:, :, :32], v[:, :, :32], beta[..., :32]))
    chunked_o, chunked_s = deltanet.delta_rule_chunked(*head, 16, initial_state=torch.from_numpy(state))
    rec_o, rec_s = deltanet.delta_rule_recurrent(*head, initial_state=torch.from_numpy(state))
    torch.testing.assert_close(chunked_o, rec_o, **TOL)
    torch.testing.assert_close(chunked_s, rec_s, **TOL)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        deltanet.delta_rule_chunked(*_torch((q, k, v, beta)), 16)


@pytest.mark.parametrize("form", ["recurrent", "chunked"])
def test_zero_beta_is_a_no_op_on_the_state(form):
    """Positions with beta 0 (left padding) leave the state where the real tokens put it."""
    q, k, v, beta, state = _inputs(2, length=64, zero_beta_from=32)
    args = _torch((q, k, v, beta))
    run = (lambda *a: deltanet.delta_rule_recurrent(*a, torch.from_numpy(state))) if form == "recurrent" else (
        lambda *a: deltanet.delta_rule_chunked(*a, 32, torch.from_numpy(state))
    )
    _, full = run(*args)
    _, head = run(*(a[:, :, :32] for a in args))
    torch.testing.assert_close(full, head, **TOL)


def test_short_convolution_and_its_state_match_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 9, 5).astype(np.float32)
    weight = rs.randn(5, 4).astype(np.float32)
    state = rs.randn(2, 5, 4).astype(np.float32)
    bias = rs.randn(5).astype(np.float32)
    for conv_state, b, act in ((None, None, "silu"), (state, bias, None), (state, None, "silu")):
        want_y, want_s = jax_deltanet.short_convolution(
            jnp.asarray(x), jnp.asarray(weight), None if b is None else jnp.asarray(b), act,
            None if conv_state is None else jnp.asarray(conv_state),
        )
        got_y, got_s = deltanet.short_convolution(
            torch.from_numpy(x), torch.from_numpy(weight), None if b is None else torch.from_numpy(b), act,
            None if conv_state is None else torch.from_numpy(conv_state),
        )
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # one token at a time through the rolling state = the whole sequence at once
    y_all, s_all = deltanet.short_convolution(torch.from_numpy(x), torch.from_numpy(weight))
    s, steps = None, []
    for t in range(x.shape[1]):
        y, s = deltanet.short_convolution(torch.from_numpy(x[:, t : t + 1]), torch.from_numpy(weight), conv_state=s)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, dim=1), y_all, **TOL)
    torch.testing.assert_close(s, s_all, atol=0, rtol=0)


def test_qk_maps_match_jax():
    x = np.random.RandomState(4).randn(3, 7).astype(np.float32)
    x[0] = 0.0  # l2_norm's eps keeps a zero row finite
    for name in ("l2_norm", "sum_norm", "elu_p1"):
        np.testing.assert_allclose(
            getattr(deltanet, name)(torch.from_numpy(x)).numpy(), np.asarray(getattr(jax_deltanet, name)(jnp.asarray(x))),
            **TOL, err_msg=name,
        )


def test_chunked_gradients_match_jax():
    q, k, v, beta, state = _inputs(5, length=64)
    w = np.random.RandomState(6).randn(B, H, 64, D).astype(np.float32)

    def jax_loss(q, k, v, beta, state):
        o, s = jax_deltanet.delta_rule_chunked(q, k, v, beta, 16, state)
        return jnp.sum(o * w) + jnp.sum(s**2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*_jax((q, k, v, beta, state)))
    args = [t.requires_grad_() for t in _torch((q, k, v, beta, state))]
    o, s = deltanet.delta_rule_chunked(*args[:4], 16, args[4])
    ((o * torch.from_numpy(w)).sum() + (s**2).sum()).backward()
    for name, arg, ref in zip("q k v beta state".split(), args, want):
        np.testing.assert_allclose(arg.grad.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4, err_msg=name)


def test_bf16_solves_in_fp32():
    """torch has no bf16 triangular solve, so the chunk's solve runs in fp32 and a bf16
    call stays within bf16's rounding of the fp32 result."""
    eye = torch.eye(4, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="BFloat16"):
        torch.linalg.solve_triangular(eye, eye, upper=False, unitriangular=True)
    q, k, v, beta, state = _torch(_inputs(7, length=64))
    want, _ = deltanet.delta_rule_chunked(q, k, v, beta, 64)
    got, _ = deltanet.delta_rule_chunked(*(t.bfloat16() for t in (q, k, v, beta)), 64)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, atol=5e-2, rtol=5e-2)
