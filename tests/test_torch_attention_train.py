"""The port's training-path attention, norm and rope against the JAX package, on the CPU.

- The causal / segment-id flash attention's plain version (what a CPU tensor takes),
  forward and gradients, against the JAX `attention(..., flash_attention_2,
  segment_ids=...)` (its XLA path on the CPU) at head_dim 64 and 80 with GQA, and
  against jax's splash kernel in interpret mode at head_dim 128 (the only width that
  kernel takes, `tests/ops/test_attention_dispatch.py`). Tolerances: atol = rtol =
  1e-5 against XLA (the JAX package's attention tolerance), 2e-5 / 5e-5 for forward /
  gradients against splash (that test's own).
- The dispatch: masks with segment ids and the key-padding -> segment-id rewrite.
- rmsnorm (both forms) and rope gradients against `jax.vjp` of the Pallas wrappers in
  interpret mode: 1e-6 relative (the rmsnorm tests' rtol 5e-7 with the fp32 backward's
  reassociation on top), rope 1e-6 absolute (1-2 fp32 ulp at magnitude ~3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.ops import attention as jax_attention
from dolomite_engine_tpu.ops.pallas.rmsnorm import fused_rmsnorm as jax_fused_rmsnorm
from dolomite_engine_tpu.ops.pallas.rope_qkv import fused_rope_qkv as jax_fused_rope_qkv
from dolomite_engine_tpu_torch.ops import attention as torch_attention
from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa
from dolomite_engine_tpu_torch.ops.kernels.rmsnorm import fused_rmsnorm
from dolomite_engine_tpu_torch.ops.kernels.rope_qkv import fused_rope_qkv


def _qkv(seed, batch, seq, hq, hkv, head_dim):
    rs = np.random.RandomState(seed)
    return (
        rs.randn(batch, seq, hq, head_dim).astype(np.float32),
        rs.randn(batch, seq, hkv, head_dim).astype(np.float32),
        rs.randn(batch, seq, hkv, head_dim).astype(np.float32),
        rs.randn(batch, seq, hq, head_dim).astype(np.float32),
    )


def _segments(batch, lengths):
    row = np.concatenate([np.full(n, i + 1) for i, n in enumerate(lengths)]).astype(np.int32)
    return np.repeat(row[None], batch, 0)


def _torch_grads(q, k, v, dout, seg, scale):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), scale)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("head_dim,hq,hkv", [(64, 4, 2), (80, 6, 2), (80, 4, 4)])
def test_flash_plain_matches_jax_flash_attention_2(head_dim, hq, hkv):
    q, k, v, dout = _qkv(head_dim + hq, 2, 48, hq, hkv, head_dim)
    seg = _segments(2, [20, 13, 15])
    scale = head_dim**-0.5

    def jax_fn(a, b, c):
        return jax_attention.attention(
            a, b, c, implementation=JaxImpl.flash_attention_2, softmax_scale=scale,
            segment_ids=jnp.asarray(seg),
        )

    want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    got, grads = _torch_grads(q, k, v, dout, seg, scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


def test_flash_plain_matches_splash_interpret():
    from dolomite_engine_tpu.ops.attention import _tpu_splash_attention

    q, k, v, dout = _qkv(0, 2, 256, 4, 2, 128)
    seg = _segments(2, [96, 96, 64])
    scale = 128**-0.5

    def splash(a, b, c):
        return _tpu_splash_attention(a, b, c, jnp.asarray(seg), scale, interpret=True)

    want, vjp = jax.vjp(splash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    got, grads = _torch_grads(q, k, v, dout, seg, scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-5)


def test_flash_plain_lets_padding_attend_among_itself():
    """Segment 0 (padding) rows attend the earlier padding, as splash does; real rows
    never see padding, so their outputs equal those of the unpadded documents."""
    q, k, v, _ = _qkv(4, 1, 64, 2, 2, 64)
    seg = np.concatenate([_segments(1, [30, 24]), np.zeros((1, 10), np.int32)], axis=1)
    out, lse = fa.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(seg), 0.125
    )
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    short, _ = fa.flash_attention_fwd_plain(
        torch.from_numpy(q[:, :54]), torch.from_numpy(k[:, :54]), torch.from_numpy(v[:, :54]),
        torch.from_numpy(seg[:, :54]), 0.125,
    )
    # equal up to the products' shape-dependent summation order
    torch.testing.assert_close(out[:, :54], short, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_make_attention_mask_with_segments_matches_jax(causal):
    seg = np.array([[1, 1, 2, 2, 2, 0], [1, 2, 3, 3, 0, 0]], np.int32)
    want = jax_attention.make_attention_mask(2, 6, 6, causal=causal, segment_ids_q=jnp.asarray(seg))
    got = torch_attention.make_attention_mask(2, 6, 6, causal=causal, segment_ids_q=torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "implementation", ["eager", "sdpa", "flash_attention_2"]
)
@pytest.mark.parametrize("masking", ["segments", "key_padding"])
def test_training_attention_dispatch_matches_jax(implementation, masking):
    """On the CPU every implementation takes masked eager attention; flash_attention_2
    with a key-padding mask first rewrites it to segment ids, as on the TPU path."""
    q, k, v, _ = _qkv(9, 2, 16, 4, 2, 16)
    seg = mask = None
    if masking == "segments":
        seg = _segments(2, [7, 9])
    else:
        mask = np.ones((2, 16), np.int32)
        mask[1, :5] = 0  # a left-padded row
    want = jax_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), implementation=JaxImpl(implementation),
        attention_mask=None if mask is None else jnp.asarray(mask),
        segment_ids=None if seg is None else jnp.asarray(seg),
    )
    got = torch_attention.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), implementation=implementation,
        attention_mask=None if mask is None else torch.from_numpy(mask),
        segment_ids=None if seg is None else torch.from_numpy(seg),
    )
    real = np.ones((2, 16), bool) if mask is None else mask.astype(bool)  # pad rows are never read
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_grads_match_jax_vjp(with_residual):
    rs = np.random.RandomState(5)
    x = rs.randn(3, 7, 64).astype(np.float32)
    r = rs.randn(3, 7, 64).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(64)).astype(np.float32)
    dy = rs.randn(3, 7, 64).astype(np.float32)
    ds = rs.randn(3, 7, 64).astype(np.float32)
    tx, tr, tw = (torch.from_numpy(a).requires_grad_() for a in (x, r, w))
    if with_residual:
        def jax_fn(a, b, c):
            return jax_fused_rmsnorm(a, c, 1e-5, residual=b, interpret=True)

        want, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(r), jnp.asarray(w))
        want_grads = vjp((jnp.asarray(dy), jnp.asarray(ds)))
        out, stream = fused_rmsnorm(tx, tw, 1e-5, residual=tr)
        torch.autograd.backward((out, stream), (torch.from_numpy(dy), torch.from_numpy(ds)))
        got_grads = (tx.grad, tr.grad, tw.grad)
        np.testing.assert_array_equal(stream.detach().numpy(), np.asarray(want[1]))
    else:
        want, vjp = jax.vjp(lambda a, c: jax_fused_rmsnorm(a, c, 1e-5, interpret=True), jnp.asarray(x), jnp.asarray(w))
        want_grads = vjp(jnp.asarray(dy))
        fused_rmsnorm(tx, tw, 1e-5).backward(torch.from_numpy(dy))
        got_grads = (tx.grad, tw.grad)
    for got, ref in zip(got_grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
def test_rope_grads_match_jax_vjp(hq, hkv):
    rs = np.random.RandomState(6)
    head_dim = 16
    qkv = rs.randn(2, 9, (hq + 2 * hkv) * head_dim).astype(np.float32)
    angles = rs.rand(1, 9, head_dim).astype(np.float32) * 6
    cos, sin = np.cos(angles), np.sin(angles)
    g = rs.randn(*qkv.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a: jax_fused_rope_qkv(a, jnp.asarray(cos), jnp.asarray(sin), hq, hkv, head_dim, interpret=True),
        jnp.asarray(qkv),
    )
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(qkv).requires_grad_()
    fused_rope_qkv(t, torch.from_numpy(cos), torch.from_numpy(sin), hq, hkv, head_dim).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    v_cols = (hq + hkv) * head_dim
    np.testing.assert_array_equal(t.grad.numpy()[..., v_cols:], g[..., v_cols:])  # V passes g through
