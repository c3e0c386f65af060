"""The port's alibi ops and the additive-bias / non-causal flash attention, on the CPU.

- `get_alibi_slopes` / `get_alibi_bias` against the JAX package's, exactly, at power-of-2
  and other head counts, with and without a left-padded mask.
- The bias / non-causal flash attention's plain version (what a CPU tensor takes),
  forward and dQ/dK/dV, against the JAX `attention(..., flash_attention_2,
  alibi_bias=..., segment_ids=...)` (its XLA path on the CPU) at atol = rtol = 1e-5,
  the JAX package's attention tolerance; head_dim 64 / 128, GQA and MHA, causal and not.
- The same against jax's own flash kernel (`_tpu_flash_attention`, the TPU path for an
  alibi model) in interpret mode at 2e-5 / 5e-5 (forward / gradients, the splash
  comparison's tolerances). That kernel adds its bias before the softmax scale, where
  the JAX package's XLA paths (and the port) add it after: it is fed ``bias / scale``,
  which computes the XLA function (ROADMAP.md Queue C records the divergence).
- The dispatch: eager, sdpa and flash_attention_2 with an alibi bias over segments and
  over a key-padding mask (the bias from the mask's cumsum) against the JAX dispatch.
- A key-row bias that requires grad raises instead of losing its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.ops import alibi as jax_alibi
from dolomite_engine_tpu.ops import attention as jax_attention
from dolomite_engine_tpu_torch.ops import alibi
from dolomite_engine_tpu_torch.ops import attention as torch_attention
from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

SEQ = 256


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


def _left_padded_mask(batch, seq, pads):
    mask = np.ones((batch, seq), np.int32)
    for row, pad in enumerate(pads):
        mask[row, :pad] = 0
    return mask


def _torch_flash(q, k, v, dout, seg, scale, bias, causal):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(
        tq, tk, tv, torch.from_numpy(seg), scale,
        None if bias is None else torch.from_numpy(np.ascontiguousarray(bias[:, :, 0])), causal,
    )
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("num_heads", [1, 4, 6, 12, 32])
def test_alibi_slopes_match_jax(num_heads):
    got = alibi.get_alibi_slopes(num_heads)
    want = jax_alibi.get_alibi_slopes(num_heads)
    assert got.dtype == np.float32 and got.shape == (num_heads,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_heads", [4, 6, 32])
@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "left_padded_mask"])
def test_alibi_bias_matches_jax_exactly(num_heads, padded):
    mask = _left_padded_mask(3, 20, [0, 5, 19]) if padded else None
    want = jax_alibi.get_alibi_bias(num_heads, None if mask is None else jnp.asarray(mask), 3, 20)
    got = alibi.get_alibi_bias(num_heads, None if mask is None else torch.from_numpy(mask), 3, 20, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, num_heads, 1, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (head_dim, query heads, kv heads, causal, with the alibi bias)
FORMS = [
    (64, 4, 2, True, True),
    (64, 4, 2, False, True),
    (128, 4, 4, True, True),
    (128, 4, 4, False, True),
    (64, 8, 2, False, False),  # non-causal without a bias
]


@pytest.mark.parametrize(
    "head_dim,hq,hkv,causal,with_bias", FORMS,
    ids=[f"d{d}-{q}q{k}kv-{'causal' if c else 'noncausal'}{'-alibi' if b else ''}" for d, q, k, c, b in FORMS],
)
def test_bias_flash_plain_matches_jax_xla(head_dim, hq, hkv, causal, with_bias):
    q, k, v, dout = _qkv(head_dim + hq + int(causal), 2, SEQ, hq, hkv, head_dim)
    seg = _segments(2, [100, 90, 66])
    bias = np.array(jax_alibi.get_alibi_bias(hq, None, 2, SEQ)) if with_bias else None
    scale = head_dim**-0.5

    def jax_fn(a, b, c):
        return jax_attention.attention(
            a, b, c, implementation=JaxImpl.flash_attention_2, causal=causal, softmax_scale=scale,
            segment_ids=jnp.asarray(seg), alibi_bias=None if bias is None else jnp.asarray(bias),
        )

    want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    got, grads = _torch_flash(q, k, v, dout, seg, scale, bias, causal)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize(
    "head_dim,hq,hkv,causal", [(128, 4, 2, True), (64, 4, 4, False)], ids=["d128-gqa-causal", "d64-mha-noncausal"]
)
def test_bias_flash_plain_matches_jax_flash_kernel_interpret(head_dim, hq, hkv, causal):
    from jax.experimental.pallas import tpu as pltpu

    from dolomite_engine_tpu.ops.attention import _tpu_flash_attention

    q, k, v, dout = _qkv(7 + hq, 2, SEQ, hq, hkv, head_dim)
    seg = _segments(2, [128, 128])
    bias = np.array(jax_alibi.get_alibi_bias(hq, None, 2, SEQ))
    scale = head_dim**-0.5

    def kernel(a, b, c):
        # jax's kernel computes (q.k + ab) * scale: ab = bias / scale gives q.k scale + bias
        return _tpu_flash_attention(a, b, c, jnp.asarray(bias / scale), jnp.asarray(seg), causal, scale)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(kernel, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want_grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
        want = np.asarray(want)
    got, grads = _torch_flash(q, k, v, dout, seg, scale, bias, causal)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5, err_msg=f"d{name}")


def test_bias_shift_leaves_the_output_and_shifts_the_logsumexp():
    """The plain version shifts each row by its own position's bias: the output is that
    of the unshifted scores and the logsumexp is theirs less bias[i]."""
    q, k, v, _ = _qkv(3, 1, 64, 2, 2, 64)
    bias = torch.from_numpy(np.ascontiguousarray(np.array(jax_alibi.get_alibi_bias(2, None, 1, 64))[:, :, 0]))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = fa.flash_attention_fwd_plain(tq, tk, tv, None, 0.125, bias)
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * 0.125 + bias[:, :, None, :]
    causal = torch.ones(64, 64, dtype=torch.bool).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), tv)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1) - bias, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("implementation", ["eager", "sdpa", "flash_attention_2"])
@pytest.mark.parametrize("masking", ["segments", "key_padding"])
def test_alibi_attention_dispatch_matches_jax(implementation, masking):
    """On the CPU every implementation takes masked eager attention with the bias;
    flash_attention_2 with a key-padding mask first rewrites it to segment ids, with the
    bias from the mask's cumsum, as on the TPU path."""
    q, k, v, _ = _qkv(9, 2, 16, 4, 2, 16)
    seg = mask = None
    if masking == "segments":
        seg = _segments(2, [7, 9])
    else:
        mask = _left_padded_mask(2, 16, [0, 5])
    bias = np.array(jax_alibi.get_alibi_bias(4, None if mask is None else jnp.asarray(mask), 2, 16))
    want = jax_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), implementation=JaxImpl(implementation),
        attention_mask=None if mask is None else jnp.asarray(mask),
        segment_ids=None if seg is None else jnp.asarray(seg), alibi_bias=jnp.asarray(bias),
    )
    got = torch_attention.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), implementation=implementation,
        attention_mask=None if mask is None else torch.from_numpy(mask),
        segment_ids=None if seg is None else torch.from_numpy(seg), alibi_bias=torch.from_numpy(bias),
    )
    real = np.ones((2, 16), bool) if mask is None else mask.astype(bool)  # pad rows are never read
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], atol=1e-5, rtol=1e-5)


def test_padded_bias_flash_plain_matches_jax_xla():
    """The padded form: a left-padded batch's key-padding mask as segment ids (pad 0,
    real 1) with the bias from the mask's cumsum; real rows against the JAX dispatch."""
    q, k, v, dout = _qkv(11, 2, 128, 4, 4, 64)
    mask = _left_padded_mask(2, 128, [0, 37])
    bias = np.array(jax_alibi.get_alibi_bias(4, jnp.asarray(mask), 2, 128))

    def jax_fn(a, b, c):
        return jax_attention.attention(
            a, b, c, implementation=JaxImpl.flash_attention_2, attention_mask=jnp.asarray(mask),
            alibi_bias=jnp.asarray(bias),
        )

    real = mask.astype(bool)
    dout = dout * real[:, :, None, None]  # the loss reads real rows only
    want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    got, grads = _torch_flash(q, k, v, dout, mask, 0.125, bias, True)
    np.testing.assert_allclose(got[real], np.asarray(want)[real], atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a[real], np.asarray(b)[real], atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


def test_a_bias_that_requires_grad_raises():
    """A key row that requires grad raises, naming the query-bias form that returns the
    gradient (jax flash's `ds`); a constant bias passes and gets no gradient."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(0, 1, 64, 2, 2, 64))
    bias = torch.zeros((1, 2, 64), requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"as a query bias \[1 or B, Hq, S, S\]"):
        fa.flash_attention(q, k, v, None, 0.125, bias)
    # a constant bias passes, and gets no gradient
    out = fa.flash_attention(q.requires_grad_(), k, v, None, 0.125, bias.detach())
    out.sum().backward()
    assert q.grad is not None
