"""The port's losses against the JAX package's, on the CPU.

The same numpy inputs go through `dolomite_engine_tpu.ops` (its `fused_ce` Pallas kernel
in interpret mode, or the XLA chunk body) and through `dolomite_engine_tpu_torch.ops`
(the `fused_ce` kernel's plain version, which a CPU tensor takes). Tolerances are the
JAX package's own fused-CE tests' (`tests/ops/test_pallas_kernels.py`): the row-wise
terms within rtol 3e-7, the loss within 2e-6 absolute (summation order only), the
gradients within 1.2e-7 absolute at magnitude ~1 (about one fp32 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops import loss as jax_loss
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.ops.pallas.fused_ce import fused_ce_rowwise as jax_fused_ce_rowwise
from dolomite_engine_tpu_torch.ops import loss as torch_loss
from dolomite_engine_tpu_torch.ops.kernels import fused_ce


def _fixtures(seed, batch, seq, hidden, vocab, ignore_rows=5):
    rs = np.random.RandomState(seed)
    h = rs.randn(batch, seq, hidden).astype(np.float32)
    table = (rs.randn(vocab, hidden) * 0.05).astype(np.float32)
    labels = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    labels[0, :ignore_rows] = -100  # IGNORE_INDEX rows must not contribute
    return h, table, labels


@pytest.mark.parametrize(
    "rows,hidden,vocab,logit_scale",
    [
        (37, 32, 211, None), (64, 64, 1000, 0.5), (8, 32, 513, 0.125),
        # two of the JAX kernel's 256-row blocks, H not a multiple of 64, V not of its 512-column tile
        (512, 96, 1000, None), (512, 96, 1300, 0.5),
    ],
)
def test_fused_ce_rowwise_plain_matches_pallas_interpret(rows, hidden, vocab, logit_scale):
    h, table, labels = _fixtures(rows, 1, rows, hidden, vocab)
    h, labels = h[0], labels[0]
    want = jax_fused_ce_rowwise(
        jnp.asarray(h), jnp.asarray(table), jnp.asarray(labels),
        logit_scale=logit_scale, compute_dtype=jnp.float32, interpret=True,
    )
    got = fused_ce.fused_ce_rowwise(
        torch.from_numpy(h), torch.from_numpy(table), torch.from_numpy(labels), logit_scale
    )
    valid = labels != -100  # the JAX kernel leaves an ignored row's label logit unspecified
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=3e-7)
    np.testing.assert_allclose(got[1].numpy()[valid], np.asarray(want[1])[valid], rtol=3e-7, atol=1e-7)
    assert np.all(got[1].numpy()[~valid] == 0.0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize(
    "z_coef,logit_scale,seq,chunk",
    [(0.0, None, 24, 7), (1e-3, None, 24, 8), (1e-4, 0.5, 30, 16)],
    ids=["plain", "z_loss", "z_loss_scaled_ragged"],
)
def test_fused_linear_cross_entropy_matches_jax(backend, z_coef, logit_scale, seq, chunk):
    """Loss, d(hidden) and d(table) against `jax.value_and_grad` of the JAX function,
    with its per-chunk reduction on the XLA body and on the Pallas kernel; the sequence
    is not a multiple of the chunk in every case."""
    h, table, labels = _fixtures(1, 2, seq, 32, 211)

    def jax_fn(hh, tt):
        return jax_loss.fused_linear_cross_entropy(
            hh, tt, jnp.asarray(labels), chunk_size=chunk, compute_dtype=jnp.float32,
            z_loss_coef=z_coef, logit_scale=logit_scale,
        )

    with kernel_overrides(fused_ce=backend):
        want_loss, want_grads = jax.value_and_grad(jax_fn, argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(table)
        )
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    loss = torch_loss.fused_linear_cross_entropy(
        th, tt, torch.from_numpy(labels).long(), chunk_size=chunk, compute_dtype=torch.float32,
        z_loss_coef=z_coef, logit_scale=logit_scale,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=2e-6)
    for got, want in zip((th.grad, tt.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1.2e-7)


def test_fused_loss_never_builds_full_logits():
    """The forward reduces chunk by chunk through the kernel wrapper: it is called once
    per chunk, with at most a chunk of rows."""
    h, table, labels = _fixtures(2, 2, 20, 32, 97)
    seen = []
    original = fused_ce.fused_ce_rowwise
    try:
        def spy(hidden, *args, **kwargs):
            seen.append(hidden.shape[0])
            return original(hidden, *args, **kwargs)

        fused_ce.fused_ce_rowwise = spy
        torch_loss.fused_linear_cross_entropy(
            torch.from_numpy(h), torch.from_numpy(table), torch.from_numpy(labels).long(),
            chunk_size=8, compute_dtype=torch.float32,
        )
    finally:
        fused_ce.fused_ce_rowwise = original
    assert seen == [2 * 8] * 3  # 20 tokens padded to 24: three chunks of [B=2, 8] rows


@pytest.mark.parametrize("seq", [512, 300])
def test_fused_loss_calls_the_kernel_once_per_chunk_of_batch_rows(seq):
    """The training paths' launch structure: one `fused_ce_rowwise` call per 256-token
    chunk, each over the chunk's tokens of every row of the micro batch (B 2, as the MoE
    and alibi cells run), a ragged sequence padded to whole chunks."""
    h, table, labels = _fixtures(4, 2, seq, 32, 97)
    seen = []
    original = fused_ce.fused_ce_rowwise
    try:
        def spy(hidden, *args, **kwargs):
            seen.append(tuple(hidden.shape))
            return original(hidden, *args, **kwargs)

        fused_ce.fused_ce_rowwise = spy
        loss = torch_loss.fused_linear_cross_entropy(
            torch.from_numpy(h), torch.from_numpy(table), torch.from_numpy(labels).long(),
            chunk_size=256, compute_dtype=torch.float32,
        )
    finally:
        fused_ce.fused_ce_rowwise = original
    assert seen == [(2 * 256, 32)] * 2  # ceil(seq / 256) chunks of [B x 256] rows
    assert torch.isfinite(loss)


@pytest.mark.parametrize("z_coef", [0.0, 1e-4])
@pytest.mark.parametrize("with_segments", [False, True])
def test_causal_lm_loss_and_labels_match_jax(z_coef, with_segments):
    rs = np.random.RandomState(3)
    logits = rs.randn(2, 12, 50).astype(np.float32)
    ids = rs.randint(0, 50, (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    seg = np.array([[1] * 5 + [2] * 7, [1] * 9 + [0] * 3], np.int32) if with_segments else None
    want_labels = jax_loss.derive_causal_labels(
        jnp.asarray(ids), jnp.asarray(mask), None if seg is None else jnp.asarray(seg)
    )
    got_labels = torch_loss.derive_causal_labels(
        torch.from_numpy(ids), torch.from_numpy(mask), None if seg is None else torch.from_numpy(seg)
    )
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(want_labels))
    want = jax_loss.causal_lm_loss(
        jnp.asarray(logits), jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        segment_ids=None if seg is None else jnp.asarray(seg), z_loss_coef=z_coef,
    )
    got = torch_loss.causal_lm_loss(
        torch.from_numpy(logits), torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        segment_ids=None if seg is None else torch.from_numpy(seg), z_loss_coef=z_coef,
    )
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=2e-6)
