"""The port's MoE ops and grouped-GEMM dispatch against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX grouped GEMMs
(`ops/pallas/moe.py`: `_gmm_call`, `_tgmm_call`, `experts_grouped`) run in Pallas
interpret mode, as `tests/ops/test_pallas_kernels.py` runs them off-TPU; the port's
`gmm` / `tgmm` take their plain versions because the tensors lie on the CPU (the CUDA
kernels are held against those plain versions by `tests/test_torch_cuda_kernels.py` and
`chip_smoke.py`).

Tolerances: routing indices and the padded layout exactly; routing weights and the
load-balancing loss 1e-6 (fp32 softmax, another summation order); the grouped GEMMs
1e-5 in fp32 and 1e-2 in bf16 (the JAX package's own kernel-parity tolerances: in bf16
the two sides round the combine's sum at different places); gradients 1e-4 (the JAX
package's backward-parity tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops import moe as jax_moe
from dolomite_engine_tpu.ops.pallas import moe as jax_pallas_moe
from dolomite_engine_tpu_torch.ops import moe
from dolomite_engine_tpu_torch.ops.activations import get_activation_function
from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_gelu(h):  # the port's "gelu" is the exact (erf) form
    return jax.nn.gelu(h, approximate=False)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    a = jnp.asarray(np.array(x))
    return a if dtype is None else a.astype(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _fixtures(seed, T=33, d=16, f=24, E=8, k=2, bias=True, glu=False):
    """numpy x, routing logits and banks ([E, d, f or 2f], [E, f, d]) with biases."""
    rs = np.random.RandomState(seed)
    fc_out = 2 * f if glu else f
    return dict(
        x=rs.randn(T, d).astype(np.float32),
        logits=rs.randn(T, E).astype(np.float32),
        w_fc=(rs.randn(E, d, fc_out) * 0.1).astype(np.float32),
        w_proj=(rs.randn(E, f, d) * 0.1).astype(np.float32),
        b_fc=(rs.randn(E, fc_out) * 0.1).astype(np.float32) if bias else None,
        b_proj=(rs.randn(E, d) * 0.1).astype(np.float32) if bias else None,
        E=E, k=k,
    )


# ------------------------------------------------------------------- routing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_matches_jax(dtype):
    logits = np.random.RandomState(0).randn(40, 8).astype(np.float32)
    want_w, want_sel = jax_moe.route(_j(logits, JAX_DTYPES[dtype]), 3)
    got_w, got_sel = moe.route(_t(logits, dtype), 3)
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    assert got_w.dtype == dtype and got_sel.dtype == torch.int32
    np.testing.assert_allclose(_np(got_w), _np(want_w), rtol=1e-6, atol=1e-6)


def test_route_breaks_ties_toward_the_lower_expert_as_xla():
    """bf16 logits on a coarse grid tie often (32 experts, as on the slice): the stable
    sort picks the same experts, in the same order, as XLA's top_k."""
    rs = np.random.RandomState(1)
    logits = rs.randint(-3, 4, (64, 32)).astype(np.float32) / 4
    logits[0] = 0.5  # every expert ties
    for k in (1, 4):
        want_w, want_sel = jax_moe.route(_j(logits, jnp.bfloat16), k)
        got_w, got_sel = moe.route(_t(logits, torch.bfloat16), k)
        np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
        np.testing.assert_array_equal(_np(got_w), _np(want_w))
    assert got_sel[0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_load_balancing_loss_matches_jax(masked, tied):
    rs = np.random.RandomState(2)
    logits = rs.randn(48, 8).astype(np.float32)
    if tied:
        logits[::3] = 0.0  # uniform rows: every probability ties
    mask = (rs.rand(48) > 0.3).astype(np.int32) if masked else None
    want = jax_moe.load_balancing_loss(_j(logits), 8, 2, token_mask=None if mask is None else _j(mask))
    got = moe.load_balancing_loss(_t(logits), 8, 2, token_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_combine_weights_and_eager_match_jax():
    fx = _fixtures(3)
    w, sel = jax_moe.route(_j(fx["logits"]), fx["k"])
    want_c = jax_moe.combine_weights(w, sel, fx["E"])
    got_c = moe.combine_weights(_t(w), _t(sel), fx["E"])
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=0)
    want = jax_moe.experts_eager(
        _j(fx["x"]), want_c, _j(fx["w_fc"]), _j(fx["b_fc"]), _j(fx["w_proj"]), _j(fx["b_proj"]), _jax_gelu
    )
    got = moe.experts_eager(
        _t(fx["x"]), got_c, _t(fx["w_fc"]), _t(fx["b_fc"]), _t(fx["w_proj"]), _t(fx["b_proj"]),
        get_activation_function("gelu"),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_eager_keeps_the_bank_layout_asserts():
    fx = _fixtures(4, bias=False)
    combine = torch.zeros(33, fx["E"])
    transposed = _t(fx["w_fc"]).transpose(1, 2).contiguous()  # [E, f, d]: a torch-layout import
    with pytest.raises(AssertionError, match="partner"):
        moe.experts_eager(_t(fx["x"]), combine, transposed, None, _t(fx["w_proj"]), None, torch.relu)


# ------------------------------------------------------------------- padded layout


@pytest.mark.parametrize(
    "group_sizes,block_rows",
    [
        ([5, 0, 12, 3, 0, 0, 9, 1], 8),  # empty experts, a partial trailing block
        ([33, 0, 0, 33], 16),  # every row on two experts
        ([0, 0, 0, 7], 7),  # A < 8: one block of the whole row count
        ([128, 1, 127, 0], 128),
        ([8, 8, 8, 8], 8),  # exact multiples: the trailing blocks repeat the last expert
    ],
)
def test_padded_layout_equals_jax(group_sizes, block_rows):
    assignments = sum(group_sizes)
    want = jax_pallas_moe._padded_layout(jnp.asarray(group_sizes, jnp.int32), assignments, block_rows)
    got = kmoe._padded_layout(torch.tensor(group_sizes, dtype=torch.int32), assignments, block_rows)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plan, _ = kmoe.block_plan(torch.tensor(group_sizes), assignments, block_rows)
    # every real row sits in a block of its expert; the block's real rows come first
    valid = plan.block_valid.numpy()
    assert valid.sum() == assignments and (valid <= block_rows).all()
    for e, rows in enumerate(group_sizes):
        blocks = np.nonzero(plan.block_expert.numpy() == e)[0]
        assert len(blocks) >= 1 and valid[blocks].sum() == rows


@pytest.mark.parametrize("assignments", [1, 5, 8, 31, 32, 64, 100, 128, 2048, 16384])
def test_pick_block_rows_equals_jax(assignments):
    assert kmoe._pick_block_rows(assignments) == jax_pallas_moe._pick_block_rows(assignments)


# ------------------------------------------------------------------- gmm / tgmm


def _jax_layout(group_sizes, block_rows):
    return jax_pallas_moe._padded_layout(jnp.asarray(group_sizes, jnp.int32), sum(group_sizes), block_rows)


@pytest.mark.parametrize("transpose", [False, True])
def test_plain_gmm_matches_the_pallas_gmm(transpose):
    """The Pallas kernel on a padded layout whose padding rows are zero (as the dispatch
    builds it) against `gmm_plain`, forward and over the transposed banks (dX)."""
    rs = np.random.RandomState(5)
    group_sizes, bm, k_dim, n_dim = [5, 0, 12, 3], 8, 16, 24
    plan, _ = kmoe.block_plan(torch.tensor(group_sizes), sum(group_sizes), bm)
    xp = rs.randn(plan.padded_rows, k_dim).astype(np.float32) * kmoe._row_mask(plan.block_valid, bm).numpy()
    w = rs.randn(4, n_dim, k_dim).astype(np.float32) if transpose else rs.randn(4, k_dim, n_dim).astype(np.float32)
    block_expert = _jax_layout(group_sizes, bm)[0]
    jax_w = jnp.swapaxes(_j(w), 1, 2) if transpose else _j(w)
    want = jax_pallas_moe._gmm_call(_j(xp), jax_w, block_expert, bm, interpret=True)
    got = kmoe.gmm(_t(xp), _t(w), plan, transpose_w=transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_tgmm_matches_the_pallas_tgmm():
    rs = np.random.RandomState(6)
    group_sizes, bm, k_dim, n_dim = [9, 0, 4, 20, 0], 8, 16, 24
    plan, _ = kmoe.block_plan(torch.tensor(group_sizes), sum(group_sizes), bm)
    mask = kmoe._row_mask(plan.block_valid, bm).numpy()
    xp = rs.randn(plan.padded_rows, k_dim).astype(np.float32) * mask
    dy = rs.randn(plan.padded_rows, n_dim).astype(np.float32) * mask
    block_expert = _jax_layout(group_sizes, bm)[0]
    want = jax_pallas_moe._tgmm_call(_j(xp), _j(dy), (5, k_dim, n_dim), block_expert, bm, interpret=True)
    got = kmoe.tgmm(_t(xp), _t(dy), plan, 5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[1].any() and not got[4].any()  # empty experts: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_tgmm_in_the_bank_dtype_is_the_pallas_tgmm_cast(dtype):
    """`tgmm_plain(..., out_dtype=bf16)` (what the backward now asks of tgmm) equals the
    JAX VJP's ``_tgmm_call(...).astype(bf16)`` bit for bit, with nonzero padding rows in
    xp (dy's are zero, as the backward's cotangent of masked outputs is). The inputs are
    multiples of 1/8 and 1/16 small enough that every fp32 sum is exact in either order,
    so the bits compare the one rounding to bf16, not the summation order."""
    rs = np.random.RandomState(13)
    group_sizes, bm, k_dim, n_dim = [9, 0, 70, 1, 29], 8, 24, 40
    plan, _ = kmoe.block_plan(torch.tensor(group_sizes), sum(group_sizes), bm)
    mask = kmoe._row_mask(plan.block_valid, bm).numpy()
    xp = rs.randint(-8, 9, (plan.padded_rows, k_dim)).astype(np.float32) / 8
    xp = np.where(mask, xp, 3.0 + xp)  # padding rows: nonzero
    dy = rs.randint(-8, 9, (plan.padded_rows, n_dim)).astype(np.float32) / 16 * mask
    block_expert = _jax_layout(group_sizes, bm)[0]
    jd = JAX_DTYPES[dtype]
    want = jax_pallas_moe._tgmm_call(
        _j(xp, jd), _j(dy, jd), (5, k_dim, n_dim), block_expert, bm, interpret=True
    ).astype(jnp.bfloat16)
    got = kmoe.tgmm_plain(
        _t(xp, dtype), _t(dy, dtype), plan.block_expert, bm, 5, plan.block_valid, out_dtype=torch.bfloat16
    )
    assert got.dtype == torch.bfloat16
    assert np.abs(np.asarray(want, np.float32)).sum() > 0
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # the wrapper on CPU tensors takes the same plain version
    wrapped = kmoe.tgmm(_t(xp, dtype), _t(dy, dtype), plan, 5, out_dtype=torch.bfloat16)
    assert torch.equal(wrapped, got)
    # and the rounding happened: the fp32 sums are not all representable in bf16
    fp32 = kmoe.tgmm_plain(_t(xp, dtype), _t(dy, dtype), plan.block_expert, bm, 5, plan.block_valid)
    assert not torch.equal(fp32, got.float())


def _run_both(fx, dtype, selected=None, weights=None, act="gelu"):
    """(port experts_grouped, JAX experts_grouped, JAX experts_eager) on the same inputs."""
    jd = JAX_DTYPES[dtype]
    if selected is None:
        w, sel = jax_moe.route(_j(fx["logits"]), fx["k"])
        weights, selected = np.asarray(w), np.asarray(sel)
    jax_args = [_j(fx[n], jd) if fx[n] is not None else None for n in ("w_fc", "b_fc", "w_proj", "b_proj")]
    jax_act = {"gelu": _jax_gelu, "swiglu": lambda h: h[..., : h.shape[-1] // 2] * jax.nn.silu(h[..., h.shape[-1] // 2 :])}[act]
    x_j, w_j, s_j = _j(fx["x"], jd), _j(weights, jd), _j(selected)
    want = jax_pallas_moe.experts_grouped(x_j, w_j, s_j, *jax_args, jax_act, fx["E"], interpret=True)
    eager = jax_moe.experts_eager(x_j, jax_moe.combine_weights(w_j, s_j, fx["E"]), *jax_args, jax_act)
    torch_args = [_t(fx[n], dtype) if fx[n] is not None else None for n in ("w_fc", "b_fc", "w_proj", "b_proj")]
    got = kmoe.experts_grouped(
        _t(fx["x"], dtype), _t(weights, dtype), _t(selected), *torch_args,
        get_activation_function("gelu" if act == "gelu" else "swiglu"), fx["E"],
    )
    return got, want, eager


@pytest.mark.parametrize(
    "dtype,tol,bias", [(torch.float32, 1e-5, True), (torch.float32, 1e-5, False), (torch.bfloat16, 1e-2, True)]
)
def test_experts_grouped_matches_jax_grouped_and_eager(dtype, tol, bias):
    got, want, eager = _run_both(_fixtures(7, bias=bias), dtype)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(eager), rtol=tol, atol=tol)


def test_experts_grouped_glu_banks_match_jax():
    """swiglu banks [E, d, 2f] (the slice's activation), four experts per token."""
    got, want, _ = _run_both(_fixtures(8, E=8, k=4, bias=False, glu=True), torch.float32, act="swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_experts_grouped_all_tokens_on_two_experts():
    fx = _fixtures(9, T=12)
    selected = np.tile([[2, 5]], (12, 1)).astype(np.int32)
    weights = np.full((12, 2), 0.5, np.float32)
    got, want, eager = _run_both(fx, torch.float32, selected=selected, weights=weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(eager), rtol=1e-5, atol=1e-5)


def test_grouped_mlp_matches_jax():
    fx = _fixtures(10, T=20)
    rs = np.random.RandomState(10)
    sorted_experts = np.sort(rs.randint(0, fx["E"], 20)).astype(np.int32)
    group_sizes = np.bincount(sorted_experts, minlength=fx["E"]).astype(np.int32)
    args = ("w_fc", "b_fc", "w_proj", "b_proj")
    want = jax_pallas_moe.grouped_mlp(
        _j(fx["x"][:20]), _j(sorted_experts), _j(group_sizes), *[_j(fx[n]) for n in args], _jax_gelu,
        interpret=True,
    )
    got = kmoe.grouped_mlp(
        _t(fx["x"][:20]), _t(sorted_experts), _t(group_sizes), *[_t(fx[n]) for n in args],
        get_activation_function("gelu"),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_grads_match_jax():
    """d/dx, d/dw_fc, d/dw_proj of sum(out^2) through the port's grouped GEMMs (plain
    gmm for dX over the transposed banks, plain tgmm for dW) against jax.grad through
    the Pallas kernels' custom VJP."""
    fx = _fixtures(11)
    w, sel = jax_moe.route(_j(fx["logits"]), fx["k"])

    def jax_loss(x, w_fc, w_proj):
        out = jax_pallas_moe.experts_grouped(
            x, w, sel, w_fc, _j(fx["b_fc"]), w_proj, _j(fx["b_proj"]), _jax_gelu, fx["E"], interpret=True
        )
        return jnp.sum(out**2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(_j(fx["x"]), _j(fx["w_fc"]), _j(fx["w_proj"]))
    x, w_fc, w_proj = (_t(fx[n]).requires_grad_() for n in ("x", "w_fc", "w_proj"))
    out = kmoe.experts_grouped(
        x, _t(w), _t(sel), w_fc, _t(fx["b_fc"]), w_proj, _t(fx["b_proj"]), get_activation_function("gelu"), fx["E"]
    )
    (out**2).sum().backward()
    for name, got, ref in zip(("x", "w_fc", "w_proj"), (x.grad, w_fc.grad, w_proj.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4, err_msg=name)


def test_bf16_bank_gradient_is_rounded_to_bf16():
    """dW leaves the grouped GEMM rounded to the bank's dtype: with fp32 master banks
    cast to bf16 for compute (mixed precision), the fp32 gradient holds exactly the bf16
    rounding of tgmm's fp32 sum, as under the JAX package's VJP cast."""
    fx = _fixtures(12, bias=False)
    w, sel = moe.route(_t(fx["logits"]), fx["k"])
    master = _t(fx["w_fc"]).requires_grad_()
    x = _t(fx["x"], torch.bfloat16)
    w_proj = _t(fx["w_proj"], torch.bfloat16)
    out = kmoe.experts_grouped(
        x, w.bfloat16(), sel, master.bfloat16(), None, w_proj, None, get_activation_function("gelu"), fx["E"]
    )
    out.float().square().sum().backward()
    grad = master.grad
    assert grad.dtype == torch.float32
    torch.testing.assert_close(grad, grad.bfloat16().float(), rtol=0, atol=0)  # representable in bf16
    assert grad.abs().sum() > 0
