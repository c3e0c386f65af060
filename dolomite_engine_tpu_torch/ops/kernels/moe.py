"""Grouped-GEMM MoE dispatch: the CUDA kernels, their plain versions and the layout.

Replaces the TPU kernels ``_gmm_call`` and ``_tgmm_call``
(`dolomite_engine_tpu/ops/pallas/moe.py:78`, `:100`) and ports the code around them:
`_pick_block_rows`, `_padded_layout` (the same static ``NB = cdiv(A, bm) + E`` blocks,
every expert owning at least one), `grouped_gemm` (forward = gmm; backward = gmm over
the banks read transposed for dX, cast to ``xp``'s dtype, and tgmm for dW, summed in
fp32 and written in the bank's dtype: the JAX package's VJP casts the fp32 sum with
``.astype(w.dtype)``, and the kernel rounds the same sum once in its epilogue),
`grouped_mlp` and `experts_grouped`. Both kernels live in
``dolomite_engine_tpu_torch/csrc/grouped_gemm.cu`` (bound, design and the fixed shape rule
that picks each call's path noted there; `gmm_path` / `tgmm_path` name it).

`gmm` / `tgmm` launch the kernels for CUDA tensors (or raise) and take `gmm_plain` /
`tgmm_plain` for CPU tensors. Rows of a block at or past its real row count
(``block_valid``) are padding: whatever they hold, both versions treat them as zero and
write zeros. The padded rows are never gathered back, so the result is the JAX package's.

Nothing here synchronises with the host on the main path: the group sizes are a
scatter-add, the block map a `repeat_interleave` with a static ``output_size``, the
permutation a stable `argsort`, and the combine gathers each token's k results back in
routing order and sums them (no scatter-add, whose atomics would sum in no fixed order).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable

import torch

from ._build import DTYPE_CODES, KernelSpec, check_cuda_tensor, check_launch, current_stream, load_library, ptr

KERNEL = KernelSpec(
    name="grouped_gemm",
    source="dolomite_engine_tpu_torch/csrc/grouped_gemm.cu",
    replaces="dolomite_engine_tpu/ops/pallas/moe.py:78",
)
TGMM_KERNEL = KernelSpec(
    name="grouped_gemm_tgmm",
    source="dolomite_engine_tpu_torch/csrc/grouped_gemm.cu",
    replaces="dolomite_engine_tpu/ops/pallas/moe.py:100",
)

MAX_BLOCK_ROWS = 128


def _pick_block_rows(assignments: int) -> int:
    for block in (128, 64, 32, 16, 8):
        if assignments >= block:
            return block
    return max(assignments, 1)


def _padded_layout(group_sizes: torch.Tensor, assignments: int, block_rows: int):
    """``(block_expert [NB], group_block_start [E], group_start [E], NB)``, int32, as the
    JAX package's: every expert rounds up to whole blocks of `block_rows` and owns at
    least one; ``group_block_start`` is each expert's first padded row; blocks past the
    last expert's repeat the last expert (over all-padding rows)."""
    num_experts = group_sizes.shape[0]
    num_blocks = -(-assignments // block_rows) + num_experts  # static upper bound
    blocks_per_group = torch.clamp(-(-group_sizes // block_rows), min=1)
    # one more entry (the last expert again) takes the trailing blocks, so the repeats sum
    # to NB exactly; built on the device, as a host scalar written into it would sync
    experts = torch.arange(num_experts + 1, dtype=torch.int32, device=group_sizes.device).clamp_(max=num_experts - 1)
    repeats = torch.cat([blocks_per_group.long(), (num_blocks - blocks_per_group.long().sum()).reshape(1)])
    block_expert = torch.repeat_interleave(experts, repeats, output_size=num_blocks)
    group_block_start = (torch.cumsum(blocks_per_group, 0) - blocks_per_group) * block_rows
    group_start = torch.cumsum(group_sizes, 0) - group_sizes
    return block_expert, group_block_start.int(), group_start.int(), num_blocks


@dataclass
class BlockPlan:
    """What the kernels read of the padded layout, all int32 on the rows' device."""

    block_rows: int
    num_blocks: int
    block_expert: torch.Tensor  # [NB] expert bank of each block
    block_valid: torch.Tensor  # [NB] real rows of each block (the rest is padding)
    group_block_start: torch.Tensor  # [E] first padded row of each expert
    group_sizes: torch.Tensor  # [E] real rows of each expert

    @property
    def padded_rows(self) -> int:
        return self.num_blocks * self.block_rows


def block_plan(
    group_sizes: torch.Tensor, assignments: int, block_rows: int | None = None
) -> tuple[BlockPlan, torch.Tensor]:
    """The kernels' plan for expert-sorted rows of `group_sizes` [E], and each expert's
    first row in the sorted (unpadded) order."""
    block_rows = block_rows or _pick_block_rows(assignments)
    if block_rows > MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows {block_rows} exceeds the kernels' {MAX_BLOCK_ROWS}")
    group_sizes = group_sizes.to(torch.int32)
    block_expert, group_block_start, group_start, num_blocks = _padded_layout(
        group_sizes, assignments, block_rows
    )
    expert = block_expert.long()
    local_block = (
        torch.arange(num_blocks, dtype=torch.int32, device=group_sizes.device)
        - group_block_start[expert] // block_rows
    )
    block_valid = torch.clamp(group_sizes[expert] - local_block * block_rows, 0, block_rows)
    plan = BlockPlan(
        block_rows, num_blocks, block_expert, block_valid.int(), group_block_start, group_sizes
    )
    return plan, group_start


def _row_mask(block_valid: torch.Tensor, block_rows: int) -> torch.Tensor:
    """[NB * bm, 1] bool: the real rows of the padded layout."""
    local = torch.arange(block_rows, device=block_valid.device)
    return (local[None, :] < block_valid[:, None]).reshape(-1, 1)


def _expert_runs(block_expert: torch.Tensor, block_rows: int):
    """(expert, row slice) of each run of consecutive blocks of one expert (host side)."""
    start = 0
    for expert, run in itertools.groupby(block_expert.tolist()):
        count = len(list(run))
        yield expert, slice(start * block_rows, (start + count) * block_rows)
        start += count


def gmm_plain(xp, w, block_expert, block_rows, block_valid=None, transpose_w=False):
    """``out[b*bm:(b+1)*bm] = xp[b*bm:(b+1)*bm] @ w[block_expert[b]]`` (``w[e]^T`` when
    `transpose_w`) with fp32 accumulation, in ``xp``'s dtype; rows at or past
    `block_valid` are zero."""
    bank = w.transpose(1, 2) if transpose_w else w
    out = torch.zeros((xp.shape[0], bank.shape[2]), dtype=torch.float32, device=xp.device)
    for expert, rows in _expert_runs(block_expert, block_rows):
        out[rows] = xp[rows].float() @ bank[expert].float()
    if block_valid is not None:
        out = torch.where(_row_mask(block_valid, block_rows), out, torch.zeros_like(out))
    return out.to(xp.dtype)


def tgmm_plain(xp, dy, block_expert, block_rows, num_experts, block_valid=None, out_dtype=torch.float32):
    """``dW[e] = sum over e's blocks of xp_b^T @ dy_b``, summed in fp32 ``[E, K, N]`` and
    returned as `out_dtype` (one rounding of the fp32 sum); rows at or past `block_valid`
    count as zero."""
    if block_valid is not None:
        dy = torch.where(_row_mask(block_valid, block_rows), dy, torch.zeros_like(dy))
    out = torch.zeros((num_experts, xp.shape[1], dy.shape[1]), dtype=torch.float32, device=xp.device)
    for expert, rows in _expert_runs(block_expert, block_rows):
        out[expert] += xp[rows].float().T @ dy[rows].float()
    return out.to(out_dtype)


def _check_plan(plan: BlockPlan, rows: int, device: torch.device) -> None:
    if rows != plan.padded_rows:
        raise ValueError(f"{rows} rows do not match the plan's {plan.num_blocks} x {plan.block_rows}")
    for name in ("block_expert", "block_valid", "group_block_start", "group_sizes"):
        check_cuda_tensor(getattr(plan, name), name, device, dtypes=(torch.int32,))


def gmm(xp: torch.Tensor, w: torch.Tensor, plan: BlockPlan, transpose_w: bool = False) -> torch.Tensor:
    """Grouped GEMM over the padded layout: ``xp [NB * bm, K]`` against ``w [E, K, N]``
    (or ``[E, N, K]`` read transposed) -> ``[NB * bm, N]`` in ``xp``'s dtype."""
    if xp.device.type == "cpu":
        return gmm_plain(xp, w, plan.block_expert, plan.block_rows, plan.block_valid, transpose_w)
    if xp.device.type != "cuda":
        raise ValueError(f"gmm runs on CUDA or CPU tensors, got {xp.device}")
    device = xp.device
    check_cuda_tensor(xp, "xp", device)
    check_cuda_tensor(w, "w", device, dtypes=(xp.dtype,))
    _check_plan(plan, xp.shape[0], device)
    k_dim = xp.shape[1]
    n_dim = w.shape[1] if transpose_w else w.shape[2]
    if w.ndim != 3 or (w.shape[2] if transpose_w else w.shape[1]) != k_dim:
        raise ValueError(f"w {tuple(w.shape)} does not contract with xp {tuple(xp.shape)}")
    out = torch.empty((xp.shape[0], n_dim), dtype=xp.dtype, device=device)
    code = load_library().dolo_gmm(
        ptr(xp), ptr(w), ptr(plan.block_expert), ptr(plan.block_valid), ptr(out),
        plan.num_blocks, plan.block_rows, k_dim, n_dim, w.shape[0], int(transpose_w), DTYPE_CODES[xp.dtype],
        current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launches += 1
    return out


def tgmm(
    xp: torch.Tensor, dy: torch.Tensor, plan: BlockPlan, num_experts: int, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Per-expert ``xp^T dy`` over each expert's real rows, summed in fp32: ``[E, K, N]``
    in `out_dtype` (fp32 or bf16)."""
    if xp.device.type == "cpu":
        return tgmm_plain(xp, dy, plan.block_expert, plan.block_rows, num_experts, plan.block_valid, out_dtype)
    if xp.device.type != "cuda":
        raise ValueError(f"tgmm runs on CUDA or CPU tensors, got {xp.device}")
    device = xp.device
    check_cuda_tensor(xp, "xp", device)
    check_cuda_tensor(dy, "dy", device, dtypes=(xp.dtype,))
    _check_plan(plan, xp.shape[0], device)
    if dy.shape[0] != xp.shape[0] or plan.group_sizes.shape[0] != num_experts:
        raise ValueError(f"xp {tuple(xp.shape)}, dy {tuple(dy.shape)} and {num_experts} experts disagree")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tgmm writes fp32 or bf16, not {out_dtype}")
    k_dim, n_dim = xp.shape[1], dy.shape[1]
    out = torch.empty((num_experts, k_dim, n_dim), dtype=out_dtype, device=device)
    code = load_library().dolo_tgmm(
        ptr(xp), ptr(dy), ptr(plan.group_block_start), ptr(plan.group_sizes), ptr(out),
        xp.shape[0], num_experts, k_dim, n_dim, DTYPE_CODES[xp.dtype], DTYPE_CODES[out_dtype],
        current_stream(device),
    )
    check_launch(code, TGMM_KERNEL.name)
    TGMM_KERNEL.launches += 1
    return out


PATHS = ("fma", "mma.sync", "wgmma")  # csrc/grouped_gemm.cu `route`: 0, 1, 2


def _path(dtype: torch.dtype, k_dim: int, n_dim: int, a: torch.Tensor, b: torch.Tensor) -> str:
    return PATHS[load_library().dolo_grouped_gemm_route(DTYPE_CODES[dtype], k_dim, n_dim, ptr(a), ptr(b), ptr(None))]


def gmm_path(xp: torch.Tensor, w: torch.Tensor, transpose_w: bool = False) -> str:
    """The kernel path `gmm` takes for these CUDA tensors: "wgmma" (TMA + warpgroup MMA),
    "mma.sync" (bf16 widths TMA cannot address) or "fma" (fp32)."""
    return _path(xp.dtype, xp.shape[1], w.shape[1] if transpose_w else w.shape[2], xp, w)


def tgmm_path(xp: torch.Tensor, dy: torch.Tensor) -> str:
    """The kernel path `tgmm` takes for these CUDA tensors (as `gmm_path`)."""
    return _path(xp.dtype, xp.shape[1], dy.shape[1], xp, dy)


class _GroupedGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, w, plan):
        ctx.plan = plan  # integer layout tensors: no gradient, never written in place
        ctx.save_for_backward(xp, w)
        return gmm(xp, w, plan)

    @staticmethod
    def backward(ctx, dy):
        xp, w = ctx.saved_tensors
        plan = ctx.plan
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, w, plan, transpose_w=True).to(xp.dtype)
        if ctx.needs_input_grad[1]:
            # written in the bank's dtype (bf16 under mixed precision: one rounding of the
            # fp32 sum) before autograd adds it into the fp32 master gradient, as the JAX
            # package's VJP casts
            dw = tgmm(xp, dy, plan, w.shape[0], out_dtype=w.dtype)
        return dx, dw, None


def grouped_gemm(xp: torch.Tensor, w: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """``out[b*bm:(b+1)*bm] = xp[b*bm:(b+1)*bm] @ w[block_expert[b]]``, differentiable in
    `xp` and `w`."""
    return _GroupedGemm.apply(xp, w, plan)


def _padded_rows(plan: BlockPlan, group_start: torch.Tensor, experts: torch.Tensor, position: torch.Tensor):
    """The padded-layout row of each row, from its expert and its position in the
    expert-sorted order: a permutation of the real rows into the padded layout."""
    experts = experts.long()
    return plan.group_block_start[experts].long() + position - group_start[experts].long()


def _padded_mlp(rows, dest, plan, w_fc, b_fc, w_proj, b_proj, act):
    """fc -> act -> proj of `rows` placed at padded rows `dest` (padding rows zero);
    biases by each row's block expert. Returns the results of `rows`, in their order.
    Placing and taking back by one permutation keeps the backward deterministic: its
    scatters write each row once."""
    xp = rows.new_zeros((plan.padded_rows, rows.shape[1])).index_copy(0, dest, rows)
    row_expert = None
    if b_fc is not None or b_proj is not None:
        row_expert = plan.block_expert.long()[:, None].expand(plan.num_blocks, plan.block_rows).reshape(-1)
    h = grouped_gemm(xp, w_fc, plan)
    if b_fc is not None:
        h = h + b_fc.index_select(0, row_expert)
    h = act(h)
    y = grouped_gemm(h, w_proj, plan)
    if b_proj is not None:
        y = y + b_proj.index_select(0, row_expert)
    return y.index_select(0, dest)


def grouped_mlp(
    xs: torch.Tensor,
    sorted_experts: torch.Tensor,
    group_sizes: torch.Tensor,
    w_fc: torch.Tensor,
    b_fc: torch.Tensor | None,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor | None,
    act: Callable[[torch.Tensor], torch.Tensor],
    *,
    block_rows: int | None = None,
) -> torch.Tensor:
    """fc -> act -> proj for rows already sorted by expert id; returns rows in the same
    sorted order. `group_sizes` covers every bank of `w_fc`."""
    assignments = xs.shape[0]
    assert group_sizes.shape == (w_fc.shape[0],), (group_sizes.shape, w_fc.shape)
    plan, group_start = block_plan(group_sizes, assignments, block_rows)
    position = torch.arange(assignments, device=xs.device)
    dest = _padded_rows(plan, group_start, sorted_experts, position)
    return _padded_mlp(xs, dest, plan, w_fc, b_fc, w_proj, b_proj, act)


def experts_grouped(
    x: torch.Tensor,
    router_weights: torch.Tensor,
    selected_experts: torch.Tensor,
    w_fc: torch.Tensor,
    b_fc: torch.Tensor | None,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor | None,
    act: Callable[[torch.Tensor], torch.Tensor],
    num_experts: int,
    *,
    block_rows: int | None = None,
) -> torch.Tensor:
    """Dropless grouped-GEMM expert compute. x ``[T, d]``; router_weights /
    selected_experts ``[T, k]``; banks ``[E, d, f]`` / ``[E, f, d]``.

    The (token, rank) slots are stable-sorted by expert into the padded layout and the
    two grouped GEMMs run over it. Each slot's token row is placed straight from ``[T, k,
    d]`` (whose backward sums a token's k gradients in a fixed order, where a gather's
    backward would scatter-add them with atomics). The combine takes each slot's result
    back in slot order, multiplies by its gate in the compute dtype and sums over k in
    routing order (torch's sum: fp32 accumulation, one rounding). The JAX package
    scatter-adds the k products into a bf16 output in expert order instead, so bf16
    results differ by the rounding of that sum."""
    tokens, hidden = x.shape
    top_k = selected_experts.shape[-1]
    assignments = tokens * top_k
    flat = selected_experts.reshape(-1).long()
    order = torch.argsort(flat, stable=True)  # sorted position -> slot
    position = torch.empty_like(order).scatter_(0, order, torch.arange(assignments, device=x.device))
    group_sizes = torch.zeros(num_experts, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat)
    )
    plan, group_start = block_plan(group_sizes, assignments, block_rows)
    dest = _padded_rows(plan, group_start, flat, position)
    x_slots = x[:, None, :].expand(tokens, top_k, hidden).reshape(assignments, hidden)
    ys = _padded_mlp(x_slots, dest, plan, w_fc, b_fc, w_proj, b_proj, act).view(tokens, top_k, hidden)
    return (ys * router_weights.to(ys.dtype)[..., None]).sum(1)
