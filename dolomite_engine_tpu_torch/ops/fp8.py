"""fp8 training with delayed scaling.

Counterpart of `dolomite_engine_tpu/ops/fp8.py`, whose numerics are flax's `fp8_ops`
(flax 0.12.3): every `ParameterizedLinear` runs `Fp8DirectDotGeneralOp`'s product (`fp8_dot`:
the input and the kernel quantized to e4m3, the output gradient to e5m2, each with a
per-tensor scale from an amax history of 1024 steps), and the operands of the products no
dot op can take, the tied LM head's and the expert banks' with their tokens, are e4m3
quantize-dequantized up front (`fp8_qdq`, flax's ``in_qdq``) and go to the hand-written
kernels (fused_ce, the grouped GEMMs) in the compute dtype.

flax's order is kept exactly: `update_fp8_meta` takes the new scale from the history the
step begins with and rolls this tensor's amax into it; `quantize` divides in the compute
dtype, then clips, then casts. The dequantizing product (`fp8_product`) is one function with
two plain forms, chosen by the tensor's device: for CUDA tensors ``torch._scaled_mm`` (fp32
accumulation, the fp32 scales applied before the single rounding to the output dtype;
e4m3 x e4m3 forward, e5m2 x e4m3 dgrad, e4m3 x e5m2 wgrad); for CPU tensors the product of
the quantized values cast up to fp32, rounded to the output dtype and scaled there, as
XLA computes flax's dot and ``out_dq`` on the CPU.

The state (`Fp8State`, JAX's ``TrainState.fp8``) is an explicit set of tensors. A forward
and its backward read the state the step (or micro-batch) began with and stage the next
one; the train step commits it after the micro-batch's backward and restores the state
the step began with when it skips a non-finite step. So a rematted block's recompute and
every use within one micro-batch see the same state, as JAX's functional state does.
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
AMAX_HISTORY_LENGTH = 1024  # Fp8DirectDotGeneralOp's amax_history_length
# the variables of one fp8 dot, flax's names
DOT_VARIABLES = (
    "input_amax_history",
    "kernel_amax_history",
    "output_grad_amax_history",
    "input_scale",
    "kernel_scale",
    "output_grad_scale",
)


def fp8_max(q_dtype: torch.dtype) -> float:
    """The largest finite value of `q_dtype` (448 for e4m3, 57344 for e5m2): exact in bf16
    and fp32, so a Python float bounds a tensor of either dtype as flax's cast maximum
    does, with no host-to-device copy."""
    return float(torch.finfo(q_dtype).max)


def quantize(x: torch.Tensor, q_dtype: torch.dtype, scale: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """flax's `quantize`: ``clip(x / scale, -max, max)`` in the compute dtype, cast to
    `q_dtype`."""
    dtype_max = fp8_max(q_dtype)
    scaled = x / scale.to(compute_dtype)
    return torch.clamp(scaled, -dtype_max, dtype_max).to(q_dtype)


def dequantize(x: torch.Tensor, dq_dtype: torch.dtype, scale: torch.Tensor) -> torch.Tensor:
    return x.to(dq_dtype) * scale.to(dq_dtype)


def qdq(x: torch.Tensor, q_dtype: torch.dtype, scale: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return dequantize(quantize(x, q_dtype, scale, compute_dtype), x.dtype, scale)


def compute_scale(amax: torch.Tensor, scale: torch.Tensor, fp8_max_value: float, margin: int = 0) -> torch.Tensor:
    """flax's `compute_scale`: ``1 / ((fp8_max / amax) / 2^margin)``, the old scale where
    the amax is 0 or not finite; fp32."""
    scale = 1.0 / scale
    # a true division, as XLA's: `float / tensor` is a reciprocal times the float in torch
    sf = torch.full_like(amax, fp8_max_value) / amax
    if margin:
        sf = sf / (2**margin)
    sf = torch.where(amax > 0.0, sf, scale)
    sf = torch.where(torch.isfinite(amax), sf, scale)
    return 1.0 / sf


def compute_amax_history(x: torch.Tensor, amax_history: torch.Tensor) -> torch.Tensor:
    """flax's `compute_amax_history`: the history rolled back one step
    (``jnp.roll(h, -1)``), its first entry then set to this tensor's amax (from its
    extremes: |x| exactly, with no copy of `x`)."""
    low, high = torch.aminmax(x)
    amax_update = torch.maximum(-low, high).abs().to(amax_history.dtype)  # abs: a NaN's sign too
    return torch.cat([amax_update.reshape(1), amax_history[2:], amax_history[:1]])[: amax_history.numel()]


def update_fp8_meta(x: torch.Tensor, q_dtype: torch.dtype, scale: torch.Tensor, amax_history: torch.Tensor):
    """flax's `update_fp8_meta`: (the scale from the history before this tensor, the
    history with this tensor's amax)."""
    new_scale = compute_scale(amax_history.max(), scale, fp8_max(q_dtype))
    return new_scale, compute_amax_history(x, amax_history)


def _round_up(n: int, multiple: int = 16) -> int:
    return -(-n // multiple) * multiple


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """`t` zero-padded to [rows, cols], row-major (a no-op copy-free view when it fits)."""
    if t.shape == (rows, cols):
        return t.contiguous()
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[: t.shape[0], : t.shape[1]].copy_(t)
    return out


def scaled_mm(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor, b_scale: torch.Tensor, out_dtype: torch.dtype):
    """``(a * a_scale) @ (b * b_scale)`` in `out_dtype` through ``torch._scaled_mm`` (CUDA
    tensors): `a` [M, K] row-major, `b` [K, N] column-major, each dimension zero-padded
    to a multiple of 16 where it is not one."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _round_up(m), _round_up(k), _round_up(n)
    a = _padded(a, mp, kp)
    b = _padded(b.t(), np_, kp).t()  # column-major [K, N]
    out = torch._scaled_mm(
        a, b, scale_a=a_scale.reshape(()).float(), scale_b=b_scale.reshape(()).float(), out_dtype=out_dtype
    )
    return out[:m, :n]


def fp8_product_plain(a, b, a_scale, b_scale, out_dtype):
    """The product over the quantized values cast up to fp32, rounded to `out_dtype`, then
    scaled in `out_dtype` by ``a_scale * b_scale`` (flax's dot and ``out_dq`` as XLA
    computes them on the CPU)."""
    out = (a.float() @ b.float()).to(out_dtype)
    return dequantize(out, out_dtype, a_scale * b_scale)


def fp8_product(a, b, a_scale, b_scale, out_dtype):
    """``(a * a_scale) @ (b * b_scale)`` of fp8 `a` [M, K] and `b` [K, N] in `out_dtype`:
    ``torch._scaled_mm`` for CUDA tensors, `fp8_product_plain` for CPU tensors."""
    if a.device.type == "cuda":
        return scaled_mm(a, b, a_scale, b_scale, out_dtype)
    if a.device.type != "cpu":
        raise ValueError(f"fp8_product runs on CUDA or CPU tensors, got {a.device}")
    return fp8_product_plain(a, b, a_scale, b_scale, out_dtype)


class Fp8State:
    """The delayed-scaling state of a model's fp8 dots and quantize-dequantize points:
    `tensors` by name (the module's path, then flax's variable name), read by the forward
    and the backward; `staged`, the next state, which `commit` writes into `tensors`."""

    def __init__(self, tensors: dict[str, torch.Tensor]) -> None:
        self.tensors = tensors
        self.staged: dict[str, torch.Tensor] = {}
        # data-parallel ranks: each saw only its rows, so the staged amax updates are
        # reduced (max) over `group` at the commit; the rest of the staged state is the
        # same on every rank, which the max keeps
        self.group = None

    def commit(self) -> None:
        with torch.no_grad():
            if self.group is not None and self.staged:
                self._reduce_staged()
            for key, value in self.staged.items():
                self.tensors[key].copy_(value)
        self.staged.clear()

    def _reduce_staged(self) -> None:
        """One max all-reduce of every staged tensor, so every rank commits the amax of
        the global batch, as GSPMD takes it over the batch-sharded tensor."""
        import torch.distributed as dist

        keys = list(self.staged)
        flat = torch.cat([self.staged[key].float().reshape(-1) for key in keys])
        dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=self.group)
        for key, part in zip(keys, flat.split([self.staged[key].numel() for key in keys])):
            self.staged[key] = part.reshape(self.staged[key].shape).to(self.staged[key].dtype)

    def snapshot(self) -> dict[str, torch.Tensor]:
        return {key: value.clone() for key, value in self.tensors.items()}

    def restore(self, snapshot: dict[str, torch.Tensor]) -> None:
        self.staged.clear()
        with torch.no_grad():
            for key, value in snapshot.items():
                self.tensors[key].copy_(value)

    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors.values())


class Fp8Slot:
    """One module's view of the state: its variables under `prefix`."""

    def __init__(self, state: Fp8State, prefix: str) -> None:
        self.state = state
        self.prefix = prefix

    def get(self, name: str) -> torch.Tensor:
        return self.state.tensors[self.prefix + name]

    def stage(self, **values: torch.Tensor) -> None:
        for name, value in values.items():
            self.state.staged[self.prefix + name] = value.detach()


def enable_fp8(model: torch.nn.Module, history_length: int = AMAX_HISTORY_LENGTH) -> Fp8State:
    """Give `model` a fresh fp8 state (scales 1, histories 0, fp32, on the model's device)
    and point each fp8 module at it: a module with ``fp8_dot`` (`ParameterizedLinear`)
    gets flax's six dot variables, one with ``fp8_qdq_names`` a scale and a history per
    name."""
    device = next(model.parameters()).device
    tensors: dict[str, torch.Tensor] = {}
    state = Fp8State(tensors)
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        variables = DOT_VARIABLES if getattr(module, "fp8_dot", False) else tuple(
            f"{qdq_name}_{kind}" for qdq_name in getattr(module, "fp8_qdq_names", ()) for kind in ("scale", "amax_history")
        )
        for variable in variables:
            if variable.endswith("scale"):
                tensors[prefix + variable] = torch.ones(1, dtype=torch.float32, device=device)
            else:
                tensors[prefix + variable] = torch.zeros(history_length, dtype=torch.float32, device=device)
        if variables:
            module.fp8 = Fp8Slot(state, prefix)
    return state


class _Fp8Dot(torch.autograd.Function):
    """`Fp8DirectDotGeneralOp` of ``x [M, K] @ w.T`` (`w` [N, K]): forward e4m3 x e4m3,
    backward the e5m2 output gradient against each quantized operand."""

    @staticmethod
    def forward(ctx, x, w, in_scale, in_history, k_scale, k_history, g_scale, g_history, slot, record):
        compute_dtype = x.dtype
        new_in_scale, new_in_history = update_fp8_meta(x, E4M3, in_scale, in_history)
        q_x = quantize(x, E4M3, new_in_scale, compute_dtype)
        new_k_scale, new_k_history = update_fp8_meta(w, E4M3, k_scale, k_history)
        q_w = quantize(w, E4M3, new_k_scale, compute_dtype)
        if record:
            slot.stage(
                input_scale=new_in_scale, input_amax_history=new_in_history,
                kernel_scale=new_k_scale, kernel_amax_history=new_k_history,
            )
        ctx.save_for_backward(q_x, q_w, new_in_scale, new_k_scale, g_scale, g_history)
        ctx.slot = slot
        return fp8_product(q_x, q_w.t(), new_in_scale, new_k_scale, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        q_x, q_w, in_scale, k_scale, g_scale, g_history = ctx.saved_tensors
        new_g_scale, new_g_history = update_fp8_meta(g, E5M2, g_scale, g_history)
        q_g = quantize(g, E5M2, new_g_scale, g.dtype)
        ctx.slot.stage(output_grad_scale=new_g_scale, output_grad_amax_history=new_g_history)
        grad_x = fp8_product(q_g, q_w, new_g_scale, k_scale, g.dtype)  # [M, K], e5m2 x e4m3
        grad_w = fp8_product(q_x.t(), q_g, in_scale, new_g_scale, g.dtype).t()  # e4m3 x e5m2
        return grad_x, grad_w, None, None, None, None, None, None, None, None


def fp8_dot(x: torch.Tensor, w: torch.Tensor, slot: Fp8Slot) -> torch.Tensor:
    """``x @ w.T`` through the fp8 dot of `slot`'s module, any leading dims on `x`. Under
    no_grad (eval, generation) the state is read and left as it is."""
    lead = x.shape[:-1]
    y = _Fp8Dot.apply(
        x.reshape(-1, x.shape[-1]), w,
        slot.get("input_scale"), slot.get("input_amax_history"),
        slot.get("kernel_scale"), slot.get("kernel_amax_history"),
        slot.get("output_grad_scale"), slot.get("output_grad_amax_history"), slot, torch.is_grad_enabled(),
    )
    return y.reshape(*lead, w.shape[0])


class _Fp8QDQ(torch.autograd.Function):
    """flax's ``in_qdq``: e4m3 quantize-dequantize with the updated scale; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x, scale, history, slot, name, record):
        new_scale, new_history = update_fp8_meta(x, E4M3, scale, history)
        if record:
            slot.stage(**{f"{name}_scale": new_scale, f"{name}_amax_history": new_history})
        return qdq(x, E4M3, new_scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None, None


def fp8_qdq(x: torch.Tensor, slot: Fp8Slot, name: str) -> torch.Tensor:
    """`x` e4m3 quantize-dequantized under `slot`'s point `name` (JAX's `Fp8QDQ`)."""
    return _Fp8QDQ.apply(
        x, slot.get(f"{name}_scale"), slot.get(f"{name}_amax_history"), slot, name, torch.is_grad_enabled()
    )
