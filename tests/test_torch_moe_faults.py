"""`chip_smoke.py`'s MoE training check against planted faults in the grouped GEMMs.

The check holds the kernel path's gradients against an fp32 plain reference, pooled, for
each parameter and for each expert's slice of a bank: the kernel path may err at most
1.5x the plain bf16 path. Here the backward of the grouped GEMM is broken on purpose
(dW of a bank or of one expert zeroed, dX of one expert's rows zeroed) and the check,
run at full width and 2 layers of the MoE slice's model, must fail each broken version.
It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_moe_faults.py
"""

import gc

import pytest
import torch

pytestmark = pytest.mark.cuda

D = 1024  # n_embd of the MoE slice: c_fc banks [E, D, 8192], c_proj banks [E, 4 * D, D]


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _faulty_tgmm(tgmm, k_dim, expert):
    """dW of the banks whose input width is `k_dim` (D: c_fc, 4 D: c_proj), zeroed for
    `expert` or, if None, for every expert."""

    def run(xp, dy, plan, num_experts, **kwargs):
        out = tgmm(xp, dy, plan, num_experts, **kwargs)
        if xp.shape[1] == k_dim:
            out[slice(None) if expert is None else expert] = 0
        return out

    return run


def _faulty_dx(gmm, out_dim, expert):
    """dX through the banks read transposed whose output width is `out_dim` (D: c_fc),
    zeroed on the rows of `expert`'s blocks."""

    def run(xp, w, plan, transpose_w=False):
        out = gmm(xp, w, plan, transpose_w)
        if transpose_w and out.shape[1] == out_dim:
            rows = (plan.block_expert == expert).repeat_interleave(plan.block_rows)
            out[rows] = 0
        return out

    return run


FAULTS = {
    "c_proj dW zeroed": ("tgmm", lambda f: _faulty_tgmm(f, 4 * D, None)),
    "c_proj dW of expert 0 zeroed": ("tgmm", lambda f: _faulty_tgmm(f, 4 * D, 0)),
    "c_fc dW of expert 0 zeroed": ("tgmm", lambda f: _faulty_tgmm(f, D, 0)),
    "c_fc dX of expert 0's rows zeroed": ("gmm", lambda f: _faulty_dx(f, D, 0)),
}


def _check():
    import chip_smoke

    return chip_smoke.training_paths_check(0, 2, chip_smoke.MOE_EP, (1, chip_smoke.MOE_TRAIN_SEQ))


def _worst(check):
    leaves = check["param_grad_rel_l2_err_vs_fp32"]
    leaf = max(leaves, key=lambda n: leaves[n]["kernel"] / leaves[n]["plain_bf16"])
    return {
        "max_grad_err_ratio_vs_fp32": check["max_grad_err_ratio_vs_fp32"],
        "worst_leaf": {leaf: leaves[leaf]},
        "pooled": [check["kernel_grad_rel_l2_err_vs_fp32"], check["plain_bf16_grad_rel_l2_err_vs_fp32"]],
    }


def test_moe_training_check_passes_the_kernels_as_they_are():
    print(f"no fault: {_worst(_check())}")


@pytest.mark.parametrize("fault", list(FAULTS))
def test_moe_training_check_fails_a_faulty_backward(monkeypatch, fault):
    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    name, plant = FAULTS[fault]
    monkeypatch.setattr(kmoe, name, plant(getattr(kmoe, name)))
    with pytest.raises(AssertionError, match="gradients off against the fp32 reference") as info:
        print(f"{fault} passed the check: {_worst(_check())}")
    message = str(info.value)
    print(f"{fault}: {message[: message.index('; {')]}")
    del info  # its traceback holds the check's model and gradients
    gc.collect()
    torch.cuda.empty_cache()
