"""`chip_smoke.py`'s additive-bias / non-causal flash cases against planted kernel faults.

The cases hold the flash kernel's bias / non-causal form (forward and backward, bf16 and
fp32, at the alibi slice's layer shape: [2, 2048] rows of 32 heads of 128) against its
plain version. Here the kernel is built from a copy of the sources with one fault
planted, and the cases must fail each broken build:

- the bias not multiplied by log2(e): the scores run in log2 units, so the bias enters
  at ln 2 of its weight (forward and backward alike);
- the bias left out of the bf16 dQ pass's recompute of P: the forward and dK/dV stay
  right, and P no longer matches the saved logsumexp in dQ;
- the non-causal walk stopping at the diagonal: the forward and the dQ kernel skip the
  key tiles past the query tile's.

It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_alibi_faults.py
"""

import shutil

import pytest
import torch

pytestmark = pytest.mark.cuda

# fault -> (the one source line it changes, its replacement)
FAULTS = {
    "bias not times log2(e)": (
        "  return (key_bias - row_bias) * kLog2e;",
        "  return (key_bias - row_bias);",
    ),
    "bias left out of the dQ recompute": (
        "            if constexpr (kBias == kKeyBias) ds_exp += bias_log2(bk[col], row_bias[h]);  // the bias in dQ's P\n",
        "",
    ),
    "non-causal walk stops at the diagonal": (
        "  return kCausal ? qt + 1 : num_tiles;",
        "  return qt + 1;",
    ),
}


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _faulty_library(tmp_path, monkeypatch, fault):
    """Point the kernel build at a copy of the sources with `fault` planted."""
    from dolomite_engine_tpu_torch.ops.kernels import _build

    old, new = FAULTS[fault]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    source = csrc / "flash_attention.cu"
    text = source.read_text()
    assert text.count(old) == 1, f"the line of '{fault}' is not in the source once"
    source.write_text(text.replace(old, new))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()


def _cases():
    import chip_smoke

    return chip_smoke.alibi_kernel_cases(0)


def test_alibi_kernel_cases_pass_the_kernel_as_it_is():
    cases = _cases()
    print("no fault:", [(c["kernel"], c["shape"], c["dtype"], c["max_abs_err"]) for c in cases])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_alibi_kernel_cases_fail_a_planted_fault(tmp_path, monkeypatch, fault):
    from dolomite_engine_tpu_torch.ops.kernels import _build

    _faulty_library(tmp_path, monkeypatch, fault)
    try:
        with pytest.raises(AssertionError, match="disagrees with its plain version") as info:
            _cases()
        print(f"{fault}: {str(info.value)[:400]}")
    finally:
        monkeypatch.undo()
        _build.load_library.cache_clear()
        torch.cuda.empty_cache()
