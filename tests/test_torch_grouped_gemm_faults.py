"""`chip_smoke.py`'s grouped-GEMM kernel cases against planted kernel faults.

The cases hold gmm (forward and dX over the banks read transposed) and tgmm (dW in fp32
and in the bank's bf16) against their plain versions at the MoE slice's shapes (32
experts, c_fc banks [32, 1024, 8192], c_proj [32, 4096, 1024]; decode, prefill-chunk and
training row counts, and most experts empty), in bf16 and fp32, with padding rows that
hold nonzero values. Here the kernel library is built from a copy of the sources with one
fault planted in the wgmma path, and the cases must fail each broken build:

- tgmm's last-stage row zeroing dropped: the rows past an expert's count (padding, or at
  bm < 64 the next expert's rows) enter its dW;
- gmm's epilogue row mask dropped: padding rows are written as their products, not zeros;
- the producer loading the bank of the previous block's expert.

It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_grouped_gemm_faults.py
"""

import shutil

import pytest
import torch

pytestmark = pytest.mark.cuda

# fault -> (source file, the one source line it changes, its replacement)
FAULTS = {
    "tgmm last-stage row zeroing dropped": (
        "grouped_gemm.cu",
        "        if (st == num_s - 1 && tail < kDepth) {",
        "        if (false) {",
    ),
    "gmm epilogue row mask dropped": (
        "grouped_gemm.cu",
        "      const uint4 value = row < rows_real ? *reinterpret_cast<const uint4*>(st + rr * kLd + v * kVecElems)",
        "      const uint4 value = true ? *reinterpret_cast<const uint4*>(st + rr * kLd + v * kVecElems)",
    ),
    "the previous block's bank": (
        "grouped_gemm.cu",
        "      const int e = block_expert[b];",
        "      const int e = block_expert[max(b - 1, 0)];",
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

    name, old, new = FAULTS[fault]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    source = csrc / name
    text = source.read_text()
    assert text.count(old) == 1, f"the line of '{fault}' is not in {name} once"
    source.write_text(text.replace(old, new))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()


def _cases():
    import chip_smoke

    return chip_smoke.moe_kernel_cases(0)


def _summary(cases):
    return [(c["kernel"], c["shape"][:48], c["dtype"], c.get("path"), c["max_abs_err"]) for c in cases]


def test_grouped_gemm_cases_pass_the_kernels_as_they_are():
    print("no fault:", _summary(_cases()))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_grouped_gemm_cases_fail_a_planted_fault(tmp_path, monkeypatch, fault):
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
