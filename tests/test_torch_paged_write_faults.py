"""`chip_smoke.py`'s paged K/V write cases against planted kernel faults.

The cases (`chip_smoke.paged_write_kernel_cases`) hold rope_qkv's paged form and
kv_quant's fused scatter-quantize against the flat rope kernel followed by the plain
scatter and against their plain versions, at both served models' decode and prefill
windows (granite-3b-code's 32 heads of 80; the MoE model's 16 query heads over 8 kv heads
of 64; 16-token pages, max_len 2048) over bf16, int8 and fp8 pools. Here the kernel
library is built from a copy of the sources with one fault planted, and the cases must
fail each broken build:

- the fused scatter's absmax taken over all of a page's rows, so stale rows past the
  frontier (the largest of their pages in these cases) set the scale;
- the fused scatter's window page index one late;
- a masked pad row written: the key mask ignored by the pool write;
- the rotated K written one pool row early (the previous row's slot);
- V rotated like K (the rotation run over every head).

It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_paged_write_faults.py
"""

import shutil

import pytest
import torch

pytestmark = pytest.mark.cuda

# fault -> (source file, the one source line it changes, its replacement)
FAULTS = {
    "absmax over all rows": (
        "kv_quant.cu",
        "    if (first + r < start || written[r]) amax = fmaxf(amax, fabsf(value(r, i - r * a.head_dim)));",
        "    amax = fmaxf(amax, fabsf(value(r, i - r * a.head_dim)));",
    ),
    "window page one late": (
        "kv_quant.cu",
        "  const int64_t logical = start / w.page_size + blockIdx.y;",
        "  const int64_t logical = start / w.page_size + blockIdx.y + 1;",
    ),
    "masked pad row written": (
        "paged_write.cuh",
        "    if (p < 0 || p >= view_len() || !unmasked(b, p)) return -1;",
        "    if (p < 0 || p >= view_len()) return -1;",
    ),
    "rotated K one pool row early": (
        "rope_qkv.cu",
        "  store_vec<T, P, N>(static_cast<P*>(dst) + slot * kv_cols + kv_col, x);",
        "  store_vec<T, P, N>(static_cast<P*>(dst) + (slot - is_k) * kv_cols + kv_col, x);",
    ),
    "V rotated like K": (
        "rope_qkv.cu",
        "  const int rope_heads = a.num_heads + a.num_kv_heads;",
        "  const int rope_heads = a.num_heads + 2 * a.num_kv_heads;",
    ),
}


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


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

    return chip_smoke.paged_write_kernel_cases(0)


def test_paged_write_cases_pass_the_kernels_as_they_are():
    print("no fault:", [(c["kernel"], c["shape"], c["max_abs_err"]) for c in _cases()])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_paged_write_cases_fail_a_planted_fault(tmp_path, monkeypatch, fault):
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
