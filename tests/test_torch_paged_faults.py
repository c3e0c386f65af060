"""`chip_smoke.py`'s paged decode / prefill kernel cases against planted kernel faults.

The cases hold the paged decode and chunked-prefill kernels against their plain versions
at the serving slices' shapes (granite-3b-code's 32 heads of 80 and the MoE model's 16
query heads over 8 kv heads of 64, 16-token pages, max_len 2048), over bf16 pages in bf16
and fp32 and over int8 / fp8 pages. Here the kernel library is built from a copy of the
sources with one fault planted, and the cases must fail each broken build:

- the decode kernel's split merge without its exp(m_split - m) rescale: every split's
  partial weighs as if its maximum were the slot's;
- the prefill kernel's diagonal-tile mask off by one: each query also sees the key one
  past its frontier;
- the K scale of a staged tile's first page applied to all the tile's pages (the page
  walk both kernels share), so three of a 64-key tile's four pages score with another
  page's scale;
- the decode kernel's key span cut to a 4-row window: a verify window's fifth row (the
  one real row of each head's second 4-row block at W = K+1 = 5) misses its own key,
  which no case at W <= 4 can see.

It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_paged_faults.py
"""

import shutil

import pytest
import torch

pytestmark = pytest.mark.cuda

# fault -> (source file, the one source line it changes, its replacement)
FAULTS = {
    "split merge without its rescale": (
        "paged_attention.cu",
        "      const float w = exp2f(m_split - m_max);",
        "      const float w = 1.f;",
    ),
    "diagonal mask off by one": (
        "prefill_attention.cu",
        "        if (diagonal && k0 + col > frontier[h]) score = -INFINITY;",
        "        if (diagonal && k0 + col > frontier[h] + 1) score = -INFINITY;",
    ),
    "a tile's first K scale for all its pages": (
        "paged.cuh",
        "      cp_async_4(k_scale_dst + r, pool.k_scales + scale_row, valid);",
        "      cp_async_4(k_scale_dst + r, pool.k_scales + static_cast<int64_t>(table_row[k0 / pool.page_size]) *"
        " pool.num_kv_heads + pool.kv_head, valid);",
    ),
    "a verify window's fifth row short of its own key": (
        "paged_attention.cu",
        "  const int num_keys = min(length + args.width, view_len);  // positions the last row may see",
        "  const int num_keys = min(length + min(args.width, kQueries), view_len);",
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
    """The paged kernels' cases of chip_smoke's phase 2: bf16 / fp32 over bf16 pages at
    both served shapes, then over int8 / fp8 pages."""
    import chip_smoke

    return chip_smoke.paged_kernel_cases(0) + chip_smoke.quant_kernel_cases(0)


def _paged(cases):
    return [(c["kernel"], c["shape"], c["dtype"], c["max_abs_err"]) for c in cases if "attention" in c["kernel"]]


def test_paged_kernel_cases_pass_the_kernels_as_they_are():
    print("no fault:", _paged(_cases()))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_paged_kernel_cases_fail_a_planted_fault(tmp_path, monkeypatch, fault):
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
