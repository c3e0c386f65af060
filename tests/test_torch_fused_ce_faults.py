"""`chip_smoke.py`'s fused_ce kernel cases against planted kernel faults.

The cases hold fused_ce against its plain version at the training paths' loss chunks
(dense [256, 2560] x [49152, 2560], with the vocabulary 83 short too; MoE [512, 1024] x
[49152, 1024]; alibi [512, 4096] x [50432, 4096]) and at small shapes (one row, H not a
multiple of 64, a one-column last vocab tile, a logit scale), in bf16 and fp32. Here the
kernel library is built from a copy of the sources with one fault planted in the bf16
`wgmma` kernel, and the cases must fail each broken build:

- the vocab-tail mask dropped: the zero-filled columns past V of the last tile enter
  the logsumexp;
- the label compared against the tile-local column: a label hits every tile, or none;
- the ring's last H stage skipped: the producer loads the last 64-wide slice of H from
  past the tensor's edge, so the copy engine fills it with zeros.

It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_fused_ce_faults.py
"""

import shutil

import pytest
import torch

pytestmark = pytest.mark.cuda

# fault -> (source file, the one source line it changes, its replacement)
FAULTS = {
    "vocab-tail mask dropped": (
        "fused_ce.cu",
        "      const bool tail = sm90::uniform(col0 + kCols > vocab);  // only the last tile has columns past V",
        "      const bool tail = false;",
    ),
    "label compared against the tile-local column": (
        "fused_ce.cu",
        "        const int off = label[h] - col0 - 2 * c;",
        "        const int off = label[h] - 2 * c;",
    ),
    "the ring's last H stage skipped": (
        "fused_ce.cu",
        "          const int k0 = kt * kDepth;",
        "          const int k0 = kt == num_k - 1 ? num_k * kDepth : kt * kDepth;",
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

    return chip_smoke.fused_ce_kernel_cases(0)


def _summary(cases):
    return [(c["shape"], c["dtype"], c["max_abs_err"], c["device_ms"]) for c in cases]


def test_fused_ce_cases_pass_the_kernel_as_it_is():
    print("no fault:", _summary(_cases()))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fused_ce_cases_fail_a_planted_fault(tmp_path, monkeypatch, fault):
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
