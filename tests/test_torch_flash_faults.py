"""`chip_smoke.py`'s flash attention cases and the rmsnorm kernel cases against planted
kernel faults.

The flash cases hold the bf16 `wgmma` kernels (forward, dK/dV and dQ passes) and the fp32
tiles against their plain versions at the training slices' layers: granite-3b-code's
[1, 4096, 32 heads of 80] over packed documents, a GQA case [2, 1024, 8 / 2 heads of 128]
and the MoE slice's [2, 2048, 16 / 8 heads of 64]. Here the kernel library is built from a
copy of the sources with one fault planted, and the cases must fail each broken build:

- the causal diagonal mask dropped in the forward's `wgmma` path: the diagonal tile's
  keys past each query row enter its softmax;
- the segment-range skip off by one tile: the forward starts its walk one tile past the
  first key tile that meets the query block;
- the head dim 80 tail not zero-filled: the box past column 80 is filled with NaN rather
  than zeros, and Q K^T reduces over the padded panel. (The kernels' products stop at
  column 80, five k16 steps and N = 80, so the fill alone never enters a result: the
  fault is what a reduction over the padding would compute without the zero fill.);
- the dK/dV pass reading the wrong q head of its GQA group: its producer loads Q, dO and
  the row statistics of the group's first head for every item. (Loading another head of
  the group in a different item would not show: dK and dV sum over the whole group.);
- rmsnorm's vector tail dropped: the last, partial round of a row's 16-byte accesses
  (the rows of 32, 1004 and 601 elements; the slices' widths fill whole rounds, so the
  rmsnorm cases here are those of the CUDA tests).

It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_flash_faults.py
"""

import shutil

import pytest
import torch

pytestmark = pytest.mark.cuda

# fault -> (cases it must fail, [(source file, the one line it changes, its replacement)])
FAULTS = {
    "causal diagonal mask dropped": (
        "flash",
        [(
            "flash_attention.cu",
            "if (!((!kCausal || kt * kTile + col <= rows[h]) & (sk[col] == row_seg[h]))) x = -INFINITY;",
            "if (!(sk[col] == row_seg[h])) x = -INFINITY;",
        )],
    ),
    "segment-range skip off by one tile": (
        "flash",
        [(
            "flash_attention.cu",
            "const int window = min(rf.z, rl.z);  // the first key tile",
            "const int window = min(rf.z, rl.z) + 1;  // the first key tile",
        )],
    ),
    "head dim 80 tail not zero-filled": (
        "flash",
        [
            ("sm90.cuh", "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE", "CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA"),
            ("flash_attention.cu", "static constexpr int kSteps = D / 16;", "static constexpr int kSteps = kPanels * 4;"),
        ],
    ),
    "dK/dV pass reads the wrong q head of its group": (
        "flash",
        [(
            "flash_attention.cu",
            "        const int head = kv_head * group + p / num_tiles;",
            "        const int head = kv_head * group;",
        )],
    ),
    "rmsnorm vector tail dropped": (
        "rmsnorm",
        [("rmsnorm.cu", "const int chunks = dim / kElems;", "const int chunks = dim / kElems / 32 * 32;")],
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

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    for name, old, new in FAULTS[fault][1]:
        source = csrc / name
        text = source.read_text()
        assert text.count(old) == 1, f"a line of '{fault}' is not in {name} once"
        source.write_text(text.replace(old, new))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()


def _rmsnorm_cases():
    """rmsnorm rows whose last round of accesses is partial, bf16 and fp32, within the
    kernel cases' tolerance (2 bf16 ulp; 1e-5)."""
    import chip_smoke
    from dolomite_engine_tpu_torch.ops.kernels import rmsnorm

    cases = []
    for rows, dim in ((21, 32), (8, 1004), (7, 601)):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randn((rows, dim), generator=g, device="cuda").to(dtype)
            w = torch.randn((dim,), generator=g, device="cuda") * 0.1 + 1.0
            got = rmsnorm.fused_rmsnorm(x, w, 1e-5).float()
            want = rmsnorm.fused_rmsnorm_plain(x, w, 1e-5).float()
            diff = (got - want).abs()
            bound = 1e-5 + 1e-5 * want.abs() if dtype == torch.float32 else 2 * chip_smoke._bf16_ulp(want)
            case = ("rmsnorm", f"[{rows},{dim}]", str(dtype), torch.nan_to_num(diff, nan=float("inf")).max().item())
            if not bool((diff <= bound).all()):
                raise AssertionError(f"rmsnorm [{rows},{dim}] {dtype} disagrees with its plain version: {case}")
            cases.append(case)
    return cases


def _cases(family):
    import chip_smoke

    if family == "rmsnorm":
        return _rmsnorm_cases()
    cases = chip_smoke.training_kernel_cases(0)
    return [(c["kernel"], c["shape"][:40], c["dtype"], c["max_abs_err"]) for c in cases]


def test_flash_and_rmsnorm_cases_pass_the_kernels_as_they_are():
    print("no fault:", _cases("flash"), _cases("rmsnorm"))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_flash_and_rmsnorm_cases_fail_a_planted_fault(tmp_path, monkeypatch, fault):
    from dolomite_engine_tpu_torch.ops.kernels import _build

    _faulty_library(tmp_path, monkeypatch, fault)
    try:
        with pytest.raises(AssertionError, match="disagrees with its plain version") as info:
            _cases(FAULTS[fault][0])
        print(f"{fault}: {str(info.value)[:400]}")
    finally:
        monkeypatch.undo()
        _build.load_library.cache_clear()
        torch.cuda.empty_cache()
