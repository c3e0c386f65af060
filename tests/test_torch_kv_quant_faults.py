"""`chip_smoke.py`'s quantized check against planted faults in the quantized KV path.

The check chunk-prefills a prompt and decodes 4 tokens into a fresh int8 pool through the
kernel path and through the plain versions of kv_quant and the paged decode / prefill
attention. It holds layer 0's pool bytes identical, layer 0's attention and the last
position's logits close, and a page of rounding ties to the plain bytes. Here the kernel
path is broken on purpose and the check, run on granite-3b-code at full width and 2
layers, must fail each broken version:

- the V scales ignored: the attention kernels read every V scale as 1.0;
- another page's scale read: each page's K and V scales taken from the next page's row;
- int8 rounding done with ``roundf`` (halves away from zero) in the kv_quant kernel,
  built from a copy of the sources with that one call changed.

It needs the card (the kernels have no CPU mode) and imports no JAX:

    python -m pytest --noconftest -q -rP -m cuda tests/test_torch_kv_quant_faults.py
"""

import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

PROMPT, DECODED = 700, 4


def _skip_without_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


@pytest.fixture(autouse=True)
def _cuda():
    _skip_without_a_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def model():
    _skip_without_a_card()  # a module fixture is set up before the autouse one
    import chip_smoke
    from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class

    config = config_from_dict(dict(chip_smoke.GRANITE_3B_CODE, n_layer=2))
    return get_model_class(config.model_type)(config, dtype=torch.bfloat16, device="cuda", seed=0)


def _check(model):
    import chip_smoke

    rs = np.random.RandomState(0)
    tokens = rs.randint(1, model.config.vocab_size, PROMPT + DECODED).tolist()
    return chip_smoke.quantized_check(model, tokens, PROMPT)


def _summary(check):
    return {
        key: check[key]
        for key in ("layer0_pool_bytes_identical", "layer0_attention_rel_l2_err", "tie_page_codes_identical", "last_position")
    }


def _attention_with(scales_fault):
    """Both attention kernels of the model with `scales_fault(k_scales, v_scales)` applied
    to the scale pools they are handed."""
    from dolomite_engine_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
    from dolomite_engine_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention

    def wrap(kernel):
        def run(q, k_pages, v_pages, table, index, scale, k_scales=None, v_scales=None):
            if k_scales is not None:
                k_scales, v_scales = scales_fault(k_scales, v_scales)
            return kernel(q, k_pages, v_pages, table, index, scale, k_scales, v_scales)

        return run

    return {"paged_decode_attention": wrap(paged_decode_attention), "paged_prefill_attention": wrap(paged_prefill_attention)}


def _roundf_library(tmp_path, monkeypatch):
    """Point the kernel build at a copy of the sources whose kv_quant rounds with roundf."""
    from dolomite_engine_tpu_torch.ops.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    source = csrc / "kv_quant.cu"
    text = source.read_text()
    assert text.count("rintf(q)") == 1
    source.write_text(text.replace("rintf(q)", "roundf(q)"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()


FAULTS = {
    "V scales ignored": lambda ks, vs: (ks, torch.ones_like(vs)),
    "another page's scale read": lambda ks, vs: (ks.roll(-1, 0), vs.roll(-1, 0)),
}


def test_quantized_check_passes_the_kernels_as_they_are(model):
    print(f"no fault: {_summary(_check(model))}")


@pytest.mark.parametrize("fault", list(FAULTS))
def test_quantized_check_fails_a_scale_fault(model, monkeypatch, fault):
    from dolomite_engine_tpu_torch.models import modeling_utils

    for name, faulty in _attention_with(FAULTS[fault]).items():
        monkeypatch.setattr(modeling_utils, name, faulty)
    with pytest.raises(AssertionError) as info:
        print(f"{fault} passed the check: {_summary(_check(model))}")
    print(f"{fault}: {str(info.value)[:400]}")


def test_quantized_check_fails_roundf_rounding(model, tmp_path, monkeypatch):
    from dolomite_engine_tpu_torch.ops.kernels import _build

    _roundf_library(tmp_path, monkeypatch)
    try:
        with pytest.raises(AssertionError, match="rounds a tie") as info:
            print(f"roundf passed the check: {_summary(_check(model))}")
        print(f"roundf: {str(info.value)[:400]}")
    finally:
        monkeypatch.undo()
        _build.load_library.cache_clear()
