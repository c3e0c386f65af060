"""`chip_smoke.py` on the CPU: without a card it prints no result and exits non-zero, and
its `pretrain` phase's control flow (the YAML's cuts, the corpus, `pretrain.main`, the
telemetry windows, the checkpoint and the 2-layer resume check, bit-identical), the
`generate` phase inside it (`generate.main` over `configs/generation.yml` from that
checkpoint with both engines, the greedy runs three ways, the logits check) and the
`alibi_generation` phase run at tiny widths through the kernels' plain versions."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run hundreds of small steps, and under the suite's
    parallel workers torch's spinning thread pool, oversubscribed, runs them many times
    slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode != 0 and result.stdout == ""
    assert "no CUDA device" in result.stderr


def test_pretrain_phase_rehearsal(monkeypatch):
    """Phase 12 with phase 13 inside it: the generation entry point from the checkpoint."""
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    rehearsal = {"model": dict(n_embd=64, n_head=4, n_inner=128, vocab_size=512), "sequence_length": 128, "new_tokens": 8, "longest_prompt": 256}
    record, launches, (generation, generate_launches) = chip_smoke.pretrain_phase(0, device="cpu", rehearsal=rehearsal)
    assert record["losses"][-1] < record["losses"][0]
    assert record["checkpoint"]["consumed_samples"] == 2 * chip_smoke.PRETRAIN_STEPS
    assert [w["at_step"] for w in record["goodput_windows"]] == list(range(1, chip_smoke.PRETRAIN_STEPS + 1))
    assert record["resume_check"]["bit_identical"] and record["resume_check"]["batches_identical"]
    assert not any(launches.values())  # the plain versions ran
    assert record["expected_launches"]["fused_ce"] == 24  # 16 micro-batches + 8 eval batches, one chunk each
    # phase 13: two sampled runs of the 32 prompts, then 16 greedy prompts three ways
    assert generation["paged_sampled"]["requests"] == generation["dense_sampled"]["requests"] == chip_smoke.GENERATION_PROMPTS
    assert max(generation["prompt_tokens"]) == 256 and generation["dense_sampled"]["pool_max_len"] == 256 + 8
    assert generation["greedy_agreement"]["paged_vs_dense"] > 0.9
    assert generation["greedy_agreement"]["dense_vs_generate_tokens"] > 0.9
    assert [c["decode_steps"] for c in generation["logits_check"].values()] == [4, 4]
    assert generation["dense_sampled"]["load_seconds"].keys() == {"build", "read", "cast"}
    assert not any(generate_launches.values())
    expected = generation["expected_launches"]
    assert expected["paged_decode_attention"] > 0 and expected["flash_attn_fwd"] > 0 and expected["rope_qkv"] > 0


def test_alibi_generation_phase_rehearsal(monkeypatch):
    """Phase 14 at a tiny MPT-like width: both engines over alibi, their agreement, and the
    logits of one request through each engine against the plain forward."""
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    tiny = dict(chip_smoke.MPT_7B, n_embd=64, n_head=4, n_inner=128, vocab_size=512, n_layer=2)
    record, launches = chip_smoke.alibi_generation_phase(0, device="cpu", config_kwargs=tiny)
    assert record["dense"]["completed"] == record["paged"]["completed"] == chip_smoke.ALIBI_GENERATION_SLOTS
    assert record["greedy_agreement_dense_vs_paged"] > 0.9
    assert record["expected_launches"]["flash_attn_bias_fwd"] == 2 * chip_smoke.ALIBI_GENERATION_SLOTS
    assert [c["engine"] for c in record["logits_check"].values()] == ["paged", "dense"]
    assert not any(launches.values())
