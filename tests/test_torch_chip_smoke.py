"""`chip_smoke.py` on the CPU: without a card it prints no result and exits non-zero, and
its `pretrain` phase's control flow (the YAML's cuts, the corpus, `pretrain.main`, the
telemetry windows, the checkpoint and the 2-layer resume check, bit-identical) runs at
tiny widths through the kernels' plain versions."""

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
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    rehearsal = {"model": dict(n_embd=64, n_head=4, n_inner=128, vocab_size=512), "sequence_length": 128}
    record, launches = chip_smoke.pretrain_phase(0, device="cpu", rehearsal=rehearsal)
    assert record["losses"][-1] < record["losses"][0]
    assert record["checkpoint"]["consumed_samples"] == 2 * chip_smoke.PRETRAIN_STEPS
    assert [w["at_step"] for w in record["goodput_windows"]] == list(range(1, chip_smoke.PRETRAIN_STEPS + 1))
    assert record["resume_check"]["bit_identical"] and record["resume_check"]["batches_identical"]
    assert not any(launches.values())  # the plain versions ran
    assert record["expected_launches"]["fused_ce"] == 24  # 16 micro-batches + 8 eval batches, one chunk each
