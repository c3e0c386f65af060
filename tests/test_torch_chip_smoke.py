"""`chip_smoke.py` on the CPU: without a card it prints no result and exits non-zero, and
its `pretrain` phase's control flow (the YAML's cuts, the corpus, `pretrain.main`, the
telemetry windows, the checkpoint and the 2-layer resume check, bit-identical), the
`training_options` phase inside it (the remat policies, fp8, offload and health, the
optimizers), the `generate` phase inside it (`generate.main` over `configs/generation.yml` from that
checkpoint with both engines, the greedy runs three ways, the logits check), the
`speculative_generation`, `preemption`, `finetune` and `interop` phases after it, the `alibi_generation`
phase, the `distribution` phase (every ZeRO stage through FSDP2 at a world of one) and the
`seq2seq` phase (the encoder-decoder family through `finetune.main` and `generate.main`, and
its query-bias kernel check) run at tiny widths (and 2 layers) through the kernels' plain
versions."""

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
    """Phase 12 with phases 13, 15, 16 and 23 inside it: the generation entry point from the
    checkpoint, with speculation, with preemption and over the serving fleet."""
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    rehearsal = {
        "model": dict(n_embd=64, n_head=4, n_inner=128, vocab_size=512), "sequence_length": 128, "new_tokens": 8,
        "longest_prompt": 256, "preempt_pages": 96, "finetune_words": (4, 40),
    }
    # every run of the YAML at 2 of its 32 layers, the resume check's count: each phase's
    # control flow in a fifth of the time
    build = chip_smoke.pretrain_args
    monkeypatch.setattr(chip_smoke, "pretrain_args", lambda *args, n_layer=None, **kwargs: build(*args, n_layer=n_layer or 2, **kwargs))
    record, launches, options_launches, (generation, generate_launches), speculated, preempted = chip_smoke.pretrain_phase(
        0, device="cpu", rehearsal=rehearsal
    )
    assert record["losses"][-1] < record["losses"][0]
    assert record["checkpoint"]["consumed_samples"] == 2 * chip_smoke.PRETRAIN_STEPS
    assert [w["at_step"] for w in record["goodput_windows"]] == list(range(1, chip_smoke.PRETRAIN_STEPS + 1))
    assert record["resume_check"]["bit_identical"] and record["resume_check"]["batches_identical"]
    assert not any(launches.values())  # the plain versions ran
    assert record["expected_launches"]["fused_ce"] == 24  # 16 micro-batches + 8 eval batches, one chunk each
    # the YAML's remat (every 2nd block; of 2 layers, block 0) reruns under save_dots, its
    # kernels with it
    assert record["remat"]["policy"] == "save_dots" and record["remat"]["rematted_blocks"] == 1
    assert record["expected_launches"]["rmsnorm"] == 16 * (2 * 2 + 1 + 2 * 1) + 8 * (2 * 2 + 1)
    # phase 17: the training options on the same corpus
    options = record["training_options"]
    remat = options["remat_policies"]
    assert [r["policy"] for r in remat["runs"]] == list(chip_smoke.OPTION_POLICIES)
    assert not any(remat["max_gap_to_full"].values())
    assert options["fp8"]["mean_loss_rel_gap_to_bf16"] <= chip_smoke.FP8_LOSS_BOUND
    assert options["fp8"]["moe"]["losses"][1] < options["fp8"]["moe"]["losses"][0]
    step_check = options["fp8"]["step_check"]  # the card's fp8 steps against the CPU's: both on the CPU here
    for run in (step_check["lr_0"], step_check["lr"]):
        assert len(run["card_losses"]) == chip_smoke.FP8_STEP_STEPS and run["card_losses"] == run["cpu_losses"]
        assert not any(run["max_rel_err"].values())
    assert set(step_check["lr_0"]["bounds"]) == set(step_check["lr_0"]["max_rel_err"])
    assert len(options["fp8"]["grad_norm_ratio_to_bf16_steps_1_2"]) == 2
    assert options["offload_and_health"]["bit_identical_to_pretrain"]
    assert options["baseline"]["steps"] == chip_smoke.PRETRAIN_STEPS and options["offload_and_health"]["steps"] == chip_smoke.OFFLOAD_STEPS
    assert options["fp8"]["bf16_losses"] == options["baseline"]["losses"]  # (b)-(d) against phase 12's run at their depth
    assert options["offload_and_health"]["health_steps"] == [1, 2, 3]
    parity = options["optimizers"]["parity"]["by_name"]
    assert len(parity) == 23 and "raises" in parity["TorchLBFGS"] and "raises" in parity["TorchRprop"]
    assert all(r["max_rel_err"] == 0 for r in parity.values() if "raises" not in r)  # both sides on the CPU
    assert not any(options_launches.values())
    # phase 23: the fleet over 2 replicas, disaggregated with tracing, int8 handoffs, a crash,
    # threads and the off path, at 2 layers
    fleet = record["fleet"]
    assert fleet["replicas_run"]["per_replica_routed"] == {0: 8, 1: 8} and not fleet["replicas_run"]["parted_from_paged_greedy"]
    assert fleet["disaggregated_run"]["traces"] == fleet["disaggregated_run"]["handoffs"] == chip_smoke.GREEDY_PROMPTS
    assert fleet["disaggregated_run"]["critical_path_max_gap"] <= 0.05
    assert fleet["int8_disaggregation"]["identical"] and fleet["int8_disaggregation"]["requests_identical_to_monolithic"] == 8
    crash = fleet["crash"]
    assert crash["rerouted"] == crash["on_replica_0"] > 0 and crash["sampled_identical"] and crash["healthz_after"] == 503
    assert crash["metrics_counters"]["router_requests_rerouted"] == crash["rerouted"]
    assert fleet["rolling_update"]["shared_weights_untouched"] and fleet["rolling_update"]["swapped_replica_has_its_own"]
    assert fleet["threaded"]["identical_to_synchronous"] == crash["requests"]
    assert fleet["off_path"]["on"]["launches_2_steps"] == fleet["off_path"]["off"]["launches_2_steps"]
    assert not any(fleet["launches"].values()) and fleet["expected_launches"]["paged_decode_attention"] > 0
    assert fleet["expected_launches"]["kv_quant"] > 0  # (c)'s int8 pools
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
    # phase 15: speculation through the entry point, a draft model, the target drafting for
    # itself, one verify step's logits over a bf16 and an int8 pool
    speculative, speculative_launches, _ = speculated
    assert speculative["ngram_greedy"]["requests"] == chip_smoke.GREEDY_PROMPTS
    assert speculative["ngram_sampled"]["requests"] == chip_smoke.GENERATION_PROMPTS
    assert speculative["ngram_greedy"]["agreement_with_paged_greedy"] > 0.9
    assert speculative["self_draft"]["accept_rate"] >= 0.95
    assert speculative["draft_model"]["requests"] == chip_smoke.SPEC_DRAFT_REQUESTS
    assert speculative["draft_model"]["agreement_with_paged_greedy"] > 0.9
    assert all(speculative["verify_logits_check"]["int8"]["layer0_pool_bytes_identical"].values())
    for check in speculative["verify_logits_check"].values():  # each window row held alone
        assert len(check["window_row_mean_abs_err"]) == chip_smoke.SPEC_K + 1
    # greedy runs part from their references only at near ties (the lists hold each parting)
    assert all(len(row) == 3 for row in speculative["ngram_greedy"]["parted_from_paged_greedy"])
    assert all(len(row) == 3 for row in speculative["draft_model"]["parted_from_paged_greedy"])
    assert speculative["expected_launches"]["flash_attn_fwd"] > 0  # the draft models' prefills
    assert speculative["expected_launches"]["kv_quant"] > 0  # the int8 verify check's kernel path
    # phase 16: swap and recompute over an oversubscribed pool, two tiers, an int8 round trip
    preemption, preemption_launches, _ = preempted
    assert preemption["swap"]["preemptions"] > 0 and preemption["swap"]["requests_identical_to_unpreempted"] == chip_smoke.GENERATION_PROMPTS
    assert preemption["recompute"]["preemptions"] > 0
    assert preemption["swap"]["parted_from_unpreempted"] == []
    assert all(len(row) == 3 for row in preemption["recompute"]["parted_from_unpreempted"] + preemption["tiers"]["parted_from_unpreempted"])
    assert set(preemption["tiers"]["preempted_by_tier"]) == {1} and preemption["tiers"]["tier0_preemptions"] == 0
    assert preemption["int8_swap_round_trip"]["pages_and_scales_identical"]
    assert not any(speculative_launches.values()) and not any(preemption_launches.values())
    # phase 18: full finetuning from the checkpoint (padded, packed), LoRA, prompt tuning
    finetune = record["finetune"]
    for name in ("full_padded", "full_padding_free", "lora", "prompt_tuning"):
        assert len(finetune[name]["losses"]) == chip_smoke.FINETUNE_STEPS and sorted(finetune[name]["val_losses"]) == [0, 3]
    assert finetune["full_padded"]["accumulation"] == 2 and finetune["full_padding_free"]["train_shapes"][0][0] == 1
    assert finetune["lora"]["base_bit_identical"] and finetune["lora"]["adapters_moved"] == 4  # 2 layers' c_attn
    assert finetune["prompt_tuning"]["trainable_tensors"] == 1
    for method in ("full_finetuning", "lora"):  # the card's step against the CPU's: both on the CPU here
        assert finetune["step_check"][method]["max_rel_err"] == {"loss": 0.0, "grad_norm": 0.0}
    assert finetune["resume_check"]["bit_identical"] and finetune["resume_check"]["val_loss_identical"]
    assert not any(finetune["launches"].values()) and finetune["expected_launches"]["flash_attn_bwd"] > 0
    # phase 21: generation from the LoRA checkpoint, the 2-layer unshard held to the checkpoint,
    # generation from its directory (the checkpoint's own greedy tokens), the export / import
    # round trips, a draft by name, and the planted adapters at 2 layers
    interop = record["interop"]
    assert interop["lora_generate"]["adapters"] == 4 and interop["lora_generate"]["eval_mode"]  # 2 layers' c_attn
    assert interop["unshard"]["bit_identical_to_checkpoint"] and interop["unshard"]["dtypes"] == ["torch.float32"]
    assert interop["model_name_generate"]["requests_identical_to_checkpoint_run"] == chip_smoke.GREEDY_PROMPTS
    assert all(interop["export_import"][t]["round_trip_bit_identical"] for t in chip_smoke.INTEROP_EXPORTS)
    assert interop["draft_model_generate"]["requests"] == chip_smoke.GREEDY_PROMPTS
    assert all(len(row) == 3 for row in interop["draft_model_generate"]["parted_from_plain"])
    lora_check = interop["lora_check"]
    assert lora_check["rows_differing_without_adapters"] > 0 and lora_check["rows"] == chip_smoke.LORA_CHECK_ROWS
    assert not any(interop["launches"].values()) and interop["expected_launches"]["paged_decode_attention"] > 0
    assert interop["expected_launches"]["flash_attn_fwd"] == 0  # a draft by name attends with sdpa, as in JAX


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


def _tiny_model():
    from dolomite_engine_tpu_torch.models import CommonConfig, GPTDolomiteForCausalLM

    config = CommonConfig(
        vocab_size=96, n_positions=128, n_embd=32, n_layer=2, n_head=4, num_key_value_heads=2,
        attention_head_type="gqa", position_embedding_type="rope", add_bias=False,
        activation_function="swiglu", normalization_function="rmsnorm", bos_token_id=0, eos_token_id=1, pad_token_id=2,
    )
    return GPTDolomiteForCausalLM(config, device="cpu", seed=5)


def test_greedy_divergences_accept_near_ties_only(monkeypatch):
    """`greedy_divergences`: a row two runs agree on is skipped; a row that parts is
    measured at its first differing position, by the plain forward's logit gap between the
    two runs' tokens after their common prefix (EOS for a row that ends there); a gap past
    the bound raises."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    model = _tiny_model()
    prompt = [5, 9, 14, 3, 40, 7]
    with torch.no_grad():
        logits = chip_smoke.plain_forward(model, torch.tensor([prompt + [11, 12]]))[0].float()
    p = len(prompt)
    gap_swap = (logits[p + 1, 30] - logits[p + 1, 31]).abs().item()  # after [11, 12]: 30 against 31
    gap_eos = (logits[p, 1] - logits[p, 20]).abs().item()  # after [11]: EOS against 20
    got = [[11, 12, 13], [11, 12, 30], [11]]
    want = [[11, 12, 13], [11, 12, 31], [11, 20]]
    parted = chip_smoke.greedy_divergences(model, [prompt] * 3, got, want, max(gap_swap, gap_eos) + 1e-4, eos_token_id=1)
    assert [row[:2] for row in parted] == [[1, 2], [2, 1]]
    assert parted[0][2] == pytest.approx(gap_swap, abs=1e-4) and parted[1][2] == pytest.approx(gap_eos, abs=1e-4)
    with pytest.raises(AssertionError, match="no near tie"):
        chip_smoke.greedy_divergences(model, [prompt] * 3, got, want, min(gap_swap, gap_eos) / 2, eos_token_id=1)


def test_window_rows_check_holds_each_row_alone(monkeypatch):
    """`_window_rows_check`: close rows pass; one wrong row of five fails although the
    window's mean error stays within the bound; an argmax that differs passes as a near
    tie within the bound and fails past it."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    want = torch.randn((5, 512), generator=gen)
    got = want + 1e-3 * torch.randn((5, 512), generator=gen)
    std = want.std().item()
    errors, gaps = chip_smoke._window_rows_check(got, want, std, 0.25)
    assert len(errors) == 5 and gaps == []
    wrong = got.clone()
    wrong[4] = want[4] + 0.4 * std * torch.randn(512, generator=gen)  # the fifth row alone
    assert (wrong - want).abs().mean() <= 0.1 * std
    with pytest.raises(AssertionError):
        chip_smoke._window_rows_check(wrong, want, std, 0.25)
    tie_want, tie_got = want.clone(), got.clone()
    tie_want[0, 3], tie_want[0, 7] = 10.0, 9.99
    tie_got[0, 3], tie_got[0, 7] = 10.0, 10.01
    _, gaps = chip_smoke._window_rows_check(tie_got, tie_want, std, 0.25)
    assert gaps == [pytest.approx(0.01, abs=1e-5)]
    with pytest.raises(AssertionError):
        chip_smoke._window_rows_check(tie_got, tie_want, std, 0.001)


def test_distribution_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 19 at a world of one: every stage and the 1 x 1 topology give stage 0's
    losses and grad norms (the kernels' plain versions are deterministic too), the launch
    counts (all 0 here) agree, and a stage-3 save restores into a stage-0 model bit for
    bit."""
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    config = dict(chip_smoke.TRAIN_CONFIG, n_embd=64, n_head=4, n_inner=128, vocab_size=512)
    record, launches = chip_smoke.distribution_phase(0, device="cpu", config_kwargs=config, seq=256, work=str(tmp_path / "work"))
    assert [name for name, _, _ in chip_smoke.DISTRIBUTION_LAYOUTS] == list(record["runs"])
    for name, run in record["runs"].items():
        assert run["bit_identical_to_stage_0"], (name, run)
        assert len(run["losses"]) == chip_smoke.DISTRIBUTION_STEPS and run["mesh"] == {"dp": 1, "fsdp": 1}
    assert record["checkpoint"]["bit_identical"] and record["checkpoint"]["restored_step"] == chip_smoke.DISTRIBUTION_STEPS
    assert not any(launches.values())


# phase 20 at 2 + 2 layers and 64 wide (both configs), over shorter examples: (b)'s
# training targets reach a decoder length of 128 (the flash route), its val batch 61
SEQ2SEQ_REHEARSAL = {
    "model": dict(n_embd=64, n_head=4, n_inner=128, vocab_size=512), "layers": 2, "kernel_shape": (2, 128, 4, 64),
    "words": {
        "ragged": {"train": ((8, 200), (4, 100)), "val": ((8, 200), (4, 100))},
        "flash": {"train": ((20, 200), (130, 150)), "val": ((20, 200), (30, 60))},
    },
    "flash_output_tokens": 129,
}


def test_seq2seq_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 20: (a) the seq2seq YAML (rope, sdpa), (b) flan-t5-base's config with
    flash_attention_2, full finetuning and LoRA (the training batches at decoder length 512,
    the val batch at 300), (c) `generate.main` from (b)'s checkpoint and the 2-layer card /
    CPU greedy check (here CPU against CPU: identical), (d) the query-bias kernel check
    (here the plain version against fp32 SDPA autograd). No kernel launches on the CPU."""
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    record, launches, cases = chip_smoke.seq2seq_phase(0, device="cpu", rehearsal=SEQ2SEQ_REHEARSAL, work=str(tmp_path / "work"))
    assert cases == [] and not any(launches.values()) and record["launch_forms"] == {}
    for name, decoder in (("yaml", None), ("flan_t5_full", 128), ("flan_t5_lora", 128)):
        run = record[name]
        assert len(run["losses"]) == chip_smoke.SEQ2SEQ_STEPS and run["decoder_layers"] == 2
        if decoder is not None:
            assert [d for _, _, d in run["train_shapes"]] == [decoder] * chip_smoke.SEQ2SEQ_STEPS
            assert run["launches"]["flash_attn_bias_fwd"] == 2 * chip_smoke.SEQ2SEQ_STEPS  # Ld a training batch
    # the expected counts of a rope run: rmsnorm 2 Le + 1 + 3 Ld + 1 and rope 2 (Le + Ld) a
    # training batch, the forward's for each of the two eval batches
    assert record["yaml"]["launches"]["rmsnorm"] == 12 * (chip_smoke.SEQ2SEQ_STEPS + 2)
    assert record["yaml"]["launches"]["rope_qkv"] == 8 * chip_smoke.SEQ2SEQ_STEPS + 4 * 2
    assert record["flan_t5_lora"]["tuning"] == "lora" and record["flan_t5_lora"]["val_losses"][0] == record["flan_t5_full"]["val_losses"][0]
    # (c) from the full run's checkpoint, and phase 21's part from the LoRA run's
    for name, targets in (("generate", ()), ("lora_generate", ("c_attn", "c_kv", "c_q"))):
        generation = record[name]
        check = generation["check"]  # a bf16 model against the fp32 one, both on the CPU here
        assert generation["requests"] == chip_smoke.SEQ2SEQ_GENERATE[0]
        assert check["prompts"] == min(chip_smoke.SEQ2SEQ_CHECK_PROMPTS, chip_smoke.SEQ2SEQ_GENERATE[0])
        assert check["lora_targets"] == targets
        assert len(check["parted"]) == check["prompts"] - check["rows_identical"]
        assert all(gap <= check["near_tie_bound"] for _, _, gap in check["parted"])
        assert check["logits_check"]["max_abs_err"] == check["logits_max_abs_err"] == check["near_tie_bound"] / 2
    assert len(record["kernel_check"]) == 2


def test_families_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 22 at 64 wide (4 heads, so dense_moe has 4 experts): (a) CLA2 serving and the
    identity conversion's check, (b) `pretrain.main` for the three families and the dense baseline,
    (c) the hybrid's generation, its 2-layer check (here CPU bf16 against CPU fp32) and the
    delta rule's forms, (d) dense_moe serving dense and top-2 and the top-2 logits check.
    No kernel launches on the CPU."""
    monkeypatch.chdir(REPO)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FAMILIES_TRAIN_LAYERS", {"gpt_crosslayer": 4, "dense_moe": 2, "rnn_dolomite": 4})
    monkeypatch.setattr(chip_smoke, "FAMILIES_MOE_SERVE_LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "MAX_NEW", 8)
    rehearsal = {
        "model": dict(n_embd=64, n_head=4, n_inner=128, vocab_size=512, n_layer=4), "sequence_length": 128,
        "identity_prompt": 64, "generate_width": 128, "delta_rule_shape": (1, 2, 128, 16),
    }
    record, launches = chip_smoke.families_phase(0, device="cpu", rehearsal=rehearsal, work=str(tmp_path / "work"))
    assert not any(launches.values()) and record["launch_forms"] == {}
    serving = record["crosslayer_serving"]
    assert serving["kv_groups"] == 2 and 2 * serving["kv_bytes_per_token"] == serving["dense_kv_bytes_per_token"]
    assert serving["identity_check"]["identity_vs_dense_max_abs_err"] < 1e-4  # fp32 here: the same model
    for model_type, run in record["pretrain"].items():
        assert len(run["losses"]) == chip_smoke.FAMILIES_STEPS and run["seq"] == 128, model_type
    generation = record["rnn_generation"]
    assert generation["check"]["rows_identical"] + len(generation["check"]["parted"]) == generation["check"]["prompts"]
    assert generation["delta_rule"]["fp32_max_abs_err"] < 1e-4
    moe = record["dense_moe_serving"]
    assert moe["num_experts"] == 4 and 0.0 <= moe["greedy_agreement_dense_vs_top_k"] <= 1.0
    assert moe["dense"]["requests"] == moe["top_k"]["requests"] == 8 and moe["top_k_inference_method"] == {"top_k": 2}
    check = moe["top_k_check"]  # here CPU bf16 against CPU fp32
    assert check["ratio"] * check["card_top_k_vs_cpu_top_k_mean_abs_err"] <= check["card_top_k_vs_cpu_dense_mean_abs_err"]
    assert set(moe["greedy_copy_share"]) == {"dense", "top_k"}
    baseline = record["pretrain"]["gpt_dolomite"]
    assert baseline["baseline_of"] == "gpt_crosslayer" and baseline["n_layer"] == record["pretrain"]["gpt_crosslayer"]["n_layer"]
