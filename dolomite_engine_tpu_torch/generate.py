"""Generation entry point: decode the test split of every dataset into jsonl.

Counterpart of `dolomite_engine_tpu/generate.py`: the model comes from a training
checkpoint (`load_checkpoint_for_inference`: a LoRA checkpoint generates through its
adapters) or, without `load_args`, from `model_args`: a local ``model_name`` directory's
weights (`ModelWrapper.load_pretrained_params`), or a config-only model with random
weights from `random_args.seed`; every test-split row is one request to the
continuous-batching `ServingEngine` (the paged pool, or the dense slot pool under
``paged_kv_cache: false``), and ``output-<data_name>.jsonl`` gets one line a row, in
dataset order, with ``generated_text`` and ``num_generated_tokens``. Each request's
sampling seed is drawn from one `torch.Generator` seeded with `random_args.seed`. The
engine runs the YAML's speculation (``speculate_ngram``, ``draft_k``), preemption and
``oversubscribe_ratio`` and a ``draft_model`` named by its HF-layout directory
(`load_draft_model`). ``replicas > 1`` or ``disaggregate`` serve through the fleet, as the
JAX package does: a `serving.cluster.Router` over ``replicas`` engines, each a
`DisaggregatedEngine` (a prefill-only engine handing its pages to one decode engine) under
``disaggregate``; every engine is built over the one model, so the weights exist once and
each replica adds only its pool. ``trace_requests`` traces every request (one ``trace``
record each into the installed telemetry). The options the port does not run raise, naming
their ROADMAP item (`arguments.check_ported_inference_options`). An encoder-decoder model keeps JAX's
fixed-batch loop (`_generate_seq2seq`): ``batch_size`` rows at a time through
`collate_fn`, left-padded to the next multiple of ``prompt_bucket_multiple`` and a
ragged last batch repeated up to ``batch_size`` (`_pad_to_static_shapes`), then
`ModelWrapper.generate` (`generation_utils.generate_seq2seq_tokens`); the sampled tokens
draw from the one generator.

    python -m dolomite_engine_tpu_torch.generate --config generation.yml
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .arguments import InferenceArgs, check_ported_inference_options, get_args
from .checkpointing import load_checkpoint_for_inference, save_args
from .data import get_datasets_list
from .data.utils import collate_fn
from .device import resolve_device
from .enums import DatasetKeys, DatasetSplit, Mode
from .model_wrapper import ModelWrapperForFinetuning
from .utils import ProgressBar, log_rank_0, set_logger

def generate(args: InferenceArgs, model, datasets_list: list, mode: Mode) -> dict:
    """Write each dataset's ``output-<data_name>.jsonl`` under `args.output_dir` (and the
    args snapshot); returns `_generate_with_engine`'s summary (`_generate_seq2seq`'s for
    an encoder-decoder)."""
    os.makedirs(args.output_dir, exist_ok=True)
    save_args(args, args.output_dir, mode)
    progress_bar = ProgressBar(0, sum(len(dataset) for dataset in datasets_list))
    generator = torch.Generator().manual_seed(args.random_args.seed or 0)
    if model.is_encoder_decoder:
        if model.model.device.type == "cuda":  # sampling draws on the card
            generator = torch.Generator(device=model.model.device).manual_seed(args.random_args.seed or 0)
        return _generate_seq2seq(args, model, datasets_list, mode, progress_bar, generator)
    return _generate_with_engine(args, model, datasets_list, progress_bar, generator)


def _generate_seq2seq(args: InferenceArgs, model, datasets_list: list, mode: Mode, progress_bar, generator) -> dict:
    """The encoder-decoder's fixed-batch loop (the JAX package's): each dataset in chunks
    of ``batch_size`` rows, padded to static shapes, generated, and written in order.
    Returns the requests, prompt and generated tokens, the output paths, the loop's
    seconds and the number of `generate` calls."""
    gp = args.generation_parameters
    generate_kwargs = dict(
        max_new_tokens=gp.max_new_tokens, do_sample=gp.do_sample, temperature=gp.temperature, top_k=gp.top_k,
        top_p=gp.top_p,
    )
    summary = {"requests": 0, "prompt_tokens": 0, "generated_tokens": 0, "batches": 0, "outputs": []}
    t0 = time.perf_counter()
    for dataset in datasets_list:
        output_path = os.path.join(args.output_dir, f"output-{dataset.data_name}.jsonl")
        with open(output_path, "w") as output_file:
            batch = []
            for index in range(len(dataset)):
                batch.append(dataset[index])
                if len(batch) < gp.batch_size and index < len(dataset) - 1:
                    continue
                collated = collate_fn(
                    batch, mode=mode, loss_mask=None, eos_token_id=model.eos_token_id, is_encoder_decoder=True,
                    use_padding_free_transformer=False,
                )
                collated = _pad_to_static_shapes(collated, gp.batch_size, model.eos_token_id, gp.prompt_bucket_multiple)
                texts, counts = model.generate(collated, generate_kwargs, generator)
                for text, count in zip(texts[: len(batch)], counts[: len(batch)]):
                    output_file.write(
                        json.dumps(
                            {DatasetKeys.generated_text.value: text, DatasetKeys.num_generated_tokens.value: count}
                        )
                        + "\n"
                    )
                summary["requests"] += len(batch)
                summary["prompt_tokens"] += sum(len(row["input"]) for row in batch)
                summary["generated_tokens"] += sum(counts[: len(batch)])
                summary["batches"] += 1
                progress_bar.update(len(batch))
                batch = []
        summary["outputs"].append(output_path)
        log_rank_0(20, f"wrote {output_path}")
    summary["engine_seconds"] = time.perf_counter() - t0
    return summary


def merged_stats(engines: list) -> "EngineStats":
    """One `EngineStats` over several engines: counts and seconds summed, latency
    samples pooled, peaks the largest."""
    import dataclasses

    from .serving import EngineStats
    from .utils import QuantileSketch

    merged = EngineStats()
    for engine in engines:
        for f in dataclasses.fields(EngineStats):
            mine, theirs = getattr(merged, f.name), getattr(engine.stats, f.name)
            if isinstance(theirs, QuantileSketch):
                for value in theirs:
                    mine.append(value)
            elif isinstance(theirs, dict):
                for key, value in theirs.items():
                    if isinstance(value, QuantileSketch):
                        sketch = mine.setdefault(key, QuantileSketch())
                        for sample in value:
                            sketch.append(sample)
                    else:
                        mine[key] = mine.get(key, 0) + value
            elif f.name == "peak_active":
                setattr(merged, f.name, max(mine, theirs))
            else:
                setattr(merged, f.name, mine + theirs)
    return merged


def _generate_with_engine(args: InferenceArgs, model, datasets_list: list, progress_bar, generator) -> dict:
    """Decoder-only batch decode through one `ServingEngine`, or the fleet (a `Router`
    over engine replicas) under ``replicas > 1`` / ``disaggregate``: every dataset row is
    one request with its own prompt length, a slot is reused the moment its row hits EOS,
    and outputs keep dataset order. Returns the requests, prompt and generated tokens, the
    engines' seconds, their `EngineStats` (merged over a fleet's engines, each also under
    ``engine_stats``), a pool's figures (``engines`` of them), the host swap traffic, and
    for a fleet the `RouterStats` and the KV handoffs."""
    from .serving import SamplingParams, ServingEngine, route_batch, serve_batch

    gp = args.generation_parameters
    multiple = gp.prompt_bucket_multiple
    max_prompt = max(
        (len(dataset[i]["input"]) for dataset in datasets_list for i in range(len(dataset))), default=0
    )
    summary = {"requests": 0, "prompt_tokens": 0, "generated_tokens": 0, "outputs": []}
    if max_prompt == 0:
        for dataset in datasets_list:
            output_path = os.path.join(args.output_dir, f"output-{dataset.data_name}.jsonl")
            open(output_path, "w").close()
            summary["outputs"].append(output_path)
            log_rank_0(20, f"wrote {output_path}")
        return summary
    max_len = -(-max_prompt // multiple) * multiple + gp.max_new_tokens

    sampling = SamplingParams(do_sample=bool(gp.do_sample), temperature=gp.temperature, top_k=gp.top_k, top_p=gp.top_p)
    pad_token_id = next((t for t in (model.tokenizer.pad_token_id, model.eos_token_id) if t is not None), 0)
    draft_model, draft_params = load_draft_model(gp.draft_model, model.model.device)

    def build_engine(**overrides):
        kwargs = dict(
            num_slots=gp.batch_size,
            max_len=max_len,
            prefill_bucket_multiple=multiple,
            max_waiting=max(2 * gp.batch_size, 8),
            eos_token_id=model.eos_token_id,
            pad_token_id=pad_token_id,
            paged=gp.paged_kv_cache,
            page_size=gp.kv_page_size,
            num_pages=gp.kv_num_pages,
            kv_dtype=gp.kv_dtype,
            prefill_chunk_tokens=gp.prefill_chunk_tokens,
            prefix_caching=gp.prefix_caching,
            preemption=gp.preemption,
            oversubscribe_ratio=gp.oversubscribe_ratio,
            session_ttl_s=gp.session_ttl_s,
            speculate_ngram=gp.speculate_ngram,
            draft_model=draft_model,
            draft_params=draft_params,
            draft_k=gp.draft_k,
            trace_requests=gp.trace_requests,
            device=model.model.device,
        )
        kwargs.update(overrides)
        return ServingEngine(model.model, None, **kwargs)

    router = None
    if gp.replicas > 1 or gp.disaggregate:
        from .serving import DisaggregatedEngine, EngineReplica, Router

        replicas = []
        for replica_id in range(gp.replicas):
            if gp.disaggregate:
                prefill = build_engine(
                    prefill_only=True, speculate_ngram=False, draft_model=None, draft_params=None,
                    preemption="off", oversubscribe_ratio=1.0,
                )
                replica_engine = DisaggregatedEngine(prefill, [build_engine()])
            else:
                replica_engine = build_engine()
            replicas.append(EngineReplica(replica_id, replica_engine))
        router = Router(replicas, trace_requests=gp.trace_requests)
        engines = [
            e for r in replicas for e in ([r.engine.prefill, *r.engine.workers] if gp.disaggregate else [r.engine])
        ]
    else:
        engines = [build_engine()]
    engine = engines[-1]  # the pool figures below are a decode engine's

    t0 = time.perf_counter()
    for dataset in datasets_list:
        specs = [
            dict(
                prompt_ids=dataset[index]["input"],
                max_new_tokens=gp.max_new_tokens,
                sampling=sampling,
                seed=int(torch.randint(2**62, (1,), generator=generator)),
                priority=gp.priority,
                on_finish=lambda state: progress_bar.update(1),
            )
            for index in range(len(dataset))
        ]
        states = route_batch(router, specs) if router is not None else serve_batch(engine, specs)

        output_path = os.path.join(args.output_dir, f"output-{dataset.data_name}.jsonl")
        with open(output_path, "w") as output_file:
            for state in states:
                text = model.tokenizer.decode(state.tokens, skip_special_tokens=True)
                output_file.write(
                    json.dumps(
                        {
                            DatasetKeys.generated_text.value: text,
                            DatasetKeys.num_generated_tokens.value: state.num_generated,
                        }
                    )
                    + "\n"
                )
        summary["requests"] += len(states)
        summary["prompt_tokens"] += sum(len(spec["prompt_ids"]) for spec in specs)
        summary["generated_tokens"] += sum(state.num_generated for state in states)
        summary["outputs"].append(output_path)
        log_rank_0(20, f"wrote {output_path}")
    engine_seconds = time.perf_counter() - t0
    swaps = [e._swap for e in engines if e._swap is not None]
    summary.update(
        engine_seconds=engine_seconds,
        stats=engine.stats if router is None else merged_stats(engines),
        # the host swap pool's traffic (``preemption: swap``); the copies out end on the host
        swap=None if not swaps else {
            key: sum(getattr(swap, key) for swap in swaps) for key in ("bytes_out", "seconds_out", "bytes_in", "seconds_in")
        },
        pool={
            "paged": gp.paged_kv_cache,
            "num_slots": engine.pool.num_slots,
            "max_len": max_len,
            "kv_bytes_per_token": engine.pool.kv_bytes_per_token,
            "bytes": sum(t.numel() * t.element_size() for cache in engine.pool.caches for t in cache.values()),
            "engines": len(engines),
        },
    )
    if router is not None:
        handoffs = [r.engine.handoff for r in router.replicas if gp.disaggregate]
        transfers = sum(h.transfers for h in handoffs)
        summary.update(
            router=router.stats,
            engine_stats=[e.stats for e in engines],
            handoff={
                "transfers": transfers,
                "mean_latency_s": sum(h._latency_sum for h in handoffs) / transfers if transfers else None,
            },
        )
        hit_rate = router.stats.affinity_hit_rate()
        log_rank_0(
            20,
            f"router: {router.stats.routed} routed / {router.stats.rejected} rejected "
            f"over {len(router.replicas)} replica(s) "
            f"{dict(sorted(router.stats.per_replica_routed.items()))}, prefix-affinity "
            f"hit rate {'n/a' if hit_rate is None else f'{hit_rate:.1%}'}",
        )
    return summary


def load_draft_model(name: str | None, device: str | torch.device = "cuda") -> tuple:
    """A draft model for speculative decoding, named by its HF-layout directory (the JAX
    package's: `ModelWrapperForFinetuning(mode=inference, model_name=name)`, its default fp32
    compute, and `load_pretrained_params`), on `device`: (model, None), or (None, None)
    without one. Any family can draft for a larger one that shares its vocabulary."""
    if not name:
        return None, None
    wrapper = ModelWrapperForFinetuning(None, mode=Mode.inference, model_name=name, device="meta")
    wrapper.load_pretrained_params(name, resolve_device(device))
    return wrapper.model, None


def _pad_to_static_shapes(collated: dict, batch_size: int, eos_token_id: int, width_multiple: int = 64) -> dict:
    """Left-pad prompts to the next width bucket and repeat-pad a ragged batch to
    `batch_size` (the JAX package pads so its jitted decode compiles once a bucket; the
    port keeps its shapes, so the encoder-decoder loop computes what JAX's does)."""
    input_ids = np.asarray(collated["input_ids"])
    attention_mask = np.asarray(collated["attention_mask"])
    rows, width = input_ids.shape

    target_width = -(-width // width_multiple) * width_multiple
    if target_width != width:
        pad = target_width - width
        input_ids = np.pad(input_ids, ((0, 0), (pad, 0)), constant_values=eos_token_id)
        attention_mask = np.pad(attention_mask, ((0, 0), (pad, 0)), constant_values=0)
    if rows < batch_size:
        reps = batch_size - rows
        input_ids = np.concatenate([input_ids, np.repeat(input_ids[-1:], reps, axis=0)])
        attention_mask = np.concatenate([attention_mask, np.repeat(attention_mask[-1:], reps, axis=0)])
    return {"input_ids": input_ids, "attention_mask": attention_mask}


def main(args: InferenceArgs | None = None, device: str | torch.device = "cuda") -> dict:
    """Load the model, read the test splits and generate on `device` (the GPU unless
    ``"cpu"`` is passed); returns the run's summary: `_generate_with_engine`'s and the
    seconds of each phase (``load``, ``datasets``, ``generate``) and of the load's parts
    (``load_seconds``: `load_checkpoint_for_inference`'s from a checkpoint,
    `load_pretrained_params`'s from a ``model_name`` directory)."""
    mode = Mode.inference
    device = resolve_device(device)
    set_logger()
    if args is None:
        args = get_args(mode)
    check_ported_inference_options(args)

    t0 = time.perf_counter()
    load_seconds = {}
    if args.load_args is None:
        model_args = args.model_args
        model = ModelWrapperForFinetuning(
            model_args.pretrained_config,
            mode=mode,
            dtype=args.mixed_precision_args.dtype,
            attention_implementation=model_args.attention_implementation,
            model_name=model_args.model_name,
            tokenizer_name=args.tokenizer_args.tokenizer_name,
            additional_special_tokens=args.tokenizer_args.additional_special_tokens,
            # a model_name directory's weights are read into it: no random init first
            device="meta" if model_args.model_name is not None else device,
            seed=args.random_args.seed,
            model_class=model_args.model_class,
        )
        if model_args.model_name is not None:
            model.load_pretrained_params(model_args.model_name, device, load_seconds)
    else:
        model, _ = load_checkpoint_for_inference(args, mode, device, load_seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()

    datasets_list, _ = get_datasets_list(
        dataset_args_list=args.datasets,
        split=DatasetSplit.test,
        mode=mode,
        tokenizer=model.tokenizer,
        is_encoder_decoder=model.is_encoder_decoder,
    )
    t2 = time.perf_counter()
    summary = generate(args, model, datasets_list, mode)
    summary["seconds"] = {"load": t1 - t0, "datasets": t2 - t1, "generate": time.perf_counter() - t2}
    summary["load_seconds"] = load_seconds
    return summary


if __name__ == "__main__":
    main()
