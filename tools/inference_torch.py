"""Interactive generation with the PyTorch port's continuous-batching engine.

    python tools/inference_torch.py --model /path/to/dolomite-model \
        --prompt "def factorial(x):" --max-new-tokens 100 --stream

The port's counterpart of `tools/inference.py`: the model is an HF-layout dolomite
directory (``config.json``, safetensors, tokenizer; `ModelWrapper.load_pretrained_params`),
prompts and sampling settings are flags, several --prompt flags (or --prompt-file) decode
concurrently through the slot pool, and --stream prints tokens as the engine emits them.
It runs on the GPU unless ``--device cpu`` is given. --trace writes one ``trace`` record a
request into --telemetry-sink. The kernel backend switch (--kernels) of the JAX tool is not
ported: the port has no backend switch (a tensor's device picks the kernel). For
dataset-driven generation use `python -m dolomite_engine_tpu_torch.generate`; for the fleet,
`tools/serve_torch.py`.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SYSTEM_PROMPT = "<|system|>\nYou are a cautious assistant. You carefully follow instructions."
USER_PROMPT = "<|user|>\n{value}\n"
ASSISTANT = "<|assistant|>\n"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True, help="dolomite-format model directory")
    p.add_argument("--prompt", action="append", default=[], help="prompt text (repeatable)")
    p.add_argument("--prompt-file", help="file with one prompt per line")
    p.add_argument("--chat", action="store_true", help="wrap each prompt in the system/user/assistant chat template")
    p.add_argument("--max-new-tokens", type=int, default=100)
    p.add_argument("--do-sample", action="store_true")
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--num-slots", type=int, default=4, help="max concurrent requests")
    p.add_argument("--bucket-multiple", type=int, default=64, help="prefill width bucket")
    p.add_argument("--speculate-ngram", action="store_true", help="n-gram self-drafting (exclusive with --draft-model)")
    p.add_argument("--draft-model", default=None, help="smaller dolomite-format directory that drafts for the target")
    p.add_argument("--draft-k", type=int, default=4, help="draft tokens proposed per engine step (K >= 1)")
    p.add_argument("--priority", type=int, default=0, help="priority tier for these prompts (0 = top tier)")
    p.add_argument("--preemption", choices=["off", "swap", "recompute"], default="off", help="paged-KV preemption of lower-tier slots")
    p.add_argument("--oversubscribe-ratio", type=float, default=1.0, help="admit up to ratio x allocatable pages of worst-case reservations")
    p.add_argument("--session-id", default=None, help="conversation key: finished turns pin their prefix pages until the TTL lapses")
    p.add_argument("--session-ttl", type=float, default=300.0, help="seconds a session's pinned prefix pages survive")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stream", action="store_true", help="print tokens as they decode (single prompt only)")
    p.add_argument("--kv-dtype", default=None, choices=["bf16", "int8", "fp8"], help="paged KV page storage (default: the model's dtype)")
    p.add_argument("--dtype", default="bf16", choices=["fp32", "bf16"], help="compute dtype of the model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--trace",
        action="store_true",
        help="per-request tracing: one `trace` record a request (span tree: queue/admission/"
        "prefill/decode) into --telemetry-sink",
    )
    p.add_argument("--telemetry-sink", help="telemetry JSONL path (for --trace records)")
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """Generate for every prompt; prints each prompt with its continuation (or streams one)
    and returns the continuations."""
    args = parse_args(argv)
    prompts = list(args.prompt)
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts.extend(line.rstrip("\n") for line in f if line.strip())
    if not prompts:
        raise SystemExit("no prompts: pass --prompt and/or --prompt-file")
    if args.chat:
        prompts = [SYSTEM_PROMPT + USER_PROMPT.format(value=text) + ASSISTANT for text in prompts]
    if args.stream and len(prompts) > 1:
        raise SystemExit("--stream supports a single prompt (others would interleave)")

    from dolomite_engine_tpu_torch.device import resolve_device
    from dolomite_engine_tpu_torch.enums import Mode
    from dolomite_engine_tpu_torch.generate import load_draft_model
    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning
    from dolomite_engine_tpu_torch.serving import SamplingParams, ServingEngine, serve_batch
    from dolomite_engine_tpu_torch.utils.telemetry import Telemetry, install_telemetry, uninstall_telemetry

    device = resolve_device(args.device)
    model = ModelWrapperForFinetuning(None, mode=Mode.inference, model_name=args.model, dtype=args.dtype, device="meta")
    model.load_pretrained_params(args.model, device)
    assert model.tokenizer is not None, "generation requires a tokenizer"

    prompt_ids = [model.tokenizer(text, add_special_tokens=False)["input_ids"] for text in prompts]
    multiple = args.bucket_multiple
    max_len = -(-max(len(ids) for ids in prompt_ids) // multiple) * multiple + args.max_new_tokens
    pad_token_id = next((t for t in (model.tokenizer.pad_token_id, model.eos_token_id) if t is not None), 0)
    draft_model, _ = load_draft_model(args.draft_model, device)
    engine = ServingEngine(
        model.model, None, num_slots=args.num_slots, max_len=max_len, prefill_bucket_multiple=multiple,
        eos_token_id=model.eos_token_id, pad_token_id=pad_token_id, seed=args.seed, kv_dtype=args.kv_dtype,
        preemption=args.preemption, oversubscribe_ratio=args.oversubscribe_ratio, session_ttl_s=args.session_ttl,
        speculate_ngram=args.speculate_ngram, draft_model=draft_model, draft_k=args.draft_k,
        trace_requests=args.trace, device=device,
    )
    telemetry = None
    if args.telemetry_sink:
        telemetry = Telemetry(sink_path=args.telemetry_sink, device=device)
        install_telemetry(telemetry)
    sampling = SamplingParams(do_sample=args.do_sample, temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)

    def stream_token(token_id: int) -> None:
        print(model.tokenizer.decode([token_id], skip_special_tokens=True), end="", flush=True)

    if args.stream:
        print(prompts[0], end="", flush=True)
    specs = [
        dict(
            prompt_ids=ids, max_new_tokens=args.max_new_tokens, sampling=sampling, priority=args.priority,
            session_id=args.session_id, on_token=stream_token if args.stream else None,
        )
        for ids in prompt_ids
    ]
    try:
        states = serve_batch(engine, specs)
    finally:
        if telemetry is not None:
            uninstall_telemetry()
            telemetry.close()
    continuations = [model.tokenizer.decode(state.tokens, skip_special_tokens=True) for state in states]
    if args.stream:
        print()
        return continuations
    for text, continuation in zip(prompts, continuations):
        print(text + continuation)
        print("---")
    return continuations


if __name__ == "__main__":
    main()
