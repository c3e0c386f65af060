#!/usr/bin/env python3
"""Run `tools/serve_torch.py` over the serving fleet on one card, from a model directory it writes.

    python3 scripts/serve_torch_fleet_check.py [--layers 2] [--device cuda]

Writes granite-3b-code's config at `--layers` layers with seeded random weights and a word
tokenizer (`chip_smoke.word_tokenizer`) as an HF-layout directory (`ModelWrapper.
save_pretrained`) in a temporary directory, then runs the CLI as a user would:
``--replicas 2 --disaggregate --trace --metrics-port 0 --health-monitoring`` with a telemetry
sink, 16 prompts x 32 greedy tokens. It checks that every request completed, that the sink holds
one trace record a request, each with one handoff span, and the router and fleet records, and
prints one JSON line: the card, the generation seconds, the handoffs and the router's placement.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import importlib.util

    import numpy as np
    import torch

    import chip_smoke
    from dolomite_engine_tpu_torch.enums import Mode
    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning

    if args.device == "cuda" and not torch.cuda.is_available():
        print("serve_torch_fleet_check: no CUDA device is available", file=sys.stderr)
        return 2
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
        ).stdout.strip().splitlines()[0]
    config = dict(chip_smoke.GRANITE_3B_CODE, n_layer=args.layers)
    rs = np.random.RandomState(0)
    prompts = [" ".join(f"t{t}" for t in rs.randint(2, config["vocab_size"], rs.randint(100, 600))) for _ in range(16)]
    with tempfile.TemporaryDirectory(prefix="serve-torch-") as work:
        tokenizer = chip_smoke.word_tokenizer(os.path.join(work, "tokenizer"), config["vocab_size"], config["eos_token_id"])
        wrapper = ModelWrapperForFinetuning(config, mode=Mode.inference, dtype="bf16", tokenizer_name=tokenizer, device=args.device, seed=0)
        model_dir = os.path.join(work, "model")
        wrapper.save_pretrained(model_dir)
        del wrapper
        with open(os.path.join(work, "prompts.txt"), "w") as f:
            f.write("\n".join(prompts) + "\n")
        spec = importlib.util.spec_from_file_location("serve_torch", os.path.join(ROOT, "tools", "serve_torch.py"))
        serve_torch = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(serve_torch)
        sink = os.path.join(work, "serve.jsonl")
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            states = serve_torch.main([
                "--model", model_dir, "--prompt-file", os.path.join(work, "prompts.txt"), "--max-new-tokens", "32",
                "--num-slots", "8", "--replicas", "2", "--disaggregate", "--trace", "--metrics-port", "0",
                "--health-monitoring", "--telemetry-sink", sink, "--device", args.device,
            ])
        seconds = time.perf_counter() - t0
        lines = [json.loads(line) for line in out.getvalue().splitlines()]
        records = [json.loads(line) for line in open(sink)]
    traces = [r for r in records if r["kind"] == "trace"]
    router = [r for r in records if r["kind"] == "router"][-1]
    assert len(lines) == len(states) == 16 and all(line["status"] == "completed" for line in lines), lines
    assert len(traces) == 16 and all(sum(s["name"] == "handoff" for s in r["spans"]) == 1 for r in traces)
    assert any(r["kind"] == "fleet" for r in records) and router["routed"] == 16
    print(json.dumps({
        "serve_torch_fleet_check": {
            "layers": args.layers, "requests": len(lines), "seconds": seconds, "routed": router["counters"]["per_replica_routed"],
            "kv_handoffs": router["counters"]["kv_handoffs"], "handoff_latency_ms": router["handoff_latency_ms"],
            "stderr": err.getvalue().strip().splitlines()[-2:],
        },
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
