"""fp8 against bf16 over the first steps of the granite pretraining run, on one card.

The PyTorch port's `pretrain.main` over `chip_smoke.py`'s phase-12 setup (the granite YAML,
32 layers, a seeded corpus, 8 steps of which 2 are warm-up; step 1's learning rate is 0),
for each seed three ways:

- ``bf16``: the YAML as it is;
- ``fp8``: ``mixed_precision_args.dtype: fp8``, flax's delayed scaling from a fresh state
  (every scale 1, every amax history 0), as `chip_smoke.py` runs it;
- ``fp8_calibrated``: the same, but before step 1 one forward and backward of the first
  training micro-batch fills the amax histories; its gradients are dropped and no update
  is made, so step 1 starts from the same weights and optimizer state with scales taken
  from the data.

Since step 1's learning rate is 0, steps 1 and 2 of every run see the same weights and
batches: their grad norms against bf16's measure the fp8 gradient from the fresh state
(step 1) and from calibrated scales (step 2) directly. The checkpoint at the last step is
not written (the runs are measured, not resumed).

    python tools/fp8_early_steps_torch.py --seeds 0 1 2 --out chiprun_out/fp8_early_steps.json

`--layers` and `--rehearsal` cut the model for a run of the control flow on the CPU
(`--device cpu`).
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("bf16", "fp8", "fp8_calibrated")


def _calibrating(make_train_step):
    """`make_train_step` whose step first runs one forward and backward of its first
    micro-batch (once a run), commits the fp8 state and drops the gradients."""

    def make(loss_fn, optimizer, **kwargs):
        train_step = make_train_step(loss_fn, optimizer, **kwargs)
        done = []

        def run(state, batch):
            if not done:
                loss_fn({name: value[0] for name, value in batch.items()}).backward()
                state.fp8.commit()
                for p in optimizer.params:
                    p.grad = None
                done.append(True)
            return train_step(state, batch)

        return run

    return make


def run(seed, variant, device, n_layer=None, rehearsal=None):
    import chip_smoke
    from dolomite_engine_tpu_torch import pretrain

    with tempfile.TemporaryDirectory(prefix="fp8-early-") as work:
        probe = chip_smoke.pretrain_args(os.path.join(work, "corpus"), "unused", chip_smoke.PRETRAIN_STEPS, n_layer=n_layer, rehearsal=rehearsal)
        config = probe.model_args.pretrained_config
        corpus, _, _ = chip_smoke.pretrain_corpus(work, seed, config["vocab_size"], config["eos_token_id"])
        tokenizer = chip_smoke.word_tokenizer(os.path.join(work, "tokenizer"), config["vocab_size"], config["eos_token_id"])
        options = {} if variant == "bf16" else {"mixed_precision_args": {"dtype": "fp8"}}
        args = chip_smoke.pretrain_args(
            corpus, os.path.join(work, "run"), chip_smoke.PRETRAIN_STEPS, n_layer=n_layer, rehearsal=rehearsal,
            tokenizer=tokenizer, options=options,
        )
        make, save = pretrain.make_train_step, pretrain.save_checkpoint
        if variant == "fp8_calibrated":
            pretrain.make_train_step = _calibrating(make)
        pretrain.save_checkpoint = lambda *args, **kwargs: None
        t0 = time.perf_counter()
        try:
            summary = pretrain.main(args, device=device)
        finally:
            pretrain.make_train_step, pretrain.save_checkpoint = make, save
        steps = summary["steps"]
        return {
            "seed": seed, "variant": variant, "losses": [s["loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps], "lrs": [s["lr"] for s in steps],
            "seconds": time.perf_counter() - t0,
        }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--rehearsal", action="store_true", help="chip_smoke's CPU widths (64 wide, 128 tokens)")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "fp8_early_steps.json"))
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import gc

    import torch

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rehearsal = {"model": dict(n_embd=64, n_head=4, n_inner=128, vocab_size=512), "sequence_length": 128} if args.rehearsal else None
    runs = []
    for seed in args.seeds:
        for variant in VARIANTS:
            record = run(seed, variant, args.device, args.layers, rehearsal)
            runs.append(record)
            print(json.dumps(record), flush=True)
            gc.collect()
            if args.device == "cuda":
                torch.cuda.empty_cache()
    by = {(r["seed"], r["variant"]): r for r in runs}
    summary = []
    for seed in args.seeds:
        bf16 = by[seed, "bf16"]
        row = {"seed": seed}
        for variant in VARIANTS:
            losses = by[seed, variant]["losses"]
            row[variant] = {
                "first": losses[0], "last": losses[-1], "last_below_first": losses[-1] < losses[0],
                "mean": sum(losses) / len(losses),
                "mean_rel_gap_to_bf16": abs(sum(losses) - sum(bf16["losses"])) / sum(bf16["losses"]),
                "grad_norm_ratio_to_bf16_steps_1_2": [
                    g / b for g, b in zip(by[seed, variant]["grad_norms"][:2], bf16["grad_norms"][:2])
                ],
            }
        summary.append(row)
    out = {"steps": len(runs[0]["losses"]), "layers": args.layers, "rehearsal": args.rehearsal, "runs": runs, "summary": summary}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
