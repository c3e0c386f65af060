#!/usr/bin/env python3
"""Time the paged attention (grouped-GEMM, flash, rmsnorm, paged K/V write, fused_ce) kernel cases of `chip_smoke.py` for one checkout.

    python scripts/paged_kernel_ab.py [--root DIR] [--seed N] [--label NAME]
        [--family paged|grouped_gemm|flash|rmsnorm|paged_write|fused_ce] [--constant FILE:NAME=VALUE ...]

Imports `chip_smoke` and `dolomite_engine_tpu_torch` from DIR (default: this checkout),
builds that checkout's kernels there, runs its phase-2 kernel cases and quantized-pool
cases (``--family grouped_gemm``: its MoE grouped-GEMM cases; ``flash``: its training
and alibi flash cases; ``rmsnorm``: its rmsnorm cases) on the card, and prints one
JSON line with the family's cases (kernel and device times, plain-version and library
times, bound, error, and the kernel path where the case names one) and the card's name
and power limit. ``--family paged_write`` times what the serving K/V write moves instead:
the flat rope kernel at fixed shapes through the checkout's wrapper, then on
granite-3b-code (32 layers, bf16, random weights from the seed) the device launches and
device time of a prefill chunk and a decode step (`chip_smoke.launches_per_forward`)
and the host time of a decode step over 8 busy slots, over bf16, int8 and fp8 pools,
the same for the MoE model of `pretrain-moe-ep.yml` over bf16 and int8 pools, the
greedy tokens of `chip_smoke.serve` on both models' bf16 cells (a digest), and the
losses and step times of `chip_smoke.train_slice` on the dense and MoE training cells (the flat rope
kernel's forward and backward). ``--family fused_ce`` prints `chip_smoke.fused_ce_kernel_cases`
and then the losses, grad norms and step times of `chip_smoke.train_slice` on the dense, MoE
and alibi training cells (``--cases-only``: the cases alone). To compare two commits on one card, unpack the other into a directory that
`.gitignore` lists and run both in one machine call, in turns (A, B, B, A).
``--constant paged_attention.cu:kSpan=128`` builds from a copy of the sources in which
that file's ``constexpr int kSpan`` is 128 (a tuning sweep; the checkout is not
changed); ``--build-only`` builds and exits, so several builds can run in parallel
first. Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path


def _patch_constants(constants):
    """Point the kernel build at a copy of the sources with each ``FILE:NAME=VALUE``
    constant set, built in a directory of its own."""
    from dolomite_engine_tpu_torch.ops.kernels import _build

    tag = "-".join(re.sub(r"[^A-Za-z0-9]+", "_", constant) for constant in constants)
    work = _build.BUILD_DIR / f"ab-{tag}"  # the same constants reuse their build
    csrc = work / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    for constant in constants:
        name, assignment = constant.split(":")
        symbol, value = assignment.split("=")
        source = csrc / name
        text, count = re.subn(rf"(constexpr int {symbol} = )[^;]+;", rf"\g<1>{value};", source.read_text())
        if count != 1:
            raise ValueError(f"{name} does not define constexpr int {symbol} once")
        source.write_text(text)
    _build.CSRC_DIR = csrc
    _build.BUILD_DIR = work / "build"


# rmsnorm shapes timed the same way in every checkout: granite's and the MoE slice's
# rows, and a decode step
RMSNORM_SHAPES = ((4096, 2560), (4096, 1024), (8, 2560))


def _rmsnorm_cases(chip_smoke, seed):
    """bf16 rmsnorm (plain and residual form) at RMSNORM_SHAPES through this checkout's
    wrapper, with `F.rms_norm` beside the plain form."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.kernels import rmsnorm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    for rows, dim in RMSNORM_SHAPES:
        x, r = (torch.randn((rows, dim), generator=gen, device="cuda").bfloat16() for _ in range(2))
        w = torch.randn((dim,), generator=gen, device="cuda") * 0.1 + 1.0
        for residual in (None, r):
            run = lambda res=residual: rmsnorm.fused_rmsnorm(x, w, 1e-5, residual=res)
            got = run()
            want = rmsnorm.fused_rmsnorm_plain(x, w, 1e-5, residual=residual)
            got, want = (got, want) if residual is None else (got[0], want[0])
            n_io = 2 if residual is None else 4
            cases.append({
                "kernel": "rmsnorm", "shape": f"[{rows},{dim}]" + ("" if residual is None else "+residual"),
                "dtype": "bfloat16", "max_abs_err": (got.float() - want.float()).abs().max().item(),
                "kernel_ms": chip_smoke._time_ms(run), "device_ms": chip_smoke._device_ms(run),
                "library_ms": None if residual is not None else chip_smoke._time_ms(
                    lambda: F.rms_norm(x, (dim,), w.bfloat16(), 1e-5)
                ),
                "bound_ms": chip_smoke._bound(n_io * rows * dim * 2 + dim * 4, 4 * rows * dim, "bfloat16")[0],
            })
    return cases


# rope shapes timed the same way in every checkout: a prefill chunk, a decode step and a
# training row of granite-3b-code's fused projection (32 + 2 x 32 heads of 80)
ROPE_SHAPES = ((1, 512), (8, 1), (1, 4096))


def _decode_host_ms(model, kv_dtype, steps=16):
    """Mean host time of a decode step over 8 busy slots (300-token prompts prefilled
    first), each step ending in the host fetch of its tokens; steps that ran a prefill
    chunk are not timed."""
    import time

    import torch

    from dolomite_engine_tpu_torch.serving import ServingEngine

    engine = ServingEngine(
        model, None, num_slots=8, max_len=2048, page_size=16, prefill_chunk_tokens=512,
        eos_token_id=None, pad_token_id=model.config.pad_token_id, kv_dtype=kv_dtype,
    )
    for i in range(8):
        engine.submit(list(range(1 + i, 301 + i)), max_new_tokens=steps + 16)
    times = []
    while len(times) < steps:
        chunks = engine.stats.prefill_chunks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        if engine.stats.prefill_chunks == chunks:
            times.append((time.perf_counter() - t0) * 1e3)
    engine.drain()
    return sum(times) / len(times)


def _paged_write_ab(chip_smoke, seed):
    """The ``paged_write`` family (see the module's docstring)."""
    import gc
    import hashlib

    import torch

    from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class
    from dolomite_engine_tpu_torch.ops.kernels import rope_qkv

    gen = torch.Generator(device="cuda").manual_seed(seed)
    heads, head_dim = 32, 80
    width = 3 * heads * head_dim
    rope = []
    for batch, seq in ROPE_SHAPES:
        qkv = torch.randn((batch, seq, width), generator=gen, device="cuda").bfloat16()
        angles = torch.rand((1, seq, head_dim), generator=gen, device="cuda") * 6.0
        cos, sin = angles.cos().bfloat16(), angles.sin().bfloat16()  # the model's dtype, shared over the batch
        run = lambda: rope_qkv.fused_rope_qkv(qkv, cos, sin, heads, heads, head_dim)  # noqa: E731
        nbytes = 2 * batch * seq * width * 2 + 2 * seq * head_dim * 2
        rope.append({
            "shape": f"[{batch},{seq},{width}]", "kernel_ms": chip_smoke._time_ms(run),
            "device_ms": chip_smoke._device_ms(run, iters=100),
            "bound_ms": chip_smoke._bound(nbytes, 6 * batch * seq * 2 * heads * head_dim, "bfloat16")[0],
        })
        del qkv
    out = {"rope": rope, "decode": {}, "greedy_sha256": {}}
    for name, config, pools in (
        ("granite-3b-code", chip_smoke.GRANITE_3B_CODE, (None, "int8", "fp8")),
        ("moe", chip_smoke.MOE_EP, (None, "int8")),
    ):
        config = config_from_dict(config)
        model = get_model_class(config.model_type)(config, dtype=torch.bfloat16, device="cuda", seed=seed)
        for kv_dtype in pools:
            record = chip_smoke.launches_per_forward(model, kv_dtype)
            record["decode_step_host_ms_8_slots"] = _decode_host_ms(model, kv_dtype)
            out["decode"][f"{name} {kv_dtype or 'bf16'}"] = record
        _, _, _, _, greedy = chip_smoke.serve(seed, model=model)
        out["greedy_sha256"][name] = hashlib.sha256(json.dumps(greedy).encode()).hexdigest()
        del model
        gc.collect()
        torch.cuda.empty_cache()
    out["training"] = _training_cells(chip_smoke, seed, ("granite-3b-code", "moe"))
    return out


def _fused_ce_cases(chip_smoke, seed):
    """`chip_smoke.fused_ce_kernel_cases` of the checkout; one from before those cases
    existed is timed through this script's own copy of them (its wrapper takes the same
    arguments)."""
    if not hasattr(chip_smoke, "fused_ce_kernel_cases"):
        spec = importlib.util.spec_from_file_location("chip_smoke_cases", Path(__file__).resolve().parents[1] / "chip_smoke.py")
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
    return chip_smoke.fused_ce_kernel_cases(seed)


def _training_cells(chip_smoke, seed, names=("granite-3b-code", "moe", "alibi")):
    """Losses, grad norms and step times of the training cells `names` (dense, MoE, alibi)."""
    import gc

    import torch

    cells = {}
    for name, args, options in (
        ("granite-3b-code", (), {}),
        (
            "moe", (dict(chip_smoke.MOE_EP, n_layer=chip_smoke.MOE_TRAIN_LAYERS),),
            {"seq": chip_smoke.MOE_TRAIN_SEQ, "micro_batch": chip_smoke.MOE_TRAIN_MICRO},
        ),
        (
            "alibi", (dict(chip_smoke.ALIBI_TRAIN_CONFIG, n_layer=chip_smoke.ALIBI_TRAIN_LAYERS),),
            {"seq": chip_smoke.ALIBI_TRAIN_SEQ, "micro_batch": chip_smoke.ALIBI_TRAIN_MICRO},
        ),
    ):
        if name not in names:
            continue
        training, launches, held = chip_smoke.train_slice(seed, *args, **options)
        cells[name] = {
            "losses": training["losses"], "grad_norms": training["grad_norms"], "step_s": training["step_s"],
            "fused_ce_launches": launches["fused_ce"],
        }
        del held
        gc.collect()
        torch.cuda.empty_cache()
    return cells


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label", default=None)
    parser.add_argument(
        "--family", choices=("paged", "grouped_gemm", "flash", "rmsnorm", "paged_write", "fused_ce"), default="paged"
    )
    parser.add_argument("--cases-only", action="store_true", help="fused_ce: the kernel cases without the training cells")
    parser.add_argument("--constant", action="append", default=[])
    parser.add_argument("--build-only", action="store_true", help="build the kernels and exit")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("paged_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke

    if args.constant:
        _patch_constants(args.constant)
    if args.build_only:
        from dolomite_engine_tpu_torch.ops.kernels._build import load_library

        load_library()
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    label = args.label or " ".join([root] + args.constant)
    if args.family == "paged_write":
        results = _paged_write_ab(chip_smoke, args.seed)
        print(json.dumps({"label": label, "paged_write": results, "card": card}), flush=True)
        return 0
    if args.family == "paged":
        cases = chip_smoke.kernel_cases(args.seed) + chip_smoke.quant_kernel_cases(args.seed)
    elif args.family == "grouped_gemm":
        cases = chip_smoke.moe_kernel_cases(args.seed)
    elif args.family == "fused_ce":
        cases = _fused_ce_cases(chip_smoke, args.seed)
    elif args.family == "flash":
        cases = chip_smoke.training_kernel_cases(args.seed) + chip_smoke.alibi_kernel_cases(args.seed)
    else:
        cases = _rmsnorm_cases(chip_smoke, args.seed)
    keep = (
        "kernel", "shape", "dtype", "path", "kernel_ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "max_abs_err", "sdpa_ms", "library", "visible_pairs", "computed_pairs", "gemm_ms",
        "bit_identical_run_to_run",
    )
    picked = [
        {key: c[key] for key in keep if key in c} for c in cases if c["kernel"].startswith(args.family + "_")
        or c["kernel"] == args.family
    ]
    print(json.dumps({"label": label, f"{args.family}_cases": picked, "card": card}), flush=True)
    if args.family == "fused_ce" and not args.cases_only:
        print(json.dumps({"label": label, "training": _training_cells(chip_smoke, args.seed), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
