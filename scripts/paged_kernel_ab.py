#!/usr/bin/env python3
"""Time the paged attention (grouped-GEMM, flash, rmsnorm) kernel cases of `chip_smoke.py` for one checkout.

    python scripts/paged_kernel_ab.py [--root DIR] [--seed N] [--label NAME]
        [--family paged|grouped_gemm|flash|rmsnorm] [--constant FILE:NAME=VALUE ...]

Imports `chip_smoke` and `dolomite_engine_tpu_torch` from DIR (default: this checkout),
builds that checkout's kernels there, runs its phase-2 kernel cases and quantized-pool
cases (``--family grouped_gemm``: its MoE grouped-GEMM cases; ``flash``: its training
and alibi flash cases; ``rmsnorm``: its rmsnorm cases) on the card, and prints one
JSON line with the family's cases (kernel and device times, plain-version and library
times, bound, error, and the kernel path where the case names one) and the card's name
and power limit. To compare two commits on one card, unpack the other into a directory that
`.gitignore` lists and run both in one machine call, in turns (A, B, B, A).
``--constant paged_attention.cu:kSpan=128`` builds from a copy of the sources in which
that file's ``constexpr int kSpan`` is 128 (a tuning sweep; the checkout is not
changed); ``--build-only`` builds and exits, so several builds can run in parallel
first. Needs a CUDA device.
"""

import argparse
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label", default=None)
    parser.add_argument("--family", choices=("paged", "grouped_gemm", "flash", "rmsnorm"), default="paged")
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
    if args.family == "paged":
        cases = chip_smoke.kernel_cases(args.seed) + chip_smoke.quant_kernel_cases(args.seed)
    elif args.family == "grouped_gemm":
        cases = chip_smoke.moe_kernel_cases(args.seed)
    elif args.family == "flash":
        cases = chip_smoke.training_kernel_cases(args.seed) + chip_smoke.alibi_kernel_cases(args.seed)
    else:
        cases = _rmsnorm_cases(chip_smoke, args.seed)
    keep = (
        "kernel", "shape", "dtype", "path", "kernel_ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "max_abs_err", "sdpa_ms", "library", "visible_pairs", "computed_pairs",
    )
    picked = [
        {key: c[key] for key in keep if key in c} for c in cases if c["kernel"].startswith(args.family + "_")
        or c["kernel"] == args.family
    ]
    label = args.label or " ".join([root] + args.constant)
    print(json.dumps({"label": label, f"{args.family}_cases": picked, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
