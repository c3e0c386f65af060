"""The port stands alone: no JAX, no flax, nothing of the JAX package.

`dolomite_engine_tpu_torch` keeps its own copies of the framework-neutral modules it
needs (the finetuning sampler and dataloader among them), so it imports on a machine without JAX (the GPU machine that runs
`chip_smoke.py` has none). Its entry points run on the GPU unless told otherwise.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dolomite_engine_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "dolomite_engine_tpu")


def _port_sources():
    # build/ holds what the kernel build writes at run time, not the package's sources
    return sorted(p for p in PORT.rglob("*.py") if "build" not in p.relative_to(PORT).parts)


def _port_tools():
    # the port's CLI tools, named ``*_torch.py`` beside the JAX package's
    return sorted((REPO / "tools").glob("*_torch.py"))


def _port_files():
    # with the port's harnesses for the card and its tools
    return _port_sources() + [
        REPO / "chip_smoke.py", REPO / "scripts" / "paged_kernel_ab.py", REPO / "scripts" / "fsdp_one_rank_probe.py",
        REPO / "scripts" / "serve_torch_fleet_check.py",
    ] + _port_tools()


def _port_modules():
    return [
        ".".join(path.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for path in _port_sources()
    ]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_the_jax_package(path):
    # the root of `dolomite_engine_tpu_torch.x` is the port itself, which is allowed
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_the_distribution_modules_are_covered():
    """The data-parallel slice's modules are among the checked ones, and the spawned
    test ranks (`tests/torch_ranks.py`, which run the port alone) import no JAX either."""
    modules = set(_port_modules())
    for name in ("parallel", "parallel.mesh", "parallel.sharding", "distributed", "utils.distributed", "data.dataloader"):
        assert f"dolomite_engine_tpu_torch.{name}" in modules, name
    assert not _imported_roots(REPO / "tests" / "torch_ranks.py") & set(FORBIDDEN)


def test_the_family_modules_are_covered():
    """The cross-layer, dense-MoE and DeltaNet-hybrid modules are among the checked ones."""
    modules = set(_port_modules())
    for name in ("models.gpt_crosslayer", "models.dense_moe", "models.rnn_dolomite", "ops.deltanet"):
        assert f"dolomite_engine_tpu_torch.{name}" in modules, name


def test_the_fleet_modules_are_covered():
    """The serving fleet's and the observability plane's modules and tools are among the
    checked ones (their JAX counterparts import no JAX, and the port still keeps copies)."""
    modules = set(_port_modules())
    for name in (
        "serving.cluster", "serving.cluster.router", "serving.cluster.disagg", "serving.cluster.health",
        "serving.cluster.faults", "serving.cluster.metrics", "serving.obs_server", "utils.tracing",
    ):
        assert f"dolomite_engine_tpu_torch.{name}" in modules, name
    tools = {path.name for path in _port_tools()}
    assert {"serve_torch.py", "trace_analyze_torch.py"} <= tools


def test_every_module_imports_with_jax_blocked():
    script = "\n".join(
        [
            "import sys",
            *(f"sys.modules[{name!r}] = None" for name in FORBIDDEN),
            "import importlib",
            f"for name in {_port_modules()!r}:",
            "    importlib.import_module(name)",
            "import chip_smoke",
            "print('ok')",
        ]
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    result = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_entry_points_default_to_the_gpu():
    import torch

    from dolomite_engine_tpu_torch import finetune, generate, unshard
    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.models import CommonConfig, GPTDolomiteForCausalLM, load_jax_params
    from dolomite_engine_tpu_torch.serving import ServingEngine

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    config = CommonConfig(vocab_size=64, n_embd=16, n_layer=1, n_head=2, attention_head_type="mha")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTDolomiteForCausalLM(config)
    model = GPTDolomiteForCausalLM(config, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, None, num_slots=1, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, None, num_slots=1, max_len=32, paged=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate.main(object())  # the device is resolved before the args are read
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune.main(object())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        unshard.main(object())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_jax_params(model, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelWrapperForPretraining(config)
