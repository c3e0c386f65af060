"""The serving fleet's disaggregation and router in the port against the JAX package, on the CPU.

The cases of `tests/test_serving_cluster.py` (TP-sharded replicas aside: ROADMAP.md Queue
A, 'Distribution') over the fleet tests' tiny model (`tests/torch_fleet.py`, fp32):

- prefill -> KV handoff -> decode gives the monolithic engine's tokens in both packages,
  greedy rows equal across the packages, sampled rows equal within the port;
- the handoff copies page bytes and, over int8 / fp8 pools, their scale rows byte for
  byte, and the decode side then serves the monolithic quantized engine's tokens;
- the ``prefill_only`` contract and the pool checks of `DisaggregatedEngine`;
- the router places the same requests where the JAX router does (``per_replica_routed``,
  prefix-affinity hits, rejections), keeps FCFS and deadlines per replica, composes with
  disaggregated replicas, and its threaded mode drains with the synchronous run's tokens;
- `generate.generate` with ``replicas: 2`` / ``disaggregate`` writes the JAX function's
  jsonl, and `generate.main` with both writes the single engine's;
- `tools/serve_torch.py --replicas 2 --disaggregate --trace --metrics-port 0` prints the
  generations `tools/serve.py` prints.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu import generate as jax_generate
from dolomite_engine_tpu.arguments import InferenceArgs as JaxInferenceArgs
from dolomite_engine_tpu.data import get_datasets_list as jax_get_datasets_list
from dolomite_engine_tpu.enums import DatasetSplit as JaxSplit
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper import ModelWrapperForFinetuning as JaxWrapper
from dolomite_engine_tpu.serving import DisaggregatedEngine as JaxDisaggregatedEngine
from dolomite_engine_tpu.serving import EngineReplica as JaxEngineReplica
from dolomite_engine_tpu.serving import QueueFullError as JaxQueueFullError
from dolomite_engine_tpu.serving import Router as JaxRouter
from dolomite_engine_tpu.serving import route_batch as jax_route_batch
from dolomite_engine_tpu.serving import serve_batch as jax_serve_batch
from dolomite_engine_tpu_torch import generate
from dolomite_engine_tpu_torch.arguments import InferenceArgs
from dolomite_engine_tpu_torch.data import get_datasets_list
from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.serving import (
    DisaggregatedEngine,
    EngineReplica,
    QueueFullError,
    RequestStatus,
    Router,
    SamplingParams,
    route_batch,
    serve_batch,
)
from tests.test_torch_data import WordTokenizer
from tests.test_torch_generate import _inference_config, _write_prompts
from tests.test_torch_model import ROPE_GQA
from tests.torch_fleet import (
    PAGE,
    fleet_models,
    for_jax,
    greedy_rows,
    jax_engine,
    jax_sampling,
    one_torch_thread,
    port_engine,
    random_prompt,
)


@pytest.fixture(autouse=True)
def single_thread():
    threads = one_torch_thread()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return fleet_models()


def _mixed_workload(rs):
    """A shared page-aligned prefix and unique tails, greedy and sampled rows: the paged,
    prefix and chunked regime at once (the JAX test's workload)."""
    shared = random_prompt(rs, 2 * PAGE)
    prompts = [shared + random_prompt(rs, 5), random_prompt(rs, 41), shared + random_prompt(rs, 9), random_prompt(rs, 7)]
    samplings = [
        SamplingParams(),
        SamplingParams(do_sample=True, temperature=0.8),
        SamplingParams(do_sample=True, temperature=1.2, top_k=7),
        SamplingParams(do_sample=True, top_p=0.9),
    ]
    return [dict(prompt_ids=prompts[i], max_new_tokens=6, sampling=samplings[i], seed=100 + i) for i in range(4)]


def _disagg(models, build, disagg_class, workers=2, **prefill_overrides):
    return disagg_class(build(models, prefill_only=True, **prefill_overrides), [build(models) for _ in range(workers)])


@pytest.fixture(scope="module")
def jax_disagg_run(models):
    """The JAX package's monolithic and disaggregated tokens on the mixed workload."""
    specs = jax_sampling(for_jax(_mixed_workload(np.random.RandomState(1))))
    mono = [s.tokens for s in jax_serve_batch(jax_engine(models), [dict(s) for s in specs])]
    disagg = _disagg(models, jax_engine, JaxDisaggregatedEngine)
    states = [disagg.submit(**dict(s)) for s in specs]
    disagg.drain()
    return mono, [s.tokens for s in states], disagg.handoff.transfers


# --------------------------------------------------------------------- disaggregation


def test_disaggregated_matches_monolithic_in_both_packages(models, jax_disagg_run):
    specs = _mixed_workload(np.random.RandomState(1))
    mono = [s.tokens for s in serve_batch(port_engine(models), [dict(s) for s in specs])]
    disagg = _disagg(models, port_engine, DisaggregatedEngine)
    states = [disagg.submit(**dict(s)) for s in specs]
    disagg.drain()
    jax_mono, jax_disagg, jax_transfers = jax_disagg_run
    assert [s.tokens for s in states] == mono  # sampled rows too: the generator state crossed
    assert jax_disagg == jax_mono
    for row in greedy_rows(specs):
        assert mono[row] == jax_mono[row]
    assert all(s.status == RequestStatus.completed for s in states)
    assert disagg.handoff.transfers == jax_transfers == len(specs) and disagg.handoff.mean_latency_s > 0
    assert disagg.prefill.stats.decode_tokens == 0 and all(w.stats.prefill_tokens == 0 for w in disagg.workers)
    assert disagg.prefill.pool.num_free == disagg.prefill.pool.num_slots
    assert all(w.pool.num_free == w.pool.num_slots for w in disagg.workers)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_kv_handoff_copies_page_and_scale_bytes(models, kv_dtype):
    """Every array of every layer (codes and, over a quantized pool, scale rows) of each
    transferred page is byte-identical on the decode side, and the decode worker serves
    the monolithic engine's tokens over the same pool type."""
    from dolomite_engine_tpu_torch.ops.kv_quant import as_bytes

    disagg = DisaggregatedEngine(port_engine(models, prefill_only=True, kv_dtype=kv_dtype), [port_engine(models, kv_dtype=kv_dtype)])
    prompt = random_prompt(np.random.RandomState(2), 2 * PAGE + 3)  # 3 pages: 2 full and a tail
    captured = {}
    transfer = disagg.handoff.transfer

    def capture(src_pool, src_pages, dst_pool, dst_pages):
        def snapshot(pool, pages):
            index = torch.as_tensor(pages)
            return [{name: as_bytes(array)[index].clone() for name, array in cache.items()} for cache in pool.caches]

        captured["src"] = snapshot(src_pool, src_pages)
        captured["pages"] = (list(src_pages), list(dst_pages))
        transfer(src_pool, src_pages, dst_pool, dst_pages)
        captured["dst"] = snapshot(dst_pool, dst_pages)

    disagg.handoff.transfer = capture
    state = disagg.submit(prompt_ids=prompt, max_new_tokens=4)
    disagg.drain()
    assert state.status == RequestStatus.completed
    assert len(captured["pages"][0]) == 3
    names = {"k", "v"} | ({"k_scale", "v_scale"} if kv_dtype in ("int8", "fp8") else set())
    for src, dst in zip(captured["src"], captured["dst"]):
        assert set(src) == names
        for name in names:
            assert torch.equal(src[name], dst[name]), name
    (mono,) = serve_batch(port_engine(models, kv_dtype=kv_dtype), [dict(prompt_ids=prompt, max_new_tokens=4)])
    assert state.tokens == mono.tokens


def test_handoff_pool_mismatch_rejected(models):
    with pytest.raises(ValueError):
        DisaggregatedEngine(port_engine(models, prefill_only=True), [port_engine(models, page_size=8)])
    with pytest.raises(ValueError):
        DisaggregatedEngine(port_engine(models, prefill_only=True), [port_engine(models, kv_dtype="int8")])
    with pytest.raises(ValueError):
        DisaggregatedEngine(port_engine(models), [port_engine(models)])


def test_prefill_only_contract(models):
    """A prefill-only engine streams the first token and parks the request for handoff,
    as the JAX engine does; it refuses the dense pool, speculation and preemption."""
    _, _, model = models
    for bad in (dict(paged=False), dict(speculate_ngram=True), dict(preemption="swap")):
        with pytest.raises(ValueError):
            port_engine(models, prefill_only=True, **bad)
    prompt = random_prompt(np.random.RandomState(3), 20)
    results = []
    for engine, kwargs in ((port_engine(models, prefill_only=True), {}), (jax_engine(models, prefill_only=True), {"rng": jax.random.PRNGKey(0)})):
        streamed = []
        state = engine.submit(prompt_ids=prompt, max_new_tokens=4, on_token=streamed.append, **kwargs)
        for _ in range(8):
            engine.step()
        assert state.tokens == streamed and len(streamed) == 1
        assert engine.pending_handoffs == 1 and not engine.has_work() and engine.stats.decode_tokens == 0
        results.append(streamed)
    assert results[0] == results[1]


def test_disagg_deadline_cancellation_spans_handoff(models):
    now = [0.0]
    disagg = DisaggregatedEngine(
        port_engine(models, prefill_only=True, clock=lambda: now[0]), [port_engine(models, clock=lambda: now[0])]
    )
    state = disagg.submit(prompt_ids=random_prompt(np.random.RandomState(4), 8), max_new_tokens=50, deadline_s=5.0)
    disagg.step()
    disagg.step()
    assert state.status == RequestStatus.running and state.slot is not None
    now[0] = 10.0  # the deadline passes on the decode worker
    disagg.drain()
    assert state.status == RequestStatus.cancelled
    assert disagg.workers[0].pool.num_free == disagg.workers[0].pool.num_slots


# ---------------------------------------------------------------------------- router


def _placement(models, build, replica_class, router_class, full_error, route, prompts_for):
    """Least-loaded placement with both queues at their bound of 2, then prefix affinity
    for a repeated prompt: the router's counters and the tokens."""
    engines = [build(models, max_waiting=2) for _ in range(2)]
    router = router_class([replica_class(i, e) for i, e in enumerate(engines)])
    rs = np.random.RandomState(5)
    for spec in prompts_for([dict(prompt_ids=random_prompt(rs, 9), max_new_tokens=2) for _ in range(4)]):
        router.submit(**spec)
    first = dict(router.stats.per_replica_routed)
    rejected = 0
    with pytest.raises(full_error):
        for spec in prompts_for([dict(prompt_ids=random_prompt(rs, 9), max_new_tokens=2) for _ in range(8)]):
            router.submit(**spec)
    rejected = router.stats.rejected
    router.drain()
    long_prompt = random_prompt(rs, 2 * PAGE + 4)
    specs = prompts_for([dict(prompt_ids=long_prompt, max_new_tokens=4)] + [dict(prompt_ids=random_prompt(rs, 9), max_new_tokens=4) for _ in range(3)])
    states = route(router, specs)
    again = router.submit(**prompts_for([dict(prompt_ids=long_prompt, max_new_tokens=4)])[0])
    router.drain()
    home = next(i for i, e in enumerate(engines) if e.prefix_match_len(long_prompt) > 0)
    return dict(
        first=first, rejected=rejected, routed=dict(router.stats.per_replica_routed), affinity=router.stats.affinity_hits,
        tokens=[s.tokens for s in states] + [again.tokens], home=home,
        hits=[e.stats.prefix_hit_tokens for e in engines],
    )


def test_router_placement_matches_jax(models):
    got = _placement(models, port_engine, EngineReplica, Router, QueueFullError, route_batch, lambda specs: specs)
    want = _placement(models, jax_engine, JaxEngineReplica, JaxRouter, JaxQueueFullError, jax_route_batch, for_jax)
    assert got == want
    assert got["first"] == {0: 2, 1: 2} and got["rejected"] == 1 and got["affinity"] == 1
    assert got["tokens"][-1] == got["tokens"][0]  # the prefix hit is token-exact
    assert got["hits"][got["home"]] > 0 and got["hits"][1 - got["home"]] == 0


def test_router_fcfs_and_deadline_through_router(models):
    now = [0.0]
    engines = [port_engine(models, num_slots=1, clock=lambda: now[0]) for _ in range(2)]
    replicas = [EngineReplica(i, e) for i, e in enumerate(engines)]
    router = Router(replicas)
    rs = np.random.RandomState(6)
    finish_order, states, homes = [], [], []
    for i in range(6):
        state = router.submit(prompt_ids=random_prompt(rs, 9), max_new_tokens=3, on_finish=lambda st, i=i: finish_order.append(i))
        states.append(state)
        homes.append(next(r.replica_id for r in replicas if state in r.engine.scheduler.waiting))
    doomed = router.submit(prompt_ids=random_prompt(rs, 9), max_new_tokens=3, deadline_s=1.0)
    now[0] = 5.0
    router.drain()
    assert all(s.status == RequestStatus.completed for s in states) and doomed.status == RequestStatus.cancelled
    for replica_id in (0, 1):
        mine = [i for i in range(6) if homes[i] == replica_id]
        assert [i for i in finish_order if i in mine] == mine


def test_router_over_disaggregated_replicas(models, tmp_path):
    """Replicas that are prefill + decode pairs: every request completes with the
    monolithic tokens, the replica ids reach the underlying engines and the router record
    reports the handoffs."""
    from dolomite_engine_tpu_torch.utils.telemetry import Telemetry, install_telemetry, uninstall_telemetry

    replicas = [EngineReplica(i, _disagg(models, port_engine, DisaggregatedEngine, workers=1)) for i in range(2)]
    rs = np.random.RandomState(8)
    specs = [dict(prompt_ids=random_prompt(rs, 9 + 4 * i), max_new_tokens=3) for i in range(4)]
    mono = [s.tokens for s in serve_batch(port_engine(models), [dict(s) for s in specs])]
    sink = tmp_path / "router.jsonl"
    telemetry = Telemetry(sink_path=str(sink), rank=0)
    install_telemetry(telemetry)
    try:
        states = route_batch(Router(replicas), specs)
    finally:
        uninstall_telemetry()
        telemetry.close()
    assert [s.tokens for s in states] == mono
    assert sum(r.engine.handoff.transfers for r in replicas) == 4
    assert replicas[0].engine.prefill.replica_id == 0 and replicas[1].engine.workers[0].replica_id == 1
    records = [json.loads(line) for line in open(sink)]
    router_record = [r for r in records if r["kind"] == "router"][-1]
    assert router_record["counters"]["kv_handoffs"] == 4 and router_record["handoff_latency_ms"] > 0
    assert {r["replica_id"] for r in records if r["kind"] == "serving"} == {0, 1}


def test_router_threaded_mode_drains(models):
    """Replicas step on their own threads; the router only submits and waits. Every
    request completes with the synchronous run's tokens and the pools come back."""
    rs = np.random.RandomState(9)
    specs = [dict(prompt_ids=random_prompt(rs, 9 + 2 * i), max_new_tokens=3) for i in range(4)]
    sync = [s.tokens for s in route_batch(Router([EngineReplica(i, port_engine(models)) for i in range(2)]), [dict(s) for s in specs])]
    engines = [port_engine(models) for _ in range(2)]
    router = Router([EngineReplica(i, e) for i, e in enumerate(engines)])
    router.start()
    try:
        states = [router.submit(**dict(s)) for s in specs]
        assert router.wait(timeout_s=120.0), "the threaded fleet did not drain"
    finally:
        router.stop()
    assert [s.tokens for s in states] == sync
    assert all(s.status == RequestStatus.completed for s in states)
    assert sum(e.stats.completed for e in engines) == 4 and all(e.pool.num_free == e.pool.num_slots for e in engines)


# ------------------------------------------------------------------------- generate.py


@pytest.mark.parametrize(
    "fleet",
    [dict(replicas=2), dict(disaggregate=True), dict(replicas=2, disaggregate=True, trace_requests=True)],
    ids=["replicas", "disaggregate", "replicas-disaggregate-trace"],
)
def test_generate_fleet_writes_the_jax_jsonl(tmp_path, fleet):
    config = dict(ROPE_GQA, initializer_range=0.3)
    prompts = _write_prompts(tmp_path / "prompts", config["vocab_size"])
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=config)

    def with_fleet(output):
        run = _inference_config(prompts, tmp_path / output, True, model_args=model_args)
        run["generation_parameters"].update(fleet)
        return run

    jax_args = JaxInferenceArgs(**with_fleet("jax"))
    jax_model = JaxWrapper(mode=JaxMode.inference, pretrained_config=config)
    jax_model.tokenizer = WordTokenizer()
    params = nn.unbox(jax_model.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    datasets, _ = jax_get_datasets_list(jax_args.datasets, JaxSplit.test, JaxMode.inference, jax_model.tokenizer)
    jax_generate.generate(jax_args, jax_model, params, datasets, JaxMode.inference)

    args = InferenceArgs(**with_fleet("port"))
    model = ModelWrapperForFinetuning(config, device="cpu")
    model.tokenizer = WordTokenizer()
    load_jax_params(model.model, jax.tree.map(np.asarray, params), device="cpu")
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer)
    summary = generate.generate(args, model, datasets, Mode.inference)

    got = (tmp_path / "port" / "output-prompts.jsonl").read_text()
    assert got == (tmp_path / "jax" / "output-prompts.jsonl").read_text()
    replicas = fleet.get("replicas", 1)
    assert summary["router"].routed == 5 and sum(summary["router"].per_replica_routed.values()) == 5
    assert len(summary["router"].per_replica_routed) == replicas
    engines = replicas * (2 if fleet.get("disaggregate") else 1)
    assert summary["pool"]["engines"] == len(summary["engine_stats"]) == engines
    assert summary["stats"].completed == 5
    assert summary["handoff"]["transfers"] == (5 if fleet.get("disaggregate") else 0)


def test_generate_main_with_replicas_and_disaggregation(tmp_path):
    """`generate.main` from `model_args` (seeded weights) over 2 disaggregated replicas
    writes what the single engine writes."""
    config = dict(ROPE_GQA, initializer_range=0.3)
    prompts = _write_prompts(tmp_path / "prompts", config["vocab_size"], rows=4)
    import chip_smoke

    tokenizer = chip_smoke.word_tokenizer(str(tmp_path / "tokenizer"), config["vocab_size"], config["eos_token_id"])
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=config)
    outputs = []
    for name, fleet in (("single", {}), ("fleet", dict(replicas=2, disaggregate=True))):
        run = _inference_config(prompts, tmp_path / name, True, model_args=model_args, tokenizer_args={"tokenizer_name": tokenizer})
        run["generation_parameters"].update(fleet)
        summary = generate.main(InferenceArgs(**run), device="cpu")
        outputs.append((tmp_path / name / "output-prompts.jsonl").read_text())
    assert outputs[0] == outputs[1] and outputs[0].count("\n") == 4
    assert summary["router"].per_replica_routed == {0: 2, 1: 2} and summary["handoff"]["transfers"] == 4


# ------------------------------------------------------------------------ the CLI tool


def test_serve_torch_prints_what_the_jax_tool_prints(tmp_path, monkeypatch, capsys):
    """`tools/serve_torch.py` over 2 disaggregated replicas with tracing and the metrics
    server (port 0) writes the generations `tools/serve.py` writes for the same prompts
    from the same directory (greedy, fp32), one trace record a request, and fleet records."""
    import chip_smoke
    from dolomite_engine_tpu.parallel.mesh import MeshManager as JaxMeshManager
    from tests.test_torch_tools import _tool

    tokenizer = chip_smoke.word_tokenizer(str(tmp_path / "tokenizer"), 96, 0)
    config = dict(ROPE_GQA, initializer_range=0.3, eos_token_id=0, pad_token_id=0, bos_token_id=0)
    wrapper = JaxWrapper(mode=JaxMode.inference, pretrained_config=config, tokenizer_name=tokenizer)
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    wrapper.save_pretrained(str(tmp_path / "model"), params=params)
    flags = [
        "--model", str(tmp_path / "model"), "--prompt", "t5 t17 t33 t8", "--prompt", "t41 t2 t90", "--prompt", "t7 t7 t9",
        "--max-new-tokens", "6", "--bucket-multiple", "8", "--num-slots", "2", "--replicas", "2", "--disaggregate", "--trace",
    ]

    def texts(out):
        return [{k: line[k] for k in ("prompt", "generated_text", "num_generated_tokens", "status")} for line in map(json.loads, out.splitlines())]

    JaxMeshManager.destroy()
    monkeypatch.setattr(sys, "argv", ["serve.py", *flags])
    try:
        _tool("serve").main()
    finally:
        JaxMeshManager.destroy()
    want = texts(capsys.readouterr().out)
    sink = tmp_path / "serve.jsonl"
    states = _tool("serve_torch").main(
        [*flags, "--metrics-port", "0", "--telemetry-sink", str(sink), "--health-monitoring", "--device", "cpu", "--dtype", "fp32"]
    )
    captured = capsys.readouterr()
    assert texts(captured.out) == want and len(states) == 3
    assert "observability: http://127.0.0.1:" in captured.err and "router: 3 routed" in captured.err
    records = [json.loads(line) for line in open(sink)]
    assert sum(r["kind"] == "trace" for r in records) == 3
    assert any(r["kind"] == "fleet" for r in records) and any(r["kind"] == "router" for r in records)
    assert all(any(s["name"] == "handoff" for s in r["spans"]) for r in records if r["kind"] == "trace")
    with pytest.raises(NotImplementedError, match="'Distribution'"):
        _tool("serve_torch").main([*flags, "--tp", "2", "--device", "cpu"])
