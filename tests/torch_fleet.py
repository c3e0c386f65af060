"""Shared set-up of the fleet tests (`tests/test_torch_serving_{cluster,faults,observability,tracing}.py`).

One tiny model in both packages (2 layers, n_embd 64, vocab 512, GQA, rope, rmsnorm) with
the same weights, the JAX fleet tests' engine arguments (16-token pages, 16-token prefill
chunks, 2 slots), and the same requests for both: a JAX request's sampling key and a port
request's seed name different streams by design, so sampled rows are held to the port's
own runs and greedy rows to the JAX package's.
"""

import jax
import numpy as np
import torch

from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu_torch.serving import SamplingParams, ServingEngine
from tests.test_torch_model import make_models

PAGE = 16
FLEET_MODEL = dict(
    vocab_size=512, n_positions=512, n_embd=64, n_layer=2, n_head=4, num_key_value_heads=2,
    attention_head_type="gqa", position_embedding_type="rope", add_bias=True,
    activation_function="gelu_pytorch_tanh", normalization_function="rmsnorm", resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2,
)


def fleet_models():
    """(jax model, jax params, port model) with the same weights."""
    return make_models(FLEET_MODEL)


def engine_kwargs(**overrides):
    kwargs = dict(
        num_slots=2, max_len=96, prefill_bucket_multiple=8, eos_token_id=None,
        pad_token_id=FLEET_MODEL["pad_token_id"], page_size=PAGE,
        prefill_chunk_tokens=16,  # long prompts take >= 2 chunks: mid-prefill states exist
    )
    kwargs.update(overrides)
    return kwargs


def jax_engine(models, **overrides):
    jax_model, params, _ = models
    return JaxServingEngine(jax_model, params, **engine_kwargs(**overrides))


def port_engine(models, **overrides):
    return ServingEngine(models[2], None, device="cpu", **engine_kwargs(**overrides))


def random_prompt(rs, length):
    return list(map(int, rs.randint(3, FLEET_MODEL["vocab_size"], length)))


def for_jax(specs, base_key=100):
    """Port request specs as the JAX engine takes them: ``seed`` becomes a PRNG key."""
    out = []
    for i, spec in enumerate(specs):
        spec = dict(spec)
        seed = spec.pop("seed", None)
        spec["rng"] = jax.random.PRNGKey(base_key + i if seed is None else seed)
        out.append(spec)
    return out


def fleet_workload():
    """The JAX fault tests' four in-flight requests: three greedy, one sampled (row 2,
    which lands on replica 0 under least-loaded placement)."""
    rs = np.random.RandomState(1234)
    prompts = [random_prompt(rs, 20), random_prompt(rs, 17), random_prompt(rs, 23), random_prompt(rs, 9)]
    specs = [dict(prompt_ids=p, max_new_tokens=8) for p in prompts]
    specs[2]["sampling"] = SamplingParams(do_sample=True, temperature=0.9)
    specs[2]["seed"] = 42
    return specs


def jax_sampling(specs):
    """The JAX package's `SamplingParams` in place of the port's (the same fields)."""
    from dolomite_engine_tpu.serving import SamplingParams as JaxSamplingParams

    out = []
    for spec in specs:
        spec = dict(spec)
        sampling = spec.get("sampling")
        if sampling is not None:
            spec["sampling"] = JaxSamplingParams(
                do_sample=sampling.do_sample, temperature=sampling.temperature, top_k=sampling.top_k,
                top_p=sampling.top_p,
            )
        out.append(spec)
    return out


def greedy_rows(specs):
    return [i for i, spec in enumerate(specs) if spec.get("sampling") is None or not spec["sampling"].do_sample]


def read_sink(path):
    import json

    return [json.loads(line) for line in open(path)]


def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads
