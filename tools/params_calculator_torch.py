"""Count a model's parameters without materialising its weights, with the PyTorch port:
the model is built on torch's meta device (no storage, no init).

    python tools/params_calculator_torch.py [--config config.json]

The counterpart of `tools/params_calculator.py`, over the same default configuration (a
72-layer, 8192-wide GQA model); ``--config`` counts another one (a ``config.json``).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class  # noqa: E402

CONFIG = dict(
    model_type="gpt_dolomite",
    vocab_size=65024,
    n_positions=4096,
    n_embd=8192,
    n_layer=72,
    n_head=64,
    num_key_value_heads=8,
    n_inner=21888,
    position_embedding_type="rope",
    activation_function="swiglu",
    normalization_function="rmsnorm",
    attention_head_type="gqa",
    add_bias=False,
)


def num_parameters(config_dict: dict) -> int:
    config = config_from_dict(config_dict)
    model = get_model_class(config.model_type)(config, device="meta")
    return sum(p.numel() for p in model.parameters())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=None, help="a config.json to count instead of the default")
    args = p.parse_args(argv)
    config = CONFIG
    if args.config is not None:
        with open(args.config) as f:
            config = json.load(f)
    total = num_parameters(config)
    print("total", f"{total:,}")
    return total


if __name__ == "__main__":
    main()
