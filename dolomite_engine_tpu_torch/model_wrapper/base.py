"""ModelWrapper: the config, the tokenizer and the model of one run.

Counterpart of `dolomite_engine_tpu/model_wrapper/base.py`: the config from
`pretrained_config` (with `config_extras` over it), the HF tokenizer (with
`additional_special_tokens`, which grow the vocabulary when the tokenizer outgrows it),
the model built by the registry from the config's ``model_type`` on `device` with random
weights from `seed` (``model_class`` ``AutoModelForSeq2SeqLM`` for the encoder-decoder
family, ``AutoModelForCausalLM`` for the others, as JAX checks), and batch generation
(`generate`, through `generation_utils.make_generate_fn`; an encoder-decoder decodes from
its ``decoder_start_token_id``), and the HF-layout directory (`save_pretrained`,
`load_pretrained_params`: ``config.json``, the safetensors in the reference layout of
`hf_interop.weights`, the tokenizer). The wrapper owns
the port's model directly: there are no separate params, no sharding rules and no apply
scope. `model_name` as a local directory gives the config (its ``config.json``, which must
name a dolomite family) and the tokenizer, as the JAX package's `_setup_config` does; its
weights are read where the JAX package reads them: generation without ``load_args`` and a
draft model by name (`generate.py`). Finetuning keeps random weights from `model_name`, as
in the JAX package, which starts a finetune from trained weights through ``load_args``. A
hub id is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import time

import torch

from ..enums import AttentionImplementation, Mode
from ..hf_interop.weights import params_to_state_dict, state_dict_to_params
from ..models import CommonConfig, config_from_dict, get_model_class, is_encoder_decoder_model
from ..ops.fp8 import enable_fp8
from ..train_utils import resolve_checkpointing_args
from ..utils import log_rank_0
from ..utils.hf_hub import HUB_NOT_PORTED
from ..utils.mixed_precision import string_to_dtype
from ..utils.safetensors import SafeTensorsWeightsManager

# the JAX package's model registry (`models.is_custom_model`): the types a config.json may name
_DOLOMITE_TYPES = (
    "gpt_dolomite", "moe_dolomite", "gpt_crosslayer", "dense_moe", "rnn_dolomite", "enc_dec_dolomite",
)


def config_from_model_name(model_name: str, config_extras: dict | None = None) -> CommonConfig:
    """The config of a local checkpoint directory's ``config.json`` (`config_extras` over
    it); a model type that is not a dolomite family raises the JAX package's ValueError.
    A name that is not a local directory (a hub id) raises NotImplementedError."""
    if not os.path.isdir(model_name):
        raise NotImplementedError(f"model_args.model_name '{model_name}' is not a local directory: {HUB_NOT_PORTED}")
    config_path = os.path.join(model_name, "config.json")
    if not os.path.isfile(config_path):
        raise ValueError(f"no config.json in resolved checkpoint dir '{model_name}'")
    with open(config_path) as f:
        config_dict = json.load(f)
    model_type = config_dict.get("model_type")
    if model_type not in _DOLOMITE_TYPES:
        raise ValueError(
            f"model_name '{model_name}' has model_type '{model_type}', which is not a "
            "dolomite model family; convert it first with "
            "hf_interop.import_from_huggingface(model_name, save_path)"
        )
    return config_from_dict(dict(config_dict, **(config_extras or {})))


def _load_tokenizer(name: str | None):
    """The HF tokenizer `name`, or None: pretraining reads token ids, so a tokenizer that
    cannot load (no `transformers`, no network) is warned about and left out, as in the JAX
    package's `ModelWrapper._setup_tokenizer`."""
    if name is None:
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name)
    except Exception as error:  # the tokenizer is optional for pretraining on token bins
        log_rank_0(logging.WARNING, f"could not load tokenizer '{name}': {error}")
        return None


class ModelWrapper:
    def __init__(
        self,
        pretrained_config: dict | CommonConfig | None,
        mode: Mode = Mode.inference,
        dtype: str | torch.dtype = "fp32",
        param_dtype: str | torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str | None = None,
        gradient_checkpointing_args: dict | None = None,
        model_name: str | None = None,
        tokenizer_name: str | None = None,
        additional_special_tokens: list[str] | None = None,
        config_extras: dict | None = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
        model_class: str | None = None,
        scan_layers: bool = False,
    ) -> None:
        """`dtype` is the compute dtype ("fp8": bf16 compute with fp8 dots, the state in
        `fp8`) and `param_dtype` (default `dtype`) the storage of the linear and embedding
        weights: fp32 master weights for training, the compute dtype for inference.
        `model_class` (the YAML's, when given) must match the family: an encoder-decoder
        takes ``AutoModelForSeq2SeqLM``, the decoder-only families ``AutoModelForCausalLM``.
        `scan_layers` changes nothing in the port (its blocks run in a Python loop) but is
        refused, as in JAX, for the families whose blocks differ (MoE's extra outputs,
        cross-layer groups, the hybrid's mixers)."""
        self.mode = mode
        self.model_name = model_name
        if model_name is not None:
            self.config = config_from_model_name(model_name, config_extras)
        elif isinstance(pretrained_config, CommonConfig):
            self.config = pretrained_config
        else:
            self.config = config_from_dict(dict(pretrained_config, **(config_extras or {})))
        self.model_type = self.config.model_type
        if model_class is not None and is_encoder_decoder_model(self.model_type) != (
            model_class == "AutoModelForSeq2SeqLM"
        ):
            raise ValueError(
                f"model_class '{model_class}' does not match model_type '{self.model_type}': "
                "encoder-decoder families require AutoModelForSeq2SeqLM, decoder-only families "
                "AutoModelForCausalLM"
            )
        if scan_layers and self.model_type not in ("gpt_dolomite", "enc_dec_dolomite"):
            raise ValueError(
                f"scan_layers supports gpt_dolomite and enc_dec_dolomite (got "
                f"'{self.model_type}'): MoE extras, per-group crosslayer and pattern-mixed "
                "RNN blocks cannot ride one homogeneous scan"
            )
        # fp8 = bf16 compute + delayed-scaling fp8 dots (`ops/fp8.py`), as in the JAX package
        self.use_fp8 = dtype == "fp8"
        self.dtype = torch.bfloat16 if self.use_fp8 else string_to_dtype(dtype)
        self.tokenizer = _load_tokenizer(tokenizer_name or model_name)
        if self.tokenizer is not None and additional_special_tokens:
            added = self.tokenizer.add_special_tokens({"additional_special_tokens": additional_special_tokens})
            if added > 0 and self.tokenizer.vocab_size > self.config.vocab_size:
                # the embedding grows with the tokenizer (resize_token_embeddings)
                self.config.vocab_size = len(self.tokenizer)
        self.checkpoint_every, self.checkpoint_policy = resolve_checkpointing_args(
            None, gradient_checkpointing_args
        )
        self.model = get_model_class(self.model_type)(
            self.config,
            dtype=self.dtype,
            device=device,
            seed=seed,
            param_dtype=string_to_dtype(param_dtype) if param_dtype else self.dtype,
            attention_implementation=attention_implementation or AttentionImplementation.sdpa,
            checkpoint_every=self.checkpoint_every,
            checkpoint_policy=self.checkpoint_policy,
        )
        self.fp8 = enable_fp8(self.model) if self.use_fp8 else None
        self._generate_fns = {}  # a decode closure per generation settings
        self._setup_model(seed)

    def _setup_model(self, seed: int) -> None:
        """Hook for the PEFT wrapper: wrap or extend `self.model` once it is built."""

    def save_pretrained(self, save_path: str) -> None:
        """Write the HF-layout directory (the JAX package's `save_pretrained`):
        ``config.json`` (`CommonConfig.save_pretrained`: the same keys and values as
        JAX's), the model's weights as safetensors in the reference layout, each tensor in
        the dtype the model holds it (`hf_interop.weights.params_to_state_dict`; a PEFT
        model raises, as the JAX function fails on a PEFT tree), and the tokenizer."""
        state_dict = params_to_state_dict(self.config, self.model.state_dict())
        self.config.save_pretrained(save_path)
        SafeTensorsWeightsManager.save_state_dict(state_dict, save_path)
        if self.tokenizer is not None:
            self.tokenizer.save_pretrained(save_path)

    @torch.no_grad()
    def load_pretrained_params(self, path: str, device: str | torch.device | None = None, seconds: dict | None = None) -> None:
        """Fill the model from the HF-layout directory `path` (its safetensors through
        `hf_interop.weights.state_dict_to_params`), each tensor cast to its parameter's dtype
        (the compute dtype for inference; norms fp32). A model built on the meta device
        first gets uninitialised storage on `device` (no random init runs). Every parameter
        must be in the file and every tensor of the file must have its parameter. Each
        tensor goes to the model's device as it is read (the host holds one at a time).
        `seconds`, when given, gets ``read`` (the files to host tensors) and ``copy`` (onto
        the device, then into the parameters in their dtype)."""
        manager = SafeTensorsWeightsManager(path)
        if len(manager) == 0:
            raise ValueError(f"'{path}' holds no safetensors weights (model.safetensors or its shards)")
        if self.model.device.type == "meta":
            if device is None:
                raise ValueError("a model on the meta device needs the device to load its weights onto")
            self.model.to_empty(device=device)
        targets = self.model.state_dict()
        times = {"read": 0.0, "copy": 0.0}

        def get_tensor(name: str) -> torch.Tensor:
            # each tensor onto the model's device as it is read: one at a time on the host
            t0 = time.perf_counter()
            tensor = manager.get_tensor(name)
            t1 = time.perf_counter()
            tensor = tensor.to(self.model.device)
            times["read"] += t1 - t0
            times["copy"] += time.perf_counter() - t1
            return tensor

        params = state_dict_to_params(self.config, get_tensor)
        missing, unexpected = set(targets) - set(params), set(params) - set(targets)
        if missing or unexpected:
            raise ValueError(f"'{path}' does not fit the model: missing {sorted(missing)}, unexpected {sorted(unexpected)}")
        t0 = time.perf_counter()
        for name, tensor in params.items():
            targets[name].copy_(tensor)
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)  # the last copies
        times["copy"] += time.perf_counter() - t0
        if seconds is not None:
            seconds.update(times)

    @property
    def is_encoder_decoder(self) -> bool:
        return is_encoder_decoder_model(self.model_type)

    @property
    def eos_token_id(self) -> int | None:
        if self.tokenizer is not None and self.tokenizer.eos_token_id is not None:
            return self.tokenizer.eos_token_id
        return self.config.eos_token_id

    def generate(
        self, batch: dict, generate_kwargs: dict, generator: torch.Generator | None = None
    ) -> tuple[list[str], list[int]]:
        """Batch generation from the inference-mode `collate_fn` output (left-padded
        ``input_ids`` and ``attention_mask``) through `generation_utils.generate_tokens`
        (an encoder-decoder's: `generate_seq2seq_tokens`, the prompts its encoder inputs);
        returns (generated_text, num_generated_tokens) per row."""
        from ..generation_utils import make_generate_fn

        assert self.tokenizer is not None, "generation requires a tokenizer"
        device = self.model.device
        input_ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=device)
        attention_mask = torch.as_tensor(batch["attention_mask"], dtype=torch.int32, device=device)

        top_p = generate_kwargs.get("top_p")
        static = dict(
            max_new_tokens=int(generate_kwargs["max_new_tokens"]),
            do_sample=bool(generate_kwargs.get("do_sample") or False),
            temperature=generate_kwargs.get("temperature"),
            top_k=generate_kwargs.get("top_k"),
            top_p=None if top_p is None else float(top_p),
            eos_token_id=self.eos_token_id,
            pad_token_id=next(
                (t for t in (self.tokenizer.pad_token_id, self.eos_token_id) if t is not None), 0
            ),
        )
        if self.is_encoder_decoder:
            static["decoder_start_token_id"] = self.config.decoder_start_token_id
        cache_key = tuple(sorted(static.items()))
        if cache_key not in self._generate_fns:
            self._generate_fns[cache_key] = make_generate_fn(
                self.model, is_encoder_decoder=self.is_encoder_decoder, **static
            )
        generated, num_generated = self._generate_fns[cache_key](input_ids, attention_mask, generator)

        num_generated = num_generated.tolist()
        texts = [
            self.tokenizer.decode(row[:n], skip_special_tokens=True)
            for row, n in zip(generated.tolist(), num_generated)
        ]
        return texts, num_generated
