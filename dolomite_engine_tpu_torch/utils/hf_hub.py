"""A model name as a local checkpoint directory.

Counterpart of the local part of `dolomite_engine_tpu/utils/hf_hub.py`: the tokenizer and
config files that travel with a checkpoint (`TOKENIZER_FILES`), and `resolve_model_path`,
which returns a local directory unchanged. A hub id is not ported: the JAX package
downloads it, and the port refuses it, naming its ROADMAP item.
"""

from __future__ import annotations

import os

# tokenizer + config sidecar files that travel with a checkpoint (the JAX package's set)
TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "tokenizer.model",
    "vocab.json",
    "merges.txt",
    "special_tokens_map.json",
    "added_tokens.json",
    "config.json",
    "generation_config.json",
)

HUB_NOT_PORTED = "loading a hub id is not ported yet: ROADMAP.md Queue A, 'Interop and tools'"


def resolve_model_path(repo_name_or_path: str) -> str:
    """`repo_name_or_path` when it is a local directory; anything else would be a hub id
    and raises NotImplementedError."""
    if os.path.isdir(repo_name_or_path):
        return repo_name_or_path
    raise NotImplementedError(f"model name '{repo_name_or_path}' is not a local directory: {HUB_NOT_PORTED}")
