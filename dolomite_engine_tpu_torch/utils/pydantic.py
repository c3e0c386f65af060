"""Base class of the argument trees (a copy of `dolomite_engine_tpu/utils/pydantic.py`):
unknown keys are refused, and `to_dict` serializes enums and nested models for logging
and checkpoint snapshots."""

from enum import Enum
from typing import Any

from pydantic import BaseModel, ConfigDict


class BaseArgs(BaseModel):
    model_config = ConfigDict(extra="forbid", protected_namespaces=(), arbitrary_types_allowed=True)

    def to_dict(self) -> dict:
        return _serialize(self.model_dump())


def _serialize(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _serialize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_serialize(v) for v in x]
    if isinstance(x, Enum):
        return x.value
    return x
