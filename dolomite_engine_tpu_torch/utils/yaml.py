"""YAML loading with correct float resolution (counterpart of
`dolomite_engine_tpu/utils/yaml.py`): scientific notation like ``1e-5`` (no dot, no
sign after e) resolves to a float, not a string. PyYAML is imported where it is used."""

import re

_FLOAT_RESOLVER = re.compile(
    """^(?:
     [-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
    |[-+]?\\.(?:inf|Inf|INF)
    |\\.(?:nan|NaN|NAN))$""",
    re.X,
)


def load_yaml(path: str) -> dict:
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT_RESOLVER, list("-+0123456789."))
    with open(path, "r") as f:
        return yaml.load(f, _Loader)


def dump_yaml(obj: dict, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False)
