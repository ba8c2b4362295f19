"""Config system (PyTorch counterpart of
``worldrenderer_tpu/utils/config.py``): YAML + dataclass schemas,
``extends`` inheritance, CLI dotlist merging, and ``${...}`` interpolation
with custom resolvers (arith, basename, rmspace, tuple2, gt0, not,
calc_exp_lr_decay_rate, calc_num_train_steps). PyYAML is imported where a
YAML text is read or written, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Callable, Dict, Optional

__all__ = [
    "ExperimentConfig",
    "load_config",
    "dump_config",
    "parse_structured",
    "register_resolver",
    "config_to_primitive",
]

# --------------------------------------------------------------------------
# Resolvers
# --------------------------------------------------------------------------

_RESOLVERS: Dict[str, Callable] = {}


def register_resolver(name: str, fn: Callable) -> None:
    _RESOLVERS[name] = fn


def _num(s):
    try:
        f = float(s)
        return int(f) if f.is_integer() and "." not in str(s) else f
    except (TypeError, ValueError):
        return s


register_resolver("calc_exp_lr_decay_rate", lambda factor, n: float(factor) ** (1.0 / float(n)))
register_resolver("add", lambda a, b: _num(a) + _num(b))
register_resolver("sub", lambda a, b: _num(a) - _num(b))
register_resolver("mul", lambda a, b: _num(a) * _num(b))
register_resolver("div", lambda a, b: _num(a) / _num(b))
register_resolver("idiv", lambda a, b: int(_num(a) // _num(b)))
register_resolver("basename", lambda p: os.path.basename(str(p)))
register_resolver("rmspace", lambda s, sub: str(s).replace(" ", str(sub)))
register_resolver("tuple2", lambda s: [float(s), float(s)])
register_resolver("gt0", lambda s: _num(s) > 0)
register_resolver("not", lambda s: not s)
register_resolver(
    "calc_num_train_steps",
    lambda num_data, batch_size, max_epochs, num_nodes, num_cards=8: int(
        _num(num_data) / (_num(num_nodes) * _num(num_cards) * _num(batch_size))
    )
    * _num(max_epochs),
)

# --------------------------------------------------------------------------
# Interpolation: ${path.to.key} references and ${resolver:a,b} calls
# --------------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif isinstance(cur, list):
            cur = cur[int(part)]
        else:
            raise KeyError(f"config interpolation: {dotted!r} not found")
    return cur


def _resolve_value(expr: str, root: dict):
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        fn = _RESOLVERS.get(name.strip())
        if fn is None:
            raise KeyError(f"unknown config resolver {name!r}")
        args = [a.strip() for a in argstr.split(",")] if argstr else []
        args = [_resolve_node(a, root) for a in args]
        return fn(*args)
    return _lookup(root, expr.strip())


def _resolve_node(node, root):
    if isinstance(node, str):
        # Innermost-first fixed-point resolution handles nesting like
        # ${mul:${a},3}: each pass rewrites expressions without inner ${...}.
        for _ in range(20):
            m = _INTERP_RE.fullmatch(node.strip())
            if m:  # whole-string interpolation keeps the value's type
                return _resolve_node(_resolve_value(m.group(1), root), root)
            if "${" not in node:
                return node
            node = _INTERP_RE.sub(
                lambda match: str(
                    _resolve_node(_resolve_value(match.group(1), root), root)
                ),
                node,
            )
        return node
    if isinstance(node, dict):
        return {k: _resolve_node(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_node(v, root) for v in node]
    return node


def resolve(cfg: dict) -> dict:
    """Resolve all interpolations against the config root (fixed point over
    nested refs is handled by recursive resolution)."""
    return _resolve_node(cfg, cfg)


# --------------------------------------------------------------------------
# Merging
# --------------------------------------------------------------------------


def merge_dicts(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def _parse_cli_value(s: str):
    import yaml

    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def from_dotlist(args) -> dict:
    """'a.b.c=1' CLI dotlist -> nested dict (OmegaConf.from_cli analog)."""
    out: dict = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"CLI override {arg!r} must be key=value")
        key, _, value = arg.partition("=")
        cur = out
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_cli_value(value)
    return out


# --------------------------------------------------------------------------
# Dataclass parsing
# --------------------------------------------------------------------------


def parse_structured(fields: Any, cfg: Optional[dict] = None) -> Any:
    """Merge a plain dict into a dataclass schema instance. Unknown keys
    raise; nested dataclass fields recurse."""
    cfg = cfg or {}
    if dataclasses.is_dataclass(fields) and not isinstance(fields, type):
        base = fields
        cls = type(fields)
    else:
        cls = fields
        base = cls()
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(cfg) - set(names)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, f in names.items():
        if name not in cfg:
            kwargs[name] = getattr(base, name)
            continue
        v = cfg[name]
        ftype = f.type
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[name] = parse_structured(ftype, v)
        else:
            kwargs[name] = v
    return cls(**kwargs)


def config_to_primitive(config, resolve: bool = True) -> Any:
    del resolve
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return dataclasses.asdict(config)
    return config


# --------------------------------------------------------------------------
# ExperimentConfig + load_config
# --------------------------------------------------------------------------


@dataclass
class ExperimentConfig:
    name: str = "default"
    description: str = ""
    tag: str = ""
    seed: int = 0
    use_timestamp: bool = True
    timestamp: Optional[str] = None
    exp_root_dir: str = "outputs"

    # derived; not set manually
    exp_dir: str = "outputs/default"
    trial_name: str = "exp"
    trial_dir: str = "outputs/default/exp"
    n_devices: int = 1

    resume: Optional[str] = None

    data_cls: str = ""
    data: dict = field(default_factory=dict)

    system_cls: str = ""
    system: dict = field(default_factory=dict)

    trainer: dict = field(default_factory=dict)
    checkpoint: dict = field(default_factory=dict)


def load_config(
    *yamls: str,
    cli_args: list = [],
    from_string: bool = False,
    makedirs: bool = True,
    schema=ExperimentConfig,
    **kwargs,
) -> ExperimentConfig:
    """Load + merge YAML configs with ``extends`` inheritance, CLI dotlist
    overrides, and kwargs; resolve interpolations; parse into the schema
    dataclass; derive trial directories."""
    import yaml

    confs = []
    for y in yamls:
        conf = (
            yaml.safe_load(y)
            if from_string
            else yaml.safe_load(open(y, "r", encoding="utf-8"))
        ) or {}
        extends = conf.pop("extends", None)
        if extends:
            assert os.path.exists(extends), f"File {extends} does not exist."
            confs.append(yaml.safe_load(open(extends, "r", encoding="utf-8")) or {})
        confs.append(conf)
    merged: dict = {}
    for c in confs:
        merged = merge_dicts(merged, c)
    merged = merge_dicts(merged, from_dotlist(cli_args))
    merged = merge_dicts(merged, kwargs)
    merged = resolve(merged)
    scfg = parse_structured(schema, merged)

    if not scfg.tag and not scfg.use_timestamp:
        raise ValueError("Either tag is specified or use_timestamp is True.")
    scfg.trial_name = scfg.tag
    if scfg.timestamp is None:
        scfg.timestamp = ""
        if scfg.use_timestamp:
            scfg.timestamp = datetime.now().strftime("@%Y%m%d-%H%M%S")
    scfg.trial_name += scfg.timestamp
    scfg.exp_dir = os.path.join(scfg.exp_root_dir, scfg.name)
    scfg.trial_dir = os.path.join(scfg.exp_dir, scfg.trial_name)
    if makedirs:
        os.makedirs(scfg.trial_dir, exist_ok=True)
    return scfg


def dump_config(path: str, config) -> None:
    import yaml

    with open(path, "w") as fp:
        yaml.safe_dump(config_to_primitive(config), fp)
