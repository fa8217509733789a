"""Config system: YAML files, ``${...}`` interpolation, CLI dotlist overrides.

The port's copy of ``equss_tpu/core/config.py``:

* ``load_config(path)``: a YAML file -> a plain nested dict;
* ``override_config_by_cli(cfg, dotlist)``: ``a.b.c=value`` merges, the
  value read by PyYAML's ``safe_load``;
* ``resolve_config(cfg)``: ``${dotted.path}`` interpolations resolved
  against the root;
* ``prepare_config(argv)``: argparse (``--config``, ``--debug``) and all
  of the above.

PyYAML is imported where a YAML file or an override string is read, not
with the module: a config given as a dict (``chip_smoke.py``'s
``PQGO_COCOSTUFF27``) resolves on a machine without it.
"""
from __future__ import annotations

import argparse
import copy
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ValueError(f"Top-level config must be a mapping, got {type(cfg)}")
    return cfg


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with YAML semantics (int/float/bool/list/str)."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _get_dotted(cfg: Dict[str, Any], dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        if isinstance(node, dict) and k in node:
            node = node[k]
        else:
            raise KeyError(f"Interpolation target '{dotted}' not found in config")
    return node


def override_config_by_cli(cfg: Dict[str, Any], dotlist: Sequence[str]) -> Dict[str, Any]:
    """Merge ``key.path=value`` strings into the config (last wins)."""
    cfg = copy.deepcopy(cfg)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"CLI override '{item}' must look like key.path=value")
        key, _, raw = item.partition("=")
        _set_dotted(cfg, key.strip(), _parse_value(raw))
    return cfg


def resolve_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ``${dotted.path}`` interpolations against the config root.

    A value that is exactly one interpolation keeps the target's type;
    embedded interpolations are string-substituted.  Chained references
    are resolved iteratively (bounded to catch cycles)."""
    cfg = copy.deepcopy(cfg)

    def resolve_str(s: str) -> Any:
        m = _INTERP_RE.fullmatch(s.strip())
        if m:
            return _get_dotted(cfg, m.group(1))
        return _INTERP_RE.sub(lambda mm: str(_get_dotted(cfg, mm.group(1))), s)

    def walk(node: Any) -> Tuple[Any, bool]:
        changed = False
        if isinstance(node, dict):
            for k, v in node.items():
                node[k], c = walk(v)
                changed |= c
            return node, changed
        if isinstance(node, list):
            for i, v in enumerate(node):
                node[i], c = walk(v)
                changed |= c
            return node, changed
        if isinstance(node, str) and "${" in node:
            return resolve_str(node), True
        return node, False

    for _ in range(8):
        cfg, changed = walk(cfg)
        if not changed:
            break
    else:
        raise ValueError("Config interpolation did not converge (cycle?)")
    return cfg


def default_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="equss_tpu_torch trainer")
    parser.add_argument("--config", type=str, required=True, help="YAML config path")
    parser.add_argument("--debug", action="store_true", help="debug mode (no remote logging)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="dotlist overrides a.b=c")
    return parser


def prepare_config(argv: Optional[List[str]] = None) -> Tuple[Dict[str, Any], argparse.Namespace]:
    parser = default_parser()
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    cfg = override_config_by_cli(cfg, [o for o in args.opts if o])
    cfg = resolve_config(cfg)
    cfg["debug"] = bool(args.debug)
    return cfg, args
