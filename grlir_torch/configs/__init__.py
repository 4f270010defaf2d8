"""Config system: YAML group composition with dotted CLI overrides (the
port's copy of `grlir.configs`, whose YAML files it carries byte for byte).

Composition order:

    defaults.yaml -> group selections (data_module/engine/model/loss/
    lr_scheduler/optimizer/metric) -> experiment overlay -> CLI overrides

An experiment's own `defaults` re-select their groups after the CLI's
selections, as in grlir.  `${path.to.key}` interpolations resolve against
the merged tree after composition.

The files are read by `load_yaml`, a reader of the YAML subset they use
(block maps, block and flow sequences, flow maps, plain and quoted scalars,
comments), with PyYAML `safe_load`'s YAML 1.1 scalar rules: `1.0e-4` is a
float and `1e-4` a string, `yes`/`on` are booleans, `~` and `null` are
None.  The GPU machine has no PyYAML.
"""

from __future__ import annotations

import copy
import math
import os.path as osp
import re
from typing import Any, List, Optional, Tuple

CONFIG_DIR = osp.dirname(__file__)

GROUPS = ["data_module", "engine", "model", "loss", "lr_scheduler",
          "optimizer", "metric"]

# ---------------------------------------------------------------- YAML subset

# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _int(text: str) -> int:
    s = text.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    if s[0] in "+-":
        s = s[1:]
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s[0] == "0":
        return sign * int(s, 8)
    if ":" in s:
        return sign * int(_sexagesimal(s))
    return sign * int(s)


def _float(text: str) -> float:
    s = text.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    if s[0] in "+-":
        s = s[1:]
    if s == ".inf":
        return sign * math.inf
    if s == ".nan":
        return math.nan
    if ":" in s:
        return sign * _sexagesimal(s)
    return sign * float(s)


def plain_scalar(text: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's safe_load resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\"}


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; (value, index after it)."""
    q = text[i]
    out, i = [], i + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in "xuU":
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
            else:
                raise ValueError(f"unknown escape \\{e} in {text!r}")
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar in {text!r}")


def _skip_space(text: str, i: int) -> int:
    while i < len(text) and text[i] in " \t":
        i += 1
    return i


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """The flow node starting at text[i] (a sequence, a map or a scalar
    ending at , ] or }); (value, index after it)."""
    i = _skip_space(text, i)
    c = text[i] if i < len(text) else ""
    if c in "[{":
        close = "]" if c == "[" else "}"
        items, i = [], _skip_space(text, i + 1)
        while True:
            if i < len(text) and text[i] == close:
                i += 1
                break
            if c == "[":
                value, i = _flow(text, i)
                items.append(value)
            else:
                key, i = _flow(text, i)
                i = _skip_space(text, i)
                if i < len(text) and text[i] == ":":
                    value, i = _flow(text, i + 1)
                else:
                    value = None
                items.append((key, value))
            i = _skip_space(text, i)
            if i < len(text) and text[i] == ",":
                i = _skip_space(text, i + 1)
            elif i >= len(text) or text[i] != close:
                raise ValueError(f"bad flow collection: {text!r}")
        return (items if c == "[" else dict(items)), i
    if c in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]}":
        if text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " ,]}"):
            break
        j += 1
    return plain_scalar(text[i:j].strip()), j


def parse_value(text: str) -> Any:
    """One inline YAML value (a line's value, or a CLI token)."""
    text = text.strip()
    if text[:1] in ("[", "{", "'", '"'):
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after {text[:end]!r}: {text!r}")
        return value
    return plain_scalar(text)


def _strip_comment(line: str) -> str:
    """The line without its comment (a # at its start or after a blank,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str) -> Optional[Tuple[str, str]]:
    """'key: value' -> (key, value); None for a line that is not a map
    entry."""
    if content[:1] in ("'", '"'):
        key, i = _quoted(content, 0)
    else:
        m = re.match(r"([^:#\[\]{},]+?)\s*:(?=\s|$)", content)
        if not m:
            return None
        key, i = m.group(1), m.end(1)
    rest = content[i:].lstrip()
    if not rest.startswith(":"):
        return None
    return key, rest[1:].strip()


def load_yaml_text(text: str) -> Any:
    """The YAML subset of the config files (see the module docstring)."""
    lines = []
    for raw in text.splitlines():
        content = _strip_comment(raw)
        if content.strip() and content.strip() != "---":
            lines.append((len(content) - len(content.lstrip(" ")), content.strip()))

    def block(i: int, indent: int) -> Tuple[Any, int]:
        if lines[i][1].startswith("- ") or lines[i][1] == "-":
            seq = []
            while i < len(lines) and lines[i][0] == indent and lines[i][1][:1] == "-":
                item = lines[i][1][1:].strip()
                if item:
                    seq.append(parse_value(item))
                    i += 1
                elif i + 1 < len(lines) and lines[i + 1][0] > indent:
                    value, i = block(i + 1, lines[i + 1][0])
                    seq.append(value)
                else:
                    seq.append(None)
                    i += 1
            return seq, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            kv = _split_key(lines[i][1])
            if kv is None:
                raise ValueError(f"not a map entry: {lines[i][1]!r}")
            key, value = kv
            key = plain_scalar(key) if lines[i][1][:1] not in "'\"" else key
            if value:
                out[key] = parse_value(value)
                i += 1
            elif i + 1 < len(lines) and lines[i + 1][0] > indent:
                out[key], i = block(i + 1, lines[i + 1][0])
            elif (i + 1 < len(lines) and lines[i + 1][0] == indent
                  and lines[i + 1][1][:1] == "-"):
                out[key], i = block(i + 1, indent)
            else:
                out[key] = None
                i += 1
        return out, i

    if not lines:
        return None
    value, end = block(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at {lines[end][1]!r}")
    return value


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return load_yaml_text(f.read()) or {}


# ---------------------------------------------------------------- composition

def _deep_merge(base: dict, overlay: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(s: str) -> Any:
    v = parse_value(s)
    # YAML 1.1 parses "1e-5" as a string (needs "1.0e-5"); accept it as float
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def _set_dotted(cfg: dict, dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _get_dotted(cfg: dict, dotted: str) -> Any:
    node = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_PART = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve(cfg: dict, node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _resolve(cfg, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(cfg, v) for v in node]
    if isinstance(node, str):
        m = _INTERP.fullmatch(node)
        if m:  # full-value interpolation keeps the referenced type
            return _resolve(cfg, _get_dotted(cfg, m.group(1)))
        if _INTERP_PART.search(node):  # string interpolation
            return _INTERP_PART.sub(
                lambda mm: str(_resolve(cfg, _get_dotted(cfg, mm.group(1)))),
                node,
            )
    return node


def load_config(overrides: Optional[List[str]] = None,
                config_dir: str = CONFIG_DIR) -> dict:
    """Compose the full config tree.

    overrides: hydra-style tokens, e.g.
      ["experiment=sr/grl_p256", "model=grl/grl_tiny", "tag=run1",
       "trainer.max_steps=1000"]
    Group selections use `group=name`; everything else is a dotted value set.
    """
    cfg = load_yaml(osp.join(config_dir, "defaults.yaml"))
    selections = dict(cfg.pop("defaults", {}))
    experiment = None
    value_overrides = []

    for tok in overrides or []:
        key, _, value = tok.partition("=")
        if key == "experiment":
            experiment = value
        elif key in GROUPS:
            selections[key] = value
        else:
            value_overrides.append((key, _parse_value(value)))

    def _apply_group(cfg, group, name):
        """Selecting a group replaces its subtree (hydra override
        semantics)."""
        overlay = load_yaml(osp.join(config_dir, group, f"{name}.yaml"))
        for key in overlay:
            cfg.pop(key, None)
        return _deep_merge(cfg, overlay)

    for group, name in selections.items():
        if name is None:
            continue
        cfg = _apply_group(cfg, group, name)

    if experiment:
        overlay = load_yaml(osp.join(config_dir, "experiment", f"{experiment}.yaml"))
        for group, name in dict(overlay.pop("defaults", {})).items():
            cfg = _apply_group(cfg, group, name)
        cfg = _deep_merge(cfg, overlay)

    for key, value in value_overrides:
        _set_dotted(cfg, key, value)

    return _resolve(cfg, cfg)


class ConfigView:
    """Attribute access over the nested dict (cfg.model.embed_dim)."""

    def __init__(self, data: dict):
        self._data = data

    def __getattr__(self, k):
        try:
            v = self._data[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return ConfigView(v) if isinstance(v, dict) else v

    def __getitem__(self, k):
        v = self._data[k]
        return ConfigView(v) if isinstance(v, dict) else v

    def get(self, k, default=None):
        v = self._data.get(k, default)
        return ConfigView(v) if isinstance(v, dict) else v

    def to_dict(self):
        return self._data

    def __contains__(self, k):
        return k in self._data

    def __repr__(self):
        return f"ConfigView({self._data})"
