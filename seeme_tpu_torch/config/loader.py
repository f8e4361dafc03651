"""The YAML config cascade (`seeme_tpu/config/loader.py`), without pyyaml.

`load_config` merges `base.yaml` -> the experiment YAML -> every YAML of
`configs/<model.target>/` (module defaults, under `model`) -> the assets
YAML -> dotted overrides, in that order, then resolves `${dotted.path}`
interpolation against the merged tree, as the JAX loader does
(`:112-143`, `:82-105`).

The card's machine has no YAML reader, so `parse_yaml` reads the subset the
shipped files use, with YAML 1.1's scalar rules as `yaml.safe_load` applies
them: block mappings by indentation, flow sequences (`[1, 256]`,
`['interactee', 'scene']`), plain scalars (null, bool, decimal int, float
with a dot; anything else a string, so `1e-4` stays the string it is to
pyyaml), single- and double-quoted strings, and comments. Anything outside
that subset (block sequences, flow mappings, block scalars, anchors,
aliases, tags, documents, tabs, duplicate keys) raises `ValueError` naming
the file and line; it does not guess.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_INNER = re.compile(r"\$\{([^}]+)\}")
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")
# YAML 1.1 implicit scalars as pyyaml's SafeLoader resolves them
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"^[-+]?(?:0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_FLOAT_SPECIAL = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)|"
                            r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*)$")
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


class Config(dict):
    """dict with attribute access and dotted-path lookup."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def select(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


class _Source:
    """Where a value was read, for error messages."""

    def __init__(self, name: str, line: int):
        self.name, self.line = name, line

    def error(self, msg: str) -> ValueError:
        return ValueError(f"{self.name}:{self.line}: {msg} (outside the YAML subset the "
                          "port reads)")


def _plain_scalar(text: str, src: _Source) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INT_OTHER.match(text) or _FLOAT_SPECIAL.match(text):
        raise src.error(f"numeric form {text!r}")
    if text[0] in _INDICATORS or ": " in text or " #" in text or text.endswith(":"):
        raise src.error(f"plain scalar {text!r}")
    return text


def _quoted(text: str, i: int, src: _Source) -> Tuple[str, int]:
    """The quoted string starting at text[i]; returns it and the index past
    its closing quote."""
    q, out, j = text[i], [], i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "0": "\0"}
            if text[j + 1:j + 2] not in esc:
                raise src.error(f"escape {text[j:j + 2]!r}")
            out.append(esc[text[j + 1]])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise src.error("unterminated quoted string (multi-line scalars are not read)")


def _flow(text: str, i: int, src: _Source) -> Tuple[Any, int]:
    """The flow node starting at text[i] (a sequence, a quoted string or a
    plain scalar ending at ',' or ']'); returns it and the index past it."""
    while i < len(text) and text[i] == " ":
        i += 1
    if i >= len(text):
        raise src.error("missing flow value")
    if text[i] in "'\"":
        return _quoted(text, i, src)
    if text[i] == "[":
        items: List[Any] = []
        j = i + 1
        while True:
            while j < len(text) and text[j] == " ":
                j += 1
            if j < len(text) and text[j] == "]" and not items:
                return items, j + 1
            item, j = _flow(text, j, src)
            items.append(item)
            while j < len(text) and text[j] == " ":
                j += 1
            if j >= len(text):
                raise src.error("unterminated flow sequence")
            if text[j] == "]":
                return items, j + 1
            if text[j] != ",":
                raise src.error(f"{text[j]!r} in a flow sequence")
            j += 1
    if text[i] == "{":
        raise src.error("flow mapping")
    j = i
    while j < len(text) and text[j] not in ",[]{}":
        j += 1
    return _plain_scalar(text[i:j].strip(), src), j


def _value(text: str, src: _Source) -> Any:
    """A whole value: a flow node and nothing after it."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "'\"[{":
        value, end = _flow(text, 0, src)
        if text[end:].strip():
            raise src.error(f"text after a value: {text[end:].strip()!r}")
        return value
    return _plain_scalar(text, src)


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at the start or after a space,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str, name: str = "<string>") -> Dict:
    """The mapping a YAML document of the subset holds (an empty document is
    an empty mapping)."""
    root: Dict = {}
    stack: List[Tuple[int, Dict]] = [(0, root)]  # (indentation, mapping) of each open level
    pending: Optional[Tuple[Dict, str, int]] = None  # a 'key:' that may open a mapping
    for lineno, raw in enumerate(text.splitlines(), 1):
        src = _Source(name, lineno)
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if "\t" in line[:indent + 1]:
            raise src.error("tab in indentation")
        if body.startswith(("---", "...", "%")):
            raise src.error("document marker or directive")
        if body.startswith("- ") or body == "-":
            raise src.error("block sequence")
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise src.error(f"line {body!r} is not 'key: value'")
        key = key.strip()
        if not _KEY.match(key):
            raise src.error(f"key {key!r}")
        if pending is not None and indent > pending[2]:
            child: Dict = {}
            pending[0][pending[1]] = child
            stack.append((indent, child))
        pending = None
        while stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent:
            raise src.error("indentation does not match its mapping")
        mapping = stack[-1][1]
        if key in mapping:
            raise src.error(f"duplicate key {key!r}")
        rest = rest.strip()
        if rest[:1] in ("|", ">", "&", "*", "!"):
            raise src.error(f"value {rest!r}")
        mapping[key] = _value(rest, src)
        if not rest:
            pending = (mapping, key, indent)
    return root


def parse_value(raw: str) -> Any:
    """One value as an override gives it (`model.latent_dim=[2,256]`), read
    by the same rules as a value in a file."""
    return _value(raw, _Source("<override>", 1))


def load_yaml(path: str | Path) -> Dict:
    with open(path) as f:
        return parse_yaml(f.read(), str(path))


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def parse_dotted_overrides(pairs: Optional[Sequence[str]]) -> Dict:
    """['TEST.MEAN=true', 'model.latent_dim=[2,256]', ...] -> nested override
    dict, the values read as YAML values (`seeme_tpu/config/loader.py:55-68`)."""
    out: Dict = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise ValueError(f"override '{pair}' is not KEY.PATH=value")
        path, raw = pair.split("=", 1)
        node = out
        parts = path.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = parse_value(raw)
    return out


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Override wins; dicts merge recursively (OmegaConf.merge semantics)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_node(node: Any, root: Config) -> Any:
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:  # whole-string interpolation keeps the referenced type
            return _resolve_node(root.select(m.group(1)), root)
        if "${" in node:  # embedded interpolation: string substitution
            return _INTERP_INNER.sub(
                lambda mm: str(_resolve_node(root.select(mm.group(1)), root)), node)
        return node
    if isinstance(node, dict):
        return {k: _resolve_node(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_node(v, root) for v in node]
    return node


def resolve_interpolations(cfg: Dict) -> Config:
    root = _wrap(cfg)
    return _wrap(_resolve_node(root, root))


def load_config(cfg_path: str | Path, cfg_assets: Optional[str | Path] = None,
                base_path: Optional[str | Path] = None,
                overrides: Optional[Dict] = None) -> Config:
    """The full cascade (`seeme_tpu/config/loader.py:112-143`)."""
    cfg_path = Path(cfg_path)
    if not cfg_path.is_file():
        raise FileNotFoundError(f"config file {cfg_path} does not exist")
    cfg_dir = cfg_path.parent
    merged: Dict = {}
    base = Path(base_path) if base_path else cfg_dir / "base.yaml"
    if base.exists():
        merged = deep_merge(merged, load_yaml(base))
    merged = deep_merge(merged, load_yaml(cfg_path))
    # module defaults under model, from the folder model.target names (base.yaml: 'modules')
    target = (merged.get("model") or {}).get("target", "modules")
    module_dir = cfg_dir / target
    if module_dir.is_dir():
        module_cfg: Dict = {}
        for f in sorted(module_dir.glob("*.yaml")):
            module_cfg = deep_merge(module_cfg, load_yaml(f))
        merged["model"] = deep_merge(module_cfg, merged.get("model") or {})
    if cfg_assets is not None and Path(cfg_assets).exists():
        merged = deep_merge(merged, load_yaml(cfg_assets))
    if overrides:
        merged = deep_merge(merged, overrides)
    return resolve_interpolations(merged)


def _emit_scalar(v: Any) -> str:
    """One value in the subset `parse_yaml` reads back as the same value."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        text = repr(v)
        if text in ("inf", "-inf", "nan"):
            raise ValueError(f"{v!r} has no form in the YAML subset")
        mantissa, e, exp = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + (e + (exp if exp[0] in "+-" else "+" + exp) if e else "")
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit_scalar(x) for x in v) + "]"
    raise ValueError(f"{type(v).__name__} {v!r} has no form in the YAML subset")


def dump_yaml(cfg: Dict, indent: int = 0) -> str:
    """A nested mapping as YAML text of the subset `parse_yaml` reads (an
    empty mapping is written as null, which the subset reads back)."""
    lines = []
    for k, v in cfg.items():
        if isinstance(v, dict) and v:
            lines.append(" " * indent + f"{k}:")
            lines.append(dump_yaml(v, indent + 2))
        else:
            lines.append(" " * indent + f"{k}: " + _emit_scalar(None if v == {} else v))
    return "\n".join(lines)


def save_config(cfg: Dict, path: str | Path) -> None:
    """The config snapshot of an experiment folder (`seeme_tpu/config/loader.py:157-166`)."""
    with open(path, "w") as f:
        f.write(dump_yaml(cfg) + "\n")
