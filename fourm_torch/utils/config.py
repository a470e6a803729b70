"""Two-stage config system: CLI > YAML > code defaults, PyTorch port.

Counterpart of fourm_tpu/utils/config.py (reference run_training_4m.py:
224-238): a pre-parser reads --config, the YAML is injected as argparse
defaults, then the full CLI is parsed so explicit flags win.

The port reads its YAML itself (the machine with the card has no PyYAML),
a subset of it that the run configs and the tokenizers' safetensors
metadata use, read as `yaml.safe_load` reads it (YAML 1.1 scalars):
  * comments;
  * a flat block mapping of scalars: null (`~`, `null`, empty), bools
    (`true`, `yes`, `on`, ... in their three casings), ints (decimal,
    0x, 0o-style `0...`, 0b, with `_`), floats (`1.5`, `1.0e-06`, `.inf`,
    `.nan`; `1e-6` without a dot is a string, as in YAML 1.1), plain,
    single-quoted and double-quoted strings;
  * block lists of scalars as a mapping's values;
  * a document that is one scalar.
Anything else (nested mappings, anchors, aliases, tags, flow collections,
block scalars, multi-line scalars, several documents, dates) raises
ValueError. `dump_yaml` writes that subset as `yaml.safe_dump` would.
"""

from __future__ import annotations

import argparse
import math
import re
import sys
from typing import Any, Dict, List, Optional

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's YAML 1.1 resolvers (resolver.py)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _resolve_int(text: str) -> int:
    t = text.replace("_", "")
    sign, body = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if ":" in body:
        return sign * _sexagesimal(body, int)
    if len(body) > 1 and body[0] == "0":
        return sign * int(body, 8)
    return sign * int(body)


def _resolve_float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return -math.inf if t[0] == "-" else math.inf
    if t == ".nan":
        return math.nan
    if ":" in t:
        return _sexagesimal(t, float)
    return float(t)


def _plain(text: str, where: str) -> Any:
    """A plain scalar, resolved as YAML 1.1 (PyYAML's SafeLoader) does."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return _resolve_int(text)
    if _FLOAT.match(text):
        return _resolve_float(text)
    if text[0] in "[]{}&*!|>%@`,#" or text.startswith(("- ", "? ")) or text == "-":
        raise ValueError(f"{where}: {text!r} is outside the YAML subset this reader takes "
                         "(flow collections, anchors, aliases, tags, block scalars)")
    if ": " in text or text.endswith(":") or " #" in text:
        raise ValueError(f"{where}: {text!r}: a mapping or comment inside a scalar")
    if _TIMESTAMP.match(text):
        raise ValueError(f"{where}: {text!r}: dates are outside the YAML subset")
    return text


def _double_quoted(body: str, where: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == '"':
            raise ValueError(f"{where}: text after a closing quote")
        if c != "\\":
            out.append(c)
            i += 1
            continue
        esc = body[i + 1:i + 2]
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc in _HEX:
            n = _HEX[esc]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"{where}: unknown escape \\{esc}")
    return "".join(out)


def _scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text == "[]":  # an empty list, as yaml.safe_dump writes one
        return []
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'" or "'" in text[1:-1].replace("''", ""):
            raise ValueError(f"{where}: unterminated or multi-line single-quoted scalar")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"' or text[-2:] == '\\"' and text[-3:] != '\\\\"':
            raise ValueError(f"{where}: unterminated or multi-line double-quoted scalar")
        return _double_quoted(text[1:-1], where)
    return _plain(text, where)


def _strip_comment(line: str) -> str:
    """The line without a trailing comment: a `#` at its start or after a
    blank, outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str, where: str):
    """'key: value' -> (key, value or None); None when the line holds no
    mapping key."""
    if text[:1] in "'\"":
        end = text.find(text[0], 1)
        while text[0] == "'" and end != -1 and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end == -1 or not re.match(r":(\s|$)", text[end + 1:]):
            return None
        return _scalar(text[:end + 1], where), text[end + 2:].strip()
    m = re.search(r":(\s|$)", text)
    if m is None:
        return None
    return _plain(text[:m.start()].strip(), where), text[m.end():].strip()


def safe_load(text: str, source: str = "<yaml>") -> Any:
    """The YAML subset above, as `yaml.safe_load(text)` reads it."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{source}:{n}: a tab in the indentation")
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((n, len(line) - len(line.lstrip()), line.strip()))
    if any(t in ("---", "...") or t.startswith(("--- ", "%")) for _, _, t in lines):
        raise ValueError(f"{source}: document markers and directives are outside the subset")
    if not lines:
        return None
    if len(lines) == 1 and lines[0][1] == 0 and _split_key(lines[0][2], source) is None:
        return _scalar(lines[0][2], f"{source}:{lines[0][0]}")

    def block_list(i: int, indent: int):
        items = []
        while i < len(lines) and lines[i][1] == indent and (
                lines[i][2] == "-" or lines[i][2].startswith("- ")):
            n, _, t = lines[i]
            where = f"{source}:{n}"
            item = t[1:].strip()
            if not item or _split_key(item, where) is not None:
                raise ValueError(f"{where}: only scalars may be list items")
            items.append(_scalar(item, where))
            i += 1
        return items, i

    out: Dict[Any, Any] = {}
    i = 0
    while i < len(lines):
        n, indent, t = lines[i]
        where = f"{source}:{n}"
        if indent != 0:
            raise ValueError(f"{where}: nested mappings and multi-line scalars are outside "
                             "the YAML subset this reader takes")
        kv = _split_key(t, where)
        if kv is None:
            raise ValueError(f"{where}: expected 'key: value', got {t!r}")
        key, value = kv
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        i += 1
        if value:
            out[key] = _scalar(value, where)
        elif i < len(lines) and (lines[i][2] == "-" or lines[i][2].startswith("- ")):
            out[key], i = block_list(i, lines[i][1])
        else:
            out[key] = None
    return out


def load_yaml(path: str) -> Dict:
    with open(path) as f:
        return safe_load(f.read(), path) or {}


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:  # 1e-06 -> 1.0e-06, as PyYAML writes it
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        try:
            plain_ok = (v == v.strip() and "\n" not in v and _plain(v, "") == v)
        except ValueError:
            plain_ok = False
        if plain_ok and v and v[0] not in "'\"" and v.isprintable():
            return v
        if v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        return '"' + v.encode("unicode_escape").decode("ascii").replace('"', '\\"') + '"'
    raise TypeError(f"dump_yaml: {type(v).__name__} is outside the YAML subset")


def dump_yaml(d: Dict[str, Any]) -> str:
    """A flat mapping of scalars and lists of scalars as block YAML, keys
    sorted, as yaml.safe_dump writes it (read back equal by both)."""
    lines = []
    for k in sorted(d):
        v = d[k]
        if isinstance(v, (list, tuple)):
            lines.append(f"{_dump_scalar(k)}:" + ("" if v else " []"))
            lines += [f"- {_dump_scalar(x)}" for x in v]
        else:
            lines.append(f"{_dump_scalar(k)}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"


def parse_args_with_config(parser: argparse.ArgumentParser, args: Optional[List[str]] = None):
    """Parse args with optional --config YAML defaults injection."""
    args = sys.argv[1:] if args is None else args
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None, type=str)
    known, _remaining = pre.parse_known_args(args)
    parser.add_argument("--config", default=None, type=str,
                        help="YAML config; CLI flags override its values")
    if known.config is not None:
        cfg = load_yaml(known.config)
        unknown = [k for k in cfg if not any(a.dest == k for a in parser._actions)]
        if unknown:
            raise ValueError(f"unknown config keys: {unknown}")
        parser.set_defaults(**cfg)
    return parser.parse_args(args)


def expand_run_name(name: str, config_path: Optional[str]) -> str:
    """'auto' run names derive from the config path (reference run_name.py:14-28)."""
    if name != "auto" or not config_path:
        return name
    parts = config_path.replace(".yaml", "").split("/")
    if "cfgs" in parts:
        parts = parts[parts.index("cfgs") + 1:]
    return "-".join(parts)
