"""Config system: YAML -> nested dict with full CLI overridability
(counterpart of ``tdanet_tpu/utils/parser.py``).

The argparse mirror of a two-level config (``prepare_parser_from_dict``,
``parse_args_as_dict``) and the any-depth ``a.b.c=value`` overrides are
the JAX package's. YAML is read and written by this module's own reader,
because the machine with the card has no ``yaml``: it takes what the
repo's configs use, block mappings, comments, and plain and quoted
scalars, and resolves scalars as ``yaml.safe_load`` does (YAML 1.1: ``1e-3``
stays a string, ``1.0e-3`` is a float, ``yes``/``on``/``true`` are True,
``~`` and ``null`` are None). Anything else (sequences, flow collections,
anchors, tags, block scalars, documents, timestamps) raises a
:class:`YAMLSubsetError` that names the line.
"""

from __future__ import annotations

import argparse
import copy
import math
import re
import sys


class YAMLSubsetError(ValueError):
    """The text is outside the YAML this reader takes."""


# yaml.safe_load's implicit resolvers (PyYAML's resolver.py, YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0"}
_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


def _base60(value):
    out = 0
    for digit in value.split(":"):
        out = out * 60 + int(digit)
    return out


def _construct_int(value):
    value = value.replace("_", "")
    sign = 1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _base60(value)
    return sign * int(value)


def _construct_float(value):
    value = value.replace("_", "").lower()
    sign = 1.0
    if value[0] == "-":
        sign = -1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        digits = [float(d) for d in value.split(":")]
        out = 0.0
        for d in digits:
            out = out * 60 + d
        return sign * out
    return sign * float(value)


def _resolve_plain(text, line):
    """A plain scalar's value, by yaml.safe_load's implicit resolvers."""
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise YAMLSubsetError(f"line {line}: {text!r} is a YAML timestamp, "
                              "merge key or value key")
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _construct_float(text)
    if _INT.match(text):
        return _construct_int(text)
    if _NULL.match(text):
        return None
    return text


def _printable(text, line):
    if any(not " " <= ch <= "~" for ch in text):
        raise YAMLSubsetError(f"line {line}: only printable ASCII is read, "
                              f"got {text!r}")


def _end_comment(rest, line):
    rest = rest.strip(" ")
    if rest and not rest.startswith("#"):
        raise YAMLSubsetError(f"line {line}: text after a quoted scalar: "
                              f"{rest!r}")


def _quoted(text, line):
    """A single- or double-quoted scalar that makes up ``text`` (with an
    optional comment after it)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            _end_comment(text[i + 1:], line)
            return "".join(out)
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise YAMLSubsetError(f"line {line}: escape \\{esc} is not "
                                      "read")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and ch == '"':
            _end_comment(text[i + 1:], line)
            return "".join(out)
        _printable(ch, line)
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f"line {line}: unterminated quoted scalar")


def parse_scalar(text, line=1):
    """One scalar as ``yaml.safe_load(text)`` reads it: a quoted or plain
    scalar on one line, optionally followed by a comment; an empty text or
    a comment alone is None. Raises YAMLSubsetError for anything else."""
    text = text.strip(" ")
    if text.startswith(("---", "...")):
        raise YAMLSubsetError(f"line {line}: document markers are not read")
    if not text or text.startswith("#"):
        return None
    if text[0] in "'\"":
        return _quoted(text, line)
    if text[0] in _INDICATORS and not (
            text[0] in "-?:" and len(text) > 1 and text[1] != " "):
        raise YAMLSubsetError(f"line {line}: {text!r} starts with a YAML "
                              "indicator (sequence, flow collection, anchor, "
                              "tag, block scalar or directive)")
    cut = text.find(" #")
    if cut >= 0:
        text = text[:cut].rstrip(" ")
    _printable(text, line)
    if ": " in text or text.endswith(":"):
        raise YAMLSubsetError(f"line {line}: {text!r} is a mapping, not a "
                              "scalar")
    return _resolve_plain(text, line)


def _split_key(content, line):
    """``key: value`` -> (key, value text); the key is a plain or quoted
    scalar."""
    if content[0] in "'\"":
        end = content.index(content[0], 1) if content[0] in content[1:] \
            else -1
        if end < 0 or content[end + 1:end + 2] != ":":
            raise YAMLSubsetError(f"line {line}: expected 'key: value'")
        return _quoted(content[:end + 1], line), content[end + 2:]
    cut = content.find(": ")
    if content.endswith(":") and (cut < 0 or cut == len(content) - 1):
        cut = len(content) - 1
    if cut < 0:
        raise YAMLSubsetError(f"line {line}: expected 'key: value', got "
                              f"{content!r}")
    key = content[:cut]
    if " #" in key:
        raise YAMLSubsetError(f"line {line}: expected 'key: value'")
    return parse_scalar(key, line), content[cut + 1:]


def loads_yaml(text):
    """A document of nested block mappings as ``yaml.safe_load`` reads it;
    None for an empty document."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip(" ")
        if not body.strip(" ") or body.lstrip(" ").startswith("#"):
            continue
        lines.append((n, len(body) - len(body.lstrip(" ")),
                      body.lstrip(" ")))
    if not lines:
        return None
    root = {}
    stack = [(lines[0][1], root)]  # (indent of the mapping's keys, mapping)
    pending = None                 # (mapping, key) awaiting a nested block
    for n, indent, content in lines:
        if pending is not None:
            parent, key = pending
            pending = None
            if indent > stack[-1][0]:
                child = {}
                parent[key] = child
                stack.append((indent, child))
        while indent < stack[-1][0]:
            stack.pop()
            if not stack:
                break
        if not stack or indent != stack[-1][0]:
            raise YAMLSubsetError(f"line {n}: inconsistent indentation")
        if content.startswith("---") or content.startswith("..."):
            raise YAMLSubsetError(f"line {n}: document markers are not read")
        key, rest = _split_key(content, n)
        mapping = stack[-1][1]
        value_text = rest.strip(" ")
        if not value_text or value_text.startswith("#"):
            mapping[key] = None
            pending = (mapping, key)
        else:
            mapping[key] = parse_scalar(rest, n)
    return root


def _dump_scalar(value):
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:  # YAML 1.1 needs the point
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        _printable(value, 0)
        if _PLAIN_KEY.match(value) and parse_scalar(value) == value:
            return value
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"save_yaml writes mappings and scalars, got "
                    f"{type(value).__name__}")


def dumps_yaml(config, indent=0):
    """Nested mappings of scalars as block YAML that ``yaml.safe_load`` and
    :func:`loads_yaml` read back as ``config``."""
    out = []
    for key, value in config.items():
        head = " " * indent + _dump_scalar(key) + ":"
        if isinstance(value, dict) and value:
            out.append(head)
            out.append(dumps_yaml(value, indent + 2))
        elif isinstance(value, dict):
            raise TypeError("save_yaml cannot write an empty mapping")
        else:
            out.append(f"{head} {_dump_scalar(value)}")
    return "\n".join(out)


def isint(value):
    try:
        int(value)
        return True
    except (TypeError, ValueError):
        return False


def isfloat(value):
    try:
        float(value)
        return True
    except (TypeError, ValueError):
        return False


def str_int_float(value):
    if isint(value):
        return int(value)
    if isfloat(value):
        return float(value)
    return value


def str2bool(value):
    if not isinstance(value, str):
        return value
    if value.lower() in ("yes", "true", "y", "1"):
        return True
    if value.lower() in ("no", "false", "n", "0"):
        return False
    return value


def str2bool_arg(value):
    value = str2bool(value)
    if isinstance(value, bool):
        return value
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _entry_type(value):
    if value is None:
        return str_int_float
    if isinstance(str2bool(value), bool):
        return str2bool_arg
    return type(value)


def prepare_parser_from_dict(dic, parser=None):
    """Mirror a 2-level config dict into argparse groups
    (parser_utils.py:11-49)."""
    if parser is None:
        parser = argparse.ArgumentParser()
    for k, v in dic.items():
        group = parser.add_argument_group(k)
        if isinstance(v, dict):
            for kk, vv in v.items():
                group.add_argument("--" + kk, default=vv,
                                   type=_entry_type(vv))
        else:
            group.add_argument("--" + k, default=v, type=_entry_type(v))
    return parser


def parse_args_as_dict(parser, return_plain_args=False, args=None):
    """Re-assemble grouped args into a nested dict
    (parser_utils.py:123-161)."""
    ns = parser.parse_args(args=args)
    args_dic = {}
    for group in parser._action_groups:
        group_dict = {a.dest: getattr(ns, a.dest, None)
                      for a in group._group_actions}
        args_dic[group.title] = group_dict
    for legacy in ("optional arguments", "options", "positional arguments"):
        if legacy in args_dic:
            args_dic.setdefault("main_args", {}).update(args_dic.pop(legacy))
    if return_plain_args:
        return args_dic, ns
    return args_dic


# ---------------------------------------------------------------------------
# Any-depth dotted overrides
# ---------------------------------------------------------------------------


def load_yaml(path):
    with open(path) as f:
        return loads_yaml(f.read())


def save_yaml(path, config):
    with open(path, "w") as f:
        f.write(dumps_yaml(config) + "\n")


def apply_overrides(config, overrides):
    """Apply ['a.b.c=value', ...] onto a nested dict (copied); each value
    is read as a YAML scalar."""
    config = copy.deepcopy(config)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must be key.path=value")
        path, raw = item.split("=", 1)
        keys = path.lstrip("-").split(".")
        node = config
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = parse_scalar(raw)
    return config


def parse_config(argv=None, default_conf=None):
    """CLI: --conf_dir <yaml> [k.ey=val ...] -> resolved nested dict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--conf_dir", default=default_conf,
                        help="Path to the YAML config")
    ns, rest = parser.parse_known_args(argv)
    config = load_yaml(ns.conf_dir) if ns.conf_dir else {}
    bad = [a for a in rest if "=" not in a]
    if bad:
        raise SystemExit(
            f"Unrecognized arguments {bad}; overrides must be key.path=value")
    config = apply_overrides(config, rest)
    config.setdefault("main_args", {})["conf_dir"] = ns.conf_dir
    return config
