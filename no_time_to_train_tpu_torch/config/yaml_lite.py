"""A reader for the YAML subset of the repository's configs, so that the port
needs no PyYAML.

Read: block maps and block lists (a list may sit at its key's indentation,
as PyYAML writes it), flow lists `[a, b]` (nested too) and the empty flow
map `{}`, single- and double-quoted and plain scalars, `null` / `~` / an
empty value, YAML 1.1 booleans and numbers as PyYAML's `safe_load` resolves
them, comments, and one leading `---`. Anything else raises `YamlError`:
anchors, aliases, tags, block scalars (`|`, `>`), flow maps with entries,
complex keys, several documents, plain scalars over several lines.
"""
import re

__all__ = ["YamlError", "safe_load", "load_file"]


class YamlError(ValueError):
    pass


# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)


def _plain(s, where):
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        if ":" in s:
            raise YamlError(f"{where}: sexagesimal number {s!r}")
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        if ":" in s:
            raise YamlError(f"{where}: sexagesimal number {s!r}")
        v = s.replace("_", "").lower()
        if v.lstrip("+-") == ".inf":
            return float("-inf") if v[0] == "-" else float("inf")
        if v == ".nan":
            return float("nan")
        return float(v)
    if s[0] in "&*!|>%@`{":
        raise YamlError(f"{where}: unsupported YAML construct {s!r}")
    return s


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _quoted(text, i, where):
    """The quoted scalar that starts at text[i] -> (value, index after it)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if q == "'" and ch == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            e = text[j + 1:j + 2]
            if e in _HEX:
                n = _HEX[e]
                out.append(chr(int(text[j + 2:j + 2 + n], 16)))
                j += 2 + n
                continue
            if e not in _ESCAPES:
                raise YamlError(f"{where}: unknown escape \\{e}")
            out.append(_ESCAPES[e])
            j += 2
            continue
        out.append(ch)
        j += 1
    raise YamlError(f"{where}: quoted scalar does not end on its line")


def _strip_comment(text, where):
    """Drop a trailing comment (a `#` after a space, outside quotes)."""
    j = 0
    while j < len(text):
        ch = text[j]
        if ch in "'\"" and (j == 0 or text[j - 1] in " [,:"):
            _, j = _quoted(text, j, where)
            continue
        if ch == "#" and (j == 0 or text[j - 1] in " \t"):
            return text[:j].rstrip()
        j += 1
    return text.rstrip()


def _flow(text, i, where):
    """A flow list / empty flow map at text[i] -> (value, index after)."""
    if text[i] == "{":
        j = i + 1
        while j < len(text) and text[j] == " ":
            j += 1
        if text[j:j + 1] != "}":
            raise YamlError(f"{where}: flow maps with entries are not read")
        return {}, j + 1
    items = []
    j = i + 1
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise YamlError(f"{where}: flow list does not end on its line")
        if text[j] == "]":
            return items, j + 1
        if text[j] in "[{":
            v, j = _flow(text, j, where)
        elif text[j] in "'\"":
            v, j = _quoted(text, j, where)
        else:
            k = j
            while k < len(text) and text[k] not in ",]":
                k += 1
            v, j = _plain(text[j:k].strip(), where), k
            if isinstance(v, str) and ": " in v:
                raise YamlError(f"{where}: maps inside flow lists are not "
                                f"read")
        items.append(v)
        while j < len(text) and text[j] == " ":
            j += 1
        if text[j:j + 1] == ",":
            j += 1
        elif text[j:j + 1] != "]":
            raise YamlError(f"{where}: bad flow list")


def _scalar(text, where):
    """A value written on the line of its key or dash."""
    if text[0] in "'\"":
        v, j = _quoted(text, 0, where)
    elif text[0] in "[{":
        v, j = _flow(text, 0, where)
    else:
        if ": " in text or text.endswith(":"):
            raise YamlError(f"{where}: a map cannot start inside a value")
        return _plain(text, where)
    if text[j:].strip():
        raise YamlError(f"{where}: text after a value: {text[j:]!r}")
    return v


def _split_key(text, where):
    """'key: rest' -> (key, rest), or None when the line holds no key."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0, where)
        rest = text[j:]
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    m = re.match(r"^([^\s#'\"\[\]{},][^#]*?)\s*:(?:\s+|$)", text)
    if m is None:
        return None
    key = m.group(1)
    if key.startswith("? "):
        raise YamlError(f"{where}: complex keys are not read")
    return _plain(key, where), text[m.end():].strip()


def safe_load(text, name="<yaml>"):
    """YAML text -> Python value, as `yaml.safe_load` gives it for the
    subset this module reads."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError(f"{where}: tab in indentation")
        body = _strip_comment(raw.strip(), where)
        if not body:
            continue
        if body in ("---", "...") or body.startswith("--- "):
            if body == "---" and not lines:
                continue          # one leading document marker
            raise YamlError(f"{where}: several documents are not read")
        if body.startswith("%"):
            raise YamlError(f"{where}: directives are not read")
        lines.append((len(raw) - len(raw.lstrip(" ")), body, where))
    if not lines:
        return None
    value, pos = _node(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlError(f"{lines[pos][2]}: unexpected indentation")
    return value


def _node(lines, pos, indent):
    """The block node whose lines start at lines[pos], at `indent`."""
    ind, body, where = lines[pos]
    if body == "-" or body.startswith("- "):
        return _seq(lines, pos, indent)
    if _split_key(body, where) is not None:
        return _map(lines, pos, indent)
    if pos + 1 < len(lines) and lines[pos + 1][0] > ind:
        raise YamlError(f"{lines[pos + 1][2]}: plain scalars over several "
                        f"lines are not read")
    return _scalar(body, where), pos + 1


def _value_after(lines, pos, rest, indent, where, in_map):
    """The value of a key or dash whose own line ends in `rest`."""
    if rest:
        value = _scalar(rest, where)
        if pos + 1 < len(lines) and lines[pos + 1][0] > indent:
            raise YamlError(f"{lines[pos + 1][2]}: unexpected indentation")
        return value, pos + 1
    nxt = pos + 1
    if nxt < len(lines):
        n_ind, n_body = lines[nxt][0], lines[nxt][1]
        if n_ind > indent:
            return _node(lines, nxt, n_ind)
        if in_map and n_ind == indent and (n_body == "-"
                                           or n_body.startswith("- ")):
            return _seq(lines, nxt, indent)     # list at its key's column
    return None, nxt


def _map(lines, pos, indent):
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        _, body, where = lines[pos]
        kv = _split_key(body, where)
        if kv is None:
            break
        key, rest = kv
        if key in out:
            raise YamlError(f"{where}: duplicate key {key!r}")
        out[key], pos = _value_after(lines, pos, rest, indent, where, True)
    if pos < len(lines) and lines[pos][0] > indent:
        raise YamlError(f"{lines[pos][2]}: unexpected indentation")
    return out, pos


def _seq(lines, pos, indent):
    out = []
    while pos < len(lines) and lines[pos][0] == indent:
        ind, body, where = lines[pos]
        if not (body == "-" or body.startswith("- ")):
            break
        rest = body[1:].strip()
        if rest and (rest == "-" or rest.startswith("- ")
                     or (rest[0] not in "[{'\""
                         and _split_key(rest, where) is not None)):
            # "- key: value" or "- - x": a block node that starts after the
            # dash, at the column of its first character
            col = ind + len(body) - len(body[1:].lstrip())
            sub = [(col, rest, where)]
            j = pos + 1
            while j < len(lines) and lines[j][0] > ind:
                sub.append(lines[j])
                j += 1
            value, used = _node(sub, 0, col)
            if used != len(sub):
                raise YamlError(f"{sub[used][2]}: unexpected indentation")
            out.append(value)
            pos = j
            continue
        value, pos = _value_after(lines, pos, rest, indent, where, False)
        out.append(value)
    return out, pos


def load_file(path):
    with open(path) as f:
        return safe_load(f.read(), name=str(path))
