"""A reader and a writer for the YAML of the repository's configs, on the
standard library alone.

`load(text)` returns what PyYAML's `yaml.safe_load` returns for the YAML
that configs/exp.yaml and command-line overrides use: block mappings,
plain scalars folded over continuation lines, quoted scalars on one line
(double quotes with JSON's escapes), flow sequences and flow mappings on
one line, and comments. Plain scalars resolve by PyYAML's YAML 1.1 rules:
`true`/`yes`/`on` (and their false forms, in the three cases PyYAML
accepts) are booleans, `null`, `~` and an empty value are None, `1.0e-15`
is a float while `1e-3` (no dot) is a string, `0x1F`, `017` (octal),
`1_000` and `1:30` are ints, and `YYYY-MM-DD` is a date.

Other valid YAML raises Unsupported: block sequences, block scalars,
anchors, aliases, tags, document markers, complex keys, escapes JSON does
not have, and a flow collection or quoted scalar over several lines. Text
that PyYAML refuses raises ValueError.

`dump(mapping)` writes mappings in block style and sequences in flow
style, which this reader and PyYAML read back to the same mapping.
"""

from __future__ import annotations

import datetime
import json
import math
import re

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
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
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")
# characters that cannot start a plain scalar: of these, YAML's node
# properties and block scalars are valid but not read here
_NOT_PLAIN_START = "[]{},#&*!|>'\"%@`"
_UNSUPPORTED_START = "&*!|>"
# escapes of double-quoted YAML that JSON lacks
_YAML_ONLY_ESCAPES = "0abvexUN_LP \t"


class Unsupported(NotImplementedError):
    """Valid YAML that this reader does not read."""


def _sexagesimal(value: str, num):
    total, base = num(0), 1
    for part in reversed(value.split(":")):
        total += num(part) * base
        base *= 60
    return total


def _to_int(s: str) -> int:
    v = s.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _to_float(s: str) -> float:
    v = s.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def resolve_plain(s: str):
    """A plain scalar's value under PyYAML's YAML 1.1 resolvers."""
    if s in _BOOL:
        return _BOOL[s]
    if s in _NULL:
        return None
    if _FLOAT.match(s):
        return _to_float(s)
    if _INT.match(s):
        return _to_int(s)
    m = _DATE.match(s)
    if m:
        return datetime.date(*(int(g) for g in m.groups()))
    if s in ("=", "<<"):
        raise ValueError(f"YAML value {s!r}")
    return s


class _Unclosed(ValueError):
    """A flow collection or quoted scalar that its line ends inside."""


def _quoted(s: str, pos: int):
    """The one-line quoted scalar starting at s[pos] -> (string, index
    after it)."""
    q, i = s[pos], pos + 1
    while i < len(s):
        if s[i] == "\\" and q == '"':
            i += 2
        elif s[i] == q and q == "'" and s[i + 1:i + 2] == "'":
            i += 2
        elif s[i] == q:
            body = s[pos + 1:i]
            if q == "'":
                return body.replace("''", "'"), i + 1
            try:
                return json.loads(f'"{body}"', strict=False), i + 1
            except ValueError:
                if any(e in _YAML_ONLY_ESCAPES
                       for e in re.findall(r"\\(.)", body)):
                    raise Unsupported(f"escapes in {s!r}") from None
                raise ValueError(f"bad escape in {s!r}") from None
        else:
            i += 1
    raise _Unclosed(f"unterminated quoted scalar in {s!r}")


def _comment_at(s: str) -> int:
    """Index of the comment in plain text s (a '#' at the start or after
    whitespace), or len(s)."""
    for j, c in enumerate(s):
        if c == "#" and (j == 0 or s[j - 1] in " \t"):
            return j
    return len(s)


def _skip_ws(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] in " \t":
        pos += 1
    return pos


def _flow(s: str, pos: int):
    """The flow node at s[pos] -> (value, index after it)."""
    pos = _skip_ws(s, pos)
    if pos >= len(s):
        raise _Unclosed(f"flow collection not closed in {s!r}")
    c = s[pos]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items = [] if c == "[" else {}
        pos += 1
        while True:
            pos = _skip_ws(s, pos)
            if pos >= len(s):
                raise _Unclosed(f"flow collection not closed in {s!r}")
            if s[pos] == close:
                return items, pos + 1
            if c == "[":
                v, pos = _flow(s, pos)
                items.append(v)
            else:
                k, pos = _flow(s, pos)
                pos = _skip_ws(s, pos)
                v = None
                if s[pos:pos + 1] == ":":
                    v, pos = _flow(s, pos + 1)
                items[k] = v
            pos = _skip_ws(s, pos)
            if s[pos:pos + 1] == ",":
                pos += 1
            elif pos >= len(s):
                raise _Unclosed(f"flow collection not closed in {s!r}")
            elif s[pos] != close:
                raise ValueError(f"expected ',' or '{close}' in {s!r}")
    if c in "'\"":
        return _quoted(s, pos)
    if c in _UNSUPPORTED_START:
        raise Unsupported(f"node properties in {s!r}")
    if c in "]},":
        raise ValueError(f"unexpected {c!r} in {s!r}")
    end = pos
    while end < len(s) and s[end] not in ",[]{}" and not (
            s[end] == ":" and s[end + 1:end + 2] in ("", " ", ",", "]", "}")) \
            and not (s[end] == "#" and s[end - 1] in " \t"):
        end += 1
    return resolve_plain(s[pos:end].strip()), end


def _key_of(text: str):
    """(key, rest after the ':') when `text` is a `key: value` line, else
    None."""
    if text[0] in "'\"":
        try:
            k, pos = _quoted(text, 0)
        except _Unclosed:
            return None
        after = text[pos:].lstrip()
        if after[:1] == ":" and after[1:2] in ("", " ", "\t"):
            return k, after[1:]
        return None
    if text[0] in "[{":
        return None
    if text[0] == "?" and text[1:2] in ("", " "):
        raise Unsupported("complex keys")
    for j, c in enumerate(text):
        if c == "#" and j > 0 and text[j - 1] in " \t":
            return None
        if c == ":" and text[j + 1:j + 2] in ("", " ", "\t"):
            return resolve_plain(text[:j].rstrip()), text[j + 1:]
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Reader:
    def __init__(self, text: str):
        self.lines = text.splitlines()
        if "\t" in "".join(ln[:len(ln) - len(ln.lstrip())]
                           for ln in self.lines):
            raise ValueError("tabs in indentation")
        self.i = 0

    def _line(self, j):
        raw = self.lines[j]
        body = raw.lstrip(" ")
        return len(raw) - len(body), body.rstrip()

    def _next(self):
        """Index of the next line that is not blank or a comment."""
        while self.i < len(self.lines):
            _, text = self._line(self.i)
            if text and not text.startswith("#"):
                if text.startswith("%"):
                    raise ValueError(f"directive {text!r}")
                if text in ("---", "...") or text.startswith("--- "):
                    raise Unsupported("document markers")
                return self.i
            self.i += 1
        return None

    def document(self):
        j = self._next()
        if j is None:
            return None
        n, text = self._line(j)
        if _is_item(text):
            raise Unsupported("block sequences")
        if _key_of(text) is not None:
            v = self.map(n)
        else:
            self.i += 1
            v = self.inline(text, n - 1)
        if self._next() is not None:
            raise ValueError(f"unexpected text at line {self.i + 1}: "
                             f"{self.lines[self.i]!r}")
        return v

    def map(self, n: int) -> dict:
        out = {}
        while (j := self._next()) is not None:
            ind, text = self._line(j)
            if ind < n:
                break
            kv = _key_of(text) if ind == n else None
            if kv is None:
                raise ValueError(f"bad mapping entry at line {j + 1}: "
                                 f"{self.lines[j]!r}")
            self.i += 1
            out[kv[0]] = self.value(kv[1], n)
        return out

    def value(self, rest: str, n: int):
        """A mapping value: `rest` follows the ':' of a key at indent n."""
        s = rest.strip()
        if s and not s.startswith("#"):
            return self.inline(s, n)
        j = self._next()
        if j is None:
            return None
        ind, text = self._line(j)
        if _is_item(text) and ind >= n:
            raise Unsupported("block sequences")
        if ind <= n:
            return None
        if _key_of(text) is not None:
            return self.map(ind)
        self.i += 1
        return self.inline(text, n)

    def _continued(self, n: int) -> bool:
        """Whether the next line continues a value of a key at indent n."""
        return self.i < len(self.lines) and self.lines[self.i].strip() \
            and self._line(self.i)[0] > n

    def inline(self, s: str, n: int):
        """The value whose text starts with s, continued on the following
        lines indented deeper than n (plain scalars only)."""
        if s[0] in "[{'\"":
            try:
                v, pos = _flow(s, 0)
            except _Unclosed:
                if self._continued(n):
                    raise Unsupported(f"{s!r} continues on the next "
                                      f"line") from None
                raise
            rest = s[pos:].strip()
            if rest and not rest.startswith("#"):
                raise ValueError(f"unexpected {rest!r} after a value in "
                                 f"{s!r}")
            return v
        if s[0] in _UNSUPPORTED_START:
            raise Unsupported(f"node properties or block scalars in {s!r}")
        if s[0] in _NOT_PLAIN_START or _is_item(s):
            raise ValueError(f"invalid value {s!r}")
        cut = _comment_at(s)
        parts = [s[:cut].rstrip()]
        ended = cut < len(s)
        blanks = 0
        while not ended and self.i < len(self.lines):
            raw = self.lines[self.i]
            t = raw.strip()
            if not t:
                blanks += 1
                self.i += 1
                continue
            if len(raw) - len(raw.lstrip(" ")) <= n or t.startswith("#"):
                break
            self.i += 1
            cut = _comment_at(t)
            parts.append("\n" * blanks if blanks else " ")
            parts.append(t[:cut].rstrip())
            blanks = 0
            ended = cut < len(t)
        value = "".join(parts)
        if ": " in value or value.endswith(":"):
            raise ValueError(f"mapping values are not allowed in {value!r}")
        return resolve_plain(value)


def load(text: str):
    """The YAML document in `text` (see the module docstring)."""
    return _Reader(text).document()


def _float_text(v: float) -> str:
    if v != v:
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    s = repr(v).lower()
    if "." not in s and "e" in s:
        s = s.replace("e", ".0e", 1)
    return s


def _plain_ok(s: str) -> bool:
    return (s != "" and s == s.strip() and s[0] not in _NOT_PLAIN_START
            and s[0] not in "-?:" and s.isprintable()
            and not any(c in s for c in ",[]{}")
            and ": " not in s and " #" not in s and not s.endswith(":")
            and resolve_plain(s) == s)


def scalar_text(v) -> str:
    """One scalar as YAML text that reads back as v."""
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        v = v.item()  # numpy scalars
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, datetime.date):
        return v.isoformat()
    if isinstance(v, str):
        return v if _plain_ok(v) else json.dumps(v, ensure_ascii=False)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _flow_text(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{scalar_text(k)}: {_flow_text(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(map(_flow_text, v)) + "]"
    return scalar_text(v)


def dump(mapping: dict) -> str:
    """Mappings in block style, everything else in flow style."""
    out = []

    def emit(m: dict, pad: str):
        for k, v in m.items():
            head = f"{pad}{scalar_text(k)}:"
            if isinstance(v, dict) and v:
                out.append(head)
                emit(v, pad + "  ")
            else:
                out.append(f"{head} {_flow_text(v)}")

    emit(mapping, "")
    return "\n".join(out) + "\n"
