"""A reader for the YAML subset that ``configs/`` is written in.

The port must run where PyYAML is not installed, so it carries this small
reader instead. It covers what the config tree uses, and a little more:

- block mappings nested by indentation;
- flow sequences ``[a, b]`` and flow mappings ``{a: 1}``, nested;
- plain, single-quoted and double-quoted scalars; ``#`` comments;
- PyYAML's YAML 1.1 scalar typing (``yaml.SafeLoader``'s implicit
  resolvers): null, bool (``yes``/``on``/``true`` ...), int (with ``_``,
  ``0x``, ``0b``, leading-zero octal and ``1:30`` base 60), float (which
  needs a dot, so ``8e-6`` stays a string as in PyYAML and is turned into
  a float only by the config layer's ``"1e-"`` rule).

A flow collection may run over several lines. Anything else (block
sequences, anchors, aliases, tags, block scalars ``|``/``>``, several
documents, dates) raises
``ValueError`` rather than being read differently from PyYAML.
"""

import re

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_BOOL_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off",
               "OFF"}
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
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_UNSUPPORTED_START = ("&", "*", "!", "|", ">", "%", "@", "`", "? ")


def _sexagesimal(text, cast):
    sign = -1 if text.startswith("-") else 1
    text = text.lstrip("+-")
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _to_int(text):
    text = text.replace("_", "")
    sign = -1 if text.startswith("-") else 1
    body = text.lstrip("+-")
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if ":" in body:
        return sign * _sexagesimal(body, int)
    if body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _to_float(text):
    text = text.replace("_", "").lower()
    sign = -1.0 if text.startswith("-") else 1.0
    body = text.lstrip("+-")
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    if ":" in body:
        return sign * _sexagesimal(body, float)
    return sign * float(body)


def resolve_plain(text):
    """Type a plain (unquoted) scalar the way PyYAML's SafeLoader does."""
    if _NULL.match(text):
        return None
    if text in _BOOL_TRUE:
        return True
    if text in _BOOL_FALSE:
        return False
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f"YAML timestamps are not supported: {text!r}")
    if text.startswith(_UNSUPPORTED_START) or text in ("-", "=", "<<"):
        raise ValueError(f"unsupported YAML construct: {text!r}")
    return text


def _strip_comment(line):
    """Drop a ``#`` comment that sits outside quotes and follows a space
    (or starts the line)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                continue
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _unquote(text):
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"unterminated quoted scalar: {text!r}")
    body = text[1:-1]
    if q == "'":
        return body.replace("''", "'")
    out, i = [], 0
    escapes = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\",
               '"': '"', "/": "/", " ": " ", "b": "\b", "f": "\f",
               "a": "\a", "v": "\v", "e": "\x1b"}
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        nxt = body[i + 1]
        if nxt in escapes:
            out.append(escapes[nxt])
            i += 2
        elif nxt in "xuU":
            width = {"x": 2, "u": 4, "U": 8}[nxt]
            out.append(chr(int(body[i + 2:i + 2 + width], 16)))
            i += 2 + width
        else:
            raise ValueError(f"unknown escape in {text!r}")
    return "".join(out)


def _scalar(text):
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _unquote(text)
    return resolve_plain(text)


class _Flow:
    """Recursive-descent reader of one flow collection on one line."""

    def __init__(self, text):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self):
        self._ws()
        ch = self.s[self.i:self.i + 1]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in ("'", '"'):
            end = self.i + 1
            while end < len(self.s):
                if self.s[end] == "\\" and ch == '"':
                    end += 2
                    continue
                if self.s[end] == ch:
                    if ch == "'" and self.s[end + 1:end + 2] == "'":
                        end += 2
                        continue
                    break
                end += 1
            text = self.s[self.i:end + 1]
            self.i = end + 1
            return _unquote(text)
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",]}":
            if self.s[self.i] == ":" and self.s[self.i + 1:self.i + 2] in (
                    " ", ""):
                break
            self.i += 1
        return resolve_plain(self.s[start:self.i].strip())

    def _expect(self, ch):
        self._ws()
        if self.s[self.i:self.i + 1] != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s!r}")
        self.i += 1

    def _seq(self):
        self._expect("[")
        out = []
        self._ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value())
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
                self._ws()
                if self.s[self.i:self.i + 1] == "]":
                    self.i += 1
                    return out
                continue
            self._expect("]")
            return out

    def _map(self):
        self._expect("{")
        out = {}
        self._ws()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.value()
            self._ws()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self._ws()
                val = (None if self.s[self.i:self.i + 1] in (",", "}")
                       else self.value())
            else:
                val = None
            out[key] = val
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
                continue
            self._expect("}")
            return out


def _inline(text):
    """A value written on the same line as its key."""
    if text[:1] in ("[", "{"):
        flow = _Flow(text)
        out = flow.value()
        flow._ws()
        if flow.i != len(text):
            raise ValueError(f"trailing text after flow collection: {text!r}")
        return out
    return _scalar(text)


def _split_key(text):
    """``key: value`` -> (key, value text) or None when not a mapping
    entry. The colon must be followed by a space or end the line."""
    quote = None
    depth = 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and text[i + 1:i + 2] in (" ", ""):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _flow_depth(text):
    """Open brackets minus closed ones, outside quotes."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


class _Block:
    """Block mappings nested by indentation, one ``key: value`` a line."""

    def __init__(self, text):
        self.lines = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("tabs in indentation are not valid YAML")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if line.strip() in ("---", "...") and not raw.startswith(" "):
                raise ValueError("multiple YAML documents are not supported")
            if line.strip() == "-" or line.strip().startswith("- "):
                raise ValueError(f"block sequences are not supported: {line!r}")
            indent = len(line) - len(line.lstrip(" "))
            self.lines.append((indent, line.strip()))
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        indent, first = self.lines[0]
        if _split_key(first) is None:
            self.i = 1
            text = self._rest(first)
            if self.i != len(self.lines):
                raise ValueError(f"unexpected content: {first!r}")
            return _inline(text)
        node = self.map(indent)
        if self.i != len(self.lines):
            raise ValueError(f"bad indentation near {self.lines[self.i][1]!r}")
        return node

    def _rest(self, rest):
        """The inline value text, joined with the lines that a flow
        collection left open continues on."""
        if rest[:1] in ("[", "{"):
            while _flow_depth(rest) > 0 and self.i < len(self.lines):
                rest += " " + self.lines[self.i][1]
                self.i += 1
        return rest

    def map(self, indent):
        out = {}
        while self.i < len(self.lines):
            cur_indent, line = self.lines[self.i]
            if cur_indent < indent:
                break
            if cur_indent > indent:
                raise ValueError(f"bad indentation near {line!r}")
            kv = _split_key(line)
            if kv is None:
                raise ValueError(f"expected 'key: value', got {line!r}")
            key, rest = kv
            self.i += 1
            rest = self._rest(rest)
            if rest:
                out[_scalar(key)] = _inline(rest)
            elif self.i < len(self.lines) and self.lines[self.i][0] > indent:
                out[_scalar(key)] = self.map(self.lines[self.i][0])
            else:
                out[_scalar(key)] = None
        return out


def safe_load(text):
    """Parse one YAML document of the supported subset."""
    return _Block(text).parse()
