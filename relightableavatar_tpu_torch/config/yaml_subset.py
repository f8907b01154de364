"""A YAML reader for the subset the config files use, typed as PyYAML's
``safe_load`` types it (YAML 1.1), so the port needs no PyYAML.

Supported: block mappings and block sequences by indentation, flow lists
and flow mappings (nested, on one or several lines), plain, single- and
double-quoted scalars, ``#`` comments, and a leading ``---``.  Plain scalars
resolve as PyYAML's implicit resolvers do: ``~``/``null``/empty to None;
``yes``/``no``/``true``/``false``/``on``/``off`` (three spellings each) to
bool; YAML 1.1 ints (binary, octal with a leading 0, hex, base 60) and
floats, which need a ``.`` (``5e-4`` stays the string ``'5e-4'``, ``5.0e-4``
is a float); anything else is a string.  Anchors, aliases, tags, block
scalars (``|``, ``>``), multi-line plain scalars and timestamps raise
:class:`YamlSubsetError`.
"""
from __future__ import annotations

import re

_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE'
                   r'|on|On|ON|off|Off|OFF)$')
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_TIMESTAMP = re.compile(r'^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?')
_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t', 'n': '\n',
            'v': '\v', 'f': '\f', 'r': '\r', 'e': '\x1b', ' ': ' ', '"': '"',
            '/': '/', '\\': '\\', 'N': '\x85', '_': '\xa0', 'L': ' ',
            'P': ' '}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}


class YamlSubsetError(ValueError):
    """The text uses YAML outside the supported subset, or is malformed."""


def _sexagesimal(digits: str, base_value):
    value = 0
    for part in digits.split(':'):
        value = value * 60 + base_value(part)
    return value


def _to_int(s: str) -> int:
    s = s.replace('_', '')
    sign = -1 if s[0] == '-' else 1
    if s[0] in '+-':
        s = s[1:]
    if s == '0':
        return 0
    if s.startswith('0b'):
        return sign * int(s[2:], 2)
    if s.startswith('0x'):
        return sign * int(s[2:], 16)
    if s[0] == '0':
        return sign * int(s, 8)
    if ':' in s:
        return sign * _sexagesimal(s, int)
    return sign * int(s)


def _to_float(s: str) -> float:
    s = s.replace('_', '').lower()
    sign = -1.0 if s[0] == '-' else 1.0
    if s[0] in '+-':
        s = s[1:]
    if s == '.inf':
        return sign * float('inf')
    if s == '.nan':
        return float('nan')
    if ':' in s:
        return sign * _sexagesimal(s, float)
    return sign * float(s)


def resolve_plain(s: str):
    """A plain scalar typed as PyYAML's implicit resolvers type it."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ('yes', 'true', 'on')
    if _INT.match(s):
        return _to_int(s)
    if _FLOAT.match(s):
        return _to_float(s)
    if _TIMESTAMP.match(s):
        raise YamlSubsetError(f'timestamps are not supported: {s!r}')
    if s[:1] in ('&', '*', '!', '|', '>', '@', '`', '%'):
        raise YamlSubsetError(f'unsupported YAML construct: {s!r}')
    return s


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != '\\':
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise YamlSubsetError(f'unknown escape \\{e}')
    return ''.join(out)


def _strip_comment(line: str) -> str:
    """The line without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote and not (quote == '"' and line[i - 1] == '\\'):
                quote = None
        elif c in '"\'' and (i == 0 or line[i - 1] in ' \t[{,:-'):
            quote = c
        elif c == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive-descent reader of one flow node (a list, a mapping or a
    scalar) from a string."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in ' \t\n':
            self.i += 1

    def node(self, stops: str):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == '[':
            return self._seq()
        if c == '{':
            return self._map()
        if c in ('"', "'"):
            return self._quoted()
        j = self.i
        while j < len(self.s) and self.s[j] not in stops:
            if self.s[j] == ':' and j + 1 < len(self.s) and self.s[j + 1] in ' \t' and ':' in stops:
                break
            j += 1
        text = self.s[self.i:j].strip()
        self.i = j
        return resolve_plain(text)

    def _quoted(self):
        q = self.s[self.i]
        j = self.i + 1
        while True:
            if j >= len(self.s):
                raise YamlSubsetError(f'unterminated quoted scalar in {self.s!r}')
            if self.s[j] == q:
                if q == "'" and self.s[j + 1:j + 2] == "'":
                    j += 2
                    continue
                break
            j += 2 if (q == '"' and self.s[j] == '\\') else 1
        body = self.s[self.i + 1:j]
        self.i = j + 1
        return _double_quoted(body) if q == '"' else body.replace("''", "'")

    def _expect(self, c: str):
        self._ws()
        if self.s[self.i:self.i + 1] != c:
            raise YamlSubsetError(f'expected {c!r} at {self.i} in {self.s!r}')
        self.i += 1

    def _seq(self):
        self._expect('[')
        out = []
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == ']':
                self.i += 1
                return out
            out.append(self.node(',]'))
            self._ws()
            if self.s[self.i:self.i + 1] == ',':
                self.i += 1

    def _map(self):
        self._expect('{')
        out = {}
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == '}':
                self.i += 1
                return out
            key = self.node(':,}')
            self._ws()
            value = None
            if self.s[self.i:self.i + 1] == ':':
                self.i += 1
                value = self.node(',}')
            out[key] = value
            self._ws()
            if self.s[self.i:self.i + 1] == ',':
                self.i += 1

    def done(self):
        self._ws()
        if self.i != len(self.s):
            raise YamlSubsetError(f'trailing text after a flow node: {self.s[self.i:]!r}')


def _scalar_or_flow(text: str):
    f = _Flow(text)
    value = f.node('')
    f.done()
    return value


def _split_key(content: str):
    """``key: value`` -> (key, value text); None when the line is no
    mapping entry."""
    if content[:1] in ('"', "'"):
        f = _Flow(content)
        key = f._quoted()
        rest = content[f.i:]
        if rest.startswith(':') and (len(rest) == 1 or rest[1] in ' \t'):
            return key, rest[1:].strip()
        return None
    m = re.search(r':(?:[ \t]|$)', content)
    if m is None or content[:1] in '[{':
        return None
    return resolve_plain(content[:m.start()].strip()), content[m.end():].strip()


class _Block:
    def __init__(self, text: str):
        self.lines = []
        for raw in text.splitlines():
            if '\t' in raw[:len(raw) - len(raw.lstrip())]:
                raise YamlSubsetError('tabs in indentation')
            line = _strip_comment(raw)
            if not line.strip() or line.strip() in ('---', '...'):
                continue
            self.lines.append((len(line) - len(line.lstrip(' ')), line.strip()))
        self.k = 0

    def _flow_text(self, first: str) -> str:
        """A flow node's text, joined over the lines it spans."""
        text = first
        while _depth(text) > 0:
            if self.k >= len(self.lines):
                raise YamlSubsetError(f'unterminated flow node: {first!r}')
            text += ' ' + self.lines[self.k][1]
            self.k += 1
        return text

    def _value(self, text: str, indent: int, allow_seq_same_indent: bool):
        """A mapping value or sequence item: inline text, or the block that
        follows on deeper-indented lines."""
        if text:
            if text[0] in '[{':
                return _scalar_or_flow(self._flow_text(text))
            if text[0] in '|>':
                raise YamlSubsetError('block scalars are not supported')
            if text.startswith('- ') or text == '-':
                raise YamlSubsetError('compact nested sequences are not supported')
            if self.k < len(self.lines) and self.lines[self.k][0] > indent:
                raise YamlSubsetError(f'multi-line plain scalar after {text!r}')
            return _scalar_or_flow(text)
        if self.k < len(self.lines):
            nxt_indent, nxt = self.lines[self.k]
            if nxt_indent > indent:
                return self.node(nxt_indent)
            if (allow_seq_same_indent and nxt_indent == indent
                    and (nxt.startswith('- ') or nxt == '-')):
                return self.node(nxt_indent)
        return None

    def node(self, indent: int):
        content = self.lines[self.k][1]
        if content.startswith('- ') or content == '-':
            return self._seq(indent)
        if content[0] in '[{':
            self.k += 1
            return _scalar_or_flow(self._flow_text(content))
        if _split_key(content) is None:
            self.k += 1
            return _scalar_or_flow(content)
        return self._map(indent)

    def _seq(self, indent: int):
        out = []
        while self.k < len(self.lines):
            ind, content = self.lines[self.k]
            if ind < indent or not (content.startswith('- ') or content == '-'):
                break
            if ind > indent:
                raise YamlSubsetError(f'bad indentation at {content!r}')
            self.k += 1
            item = content[1:].strip()
            if item and _split_key(item) is not None and item[0] not in '[{"\'':
                raise YamlSubsetError('mappings inside sequence items are not supported')
            out.append(self._value(item, indent, False))
        return out

    def _map(self, indent: int):
        out = {}
        while self.k < len(self.lines):
            ind, content = self.lines[self.k]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f'bad indentation at {content!r}')
            kv = _split_key(content)
            if kv is None:
                if content.startswith('- ') or content == '-':
                    break
                raise YamlSubsetError(f'expected "key: value", got {content!r}')
            self.k += 1
            key, text = kv
            if key == '<<':
                raise YamlSubsetError('merge keys are not supported')
            out[key] = self._value(text, indent, True)
        return out


def _depth(text: str) -> int:
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote and not (quote == '"' and text[i - 1] == '\\'):
                quote = None
        elif c in '"\'':
            quote = c
        elif c in '[{':
            depth += 1
        elif c in ']}':
            depth -= 1
    return depth


def safe_load(text: str):
    """Parse ``text`` (the supported subset) like ``yaml.safe_load``."""
    b = _Block(text)
    if not b.lines:
        return None
    value = b.node(b.lines[0][0])
    if b.k != len(b.lines):
        raise YamlSubsetError(f'unexpected line: {b.lines[b.k][1]!r}')
    return value


def load_file(path: str):
    with open(path, 'r') as f:
        return safe_load(f.read())
