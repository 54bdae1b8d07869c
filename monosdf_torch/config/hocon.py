"""Minimal HOCON-subset parser + two-file layering: a copy of
monosdf_tpu/config/hocon.py (the port imports nothing of the JAX package).

The reference uses pyhocon with ``ConfigTree.merge_configs`` for --conf /
--conf_add layering (reference code/training/monosdf_train.py:43-48). This
parser covers the subset its confs actually use: nested objects (with the
``key { ... }`` and ``key\n{ ... }`` forms), ``=``/``:`` separators, lists,
numbers, booleans, bare and quoted strings, ``#``/``//`` comments.
"""

from __future__ import annotations

import re


class HoconError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*|//[^\n]*)
  | (?P<lbrace>\{) | (?P<rbrace>\}) | (?P<lbracket>\[) | (?P<rbracket>\])
  | (?P<sep>[=:]) | (?P<comma>,) | (?P<newline>\n)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<bare>[^\s=:,\{\}\[\]\#]+)
  | (?P<ws>[ \t\r]+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise HoconError(f"Unexpected character at {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("comment", "ws"):
            continue
        tokens.append((kind, m.group()))
    tokens.append(("eof", ""))
    return tokens


def _convert_scalar(raw: str):
    if raw.startswith('"'):
        return raw[1:-1].encode().decode("unicode_escape")
    low = raw.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self, skip_newlines=True):
        j = self.i
        while skip_newlines and self.tokens[j][0] == "newline":
            j += 1
        return self.tokens[j]

    def next(self, skip_newlines=True):
        while skip_newlines and self.tokens[self.i][0] == "newline":
            self.i += 1
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def parse_object_body(self, root=False):
        obj: dict = {}
        while True:
            kind, val = self.peek()
            if kind == "eof":
                if root:
                    return obj
                raise HoconError("Unexpected EOF inside object")
            if kind == "rbrace":
                self.next()
                return obj
            if kind not in ("bare", "string"):
                raise HoconError(f"Expected key, got {kind}={val!r}")
            self.next()
            key = _convert_scalar(val) if kind == "string" else val

            kind2, _ = self.peek()
            if kind2 == "lbrace":
                self.next()
                value = self.parse_object_body()
                if isinstance(obj.get(key), dict):
                    obj[key] = merge_configs(obj[key], value)
                else:
                    obj[key] = value
            elif kind2 == "sep":
                self.next()
                value = self.parse_value()
                if isinstance(value, dict) and isinstance(obj.get(key), dict):
                    obj[key] = merge_configs(obj[key], value)
                else:
                    obj[key] = value
            else:
                raise HoconError(f"Expected '=' or '{{' after key {key!r}")
            # optional comma
            if self.peek(skip_newlines=False)[0] == "comma":
                self.next(skip_newlines=False)

    def parse_value(self):
        kind, val = self.next()
        if kind == "lbrace":
            return self.parse_object_body()
        if kind == "lbracket":
            return self.parse_list()
        if kind in ("bare", "string"):
            return _convert_scalar(val)
        raise HoconError(f"Unexpected value token {kind}={val!r}")

    def parse_list(self):
        items = []
        while True:
            kind, val = self.peek()
            if kind == "rbracket":
                self.next()
                return items
            if kind == "comma":
                self.next()
                continue
            items.append(self.parse_value())


def parse_hocon(text: str) -> dict:
    return _Parser(_tokenize(text)).parse_object_body(root=True)


def parse_hocon_file(path: str) -> dict:
    with open(path) as f:
        return parse_hocon(f.read())


def merge_configs(base: dict, overlay: dict) -> dict:
    """Deep merge: overlay wins on scalars/lists, dicts merge recursively
    (pyhocon ConfigTree.merge_configs semantics)."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = v
    return out
