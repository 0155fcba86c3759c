"""SQL lexer.

Capability parity with reference parser/lexer.go (873 L) + misc.go token
tables: MySQL-ish tokens — backquoted identifiers, single/double-quoted
strings with escapes, ints/floats/scientific, hex literals, line (`--`, `#`)
and block comments, user (@v) and system (@@v) variables, multi-char
operators.  Keywords are recognized case-insensitively by the parser, not
reserved here beyond a shared set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

# token kinds
T_EOF = "eof"
T_IDENT = "ident"
T_QIDENT = "qident"      # `quoted`
T_INT = "int"
T_FLOAT = "float"
T_STRING = "string"
T_OP = "op"
T_SYSVAR = "sysvar"      # @@name or @@global.name / @@session.name
T_USERVAR = "uservar"    # @name

_OPS = [
    "<=>", "<<", ">>", "<=", ">=", "<>", "!=", ":=", "||", "&&",
    "+", "-", "*", "/", "%", "=", "<", ">", "(", ")", ",", ".", ";",
    "!", "~", "^", "&", "|", "?",
]


class ParseError(Exception):
    def __init__(self, msg: str, pos: int = -1, line: int = -1):
        near = f" near position {pos}" if pos >= 0 else ""
        super().__init__(f"You have an error in your SQL syntax: {msg}{near}")
        self.pos = pos


@dataclass
class Token:
    kind: str
    value: object
    text: str
    pos: int

    def __repr__(self) -> str:  # pragma: no cover
        return f"Token({self.kind},{self.text!r})"


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        # comments
        if c == "#" or (c == "-" and sql[i:i + 3] in ("-- ", "--\t", "--\n") or sql[i:i + 2] == "--" and i + 2 == n):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and sql[i:i + 2] == "/*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise ParseError("unterminated comment", i)
            i = j + 2
            continue
        # strings
        if c in "'\"":
            start = i
            s, i = _lex_string(sql, i, c)
            toks.append(Token(T_STRING, s, sql[start:i], start))
            continue
        # quoted identifier
        if c == "`":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "`":
                    if sql[j:j + 2] == "``":
                        buf.append("`")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise ParseError("unterminated identifier", i)
            toks.append(Token(T_QIDENT, "".join(buf), "".join(buf), i))
            i = j + 1
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            tok, i = _lex_number(sql, i)
            toks.append(tok)
            continue
        # variables
        if c == "@":
            if sql[i:i + 2] == "@@":
                j = i + 2
                while j < n and (sql[j].isalnum() or sql[j] in "_."):
                    j += 1
                toks.append(Token(T_SYSVAR, sql[i + 2:j].lower(), sql[i:j], i))
                i = j
                continue
            j = i + 1
            while j < n and (sql[j].isalnum() or sql[j] in "_."):
                j += 1
            toks.append(Token(T_USERVAR, sql[i + 1:j].lower(), sql[i:j], i))
            i = j
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_" or ord(c) > 127:
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_" or ord(sql[j]) > 127):
                j += 1
            word = sql[i:j]
            # hex literal 0x... handled in numbers; also x'ab' b'01' skipped
            toks.append(Token(T_IDENT, word, word, i))
            i = j
            continue
        # operators
        for op in _OPS:
            if sql.startswith(op, i):
                toks.append(Token(T_OP, op, op, i))
                i += len(op)
                break
        else:
            raise ParseError(f"unexpected character {c!r}", i)
    toks.append(Token(T_EOF, None, "", n))
    return toks


def _lex_string(sql: str, i: int, quote: str):
    j = i + 1
    n = len(sql)
    buf = []
    while j < n:
        c = sql[j]
        if c == "\\" and j + 1 < n:
            esc = sql[j + 1]
            buf.append({"n": "\n", "t": "\t", "r": "\r", "0": "\0",
                        "b": "\b", "Z": "\x1a", "\\": "\\",
                        "'": "'", '"': '"', "%": "\\%", "_": "\\_"}.get(esc, esc))
            j += 2
            continue
        if c == quote:
            if sql[j:j + 2] == quote * 2:  # doubled quote escape
                buf.append(quote)
                j += 2
                continue
            return "".join(buf), j + 1
        buf.append(c)
        j += 1
    raise ParseError("unterminated string", i)


def _lex_number(sql: str, i: int):
    n = len(sql)
    j = i
    if sql[j:j + 2].lower() == "0x":
        j += 2
        start = j
        while j < n and sql[j] in "0123456789abcdefABCDEF":
            j += 1
        return Token(T_INT, int(sql[start:j] or "0", 16), sql[i:j], i), j
    is_float = False
    while j < n and sql[j].isdigit():
        j += 1
    if j < n and sql[j] == ".":
        is_float = True
        j += 1
        while j < n and sql[j].isdigit():
            j += 1
    if j < n and sql[j] in "eE":
        k = j + 1
        if k < n and sql[k] in "+-":
            k += 1
        if k < n and sql[k].isdigit():
            is_float = True
            j = k
            while j < n and sql[j].isdigit():
                j += 1
    text = sql[i:j]
    if is_float:
        return Token(T_FLOAT, float(text), text, i), j
    v = int(text)
    return Token(T_INT, v, text, i), j
