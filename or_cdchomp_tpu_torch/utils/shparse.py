# Copied from or_cdchomp_tpu/utils/shparse.py (host Python; shared copy pending de-duplication).
"""POSIX-shell-like command tokenizer.

Mirrors cd_util_shparse (src/libcd/util_shparse.c:37-128): splits a
command string into argv tokens honoring single quotes, double quotes,
and backslash escapes — the transport format used by the reference's
SendCommand strings (orcwrap.cpp:37-69) and emitted by the python
bindings' ``shquot`` (orcdchomp.py:39-40).
"""

from __future__ import annotations


def shparse(text: str) -> list:
    """Tokenize like a POSIX shell word-splitter (no expansions)."""
    toks = []
    cur = []
    in_tok = False
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            if in_tok:
                toks.append("".join(cur))
                cur = []
                in_tok = False
            i += 1
        elif c == "'":
            in_tok = True
            i += 1
            while i < n and text[i] != "'":
                cur.append(text[i])
                i += 1
            if i >= n:
                raise ValueError("unterminated single quote")
            i += 1
        elif c == '"':
            in_tok = True
            i += 1
            while i < n and text[i] != '"':
                if text[i] == "\\" and i + 1 < n and text[i + 1] in '"\\':
                    i += 1
                cur.append(text[i])
                i += 1
            if i >= n:
                raise ValueError("unterminated double quote")
            i += 1
        elif c == "\\":
            in_tok = True
            if i + 1 >= n:
                raise ValueError("trailing backslash")
            cur.append(text[i + 1])
            i += 2
        else:
            in_tok = True
            cur.append(c)
            i += 1
    if in_tok:
        toks.append("".join(cur))
    return toks


def shquot(s: str) -> str:
    """Quote for shparse round-trip (orcdchomp.py:39-40)."""
    return "'" + s.replace("'", "'\\''") + "'"
