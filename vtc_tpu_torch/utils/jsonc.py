"""JSONC (JSON-with-comments) reader/writer.

The port's own copy of ``vtc_tpu/utils/jsonc.py`` (standard library only), so
that the port reads the repo's ``configs/*.jsonc`` without the JAX package.

The reference loads its ``configs/*.jsonc`` files through pyjson5
(``utils/util.py:60-63``). pyjson5 is not available here, so
this is a small self-contained JSONC front end: it strips ``//`` and ``/* */``
comments and trailing commas (both occur in the reference configs) and then
defers to the stdlib ``json`` parser.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Any


def _strip_jsonc(text: str) -> str:
    """Remove comments and trailing commas from JSONC text.

    Runs a tiny state machine so comment markers inside string literals are
    preserved.
    """
    out = []
    i = 0
    n = len(text)
    in_string = False
    while i < n:
        c = text[i]
        if in_string:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_string = False
            i += 1
            continue
        if c == '"':
            in_string = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.append(c)
        i += 1

    stripped = "".join(out)

    # Remove trailing commas: a comma followed only by whitespace and a
    # closing bracket/brace. Repeat to handle ",]," chains like "},],".
    result = []
    i = 0
    n = len(stripped)
    in_string = False
    while i < n:
        c = stripped[i]
        if in_string:
            result.append(c)
            if c == "\\" and i + 1 < n:
                result.append(stripped[i + 1])
                i += 2
                continue
            if c == '"':
                in_string = False
            i += 1
            continue
        if c == '"':
            in_string = True
            result.append(c)
            i += 1
            continue
        if c == ",":
            j = i + 1
            while j < n and stripped[j] in " \t\r\n":
                j += 1
            if j < n and stripped[j] in "]}":
                i += 1  # drop the trailing comma
                continue
        result.append(c)
        i += 1
    return "".join(result)


def loads(text: str) -> Any:
    return json.loads(_strip_jsonc(text), object_pairs_hook=OrderedDict)


def read_json(fname) -> Any:
    """Read a JSON or JSONC file into an OrderedDict tree.

    Mirrors ``utils/util.py:60-63`` in the reference (pyjson5 read with
    OrderedDict hook).
    """
    fname = Path(fname)
    with fname.open("rt") as handle:
        return loads(handle.read())


def write_json(content: Any, fname) -> None:
    """Mirrors ``utils/util.py:66-69``: indent=4, insertion order preserved."""
    fname = Path(fname)
    with fname.open("wt") as handle:
        json.dump(content, handle, indent=4, sort_keys=False)
