"""Read the repo's tuned-example yamls without a YAML package.

The tuned examples (``tuned_examples/*/*.yaml``) use a small subset of
YAML: mappings nested by indentation, ``key: scalar`` lines, ``#``
comments, and flow lists of scalars. This parser reads that subset and
raises on anything else, so a port run needs no PyYAML.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Tuple

_NUMBER = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _strip_comment(line: str) -> str:
    out, quote = [], None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            break
        out.append(ch)
    return "".join(out).rstrip()


def _scalar(text: str) -> Any:
    if text in ("null", "~", "Null", "NULL"):
        return None
    if text in ("true", "True", "TRUE"):
        return True
    if text in ("false", "False", "FALSE"):
        return False
    if _NUMBER.match(text):
        return int(text) if re.match(r"^[-+]?\d+$", text) else float(text)
    if text[:1] in "'\"" and text[-1:] == text[:1]:
        return text[1:-1]
    if text.startswith("["):
        return json.loads(text)
    if text.startswith(("{", "&", "*", "!", "|", ">", "- ")):
        raise ValueError(f"unsupported YAML value {text!r}")
    return text


def parse(text: str) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = [(-1, root)]
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep or key.startswith("- "):
            raise ValueError(f"unsupported YAML line {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        value = value.strip()
        if value:
            parent[key] = _scalar(value)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
    return root


def load_tuned_example(path) -> Dict[str, Any]:
    """The yaml as nested dicts: ``{experiment: {"env", "run", "stop",
    "config"}}``."""
    return parse(Path(path).read_text())
