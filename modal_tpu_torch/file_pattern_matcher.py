"""Dockerignore-style path matching (port of modal_tpu/file_pattern_matcher.py;
reference py/modal/file_pattern_matcher.py):
`FilePatternMatcher("**/*.pyc", "!keep/**")` answers whether a relative path
matches — used as the `ignore=` argument to `Mount.from_local_dir` /
`add_local_dir`. Later patterns win (dockerignore semantics); a leading `!`
re-includes. Own implementation: each pattern compiles to a regex where
`**` crosses directory separators, `*`/`?` do not.
"""

from __future__ import annotations

import re
from pathlib import Path, PurePosixPath
from typing import Callable, Union


def _translate(pattern: str) -> "re.Pattern[str]":
    pattern = pattern.strip().strip("/")
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i : i + 2] == "**":
                # '**/' or trailing '**': any number of segments (incl. none)
                if pattern[i : i + 3] == "**/":
                    out.append(r"(?:[^/]+/)*")
                    i += 3
                else:
                    out.append(r".*")
                    i += 2
            else:
                out.append(r"[^/]*")
                i += 1
        elif c == "?":
            out.append(r"[^/]")
            i += 1
        elif c == "[":
            j = pattern.find("]", i)
            if j == -1:
                out.append(re.escape(c))
                i += 1
            else:
                out.append(pattern[i : j + 1])
                i = j + 1
        else:
            out.append(re.escape(c))
            i += 1
    return re.compile("^" + "".join(out) + "$")


class FilePatternMatcher:
    """Callable matcher over relative paths. `matcher(path)` is True when
    the path matches the pattern set (later patterns override earlier ones;
    `!pattern` re-includes). `~matcher` gives the complement — handy when an
    API wants a keep-condition instead of an ignore-condition."""

    def __init__(self, *patterns: str):
        self._rules: list[tuple[bool, re.Pattern[str]]] = []
        for raw in patterns:
            raw = raw.strip()
            if not raw or raw.startswith("#"):
                continue
            negated = raw.startswith("!")
            self._rules.append((negated, _translate(raw[1:] if negated else raw)))

    @staticmethod
    def from_file(path: Union[str, Path]) -> "FilePatternMatcher":
        """Build from a .dockerignore / .gitignore-style file."""
        lines = Path(path).read_text().splitlines()
        return FilePatternMatcher(*lines)

    def __call__(self, path: Union[str, Path]) -> bool:
        rel = str(PurePosixPath(Path(path))).lstrip("/")
        # dockerignore: a rule matching the path OR any parent dir applies
        parts = rel.split("/")
        prefixes = ["/".join(parts[: k + 1]) for k in range(len(parts))]
        matched = False
        for negated, regex in self._rules:
            if any(regex.match(p) for p in prefixes):
                matched = not negated
        return matched

    def __invert__(self) -> Callable[[Union[str, Path]], bool]:
        return lambda path: not self(path)
