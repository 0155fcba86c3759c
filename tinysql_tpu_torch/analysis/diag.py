"""Shared diagnostic/reporting core for the qlint passes.

Every pass produces `Diagnostic`s; this module owns the common machinery:
source loading + AST parse, the inline-suppression protocol, rule
registration, and report formatting.  The suppression syntax is

    offending_line()  # qlint: disable=TS101 -- why this is actually fine

- the comment may sit on the flagged line or on the line directly above;
- `disable=` takes a comma-separated rule list or `all`;
- the `-- justification` text is REQUIRED: a disable without it does not
  suppress anything and instead raises its own QL001 violation, so every
  suppression in the tree documents WHY the code is correct.
"""
from __future__ import annotations

import ast
import os
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Dict, Iterable, List, Optional, Set, Tuple


class Severity:
    ERROR = "error"
    WARNING = "warning"


#: rule code -> one-line description; passes register on import so the CLI
#: can print the catalogue (`tools/lint.py --rules`)
RULES: Dict[str, str] = {
    "QL001": "qlint disable comment without a `-- justification` text",
}


def register_rules(rules: Dict[str, str]) -> None:
    RULES.update(rules)


@dataclass
class Diagnostic:
    rule: str
    message: str
    path: str = "<plan>"
    line: int = 0
    col: int = 0
    severity: str = Severity.ERROR

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.severity}: {self.rule} {self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*qlint:\s*disable=([A-Za-z0-9_,\s]+?)"
    r"(?:\s*--\s*(.*?))?\s*$")


@dataclass
class _Suppression:
    line: int
    rules: Set[str]
    justification: str


class SourceFile:
    """One parsed source file: text, AST, and its suppression table."""

    def __init__(self, path: str, text: Optional[str] = None):
        self.path = path
        if text is None:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.suppressions: List[_Suppression] = []
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(StringIO(self.text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.suppressions.append(_Suppression(
                    tok.start[0], rules, (m.group(2) or "").strip()))
        except tokenize.TokenError:
            pass

    def suppressed(self, rule: str, line: int) -> bool:
        """Is `rule` disabled at `line`?  Same-line or line-above comments
        apply; a justification-less disable never suppresses (QL001)."""
        for s in self.suppressions:
            if s.line in (line, line - 1) and s.justification \
                    and (rule in s.rules or "all" in s.rules):
                return True
        return False

    def check_suppression_syntax(self) -> List[Diagnostic]:
        out = []
        for s in self.suppressions:
            if not s.justification:
                out.append(Diagnostic(
                    "QL001",
                    "suppression requires a justification: "
                    "`# qlint: disable=RULE -- why this is correct`",
                    self.path, s.line))
            for r in s.rules:
                if r != "all" and r not in RULES:
                    out.append(Diagnostic(
                        "QL001", f"unknown rule {r!r} in disable comment",
                        self.path, s.line))
        return out

    def filter(self, diags: Iterable[Diagnostic]) -> List[Diagnostic]:
        return [d for d in diags if not self.suppressed(d.rule, d.line)]


def gather_sources(root: str,
                   skip_dirs: Tuple[str, ...] = ()) -> List[SourceFile]:
    """All .py files under `root` (a package dir or a single file)."""
    if os.path.isfile(root):
        return [SourceFile(root)]
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in skip_dirs and not d.startswith(".")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(SourceFile(os.path.join(dirpath, fn)))
    return out


def format_diagnostics(diags: List[Diagnostic]) -> str:
    lines = [d.format() for d in diags]
    lines.append(f"{len(diags)} violation" + ("s" if len(diags) != 1 else ""))
    return "\n".join(lines)
