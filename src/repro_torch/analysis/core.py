"""tentlint framework core: files, findings, pragmas, fingerprints.

The linter is purely syntactic: it parses every Python file with `ast`,
reads every CUDA source (`.cu`, `.cuh`) as text, and never imports or
compiles the code under analysis, so it runs in about a second, works where
neither a card nor nvcc is present, and can never be perturbed by import-time
side effects.

Three layers:

* `FileContext`: one source file, its text and the per-line suppression
  pragmas. A Python file carries its AST and takes `# tentlint:
  disable=<rule>[,<rule>]` on the flagged line and `# tentlint:
  disable-file=<rule>` anywhere; a CUDA file carries its text with the
  comments blanked (`code`) and takes the same pragmas after `//`.
* `Project`: the scanned file set plus the classification every rule
  shares: which files count as engine source (`src/repro_torch/` by
  default) and which count as tests. Cross-file rules (twin-drift, the CUDA
  half of fma-hazard) resolve names here.
* `Finding`: one diagnostic, carrying a *content fingerprint* (rule + file
  basename + normalized line text + same-line occurrence ordinal) so
  baseline entries survive unrelated line drift but die with the code they
  described. The scheme is the reference linter's, byte for byte.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "CUDA_SUFFIXES",
    "FileContext",
    "Finding",
    "Project",
    "Rule",
    "SOURCE_SUFFIXES",
    "dotted_name",
    "iter_source_files",
    "strip_c_comments",
]

# Directories never walked: generated caches plus the deliberate-violation
# lint fixtures (they exist to be broken; the fixture tests lint them with
# explicit paths, which bypass the walk entirely).
SKIP_DIR_NAMES = {"__pycache__", ".git", ".hypothesis", ".pytest_cache"}
SKIP_REL_PREFIXES = ("tests/fixtures/",)

CUDA_SUFFIXES = (".cu", ".cuh")
SOURCE_SUFFIXES = (".py",) + CUDA_SUFFIXES

_PRAGMA_RE = re.compile(r"#\s*tentlint:\s*(disable|disable-file)=([\w\-, ]+)")
_CUDA_PRAGMA_RE = re.compile(r"^//\s*tentlint:\s*(disable|disable-file)=([\w\-, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. `fingerprint` identifies the finding by content (not
    line number) for the committed baseline; `suppressed`/`baselined` are
    set by the driver, never by rules."""

    rule: str
    path: str  # project-root-relative, posix separators
    line: int
    col: int
    message: str
    snippet: str
    fingerprint: str
    suppressed: bool = False
    baselined: bool = False

    @property
    def active(self) -> bool:
        """True when this finding should fail a gate: neither suppressed by
        a pragma nor accepted into the committed baseline."""
        return not (self.suppressed or self.baselined)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def strip_c_comments(text: str) -> Tuple[str, List[Tuple[int, str]]]:
    """`text` with every `//` and `/* */` comment replaced by spaces (line
    breaks kept, so lines and columns still match the file), and the
    comments as `(line, text)`. String and character literals are kept
    whole, so a `//` inside one is no comment."""
    out: List[str] = []
    comments: List[Tuple[int, str]] = []
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
            out.append(text[i:j])
            i = j
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            comments.append((line, text[i:j]))
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            body = text[i:j]
            comments.append((line, body))
            out.append(re.sub(r"[^\n]", " ", body))
            line += body.count("\n")
            i = j
        else:
            if c == "\n":
                line += 1
            out.append(c)
            i += 1
    return "".join(out), comments


class FileContext:
    """One source file plus its suppression pragmas. `tree` is the AST of a
    Python file and None for a CUDA one, whose `code` is its text with the
    comments blanked."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.is_cuda = Path(rel).suffix in CUDA_SUFFIXES
        self.line_disables: Dict[int, Set[str]] = {}
        self.file_disables: Set[str] = set()
        if self.is_cuda:
            self.tree = None
            self.code, comments = strip_c_comments(text)
            for line, comment in comments:
                m = _CUDA_PRAGMA_RE.search(comment)
                if m:
                    self._add_pragma(m.group(1), m.group(2), line)
        else:
            self.tree = ast.parse(text, filename=rel)
            self.code = text
            self._scan_pragmas()

    def _add_pragma(self, kind: str, rule_ids: str, line: int) -> None:
        ids = {r.strip() for r in rule_ids.split(",") if r.strip()}
        if kind == "disable-file":
            self.file_disables |= ids
        else:
            self.line_disables.setdefault(line, set()).update(ids)

    def _scan_pragmas(self) -> None:
        # Pragmas live in comments; scanning raw lines would also match
        # string literals, so only genuine COMMENT tokens count.
        try:
            tokens = tokenize.generate_tokens(iter(self.lines_iter()).__next__)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA_RE.search(tok.string)
                if m:
                    self._add_pragma(m.group(1), m.group(2), tok.start[0])
        except tokenize.TokenError:  # unterminated constructs: best effort
            pass

    def lines_iter(self):
        for ln in self.lines:
            yield ln + "\n"

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        for ids in (self.file_disables, self.line_disables.get(line, ())):
            if rule_id in ids or "all" in ids:
                return True
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class Rule:
    """One invariant. Subclasses implement `check_file` (per-file findings
    as `(line, col, message)` triples) and may implement `finalize` for
    cross-file checks that need the whole `Project`. `check_file` sees
    Python files only, unless `reads_cuda` is set."""

    id: str = "abstract"
    description: str = ""
    reads_cuda: bool = False

    def check_file(self, ctx: FileContext,
                   project: "Project") -> Iterable[Tuple[int, int, str]]:
        return ()

    def finalize(self,
                 project: "Project") -> Iterable[Tuple[str, int, int, str]]:
        """Cross-file findings as `(rel_path, line, col, message)`."""
        return ()


class Project:
    """The scanned file set plus shared path classification.

    `src_prefixes` decides which files carry the engine-source invariants
    (wall-clock purity, FMA guards, ordered iteration, twins); the default
    matches this repo's layout and the fixture tests override it to treat a
    fixture directory as its own miniature project. `memo` holds what a rule
    derives once per project (the CUDA builds).
    """

    def __init__(self, root: Path, files: Sequence[Path], *,
                 src_prefixes: Tuple[str, ...] = ("src/repro_torch/",),
                 test_markers: Tuple[str, ...] = ("tests/",)):
        self.root = Path(root)
        self.src_prefixes = src_prefixes
        self.test_markers = test_markers
        self.contexts: List[FileContext] = []
        self.errors: List[Tuple[str, str]] = []  # (rel, parse error)
        self.memo: Dict[str, object] = {}
        for f in files:
            rel = self._rel(f)
            try:
                text = f.read_text()
                self.contexts.append(FileContext(f, rel, text))
            except (SyntaxError, UnicodeDecodeError) as e:
                self.errors.append((rel, str(e)))

    def _rel(self, path: Path) -> str:
        try:
            return path.resolve().relative_to(self.root.resolve()).as_posix()
        except ValueError:
            return path.as_posix()

    def is_src(self, rel: str) -> bool:
        return self.src_rel(rel) is not None

    def src_rel(self, rel: str) -> Optional[str]:
        """`rel` below the first source prefix it lies under (the path the
        rules' per-module lists name), or None outside engine source."""
        for p in self.src_prefixes:
            if p in ("", "./"):
                return rel
            if rel.startswith(p):
                return rel[len(p):]
        return None

    def is_test(self, rel: str) -> bool:
        return any(rel.startswith(m) or f"/{m}" in rel
                   for m in self.test_markers)

    def context_for(self, rel: str) -> Optional[FileContext]:
        for ctx in self.contexts:
            if ctx.rel == rel:
                return ctx
        return None

    def files_by_suffix(self) -> Dict[str, int]:
        """Scanned files by suffix, every suffix the walk takes listed."""
        out = {s: 0 for s in SOURCE_SUFFIXES}
        for ctx in self.contexts:
            suffix = Path(ctx.rel).suffix
            out[suffix] = out.get(suffix, 0) + 1
        return out


def fingerprint(rule_id: str, rel: str, normalized_line: str,
                ordinal: int) -> str:
    base = Path(rel).name
    payload = f"{rule_id}\x00{base}\x00{normalized_line}\x00{ordinal}"
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def make_findings(rule_id: str, ctx: FileContext,
                  raw: Iterable[Tuple[int, int, str]]) -> List[Finding]:
    """Attach suppression flags and content fingerprints to a rule's raw
    `(line, col, message)` output. The ordinal counts earlier findings of
    the same rule on an identical normalized line in the same file, so two
    copies of one bad statement get distinct, stable fingerprints."""
    seen: Dict[str, int] = {}
    out: List[Finding] = []
    for line, col, message in sorted(raw):
        norm = " ".join(ctx.line_text(line).split())
        ordinal = seen.get(norm, 0)
        seen[norm] = ordinal + 1
        out.append(Finding(
            rule=rule_id,
            path=ctx.rel,
            line=line,
            col=col,
            message=message,
            snippet=ctx.line_text(line).strip(),
            fingerprint=fingerprint(rule_id, ctx.rel, norm, ordinal),
            suppressed=ctx.is_suppressed(rule_id, line),
        ))
    return out


def run_rules(project: Project, rules: Sequence[Rule]) -> List[Finding]:
    findings: List[Finding] = []
    for rule in rules:
        for ctx in project.contexts:
            if ctx.is_cuda and not rule.reads_cuda:
                continue
            findings.extend(make_findings(
                rule.id, ctx, rule.check_file(ctx, project)))
        for rel, line, col, message in rule.finalize(project):
            ctx = project.context_for(rel)
            if ctx is None:  # finding against a missing file: no pragmas
                findings.append(Finding(
                    rule=rule.id, path=rel, line=line, col=col,
                    message=message, snippet="",
                    fingerprint=fingerprint(rule.id, rel, message, 0)))
            else:
                findings.extend(make_findings(
                    rule.id, ctx, [(line, col, message)]))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_source_files(paths: Sequence[Path], root: Path) -> List[Path]:
    """Expand CLI path arguments into Python and CUDA sources. Directories
    are walked for `*.py`, `*.cu` and `*.cuh` (skipping caches and the lint
    fixtures); explicitly named files are always included, so fixture tests
    can lint deliberate violations directly."""
    out: List[Path] = []
    seen: Set[Path] = set()

    def add(p: Path) -> None:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            out.append(p)

    for p in paths:
        if p.is_file():
            add(p)
            continue
        for f in sorted(f for f in p.rglob("*") if f.suffix in SOURCE_SUFFIXES):
            if any(part in SKIP_DIR_NAMES for part in f.parts) or not f.is_file():
                continue
            try:
                rel = f.resolve().relative_to(root.resolve()).as_posix()
            except ValueError:
                rel = f.as_posix()
            if any(rel.startswith(pre) for pre in SKIP_REL_PREFIXES):
                continue
            add(f)
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` for Name/Attribute chains, None for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
