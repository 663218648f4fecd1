"""The port's rule set: the reference linter's six rules, read against the
port's own hazards.

Each rule documents the invariant it guards; `README.md` beside this file
says how each applies to the port. Rules are deliberately high-precision:
they key on the syntactic shapes the hazards take in this codebase rather
than trying to be a general-purpose linter, and anything they cannot prove
is left to the parity tests and the card's checks that remain the dynamic
backstop. `no-wall-clock`, `no-global-rng` (its numpy and stdlib part),
`unordered-iter` and `hot-path-alloc` give the reference linter's findings
on the same files; `fma-hazard` reads the compilers the port has (torch's
and Triton's in Python, nvcc for the CUDA sources) and `twin-drift` reads
`__torch_twins__`.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path, PurePosixPath
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import FileContext, Project, Rule, dotted_name

__all__ = ["ALL_RULES", "RULES_BY_ID", "cuda_builds", "default_rules"]


# ---------------------------------------------------------------------------
# import-alias resolution (shared by the wall-clock, RNG and FMA rules)
# ---------------------------------------------------------------------------

def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local names to the dotted origin they were imported as:
    `import numpy as np` -> {"np": "numpy"}, `from time import perf_counter
    as pc` -> {"pc": "time.perf_counter"}. Only absolute imports are
    tracked; they are how this repo imports time/numpy/random/torch."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _aliases(ctx: FileContext, project: Project) -> Dict[str, str]:
    """`_import_aliases` of a file, worked out once per project."""
    key = f"aliases:{ctx.rel}"
    if key not in project.memo:
        project.memo[key] = _import_aliases(ctx.tree)
    return project.memo[key]


def _resolve(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted name of a call target with the leading alias expanded."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = aliases.get(head)
    if origin is None:
        return name
    return f"{origin}.{rest}" if rest else origin


# ---------------------------------------------------------------------------
# no-wall-clock
# ---------------------------------------------------------------------------

class NoWallClock(Rule):
    """Virtual-clock purity (the sub-50 ms healing claims).

    All simulated time flows from `Fabric.now`; a single `time.time()` or
    `datetime.now()` on a simulated path makes reports machine-dependent
    and kills byte-identical reproduction. Forbidden throughout engine
    source, with an explicit allowlist for the modules whose *job* is
    wall-clock measurement. The chip script, the probes and the tests are
    exempt by scope: timing real walls is what they do.
    """

    id = "no-wall-clock"
    description = ("time.time/perf_counter/monotonic/sleep/datetime.now "
                   "forbidden in engine source (virtual-clock purity)")

    FORBIDDEN = {
        "time.time", "time.time_ns",
        "time.perf_counter", "time.perf_counter_ns",
        "time.monotonic", "time.monotonic_ns",
        "time.process_time", "time.process_time_ns",
        "time.sleep",
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "datetime.datetime.today", "datetime.date.today",
    }
    # suffix matches catch `from datetime import datetime; datetime.now()`
    FORBIDDEN_SUFFIXES = ("datetime.now", "datetime.utcnow", "date.today")

    # Modules whose purpose is wall-clock measurement (never on a simulated
    # path): the real-training step timer, the dry run's timer and the
    # host-clock span recorder (its readings feed nothing the simulation
    # reads; engine sites reach the clock only through it), named below the
    # source prefix so that one list judges either package.
    # `sanitize.DYNAMIC_ALLOWLIST` is the same list as module names.
    ALLOWED_FILES = {
        "training/train_loop.py",
        "launch/dryrun.py",
        "obs/spans.py",
    }

    def check_file(self, ctx: FileContext, project: Project):
        if not project.is_src(ctx.rel) or project.is_test(ctx.rel):
            return
        if project.src_rel(ctx.rel) in self.ALLOWED_FILES:
            return
        aliases = _aliases(ctx, project)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _resolve(node.func, aliases)
            if name is None:
                continue
            if name in self.FORBIDDEN or name.endswith(self.FORBIDDEN_SUFFIXES):
                yield (node.lineno, node.col_offset,
                       f"wall-clock call `{name}()` in engine source — "
                       "simulated paths must read the fabric's virtual "
                       "clock (Fabric.now)")


# ---------------------------------------------------------------------------
# no-global-rng
# ---------------------------------------------------------------------------

class NoGlobalRng(Rule):
    """Seeded-randomness discipline (seeded lanes equal single-seed runs;
    every determinism pin in the suite).

    Randomness must flow through an explicitly seeded `np.random.Generator`
    or `torch.Generator`: the numpy, stdlib and torch *global* generators
    are hidden shared state that any import can perturb. So torch's global
    seeders are flagged, and so is a torch sampler called without
    `generator=`. Seeding a generator from `id()`, `hash()` or the wall
    clock is the same hazard wearing a disguise: `id()` changes run to run,
    `hash(str)` changes with PYTHONHASHSEED. Applies to the whole tree: an
    unseeded test is exactly as unreproducible as an unseeded engine.
    """

    id = "no-global-rng"
    description = ("module-level np.random.* / bare random.* / torch's "
                   "global generator and id()/hash()/wall-clock seeds "
                   "forbidden; use seeded np.random.Generator or "
                   "torch.Generator")

    NP_ALLOWED = {
        "default_rng", "Generator", "SeedSequence", "BitGenerator",
        "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
    }
    PY_RANDOM_ALLOWED = {"Random"}  # random.Random(seed) is explicit state
    # constructors and seeders whose seed argument must be deterministic
    SEEDED_CTORS = ("default_rng", "SeedSequence", "Random", "RandomState",
                    "seed", "manual_seed")
    BAD_SEED_CALLS = {"id", "hash", "time.time", "time.time_ns",
                      "time.perf_counter", "time.monotonic", "uuid.uuid4"}
    # calls that seed (or reseed from entropy) torch's global generators
    TORCH_GLOBAL_SEEDERS = {
        "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
        "torch.random.seed", "torch.cuda.manual_seed",
        "torch.cuda.manual_seed_all", "torch.cuda.seed",
        "torch.cuda.seed_all",
    }
    # torch samplers that draw from the global generator unless handed one
    TORCH_SAMPLERS = {
        "rand", "randn", "randint", "randperm", "normal", "bernoulli",
        "multinomial", "rand_like", "randn_like",
    }

    def check_file(self, ctx: FileContext, project: Project):
        aliases = _aliases(ctx, project)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _resolve(node.func, aliases)
            if name is not None:
                yield from self._check_global(node, name)
                yield from self._check_torch(node, name)
            elif isinstance(node.func, ast.Attribute):
                # `torch.Generator(...).manual_seed(...)`: no dotted name
                name = node.func.attr
            else:
                continue
            yield from self._check_seed_args(node, name, aliases)

    def _check_global(self, node: ast.Call, name: str):
        if name.startswith("numpy.random."):
            tail = name[len("numpy.random."):]
            if "." not in tail and tail not in self.NP_ALLOWED:
                yield (node.lineno, node.col_offset,
                       f"global-state RNG `{name}()` — draw from a seeded "
                       "np.random.default_rng(seed) Generator instead")
        elif name.startswith("random."):
            tail = name[len("random."):]
            if "." not in tail and tail not in self.PY_RANDOM_ALLOWED:
                yield (node.lineno, node.col_offset,
                       f"stdlib global RNG `{name}()` — use a seeded "
                       "random.Random(seed) or np.random.default_rng(seed)")

    def _check_torch(self, node: ast.Call, name: str):
        if name in self.TORCH_GLOBAL_SEEDERS:
            yield (node.lineno, node.col_offset,
                   f"`{name}()` sets torch's global generator — hand each "
                   "draw a torch.Generator(device).manual_seed(seed)")
        elif (name.startswith("torch.")
              and name[len("torch."):] in self.TORCH_SAMPLERS
              and not any(kw.arg == "generator" for kw in node.keywords)):
            yield (node.lineno, node.col_offset,
                   f"`{name}()` without generator= draws from torch's "
                   "global generator — pass generator=torch.Generator("
                   "device).manual_seed(seed)")

    def _check_seed_args(self, node: ast.Call, name: str, aliases):
        if not name.endswith(self.SEEDED_CTORS):
            return
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Call):
                    continue
                sub_name = _resolve(sub.func, aliases)
                if sub_name in self.BAD_SEED_CALLS:
                    yield (sub.lineno, sub.col_offset,
                           f"nondeterministic seed: `{sub_name}()` feeding "
                           f"`{name.rsplit('.', 1)[-1]}(...)` changes run "
                           "to run — derive seeds from the spec/config")


# ---------------------------------------------------------------------------
# fma-hazard: CUDA sources and their nvcc flags
# ---------------------------------------------------------------------------

Build = Tuple[Tuple[str, ...], Tuple[str, ...]]  # (sources, nvcc flags)

_C_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<cast>\b(?:static|reinterpret|const)_cast\s*<[^<>;]*>)
  | (?P<str>"(?:\\.|[^"\\\n])*"|'(?:\\.|[^'\\\n])*')
  | (?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?\w*)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op>->|\+\+|--|<<=|>>=|<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%&|^]=|::|\S)
""", re.X)
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)
# intrinsics that return a double: __dmul_rn, __ddiv_rn, __fma_rn, ...
_DOUBLE_INTRINSIC_RE = re.compile(r"^(?:__d\w+_r[nzud]|__fma_r[nzud])$")
_TYPE_WORDS = {
    "double", "float", "int", "unsigned", "signed", "long", "short", "char",
    "bool", "void", "const", "volatile", "size_t", "int8_t", "int16_t",
    "int32_t", "int64_t", "uint8_t", "uint16_t", "uint32_t", "uint64_t",
    "half", "__half", "__nv_bfloat16", "float2", "float4", "double2", "*",
}
_KEYWORDS = _TYPE_WORDS | {
    "return", "case", "else", "do", "sizeof", "if", "while", "for", "switch",
    "goto", "new", "delete", "throw", "__restrict__", "__restrict", "restrict",
    "__shared__", "__device__", "__global__", "__host__", "__forceinline__",
    "static", "inline", "constexpr", "extern", "template", "typename",
}
_INDEX_BUILTINS = {"threadIdx", "blockIdx", "blockDim", "gridDim"}
_QUALIFIERS = {"*", "&", "const", "volatile", "__restrict__", "__restrict",
               "restrict"}
# tokens that end a multiplicative term (besides a binary + or -, brackets
# and the start of the file)
_TERM_BOUNDARY = {
    ";", ",", "{", "}", "?", ":", "=", "+=", "-=", "*=", "/=", "%=", "&=",
    "|=", "^=", "<<=", ">>=", "<<", ">>", "<", ">", "<=", ">=", "==", "!=",
    "&&", "||", "|", "^", "return", "case", "#",
}
_OPEN, _CLOSE = {"(": ")", "[": "]", "{": "}"}, {")": "(", "]": "[", "}": "{"}


class _CTokens:
    """A CUDA source's comment-blanked text as tokens `(kind, text, line,
    col)` with its brackets matched."""

    def __init__(self, code: str):
        starts = [0] + [m.end() for m in re.finditer("\n", code)]
        self.toks: List[Tuple[str, str, int, int]] = []
        line = 0
        for m in _C_TOKEN_RE.finditer(code):
            kind = m.lastgroup
            if kind == "ws":
                continue
            while line + 1 < len(starts) and starts[line + 1] <= m.start():
                line += 1
            self.toks.append((kind, m.group(), line + 1, m.start() - starts[line]))
        self.match: Dict[int, int] = {}
        stack: List[int] = []
        for i, (_, t, _, _) in enumerate(self.toks):
            if t in _OPEN:
                stack.append(i)
            elif t in _CLOSE and stack and self.toks[stack[-1]][1] == _CLOSE[t]:
                j = stack.pop()
                self.match[i], self.match[j] = j, i

    def text(self, i: int) -> str:
        return self.toks[i][1] if 0 <= i < len(self.toks) else ""

    def is_cast_group(self, i: int) -> bool:
        """The `(` at `i` opens a C cast `(type)`."""
        j = self.match.get(i)
        inner = [t for _, t, _, _ in self.toks[i + 1:j]] if j else []
        return bool(inner) and all(t in _TYPE_WORDS for t in inner)

    def ends_operand(self, i: int) -> bool:
        kind, t = (self.toks[i][0], self.toks[i][1]) if i >= 0 else ("", "")
        if kind in ("num", "str"):
            return True
        if kind == "id":
            return t not in _KEYWORDS
        if t == "]":
            return True
        if t == ")":  # a cast's `)` is followed by its operand, ends none
            return i in self.match and not self.is_cast_group(self.match[i])
        return False

    def double_names(self) -> Set[str]:
        """Identifiers declared `double` (parameters, locals, members,
        functions returning one) and the double-valued intrinsics."""
        out = {t for k, t, _, _ in self.toks if k == "id" and _DOUBLE_INTRINSIC_RE.match(t)}
        n = len(self.toks)
        for i, (_, t, _, _) in enumerate(self.toks):
            if t != "double":
                continue
            j = i + 1
            while j < n:
                while j < n and self.text(j) in _QUALIFIERS:
                    j += 1
                if j >= n or self.toks[j][0] != "id" or self.text(j) in _TYPE_WORDS:
                    break
                out.add(self.text(j))
                k = j + 1
                if self.text(k) == "[" and k in self.match:
                    k = self.match[k] + 1
                if self.text(k) == "=":  # skip the initializer
                    depth = 0
                    while k < n and not (depth == 0 and self.text(k) in (",", ";")):
                        t2 = self.text(k)
                        depth += (t2 in _OPEN) - (t2 in _CLOSE)
                        if depth < 0:
                            break
                        k += 1
                if self.text(k) != ",":
                    break
                j = k + 1
                nxt = j
                while self.text(nxt) in _QUALIFIERS:
                    nxt += 1
                if self.text(nxt + 1) not in (",", ";", "=", "[", ")"):
                    break  # `, int b`: the next parameter has a type of its own
        return out

    def _is_binary_sign(self, i: int) -> bool:
        return self.text(i) in ("+", "-") and self.ends_operand(i - 1)

    def _term(self, i: int) -> Tuple[int, int]:
        """First and last token of the multiplicative term holding `i`:
        walk out at one bracket depth to a boundary, a binary sign or an
        unmatched bracket."""
        s = i
        while s > 0:
            j = s - 1
            t = self.text(j)
            if t in _CLOSE and j in self.match:
                s = self.match[j]
                continue
            if t in _TERM_BOUNDARY or t in _OPEN or self._is_binary_sign(j):
                break
            s = j
        e, n = i, len(self.toks)
        while e + 1 < n:
            j = e + 1
            t = self.text(j)
            if t in _OPEN and j in self.match:
                e = self.match[j]
                continue
            if t in _TERM_BOUNDARY or t in _CLOSE or self._is_binary_sign(j):
                break
            e = j
        return s, e

    def _group_has_double(self, i: int, doubles: Set[str]) -> bool:
        j = self.match.get(i, i)
        return any(t == "double" or (k == "id" and t in doubles)
                   for k, t, _, _ in self.toks[i + 1:j])

    def _term_is_double(self, s: int, e: int, doubles: Set[str]) -> bool:
        """A value of the term is double: an identifier declared double at
        its top level (not in a subscript or a call's arguments), a cast to
        double, or a parenthesised operand holding one. A cast to another
        type hides the operand it converts."""
        i, hide_next = s, False
        while i <= e:
            kind, t = self.toks[i][0], self.toks[i][1]
            if t == "(" and i in self.match:
                end = self.match[i]
                if self.is_cast_group(i):
                    if self._group_has_double(i, doubles):
                        return True
                    hide_next = True
                elif not self.ends_operand(i - 1) and not hide_next:
                    if self._group_has_double(i, doubles):
                        return True
                else:
                    hide_next = False
                i = end + 1
                continue
            if t == "[" and i in self.match:
                i = self.match[i] + 1
                continue
            if kind == "cast":
                if "double" in t:
                    return True
                hide_next = True
            elif t in _INDEX_BUILTINS and self.text(i + 1) == ".":
                i += 3  # `blockIdx.x`: an unsigned int, whatever `x` is elsewhere
                hide_next = False
                continue
            elif kind == "id" and t not in _KEYWORDS:
                if t in doubles and not hide_next:
                    return True
                hide_next = False
            i += 1
        return False

    def contracted_products(self) -> List[Tuple[int, int]]:
        """(line, col) of each term whose last operation is a product with
        a double operand and whose value an add or subtract takes: what
        nvcc contracts into an fma unless told not to."""
        doubles = self.double_names()
        out, seen = [], set()
        for i, (_, t, _, _) in enumerate(self.toks):
            if t != "*" or i in seen or not self.ends_operand(i - 1):
                continue
            s, e = self._term(i)
            last_op = None
            k = s
            while k <= e:  # the term's top-level multiplicative operators
                tk = self.text(k)
                if tk in _OPEN and k in self.match:
                    k = self.match[k] + 1
                    continue
                if tk in ("*", "/", "%") and self.ends_operand(k - 1):
                    last_op = tk
                    if tk == "*":
                        seen.add(k)
                k += 1
            if last_op != "*":
                continue
            left, right = self.text(s - 1), self.text(e + 1)
            feeds_sum = (right in ("+", "-") or left in ("+=", "-=")
                         or self._is_binary_sign(s - 1))
            if feeds_sum and self._term_is_double(s, e, doubles):
                out.append(self.toks[s][2:4])
        return out


def _fmad_off(flags: Sequence[str]) -> bool:
    """nvcc's multiply-add contraction is off under these flags (the last
    `--fmad=` wins; it is on by default)."""
    settings = [f.split("=", 1)[1] for f in flags if f.lstrip("-").startswith("fmad=")]
    return bool(settings) and settings[-1] == "false"


def _literal_strings(node: Optional[ast.AST],
                     consts: Dict[str, ast.AST]) -> Optional[Tuple[str, ...]]:
    """A tuple or list of string literals, or a module-level name bound to
    one, as a tuple; None where it is anything else."""
    if isinstance(node, ast.Name):
        node = consts.get(node.id)
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    if not all(isinstance(e, ast.Constant) and isinstance(e.value, str)
               for e in node.elts):
        return None
    return tuple(e.value for e in node.elts)


def _module_consts(tree: ast.Module) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value
    return out


def _call_arg(node: ast.Call, pos: int, kw: str) -> Optional[ast.AST]:
    for k in node.keywords:
        if k.arg == kw:
            return k.value
    return node.args[pos] if len(node.args) > pos else None


def _read_builds(project: Project):
    """Every `load_library(name, [sources], extra_flags=X)` call in engine
    source, with the build module's `NVCC_FLAGS` before X, as `{name:
    (sources, flags)}`, and the calls that cannot be read as `{rel: [(line,
    col, message)]}`. Memoised on the project."""
    if "cuda_builds" in project.memo:
        return project.memo["cuda_builds"]
    src = [ctx for ctx in project.contexts if not ctx.is_cuda
           and project.is_src(ctx.rel) and not project.is_test(ctx.rel)]
    base: Tuple[str, ...] = ()
    for ctx in src:
        if any(isinstance(n, ast.FunctionDef) and n.name == "load_library"
               for n in ast.iter_child_nodes(ctx.tree)):
            base = _literal_strings(_module_consts(ctx.tree).get("NVCC_FLAGS"), {}) or ()
            break
    builds: Dict[str, Build] = {}
    problems: Dict[str, List[Tuple[int, int, str]]] = {}
    for ctx in src:
        consts = None
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and (dotted_name(node.func) or "").split(".")[-1] == "load_library"):
                continue
            consts = _module_consts(ctx.tree) if consts is None else consts
            name = _call_arg(node, 0, "name")
            sources = _literal_strings(_call_arg(node, 1, "sources"), consts)
            flags_node = _call_arg(node, 2, "extra_flags")
            flags = () if flags_node is None else _literal_strings(flags_node, consts)
            if not (isinstance(name, ast.Constant) and isinstance(name.value, str)) \
                    or sources is None or flags is None:
                problems.setdefault(ctx.rel, []).append((
                    node.lineno, node.col_offset,
                    "load_library call whose name, sources or extra_flags are "
                    "not literals (or a module-level name bound to one) — the "
                    "rule cannot read what nvcc is given"))
                continue
            builds[name.value] = (sources, base + flags)
    project.memo["cuda_builds"] = builds, problems
    return builds, problems


def cuda_builds(project: Project) -> Dict[str, Build]:
    """The rule's reading of the CUDA builds: `{library: (sources, the full
    nvcc flag list)}` from the `load_library` calls in engine source. The
    chip script holds it against `kernels.build.loaded_builds()`, the flags
    nvcc really got."""
    return dict(_read_builds(project)[0])


def _libraries_building(ctx: FileContext, project: Project) -> List[str]:
    """The libraries whose sources are `ctx` or `#include` it (through
    other headers too)."""
    if "cuda_includes" not in project.memo:
        project.memo["cuda_includes"] = {
            Path(c.rel).name: set(_INCLUDE_RE.findall(c.code))
            for c in project.contexts if c.is_cuda}
    includes = project.memo["cuda_includes"]
    me = Path(ctx.rel).name
    out = []
    for name, (sources, _) in sorted(_read_builds(project)[0].items()):
        reach, todo = set(), list(sources)
        while todo:
            f = todo.pop()
            if f not in reach:
                reach.add(f)
                todo.extend(includes.get(Path(f).name, ()))
        if me in {Path(f).name for f in reach}:
            out.append(name)
    return out


# ---------------------------------------------------------------------------
# fma-hazard
# ---------------------------------------------------------------------------

class FmaHazard(Rule):
    """Multiply-add contraction defence (the port's bit-exact fp64 engine
    kernels against their numpy twins).

    A compiler that contracts `a*b + c` into one fma rounds once where the
    numpy twin rounds twice: one ulp off, and every bit-exact check fails.

    * CUDA. nvcc contracts by default. The rule reads each `load_library`
      call in engine source (name, sources, `extra_flags` as a literal or a
      module-level name bound to one, after the build module's
      `NVCC_FLAGS`); a `.cuh` belongs to each library whose sources
      `#include` it. In a source that some library builds without
      `--fmad=false` it flags each `x * y +- z` (or `z +- x * y`, `z += x *
      y`) in which an operand is declared `double` (parameters, locals,
      members, casts). `__dadd_rn(__dmul_rn(x, y), z)` has no `*` and
      passes; integer index arithmetic and `float` products pass. A source
      that no `load_library` call builds is a finding of its own.
    * Python. A product feeding an add/sub inside a function decorated
      with, or passed to, `torch.compile`, `torch.jit.script`/`trace` or
      `triton.jit`: the port's compilers that contract. And in the
      bit-exact modules (`BIT_EXACT`), any call of a fused-rounding op
      (`addcmul`, `addcdiv`, `lerp`, `baddbmm`, `addbmm`, `addmm`, `addmv`,
      `fma`, as functions, methods or in place). The models and the
      f32/bf16 kernels are held at a tolerance and are not checked.
    """

    id = "fma-hazard"
    description = ("double `a*b + c` in CUDA built without --fmad=false, "
                   "products feeding adds under torch.compile/jit/"
                   "triton.jit, and fused-rounding ops in bit-exact modules")
    reads_cuda = True

    COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                 "triton.jit"}
    FUSED_OPS = {"addcmul", "addcdiv", "lerp", "baddbmm", "addbmm", "addmm",
                 "addmv", "fma"}
    # modules below the source prefix whose arithmetic is bit for bit the
    # numpy twins'
    BIT_EXACT = ("core/", "cluster/", "scenarios/", "serving/", "obs/",
                 "kernels/tent_core/", "kernels/spray_sim/", "kernels/kv_pack/")

    def check_file(self, ctx: FileContext, project: Project):
        if not project.is_src(ctx.rel) or project.is_test(ctx.rel):
            return
        if ctx.is_cuda:
            yield from self._check_cuda(ctx, project)
            return
        yield from _read_builds(project)[1].get(ctx.rel, ())
        aliases = _aliases(ctx, project)
        yield from self._check_compiled(ctx, aliases)
        if project.src_rel(ctx.rel).startswith(self.BIT_EXACT):
            yield from self._check_fused(ctx, aliases)

    def _check_cuda(self, ctx: FileContext, project: Project):
        builds = _read_builds(project)[0]
        libs = _libraries_building(ctx, project)
        if not libs:
            yield (1, 0, "CUDA source that no load_library call builds — "
                         "the rule cannot tell what flags nvcc gives it")
            return
        contracting = [n for n in libs if not _fmad_off(builds[n][1])]
        if not contracting:
            return
        for line, col in _CTokens(ctx.code).contracted_products():
            yield (line, col,
                   f"double product feeding an add/sub in a source that "
                   f"{', '.join(f'`{n}`' for n in contracting)} builds "
                   "without --fmad=false — nvcc contracts it into an fma; "
                   "build with --fmad=false or write "
                   "__dadd_rn(__dmul_rn(x, y), z)")

    def _check_compiled(self, ctx: FileContext, aliases):
        compiled: List[ast.AST] = []
        # defs by name per enclosing scope, to resolve `torch.compile(fn)`
        for scope in ast.walk(ctx.tree):
            if not isinstance(scope, (ast.Module, ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            local_defs = {n.name: n for n in ast.iter_child_nodes(scope)
                          if isinstance(n, ast.FunctionDef)}
            for node in ast.walk(scope):
                if not (isinstance(node, ast.Call)
                        and _resolve(node.func, aliases) in self.COMPILERS):
                    continue
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Name) and arg.id in local_defs:
                        compiled.append(local_defs[arg.id])
                    elif isinstance(arg, ast.Lambda):
                        compiled.append(arg)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.FunctionDef) and self._is_compiled(node, aliases):
                compiled.append(node)

        seen: Set[int] = set()
        for body in compiled:
            for expr in ast.walk(body):
                if id(expr) in seen:
                    continue
                seen.add(id(expr))
                if (isinstance(expr, ast.BinOp)
                        and isinstance(expr.op, (ast.Add, ast.Sub))):
                    for side in (expr.left, expr.right):
                        if (isinstance(side, ast.BinOp)
                                and isinstance(side.op, ast.Mult)
                                and not self._integer_product(side)):
                            yield (side.lineno, side.col_offset,
                                   "product feeding an add/sub inside a "
                                   "torch.compile/jit/triton.jit body "
                                   "invites fma contraction — keep bit-exact "
                                   "arithmetic out of compiled bodies")

    def _is_compiled(self, node: ast.FunctionDef, aliases) -> bool:
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = _resolve(target, aliases) or ""
            if name in self.COMPILERS:
                return True
            if (isinstance(dec, ast.Call) and name.endswith("partial")
                    and dec.args
                    and _resolve(dec.args[0], aliases) in self.COMPILERS):
                return True
        return False

    def _check_fused(self, ctx: FileContext, aliases):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                op = node.func.attr
            else:
                op = (_resolve(node.func, aliases) or "").partition("torch.")[2]
            if op.rstrip("_") in self.FUSED_OPS:
                yield (node.lineno, node.col_offset,
                       f"fused-rounding `{op}` in a bit-exact module rounds "
                       "once where the numpy twin rounds twice — write the "
                       "product and the sum as two ops")

    @staticmethod
    def _integer_product(node: ast.BinOp) -> bool:
        return all(isinstance(s, ast.Constant) and isinstance(s.value, int)
                   for s in (node.left, node.right))


# ---------------------------------------------------------------------------
# unordered-iteration
# ---------------------------------------------------------------------------

class UnorderedIteration(Rule):
    """Ordering-stable iteration (the byte-identical `ScenarioReport` pins
    across the wave/jit/calendar toggles).

    Python `set` iteration order depends on element hashes — for strings,
    on PYTHONHASHSEED — so a set iterated into scheduling or report
    building makes whole runs irreproducible. (`dict` is *not* flagged:
    CPython dict iteration is insertion-ordered and deterministic, which
    the engine exploits deliberately.) The rule flags iteration contexts —
    for/comprehensions and order-materializing calls (`list`, `tuple`,
    `enumerate`, `iter`) — whose iterable is syntactically a set: a set
    literal/comprehension, `set(...)`/`frozenset(...)`, a set-operator
    expression, or a local name only ever assigned such values. Wrapping
    in `sorted(...)` (or reducing with min/max/sum/len/any/all) is the
    fix, and passes automatically because the iterable is then the
    `sorted` call, not the set.
    """

    id = "unordered-iter"
    description = ("iterating a set in engine source — hash order is not "
                   "deterministic; wrap in sorted(...) or use a "
                   "list/dict")

    MATERIALIZERS = {"list", "tuple", "enumerate", "iter"}

    def check_file(self, ctx: FileContext, project: Project):
        if not project.is_src(ctx.rel) or project.is_test(ctx.rel):
            return
        for scope in ast.walk(ctx.tree):
            if not isinstance(scope, (ast.Module, ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            set_locals = self._set_locals(scope)
            for node in ast.iter_child_nodes(scope):
                yield from self._check_scope_body(node, set_locals)

    def _check_scope_body(self, node: ast.AST, set_locals: Set[str]):
        """Walk one scope without descending into nested function scopes
        (they get their own `set_locals`)."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        iterables: List[ast.AST] = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iterables.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iterables.extend(g.iter for g in node.generators)
        elif isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname in self.MATERIALIZERS and node.args:
                iterables.append(node.args[0])
        for it in iterables:
            if self._is_set_expr(it, set_locals):
                yield (it.lineno, it.col_offset,
                       "iteration over a set — order follows element "
                       "hashes (PYTHONHASHSEED-dependent for strings); "
                       "wrap in sorted(...) to pin it")
        for child in ast.iter_child_nodes(node):
            yield from self._check_scope_body(child, set_locals)

    def _set_locals(self, scope: ast.AST) -> Set[str]:
        """Local names assigned *only* syntactic-set values in this scope."""
        assigned: Dict[str, List[bool]] = {}
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            else:
                continue
            value = getattr(node, "value", None)
            if value is None:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    assigned.setdefault(t.id, []).append(
                        self._is_set_expr(value, set()))
        return {name for name, kinds in assigned.items() if all(kinds)}

    def _is_set_expr(self, node: ast.AST, set_locals: Set[str]) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname in ("set", "frozenset"):
                return True
            # s.union(t) / s.intersection(t) / ... on a syntactic set
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "union", "intersection", "difference",
                    "symmetric_difference", "copy"):
                return self._is_set_expr(node.func.value, set_locals)
            return False
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor, ast.Sub)):
            return (self._is_set_expr(node.left, set_locals)
                    or self._is_set_expr(node.right, set_locals))
        if isinstance(node, ast.Name):
            return node.id in set_locals
        return False


# ---------------------------------------------------------------------------
# hot-path-alloc
# ---------------------------------------------------------------------------

class HotPathAlloc(Rule):
    """The allocation discipline as a decorator-driven contract.

    Functions tagged `@hot_path` (repro_torch.analysis.hotpath) run once
    per slice/completion/tick; the engine's speed came from removing
    per-item closures, `functools.partial` wrappers, and comprehension
    churn from exactly these bodies. The rule keeps them out: inside a
    tagged function it flags lambdas/nested defs and comprehensions
    *inside loops* (per-iteration allocation), and any `functools.partial`
    call (a per-op closure). One-time setup allocations before the loop
    are fine and not flagged.
    """

    id = "hot-path-alloc"
    description = ("per-iteration closures/comprehensions or "
                   "functools.partial inside an @hot_path body")

    def check_file(self, ctx: FileContext, project: Project):
        aliases = _aliases(ctx, project)
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and self._tagged(node):
                yield from self._check_body(node, aliases, loop_depth=0,
                                            root=True)

    @staticmethod
    def _tagged(node: ast.AST) -> bool:
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = dotted_name(target) or ""
            if name == "hot_path" or name.endswith(".hot_path"):
                return True
        return False

    def _check_body(self, node: ast.AST, aliases, loop_depth: int,
                    root: bool = False):
        in_loop = loop_depth > 0
        if not root:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                if in_loop:
                    kind = "lambda" if isinstance(node, ast.Lambda) \
                        else f"nested def `{node.name}`"
                    yield (node.lineno, node.col_offset,
                           f"{kind} created inside a loop on a @hot_path "
                           "body — one closure per iteration; hoist it or "
                           "use a shared tagged callback")
                return  # nested scopes are their own (untagged) world
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)) and in_loop:
                yield (node.lineno, node.col_offset,
                       "comprehension inside a loop on a @hot_path body — "
                       "per-iteration list churn; hoist or write into a "
                       "preallocated buffer")
                return
            if isinstance(node, ast.Call):
                name = _resolve(node.func, aliases) or ""
                if name == "partial" or name.endswith("functools.partial"):
                    yield (node.lineno, node.col_offset,
                           "functools.partial on a @hot_path body — "
                           "allocates a wrapper per call; use a shared "
                           "tagged callback instead")
        next_depth = loop_depth + (1 if isinstance(
            node, (ast.For, ast.AsyncFor, ast.While)) else 0)
        for child in ast.iter_child_nodes(node):
            yield from self._check_body(child, aliases, next_depth)


# ---------------------------------------------------------------------------
# twin-drift
# ---------------------------------------------------------------------------

Defs = Dict[str, Tuple[ast.FunctionDef, str]]


class TwinDrift(Rule):
    """Kernel-twin discipline (the parity contract behind every `*_torch`
    program and every kernel's plain version).

    Every public module-level `*_torch` function in engine source, and
    every entry named in a module's `__torch_twins__`, must have a twin
    with the same parameter names and a parity test referencing both, or
    the pair silently drifts apart the first time one side changes:

        __torch_twins__ = {
            "x_torch": "x",                             # def in engine source
            "y_torch": "SomeClass.method",              # method twin
            "kernel": kernel_ref,                       # a name bound to a def
            "z": (z_ref, "why the signatures differ"),  # waiver, with reason
        }

    A string names a def anywhere in engine source; a name is looked up
    through the registry module's own defs and imports. A key must be a
    def in the registry's module or its package (the modules beside it).
    Unregistered `*_torch` functions default to the strip-`_torch`
    convention. The rule checks (1) the key's def and the twin exist, (2)
    parameter names match exactly (ignoring a leading `self`) unless the
    entry is a waiver, whose reason must not be empty, and (3) at least
    one test file mentions both the key and its twin.
    """

    id = "twin-drift"
    description = ("*_torch function or __torch_twins__ entry without a "
                   "twin, with a drifted signature, or without a parity "
                   "test referencing both")

    REGISTRY = "__torch_twins__"

    def finalize(self, project: Project):
        src = [ctx for ctx in project.contexts if not ctx.is_cuda
               and project.is_src(ctx.rel) and not project.is_test(ctx.rel)]
        by_rel = {ctx.rel: ctx for ctx in src}
        defs: Defs = {}
        for ctx in src:
            for name, node in self._module_defs(ctx).items():
                defs.setdefault(name, (node, ctx.rel))
        test_texts = [ctx.text for ctx in project.contexts
                      if not ctx.is_cuda and project.is_test(ctx.rel)]
        for ctx in src:
            registry, problems = self._registry(ctx)
            for line, col, message in problems:
                yield ctx.rel, line, col, message
            own = self._module_defs(ctx)
            kernels = [n for n in own if n.endswith("_torch")
                       and not n.startswith("_") and "." not in n]
            kernels += [k for k in registry if k not in kernels]
            for name in kernels:
                yield from self._check_kernel(ctx, name, registry.get(name),
                                              own, by_rel, defs, test_texts)

    def _check_kernel(self, ctx, name, entry, own, by_rel, defs, test_texts):
        kernel = own.get(name)
        where = kernel.lineno if kernel is not None else entry[0]
        col = kernel.col_offset if kernel is not None else 0
        if kernel is None:
            kernel = self._in_package(ctx, name, by_rel)
            if kernel is None:
                yield (ctx.rel, where, col,
                       f"`{name}` is keyed in {self.REGISTRY} but is no def "
                       f"in {ctx.rel} or its package — key the registry by "
                       "the entry point's own name")
                return
        if entry is None:
            written, waiver = name[:-len("_torch")], None
            twin = defs.get(written)
        else:
            _, value, waiver = entry
            written = value if isinstance(value, str) else value.id
            twin = (defs.get(value) if isinstance(value, str)
                    else self._resolve_name(ctx, value.id, by_rel))
        if twin is None:
            yield (ctx.rel, where, col,
                   f"`{name}` has no twin: `{written}` resolves to no def in "
                   "engine source — add the twin or register the real one "
                   f"in {self.REGISTRY}")
            return
        twin_node, twin_rel = twin
        if waiver is None:
            params = self._params(kernel)
            twin_params = self._params(twin_node, drop_self=True)
            if params != twin_params:
                yield (ctx.rel, where, col,
                       f"`{name}` signature drifted from twin `{written}` "
                       f"({twin_rel}): {params} != {twin_params} — fix the "
                       "drift or register a (twin, reason) waiver in "
                       f"{self.REGISTRY}")
        elif not waiver.strip():
            yield (ctx.rel, where, col,
                   f"`{name}`'s waiver carries no reason — say why the "
                   "signatures differ")
        terminals = (written.rsplit(".", 1)[-1], twin_node.name)
        if not any(name in text and any(t in text for t in terminals)
                   for text in test_texts):
            yield (ctx.rel, where, col,
                   f"no parity test references both `{name}` and its twin "
                   f"`{written.rsplit('.', 1)[-1]}` — add one to the test tier")

    @staticmethod
    def _module_defs(ctx: FileContext) -> Dict[str, ast.FunctionDef]:
        """`name` / `Class.method` -> def at a module's top level."""
        out: Dict[str, ast.FunctionDef] = {}
        for node in ast.iter_child_nodes(ctx.tree):
            if isinstance(node, ast.FunctionDef):
                out.setdefault(node.name, node)
            elif isinstance(node, ast.ClassDef):
                for sub in ast.iter_child_nodes(node):
                    if isinstance(sub, ast.FunctionDef):
                        out.setdefault(f"{node.name}.{sub.name}", sub)
        return out

    def _in_package(self, ctx, name, by_rel) -> Optional[ast.FunctionDef]:
        package = PurePosixPath(ctx.rel).parent
        for rel in sorted(by_rel):
            if rel != ctx.rel and PurePosixPath(rel).parent == package:
                node = self._module_defs(by_rel[rel]).get(name)
                if node is not None:
                    return node
        return None

    def _resolve_name(self, ctx, name, by_rel, depth=0):
        """The def a module-level name is bound to: a def of the module, or
        followed through a relative `from ... import` into the module it
        names."""
        node = self._module_defs(ctx).get(name)
        if node is not None:
            return node, ctx.rel
        if depth > 8:
            return None
        for imp in ast.iter_child_nodes(ctx.tree):
            if not isinstance(imp, ast.ImportFrom):
                continue
            for alias in imp.names:
                if (alias.asname or alias.name) != name:
                    continue
                target = self._module_ctx(ctx, imp, by_rel)
                if target is not None:
                    return self._resolve_name(target, alias.name, by_rel,
                                              depth + 1)
        return None

    @staticmethod
    def _module_ctx(ctx, imp: ast.ImportFrom, by_rel):
        """The module a relative `from ... import` names, if scanned."""
        if not imp.level:
            return None
        base = PurePosixPath(ctx.rel).parent
        for _ in range(imp.level - 1):
            base = base.parent
        stem = base.joinpath(*(imp.module or "").split(".")).as_posix() \
            if imp.module else base.as_posix()
        return next((by_rel[c] for c in (f"{stem}.py", f"{stem}/__init__.py")
                     if c in by_rel), None)

    @staticmethod
    def _params(node: ast.FunctionDef, drop_self: bool = False) -> Tuple:
        args = node.args
        names = [a.arg for a in args.posonlyargs + args.args
                 + args.kwonlyargs]
        if drop_self and names and names[0] in ("self", "cls"):
            names = names[1:]
        return tuple(names)

    def _registry(self, ctx: FileContext):
        """The module's `__torch_twins__` as `{key: (line, value, waiver)}`
        (value a string or an `ast.Name`, waiver the reason or None) and
        the entries it cannot read as findings."""
        out: Dict[str, tuple] = {}
        problems: List[Tuple[int, int, str]] = []
        for node in ast.iter_child_nodes(ctx.tree):
            if not (isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == self.REGISTRY
                    for t in node.targets)):
                continue
            if not isinstance(node.value, ast.Dict):
                problems.append((node.lineno, node.col_offset,
                                 f"{self.REGISTRY} is not a dict literal"))
                continue
            for key, value in zip(node.value.keys, node.value.values):
                waiver = None
                if isinstance(value, (ast.List, ast.Tuple)) and 1 <= len(value.elts) <= 2:
                    reason = value.elts[1] if len(value.elts) == 2 else None
                    waiver = reason.value if (isinstance(reason, ast.Constant)
                                              and isinstance(reason.value, str)) else ""
                    value = value.elts[0]
                if isinstance(value, ast.Constant) and isinstance(value.value, str):
                    value = value.value
                if not (isinstance(key, ast.Constant) and isinstance(key.value, str)) \
                        or not isinstance(value, (str, ast.Name)):
                    where = key if key is not None else node
                    problems.append((where.lineno, where.col_offset,
                                     f"{self.REGISTRY} entry is not a string key "
                                     "to a string, a name or a (twin, reason) pair"))
                    continue
                out[key.value] = (key.lineno, value, waiver)
        return out, problems


ALL_RULES: Sequence[Rule] = (
    NoWallClock(),
    NoGlobalRng(),
    FmaHazard(),
    UnorderedIteration(),
    HotPathAlloc(),
    TwinDrift(),
)

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}


def default_rules(only: Optional[Iterable[str]] = None) -> List[Rule]:
    if only is None:
        return list(ALL_RULES)
    unknown = set(only) - set(RULES_BY_ID)
    if unknown:
        raise ValueError(
            f"unknown rule id(s) {sorted(unknown)}; "
            f"have {sorted(RULES_BY_ID)}")
    return [RULES_BY_ID[r] for r in only]
