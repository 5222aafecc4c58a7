"""LiLAC: the paper's specification language (Fig. 3 grammar + §3.3).

Counterpart of ``repro.core.what_lang``, the same grammar and builtin spec
texts with the port's vocabulary: platforms are ``cpu`` and ``cuda``
(``tpu`` in the JAX package) and the builtin plain backends are named
``torch.*`` (``jnp.*`` there).

    spec    ::= { <computation> | <harness> }
    computation ::= COMPUTATION <name> <body>
    body    ::= <forall> | <stmt>
    range   ::= ( <exp> <= <name> < <exp> )
    forall  ::= forall <range> { <body> }
    stmt    ::= <addr> = sum <range> <exp> ;
    addr    ::= <name> { [ <exp> ] }
    exp     ::= <name> | <cnst> | <addr> | <exp> + <exp> | <exp> * <exp>

    harness ::= HARNESS <name> implements <namelist> { <clause> }
    clause  ::= platforms <namelist> ;
              | formats <namelist> ;
              | default_for <namelist> ;
              | host_only ;
              | marshal <name> = <name> ( <keylist> )
                    [ from <name> ] [ to <name> ] ;
              | persistent <namelist> ;
              | BeforeFirstExecution <name> ;
              | AfterLastExecution <name> ;
              | tune <name> in { <valuelist> } ;
              | constraint <exp> ( <= | < ) <exp> ;
              | fuse epilogue ;
              | vjp <name> ( <namelist> ) ;
    namelist ::= <name> { , <name> }
    keylist ::= <key> { , <key> }
    key     ::= <name> { | <name> }          -- alternatives, first present wins
    valuelist ::= <value> { , <value> }
    value   ::= <num> | <name>               -- numbers or symbolic values

A *spec* is the paper's one-off LiLAC description: the What-clause (the
COMPUTATION programs) and the How-clause (the HARNESS blocks of §3.3).
This module provides a tokenizer with source positions, a recursive-descent
parser producing the ASTs below, and the builtin spec texts.  The detection
pass (``repro_torch.core.detect``) *generates* FX-graph matchers from the
What-ASTs; ``repro_torch.core.spec`` *compiles* the How-descriptors into
executable ``Harness`` objects.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# AST — What (computation)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Const:
    value: float

    def __str__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Var:
    name: str

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Load:
    """array[index] — possibly nested, e.g. a[rowstr[i]+j]."""
    array: str
    index: "Expr"

    def __str__(self):
        return f"{self.array}[{self.index}]"


@dataclasses.dataclass(frozen=True)
class Add:
    lhs: "Expr"
    rhs: "Expr"

    def __str__(self):
        return f"({self.lhs} + {self.rhs})"


@dataclasses.dataclass(frozen=True)
class Mul:
    lhs: "Expr"
    rhs: "Expr"

    def __str__(self):
        return f"({self.lhs} * {self.rhs})"


Expr = Union[Const, Var, Load, Add, Mul]


@dataclasses.dataclass(frozen=True)
class Range:
    lo: Expr
    var: str
    hi: Expr

    def __str__(self):
        return f"({self.lo} <= {self.var} < {self.hi})"


@dataclasses.dataclass(frozen=True)
class SumStore:
    """target = sum(range) expr;   target is Var (scalar) or Load (addr)."""
    target: Union[Var, Load]
    range: Range
    expr: Expr

    def __str__(self):
        return f"{self.target} = sum{self.range} {self.expr};"


@dataclasses.dataclass(frozen=True)
class ForAll:
    range: Range
    body: "Body"

    def __str__(self):
        return f"forall{self.range} {{ {self.body} }}"


Body = Union[ForAll, SumStore]


@dataclasses.dataclass(frozen=True)
class Computation:
    name: str
    body: Body

    def __str__(self):
        return f"COMPUTATION {self.name}\n{self.body}"

    # -- structural helpers used by the matcher generator ------------------

    def foralls(self) -> List[ForAll]:
        out, b = [], self.body
        while isinstance(b, ForAll):
            out.append(b)
            b = b.body
        return out

    def stmt(self) -> SumStore:
        b = self.body
        while isinstance(b, ForAll):
            b = b.body
        assert isinstance(b, SumStore)
        return b

    def free_arrays(self) -> List[str]:
        """Array names loaded/stored — the harness interface (paper §3.1:
        'it identifies the variables that are arguments to the library')."""
        seen: List[str] = []

        def walk_e(e: Expr):
            if isinstance(e, Load):
                if e.array not in seen:
                    seen.append(e.array)
                walk_e(e.index)
            elif isinstance(e, (Add, Mul)):
                walk_e(e.lhs)
                walk_e(e.rhs)

        def walk_b(b: Body):
            if isinstance(b, ForAll):
                walk_e(b.range.lo)
                walk_e(b.range.hi)
                walk_b(b.body)
            else:
                if isinstance(b.target, Load):
                    if b.target.array not in seen:
                        seen.append(b.target.array)
                    walk_e(b.target.index)
                walk_e(b.range.lo)
                walk_e(b.range.hi)
                walk_e(b.expr)

        walk_b(self.body)
        return seen

    def free_scalars(self) -> List[str]:
        """Loop-bound names that are not loop iterators and not arrays."""
        iters = {f.range.var for f in self.foralls()} | {self.stmt().range.var}
        arrays = set(self.free_arrays())
        seen: List[str] = []

        def walk_e(e: Expr):
            if isinstance(e, Var) and e.name not in iters \
                    and e.name not in arrays and e.name not in seen:
                seen.append(e.name)
            elif isinstance(e, Load):
                walk_e(e.index)
            elif isinstance(e, (Add, Mul)):
                walk_e(e.lhs)
                walk_e(e.rhs)

        def walk_b(b: Body):
            if isinstance(b, ForAll):
                walk_e(b.range.lo)
                walk_e(b.range.hi)
                walk_b(b.body)
            else:
                if isinstance(b.target, Load):
                    walk_e(b.target.index)
                walk_e(b.range.lo)
                walk_e(b.range.hi)
                walk_e(b.expr)

        walk_b(self.body)
        return seen


# ---------------------------------------------------------------------------
# AST — How (harness descriptors, paper §3.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MarshalClause:
    """``marshal <name> = <repack>(<keys>) [from <src>] [to <dst>]``: the
    named input is produced by the registered repack function, memoized in
    the marshaling cache on the fingerprints of the key arrays (the
    mprotect analogue).  Each key may list ``|``-separated alternatives;
    the first present in the binding is used (e.g. ``rowstr|rowidx``
    covers CSR and COO matches).

    ``from``/``to`` declare the repack's source loader and target format
    (names in the data plane's SOURCES / FORMATS registries).  With both
    present the conversion graph plans the repack as a *path* — sharing
    cached intermediates with other harnesses — and the repack function
    itself becomes the fallback when no path exists."""
    name: str
    repack: str
    keys: Tuple[Tuple[str, ...], ...]
    src: Optional[str] = None
    dst: Optional[str] = None

    def __str__(self):
        ks = ", ".join("|".join(alts) for alts in self.keys)
        tail = ""
        if self.src is not None:
            tail += f" from {self.src}"
        if self.dst is not None:
            tail += f" to {self.dst}"
        return f"marshal {self.name} = {self.repack}({ks}){tail};"


@dataclasses.dataclass(frozen=True)
class TuneClause:
    """``tune <param> in {v1, v2, ...}``: a declared schedule parameter.

    The first value is the *default schedule*'s value — HARNESS blocks list
    the previously hard-coded constant first so an untuned call is
    bit-identical to the pre-tuning kernel.  Values are ints, floats or
    bare names (symbolic values)."""
    name: str
    values: Tuple[Any, ...]

    def __str__(self):
        vals = ", ".join(str(v) for v in self.values)
        return f"tune {self.name} in {{{vals}}};"


@dataclasses.dataclass(frozen=True)
class Constraint:
    """``constraint <exp> (<=|<) <exp>``: prunes the schedule cross-product.

    Expressions use the What-language grammar over tune-parameter names and
    constants (e.g. ``block_m * block_k <= 16384`` bounds a block's shared
    memory working set); variants violating any constraint are never materialized."""
    lhs: Expr
    op: str          # '<=' | '<'
    rhs: Expr

    def __str__(self):
        return f"constraint {self.lhs} {self.op} {self.rhs};"

    def holds(self, env: Dict[str, Any]) -> bool:
        lhs = _eval_expr(self.lhs, env)
        rhs = _eval_expr(self.rhs, env)
        return lhs <= rhs if self.op == "<=" else lhs < rhs

    def params(self) -> Tuple[str, ...]:
        """Names referenced by either side (must all be tune params)."""
        out: List[str] = []

        def walk(e: Expr):
            if isinstance(e, Var):
                if e.name not in out:
                    out.append(e.name)
            elif isinstance(e, Load):
                walk(e.index)
            elif isinstance(e, (Add, Mul)):
                walk(e.lhs)
                walk(e.rhs)

        walk(self.lhs)
        walk(self.rhs)
        return tuple(out)


def _eval_expr(e: Expr, env: Dict[str, Any]):
    """Evaluate a constraint expression over concrete parameter values.
    Referencing a non-numeric (symbolic) tune value raises TypeError,
    which surfaces as a registration-time SpecError for the whole harness
    (constraints are arithmetic; symbolic params can't be bounded)."""
    if isinstance(e, Const):
        return e.value
    if isinstance(e, Var):
        v = env[e.name]
        if not isinstance(v, (int, float)):
            raise TypeError(f"constraint references non-numeric value "
                            f"{e.name}={v!r}")
        return v
    if isinstance(e, Add):
        return _eval_expr(e.lhs, env) + _eval_expr(e.rhs, env)
    if isinstance(e, Mul):
        return _eval_expr(e.lhs, env) * _eval_expr(e.rhs, env)
    raise TypeError(f"unsupported constraint expression {e!r}")


@dataclasses.dataclass(frozen=True)
class VjpClause:
    """``vjp <name>(<wrt>)``: the harness is differentiable with the
    registered backward body ``name`` (``spec.vjp``), with respect to the
    listed binding keys: the rewriter runs the call inside one
    ``torch.autograd.Function`` whose backward is that body."""
    name: str
    wrt: Tuple[str, ...]

    def __str__(self):
        return f"vjp {self.name}({', '.join(self.wrt)});"


_DEFAULT_PLATFORMS = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class HarnessDecl:
    """One HARNESS block: how a named backend implements What-computations."""
    name: str
    implements: Tuple[str, ...]
    platforms: Tuple[str, ...] = _DEFAULT_PLATFORMS
    formats: Tuple[str, ...] = ()
    jit_safe: bool = True                    # host_only; sets this False
    default_for: Tuple[str, ...] = ()
    marshal: Tuple[MarshalClause, ...] = ()
    persistent: Tuple[str, ...] = ()
    before_first: Optional[str] = None       # BeforeFirstExecution hook name
    after_last: Optional[str] = None         # AfterLastExecution hook name
    tune: Tuple[TuneClause, ...] = ()        # declared schedule parameters
    constraints: Tuple[Constraint, ...] = ()  # schedule-space pruning
    fuse_epilogue: bool = False              # body applies detected epilogues
    vjp: Optional[VjpClause] = None          # declared custom backward body

    def __str__(self):
        lines = [f"HARNESS {self.name} implements {', '.join(self.implements)}"]
        if self.platforms != _DEFAULT_PLATFORMS:
            lines.append(f"  platforms {', '.join(self.platforms)};")
        if self.formats:
            lines.append(f"  formats {', '.join(self.formats)};")
        if not self.jit_safe:
            lines.append("  host_only;")
        if self.default_for:
            lines.append(f"  default_for {', '.join(self.default_for)};")
        lines.extend(f"  {m}" for m in self.marshal)
        if self.persistent:
            lines.append(f"  persistent {', '.join(self.persistent)};")
        if self.before_first is not None:
            lines.append(f"  BeforeFirstExecution {self.before_first};")
        if self.after_last is not None:
            lines.append(f"  AfterLastExecution {self.after_last};")
        lines.extend(f"  {t}" for t in self.tune)
        lines.extend(f"  {c}" for c in self.constraints)
        if self.fuse_epilogue:
            lines.append("  fuse epilogue;")
        if self.vjp is not None:
            lines.append(f"  {self.vjp}")
        return "\n".join(lines)

    def default_schedule(self) -> Dict[str, Any]:
        """First declared value of every tune param — the pre-tuning
        constants, so an unswept call reproduces the fixed-constant kernel."""
        return {t.name: t.values[0] for t in self.tune}

    def schedules(self) -> Tuple[Dict[str, Any], ...]:
        """The declared schedule-variant family (see
        :func:`enumerate_schedules`); empty for untuned harnesses."""
        return enumerate_schedules(self.tune, self.constraints)


def enumerate_schedules(tune: Tuple[TuneClause, ...],
                        constraints: Tuple[Constraint, ...] = (),
                        ) -> Tuple[Dict[str, Any], ...]:
    """Cross-product of the declared tune values, filtered by constraints.

    The first variant is the default schedule (every param at its first
    declared value) when it satisfies the constraints; declared order is
    otherwise preserved so budget truncation keeps near-default variants.
    """
    if not tune:
        return ()
    import itertools

    names = [t.name for t in tune]
    out: List[Dict[str, Any]] = []
    for combo in itertools.product(*(t.values for t in tune)):
        env = dict(zip(names, combo))
        try:
            if all(c.holds(env) for c in constraints):
                out.append(env)
        except TypeError as e:
            raise ParseError(f"constraint not evaluable: {e}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Spec:
    """A parsed LiLAC description: What-programs + How-descriptors."""
    computations: Tuple[Computation, ...]
    harnesses: Tuple[HarnessDecl, ...]

    def __str__(self):
        return "\n\n".join([str(c) for c in self.computations]
                           + [str(h) for h in self.harnesses])

    def computation(self, name: str) -> Computation:
        for c in self.computations:
            if c.name == name:
                return c
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Tokenizer + recursive-descent parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"[ \t\r\n]*(?:(?P<comment>--[^\n]*)"
    r"|(?P<num>\d+(?:\.\d+)?)"
    r"|(?P<name>[A-Za-z_]\w*(?:\.[A-Za-z_]\w*)*)"
    r"|(?P<op><=|[()\[\]{}=;+*<,|])|(?P<bad>\S))"
)

_KEYWORDS = {"COMPUTATION", "HARNESS", "forall", "sum"}

# HARNESS clause words are contextual (not reserved in expressions).
_CLAUSES = {"platforms", "formats", "default_for", "host_only", "marshal",
            "persistent", "BeforeFirstExecution", "AfterLastExecution",
            "tune", "constraint", "fuse", "vjp"}


class ParseError(ValueError):
    """Parse failure with 1-based source position (``line``, ``col``)."""

    def __init__(self, msg: str, line: Optional[int] = None,
                 col: Optional[int] = None):
        if line is not None:
            msg = f"{msg} (at line {line}, col {col})"
        super().__init__(msg)
        self.line = line
        self.col = col


def _line_col_fn(src: str):
    """O(1)-per-query offset -> (line, col) via precomputed line starts."""
    import bisect

    starts = [0] + [i + 1 for i, c in enumerate(src) if c == "\n"]

    def line_col(pos: int) -> Tuple[int, int]:
        li = bisect.bisect_right(starts, pos) - 1
        return li + 1, pos - starts[li] + 1

    return line_col


def _tokenize(src: str):
    line_col = _line_col_fn(src)
    toks: List[Tuple[str, str]] = []
    positions: List[Tuple[int, int]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            break
        start = m.end() - len(m.group(0).lstrip())
        pos = m.end()
        if m.group("comment") is not None:
            continue
        if m.group("num") is not None:
            toks.append(("num", m.group("num")))
        elif m.group("name") is not None:
            name = m.group("name")
            toks.append(("kw" if name in _KEYWORDS else "name", name))
        elif m.group("op") is not None:
            toks.append(("op", m.group("op")))
        elif m.group("bad") is not None:
            line, col = line_col(start)
            raise ParseError(f"bad token {m.group('bad')!r}", line, col)
        positions.append(line_col(start))
    return toks, positions, line_col(len(src))


class _Parser:
    def __init__(self, src: str):
        self.toks, self.positions, self.end_pos = _tokenize(src)
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def pos(self) -> Tuple[int, int]:
        """Position of the current (next-to-consume) token."""
        if self.i < len(self.positions):
            return self.positions[self.i]
        return self.end_pos

    def error(self, msg: str) -> ParseError:
        line, col = self.pos()
        return ParseError(msg, line, col)

    def next(self) -> Tuple[str, str]:
        if self.i >= len(self.toks):
            raise self.error("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, value: Optional[str] = None) -> str:
        if self.i >= len(self.toks):
            raise self.error(f"expected {value or kind}, got end of input")
        k, v = self.toks[self.i]
        if k != kind or (value is not None and v != value):
            raise self.error(f"expected {value or kind}, got {v!r}")
        self.i += 1
        return v

    # spec ::= { computation | harness }
    def spec(self) -> Spec:
        comps: List[Computation] = []
        harnesses: List[HarnessDecl] = []
        while True:
            t = self.peek()
            if t is None:
                break
            if t == ("kw", "COMPUTATION"):
                comps.append(self.program())
            elif t == ("kw", "HARNESS"):
                harnesses.append(self.harness())
            else:
                raise self.error(
                    f"expected COMPUTATION or HARNESS, got {t[1]!r}")
        if not comps and not harnesses:
            raise self.error("empty spec")
        return Spec(tuple(comps), tuple(harnesses))

    # program ::= COMPUTATION <name> <body>
    def program(self) -> Computation:
        self.expect("kw", "COMPUTATION")
        name = self.expect("name")
        return Computation(name=name, body=self.body())

    def body(self) -> Body:
        t = self.peek()
        if t == ("kw", "forall"):
            return self.forall()
        return self.stmt()

    # forall ::= forall ( exp <= name < exp ) { body }
    def forall(self) -> ForAll:
        self.expect("kw", "forall")
        rng = self.range_()
        self.expect("op", "{")
        b = self.body()
        self.expect("op", "}")
        return ForAll(range=rng, body=b)

    def range_(self) -> Range:
        self.expect("op", "(")
        lo = self.expr()
        self.expect("op", "<=")
        var = self.expect("name")
        self.expect("op", "<")
        hi = self.expr()
        self.expect("op", ")")
        return Range(lo=lo, var=var, hi=hi)

    # stmt ::= addr = sum ( range ) expr ;
    def stmt(self) -> SumStore:
        target = self.addr_or_var()
        self.expect("op", "=")
        self.expect("kw", "sum")
        rng = self.range_()
        e = self.expr()
        self.expect("op", ";")
        return SumStore(target=target, range=rng, expr=e)

    def addr_or_var(self) -> Union[Var, Load]:
        name = self.expect("name")
        if self.peek() == ("op", "["):
            self.next()
            idx = self.expr()
            self.expect("op", "]")
            return Load(array=name, index=idx)
        return Var(name)

    # expr with + lowest, * higher
    def expr(self) -> Expr:
        e = self.term()
        while self.peek() == ("op", "+"):
            self.next()
            e = Add(e, self.term())
        return e

    def term(self) -> Expr:
        e = self.atom()
        while self.peek() == ("op", "*"):
            self.next()
            e = Mul(e, self.atom())
        return e

    def atom(self) -> Expr:
        t = self.peek()
        if t is None:
            raise self.error("unexpected end")
        if t[0] == "num":
            self.next()
            return Const(float(t[1]) if "." in t[1] else int(t[1]))
        if t == ("op", "("):
            self.next()
            e = self.expr()
            self.expect("op", ")")
            return e
        return self.addr_or_var()

    # -- harness blocks (§3.3) ----------------------------------------------

    def namelist(self) -> Tuple[str, ...]:
        names = [self.expect("name")]
        while self.peek() == ("op", ","):
            self.next()
            names.append(self.expect("name"))
        return tuple(names)

    def keylist(self) -> Tuple[Tuple[str, ...], ...]:
        keys = [self.key()]
        while self.peek() == ("op", ","):
            self.next()
            keys.append(self.key())
        return tuple(keys)

    def key(self) -> Tuple[str, ...]:
        alts = [self.expect("name")]
        while self.peek() == ("op", "|"):
            self.next()
            alts.append(self.expect("name"))
        return tuple(alts)

    def tune_value(self):
        t = self.peek()
        if t is None:
            raise self.error("expected a tune value, got end of input")
        if t[0] == "num":
            self.next()
            return float(t[1]) if "." in t[1] else int(t[1])
        if t[0] == "name":
            self.next()
            return t[1]
        raise self.error(f"expected a tune value (number or name), "
                         f"got {t[1]!r}")

    def harness(self) -> HarnessDecl:
        self.expect("kw", "HARNESS")
        name = self.expect("name")
        self.expect("name", "implements")
        implements = self.namelist()
        platforms = _DEFAULT_PLATFORMS
        formats: Tuple[str, ...] = ()
        jit_safe = True
        default_for: Tuple[str, ...] = ()
        marshal: List[MarshalClause] = []
        persistent: Tuple[str, ...] = ()
        before_first: Optional[str] = None
        after_last: Optional[str] = None
        tune: List[TuneClause] = []
        constraints: List[Constraint] = []
        fuse_epilogue = False
        vjp_clause: Optional[VjpClause] = None
        while True:
            t = self.peek()
            if t is None or t[0] == "kw":
                break
            if t[0] != "name":
                raise self.error(f"expected a HARNESS clause, got {t[1]!r}")
            word = t[1]
            if word not in _CLAUSES:
                raise self.error(f"unknown HARNESS clause {word!r}")
            self.next()
            if word == "platforms":
                platforms = self.namelist()
            elif word == "formats":
                formats = self.namelist()
            elif word == "default_for":
                default_for = self.namelist()
            elif word == "host_only":
                jit_safe = False
            elif word == "marshal":
                mname = self.expect("name")
                self.expect("op", "=")
                repack = self.expect("name")
                self.expect("op", "(")
                keys = self.keylist()
                self.expect("op", ")")
                src = dst = None
                if self.peek() == ("name", "from"):
                    self.next()
                    src = self.expect("name")
                if self.peek() == ("name", "to"):
                    self.next()
                    dst = self.expect("name")
                marshal.append(MarshalClause(mname, repack, keys,
                                             src=src, dst=dst))
            elif word == "persistent":
                persistent = persistent + self.namelist()
            elif word == "BeforeFirstExecution":
                before_first = self.expect("name")
            elif word == "AfterLastExecution":
                after_last = self.expect("name")
            elif word == "tune":
                pname = self.expect("name")
                if any(t.name == pname for t in tune):
                    raise self.error(f"duplicate tune parameter {pname!r}")
                self.expect("name", "in")
                self.expect("op", "{")
                values = [self.tune_value()]
                while self.peek() == ("op", ","):
                    self.next()
                    values.append(self.tune_value())
                if len(values) != len(set(values)):
                    raise self.error(
                        f"duplicate values in tune {pname!r}")
                self.expect("op", "}")
                tune.append(TuneClause(pname, tuple(values)))
            elif word == "constraint":
                lhs = self.expr()
                t = self.peek()
                if t not in (("op", "<="), ("op", "<")):
                    raise self.error(
                        f"expected <= or < in constraint, got "
                        f"{t[1] if t else 'end of input'!r}")
                self.next()
                rhs = self.expr()
                constraints.append(Constraint(lhs, t[1], rhs))
            elif word == "fuse":
                self.expect("name", "epilogue")
                fuse_epilogue = True
            elif word == "vjp":
                if vjp_clause is not None:
                    raise self.error("duplicate vjp clause")
                vname = self.expect("name")
                self.expect("op", "(")
                wrt = self.namelist()
                self.expect("op", ")")
                vjp_clause = VjpClause(vname, wrt)
            self.expect("op", ";")
        tune_names = {t.name for t in tune}
        for c in constraints:
            for p in c.params():
                if p not in tune_names:
                    raise self.error(
                        f"constraint references unknown tune parameter "
                        f"{p!r} (declared: {sorted(tune_names)})")
        return HarnessDecl(name=name, implements=implements,
                           platforms=platforms, formats=formats,
                           jit_safe=jit_safe, default_for=default_for,
                           marshal=tuple(marshal), persistent=persistent,
                           before_first=before_first, after_last=after_last,
                           tune=tuple(tune), constraints=tuple(constraints),
                           fuse_epilogue=fuse_epilogue, vjp=vjp_clause)


def parse_spec(src: str) -> Spec:
    """Parse a full LiLAC spec: computations and/or harness blocks."""
    p = _Parser(src)
    spec = p.spec()
    if p.peek() is not None:
        raise p.error(f"trailing tokens: {p.peek()}")
    return spec


def parse(src: str) -> Computation:
    """Parse a LiLAC-What program (exactly one COMPUTATION; any HARNESS
    blocks in the text are parsed, validated and discarded)."""
    spec = parse_spec(src)
    if len(spec.computations) != 1:
        raise ParseError(
            f"expected exactly one COMPUTATION, got {len(spec.computations)}")
    return spec.computations[0]


def parse_harness(src: str) -> HarnessDecl:
    """Parse a single HARNESS block (no COMPUTATION)."""
    spec = parse_spec(src)
    if spec.computations or len(spec.harnesses) != 1:
        raise ParseError("expected exactly one HARNESS block")
    return spec.harnesses[0]


# ---------------------------------------------------------------------------
# Builtin specs (paper Figs. 2, 5, 11 + framework computations, with the
# §3.3 harness descriptors for the torch.* backends; the cuda.* backends
# declare their HARNESS blocks next to their kernels under
# repro_torch/kernels/).
# ---------------------------------------------------------------------------

BUILTIN_SPECS: Dict[str, str] = {}

BUILTIN_SPECS["spmv"] = """
COMPUTATION spmv_csr
forall(0 <= i < rows) {
  output[i] = sum(rowstr[i] <= j < rowstr[i+1]) a[j] * iv[colidx[j]];
}

COMPUTATION spmv_coo
forall(0 <= i < rows) {
  output[i] = sum(0 <= j < nnz) delta[rowidx[j]] * a[j] * iv[colidx[j]];
}

HARNESS torch.segment implements spmv_csr, spmv_coo
  formats CSR, COO;
  default_for cpu, cuda;

HARNESS torch.ell implements spmv_csr, spmv_coo
  formats CSR, COO;
  host_only;
  marshal ell = ell_pack(a, colidx, rowstr|rowidx) from csr_binding to ELL8;
  vjp spmv_csr_bwd(a, iv);

HARNESS torch.bcsr implements spmv_csr, spmv_coo
  formats CSR, COO;
  host_only;
  marshal bcsr = bcsr_pack(a, colidx, rowstr|rowidx)
      from csr_binding to BCSR8x128;
  vjp spmv_csr_bwd(a, iv);

HARNESS torch.dense implements spmv_csr, spmv_coo
  formats CSR, COO;
  host_only;
  marshal dense = densify(a, colidx, rowstr|rowidx)
      from csr_binding to DENSE;
  vjp spmv_csr_bwd(a, iv);
"""
# delta[rowidx[j]] denotes the i==rowidx[j] indicator; the generated matcher
# realizes it as the scatter-add-by-row skeleton (see detect.py).  The
# marshaling harnesses repack the matrix's values outside autograd, so each
# declares the CSR backward (the reference's jnp.* blocks declare none):
# without it the gradient of ``a`` would be lost.

BUILTIN_SPECS["spmv_padded"] = """
COMPUTATION spmv_ell
forall(0 <= i < rows) {
  output[i] = sum(0 <= j < width) val[i*width+j] * iv[colidx[i*width+j]];
}

COMPUTATION spmv_jds
forall(0 <= i < rows) {
  output[perm[i]] = sum(0 <= j < nzcnt[i])
      val[jd_ptr[j]+i] * vector[col_ind[jd_ptr[j]+i]];
}

HARNESS torch.ell implements spmv_ell, spmv_jds
  formats ELL, JDS;
  default_for cpu;
"""

BUILTIN_SPECS["spmm"] = """
COMPUTATION spmm_csr
forall(0 <= i < rows) {
  forall(0 <= n < ncols) {
    output[i*ncols+n] = sum(rowstr[i] <= j < rowstr[i+1])
        a[j] * dense[colidx[j]*ncols+n];
  }
}

HARNESS torch.segment implements spmm_csr
  formats CSR, COO;
  default_for cpu;

HARNESS torch.bcsr implements spmm_csr
  formats CSR, COO;
  host_only;
  marshal bcsr = bcsr_pack_mm(a, colidx, rowstr|rowidx)
      from csr_binding_mm to BCSR8x128;
  vjp spmm_csr_bwd(a, dense);
"""

BUILTIN_SPECS["dotproduct"] = """
COMPUTATION dotproduct
result = sum(0 <= i < length) a[i] * b[i];

HARNESS torch.dot implements dotproduct
  default_for cpu, cuda;
"""

BUILTIN_SPECS["gemv"] = """
COMPUTATION gemv
forall(0 <= i < rows) {
  output[i] = sum(0 <= j < cols) mat[i*cols+j] * vec[j];
}

HARNESS torch.dot implements gemv
  default_for cpu, cuda;
"""

# The MoE expert FFN with one-hot dispatch: the sparse computation inside
# modern LMs.  dispatch[t*E+e] is top-k sparse; computing h for all (e, t)
# is the naive dense realization the LiLAC pass detects and replaces.
BUILTIN_SPECS["moe_ffn"] = """
COMPUTATION moe_ffn
forall(0 <= t < tokens) {
  out[t*dm+d] = sum(0 <= e < experts)
      dispatch[t*experts+e] * y[e*tokens*dm+t*dm+d];
}

HARNESS torch.capacity implements moe_ffn
  default_for cpu;
"""

# The dense baseline registers AFTER the kernels' own HARNESS
# blocks: candidate order is registration order, and the autotuner's
# exploration budget truncates in that order, so the baseline must stay
# last exactly as in the pre-spec hand-wired registry.
BUILTIN_SPECS["moe_ffn_baseline"] = """
HARNESS dense implements moe_ffn
"""

# Families whose harnesses must register after the kernel packages'.
POST_KERNEL_FAMILIES = ("moe_ffn_baseline",)

_BUILTIN_PARSED: Dict[str, Spec] = {k: parse_spec(v)
                                    for k, v in BUILTIN_SPECS.items()}

BUILTINS: Dict[str, Computation] = {
    c.name: c for s in _BUILTIN_PARSED.values() for c in s.computations
}

# Back-compat constants (paper Figs. 2, 5, 11).
SPMV_CSR = BUILTINS["spmv_csr"]
SPMV_COO = BUILTINS["spmv_coo"]
SPMV_ELL = BUILTINS["spmv_ell"]
SPMV_JDS = BUILTINS["spmv_jds"]
SPMM_CSR = BUILTINS["spmm_csr"]
DOTPRODUCT = BUILTINS["dotproduct"]
GEMV = BUILTINS["gemv"]
MOE_FFN = BUILTINS["moe_ffn"]
