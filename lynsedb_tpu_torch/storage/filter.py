"""SQL-style ``where`` expression compiler.

The reference hands filter strings to an embedded SQL engine
(reference: src/storage/field_store.rs:1203 — ``SELECT _id FROM t WHERE
<expr>``, plus an in-memory equality-index fast path :711). Here the
expression compiles to an AST evaluated vectorized over the columnar field
store, producing a row bitmask that ships to the device and fuses into the
distance scan.

Grammar:
    expr       := or_expr
    or_expr    := and_expr (OR and_expr)*
    and_expr   := not_expr (AND not_expr)*
    not_expr   := NOT not_expr | primary
    primary    := '(' expr ')' | predicate
    predicate  := field (=|==|!=|<>|<|<=|>|>=) literal
                | field [NOT] IN '(' literal (',' literal)* ')'
                | field [NOT] CONTAINS literal
                | field [NOT] LIKE string
                | field IS [NOT] NULL
                | field BETWEEN literal AND literal
    field      := identifier | "quoted identifier"
    literal    := number | 'string' | true | false | null
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np


class FilterError(ValueError):
    pass


# ── AST ──────────────────────────────────────────────────────────────────


@dataclass
class Cmp:
    field: str
    op: str  # = != < <= > >=
    value: Any


@dataclass
class In:
    field: str
    values: list
    negate: bool = False


@dataclass
class Contains:
    field: str
    value: Any
    negate: bool = False


@dataclass
class Like:
    field: str
    pattern: str
    negate: bool = False


@dataclass
class IsNull:
    field: str
    negate: bool = False


@dataclass
class Between:
    field: str
    lo: Any
    hi: Any


@dataclass
class And:
    parts: list


@dataclass
class Or:
    parts: list


@dataclass
class Not:
    part: Any


# ── tokenizer ────────────────────────────────────────────────────────────

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<dquoted>"(?:[^"\\]|\\.)*") |
        (?P<squoted>'(?:[^'\\]|\\.)*') |
        (?P<number>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?) |
        (?P<op><=|>=|!=|<>|==|=|<|>) |
        (?P<lparen>\() |
        (?P<rparen>\)) |
        (?P<comma>,) |
        (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
    )
    """,
    re.VERBOSE,
)

_KEYWORDS = {"AND", "OR", "NOT", "IN", "CONTAINS", "LIKE", "IS", "NULL", "BETWEEN", "TRUE", "FALSE"}


def _tokenize(s: str) -> List[Tuple[str, Any]]:
    tokens = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            rest = s[pos:].strip()
            if not rest:
                break
            raise FilterError(f"unexpected character in filter at: {rest[:20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group(kind)
        if kind == "dquoted":
            tokens.append(("field", re.sub(r"\\(.)", r"\1", text[1:-1])))
        elif kind == "squoted":
            tokens.append(("str", re.sub(r"\\(.)", r"\1", text[1:-1])))
        elif kind == "number":
            tokens.append(("num", float(text) if ("." in text or "e" in text or "E" in text) else int(text)))
        elif kind == "op":
            tokens.append(("op", "=" if text == "==" else ("!=" if text == "<>" else text)))
        elif kind == "word":
            up = text.upper()
            if up in _KEYWORDS:
                tokens.append(("kw", up))
            else:
                tokens.append(("word", text))
        else:
            tokens.append((kind, text))
    return tokens


# ── parser ───────────────────────────────────────────────────────────────


class _Parser:
    def __init__(self, tokens: List[Tuple[str, Any]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind, value=None):
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise FilterError(f"expected {value or kind}, got {v!r}")
        return v

    def parse(self):
        node = self.or_expr()
        if self.peek()[0] is not None:
            raise FilterError(f"trailing tokens in filter: {self.peek()[1]!r}")
        return node

    def or_expr(self):
        parts = [self.and_expr()]
        while self.peek() == ("kw", "OR"):
            self.next()
            parts.append(self.and_expr())
        return parts[0] if len(parts) == 1 else Or(parts)

    def and_expr(self):
        parts = [self.not_expr()]
        while self.peek() == ("kw", "AND"):
            self.next()
            parts.append(self.not_expr())
        return parts[0] if len(parts) == 1 else And(parts)

    def not_expr(self):
        if self.peek() == ("kw", "NOT"):
            self.next()
            return Not(self.not_expr())
        return self.primary()

    def primary(self):
        k, v = self.peek()
        if k == "lparen":
            self.next()
            node = self.or_expr()
            self.expect("rparen")
            return node
        return self.predicate()

    def _field(self) -> str:
        k, v = self.next()
        if k in ("word", "field"):
            return v
        raise FilterError(f"expected field name, got {v!r}")

    def _literal(self):
        k, v = self.next()
        if k in ("str", "num"):
            return v
        if k == "kw" and v in ("TRUE", "FALSE"):
            return v == "TRUE"
        if k == "kw" and v == "NULL":
            return None
        raise FilterError(f"expected literal, got {v!r}")

    def predicate(self):
        field = self._field()
        negate = False
        k, v = self.peek()
        if (k, v) == ("kw", "NOT"):
            self.next()
            negate = True
            k, v = self.peek()
        if k == "op":
            if negate:
                raise FilterError("NOT must precede IN/CONTAINS/LIKE")
            self.next()
            return Cmp(field, v, self._literal())
        if (k, v) == ("kw", "IN"):
            self.next()
            self.expect("lparen")
            values = [self._literal()]
            while self.peek()[0] == "comma":
                self.next()
                values.append(self._literal())
            self.expect("rparen")
            return In(field, values, negate)
        if (k, v) == ("kw", "CONTAINS"):
            self.next()
            return Contains(field, self._literal(), negate)
        if (k, v) == ("kw", "LIKE"):
            self.next()
            lit = self._literal()
            if not isinstance(lit, str):
                raise FilterError("LIKE requires a string pattern")
            return Like(field, lit, negate)
        if (k, v) == ("kw", "IS"):
            if negate:
                raise FilterError("NOT must follow IS")
            self.next()
            neg = False
            if self.peek() == ("kw", "NOT"):
                self.next()
                neg = True
            self.expect("kw", "NULL")
            return IsNull(field, neg)
        if (k, v) == ("kw", "BETWEEN"):
            if negate:
                raise FilterError("NOT BETWEEN is not supported")
            self.next()
            lo = self._literal()
            self.expect("kw", "AND")
            hi = self._literal()
            return Between(field, lo, hi)
        raise FilterError(f"expected predicate operator after field {field!r}, got {v!r}")


def parse_where(where: str):
    tokens = _tokenize(where)
    if not tokens:
        raise FilterError("empty filter expression")
    return _Parser(tokens).parse()


# ── analysis helpers ─────────────────────────────────────────────────────


def equality_conjuncts(node) -> Optional[list[tuple[str, Any]]]:
    """If the AST is a pure AND of equality predicates, return the
    (field, value) pairs — the equality-index fast path
    (reference: field_store.rs:711 query_from_index)."""
    if isinstance(node, Cmp) and node.op == "=":
        return [(node.field, node.value)]
    if isinstance(node, And):
        out = []
        for p in node.parts:
            sub = equality_conjuncts(p)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return None


# ── evaluation ───────────────────────────────────────────────────────────


def _like_to_regex(pattern: str) -> re.Pattern:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


class ColumnProvider:
    """Interface the evaluator needs: column(field) -> (values, present).

    ``values`` is a length-n object/typed numpy array; ``present`` is a bool
    mask (False where the field is missing/null for that row).
    """

    def column(self, field: str):  # pragma: no cover - interface
        raise NotImplementedError

    def n_rows(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError


def _coerce_pair(values: np.ndarray, present: np.ndarray, literal):
    """Return (comparable_values, comparable_mask, literal) for an ordered
    comparison. Rows whose type doesn't match the literal's family are
    excluded (SQL-ish: heterogenous comparisons are false, not errors)."""
    n = len(values)
    if isinstance(literal, bool):
        ok = present & np.fromiter((isinstance(v, bool) for v in values), bool, n)
        return values, ok, literal
    if isinstance(literal, (int, float)):
        ok = present & np.fromiter(
            (isinstance(v, (int, float)) and not isinstance(v, bool) for v in values), bool, n
        )
        nums = np.array([float(v) if ok[i] else np.nan for i, v in enumerate(values)])
        return nums, ok, float(literal)
    if isinstance(literal, str):
        ok = present & np.fromiter((isinstance(v, str) for v in values), bool, n)
        return values, ok, literal
    if literal is None:
        return values, np.zeros(n, dtype=bool), None
    raise FilterError(f"unsupported literal: {literal!r}")


def evaluate(node, provider: ColumnProvider) -> np.ndarray:
    n = provider.n_rows()
    if n == 0:
        return np.zeros(0, dtype=bool)

    if isinstance(node, And):
        mask = np.ones(n, dtype=bool)
        for p in node.parts:
            mask &= evaluate(p, provider)
        return mask
    if isinstance(node, Or):
        mask = np.zeros(n, dtype=bool)
        for p in node.parts:
            mask |= evaluate(p, provider)
        return mask
    if isinstance(node, Not):
        return ~evaluate(node.part, provider)

    values, present = provider.column(node.field)

    if isinstance(node, IsNull):
        return present if node.negate else ~present

    if isinstance(node, Cmp):
        if node.value is None:
            eq = ~present
            return eq if node.op == "=" else (present if node.op == "!=" else np.zeros(n, bool))
        vals, ok, lit = _coerce_pair(values, present, node.value)
        if node.op in ("=", "!="):
            if isinstance(lit, float):
                eq = ok & (np.nan_to_num(vals, nan=np.inf) == lit)
            else:
                eq = ok & np.fromiter((ok[i] and vals[i] == lit for i in range(n)), bool, n)
            return eq if node.op == "=" else (present & ~eq)
        # ordered comparison
        if isinstance(lit, float):
            safe = np.where(ok, np.nan_to_num(vals, nan=0.0), 0.0)
            res = {"<": safe < lit, "<=": safe <= lit, ">": safe > lit, ">=": safe >= lit}[node.op]
            return ok & res
        if isinstance(lit, str):
            out = np.zeros(n, dtype=bool)
            for i in range(n):
                if ok[i]:
                    v = vals[i]
                    out[i] = (
                        v < lit if node.op == "<" else v <= lit if node.op == "<=" else v > lit if node.op == ">" else v >= lit
                    )
            return out
        raise FilterError(f"cannot order-compare with {type(node.value).__name__}")

    if isinstance(node, In):
        mask = np.zeros(n, dtype=bool)
        for lit in node.values:
            mask |= evaluate(Cmp(node.field, "=", lit), provider)
        return (present & ~mask) if node.negate else mask

    if isinstance(node, Between):
        lo = evaluate(Cmp(node.field, ">=", node.lo), provider)
        hi = evaluate(Cmp(node.field, "<=", node.hi), provider)
        return lo & hi

    if isinstance(node, Contains):
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            if present[i]:
                v = values[i]
                if isinstance(v, (list, tuple)):
                    out[i] = node.value in v
                elif isinstance(v, str) and isinstance(node.value, str):
                    out[i] = node.value in v
        return (present & ~out) if node.negate else out

    if isinstance(node, Like):
        rx = _like_to_regex(node.pattern)
        out = np.fromiter(
            (present[i] and isinstance(values[i], str) and bool(rx.match(values[i])) for i in range(n)),
            bool,
            n,
        )
        return (present & ~out) if node.negate else out

    raise FilterError(f"unsupported filter node: {node!r}")
