"""(E)CQL text -> predicate IR.

Copy of the recursive-descent parser in ``geomesa_tpu/filter/ecql.py`` cut to
the grammar this port serves::

    INCLUDE | EXCLUDE
    BBOX(geom, xmin, ymin, xmax, ymax)
    INTERSECTS/CONTAINS/WITHIN/DISJOINT/...(geom, POLYGON(...))
    dtg DURING t1/t2 | dtg BEFORE t | dtg AFTER t | dtg TEQUALS t
    AND / OR / NOT, parentheses

Attribute comparisons, DWITHIN, feature-id filters and expressions raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.utils import geometry as geo

_ISO = r"\d{4}-\d{2}-\d{2}(?:[T ]\d{2}:\d{2}(?::\d{2}(?:\.\d+)?)?(?:Z|[-+]\d{2}:?\d{2})?)?"

_TOKEN_RE = re.compile(
    "|".join(
        [
            r"(?P<date>" + _ISO + r")",
            r"(?P<num>[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?)",
            r"(?P<str>'(?:[^']|'')*')",
            r"(?P<op><=|>=|<>|!=|=|<|>)",
            r"(?P<sym>[(),/*+\-])",
            r"(?P<id>[A-Za-z_][A-Za-z0-9_.:]*)",
            r"(?P<ws>\s+)",
        ]
    )
)

_KEYWORDS = {
    "AND", "OR", "NOT", "INCLUDE", "EXCLUDE", "BBOX", "INTERSECTS", "CONTAINS",
    "WITHIN", "DISJOINT", "CROSSES", "OVERLAPS", "TOUCHES", "EQUALS", "DWITHIN",
    "BEYOND", "DURING", "BEFORE", "AFTER", "TEQUALS", "BETWEEN", "IN", "LIKE",
    "ILIKE", "IS", "NULL",
}

#: ROADMAP item that ports the predicates this parser refuses
_LATER = "ROADMAP Queue 1, index key spaces and predicates"


class _Tok:
    __slots__ = ("kind", "text")

    def __init__(self, kind, text):
        self.kind = kind
        self.text = text

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def _lex(s: str) -> List[_Tok]:
    out = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ValueError(f"ECQL lex error at: {s[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "id" and text.upper() in _KEYWORDS:
            out.append(_Tok("kw", text.upper()))
        else:
            out.append(_Tok(kind, text))
    return out


def parse_iso_ms(s: str) -> int:
    """ISO-8601 -> epoch ms (UTC assumed when no offset given)."""
    s = s.strip().strip("'")
    s = s.replace(" ", "T")
    if s.endswith("Z"):
        s = s[:-1]
    return int(np.datetime64(s, "ms").astype(np.int64))


class _Parser:
    def __init__(self, toks: List[_Tok], text: str):
        self.toks = toks
        self.pos = 0
        self.text = text

    def peek(self) -> Optional[_Tok]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise ValueError(f"unexpected end of ECQL: {self.text!r}")
        self.pos += 1
        return t

    def accept(self, kind, text=None) -> Optional[_Tok]:
        t = self.peek()
        if t and t.kind == kind and (text is None or t.text == text):
            self.pos += 1
            return t
        return None

    def expect(self, kind, text=None) -> _Tok:
        t = self.accept(kind, text)
        if t is None:
            raise ValueError(
                f"ECQL parse error: expected {text or kind} at token "
                f"{self.peek()!r} in {self.text!r}"
            )
        return t

    # expr := term (OR term)*
    def expr(self) -> ir.Filter:
        terms = [self.term()]
        while self.accept("kw", "OR"):
            terms.append(self.term())
        return terms[0] if len(terms) == 1 else ir.Or(tuple(terms))

    # term := factor (AND factor)*
    def term(self) -> ir.Filter:
        factors = [self.factor()]
        while self.accept("kw", "AND"):
            factors.append(self.factor())
        return factors[0] if len(factors) == 1 else ir.And(tuple(factors))

    def factor(self) -> ir.Filter:
        if self.accept("kw", "NOT"):
            return ir.Not(self.factor())
        if self.accept("sym", "("):
            e = self.expr()
            self.expect("sym", ")")
            return e
        return self.predicate()

    def time_literal(self) -> int:
        t = self.next()
        if t.kind == "date":
            return parse_iso_ms(t.text)
        if t.kind == "str" and re.fullmatch(_ISO, t.text[1:-1]):
            return parse_iso_ms(t.text[1:-1])
        if t.kind == "num":
            return int(float(t.text))
        raise ValueError(f"ECQL: expected a time literal, got {t!r}")

    def wkt_literal(self) -> geo.Geometry:
        t = self.next()
        if t.kind == "str":
            return geo.parse_wkt(t.text[1:-1])
        # bare WKT: TYPE ( ... ), re-assembled by paren matching
        if t.kind in ("id", "kw"):
            tag = t.text
            self.expect("sym", "(")
            depth = 1
            parts = ["("]
            while depth > 0:
                nt = self.next()
                if nt.kind == "sym" and nt.text == "(":
                    depth += 1
                elif nt.kind == "sym" and nt.text == ")":
                    depth -= 1
                parts.append(nt.text)
            return geo.parse_wkt(tag + " " + " ".join(parts))
        raise ValueError(f"ECQL: expected WKT geometry, got {t!r}")

    def predicate(self) -> ir.Filter:
        t = self.peek()
        if t is None:
            raise ValueError("empty predicate")
        if t.kind == "kw":
            kw = t.text
            if kw == "INCLUDE":
                self.next()
                return ir.Include()
            if kw == "EXCLUDE":
                self.next()
                return ir.Exclude()
            if kw == "BBOX":
                self.next()
                self.expect("sym", "(")
                prop = self.expect("id").text
                self.expect("sym", ",")
                nums = []
                for i in range(4):
                    nums.append(float(self.expect("num").text))
                    if i < 3:
                        self.expect("sym", ",")
                if self.accept("sym", ","):
                    self.next()  # ignore the CRS argument
                self.expect("sym", ")")
                return ir.BBox(prop, nums[0], nums[1], nums[2], nums[3])
            if kw in ("INTERSECTS", "CONTAINS", "WITHIN", "DISJOINT", "CROSSES",
                      "OVERLAPS", "TOUCHES", "EQUALS"):
                self.next()
                self.expect("sym", "(")
                prop = self.expect("id").text
                self.expect("sym", ",")
                g = self.wkt_literal()
                self.expect("sym", ")")
                return ir.Spatial(kw.lower(), prop, g)
            raise NotImplementedError(f"ECQL {kw}: {_LATER}")
        if t.kind != "id":
            raise NotImplementedError(f"ECQL expressions: {_LATER}")
        prop = self.next().text
        kw = self.accept("kw")
        if kw is not None:
            if kw.text == "DURING":
                lo = self.time_literal()
                self.expect("sym", "/")
                hi = self.time_literal()
                return ir.During(prop, lo, hi)
            if kw.text == "BEFORE":
                return ir.During(prop, ir.MIN_MS, self.time_literal() - 1)
            if kw.text == "AFTER":
                return ir.During(prop, self.time_literal() + 1, ir.MAX_MS)
            if kw.text == "TEQUALS":
                v = self.time_literal()
                return ir.During(prop, v, v)
        raise NotImplementedError(f"attribute predicates on {prop!r}: {_LATER}")


def parse_ecql(text: str) -> ir.Filter:
    """Parse ECQL text into the predicate IR."""
    toks = _lex(text)
    if not toks:
        return ir.Include()
    p = _Parser(toks, text)
    f = p.expr()
    if p.peek() is not None:
        raise ValueError(f"trailing tokens in ECQL: {p.peek()!r} in {text!r}")
    return f
