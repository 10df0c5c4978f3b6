"""(E)CQL text -> predicate IR.

Copy of the recursive-descent parser in ``geomesa_tpu/filter/ecql.py`` cut to
the grammar this port serves::

    INCLUDE | EXCLUDE
    BBOX(geom, xmin, ymin, xmax, ymax)
    INTERSECTS/CONTAINS/WITHIN/DISJOINT/...(geom, WKT)
    DWITHIN/BEYOND(geom, WKT, distance, units)
    a = | <> | != | < | <= | > | >= literal   (or literal op a)
    a BETWEEN x AND y | a IN (v1, v2) | a LIKE 'pat%' | a ILIKE 'pat%'
    a IS [NOT] NULL
    dtg DURING t1/t2 | dtg BEFORE t | dtg AFTER t | dtg TEQUALS t
    IN ('id1', 'id2')              -- feature-id filter
    AND / OR / NOT, parentheses

Expression operands (property against property, arithmetic, functions,
``jsonPath``) raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
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

#: ROADMAP item that ports the expressions this parser refuses
_LATER = "ROADMAP Queue 1, extent geometries and expression predicates"

#: DWITHIN / BEYOND distance units -> meters
_UNITS = {
    "meters": 1.0, "metres": 1.0, "m": 1.0,
    "kilometers": 1000.0, "km": 1000.0,
    "feet": 0.3048, "statute miles": 1609.344, "miles": 1609.344,
    "nautical miles": 1852.0,
}


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

    def literal(self):
        t = self.next()
        if t.kind == "num":
            v = float(t.text)
            return int(v) if v.is_integer() and "." not in t.text and "e" not in t.text.lower() else v
        if t.kind == "str":
            inner = t.text[1:-1].replace("''", "'")
            if re.fullmatch(_ISO, inner):
                return np.int64(parse_iso_ms(inner))
            return inner
        if t.kind == "date":
            return np.int64(parse_iso_ms(t.text))
        if t.kind == "id" and t.text.lower() in ("true", "false"):
            return t.text.lower() == "true"
        raise ValueError(f"ECQL: expected literal, got {t!r}")

    def is_literal(self) -> bool:
        t = self.peek()
        return t is not None and (
            t.kind in ("num", "str", "date")
            or (t.kind == "id" and t.text.lower() in ("true", "false")))

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
            if kw in ("DWITHIN", "BEYOND"):
                self.next()
                self.expect("sym", "(")
                prop = self.expect("id").text
                self.expect("sym", ",")
                g = self.wkt_literal()
                self.expect("sym", ",")
                dist = float(self.expect("num").text)
                self.expect("sym", ",")
                units = self.expect("id").text.lower()
                self.expect("sym", ")")
                node = ir.DWithin(prop, g, dist * _UNITS.get(units, 1.0))
                return ir.Not(node) if kw == "BEYOND" else node
            if kw == "IN":  # feature-id filter
                self.next()
                self.expect("sym", "(")
                ids = []
                while True:
                    ids.append(str(self.literal()))
                    if not self.accept("sym", ","):
                        break
                self.expect("sym", ")")
                return ir.IdIn(tuple(ids))
            raise ValueError(f"ECQL parse error at {kw} in {self.text!r}")
        if self.is_literal():
            # literal op property: flipped into property op literal
            value = self.literal()
            op = self.expect("op").text
            if self.peek() is None or self.peek().kind != "id":
                raise NotImplementedError(f"ECQL expressions: {_LATER}")
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "!=": "<>"}
            return ir.Compare(self.next().text, flip.get(op, op), value)
        if t.kind != "id":
            raise NotImplementedError(f"ECQL expressions: {_LATER}")
        prop = self.next().text
        t = self.peek()
        if t is not None and t.kind == "sym" and t.text == "(":
            raise NotImplementedError(f"ECQL functions: {_LATER}")
        if t is not None and t.kind == "op":
            op = self.next().text
            if op == "!=":
                op = "<>"
            if not self.is_literal():
                raise NotImplementedError(f"ECQL expressions: {_LATER}")
            value = self.literal()
            nt = self.peek()
            if nt is not None and (nt.kind == "sym" and nt.text in "+-*/"
                                   or nt.kind == "num" and nt.text[0] in "+-"):
                raise NotImplementedError(f"ECQL expressions: {_LATER}")
            return ir.Compare(prop, op, value)
        kw = self.accept("kw")
        if kw is not None:
            if kw.text == "BETWEEN":
                lo = self.literal()
                self.expect("kw", "AND")
                return ir.Between(prop, lo, self.literal())
            if kw.text == "IN":
                self.expect("sym", "(")
                vals = []
                while True:
                    vals.append(self.literal())
                    if not self.accept("sym", ","):
                        break
                self.expect("sym", ")")
                return ir.In(prop, tuple(vals))
            if kw.text in ("LIKE", "ILIKE"):
                return ir.Like(prop, str(self.literal()),
                               case_insensitive=kw.text == "ILIKE")
            if kw.text == "IS":
                neg = bool(self.accept("kw", "NOT"))
                self.expect("kw", "NULL")
                return ir.IsNull(prop, negate=neg)
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
        if t is not None and (t.kind == "sym" and t.text in "+-*/"
                              or t.kind == "num" and t.text[0] in "+-"):
            raise NotImplementedError(f"ECQL expressions: {_LATER}")
        raise ValueError(f"ECQL parse error near {prop!r} in {self.text!r}")


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
