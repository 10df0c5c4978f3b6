"""ECQL (Extended CQL) text -> predicate IR.

Copy of the recursive-descent parser in ``geomesa_tpu/filter/ecql.py``::

    INCLUDE | EXCLUDE
    BBOX(geom, minx, miny, maxx, maxy)
    INTERSECTS/CONTAINS/WITHIN/DISJOINT/...(geom, WKT)
    DWITHIN/BEYOND(geom, WKT, distance, units)
    a = | <> | != | < | <= | > | >= literal   (or literal op a)
    a BETWEEN x AND y | a IN (v1, v2) | a LIKE 'pat%' | a ILIKE 'pat%'
    a IS NULL | a IS NOT NULL
    dtg DURING t1/t2 | dtg BEFORE t | dtg AFTER t | dtg TEQUALS t
    IN ('fid1', 'fid2')                       -- feature ids
    expr CMP expr                             -- property against property,
                                              -- arithmetic, functions:
        speed > heading
        weight * 2 < limit
        (a + b) * 2 >= c - 1
        st_area(geom) > 0.5
    NOT p | p AND q | p OR q | ( p )

    jsonPath('$.a.b', attr) CMP literal        -- stored-JSON accessor, also
                                              -- with BETWEEN / IN / LIKE /
                                              -- IS NULL

Functions resolve against the port's ``geofn`` ``st_*`` library. Dates are
ISO-8601 (bare or quoted).
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
        left = self.term()
        terms = [left]
        while self.accept("kw", "OR"):
            terms.append(self.term())
        return terms[0] if len(terms) == 1 else ir.Or(tuple(terms))

    # term := factor (AND factor)*
    def term(self) -> ir.Filter:
        left = self.factor()
        factors = [left]
        while self.accept("kw", "AND"):
            factors.append(self.factor())
        return factors[0] if len(factors) == 1 else ir.And(tuple(factors))

    def factor(self) -> ir.Filter:
        if self.accept("kw", "NOT"):
            return ir.Not(self.factor())
        t = self.peek()
        if t and t.kind == "sym" and t.text == "(":
            # '(' opens either a boolean group or an arithmetic group
            # ('(a + b) * 2 >= c'): try boolean, backtrack to the
            # expression-led predicate parse on failure
            mark = self.pos
            try:
                self.next()
                e = self.expr()
                self.expect("sym", ")")
                return e
            except ValueError:
                self.pos = mark
        return self.predicate()

    # -- literals ---------------------------------------------------------
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

    def wkt_literal(self) -> geo.Geometry:
        t = self.next()
        if t.kind == "str":
            return geo.parse_wkt(t.text[1:-1])
        # bare WKT: TYPE ( ... ) — re-lex from source text by paren matching
        if t.kind == "id" or (t.kind == "kw"):
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

    # -- scalar expressions (FastFilterFactory.scala:395 parity) ----------
    @staticmethod
    def _mk_arith(op: str, left, right):
        """Build an Arith node; jsonPath() refs cannot ride arithmetic,
        and literal-only subtrees fold to a literal (so 'speed < 1 + 1' and
        unary minus keep the plain Compare IR and its device pushdown)."""
        for side in (left, right):
            if isinstance(side, ir.JsonPath):
                raise ValueError(
                    "jsonPath() cannot appear inside arithmetic "
                    "expressions; compare it directly against a literal"
                )
        if isinstance(left, ir.Lit) and isinstance(right, ir.Lit) \
                and isinstance(left.value, (int, float, np.integer)) \
                and isinstance(right.value, (int, float, np.integer)):
            lv, rv = left.value, right.value
            if op == "+":
                return ir.Lit(lv + rv)
            if op == "-":
                return ir.Lit(lv - rv)
            if op == "*":
                return ir.Lit(lv * rv)
            if rv != 0:
                v = lv / rv
                return ir.Lit(int(v) if isinstance(lv, (int, np.integer))
                              and isinstance(rv, (int, np.integer))
                              and v == int(v) else v)
        return ir.Arith(op, left, right)

    # additive := multiplicative (('+'|'-') multiplicative)*
    def expr_operand(self):
        left = self.expr_mul()
        while True:
            t = self.peek()
            if t and t.kind == "sym" and t.text in "+-":
                self.next()
                left = self._mk_arith(t.text, left, self.expr_mul())
            elif t and t.kind == "num" and t.text[0] in "+-":
                # 'a -5' lexes the sign into the number: it is really a
                # binary minus (a + (-5))
                self.next()
                v = float(t.text)
                v = int(v) if v.is_integer() and "." not in t.text else v
                left = self._mk_arith("+", left, ir.Lit(v))
            else:
                return left

    def expr_mul(self):
        left = self.expr_unary()
        while True:
            t = self.peek()
            if t and t.kind == "sym" and t.text in "*/":
                self.next()
                left = self._mk_arith(t.text, left, self.expr_unary())
            else:
                return left

    def expr_unary(self):
        t = self.peek()
        if t is None:
            raise ValueError("ECQL: expected expression operand")
        if t.kind == "sym" and t.text == "(":
            self.next()
            e = self.expr_operand()
            self.expect("sym", ")")
            return e
        if t.kind == "sym" and t.text == "-":
            self.next()
            return self._mk_arith("-", ir.Lit(0), self.expr_unary())
        if t.kind in ("num", "str", "date"):
            return ir.Lit(self.literal())
        if t.kind == "id":
            name = self.next().text
            if name.lower() in ("true", "false"):
                return ir.Lit(name.lower() == "true")
            nt = self.peek()
            if nt and nt.kind == "sym" and nt.text == "(":
                if name.lower() == "jsonpath":
                    self.next()
                    path = str(self.literal())
                    self.expect("sym", ",")
                    attr = self.expect("id").text
                    self.expect("sym", ")")
                    return ir.JsonPath(attr, path)
                self.next()
                args = []
                if not self.accept("sym", ")"):
                    while True:
                        a = self.expr_operand()
                        if isinstance(a, ir.JsonPath):
                            raise ValueError(
                                "jsonPath() cannot be a function argument;"
                                " compare it directly against a literal"
                            )
                        args.append(a)
                        if not self.accept("sym", ","):
                            break
                    self.expect("sym", ")")
                return ir.FnCall(name, tuple(args))
            return ir.Prop(name)
        raise ValueError(f"ECQL: expected expression operand, got {t!r}")

    # -- predicates -------------------------------------------------------
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
                # optional CRS arg
                if self.accept("sym", ","):
                    self.next()  # ignore crs string
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
                    lit = self.literal()
                    ids.append(str(lit))
                    if not self.accept("sym", ","):
                        break
                self.expect("sym", ")")
                return ir.IdIn(tuple(ids))
        # property-led predicates: the left side is a full scalar
        # expression (property, jsonPath(), arithmetic, st_* call); plain
        # property against literal keeps the Compare IR (and its device
        # pushdown), anything richer becomes ExprCompare
        lhs = self.expr_operand()
        if isinstance(lhs, ir.JsonPath):
            prop = lhs
        elif isinstance(lhs, ir.Prop):
            prop = lhs.name
        else:
            prop = None  # expression: comparison operators only
        t = self.peek()
        if t and t.kind == "op":
            op = self.next().text
            if op == "!=":
                op = "<>"
            rhs = self.expr_operand()
            if prop is not None and isinstance(rhs, ir.Lit):
                return ir.Compare(prop, op, rhs.value)
            if isinstance(lhs, ir.Lit) and isinstance(rhs, ir.Prop):
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
                return ir.Compare(rhs.name, flip.get(op, op), lhs.value)
            if isinstance(lhs, ir.JsonPath) or isinstance(rhs, ir.JsonPath):
                raise ValueError(
                    "jsonPath() comparisons support literal operands only"
                )
            if isinstance(lhs, ir.Lit) and isinstance(rhs, ir.Lit):
                # constant comparison folds at parse time ('1 + 1 = 2').
                # Dispatch on the op — eagerly building a table of all six
                # evaluated '1 < "a"' even for '1 = "a"', leaking TypeError
                # past parser backtracking
                a, b = lhs.value, rhs.value
                try:
                    if op == "=":
                        res = a == b
                    elif op == "<>":
                        res = a != b
                    elif op == "<":
                        res = a < b
                    elif op == "<=":
                        res = a <= b
                    elif op == ">":
                        res = a > b
                    else:
                        res = a >= b
                except TypeError as e:
                    raise ValueError(
                        f"incomparable literal types in {self.text!r}: "
                        f"{a!r} {op} {b!r}"
                    ) from e
                return ir.Include() if res else ir.Exclude()
            return ir.ExprCompare(op, lhs, rhs)
        if prop is None:
            raise ValueError(
                f"ECQL: expression must be followed by a comparison "
                f"operator in {self.text!r}"
            )
        if t and t.kind == "kw":
            kw = self.next().text
            if kw == "BETWEEN":
                lo = self.literal()
                self.expect("kw", "AND")
                hi = self.literal()
                return ir.Between(prop, lo, hi)
            if kw == "IN":
                self.expect("sym", "(")
                vals = []
                while True:
                    vals.append(self.literal())
                    if not self.accept("sym", ","):
                        break
                self.expect("sym", ")")
                return ir.In(prop, tuple(vals))
            if kw in ("LIKE", "ILIKE"):
                pat = self.literal()
                return ir.Like(prop, str(pat), case_insensitive=(kw == "ILIKE"))
            if kw == "IS":
                neg = bool(self.accept("kw", "NOT"))
                self.expect("kw", "NULL")
                return ir.IsNull(prop, negate=neg)
            if kw == "DURING":
                lo = self.literal()
                self.expect("sym", "/")
                hi = self.literal()
                return ir.During(prop, int(lo), int(hi))
            if kw == "BEFORE":
                return ir.During(prop, ir.MIN_MS, int(self.literal()) - 1)
            if kw == "AFTER":
                return ir.During(prop, int(self.literal()) + 1, ir.MAX_MS)
            if kw == "TEQUALS":
                v = int(self.literal())
                return ir.During(prop, v, v)
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
