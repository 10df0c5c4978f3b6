"""Stat DSL parser.

Copy of ``geomesa_tpu/stats/parser.py``: the reference's stat string syntax
(StatParser analog):

    Count();MinMax(attr);Histogram(attr,20,0,100);Enumeration(name);
    TopK(name);Frequency(attr);DescriptiveStats(a,b);GroupBy(cat,MinMax(v));
    Z3Histogram(geom,dtg,week,1024)

Semicolon-separated stats become a SeqStat. Arguments are attribute names,
numbers, or quoted strings.
"""

from __future__ import annotations

import re
from typing import Any, List

from geomesa_tpu_torch.stats import sketches as sk

_TOKEN = re.compile(r"\s*(?:(?P<id>[A-Za-z_][A-Za-z0-9_.]*)|(?P<num>-?\d+(?:\.\d+)?)"
                    r"|'(?P<str>[^']*)'|\"(?P<dstr>[^\"]*)\"|(?P<sym>[(),]))")


class _Tokens:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def peek(self):
        if self.pos >= len(self.text):
            return None, None
        m = _TOKEN.match(self.text, self.pos)
        if not m:
            raise ValueError(f"bad stat string at {self.text[self.pos:]!r}")
        for kind in ("id", "num", "str", "dstr", "sym"):
            v = m.group(kind)
            if v is not None:
                return ("str" if kind == "dstr" else kind), (m, v)
        raise ValueError("unreachable")

    def next(self):
        kind, mv = self.peek()
        if kind is None:
            raise ValueError("unexpected end of stat string")
        m, v = mv
        self.pos = m.end()
        return kind, v

    def expect(self, sym: str):
        kind, v = self.next()
        if kind != "sym" or v != sym:
            raise ValueError(f"expected {sym!r}, got {v!r}")


def _parse_args(toks: _Tokens) -> List[Any]:
    """Parse '(' arg, ... ')' where an arg is an id/number/string or a nested
    stat call (for GroupBy)."""
    toks.expect("(")
    args: List[Any] = []
    kind, mv = toks.peek()
    if kind == "sym" and mv[1] == ")":
        toks.next()
        return args
    while True:
        kind, v = toks.next()
        if kind == "id":
            # Nested stat call? e.g. GroupBy(cat,MinMax(v))
            k2, mv2 = toks.peek()
            if k2 == "sym" and mv2[1] == "(":
                start = toks.pos - len(v)
                _build(v, _parse_args(toks))  # validate
                args.append(("stat", toks.text[start:toks.pos].strip()))
            else:
                args.append(("id", v))
        elif kind == "num":
            args.append(("num", float(v) if "." in v else int(v)))
        elif kind == "str":
            args.append(("str", v))
        else:
            raise ValueError(f"unexpected token {v!r} in stat args")
        kind, v = toks.next()
        if kind == "sym" and v == ")":
            return args
        if not (kind == "sym" and v == ","):
            raise ValueError(f"expected ',' or ')', got {v!r}")


def _val(arg):
    return arg[1]


def _build(name: str, args: List[Any]) -> sk.Stat:
    n = name.lower()
    if n == "count":
        return sk.CountStat()
    if n == "minmax":
        return sk.MinMax(_val(args[0]))
    if n == "enumeration":
        return sk.EnumerationStat(_val(args[0]))
    if n == "topk":
        k = int(_val(args[1])) if len(args) > 1 else 10
        return sk.TopK(_val(args[0]), k)
    if n == "histogram":
        a, bins, lo, hi = (_val(x) for x in args[:4])
        return sk.Histogram(a, int(bins), float(lo), float(hi))
    if n == "frequency":
        width = int(_val(args[1])) if len(args) > 1 else 1024
        return sk.Frequency(_val(args[0]), width)
    if n == "descriptivestats":
        return sk.DescriptiveStats([_val(a) for a in args])
    if n == "groupby":
        return sk.GroupBy(_val(args[0]), _val(args[1]))
    if n == "z3histogram":
        geom, dtg = _val(args[0]), _val(args[1])
        period = _val(args[2]) if len(args) > 2 else "week"
        length = int(_val(args[3])) if len(args) > 3 else 1024
        return sk.Z3HistogramStat(geom, dtg, period, length)
    if n == "z3frequency":
        geom, dtg = _val(args[0]), _val(args[1])
        period = _val(args[2]) if len(args) > 2 else "week"
        precision = int(_val(args[3])) if len(args) > 3 else 10
        return sk.Z3FrequencyStat(geom, dtg, period, precision)
    raise ValueError(f"unknown stat function: {name!r}")


def parse_stat(spec: str) -> sk.Stat:
    """Parse a stat DSL string into a (possibly Seq) sketch."""
    parts = [p.strip() for p in spec.split(";") if p.strip()]
    stats = []
    for part in parts:
        toks = _Tokens(part)
        kind, v = toks.next()
        if kind != "id":
            raise ValueError(f"expected stat name, got {v!r}")
        stats.append(_build(v, _parse_args(toks)))
        if toks.peek()[0] is not None:
            raise ValueError(f"trailing content in stat spec: {part!r}")
    if not stats:
        raise ValueError("empty stat spec")
    return stats[0] if len(stats) == 1 else sk.SeqStat(stats)
