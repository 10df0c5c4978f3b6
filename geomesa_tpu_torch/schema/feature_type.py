"""Feature schema model: a named, typed attribute list plus user data.

Copy of ``geomesa_tpu/schema/feature_type.py`` cut to the attribute types
this port serves: Point, the extent geometries (LineString, Polygon,
MultiPoint, MultiLineString, MultiPolygon, Geometry; GeometryCollection is
stored as Geometry), Date, String (UUID and Bytes are stored as strings),
Integer, Long, Float, Double, Boolean and Json (a stored JSON document,
host-only, queried through ``jsonPath()``). The spec-string format
stays GeoMesa's (``name:Type:opt=val,*geom:Point;userdata='v'``);
``index=true`` marks an attribute index.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# spec type name -> canonical type
_TYPES = {
    "string": "string",
    "integer": "int32",
    "int": "int32",
    "long": "int64",
    "float": "float32",
    "double": "float64",
    "boolean": "bool",
    "date": "date",
    "timestamp": "date",
    "uuid": "string",
    "bytes": "string",
    "json": "json",
    "point": "point",
    "linestring": "linestring",
    "polygon": "polygon",
    "multipoint": "multipoint",
    "multilinestring": "multilinestring",
    "multipolygon": "multipolygon",
    "geometry": "geometry",
    "geometrycollection": "geometry",
}

#: canonical type -> its name in a spec string
_SPEC_NAMES = {
    "string": "String", "int32": "Integer", "int64": "Long", "float32": "Float",
    "float64": "Double", "bool": "Boolean", "date": "Date", "json": "Json",
    "point": "Point",
    "linestring": "LineString", "polygon": "Polygon", "multipoint": "MultiPoint",
    "multilinestring": "MultiLineString", "multipolygon": "MultiPolygon",
    "geometry": "Geometry",
}

GEOM_TYPES = {
    "point", "linestring", "polygon", "multipoint", "multilinestring",
    "multipolygon", "geometry",
}

@dataclass
class AttributeSpec:
    name: str
    type: str  # canonical: string | int32 | int64 | float32 | float64 | bool | date | <geom>
    default_geom: bool = False
    options: Dict[str, str] = field(default_factory=dict)

    @property
    def is_geom(self) -> bool:
        return self.type in GEOM_TYPES

    @property
    def is_point(self) -> bool:
        return self.type == "point"

    @property
    def indexed(self) -> bool:
        return self.options.get("index", "").lower() in ("true", "full", "join")

    def spec(self) -> str:
        star = "*" if self.default_geom else ""
        opts = "".join(f":{k}={v}" for k, v in self.options.items())
        return f"{star}{self.name}:{_SPEC_NAMES[self.type]}{opts}"


@dataclass
class FeatureType:
    """Schema: name + ordered attributes + user data."""

    name: str
    attributes: List[AttributeSpec]
    user_data: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        self._by_name = {a.name: a for a in self.attributes}
        if len(self._by_name) != len(self.attributes):
            raise ValueError(f"duplicate attribute names in schema {self.name!r}")

    def has(self, name: str) -> bool:
        return name in self._by_name

    def attr(self, name: str) -> AttributeSpec:
        a = self._by_name.get(name)
        if a is None:
            raise KeyError(
                f"no attribute {name!r} in schema {self.name!r} "
                f"(has: {', '.join(self._by_name)})"
            )
        return a

    @property
    def geom_field(self) -> Optional[str]:
        for a in self.attributes:
            if a.default_geom:
                return a.name
        for a in self.attributes:
            if a.is_geom:
                return a.name
        return None

    @property
    def dtg_field(self) -> Optional[str]:
        explicit = self.user_data.get("geomesa.index.dtg")
        if explicit:
            return explicit
        for a in self.attributes:
            if a.type == "date":
                return a.name
        return None

    @property
    def time_period(self) -> str:
        return self.user_data.get("geomesa.z3.interval", "week")

    @property
    def shards(self) -> Optional[int]:
        """The ``geomesa.z.splits`` user data: the schema's shard count."""
        v = self.user_data.get("geomesa.z.splits")
        return int(v) if v else None

    def spec(self) -> str:
        s = ",".join(a.spec() for a in self.attributes)
        if self.user_data:
            s += ";" + ",".join(f"{k}='{v}'" for k, v in self.user_data.items())
        return s

    def describe(self) -> str:
        lines = [f"Feature type: {self.name}"]
        for a in self.attributes:
            flags = []
            if a.default_geom:
                flags.append("default geometry")
            if a.name == self.dtg_field:
                flags.append("default date")
            if a.indexed:
                flags.append("indexed")
            suffix = f" ({', '.join(flags)})" if flags else ""
            lines.append(f"  {a.name}: {a.type}{suffix}")
        for k, v in self.user_data.items():
            lines.append(f"  [user-data] {k} = {v}")
        return "\n".join(lines)

    @staticmethod
    def from_spec(name: str, spec: str) -> "FeatureType":
        """Parse ``field:Type[:opt=val]*,...[;userdata='v',...]``."""
        spec = spec.strip()
        user_data: Dict[str, str] = {}
        if ";" in spec:
            spec, ud = spec.split(";", 1)
            for kv in _split_top(ud, ","):
                if not kv.strip():
                    continue
                k, v = kv.split("=", 1)
                user_data[k.strip()] = v.strip().strip("'\"")
        attrs = []
        for part in _split_top(spec, ","):
            part = part.strip()
            if not part:
                continue
            default_geom = part.startswith("*")
            if default_geom:
                part = part[1:]
            pieces = part.split(":")
            if len(pieces) < 2:
                raise ValueError(f"invalid attribute spec: {part!r}")
            aname, atype = pieces[0].strip(), pieces[1].strip().lower()
            if atype not in _TYPES:
                raise ValueError(f"unknown attribute type {pieces[1]!r} for {aname!r}")
            options = {}
            for opt in pieces[2:]:
                if "=" in opt:
                    k, v = opt.split("=", 1)
                    options[k.strip()] = v.strip()
            attrs.append(AttributeSpec(aname, _TYPES[atype], default_geom, options))
        return FeatureType(name, attrs, user_data)


def _split_top(s: str, sep: str) -> List[str]:
    """Split on sep outside quotes/brackets."""
    out, depth, cur, q = [], 0, [], None
    for ch in s:
        if q:
            if ch == q:
                q = None
            cur.append(ch)
        elif ch in "'\"":
            q = ch
            cur.append(ch)
        elif ch in "([":
            depth += 1
            cur.append(ch)
        elif ch in ")]":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out
