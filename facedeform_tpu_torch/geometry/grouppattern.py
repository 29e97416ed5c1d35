"""Houdini group-pattern strings -> boolean point masks.

A copy of facedeform_tpu/geometry/grouppattern.py (numpy only):
importing it from there would import the JAX package.

The reference binds its `group` parameter through `cookInputGroups`
(src/SOP_FaceDeform.cpp:119-120, 156-173), which accepts full Houdini
group syntax — not just a single named group.  This module implements the
point-group subset of that grammar over Mesh.point_groups:

    token        meaning
    -----        -------
    name         named point group (KeyError if absent and not a pattern)
    na*e / n?me  glob over group names (union of all matches)
    !name        complement of a named group / glob union
    7            a single point number
    3-40         inclusive point-number range
    3-40:2       every 2nd point of the range (Houdini step syntax)
    3-40:2,5     keep the first 2 of every 5 (Houdini keep,of syntax)
    @class=1     points whose point attr `class` equals 1
    @id<40       numeric comparison on a point attr (< <= > >= != =)
    @name=a,b*   string attr: any-of a comma list, values may glob
    @P.y>0.5     component select on a vector attr (.x/.y/.z/.w or .INDEX)

Whitespace-separated tokens are unioned left to right; a `^` prefix
subtracts the token's set from the selection accumulated so far (the
Houdini idiom `* ^fixed`).  A pattern of only `^`/`!` tokens starts from
the empty set, matching GOP's semantics.

Out of scope (documented, not planned): backtick hscript expressions
(``ch(..)`` interpolation, needs a live Houdini session), ad-hoc group ops from other
geometry streams (`opinput:` bindings), and primitive/edge/vertex group
classes — this is a *point*-group parameter in the reference
(src/SOP_FaceDeform.cpp:156: cookInputPointGroups).
"""

from __future__ import annotations

import fnmatch
import re

import numpy as np

_RANGE_RE = re.compile(
    r"^(\d+)(?:-(\d+)(?::(\d+)(?:,(\d+))?)?)?$"
)

# @attr[.comp]<op>value — the GOP attribute-match tokens the reference's
# group parm accepts via cookInputPointGroups (src/SOP_FaceDeform.cpp:156-173).
_ATTR_RE = re.compile(
    r"^@([A-Za-z_]\w*)(?:\.([xyzwXYZW]|\d+))?(<=|>=|!=|==|<|>|=)(.*)$"
)
_COMP_INDEX = {"x": 0, "y": 1, "z": 2, "w": 3}


def _attr_column(mesh, name: str, comp: str | None) -> np.ndarray:
    """Resolve @name[.comp] to a (V,) column of the point attribute."""
    arr = mesh.point_attrs.get(name)
    if arr is None and name == "P":
        # Positions live in mesh.points, not point_attrs (geo_io routes
        # the P attribute there on load) — @P.y>0 must still work.
        arr = mesh.points
    if arr is None:
        raise KeyError(
            f"point attribute {name!r} not found; have "
            f"{sorted(mesh.point_attrs)}"
        )
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr[:, 0]
    if comp is not None:
        idx = _COMP_INDEX.get(comp.lower())
        if idx is None:
            idx = int(comp)
        if arr.ndim < 2 or idx >= arr.shape[1]:
            raise ValueError(
                f"@{name}.{comp}: attribute has shape {arr.shape}, "
                f"component {comp} out of range"
            )
        return arr[:, idx]
    if arr.ndim != 1:
        raise ValueError(
            f"@{name}: attribute has shape {arr.shape}; select a component "
            f"(@{name}.x / @{name}.0) to compare a vector attribute"
        )
    return arr


def _attr_mask(tok: str, mesh) -> np.ndarray:
    """One @attr token -> boolean mask (Houdini GOP attribute match)."""
    m = _ATTR_RE.match(tok)
    if not m:
        raise ValueError(
            f"bad attribute pattern {tok!r}: expected @name[.comp]<op>value "
            f"with op one of = == != < <= > >="
        )
    name, comp, op, rhs = m.groups()
    if rhs == "":
        raise ValueError(f"bad attribute pattern {tok!r}: missing value")
    col = _attr_column(mesh, name, comp)
    is_string = col.dtype.kind in "USO"
    if op in ("=", "==", "!="):
        # Equality accepts a comma list (any-of); string values may glob.
        vals = rhs.split(",")
        mask = np.zeros(col.shape[0], bool)
        for v in vals:
            if is_string:
                sv = col.astype(str)
                if any(c in v for c in "*?["):
                    mask |= np.array(
                        [fnmatch.fnmatchcase(s, v) for s in sv], bool
                    )
                else:
                    mask |= sv == v
            elif col.dtype.kind in "iub":
                # integer attrs compare EXACTLY (np.isclose's relative
                # tolerance would match id 999991..1000009 for @id=1e6)
                mask |= col == int(float(v))
            else:
                # floats: the column is f32, so a fixed 1e-6 absolute
                # tolerance breaks both ways — above |v| ~ 16 one f32 ULP
                # already exceeds it (@P.x=123.456 would match nothing),
                # while near zero it conflates distinct tiny values.
                # Scale with magnitude: a few ULPs relative, floored at
                # 1e-6 absolute for values around zero.
                fv = float(v)
                tol = max(1e-6, 4.0 * abs(fv) * np.finfo(np.float32).eps)
                mask |= np.abs(col.astype(np.float64) - fv) <= tol
        return ~mask if op == "!=" else mask
    # Ordered comparisons are numeric-only, matching Houdini.
    if is_string:
        raise ValueError(
            f"@{name}: ordered comparison {op!r} on a string attribute"
        )
    x = col.astype(np.float64)
    r = float(rhs)
    if op == "<":
        return x < r
    if op == "<=":
        return x <= r
    if op == ">":
        return x > r
    return x >= r


def _token_mask(tok: str, mesh) -> np.ndarray:
    """One token (no ^/! prefix) -> boolean mask."""
    v = mesh.num_points
    if tok.startswith("@"):
        return _attr_mask(tok, mesh)
    m = _RANGE_RE.match(tok)
    if m:
        lo = int(m.group(1))
        hi = int(m.group(2)) if m.group(2) is not None else lo
        if lo > hi:
            lo, hi = hi, lo
        lo, hi = min(lo, v), min(hi, v - 1)
        mask = np.zeros(v, bool)
        if m.group(3) is None:
            mask[lo : hi + 1] = True
        elif m.group(4) is None:
            # a-b:step — every step-th point of the range
            step = max(int(m.group(3)), 1)
            mask[lo : hi + 1 : step] = True
        else:
            # a-b:keep,of — the first `keep` of every `of` points
            keep, of = int(m.group(3)), max(int(m.group(4)), 1)
            rel = np.arange(hi + 1 - lo) % of < keep
            mask[lo : hi + 1] = rel
        return mask
    if tok == "*":
        # Houdini: `*` selects every point, grouped or not (the idiom
        # `* ^fixed` depends on this), NOT the union of group names.
        return np.ones(v, bool)
    if any(c in tok for c in "*?["):
        names = sorted(n for n in mesh.point_groups if fnmatch.fnmatchcase(n, tok))
        mask = np.zeros(v, bool)
        for n in names:
            mask |= mesh.point_groups[n].astype(bool)
        return mask
    return mesh.group_mask(tok).astype(bool)


def parse_group_pattern(pattern: str, mesh) -> np.ndarray:
    """Resolve a Houdini-style group pattern to a (V,) boolean mask.

    Raises ValueError on an empty/blank pattern and KeyError (with the
    known group names) when a plain token names no group — same contract
    as Mesh.group_mask.
    """
    toks = pattern.split()
    if not toks:
        raise ValueError("empty group pattern")
    sel = np.zeros(mesh.num_points, bool)
    for tok in toks:
        if tok.startswith("^"):
            sel &= ~_token_mask(tok[1:], mesh)
        elif tok.startswith("!"):
            sel |= ~_token_mask(tok[1:], mesh)
        else:
            sel |= _token_mask(tok, mesh)
    return sel
