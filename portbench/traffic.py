"""The one general traffic generator: a mix file in, a seeded query stream out.

A mix (``mixes/<name>.json``) is data alone:

  ``kinds``   query templates: scans (alias -> table and predicate), an
              optional ``join [build, probe, build_key, probe_key]`` or
              ``joins`` (a list of them: a star join, several build sides
              on one probe scan; not both), ``limit`` / ``offset`` and
              ``order_by [alias, column, desc]``; ``vars`` are drawn first
              and shared by the query's constraints;
  ``preds``   named predicates: conjunctions of ``{"col", "op", "value"}``
              with ``op`` one of ge, gt, le, lt, eq, prefix, like
              (a trailing ``%`` only), in (``value`` a list of values or
              draws); ge, gt, le and lt compare strings by dictionary
              order;
  ``cycle``   ``[kind, count]`` pairs: the stream repeats one cycle whose
              counts are the mix's shares, each kind spread evenly over it.

The kind of query ``i`` is fixed by its place in the cycle; the seed draws
only each query's parameters (its own generator, keyed by the seed and
``i``), so every seed sends the same work in other values.  A value is a
literal or a draw: ``{"int": [a, b]}`` (integer in [a, b)), ``{"uniform":
[a, b]}``, ``{"lognormal": [median, sigma]}``, ``{"choice": [...]}``,
``{"fig6_k": {"positive": bool}}`` (the Fig. 6 LIMIT k), ``{"var": name}``,
``{"maybe": p, "value": draw}`` (else 0); then optional ``cap`` (min),
``scale`` (times), ``add`` (plus) and ``floor`` (down to a multiple), in
that order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .gen import rng_for, sample_limit_k

Constraint = Tuple[str, str, object]          # (column, op, value)
Join = Tuple[str, str, str, str]              # build, probe, build_key,
                                              # probe_key


@dataclasses.dataclass
class QuerySpec:
    """One query as the benchmark describes it, for the program (``to_port``)
    and the reference alike."""

    index: int
    kind: str
    scans: Dict[str, Tuple[str, List[Constraint]]]   # alias -> (table, pred)
    join: Optional[Join] = None                       # the one join
    limit: Optional[int] = None
    offset: int = 0
    order_by: Optional[Tuple[str, str, bool]] = None
    joins: Tuple[Join, ...] = ()                      # two or more

    @property
    def all_joins(self) -> Tuple[Join, ...]:
        return (self.join,) if self.join is not None else self.joins

    @property
    def cls(self) -> str:
        """filter | limit | join | topk: the stage that carries it."""
        if self.order_by is not None and not self.all_joins:
            return "topk"
        if self.all_joins:
            return "join"
        if self.limit is not None:
            return "limit"
        return "filter"

    @property
    def stages(self) -> Tuple[str, ...]:
        """The techniques that act on this query."""
        out = ["filter"]
        if self.limit is not None and self.order_by is None \
                and not self.all_joins:
            out.append("limit")
        if self.all_joins:
            out.append("join")
        if self.order_by is not None and self.limit is not None:
            out.append("topk")
        return tuple(out)


def kind_joins(kind: dict) -> Tuple[Optional[Join], Tuple[Join, ...]]:
    """A kind's ``(join, joins)`` as ``QuerySpec`` holds them: a ``joins``
    list of one is the one ``join``."""
    if "join" in kind and "joins" in kind:
        raise ValueError("a kind carries 'join' or 'joins', not both")
    if "join" in kind:
        return tuple(kind["join"]), ()
    joins = tuple(tuple(j) for j in kind.get("joins", ()))
    return (joins[0], ()) if len(joins) == 1 else (None, joins)


def draws_anything(kind: dict, preds: dict) -> bool:
    """Does a query of this kind draw from its generator?  A kind of
    literals alone needs none made (which is most of a set-up's planning
    time for such a kind)."""
    values = list(kind.get("vars", {}).values())
    values += [kind.get("limit"), kind.get("offset")]
    for s in kind["scans"].values():
        pred = s.get("pred", [])
        for c in preds[pred] if isinstance(pred, str) else pred:
            values += c["value"] if c["op"] == "in" else [c["value"]]
    return any(isinstance(v, dict) for v in values)


def make_cycle(mix: dict) -> List[str]:
    """The kind cycle: each kind's ``count`` slots spread evenly (slot j of
    a kind with count n sits at (j + 0.5) / n of the way through)."""
    marks = []
    for order, (kind, count) in enumerate(mix["cycle"]):
        if kind not in mix["kinds"]:
            raise KeyError(f"cycle names unknown kind {kind!r}")
        for j in range(int(count)):
            marks.append(((j + 0.5) / count, order, kind))
    return [k for _, _, k in sorted(marks)]


def draw(spec, rng: np.random.Generator, env: Dict[str, float]):
    if not isinstance(spec, dict):
        return spec
    if "var" in spec:
        v = env[spec["var"]]
    elif "int" in spec:
        v = int(rng.integers(*spec["int"]))
    elif "uniform" in spec:
        v = float(rng.uniform(*spec["uniform"]))
    elif "lognormal" in spec:
        median, sigma = spec["lognormal"]
        v = float(np.exp(rng.normal(np.log(median), sigma)))
    elif "choice" in spec:
        v = spec["choice"][int(rng.integers(len(spec["choice"])))]
    elif "fig6_k" in spec:
        v = sample_limit_k(rng)
        while spec["fig6_k"].get("positive") and v <= 0:
            v = sample_limit_k(rng)
    elif "maybe" in spec:
        v = (draw(spec["value"], rng, env) if rng.random() < spec["maybe"]
             else 0)
    else:
        raise ValueError(f"unknown draw {spec}")
    if "cap" in spec:
        v = min(v, spec["cap"])
    if "scale" in spec:
        v = v * spec["scale"]
    if "add" in spec:
        v = v + spec["add"]
    if "floor" in spec:
        q = spec["floor"]
        v = math.floor(v / q) * q
        if q == 1:
            v = int(v)
    return v


class Stream:
    """Query ``i`` of a seeded stream over a mix: ``spec(i)`` is the
    benchmark's description, which ``to_port`` turns into the program's
    ``Query``."""

    def __init__(self, mix: dict, seed: int, salt: int = 0):
        self.mix = mix
        self.seed = seed
        self.salt = salt
        self.cycle = make_cycle(mix)
        self.joins = {name: kind_joins(k) for name, k in mix["kinds"].items()}
        self.draws = {name: draws_anything(k, mix.get("preds", {}))
                      for name, k in mix["kinds"].items()}

    def kind(self, i: int) -> str:
        return self.cycle[i % len(self.cycle)]

    def spec_cls(self, i: int) -> str:
        """``QuerySpec.cls`` of query i, from its kind alone."""
        kind = self.kind(i)
        k = self.mix["kinds"][kind]
        join, joins = self.joins[kind]
        return QuerySpec(i, "", {}, join, 0 if "limit" in k else None, 0,
                         tuple(k["order_by"]) if "order_by" in k else None,
                         joins).cls

    def spec(self, i: int) -> QuerySpec:
        kind = self.kind(i)
        k = self.mix["kinds"][kind]
        rng = (rng_for(self.seed, 0x7AFF1C, self.salt, i)
               if self.draws[kind] else None)
        env: Dict[str, float] = {}
        for name in sorted(k.get("vars", {})):
            env[name] = draw(k["vars"][name], rng, env)
        scans = {}
        for alias, s in k["scans"].items():
            pred = s.get("pred", [])
            if isinstance(pred, str):
                pred = self.mix["preds"][pred]
            scans[alias] = (s["table"], [
                (c["col"], c["op"],
                 tuple(draw(v, rng, env) for v in c["value"])
                 if c["op"] == "in" else draw(c["value"], rng, env))
                for c in pred])
        limit = draw(k["limit"], rng, env) if "limit" in k else None
        if limit is not None and "cap" in k:
            limit = min(limit, k["cap"])
        offset = int(draw(k.get("offset", 0), rng, env))
        join, joins = self.joins[kind]
        return QuerySpec(
            index=i, kind=kind, scans=scans, join=join,
            limit=None if limit is None else int(limit), offset=offset,
            order_by=tuple(k["order_by"]) if "order_by" in k else None,
            joins=joins)


def port_pred(cons: List[Constraint]):
    """A constraint list as the program's predicate expression."""
    from repro_torch.core import expr as E

    parts = []
    for col, op, v in cons:
        c = E.col(col)
        if op == "ge":
            parts.append(c >= v)
        elif op == "gt":
            parts.append(c > v)
        elif op == "le":
            parts.append(c <= v)
        elif op == "lt":
            parts.append(c < v)
        elif op == "eq":
            parts.append(c == E.lit(v))
        elif op == "prefix":
            parts.append(E.startswith(c, v))
        elif op == "like":
            parts.append(E.like(c, v))
        elif op == "in":
            parts.append(E.in_(c, v))
        else:
            raise ValueError(f"unknown op {op!r}")
    return E.and_(*parts) if parts else E.true()


def to_port(q: QuerySpec, tables: dict):
    """The program's ``Query`` for a spec, over its ``Table`` objects: one
    join as ``Query.join``, several as ``Query.joins``, which a program
    without that field cannot take."""
    from repro_torch.core.flow import JoinSpec, Query, TableScanSpec

    scans = {alias: TableScanSpec(tables[t], port_pred(cons))
             for alias, (t, cons) in q.scans.items()}
    joins = {}
    if q.joins:
        if "joins" not in {f.name for f in dataclasses.fields(Query)}:
            raise TypeError(
                f"query {q.index} ({q.kind}) has {len(q.joins)} joins, and "
                f"the program's Query has no field 'joins' (Query.joins)")
        joins["joins"] = [JoinSpec(*j) for j in q.joins]
    return Query(scans=scans,
                 join=None if q.join is None else JoinSpec(*q.join),
                 limit=q.limit, offset=q.offset,
                 order_by=q.order_by, **joins)
