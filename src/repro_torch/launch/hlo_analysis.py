"""Post-optimization HLO text analyzer: loop-aware FLOPs / traffic /
collective accounting.

XLA's ``compiled.cost_analysis()`` counts while-loop bodies ONCE — a
scan-over-layers train step under-reports by ~n_layers x accum.  This
analyzer parses the compiled HLO, extracts every while-loop trip count from
its condition computation, and propagates multipliers through the call
graph (while bodies, fusions, calls, conditionals), so the roofline terms
reflect what actually executes.

  flops       — dot ops: 2 * prod(out) * prod(contracting dims)
  traffic     — per materializing op (fusion/dot/copy/collectives/slices):
                sum of operand + output bytes (an HBM model: fusion
                internals are on-chip and not counted)
  collectives — per kind, output bytes * multiplier ("-start" variants
                counted, "-done" skipped)
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COMP_HEADER = re.compile(r"^(?:ENTRY )?%?([\w.\-]+)(?:\.\d+)? \(.*\) -> .* \{")
_SHAPE = re.compile(r"(\w+)\[([0-9,]*)\]")
_OP = re.compile(
    r"^\s*(?:ROOT )?%([\w.\-]+) = ((?:\([^)]*\))|(?:\w+\[[0-9,]*\][^\s]*))\s+"
    r"([\w\-]+)\(")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_BODY = re.compile(r"body=%?([\w.\-]+)")
_COND = re.compile(r"condition=%?([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")
_OPERAND = re.compile(r"%([\w.\-]+)")
_CONST_INT = re.compile(r"constant\((\d+)\)")

TRAFFIC_OPS = {
    "fusion", "dot", "copy", "convert", "all-gather", "all-reduce",
    "reduce-scatter", "all-to-all", "collective-permute", "dynamic-slice",
    "dynamic-update-slice", "scatter", "gather", "transpose", "reduce",
    "sort", "all-gather-start", "all-reduce-start", "collective-permute-start",
    "concatenate", "pad", "slice", "reshape", "iota", "select",
}
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(type_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str) -> list[int]:
    m = _SHAPE.search(type_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


@dataclass
class Op:
    name: str
    type_str: str
    opcode: str
    line: str


@dataclass
class Computation:
    name: str
    ops: list = field(default_factory=list)
    symbols: dict = field(default_factory=dict)    # name -> type_str


def parse_computations(hlo: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    entry_name = None
    for line in hlo.splitlines():
        if line.startswith(("ENTRY", "%")) and "->" in line and line.rstrip().endswith("{"):
            name = line.split("(")[0].replace("ENTRY", "").strip().lstrip("%").strip()
            cur = Computation(name)
            comps[name] = cur
            if line.startswith("ENTRY"):
                entry_name = name
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is None:
            continue
        om = _OP.match(line)
        if om:
            name, type_str, opcode = om.groups()
            cur.ops.append(Op(name, type_str, opcode, line.strip()))
            cur.symbols[name] = type_str
    comps["__entry__"] = comps.get(entry_name, Computation("none"))
    return comps


def _dot_flops(op: Op, comp: Computation) -> float:
    out_dims = _shape_dims(op.type_str)
    out_elems = 1
    for d in out_dims:
        out_elems *= d
    m = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", op.line)
    inner = op.line.split("(", 1)[1]
    operands = _OPERAND.findall(inner.split(")", 1)[0])
    k = 1
    if m and operands:
        lhs_type = comp.symbols.get(operands[0], "")
        lhs_dims = _shape_dims(lhs_type)
        for ci in (m.group(1).split(",") if m.group(1) else []):
            ci = int(ci)
            if ci < len(lhs_dims):
                k *= lhs_dims[ci]
    return 2.0 * out_elems * k


def _trip_count(cond: Computation) -> int:
    """Largest integer constant compared in the loop condition."""
    best = 1
    for op in cond.ops:
        if op.opcode == "compare":
            pass
    for op in cond.ops:
        for c in _CONST_INT.findall(op.line):
            best = max(best, int(c))
    return best


def _op_operand_bytes(op: Op, comp: Computation) -> int:
    inner = op.line.split("(", 1)[1]
    operands = _OPERAND.findall(inner.split(")", 1)[0])
    total = 0
    for o in operands:
        t = comp.symbols.get(o)
        if t:
            total += _shape_bytes(t)
    return total


class HloCost:
    def __init__(self, hlo: str):
        self.comps = parse_computations(hlo)
        self._memo: dict[str, tuple] = {}
        entry = self.comps["__entry__"]
        self.flops, self.traffic, colls = self._visit(entry.name)
        self.collective_bytes: dict[str, float] = dict(colls)

    def _visit(self, comp_name: str) -> tuple:
        if comp_name in self._memo:
            return self._memo[comp_name]
        comp = self.comps.get(comp_name)
        if comp is None:
            return (0.0, 0.0, {})
        flops = 0.0
        traffic = 0.0
        colls: dict[str, float] = defaultdict(float)
        self._memo[comp_name] = (0.0, 0.0, {})   # cycle guard
        for op in comp.ops:
            if op.opcode == "dot":
                flops += _dot_flops(op, comp)
                traffic += _op_operand_bytes(op, comp) + _shape_bytes(op.type_str)
            elif op.opcode == "while":
                body = _BODY.search(op.line)
                cond = _COND.search(op.line)
                trips = 1
                if cond and cond.group(1) in self.comps:
                    trips = _trip_count(self.comps[cond.group(1)])
                if body:
                    bf, bt, bc = self._visit(body.group(1))
                    flops += trips * bf
                    traffic += trips * bt
                    for k, v in bc.items():
                        colls[k] += trips * v
            elif op.opcode in ("fusion", "call", "async-start"):
                cm = _CALLS.search(op.line)
                if cm:
                    cf, ct, cc = self._visit(cm.group(1))
                    flops += cf
                    # fusion internals are on-chip: count boundary traffic
                    traffic += _op_operand_bytes(op, comp) + _shape_bytes(op.type_str)
                    for k, v in cc.items():
                        colls[k] += v
            elif op.opcode == "conditional":
                bm = _BRANCHES.search(op.line)
                if bm:
                    branch_costs = [self._visit(b.strip().lstrip("%"))
                                    for b in bm.group(1).split(",")]
                    if branch_costs:
                        bf = max(c[0] for c in branch_costs)
                        bt = max(c[1] for c in branch_costs)
                        flops += bf
                        traffic += bt
            else:
                base = op.opcode.replace("-start", "")
                if base in COLLECTIVE_KINDS:
                    colls[base] += _shape_bytes(op.type_str)
                    traffic += _shape_bytes(op.type_str)
                elif op.opcode in TRAFFIC_OPS:
                    traffic += _op_operand_bytes(op, comp) + \
                        _shape_bytes(op.type_str)
        out = (flops, traffic, dict(colls))
        self._memo[comp_name] = out
        return out


def analyze(hlo_text: str) -> dict:
    c = HloCost(hlo_text)
    return {
        "flops": c.flops,
        "traffic_bytes": c.traffic,
        "collective_bytes": c.collective_bytes,
    }
