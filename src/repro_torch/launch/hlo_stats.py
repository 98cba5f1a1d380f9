"""Parse collective traffic out of compiled HLO text — a copy of
``repro/launch/hlo_stats.py`` (regex over text, no framework), held to it
by ``tests/test_torch_launch.py``.

``cost_analysis()`` reports FLOPs and bytes but not collective bytes; we
recover them by scanning the (post-SPMD-partitioning) HLO for
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute
instructions and summing their *operand* sizes (per the spec). Its
consumer in the port is the dry run of ROADMAP Queue A item 11c.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# one instruction definition: %name = <type> opcode(...)
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^)]*\))|(?:[\w\[\],{}\s/]*?))\s+([\w\-]+)(?:\.\d+)?\(([^)]*)",
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Bytes of one HLO type string, incl. tuples '(f32[2,3], bf16[4])'."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        numel = 1
        if dims:
            for d in dims.split(","):
                if d:
                    numel *= int(d)
        total += numel * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    count_by_kind: dict = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> dict:
        return {
            k: {"count": self.count_by_kind[k], "bytes": self.bytes_by_kind[k]}
            for k in sorted(self.bytes_by_kind)
        }


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Sum operand bytes of every collective op in the HLO module text.

    Operand shapes are resolved through a name->type map built from all
    instruction definitions (operand references carry no shapes inline).
    Instructions inside while-loop bodies appear once; scan trip counts are
    NOT multiplied in (we report per-HLO-occurrence bytes and scale by layer
    count analytically in the roofline — see benchmarks/roofline.py)."""
    types: dict[str, str] = {}
    pending: list[tuple[str, str]] = []  # (opcode, operand list str)
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, type_str, opcode, operands = m.groups()
        types[name] = type_str
        base_op = opcode.split(".")[0]
        if base_op in _COLLECTIVES:
            pending.append((base_op, operands))
    stats = CollectiveStats()
    opnd_re = re.compile(r"%?([\w.\-]+)")
    for op, operands in pending:
        total = 0
        for token in operands.split(","):
            token = token.strip()
            m = opnd_re.match(token)
            if not m:
                continue
            opname = m.group(1)
            if opname in types:
                total += _shape_bytes(types[opname])
            else:
                # inline-typed operand, e.g. 'f32[8,16] %foo'
                total += _shape_bytes(token)
        stats.bytes_by_kind[op] += total
        stats.count_by_kind[op] += 1
    return stats


def top_ops_by_bytes(hlo_text: str, k: int = 25) -> list[tuple[str, int, int]]:
    """Rank opcodes by total (operand+output) bytes across the module —
    the dry-run 'profile' used by the §Perf hypothesis loop.
    Returns [(opcode, count, bytes)]."""
    types: dict[str, str] = {}
    per_op: dict[str, list[int]] = defaultdict(lambda: [0, 0])
    instrs = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, type_str, opcode, operands = m.groups()
        types[name] = type_str
        instrs.append((opcode.split(".")[0], type_str, operands))
    opnd_re = re.compile(r"%?([\w.\-]+)")
    for opcode, type_str, operands in instrs:
        total = _shape_bytes(type_str)
        for token in operands.split(","):
            token = token.strip()
            m = opnd_re.match(token)
            if m and m.group(1) in types:
                total += _shape_bytes(types[m.group(1)])
        per_op[opcode][0] += 1
        per_op[opcode][1] += total
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][1])[:k]
    return [(op, c, b) for op, (c, b) in ranked]


@dataclass
class LaunchStats:
    """Kernel-launch census of one compiled HLO module (the hot-path bench's
    fusion-win metric: fewer fusions + custom-calls per step = fewer device
    launches per edit)."""
    fusions: int = 0
    custom_calls: int = 0  # Pallas kernels and library calls land here
    collectives: int = 0
    instructions: int = 0

    @property
    def launches(self) -> int:
        """Device-program launches the module implies: every fusion and
        every custom-call is (at least) one kernel on the accelerator
        timeline. Elementwise ops outside fusions are compiled into the
        surrounding computation on CPU/TPU, so this is the stable,
        backend-portable count."""
        return self.fusions + self.custom_calls

    def summary(self) -> dict:
        return {"fusions": self.fusions, "custom_calls": self.custom_calls,
                "collectives": self.collectives,
                "instructions": self.instructions, "launches": self.launches}


def launch_stats(hlo_text: str) -> LaunchStats:
    """Count fusion/custom-call/collective instructions across the module.

    Operates on the same ``_INSTR_RE`` parse as ``collective_stats`` —
    post-optimization HLO (``compiled.as_text()``), where every residual
    op boundary is explicit. Deterministic for a fixed jax/XLA version:
    the hot-path bench gates on these counts with ``must_equal``-style
    identity, re-anchored when the compiler version moves."""
    st = LaunchStats()
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        opcode = m.group(3).split(".")[0]
        st.instructions += 1
        if opcode == "fusion":
            st.fusions += 1
        elif opcode == "custom-call":
            st.custom_calls += 1
        elif opcode in _COLLECTIVES:
            st.collectives += 1
    return st


def while_trip_counts(hlo_text: str) -> list[int]:
    """Best-effort extraction of scan/while trip counts (for scaling
    per-iteration collective bytes to whole-model traffic)."""
    out = []
    for m in re.finditer(r"trip_count[=:\"]+(\d+)", hlo_text):
        out.append(int(m.group(1)))
    return out
