"""SimPoint trace window (port of ``shrewd_tpu/trace/format.py``).

A ``Trace`` is the recorded dynamic-µop window plus the machine state it
starts from, struct-of-arrays with fixed shapes.  It holds numpy arrays on
the host; ``ops.replay.TraceArrays.from_trace`` moves it to a device.
``save`` / ``load`` write and read the reference's ``.npz`` layout (one
file per window with a JSON metadata blob), so a window saved by either
package loads in the other.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np

from shrewd_tpu_torch.isa import uops as U

FORMAT_VERSION = 1


class Trace(NamedTuple):
    """A dynamic µop window plus the machine state it starts from."""

    opcode: np.ndarray    # int32[n]
    dst: np.ndarray       # int32[n]   destination register index
    src1: np.ndarray      # int32[n]
    src2: np.ndarray      # int32[n]
    imm: np.ndarray       # uint32[n]
    taken: np.ndarray     # int32[n]   golden branch outcome (0: no branch)
    init_reg: np.ndarray  # uint32[nphys]  register file at window start
    init_mem: np.ndarray  # uint32[mem_words]  memory image at window start

    @property
    def n(self) -> int:
        return int(self.opcode.shape[0])

    @property
    def nphys(self) -> int:
        return int(self.init_reg.shape[0])

    @property
    def mem_words(self) -> int:
        return int(self.init_mem.shape[0])

    def validate(self) -> None:
        n = self.n
        for name in ("dst", "src1", "src2", "imm", "taken"):
            arr = getattr(self, name)
            if arr.shape != (n,):
                raise ValueError(f"{name}: shape {arr.shape} != ({n},)")
        if not ((self.opcode >= 0) & (self.opcode < U.N_OPCODES)).all():
            raise ValueError("opcode out of range")
        for name in ("dst", "src1", "src2"):
            arr = getattr(self, name)
            if not ((arr >= 0) & (arr < self.nphys)).all():
                raise ValueError(f"{name} register index out of range")
        # the replay kernels compare effective control flow against `taken`
        # unconditionally, which requires taken == 0 on every non-branch row
        if self.taken[~U.is_branch(self.opcode)].any():
            raise ValueError("taken must be 0 on non-branch µops")
        if self.nphys & (self.nphys - 1):
            raise ValueError("nphys must be a power of two")
        if self.mem_words & (self.mem_words - 1):
            raise ValueError("mem_words must be a power of two")


def save(path, trace: Trace, meta: dict | None = None) -> None:
    trace.validate()
    meta = dict(meta or {})
    meta["format_version"] = FORMAT_VERSION
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f: getattr(trace, f) for f in Trace._fields},
    )


def load(path) -> tuple[Trace, dict]:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"trace format version {meta.get('format_version')} != "
                f"{FORMAT_VERSION} (regenerate or write an upgrader, the "
                f"cpt_upgraders analog)")
        trace = Trace(**{f: z[f] for f in Trace._fields})
    trace.validate()
    return trace, meta
