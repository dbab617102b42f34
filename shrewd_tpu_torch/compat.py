"""Carry the reference's inputs across to the port.

The system has no weights; what the JAX package and the port must share is
the input of a run: a trace window, a machine config, the per-trial PRNG
keys and fault coordinates.  Each function here takes them as the reference
hands them out, as numpy arrays (``np.asarray`` of jax arrays) or plain
dicts, and builds the port's object; the chunked path's window and carried
deviation sets also go back, as numpy arrays the reference takes.  The
fleet's documents (tenant specs, scenario matrices) pass as JSON, and the
protection search's schemes and profiles through their fields.  Nothing
here imports the reference.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from shrewd_tpu_torch.models.minor import MinorConfig
from shrewd_tpu_torch.models.o3 import Fault, O3Config
from shrewd_tpu_torch.models.timing import Scoreboard
from shrewd_tpu_torch.ops.window import TRACE_FIELDS, PreprocessedWindow
from shrewd_tpu_torch.trace.format import Trace
from shrewd_tpu_torch.utils.device import resolve as resolve_device

_TRACE_DTYPES = (("opcode", np.int32), ("dst", np.int32),
                 ("src1", np.int32), ("src2", np.int32),
                 ("imm", np.uint32), ("taken", np.int32),
                 ("init_reg", np.uint32), ("init_mem", np.uint32))


def trace_from_arrays(opcode, dst, src1, src2, imm, taken, init_reg,
                      init_mem) -> Trace:
    """A trace's eight arrays (the reference ``Trace``'s fields, in
    order) → the port's validated ``Trace``."""
    arrays = (opcode, dst, src1, src2, imm, taken, init_reg, init_mem)
    t = Trace(**{name: np.ascontiguousarray(np.asarray(x), dtype=dt)
                 for (name, dt), x in zip(_TRACE_DTYPES, arrays)})
    t.validate()
    return t


def config_from_dict(d: dict) -> O3Config:
    """A reference ``O3Config.to_dict()`` → the port's ``O3Config``."""
    return O3Config.from_dict(d)


def minor_config_from_dict(d: dict) -> MinorConfig:
    """A reference ``MinorConfig.to_dict()`` → the port's ``MinorConfig``."""
    return MinorConfig.from_dict(d)


def scoreboard_from_arrays(dispatch, issue, writeback, commit,
                           mispredict=None, wp_mass_rob=0, wp_mass_iq=0,
                           wp_mass_fu=0, wp_mass_lsq=0) -> Scoreboard:
    """A reference ``Scoreboard``'s fields, in order (``*sb``) → the
    port's, with int64 timestamp arrays."""
    def stamps(x):
        return np.asarray(x, dtype=np.int64)
    return Scoreboard(stamps(dispatch), stamps(issue), stamps(writeback),
                      stamps(commit),
                      None if mispredict is None
                      else np.asarray(mispredict, dtype=bool),
                      int(wp_mass_rob), int(wp_mass_iq), int(wp_mass_fu),
                      int(wp_mass_lsq))


def keys_from_key_data(key_data, device=None) -> torch.Tensor:
    """``jax.random.key_data(keys)`` (uint32 ``(..., 2)``) → the port's
    int64 key tensor, on ``device`` (``None``: the CUDA card)."""
    kd = np.asarray(key_data)
    if kd.dtype != np.uint32 or kd.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 (..., 2) key data, got "
                         f"{kd.dtype} {kd.shape}")
    return torch.as_tensor(kd.astype(np.int64),
                           device=resolve_device(device))


def fault_from_arrays(kind, cycle, entry, bit, shadow_u,
                      device=None) -> Fault:
    """Numpy fault fields (the reference ``Fault``'s, in order) → the
    port's ``Fault`` batch, on ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)

    def i32(x):
        return torch.as_tensor(np.array(x, dtype=np.int32).reshape(-1),
                               device=device)
    return Fault(kind=i32(kind), cycle=i32(cycle), entry=i32(entry),
                 bit=i32(bit),
                 shadow_u=torch.as_tensor(
                     np.array(shadow_u, dtype=np.float32).reshape(-1),
                     device=device))


def window_from_arrays(n: int, S: int, tr: dict, gb_reg, gb_mem,
                       trace_digest: str = "") -> PreprocessedWindow:
    """A reference ``PreprocessedWindow``'s ``n``, ``S``, padded ``tr``
    and boundary states → the port's window (host numpy, as the
    reference keeps them)."""
    gb_reg = np.ascontiguousarray(np.asarray(gb_reg), dtype=np.uint32)
    gb_mem = np.ascontiguousarray(np.asarray(gb_mem), dtype=np.uint32)
    return PreprocessedWindow(
        n=n, S=S, nphys=gb_reg.shape[1], mem_words=gb_mem.shape[1],
        trace_digest=trace_digest,
        tr={f: np.asarray(tr[f]) for f in TRACE_FIELDS},
        gb_reg=gb_reg, gb_mem=gb_mem)


def window_to_arrays(win: PreprocessedWindow) -> tuple[dict, np.ndarray,
                                                      np.ndarray]:
    """The port's window → ``(tr, gb_reg, gb_mem)`` as numpy arrays with
    the reference's dtypes (``tr`` int32 fields, ``imm`` and the states
    uint32)."""
    return ({f: np.asarray(win.tr[f]) for f in TRACE_FIELDS},
            np.asarray(win.gb_reg, np.uint32),
            np.asarray(win.gb_mem, np.uint32))


def sets_from_arrays(tags, vals, device=None) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Carried deviation sets in the reference's per-lane layout (``(B,
    k)`` int32 tags, uint32 values) → the port's ``(B, k)`` int64 pair, on
    ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    return (torch.as_tensor(np.asarray(tags).astype(np.int64),
                            device=device),
            torch.as_tensor(np.asarray(vals).astype(np.uint32)
                            .astype(np.int64), device=device))


def sets_to_arrays(tags: torch.Tensor, vals: torch.Tensor
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The port's carried sets → the reference's ``(B, k)`` int32 tags and
    uint32 values."""
    return (tags.cpu().numpy().astype(np.int32),
            vals.cpu().numpy().astype(np.uint32))


def tenant_spec_from_dict(doc: dict):
    """A reference ``TenantSpec.to_dict()`` (or its JSON) → the port's
    ``TenantSpec``: the document is the same in both packages."""
    from shrewd_tpu_torch.service.queue import TenantSpec

    return TenantSpec.from_dict(json.loads(json.dumps(doc)))


def matrix_from_dict(doc: dict):
    """A reference ``ScenarioMatrix.to_dict()`` (or its JSON) → the
    port's ``ScenarioMatrix``."""
    from shrewd_tpu_torch.scenario.matrix import ScenarioMatrix

    return ScenarioMatrix.from_dict(json.loads(json.dumps(doc)))


def scheme_from_fields(name, detect, correct, area, detect_sdc=None,
                       detect_due=None):
    """A reference ``Scheme``'s fields, in order (``*scheme``) → the
    port's ``Scheme``."""
    from shrewd_tpu_torch.search.protect import Scheme

    def opt(x):
        return None if x is None else float(x)
    return Scheme(str(name), float(detect), float(correct), float(area),
                  detect_sdc=opt(detect_sdc), detect_due=opt(detect_due))


def profile_from_fields(name, bits, probs, fit_per_bit=1.0e-3,
                        halfwidth=0.0):
    """A reference ``StructureProfile``'s fields, in order
    (``*profile``) → the port's, its probabilities as float64 numpy."""
    from shrewd_tpu_torch.search.protect import StructureProfile

    return StructureProfile(str(name), int(bits),
                            np.asarray(probs, dtype=np.float64),
                            float(fit_per_bit), float(halfwidth))
