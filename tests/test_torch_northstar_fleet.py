"""The port's north-star fleet arm and entry point against the JAX
package's, on the CPU.

``_run_fleet`` of ``shrewd_tpu_torch/tools/northstar.py`` and of the repo's
``tools/northstar.py`` (imported by path) run the rotmix sweep of
``test_torch_northstar.py`` (one SimPoint window from ONE ptrace capture,
regfile and latch, ±0.05, at most 1024 trials) as a fleet: batch 128,
``sync_every`` 2, depth budget 2. The tenant rows, ``fleet_ticks`` and
``fairness_index`` must be equal (``min_trials`` floors at 1000, so every
campaign runs to its cap of 1024 trials); ``exec_cache`` is the port's
kernel registry, not the reference's executable cache (ROADMAP Queue 3 D5),
and is compared with nothing. ``main`` with ``--fleet --also-serial
--platform cpu`` writes its three documents where ``--out``,
``--fleet-out`` and ``--bench-out`` say, and ``--fleet`` without a
baseline exits 2 before any work.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import json
import tempfile

import pytest

from shrewd_tpu_torch.tools import northstar

from test_torch_lift import needs_toolchain
from test_torch_northstar import (WORKLOAD, captures, ref_ns,  # noqa: F401
                                  scrub, sweep_args, windows)
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

pytestmark = needs_toolchain

# main's flags: the rotmix sweep, regfile alone and capped at 512 trials
# (on the CPU each batch walks the whole window: ~1.7 s a call)
FLAGS = ["--workloads", WORKLOAD, "--structures", "regfile", "--k", "1",
         "--halfwidth", "0.05", "--batch", "256", "--max-trials", "512",
         "--fleet-batch", "128", "--sync-every", "2", "--depth-budget", "2",
         "--platform", "cpu"]


@pytest.fixture(scope="module")
def fleet_docs(windows, ref_ns, tmp_path_factory):  # noqa: F811
    """(port, reference) fleet documents; the reference spills its
    windows into a directory of the test's, not the system's."""
    got, ref = windows
    a = sweep_args()
    spool = tmp_path_factory.mktemp("ref_spool")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "mkdtemp", lambda prefix="": str(spool))
        ref_doc = ref_ns._run_fleet(a, ref)
    return northstar._run_fleet(a, got), ref_doc


def test_fleet_arm_equals_the_reference(fleet_docs):
    got, ref = fleet_docs
    assert got["rc"] == ref["rc"] == 0
    assert got["fleet_ticks"] == ref["fleet_ticks"]
    assert got["fairness_index"] == ref["fairness_index"]
    assert scrub({k: v for k, v in got.items() if k != "exec_cache"}) == \
        scrub({k: v for k, v in ref.items() if k != "exec_cache"})
    assert got["tenants"] == got["campaigns"] == 2


@pytest.mark.parametrize("structure", ["regfile", "latch"])
def test_fleet_tenant_rows_equal_the_reference(fleet_docs, structure):
    got, ref = (d["workloads"][WORKLOAD]["structures"][structure]
                for d in fleet_docs)
    assert got["tenants"] == ref["tenants"]
    assert got["weighted_avf"] == ref["weighted_avf"]
    (row,) = got["tenants"]
    assert row["status"] == "complete"
    assert row["trials"] == 1024


def test_fleet_exec_cache_is_the_kernel_registry(fleet_docs):
    assert sorted(fleet_docs[0]["exec_cache"]) == [
        "compiled", "evicted", "refused", "reused"]


def test_main_fleet_also_serial_writes_three_documents(tmp_path, capsys):
    out, fleet_out, bench_out = (tmp_path / f"{n}.json" for n in
                                 ("serial", "fleet", "bench"))
    assert northstar.main([*FLAGS, "--fleet", "--also-serial", "--out",
                           str(out), "--fleet-out", str(fleet_out),
                           "--bench-out", str(bench_out)]) == 0
    serial, fleet, bench = (json.loads(p.read_text())
                            for p in (out, fleet_out, bench_out))
    assert serial["campaigns"] == fleet["campaigns"] == 1
    assert serial["total_trials"] == fleet["total_trials"] == 512
    assert fleet["serial_wall_clock_s"] == serial["total_wall_clock_s"]
    assert fleet["serial_source"].startswith("measured")
    assert bench["serial_trials"] == serial["total_trials"]
    assert bench["fleet_trials"] == fleet["total_trials"]
    assert bench["platform"] == "cpu" and bench["card"] is None
    assert bench["config"]["fleet_batch"] == 128
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["speedup"] == fleet["speedup_vs_serial"]


def test_main_fleet_without_a_baseline_exits_2(tmp_path, capsys):
    assert northstar.main([*FLAGS, "--fleet", "--fleet-out",
                           str(tmp_path / "f.json")]) == 2
    assert "--serial-baseline" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
