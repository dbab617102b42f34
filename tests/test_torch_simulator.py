"""The port's ``Simulator`` (the exit-event automation API,
``sim/simulator.py``) against the JAX package's, on the CPU.

A ``Simulator`` whose handler stops the run at the first checkpoint
(after the first batch, ``checkpoint_every=1``) returns what it has so
far and writes its outputs; ``Simulator.from_checkpoint`` then runs the
campaign to its end.  Both packages give the same last event, the same
partial and final results, and the uninterrupted run's result, and
either package's checkpoint continues in the other.

Module fixture: R1 and R4, as in ``test_torch_orchestrator.py``.
"""

import os

import pytest

from shrewd_tpu.sim import ExitEvent as RefEvent
from shrewd_tpu.sim import Simulator as RefSimulator
from shrewd_tpu_torch.sim import ExitEvent, Simulator
from shrewd_tpu_torch.ingest.statsfile import load_stats_txt
from test_torch_orchestrator import (_reference_on_jax_09,  # noqa: F401
                                     mesh, port_plan, result_key, tiny_plan)


def _stop_at_first():
    """A handler: stop at the first event it sees."""
    yield True


def _plan():
    return tiny_plan("serial", stratify=True, checkpoint_every=1)


def _results(results):
    return sorted((k, result_key(r)) for k, r in results.items())


def _first_leg(pkg, outdir, mesh):
    if pkg == "reference":
        sim = RefSimulator(_plan(), mesh=mesh, outdir=outdir,
                           on_exit_event={RefEvent.CHECKPOINT:
                                          _stop_at_first()})
    else:
        sim = Simulator(port_plan(_plan()), outdir=outdir, device="cpu",
                        on_exit_event={ExitEvent.CHECKPOINT:
                                       _stop_at_first()})
    partial = sim.run()
    return sim, partial


@pytest.mark.parametrize("second", ["reference", "port"])
def test_stop_then_from_checkpoint_equals_reference(tmp_path, mesh, second):
    legs = {}
    for pkg in ("reference", "port"):
        out = str(tmp_path / pkg)
        sim, partial = _first_leg(pkg, out, mesh)
        legs[pkg] = (sim.last_event.name, sim.last_payload, partial, out)
    assert legs["port"][0] == legs["reference"][0] == "CHECKPOINT"
    assert os.path.basename(legs["port"][1]) == \
        os.path.basename(legs["reference"][1])
    assert _results(legs["port"][2]) == _results(legs["reference"][2])
    blocks = load_stats_txt(os.path.join(legs["port"][3], "stats.txt"))
    assert blocks[0]["campaign.w0.regfile.trials"] == 32
    # continue the port's first leg in ``second``, and the reference's in
    # the port
    ckpt = os.path.join(legs["port"][3], "campaign_ckpt")
    if second == "reference":
        rest = RefSimulator.from_checkpoint(ckpt, mesh=mesh)
    else:
        rest = Simulator.from_checkpoint(ckpt, device="cpu")
    final = rest.run()
    cross = Simulator.from_checkpoint(
        os.path.join(legs["reference"][3], "campaign_ckpt"),
        outdir=str(tmp_path / "cross"), device="cpu").run()
    whole = RefSimulator(_plan(), mesh=mesh).run()
    assert _results(final) == _results(cross) == _results(whole)
    assert len(whole) == 2 and rest.last_event.name == "CAMPAIGN_COMPLETE"
    assert os.path.exists(tmp_path / "cross" / "stats.json")


def test_exhausted_handler_falls_back_and_runs_to_the_end(mesh):
    """A handler that runs out of values is dropped; the run goes on."""
    def twice():
        yield False
        yield False

    mine = Simulator(port_plan(_plan()), device="cpu",
                     on_exit_event={ExitEvent.BATCH_COMPLETE: twice()})
    ref = RefSimulator(_plan(), mesh=mesh,
                       on_exit_event={RefEvent.BATCH_COMPLETE: twice()})
    assert _results(mine.run()) == _results(ref.run())
    assert mine.last_event is ExitEvent.CAMPAIGN_COMPLETE
    assert ExitEvent.BATCH_COMPLETE not in mine._handlers
