"""The Simulator: exit events → user generators (the port of
``shrewd_tpu/sim/simulator.py``, over the port's ``Orchestrator``).

The reference's stdlib ``Simulator`` (``python/gem5/simulate/simulator.py:58``,
``run()`` at ``:530``) maps each typed exit event to a user-supplied Python
*generator*; yielding ``True`` stops the run, ``False``/``None`` continues
(``simulator.py:208``; SURVEY §A.4 calls this the public automation API to
keep). This class preserves that protocol over the campaign orchestrator's
event stream.

    sim = Simulator(plan, outdir="m5out", on_exit_event={
        ExitEvent.BATCH_COMPLETE: my_progress_gen(),
        ExitEvent.CI_CONVERGED: my_result_gen(),
    })
    sim.run()
"""

from __future__ import annotations

from typing import Generator, Iterable, Mapping

from shrewd_tpu_torch.sim.exit_event import ExitEvent


class Simulator:
    def __init__(self, plan, mesh=None, outdir: str | None = None,
                 on_exit_event: Mapping[ExitEvent, Iterable] | None = None,
                 device=None):
        """``mesh`` and ``device`` as the ``Orchestrator``'s: every visible
        card by default, the CPU with ``device="cpu"``."""
        # deferred import: campaign.orchestrator imports sim.exit_event, so a
        # module-level import here would close an import cycle
        from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
        self.orchestrator = Orchestrator(plan, mesh=mesh, outdir=outdir,
                                         device=device)
        self._handlers: dict[ExitEvent, Generator] = {}
        for ev, gen in (on_exit_event or {}).items():
            self._handlers[ev] = iter(gen)  # accept generators or iterables
        self.last_event: ExitEvent | None = None
        self.last_payload: object = None

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, mesh=None,
                        outdir: str | None = None,
                        on_exit_event=None, device=None) -> "Simulator":
        from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
        sim = cls.__new__(cls)
        sim.orchestrator = Orchestrator.resume(ckpt_dir, mesh=mesh,
                                               outdir=outdir, device=device)
        sim._handlers = {}
        for ev, gen in (on_exit_event or {}).items():
            sim._handlers[ev] = iter(gen)
        sim.last_event = None
        sim.last_payload = None
        return sim

    def run(self) -> dict:
        """Drive the campaign to completion or to the first handler that
        yields True. Returns results collected so far."""
        for event, payload in self.orchestrator.events():
            self.last_event, self.last_payload = event, payload
            handler = self._handlers.get(event)
            if handler is None:
                continue
            try:
                # the payload is available to handlers via self.last_payload,
                # matching the reference where generators consult the
                # simulator object rather than receiving arguments
                stop = next(handler)
            except StopIteration:
                del self._handlers[event]  # exhausted handlers fall back
                continue
            if stop:
                break
        self.orchestrator.write_outputs()
        return dict(self.orchestrator.results)
