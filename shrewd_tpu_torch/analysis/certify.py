"""Certify the port's standard campaign steps (the port of
``shrewd_tpu/analysis/certify.py``).

The acceptance surface of the step auditor (``analysis/step_audit.py``):
build the step shapes every campaign dispatches — the dense per-batch
step, the hybrid (budgeted device-resolution) step and the stratified step,
each with its pipelined interval step and its until-CI step — over a small
synthetic window, run each once under the auditor, and certify the
replay-safety rules at the ONE-transfer budget.  Plus two deliberately
*violating* steps, an interval and an until-CI loop that read the running
tally to the host inside the loop body (where the reference smuggles in a
``jax.debug.print``), which the auditor must reject: a certifier that
cannot fail is not evidence.

Used by ``python -m shrewd_tpu_torch.tools.graftlint``, ``chip_smoke.py``
and the tests.  Each certificate costs one call of its step.
"""

from __future__ import annotations

from shrewd_tpu_torch.analysis.step_audit import audit_callable

#: (name, replay_kernel mode, stratify) for the standard per-batch steps
STANDARD_STEPS = (
    ("dense", "dense", False),
    ("hybrid", "hybrid", False),
    ("stratified", "hybrid", True),
)


def _probe_campaigns(device=None):
    """One tiny-window campaign per standard step shape (the reference's
    probe geometry: small enough that the golden pass is quick, big
    enough to exercise every code path), on ``device`` (the card by
    default)."""
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.parallel.campaign import ShardedCampaign
    from shrewd_tpu_torch.trace.synth import WorkloadConfig, generate

    tr = generate(WorkloadConfig(n=96, nphys=32, mem_words=64,
                                 working_set_words=32, seed=7))
    out = []
    for name, mode, stratify in STANDARD_STEPS:
        kernel = TrialKernel(tr, O3Config(replay_kernel=mode), device=device)
        out.append((name, ShardedCampaign(kernel, None, "regfile",
                                          stratify=stratify)))
    return out


def _structure_key(camp):
    from shrewd_tpu_torch.utils import prng

    return prng.structure_key(prng.simpoint_key(
        prng.campaign_key(0, camp.kernel.device), 0), 0)


def _batch_args(camp, B: int):
    from shrewd_tpu_torch.utils import prng

    return (prng.trial_keys(prng.batch_key(_structure_key(camp), 0), B),)


def _interval_args(camp, S: int, B: int):
    from shrewd_tpu_torch.utils import prng

    sk = _structure_key(camp)
    return ([prng.trial_keys(prng.batch_key(sk, b), B) for b in range(S)],)


def _until_ci_args(camp, S: int, B: int):
    """Example args of the until-CI step: the staged key list plus the
    cumulative state and stopping parameters (initial tallies [+ strata],
    trials so far, minimum trials, target half-width, confidence)."""
    import numpy as np

    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops.trial import N_STRATA

    strat0 = (np.zeros((N_STRATA, C.N_OUTCOMES), np.int64)
              if camp.stratify else None)
    return (_interval_args(camp, S, B)[0],
            np.zeros(C.N_OUTCOMES, np.int64), strat0, 0, 1000, 0.01, 0.95)


def violating_until_ci_step(camp, S: int):
    """The until-CI seeded-violation fixture: the loop body reads the
    running tally to the host on every batch — a hidden host channel per
    iteration, so 1 + S transfers > the 1-per-super-interval budget.  The
    auditor MUST reject it."""
    import numpy as np
    import torch

    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.parallel import stopping
    from shrewd_tpu_torch.parallel.campaign import _to_host
    from shrewd_tpu_torch.utils import debug
    from shrewd_tpu_torch.utils import device as devmod

    kernel, structure = camp.kernel, camp.structure

    def broken(keys_list, tal0, strat0, trials0, min_trials, target,
               confidence):
        del strat0
        dev = kernel.device
        cum0 = torch.as_tensor(np.asarray(tal0), dtype=torch.int32,
                               device=dev)
        z = torch.tensor(stopping.z_value(float(confidence)),
                         dtype=torch.float32, device=dev)
        t = None
        for i, keys in enumerate(keys_list):
            tb, _ = kernel.tally_on_device(keys, structure)
            t = tb if t is None else t + tb
            debug.dprintf("CampaignStep", "tally=%s",
                          t.tolist())        # the smuggled side effect
            trials = int(trials0) + (i + 1) * int(keys.shape[0])
            cum = cum0 + t
            hw = stopping.wilson_halfwidth_device(
                cum[C.OUTCOME_SDC] + cum[C.OUTCOME_DUE],
                torch.full((), trials, dtype=torch.int32, device=dev), z)
            if trials >= int(min_trials):
                with devmod.host_sync("stop-flag"):
                    if bool(hw <= float(target)):
                        break
        return _to_host(t)[0]

    return broken


def violating_interval_step(camp, S: int):
    """The seeded-violation fixture: the interval step's loop body reads
    the running tally to the host — one hidden host channel per batch, so
    1 + S transfers > the 1-per-interval budget.  The auditor MUST reject
    it."""
    from shrewd_tpu_torch.parallel.campaign import _to_host
    from shrewd_tpu_torch.utils import debug

    kernel, structure = camp.kernel, camp.structure

    def broken(keys_list):
        t = None
        for keys in keys_list:
            tb, _ = kernel.tally_on_device(keys, structure)
            t = tb if t is None else t + tb
            debug.dprintf("CampaignStep", "tally=%s",
                          t.tolist())        # the smuggled side effect
        return _to_host(t)[0]

    return broken


def certify_standard_executables(transfer_budget: int = 1,
                                 batch_size: int = 32,
                                 sync_every: int = 4, device=None,
                                 sync_debug: bool = False) -> dict:
    """Certificates for every standard step + the violation fixtures'
    verdicts, on ``device`` (the card by default).  ``doc["ok"]`` means:
    every standard step certified clean AND both broken fixtures were
    rejected.  ``sync_debug=True`` (on the card) adds to each certificate
    torch's own count of synchronizing calls over the same call
    (``step_audit.audit_callable``)."""
    certs: dict[str, dict] = {}
    camps = _probe_campaigns(device)

    def audit(fn, args, kind):
        return audit_callable(fn, args, kind=kind,
                              transfer_budget=transfer_budget,
                              sync_debug=sync_debug)

    for name, camp in camps:
        certs[f"{name}/batch"] = audit(
            camp._build_batch_step(stratified=camp.stratify),
            _batch_args(camp, batch_size), f"{name}/batch")
        certs[f"{name}/interval"] = audit(
            camp._build_interval_step(sync_every),
            _interval_args(camp, sync_every, batch_size),
            f"{name}/interval")
        # the until-CI step: the whole super-interval — batches consumed,
        # half-widths evaluated, the exit decision — must certify at the
        # same ONE-transfer budget as the interval it extends
        certs[f"{name}/until_ci"] = audit(
            camp._build_until_ci_step(sync_every, strat_rule=camp.stratify),
            _until_ci_args(camp, sync_every, batch_size),
            f"{name}/until_ci")
    # pipelined-interval is the hybrid interval step (the engine's hot
    # path); alias it under the name the acceptance criteria use
    certs["pipelined/interval"] = certs["hybrid/interval"]
    # the fixtures that must FAIL
    _, dense_camp = camps[0]
    broken_cert = audit(violating_interval_step(dense_camp, sync_every),
                        _interval_args(dense_camp, sync_every, batch_size),
                        "fixture/broken-interval")
    fixture_rejected = not broken_cert["ok"]
    broken_ci_cert = audit(violating_until_ci_step(dense_camp, sync_every),
                           _until_ci_args(dense_camp, sync_every,
                                          batch_size),
                           "fixture/broken-until-ci")
    ci_fixture_rejected = not broken_ci_cert["ok"]
    ok = fixture_rejected and ci_fixture_rejected and all(
        c["ok"] and c["transfers"] <= transfer_budget
        for c in certs.values())
    return {
        "ok": ok,
        "transfer_budget": transfer_budget,
        "certificates": certs,
        "violation_fixture": broken_cert,
        "fixture_rejected": fixture_rejected,
        "until_ci_violation_fixture": broken_ci_cert,
        "until_ci_fixture_rejected": ci_fixture_rejected,
    }
