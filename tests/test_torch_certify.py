"""The port's step auditor and ``certify`` against the JAX package's, on
the CPU.

Both packages' ``certify_standard_executables()`` certify the same steps
at ONE transfer and reject both violation fixtures; the port's auditor
catches a Generator RNG draw and an undeclared in-place write; a strict
refusal is sticky, warn never refuses, and warn does not downgrade an
installed strict auditor (the campaign layers: ``test_torch_certify_
campaign.py`` and ``test_torch_certify_cli.py``).

Under jax 0.9 the reference's auditor needs three aliases beside R1 and R4
(``test_torch_orchestrator.py``), set in a module fixture and undone after
it (ROADMAP Queue 3 R10): ``jax.core.ClosedJaxpr`` and ``jax.core.Jaxpr``
moved to ``jax._src.core``, and ``jax.debug.print`` is now the
``debug_print`` primitive, which the reference's ``CALLBACK_PRIMS`` does
not list — without it the reference certifies its own violation
fixtures."""

import jax
import pytest
import torch

import shrewd_tpu.analysis.jaxpr_audit as ref_audit
from shrewd_tpu.analysis.certify import \
    certify_standard_executables as ref_certify
from shrewd_tpu.parallel import exec_cache as ref_exec_cache
from shrewd_tpu_torch import analysis
from shrewd_tpu_torch.analysis import step_audit
from shrewd_tpu_torch.analysis.certify import certify_standard_executables
from shrewd_tpu_torch.parallel import ShardedCampaign
from shrewd_tpu_torch.parallel import campaign as campaign_mod
from shrewd_tpu_torch.parallel import exec_cache
from shrewd_tpu_torch.utils import device as devmod
from test_torch_campaign import _kernels, _keys, window  # noqa: F401
# the reference's R1/R4 fixture (autouse)
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401

@pytest.fixture(autouse=True, scope="module")
def _reference_audits_on_jax_09():
    """R10 (see the module docstring); undone after the module."""
    saved = {}
    for name in ("ClosedJaxpr", "Jaxpr"):
        if not hasattr(jax.core, name):
            saved[name] = True
            setattr(jax.core, name, getattr(jax._src.core, name))
    prims = ref_audit.CALLBACK_PRIMS
    ref_audit.CALLBACK_PRIMS = prims | {"debug_print"}
    yield
    ref_audit.CALLBACK_PRIMS = prims
    for name in saved:
        delattr(jax.core, name)


@pytest.fixture(autouse=True)
def _no_auditor_left():
    """Certification is process-wide: no test leaves an auditor behind."""
    yield
    exec_cache.clear_auditor()
    exec_cache.cache().clear()
    ref_exec_cache.clear_auditor()


@pytest.fixture(scope="module")
def standard_docs():
    torch.set_num_threads(1)
    return (certify_standard_executables(device="cpu"), ref_certify())


# --- the standard certificates ------------------------------------------------

def test_standard_certificates_agree_with_the_reference(standard_docs):
    port, ref = standard_docs
    assert set(port) == set(ref)
    assert set(port["certificates"]) == set(ref["certificates"])
    assert port["ok"] and ref["ok"]
    for name, cert in port["certificates"].items():
        want = ref["certificates"][name]
        assert set(want) <= set(cert), name
        assert cert["ok"] == want["ok"] is True, (name, cert["violations"])
        assert cert["transfers"] == want["transfers"] == 1, name
        assert cert["rng"] == {} and cert["donated_args"] == []
        assert cert["syncs"]["result"] == 1 and cert["n_eqns"] > 0


@pytest.mark.parametrize("fixture", ["violation_fixture",
                                     "until_ci_violation_fixture"])
def test_both_fixtures_are_rejected_in_both(standard_docs, fixture):
    """Each fixture fails on a side effect and on the transfer budget in
    both packages: 2 transfers in the reference (static), 1 + S in the
    port (one call: S = 4 batches, each read to the host)."""
    port, ref = standard_docs
    for doc in (port, ref):
        cert = doc[fixture]
        assert not cert["ok"]
        kinds = {v.split(":")[0] for v in cert["violations"]}
        assert kinds == {"side-effect", "transfer budget"}, cert
    assert ref[fixture]["transfers"] == 2
    assert port[fixture]["transfers"] == 1 + 4
    assert port[fixture]["callbacks"] == {"tolist": 4}
    assert port["fixture_rejected"] and port["until_ci_fixture_rejected"]


# --- the rules ----------------------------------------------------------------

def test_forbidden_rng_and_undeclared_mutation_detected():
    keys = torch.arange(8, dtype=torch.int64).reshape(4, 2)

    def rng_step(k):
        return (k + torch.randint(0, 2, k.shape)).sum()

    def mutating_step(k):
        k.add_(1)
        return k.sum()

    cert = step_audit.audit_callable(rng_step, (keys,), transfer_budget=1)
    assert not cert["ok"] and cert["rng"] == {"randint": 1}, cert
    assert cert["violations"][0].startswith("rng:")
    assert step_audit.primitive_census(rng_step, (keys,))["randint"] == 1
    cert = step_audit.audit_callable(mutating_step, (keys.clone(),))
    assert not cert["ok"] and cert["donated_args"] == [0], cert
    assert cert["violations"][0].startswith("donation:")
    cert = step_audit.audit_callable(mutating_step, (keys.clone(),),
                                     declared_donations=(0,))
    assert cert["ok"], cert
    # a host read is sanctioned inside the seam, a result copy counts
    def seamed(k):
        with devmod.host_sync("flag"):
            bool(k.sum() > 3)
        return campaign_mod._to_host(k)[0]

    cert = step_audit.audit_callable(seamed, (keys,))
    assert cert["ok"] and cert["transfers"] == 1, cert
    assert cert["syncs"] == {"flag": 1, "result": 1}


def _broken_step(k):
    return k.sum().item()


def test_strict_refusal_is_sticky():
    """A refused step stays refused for its key: the ledger re-raises
    without auditing again, and a campaign whose step reads the host
    raises before its batch is counted, every time."""
    ledger = exec_cache.cache()
    auditor = analysis.install_step_auditor("strict")
    key = ("batch", "sticky", None, "regfile", ())
    keys = torch.arange(8, dtype=torch.int64).reshape(4, 2)
    refused = ledger.refused
    for _ in range(2):
        with pytest.raises(exec_cache.AdmissionError) as e:
            ledger.audit(key, _broken_step, (keys,))
        assert e.value.certificate["callbacks"] == {"item": 1}
    assert auditor.audited == 1 and auditor.failed == 1
    assert ledger.refused == refused + 1


def test_strict_refusal_stops_a_campaign_before_its_tally(window,
                                                          monkeypatch):
    _, mk = _kernels(window)
    analysis.install_step_auditor("strict")
    tally_on_device = type(mk).tally_on_device

    def leaky(self, keys, structure, stratified=False):
        t, n = tally_on_device(self, keys, structure, stratified)
        int(n)                                  # an unmarked host read
        return t, n

    monkeypatch.setattr(type(mk), "tally_on_device", leaky)
    camp = ShardedCampaign(mk, None, "fu")
    for _ in range(2):
        with pytest.raises(exec_cache.AdmissionError):
            camp.tally_batch(_keys(3, 32)[1])
    assert camp.transfers == 0 and mk.taint_trials == 0


def test_warn_auditor_certifies_without_refusing():
    ledger = exec_cache.cache()
    auditor = analysis.install_step_auditor("warn")
    keys = torch.arange(8, dtype=torch.int64).reshape(4, 2)
    cert = ledger.audit(("batch", "warn", None, "regfile", ()),
                        _broken_step, (keys,))
    assert not cert["ok"] and auditor.failed == 1 and not auditor.strict


def test_warn_does_not_downgrade_installed_strict_auditor():
    strict = step_audit.StepAuditor(transfer_budget=1, strict=True)
    exec_cache.install_auditor(strict)
    assert analysis.install_step_auditor("warn") is strict
    assert exec_cache.current_auditor() is strict
    assert analysis.install_step_auditor("off") is None
    assert exec_cache.current_auditor() is strict      # off: no disarm


def test_crashing_auditor_leaves_an_error_certificate():
    """An auditor that crashed proves nothing: the step runs, and the
    ledger keeps an ``ok: False`` certificate with ``audit_error``."""
    def crash(fn, args, key):
        raise ValueError("cannot analyze")

    exec_cache.install_auditor(crash)
    key = ("batch", "crash", None, "regfile", ())
    cert = exec_cache.cache().audit(key, _broken_step, (torch.ones(2),))
    assert cert["ok"] is False and cert["audit_error"] == "cannot analyze"
