"""Post-stratification effectiveness — the port of the JAX package's
``tools/strat_effect.py``, with its flags, run as
``python -m shrewd_tpu_torch.tools.strat_effect``.  Trials run on the card
unless ``--platform cpu`` asks for the CPU; without a card the default
raises.

For each fault tier, compare the plain Wilson estimator's variance
against the post-stratified estimator's on the same trial budget — the
variance-reduction factor is (trials to reach a CI target, plain) /
(trials, stratified), approximated here by the ratio of estimator
variances over repeated batches (the NoC pipeline made outcomes
type-determined, and MESI has structure-specific tiers).

The O3 tiers run ``TrialKernel.run_keys_stratified``: one launch of the
fast-pass kernel a batch on the card.  The MESI tiers run the MESI walk
and the NoC tier the flit pipeline, both torch step loops.

Where the port departs from the reference (ROADMAP Queue 3 D8): the
document goes to ``--out``, by default ``strat_effect_torch.json`` in the
current directory (the reference writes ``STRAT_EFFECT.json`` into the
repository's root), and records ``card``, the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (null on the CPU).

Usage: python -m shrewd_tpu_torch.tools.strat_effect [--batches 24]
           [--batch 512] [--out FILE] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def _variance_ratio(kernel, structure: str, batches: int, batch: int,
                    seed0: int):
    """Trials-to-CI-target reduction factor: mean of
    (plain Wilson halfwidth / post-stratified halfwidth)² over repeated
    batches.  (The point estimates coincide by construction — observed-
    allocation weights telescope to the pooled proportion — so the win is
    entirely in the interval width, i.e. how soon run_until_ci stops.)"""
    import numpy as np

    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.parallel.stopping import (pairs_from_strata,
                                                    post_stratified, wilson)
    from shrewd_tpu_torch.utils import prng

    avfs, factors = [], []
    for b in range(batches):
        keys = prng.trial_keys(prng.campaign_key(seed0 + b, kernel.device),
                               batch)
        st_tally, _ = kernel.run_keys_stratified(keys, structure)
        tally = st_tally.sum(dim=0)
        avfs.append(float(C.avf(tally)))
        vuln = int(tally[C.OUTCOME_SDC] + tally[C.OUTCOME_DUE])
        hw_p = wilson(vuln, int(tally.sum())).halfwidth
        # the campaign stopping rule's own vulnerability definition —
        # never re-derive it here
        pairs = pairs_from_strata(st_tally.numpy())
        hw_s = post_stratified(pairs).halfwidth
        factors.append((hw_p / hw_s) ** 2)
    return {
        "avf_mean": round(float(np.mean(avfs)), 4),
        "batch": batch,
        "trials_reduction_factor": round(float(np.mean(factors)), 3)
        if factors else None,
    }


def tiers(device) -> list:
    """(tier name, kernel, structure, batch cap, seed) in the document's
    order: the O3 tiers on a generated window, the MESI tiers on a torture
    stream and the NoC router on its message trace, all on ``device``."""
    import numpy as np

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.models.mesi import (MesiConfig, MesiKernel,
                                              torture_stream)
    from shrewd_tpu_torch.models.noc import (NocConfig, NocKernel,
                                             build_message_trace)
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel

    trace = native.generate_trace(seed=1, n=2048, nphys=256, mem_words=2048,
                                  working_set_words=512)
    o3 = TrialKernel(trace, O3Config(), device=device)
    out = [(f"o3:{s}", o3, s, None, 100) for s in ("regfile", "fu")]
    mcfg = MesiConfig(n_cores=4)
    mcfg.validate()
    stream = torture_stream(mcfg, 96, 64, seed=3, sharing=0.6)
    init = np.arange(64, dtype=np.uint32)
    mk = MesiKernel(stream, mcfg, init, device=device)
    out += [(f"mesi:{s}", mk, s, 256, 200) for s in ("state", "dir", "tbe")]
    ncfg = NocConfig()
    ncfg.validate()
    nk = NocKernel(build_message_trace(stream, mcfg, ncfg), ncfg,
                   device=device)
    out.append(("noc:router", nk, "router", 256, 300))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.strat_effect")
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--out", default="strat_effect_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.tools.northstar import card_identity, device_of

    dev = device_of(a.platform)
    out = {"batches": a.batches,
           "batch": "per-tier (see tiers[*].batch)", "tiers": {},
           "card": card_identity(dev)}
    for name, kernel, structure, cap, seed0 in tiers(dev):
        batch = a.batch if cap is None else min(a.batch, cap)
        out["tiers"][name] = _variance_ratio(kernel, structure, a.batches,
                                             batch, seed0)
        print(name, out["tiers"][name], file=sys.stderr)

    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v["trials_reduction_factor"]
                      for k, v in out["tiers"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
