"""Plan analysis: the hardware-contract audit and the measured tuner
(``repro/analysis``).

- ``analysis.trace``: one call of an eager program observed (device waits,
  kernel operands, cross-shard traffic, replaced state kept alive), the
  stand-in for the JAX package's HLO parse (``repro/analysis/hlo.py``).
- ``analysis.rules``: the rules R1-R5, each a pure function from what a trace
  saw and a prediction to structured Findings.
- ``analysis.audit``: ``audit_plan`` (the rules over a compiled plan's
  programs) and the ``python -m repro_torch.analysis.audit --matrix`` CLI.
- ``analysis.tuner``: the measured tuner (candidate lowerings timed on the card
  with CUDA events, decisions cached) and the ``--what-if`` CLI.
- ``analysis.roofline``: the operation and byte counts of the kernels.

``audit`` and ``tuner`` are imported lazily.
"""

from repro_torch.analysis.rules import RULES, Finding


def __getattr__(name):
    if name in ("tune", "TuneReport", "Candidate", "tune_cache_key", "spec_fingerprint"):
        from repro_torch.analysis import tuner

        return getattr(tuner, name)
    if name in ("audit_plan", "AuditReport", "AuditError"):
        from repro_torch.analysis import audit

        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
