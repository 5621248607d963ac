"""Hardware-contract rules for the plan auditor (``analysis/audit.py``).

Counterpart of ``repro/analysis/rules.py``. MERINDA's recovery speed comes from
structural properties of the programs a plan runs: state reused in place,
state resident on chip, no host round-trip in a tick, fixed-point weights, no
cross-shard traffic. The JAX package checks each against the optimized HLO of
a compiled program. An eager PyTorch program has no HLO, so each rule here is
restated for what the program does when it runs once, as
``analysis/trace.py`` observes it:

    R1 no copy kept   after the call, every leaf of the tree it replaces
                      shares storage with an output leaf or is unreachable
    R2 residency      the tiling.py shared-memory model equals the bytes the
                      launcher requests (its exported carve), exactly
    R3 host transfer  no device wait in the program beyond an allowlist
    R4 dtype          the int8/PWL serving path hands its gate and head weight
                      matrices to its kernels as int8
    R5 collectives    a sharded tick's census of cross-device copies and
                      other-shard storage reads and writes matches the
                      prediction (empty)

Every rule is a pure function ``(program name, observation, prediction) ->
[Finding]``, so the rules are unit-testable on synthetic traces and the
auditor stays the one place that knows how to run a plan's programs. R1 and
R4 emit a vacuity Finding when nothing binds (no leaf to hold, a contracted
weight that never reached its kernel), as the JAX rules do: an auditor whose
contract silently stopped binding is itself a violation.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Mapping, Sequence

from repro_torch.analysis.trace import Trace

#: rule id -> one-line contract
RULES: dict[str, str] = {
    "R1": "no copy kept: every replaced leaf shares an output's storage or is unreachable",
    "R2": "residency: tiling.py shared-memory model equals the launcher's exported carve",
    "R3": "host-transfer: no device wait in the program beyond the allowlist",
    "R4": "dtype: int8 serving path hands gate/head weights to its kernels as int8",
    "R5": "collectives: sharded-tick crossing census matches the prediction",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured contract violation."""

    rule: str  # "R1".."R5"
    program: str  # which program ("tick", "epoch", "fused_step", ...)
    op: str  # the op, leaf or operand the finding anchors on ("" = the whole program)
    expected: str
    actual: str
    message: str

    def __str__(self) -> str:
        anchor = f" @ {self.op}" if self.op else ""
        return (
            f"[{self.rule}] {self.program}{anchor}: {self.message} "
            f"(expected {self.expected}, got {self.actual})"
        )


# -- R1 ----------------------------------------------------------------------
def check_no_copy_kept(program: str, trace: Trace, replaced: Sequence[str]) -> list[Finding]:
    """R1: no leaf of a replaced tree outlives the call as a copy.

    ``replaced`` names the trees the call replaces (``("state",)`` for the
    tick, ``("params", "opt_state")`` for the epoch). A leaf passes when its
    storage is an output leaf's (reused in place, or passed through) or
    unreachable once the call returns; a leaf still reachable beside a new
    output is a second copy of the state held alive, the eager form of the
    JAX rule's copy fallback.
    """
    findings = [
        Finding(
            rule="R1",
            program=program,
            op=name,
            expected="storage shared with an output leaf, or unreachable",
            actual="reachable and not an output's storage",
            message=f"replaced leaf {name!r} is kept alive beside its replacement",
        )
        for name in trace.kept_alive
    ]
    if not trace.donated:
        findings.append(
            Finding(
                rule="R1",
                program=program,
                op="",
                expected=f"tensor leaves under the replaced trees {list(replaced)}",
                actual="no leaves",
                message="the no-copy audit bound nothing; the rule would be vacuous",
            )
        )
    return findings


# -- R2 ----------------------------------------------------------------------
def check_residency(program: str, predicted_bytes: int, carved_bytes: int,
                    family: str = "gru") -> list[Finding]:  # fmt: skip
    """R2: the shared-memory model equals the launcher's carve.

    ``predicted_bytes`` is ``kernels/mr_step/tiling.py``'s model of a block's
    shared memory, ``carved_bytes`` what the kernel's launcher requests for the same dims
    (``runtime.kernel_smem_bytes``). Both are exact counts of one layout, so
    the band is equality: a region the model misses, a padding it rounds
    otherwise, a layout change on one side only.
    """
    if predicted_bytes <= 0:
        return [
            Finding(
                rule="R2",
                program=program,
                op="",
                expected="> 0 predicted shared-memory bytes",
                actual=str(predicted_bytes),
                message="the shared-memory model predicted a nonpositive carve",
            )
        ]
    if carved_bytes == predicted_bytes:
        return []
    return [
        Finding(
            rule="R2",
            program=program,
            op="",
            expected=f"{predicted_bytes} B (the {family} model)",
            actual=f"{carved_bytes} B (the launcher's carve)",
            message="the launcher's shared-memory carve disagrees with the tiling.py model",
        )
    ]


def check_recorded_carve(program: str, recorded_bytes: int, carved_bytes: int) -> list[Finding]:
    """R2 for a measured-tuned plan: the carve the tuner recorded for its
    choice (``Lowering.measured_bytes``) is the carve the launch requests.
    The model is held to the carve by ``check_residency`` in any case."""
    if recorded_bytes == carved_bytes:
        return []
    return [
        Finding(
            rule="R2",
            program=program,
            op="",
            expected=f"{recorded_bytes} B (the tuner's recorded carve)",
            actual=f"{carved_bytes} B (the launcher's carve)",
            message="the plan's measured_bytes is not the carve its launch requests",
        )
    ]


# -- R3 ----------------------------------------------------------------------
def check_host_transfers(program: str, trace: Trace, allowlist: Sequence[str] = ()) -> list[Finding]:
    """R3: no device wait inside the program.

    The service's contract is that every host read happens in its own layer
    (``RecoveryService.tick_once`` counts them in ``sync_log``); a wait inside
    the tick program would stall every tick uncounted. ``allowlist`` entries
    are substrings of an op name or its detail that are declared waits.
    """
    findings = []
    for w in trace.waits:
        if any(a and (a in w.op or a in w.detail) for a in allowlist):
            continue
        findings.append(
            Finding(
                rule="R3",
                program=program,
                op=w.op,
                expected="no device wait",
                actual=w.detail,
                message=f"{w.op} makes the host wait for the device inside the program",
            )
        )
    return findings


def sync_debug_finding(program: str, error: str) -> Finding:
    """R3's second witness on the card: the program raised under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    return Finding(
        rule="R3",
        program=program,
        op="sync_debug",
        expected="no synchronizing CUDA call",
        actual=error.splitlines()[0] if error else "?",
        message="the program synchronized with the card under sync-debug mode 'error'",
    )


# -- R4 ----------------------------------------------------------------------
def check_weight_dtypes(
    program: str, trace: Trace, weights: Mapping[str, Mapping[str, str]]
) -> list[Finding]:
    """R4: quantized weights reach their kernels at their serving dtype.

    ``weights`` maps a kernel to its contracted operands and their dtype
    (``{"mr_step_int8": {"wxq": "int8", ...}}``). The int8 kernels dequantize
    per channel inside (the scales are separate float rows), so the contract
    is at the kernel's operands: a weight matrix handed over as float32 means
    the serving path widened it. Every contracted operand must be seen; a
    kernel that was never called, or a weight missing from its call, is a
    finding, not a pass.
    """
    findings, seen = [], set()
    for call in trace.kernel_calls:
        want = weights.get(call.kernel)
        if not want:
            continue
        for name, dtype in call.dtypes:
            if name not in want:
                continue
            seen.add((call.kernel, name))
            if dtype != want[name]:
                findings.append(
                    Finding(
                        rule="R4",
                        program=program,
                        op=f"{call.kernel}.{name}",
                        expected=want[name],
                        actual=dtype,
                        message=f"serving weight {name!r} reaches {call.kernel} as {dtype}: "
                        f"widened on the transport path",
                    )
                )
    for kernel, want in sorted(weights.items()):
        for name in sorted(set(want) - {n for k, n in seen if k == kernel}):
            findings.append(
                Finding(
                    rule="R4",
                    program=program,
                    op=f"{kernel}.{name}",
                    expected=f"{want[name]} operand {name!r} of {kernel}",
                    actual="not seen in any call",
                    message=f"contracted serving weight {name!r} never reached {kernel}",
                )
            )
    return findings


# -- R5 ----------------------------------------------------------------------
def predict_tick_collectives(mesh) -> dict[str, int]:
    """The crossings a slot-sharded tick may make: none. Each shard's tick
    reads and writes only its own slots and control row
    (``repro/parallel/rules.py:257`` ``predict_tick_collectives``; the port
    keeps its own copy)."""
    return {}


def check_collectives(program: str, trace: Trace, predicted_ops: Mapping[str, int]) -> list[Finding]:
    """R5: the tick's crossing census matches the prediction, kind by kind
    (``cross_device_copy``, ``foreign_read``, ``foreign_write``)."""
    census = collections.Counter(c.kind for c in trace.crossings)
    findings = []
    for kind in sorted(set(census) | set(predicted_ops)):
        got, want = census.get(kind, 0), predicted_ops.get(kind, 0)
        if got != want:
            ops = sorted({c.op for c in trace.crossings if c.kind == kind})
            findings.append(
                Finding(
                    rule="R5",
                    program=program,
                    op=kind,
                    expected=f"{want} x {kind}",
                    actual=f"{got} ({', '.join(ops)})" if ops else str(got),
                    message="crossing census disagrees with the sharding prediction",
                )
            )
    return findings
