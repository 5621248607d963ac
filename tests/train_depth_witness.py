"""How far float32 gradients of a deep random zamba2 move, in the JAX package
and in the port, by depth, on the CPU (a script, not a test).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/train_depth_witness.py [--depths 2,6,12,24,38]

zamba2-1.2b's SMOKE widths in float32 with ``num_layers`` set to each depth
(the JAX package's ``init_params``, seed 0, carried to the port), one batch
of B = 2, S = 64 (``test_torch_train_lm.make_batch``). At each depth it
prints each gradient leaf's max |difference| over JAX's largest |g| in that
leaf (the worst leaf and the median):

- the port's ``train_loss`` gradients against JAX's ``jax.grad(train_loss)``;
- JAX's against JAX's on the same weights each multiplied by (1 + e·u), u
  uniform in [-1, 1] (``jax.random.key(1)``), e = 2^-24: one float32
  rounding's change of the inputs, within the JAX package alone.

The second column owes nothing to the port: where it grows with depth, the
step's gradients at that depth are as far from fixed in float32 as it shows.
``src/repro_torch/launch/train_depth.py`` is its counterpart on the card at
the published widths.
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np
from test_torch_train_lm import (
    flat,
    jax_loss_and_grad,
    make_batch,
    models,
    port_loss_and_grads,
    torch_batch,
)

PERTURB = 2.0**-24


def rel_gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--depths", default="2,6,12,24,38")
    args = ap.parse_args()
    for n in (int(d) for d in args.depths.split(",")):
        t0 = time.time()
        _, cfg, jparams, params = models("zamba2-1.2b", "float32", num_layers=n)
        batch = make_batch(cfg, 2, 64)
        step = jax_loss_and_grad("zamba2-1.2b", "float32", num_layers=n)
        (jloss, _), jgrads = step(jparams, batch)
        leaves, treedef = jax.tree.flatten(jparams)
        keys = jax.random.split(jax.random.key(1), len(leaves))
        moved = [x * (1 + PERTURB * jax.random.uniform(k, x.shape, x.dtype, -1, 1))
                 for x, k in zip(leaves, keys)]  # fmt: skip
        _, jmoved = step(jax.tree.unflatten(treedef, moved), batch)
        loss, _, grads = port_loss_and_grads(params, torch_batch(batch), cfg)
        want = {k: np.asarray(v) for k, v in flat(jgrads).items()}
        port = {k: rel_gap(grads[k].numpy(), w) for k, w in want.items()}
        jax_self = {k: rel_gap(np.asarray(v), want[k]) for k, v in flat(jmoved).items()}
        wp, wj = max(port, key=port.get), max(jax_self, key=jax_self.get)
        print(f"{n} layers, loss {float(jloss):.6f} (port {float(loss):.6f}), largest |g| "
              f"{max(np.abs(w).max() for w in want.values()):.3e}: port against JAX worst "
              f"{port[wp]:.3e} ({wp}), median {np.median(list(port.values())):.3e}; JAX moved "
              f"against JAX worst {jax_self[wj]:.3e} ({wj}), median "
              f"{np.median(list(jax_self.values())):.3e}; {time.time() - t0:.1f} s", flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
