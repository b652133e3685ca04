"""Heavy-tailed client noise: clipped SAFL against plain SAFL (the paper's
section 2 noise discussion; adaptive methods need clipping under heavy
tails).

The port's counterpart of ``examples/heavy_tail.py``: a 32 x 4 linear
regression whose labels carry Pareto(1.2) noise (infinite variance), four
clients, K = 2, 150 rounds of each round function from zero weights.
``W_true`` is ``prng.normal``'s draw, the reference's uniforms bit for bit
(``torch.erfinv`` within ~1e-5 of XLA's); the batches are numpy's, as
the reference draws them.

    PYTHONPATH=src python -m repro_torch.launch.heavy_tail [--device cpu]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.clipped import ClippedSAFLConfig, clipped_safl_round
from repro_torch.core.safl import SAFLConfig, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig

BASE = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.5, min_b=8),
                  server=AdaConfig(name="amsgrad", lr=0.05),
                  client_lr=0.05, local_steps=2)
ROUNDS = 150


def make_batch(seed: int, w_true: np.ndarray, device, n: int = 64,
               tail: float = 1.2) -> dict:
    """Regression with Pareto(alpha=1.2) label noise, shaped (4, 2, 8, ...)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    noise = (rng.pareto(tail, size=(n, 4)) * rng.choice([-1, 1], (n, 4)))
    y = x @ w_true + 0.5 * noise.astype(np.float32)
    return {k: torch.as_tensor(v.reshape(4, 2, 8, *v.shape[1:]), device=device)
            for k, v in (("x", x), ("y", y))}


def loss_fn(p, b):
    return torch.mean((b["x"] @ p["W"] - b["y"]) ** 2)


def run(device: str = "cuda") -> dict[str, list[float]]:
    """Both runs; returns each one's parameter MSE after every round."""
    w_true_t = prng.normal(prng.fold_in(prng.key(0), 1), (32, 4), device)
    w_true = w_true_t.cpu().numpy()
    errs = {}
    for name, tau in [("plain SAFL", None), ("clipped SAFL tau=0.5", 0.5)]:
        params = {"W": torch.zeros((32, 4), device=device)}
        opt = init_safl(BASE, params)
        if tau is None:
            step = functools.partial(safl_round, BASE, loss_fn)
        else:
            step = functools.partial(
                clipped_safl_round, ClippedSAFLConfig(base=BASE, clip_tau=tau),
                loss_fn)
        curve = []
        for t in range(ROUNDS):
            params, opt, _ = step(params, opt, make_batch(t, w_true, device),
                                  prng.key(t))
            curve.append(float(torch.mean((params["W"] - w_true_t) ** 2)))
        errs[name] = curve
        print(f"{name:24s} param-MSE: start {curve[0]:.3f}  "
              f"mid {curve[75]:.3f}  final {curve[-1]:.4f}")
    print("clipping should give a lower, more stable final parameter error")
    return errs


def main(argv=None) -> dict[str, list[float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
