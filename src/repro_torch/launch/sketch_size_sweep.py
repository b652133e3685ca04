"""The paper's sketch-size study (Fig. 1 right, Fig. 3, Fig. 6): training
error is monotone in the sketch size b, and even extreme compression
(b ~ 0.2% of d) still converges, the log-d communication claim.

The port's counterpart of ``examples/sketch_size_sweep.py``: the same
2-layer model, data (``round_batch`` draws the reference's batches bit
for bit), ratios and 80 rounds, with the same monotonicity assertion.
The weights are the port's own random init (seed 0).

    PYTHONPATH=src python -m repro_torch.launch.sketch_size_sweep [--device cpu] [--rounds N]
"""

from __future__ import annotations

import argparse
import functools

import torch

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.safl import SAFLConfig, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig, total_sketch_bits
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn

MODEL = ModelConfig(name="sweep", arch_type="dense", num_layers=2,
                    d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
                    vocab_size=512)
RATIOS = (0.002, 0.01, 0.05, 0.25, 1.0)
ROUNDS = 80


def run(device: str = "cuda", rounds: int = ROUNDS) -> dict[float, float]:
    """Each ratio's run of ``rounds`` rounds; returns its final loss by
    ratio."""
    data = BigramLMData(LMDataConfig(vocab_size=512, seq_len=32, num_clients=5,
                                     alpha=0.02))
    loss = lambda p, b: loss_fn(MODEL, p, b)
    print(f"{'ratio':>8} {'uplinkKiB':>10} {'final_loss':>11}  loss curve (every 20)")
    results = {}
    for ratio in RATIOS:
        kind = "none" if ratio == 1.0 else "countsketch"
        safl = SAFLConfig(sketch=SketchConfig(kind=kind, ratio=ratio, min_b=8),
                          server=AdaConfig(name="amsgrad", lr=0.01),
                          client_lr=0.5, local_steps=2)
        params = init_params(MODEL, torch.Generator().manual_seed(0), device)
        opt = init_safl(safl, params)
        step = functools.partial(safl_round, safl, loss)
        curve = []
        for t in range(rounds):
            batch = data.round_batch(8, 2, seed=t, device=device)
            params, opt, m = step(params, opt, batch, prng.key(t))
            curve.append(float(m["loss"]))
        kib = total_sketch_bits(safl.sketch, params) / 8 / 1024
        results[ratio] = curve[-1]
        pts = " ".join(f"{curve[i]:.3f}" for i in range(0, rounds, 20))
        print(f"{ratio:8.3f} {kib:10.1f} {curve[-1]:11.4f}  {pts}")

    rs = sorted(results)
    assert all(results[rs[i]] >= results[rs[i + 1]] - 0.05
               for i in range(len(rs) - 1)), \
        "training error should be (approximately) monotone in sketch size"
    print("\nmonotonicity in b: OK (matches paper Fig. 1/3)")
    return results


def main(argv=None) -> dict[float, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"rounds a ratio (default: the reference's {ROUNDS})")
    args = ap.parse_args(argv)
    return run(args.device, args.rounds)


if __name__ == "__main__":
    main()
