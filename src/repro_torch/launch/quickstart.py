"""Quickstart: LAMP on one composition f(g(x)) = softmax(A @ x) (the twin
of ``examples/quickstart.py``).

Accumulate the matmul in PS(mu), look ahead at the softmax to find the
numerically sensitive entries (rule (8)), recompute only those in FP32,
and compare the error against uniform low-precision evaluation.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Runs on CUDA unless `--device cpu`. The inputs come from a seeded
generator (not the JAX example's draws).
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.core import lamp_matmul_softmax
from repro_torch.models.transformer import resolve_device


def kl(p: torch.Tensor, q: torch.Tensor) -> float:
    return float(torch.mean(torch.sum(
        p * (torch.log(p + 1e-30) - torch.log(q + 1e-30)), -1)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    d, n = 64, 256
    A = (torch.randn(1, n, d, generator=gen) * 1.2).to(device)   # "keys"
    x = (torch.randn(1, d, n, generator=gen) * 1.2).to(device)   # "queries"

    z_exact = torch.softmax(torch.matmul(A, x), dim=-1)
    mu, tau = 4, 0.05
    # uniform low precision (no recompute), then LAMP with the strict rule (8)
    z_low, _, _ = lamp_matmul_softmax(A, x, mu, tau, rule="none")
    z_lamp, _, mask = lamp_matmul_softmax(A, x, mu, tau, rule="strict")

    kl_low, kl_lamp = kl(z_exact, z_low), kl(z_exact, z_lamp)
    print(f"PS(mu={mu}) accumulation, LAMP threshold tau={tau}, on {device}")
    print(f"  KL(exact || uniform-low) = {kl_low:.3e}")
    print(f"  KL(exact || LAMP)        = {kl_lamp:.3e}")
    print(f"  recompute rate           = {float(mask.float().mean()):.2%}")
    print(f"  improvement              = {kl_low / max(kl_lamp, 1e-30):.0f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
