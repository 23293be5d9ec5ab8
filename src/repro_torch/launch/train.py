"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
        --batch 8 --seq 1024 --steps 40 [--device cuda|cpu]
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch ... \
        [--production-mesh [--multi-pod]]

Trains `--arch` (with `--reduced`, the family-preserving smoke config)
through ``runtime.train_loop`` on a mesh: the host mesh (``launch.mesh.
make_host_mesh``: every rank of a torchrun world on `data`, or this
process alone), or with `--production-mesh` the production mesh, which
needs a torchrun world of its size (256 ranks; 512 with `--multi-pod`).
CUDA (NCCL) unless `--device cpu` (gloo). Synthetic Markov data, AdamW, a
checkpoint every `--checkpoint-every` steps into `--checkpoint-dir`,
resuming from its latest checkpoint. The whisper and llava families get
the JAX launcher's stub modality inputs, ``normal(PRNGKey(step), ...) *
0.1`` (``core.prng.normal``, JAX's bits).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config, list_archs, reduced as reduce_cfg
from repro_torch.core import prng
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.transformer import resolve_device
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainLoopConfig, train


def stub_inputs(cfg, batch: int, device):
    """The whisper / llava stub frontends' inputs of a step, as the JAX
    launcher draws them, or None for the other families."""
    rows = {"whisper": ("frames", cfg.enc_seq),
            "llava": ("image_embeds", cfg.n_patches)}.get(cfg.family)
    if rows is None:
        return None
    name, n = rows

    def extra(step):
        return {name: prng.normal(prng.PRNGKey(step, device),
                                  (batch, n, cfg.d_model)) * 0.1}
    return extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="repro_ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    mesh = (make_production_mesh(multi_pod=args.multi_pod, device=device)
            if args.production_mesh else make_host_mesh(device=device))
    loop = TrainLoopConfig(total_steps=args.steps,
                           checkpoint_every=args.checkpoint_every,
                           checkpoint_dir=args.checkpoint_dir,
                           num_microbatches=args.microbatches)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    out = train(cfg, mesh, loop, adamw.AdamWConfig(lr=args.lr), data_cfg=data,
                extra_batch=stub_inputs(cfg, args.batch, device))
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
