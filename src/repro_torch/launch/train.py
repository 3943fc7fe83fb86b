"""Training launcher: the paper's pipeline end to end on a device mesh.

Stage 0 pre-trains a teacher on the structured Markov corpus (CE), stage 1
optionally samples the training data from it (``--synthetic-data``, paper
Fig. 2a), stage 2 distils the HWA student from it (Fig. 2b) in ``--mode``
``analog`` (the paper's method) or ``qat``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-3.2-1b \\
        --mode analog --steps 200 --reduced --ckpt-dir /tmp/run1

Runs on the card; ``--device cpu`` runs on the CPU with the kernels' plain
PyTorch versions (``--reduced --device cpu --steps 4 --pretrain-steps 4``
takes seconds). As the reference's, the launcher runs the recipes under a
mesh: the host mesh over the visible cards (data = their count, model 1;
one device with ``--device cpu``), or with ``--production-mesh`` the 16 x
16 production mesh, which needs 256 cards and raises a ``ValueError``
naming both counts on fewer. The state is placed by the training rules and
the step runs data-parallel over them (``train.train_step``); on one card
the mesh is ``(1, 1)`` and the step is the unsharded one, bit for bit.
The vlm family trains on
the corpus as text (it has no patch embeddings), and the audio family's
model refuses the corpus's two-dimensional tokens, as the reference's CLI
does.
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import get_config
from repro_torch.core.analog import AnalogConfig
from repro_torch.data.corpus import MarkovCorpus
from repro_torch.data.synthetic import GenConfig, generate_synthetic
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     place_mesh)
from repro_torch.models import build
from repro_torch.train.recipes import distill_recipe, pretrain_recipe
from repro_torch.train.train_step import TrainConfig


def parse_args(argv=None):
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.2-1b")
    ap.add_argument("--mode", default="analog",
                    choices=["analog", "qat", "off"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--synthetic-data", action="store_true",
                    help="paper pipeline: sample training data from the "
                         "teacher instead of the corpus")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda raises when no card is present; cpu runs "
                         "the kernels' plain PyTorch versions")
    return ap.parse_args(argv)


def main(argv=None):
    """CLI entry point. Returns the distillation trainer (None with
    ``--mode off``)."""
    args = parse_args(argv)
    if args.production_mesh:
        mesh = place_mesh(make_production_mesh())
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)
    if not args.production_mesh:
        mesh = make_host_mesh(devices=None if args.device == "cuda"
                              else [device])
    print(f"[launch] mesh {dict(mesh.shape)}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduce()
    cfg, params, labels = build(cfg, args.seed, device=device)

    def ckpt(name):
        return os.path.join(args.ckpt_dir, name) if args.ckpt_dir else None

    # stage 0: the teacher, pre-trained on the structured corpus
    corpus = MarkovCorpus(cfg.vocab_size, seed=args.seed)
    corpus_tokens = corpus.sample(64 * args.batch, args.seq + 1)
    print(f"[launch] pre-training teacher ({args.pretrain_steps} steps)")
    teacher, _ = pretrain_recipe(
        params, labels, cfg, corpus_tokens, num_steps=args.pretrain_steps,
        batch_size=args.batch, ckpt_dir=ckpt("teacher"), seed=args.seed,
        mesh=mesh)

    # stage 1: the data (paper Fig. 2a)
    if args.synthetic_data:
        print("[launch] sampling synthetic corpus from teacher")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        tokens = generate_synthetic(teacher, cfg, gen, 32 * args.batch,
                                    args.seq + 1, GenConfig())
    else:
        tokens = corpus_tokens
    if args.mode == "off":
        print("[launch] mode=off: teacher only; done")
        return None

    # stage 2: HWA distillation (paper Fig. 2b)
    acfg = AnalogConfig(mode=args.mode, gamma_weight=0.02, alpha_clip=3.0,
                        init_steps=min(500, args.steps // 4))
    tcfg = TrainConfig(peak_lr=5e-4, total_steps=args.steps,
                       kd_temperature=2.0,
                       grad_compression=args.grad_compression)
    print(f"[launch] HWA distillation mode={args.mode} ({args.steps} steps)")
    _, trainer = distill_recipe(
        teacher, labels, cfg, tokens, acfg=acfg, tcfg=tcfg,
        batch_size=args.batch, num_steps=args.steps,
        ckpt_dir=ckpt("student"), seed=args.seed, mesh=mesh)
    print(f"[launch] final KD loss: {trainer.history[-1]['kd']:.4f}; "
          f"stragglers flagged: {len(trainer.monitor.events)}")
    return trainer


if __name__ == "__main__":
    main()
