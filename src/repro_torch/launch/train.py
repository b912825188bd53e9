"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py``, with its arguments: an arch
(full size or ``--reduced``), random weights from ``--seed`` (the port's
``init``, in the config's parameter dtype), the seeded ``SyntheticLM``
stream (``--batch`` x ``--seq`` tokens a step), AdamW at ``--lr`` with the
reference's schedule (warmup over a twentieth of ``--steps``), a checkpoint
every ``--ckpt-every`` steps and at the end under ``--ckpt-dir``, and a
resume from the newest checkpoint there unless ``--no-resume``. Runs on
``--device cuda`` by default (raises without a card); pass ``--device cpu``
to run on the CPU. Prints the reference's ``mesh:`` and ``final loss:``
lines (rank 0).

The mesh is the reference's, ``elastic_mesh(model_parallel=min(16,
world))`` over the process group's ranks, and every parameter is placed by
``param_specs(params, mesh, "train")`` (``train/loop.make_placed_train_
step``). One process with no launcher makes a one-rank group and a 1 x 1
mesh, where the placed step is the unplaced one bit for bit. Several CPU
ranks (gloo):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --arch internlm2-1.8b --reduced --steps 8 --batch 4 --seq 16

On CUDA each rank takes the card of its local rank (NCCL); this machine
has one card, so the card runs 1 x 1. The model axis shards storage, not
compute.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.dist.logical import axis_sizes
from repro_torch.dist.sharding import distribute, param_specs
from repro_torch.ft.elastic import elastic_mesh, ensure_process_group
from repro_torch.models.registry import PORTED_ARCHS, build, load_config
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, make_train_step, run_loop


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, help=f"ported: {', '.join(PORTED_ARCHS)}")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale smoke/e2e runs)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(1, args.steps // 20))
    owned = ensure_process_group(device)
    try:
        mesh = elastic_mesh(device, model_parallel=min(16, dist.get_world_size()))
        rank0 = dist.get_rank() == 0
        log = print if rank0 else (lambda _: None)
        log(f"mesh: {axis_sizes(mesh)}  arch: {cfg.arch_id}  device: {device}")
        params = model.init(seed=args.seed, device=device)
        params = distribute(params, param_specs(params, mesh, "train"), mesh)
        data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
            seed=args.seed,
        ))
        loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                              ckpt_dir=args.ckpt_dir)
        params, _, history = run_loop(model, params, data, opt_cfg, loop_cfg,
                                      train_step=make_train_step(model, opt_cfg, mesh=mesh),
                                      resume=not args.no_resume, log=log)
        log(f"final loss: {history[-1]['loss']:.4f}")
    finally:
        if owned:
            dist.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
