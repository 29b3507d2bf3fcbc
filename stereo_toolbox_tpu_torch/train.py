"""Training entry point of the PyTorch port.

    python -m stereo_toolbox_tpu_torch.train --model PSMNet --dataset synthetic

Trains PSMNet, GwcNet_G, GwcNet_GC, ACVNet or CFNet on the card
(``--device cpu`` runs the plain paths on the CPU; without it and without a
card it raises), in float32 or, with ``--bf16``, in bfloat16, on the
synthetic dataset. ``--bf16`` is the JAX package's: the model's parameters
and running statistics stay float32 (the masters, which the optimizer
updates and the checkpoints hold), and each step computes on a bfloat16
view of them (``trainer.make_train_step(..., dtype=torch.bfloat16)``). The
flags are those of the JAX package's ``examples/train.py`` that the port
supports, with its defaults, plus ``--device``; the synthetic dataset holds
64 samples, as there. The multi-head loss weighs PSMNet's three heads
(0.5, 0.7, 1.0) and every other model's four (0.5, 0.5, 0.7, 1.0), as
there: CFNet's nine heads train with ``--loss sequence`` (with the default
``multihead`` its step raises, as JAX's asserts). ``--distributed`` is
refused: data parallelism is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse

import torch

from stereo_toolbox_tpu_torch.datasets import (DataLoader,
                                               SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.trainer import (TrainConfig, Trainer,
                                              init_train_state)

TRAINABLE = ("PSMNet", "GwcNet_G", "GwcNet_GC", "ACVNet", "CFNet")
# the heads' weights of the multi-head loss (the JAX entry point's)
LOSS_WEIGHTS = {name: (0.5, 0.7, 1.0) if name == "PSMNet"
                else (0.5, 0.5, 0.7, 1.0) for name in TRAINABLE}
SYNTHETIC_SAMPLES = 64


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="PSMNet", choices=TRAINABLE)
    p.add_argument("--dataset", default="synthetic", choices=("synthetic",))
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--crop", type=int, nargs=2, default=(320, 512))
    p.add_argument("--clip-grad", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--ckpt-dir", default="checkpoints")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=16)
    p.add_argument("--log-dir", default=None,
                   help="TensorBoard/JSONL scalar directory")
    p.add_argument("--loss", default="multihead",
                   choices=("sequence", "multihead", "selfsup"))
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain paths; default: the card")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute on float32 master parameters (the "
                        "JAX package's --bf16, its analogue of --amp)")
    p.add_argument("--distributed", action="store_true",
                   help="refused: data parallelism is not ported yet")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.distributed:
        raise SystemExit("--distributed: data parallelism is not ported yet "
                         "(ROADMAP Queue 1, item 3)")
    torch.manual_seed(args.seed)
    model = create_model(args.model, device=args.device,
                         max_disp=args.maxdisp,
                         generator=torch.Generator().manual_seed(args.seed))
    config = TrainConfig(
        lr=args.lr, batch_size=args.batch_size, epochs=args.epochs,
        clip_grad=args.clip_grad, max_disp=args.maxdisp, seed=args.seed,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        log_dir=args.log_dir, loss=args.loss,
        loss_weights=LOSS_WEIGHTS[args.model])
    dataset = SyntheticStereoDataset(
        num_samples=SYNTHETIC_SAMPLES, height=args.crop[0] + 64,
        width=args.crop[1] + 64, max_disp=min(args.maxdisp, 96),
        training=True, crop_size=tuple(args.crop), seed=args.seed)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                        seed=args.seed, drop_last=True,
                        num_workers=args.num_workers)
    total_steps = len(loader) * args.epochs
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = init_train_state(model, config, total_steps, dtype)
    trainer = Trainer(model, config, lr_schedule=state.optimizer.schedule,
                      dtype=dtype)
    start_epoch = 0
    if args.resume:
        state, last_epoch = trainer.load_checkpoint(state, args.resume)
        start_epoch = last_epoch + 1
        print(f"resumed from {args.resume}: last completed epoch "
              f"{last_epoch}, continuing at {start_epoch}")
    device = next(model.parameters()).device
    print(f"training {args.model} on {args.dataset}: {len(loader)} steps/"
          f"epoch x {args.epochs} epochs on {device} in "
          f"{str(dtype).replace('torch.', '')}")
    trainer.train(state, loader, epochs=args.epochs, start_epoch=start_epoch)
    trainer.writer.close()


if __name__ == "__main__":
    main()
