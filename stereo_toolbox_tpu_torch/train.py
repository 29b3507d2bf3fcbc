"""Training entry point of the PyTorch port.

    python -m stereo_toolbox_tpu_torch.train --model PSMNet --dataset synthetic
    python -m stereo_toolbox_tpu_torch.train --model GwcNet_G \
        --dataset sceneflow --root /data/Scene_Flow --bf16

Trains PSMNet, GwcNet_G, GwcNet_GC, ACVNet, CFNet, DEFOMStereo_S or
DEFOMStereo_L on the card
(``--device cpu`` runs the plain paths on the CPU; without it and without a
card it raises), in float32 or, with ``--bf16``, in bfloat16, on the
synthetic dataset or on a dataset of the zoo (``--dataset`` a name of
`DATASETS` or a '+'-joined mix of them, trained as one `ConcatDataset`;
``--split`` overrides each one's train split, ``--root`` its root), as the
JAX package's ``examples/train.py`` builds them; ``--lists`` takes their
manifests from a directory laid out as ``datasets/lists`` instead of the
vendored ones. ``--bf16`` is the JAX package's: the model's parameters and
running statistics stay float32 (the masters, which the optimizer updates
and the checkpoints hold), and each step computes on a bfloat16 view of
them (``trainer.make_train_step(..., dtype=torch.bfloat16)``). The
flags are those of the JAX package's ``examples/train.py`` that the port
supports, with its defaults, plus ``--device`` and ``--lists``; the
synthetic dataset holds 64 samples, as there. ``--loss`` defaults to the
sequence loss for the iterative models (DEFOMStereo: its ``train_iters``
predictions; ``--maxdisp`` then goes to the loss's mask alone, the model
takes none) and to the multi-head loss for the others, as JAX's trainer
trains them (``TrainConfig(loss="sequence")``; JAX's own
``examples/train.py`` passes DEFOMStereo a ``max_disp`` it does not take).
The multi-head loss weighs PSMNet's three heads (0.5, 0.7, 1.0) and every
other model's four (0.5, 0.5, 0.7, 1.0), as there: CFNet's nine heads train
with ``--loss sequence`` (with ``multihead`` its step raises, as JAX's
asserts). ``--distributed`` is refused: data parallelism is not ported yet
(ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import os

import torch

from stereo_toolbox_tpu_torch import datasets as D
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.trainer import (TrainConfig, Trainer,
                                              init_train_state)

TRAINABLE = ("PSMNet", "GwcNet_G", "GwcNet_GC", "ACVNet", "CFNet",
             "DEFOMStereo_S", "DEFOMStereo_L")
# the models whose constructor takes max_disp, and those trained with the
# sequence loss by default
TAKES_MAX_DISP = TRAINABLE[:5]
ITERATIVE = ("DEFOMStereo_S", "DEFOMStereo_L")
# the heads' weights of the multi-head loss (the JAX entry point's)
LOSS_WEIGHTS = {name: (0.5, 0.7, 1.0) if name == "PSMNet"
                else (0.5, 0.5, 0.7, 1.0) for name in TRAINABLE}
SYNTHETIC_SAMPLES = 64
# dataset key → (class name in `datasets`, default train split)
DATASETS = {
    "sceneflow": ("SceneFlow_Dataset", "train_finalpass"),
    "kitti2015": ("KITTI2015_Dataset", "train"),
    "kitti2012": ("KITTI2012_Dataset", "train"),
    "middleburyeval3": ("MiddleburyEval3_Dataset", "trainH"),
    "eth3d": ("ETH3D_Dataset", "train"),
    "drivingstereo": ("DrivingStereo_Dataset", "train_half"),
    "middlebury2021": ("Middlebury2021_Dataset", "train"),
    "sintel": ("Sintel_Dataset", "train_final"),
    "hr_vs": ("HR_VS_Dataset", "train"),
    "booster": ("Booster_Dataset", "train_balanced"),
    "instereo2k": ("InStereo2k_Dataset", "train"),
    "crestereo": ("CREStereo_Dataset", "train"),
    "argoverse": ("Argoverse_Dataset", "train"),
    "holopix50k": ("Holopix50k_Dataset", "train"),
    "fallingthings": ("FallingThings_Dataset", "train"),
    "virtualkitti2": ("VirtualKITTI2_Dataset", "train"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="PSMNet", choices=TRAINABLE)
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic', a dataset name, or a '+'-joined mix "
                        "(e.g. sceneflow+sintel+hr_vs); names: "
                        + ", ".join(DATASETS))
    p.add_argument("--split", default=None,
                   help="split name; default: each dataset's train split")
    p.add_argument("--root", default=None,
                   help="dataset root; default: each dataset's own")
    p.add_argument("--lists", default=None,
                   help="manifest directory laid out as datasets/lists "
                        "(default: the vendored manifests)")
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
    p.add_argument("--loss", default=None,
                   choices=("sequence", "multihead", "selfsup"),
                   help="default: sequence for the iterative models, "
                        "multihead for the others")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain paths; default: the card")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute on float32 master parameters (the "
                        "JAX package's --bf16, its analogue of --amp)")
    p.add_argument("--distributed", action="store_true",
                   help="refused: data parallelism is not ported yet")
    return p.parse_args(argv)


def _build_one(name: str, args):
    if name == "synthetic":
        return D.SyntheticStereoDataset(
            num_samples=SYNTHETIC_SAMPLES, height=args.crop[0] + 64,
            width=args.crop[1] + 64, max_disp=min(args.maxdisp, 96),
            training=True, crop_size=tuple(args.crop), seed=args.seed)
    if name not in DATASETS:
        raise SystemExit(f"unknown dataset {name!r}; have "
                         f"{['synthetic'] + sorted(DATASETS)}")
    cls_name, default_split = DATASETS[name]
    cls, split = getattr(D, cls_name), args.split or default_split
    kw = {"crop_size": tuple(args.crop), "seed": args.seed}
    if args.root:
        kw["root_dir"] = args.root
    if args.lists:
        kw["manifest"] = os.path.join(args.lists, cls.list_name,
                                      f"{split}.txt")
    return cls(split, training=True, **kw)


def build_dataset(args):
    """One dataset, or a '+'-joined mix as one `ConcatDataset` (the
    original's SceneFlow+Sintel+HR-VS+CREStereo recipe,
    train_accelerate.py:97-107)."""
    parts = [_build_one(n, args) for n in args.dataset.split("+")]
    return parts[0] if len(parts) == 1 else D.ConcatDataset(parts)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.distributed:
        raise SystemExit("--distributed: data parallelism is not ported yet "
                         "(ROADMAP Queue 1, item 3)")
    torch.manual_seed(args.seed)
    model_kw = ({"max_disp": args.maxdisp}
                if args.model in TAKES_MAX_DISP else {})
    model = create_model(args.model, device=args.device,
                         generator=torch.Generator().manual_seed(args.seed),
                         **model_kw)
    config = TrainConfig(
        lr=args.lr, batch_size=args.batch_size, epochs=args.epochs,
        clip_grad=args.clip_grad, max_disp=args.maxdisp, seed=args.seed,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        log_dir=args.log_dir,
        loss=args.loss or ("sequence" if args.model in ITERATIVE
                           else "multihead"),
        loss_weights=LOSS_WEIGHTS[args.model])
    dataset = build_dataset(args)
    loader = D.DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
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
