"""Evaluation entry point of the PyTorch port.

    # a checkpoint of the original toolbox -> SceneFlow finalpass metrics
    python -m stereo_toolbox_tpu_torch.eval --model GwcNet_G \
        --torch-ckpt gwcnet.pth --suite sceneflow --root /data/Scene_Flow

    # zero-shot generalization (KITTI15/12, MiddEval3, ETH3D training sets
    # under <root>/KITTI_2015, KITTI_2012, MiddEval3, ETH3D)
    python -m stereo_toolbox_tpu_torch.eval --model CFNet --ckpt \
        checkpoints/epoch_0019.pt --suite generalization --root /data

    # DrivingStereo half-resolution test, by weather; speed and memory
    python -m stereo_toolbox_tpu_torch.eval --suite weather --root /data/DS
    python -m stereo_toolbox_tpu_torch.eval --model PSMNet --suite speed

The counterpart of the JAX package's ``examples/eval.py`` for the port's
models, on the card (``--device cpu`` runs the plain paths on the CPU;
without it and without a card it raises). The weights come from
``--torch-ckpt`` (a ``state_dict`` of the original toolbox, loaded as it is
with ``strict=True``: the port keeps its names), ``--ckpt`` (a checkpoint of
the port's trainer) or, with neither, from ``--seed``. ``--max-disp`` goes to
the models that take it and to the SceneFlow mask; the generalization and
weather suites keep their default 192, as there. ``--write-json`` turns on
the metric write-back regression gate. The speed suite times 100 forwards
after 20 at 480x640, 736x1280 and 1088x1920. ``--lists`` takes the manifests
from a directory laid out as ``datasets/lists`` (e.g. of a tree that
``datasets.fixtures.write_eval_trees`` wrote) instead of the vendored ones.
"""

from __future__ import annotations

import argparse
import os

import torch

from stereo_toolbox_tpu_torch import evaluation
from stereo_toolbox_tpu_torch.datasets import DataLoader, zoo
from stereo_toolbox_tpu_torch.models import MODEL_REGISTRY, create_model
from stereo_toolbox_tpu_torch.utils.weights import reference_state_dict

# the models `--max-disp` goes to (examples/eval.py:94-96, those ported),
# and every model that predicts disparity
TAKES_MAX_DISP = ("PSMNet", "GwcNet_G", "GwcNet_GC", "ACVNet", "CFNet",
                  "PCWNet_G", "PCWNet_GC", "IGEVStereo")
STEREO = TAKES_MAX_DISP + ("RAFTStereo", "DEFOMStereo_S", "DEFOMStereo_L")
DATA_SUITES = ("sceneflow", "generalization", "weather")
SUITES = DATA_SUITES + ("speed",)
LOADER_WORKERS = 2                  # examples/eval.py's
WEATHERS = ("sunny", "cloudy", "rainy", "foggy")
# generalization: loader name → (class, split, subdirectory of --root)
GENERALIZATION = {
    "kitti2015": (zoo.KITTI2015_Dataset, "train", "KITTI_2015"),
    "kitti2012": (zoo.KITTI2012_Dataset, "train", "KITTI_2012"),
    "middeval3": (zoo.MiddleburyEval3_Dataset, "trainH", "MiddEval3"),
    "eth3d": (zoo.ETH3D_Dataset, "train", "ETH3D"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="PSMNet",
                    choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--suite", default="sceneflow", choices=SUITES)
    ap.add_argument("--root", default=None,
                    help="dataset root (per-dataset subdirectories for "
                         "generalization)")
    ap.add_argument("--lists", default=None,
                    help="manifest directory laid out as datasets/lists "
                         "(default: the vendored manifests)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint of the port's trainer (torch.save)")
    ap.add_argument("--torch-ckpt", default=None,
                    help="the original toolbox's checkpoint (state_dict)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights without a checkpoint")
    ap.add_argument("--max-disp", type=int, default=192)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--write-json", default=None,
                    help="metrics JSON for the write-back regression gate")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain paths")
    return ap.parse_args(argv)


def build_model(args) -> torch.nn.Module:
    """The eval model of `args`, on its device, with its weights."""
    kwargs = {"max_disp": args.max_disp} if args.model in TAKES_MAX_DISP \
        else {}
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = create_model(args.model, device=args.device, dtype=dtype,
                         generator=torch.Generator().manual_seed(args.seed),
                         **kwargs)
    if args.torch_ckpt:
        model.load_state_dict(reference_state_dict(args.model,
                                                   args.torch_ckpt))
        print(f"loaded the original toolbox's checkpoint {args.torch_ckpt}")
    elif args.ckpt:
        ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        model.load_state_dict(ckpt["model"])
        print(f"loaded checkpoint {args.ckpt}")
    return model


def suite_loaders(suite: str, root: str, lists: str | None = None):
    """The loaders `suite` reads under `root`: one for sceneflow, a dict
    name → loader for generalization and weather; their manifests from
    `lists` (laid out as ``datasets/lists``) or the vendored ones."""
    def loader(cls, split, root_dir):
        manifest = None if lists is None else os.path.join(
            lists, cls.list_name, f"{split}.txt")
        return DataLoader(cls(split, training=False, root_dir=root_dir,
                              manifest=manifest),
                          batch_size=1, num_workers=LOADER_WORKERS,
                          shuffle=False)

    if suite == "sceneflow":
        return loader(zoo.SceneFlow_Dataset, "test_finalpass", root)
    if suite == "generalization":
        return {name: loader(cls, split, os.path.join(root, sub))
                for name, (cls, split, sub) in GENERALIZATION.items()}
    if suite == "weather":
        return {w: loader(zoo.DrivingStereo_Dataset, f"test_half_{w}", root)
                for w in WEATHERS}
    raise ValueError(f"{suite!r} reads no dataset")


def run_suite(suite: str, apply_fn, loaders, max_disp: int = 192,
              write_json: str | None = None):
    """`suite`'s metrics through `apply_fn` on `loaders` (`suite_loaders`),
    with the masks `examples/eval.py` gives each suite."""
    if suite == "sceneflow":
        return evaluation.sceneflow_test(apply_fn, loaders, maxdisp=max_disp,
                                         write_json=write_json)
    if suite == "generalization":
        return evaluation.generalization_eval(apply_fn, loaders,
                                              write_json=write_json)
    if suite == "weather":
        return evaluation.drivingstereo_weather_test(apply_fn, loaders,
                                                     write_json=write_json)
    raise ValueError(f"unknown data suite {suite!r}")


def main(argv=None):
    args = parse_args(argv)
    if args.suite != "speed" and args.root is None:
        raise SystemExit(f"--root is required for the data-driven "
                         f"'{args.suite}' suite (dataset root directory)")
    if args.suite != "speed" and args.model not in STEREO:
        raise SystemExit(f"{args.model} predicts no disparity: it runs the "
                         f"speed suite only")
    model = build_model(args)
    apply_fn = evaluation.make_apply(model)
    if args.suite == "speed":
        return evaluation.speed_and_memory_test(apply_fn, model)
    loaders = suite_loaders(args.suite, args.root, args.lists)
    result = run_suite(args.suite, apply_fn, loaders, args.max_disp,
                       args.write_json)
    print(f"{args.suite} metrics: {result.tolist()}")
    return result


if __name__ == "__main__":
    main()
