"""Planted faults against `chip_smoke.py`'s card-vs-CPU train step check.

    python3 chip_train_faults.py

Phase 14 of `chip_smoke.py` holds one float32 train step of each model it
trains on the card against the same step on the port's CPU paths (64x128,
B 2, max_disp 192) within its limits on the loss, the gradients and the
BatchNorm running statistics. This script runs that comparison clean,
where it must hold, and then with one fault planted into the card's step
at a time, and prints for each run its readings and whether the limits
caught it:

- ``k1_bwd_dr_dropped``: K1's backward kernel returns dr = 0 (GwcNet_G);
- ``k1_bwd_last_disparity_dropped``: K1's backward sums d < D - 1 only,
  as a kernel whose loop stops one disparity short would (GwcNet_G);
- ``bn_unbiased_running_var``: the card's BatchNorms update their running
  variance by PyTorch's rule (the unbiased batch variance) instead of
  flax's (PSMNet, GwcNet_G);
- ``k6_bwd_dr_dropped``: K6's backward kernel returns dr = 0 (GwcNet_GC,
  ACVNet, CFNet);
- ``k5_bwd_scatter_dropped``: K5's backward kernel returns dr = 0, its
  scatter (CFNet);
- ``k4_bwd_shifted``: K4's backward kernel writes each right pixel's
  gradient one pixel to the right (CFNet).

The last line is one JSON object ``{"faults": [...]}``. Exits with code 1
if a clean run is outside the limits; a fault that passes is reported, not
raised. Needs one card.
"""

from __future__ import annotations

import contextlib
import json

import torch

import chip_smoke
from stereo_toolbox_tpu_torch.nn.layers import FlaxRunningStats
from stereo_toolbox_tpu_torch.ops import volume


@contextlib.contextmanager
def patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def k1_bwd_dr_dropped():
    launch = volume._launch_gwc_backward

    def faulty(left, right, grad, max_disp, num_groups):
        dl, dr = launch(left, right, grad, max_disp, num_groups)
        return dl, torch.zeros_like(dr)
    return patched(volume, "_launch_gwc_backward", faulty)


def k1_bwd_last_disparity_dropped():
    launch = volume._launch_gwc_backward

    def faulty(left, right, grad, max_disp, num_groups):
        grad = grad.clone()
        grad[:, -1] = 0
        return launch(left, right, grad, max_disp, num_groups)
    return patched(volume, "_launch_gwc_backward", faulty)


def bn_unbiased_running_var():
    flax_forward = FlaxRunningStats.forward

    def faulty(self, x):
        if x.is_cuda:
            return super(FlaxRunningStats, self).forward(x)
        return flax_forward(self, x)
    return patched(FlaxRunningStats, "forward", faulty)


def k6_bwd_dr_dropped():
    launch = volume._launch_concat_backward

    def faulty(grad, max_disp, mask_left):
        dl, dr = launch(grad, max_disp, mask_left)
        return dl, torch.zeros_like(dr)
    return patched(volume, "_launch_concat_backward", faulty)


def k5_bwd_scatter_dropped():
    launch = volume._launch_gwc_samples_backward

    def faulty(*args):
        dl, dr = launch(*args)
        return dl, torch.zeros_like(dr)
    return patched(volume, "_launch_gwc_samples_backward", faulty)


def k4_bwd_shifted():
    launch = volume._launch_gather_backward

    def faulty(*args):
        dright = launch(*args)
        shifted = torch.zeros_like(dright)
        shifted[:, :, 1:] = dright[:, :, :-1]
        return shifted
    return patched(volume, "_launch_gather_backward", faulty)


RUNS = (
    ("clean", None, chip_smoke.TRAIN_MODELS),
    ("k1_bwd_dr_dropped", k1_bwd_dr_dropped, ("GwcNet_G",)),
    ("k1_bwd_last_disparity_dropped", k1_bwd_last_disparity_dropped,
     ("GwcNet_G",)),
    ("bn_unbiased_running_var", bn_unbiased_running_var,
     ("PSMNet", "GwcNet_G")),
    ("k6_bwd_dr_dropped", k6_bwd_dr_dropped,
     ("GwcNet_GC", "ACVNet", "CFNet")),
    ("k5_bwd_scatter_dropped", k5_bwd_scatter_dropped, ("CFNet",)),
    ("k4_bwd_shifted", k4_bwd_shifted, ("CFNet",)),
)


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"limits: loss and running statistics {chip_smoke.TRAIN_REL}, "
          f"gradients (global relative L2, worst leaf) by model "
          f"{chip_smoke.TRAIN_GRAD}")
    rows, clean_ok = [], True
    for fault, plant, models in RUNS:
        for name in models:
            print(f"{fault}: {name}")
            with plant() if plant else contextlib.nullcontext():
                row = chip_smoke.compare_train_step(name)
            within = chip_smoke.train_step_within_limits(row)
            print(f"  {'within the limits' if within else 'caught'}")
            if fault == "clean":
                clean_ok &= within
            rows.append({"fault": fault, "model": name,
                         "caught": not within, **row})
    print(json.dumps({"faults": rows}))
    if not clean_ok:
        raise SystemExit("a clean run is outside the limits")


if __name__ == "__main__":
    main()
