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
  gradient one pixel to the right (CFNet);
- ``k4_bwd_long_lane_dropped``: K4's backward kernel built from a copy of
  ``csrc/sample_gather.cu`` whose long-list warp path drops lane 31's
  entries (31, 63, ... of a list of more than 32; CFNet, and phase 6's K4-
  and K5-bwd kernel gates, `chip_smoke.check_samples_backward`, whose
  skewed rows make such lists).

Then DEFOMStereo_S's card-vs-CPU train step of phase 18
(`chip_smoke.compare_defom_train_step`: the loss, each group's gradient,
each K7-bwd launch against its plain version) clean and with each fault
planted into the card's step, and phase 7's K7-bwd kernel gates
(`chip_smoke.check_attention_backward`) under each fault:

- ``k7_bwd_dq_dropped``: K7-bwd's dq kernel returns dQ = 0;
- ``k7_bwd_last_key_tile_dropped``: K7-bwd's dkv kernels, built from a copy
  of ``csrc/vit_attention.cu`` whose blocks of the last key tile store
  nothing (their dK, dV stay as allocated: a ragged-tail fault; at 64x128
  the 33 tokens are one tile);
- ``k7_bwd_one_tf32_product``: K7-bwd's float32 design ("tf32x3") built
  from a copy of ``csrc/vit_attention.cu`` whose 3xTF32 step keeps hi·hi
  alone (the two products of a remainder taken out).

Then the same for phase 14's bfloat16 card-vs-CPU step
(`chip_smoke.compare_train_step_bf16`): clean (GwcNet_G, CFNet), and with
each fault planted into the card's bfloat16 step, printing which of its
gates caught it (`chip_smoke.bf16_step_failures`):

- ``bf16_masters_dropped``: the card's bfloat16 view is cut from its
  float32 masters (each cast a leaf of its own), so no gradient reaches a
  master (GwcNet_G);
- ``k1_bwd_dr_dropped`` in bfloat16: K1's backward kernel returns dr = 0
  (GwcNet_G).

The last line is one JSON object ``{"faults": [...]}``. Exits with code 1
if a clean run is outside the limits; a fault that passes is reported, not
raised. Needs one card.
"""

from __future__ import annotations

import contextlib
import functools
import json

import torch

import chip_smoke
from stereo_toolbox_tpu_torch import trainer as port_trainer
from stereo_toolbox_tpu_torch.nn.layers import FlaxRunningStats
from stereo_toolbox_tpu_torch.ops import _cuda, volume


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


# the load of K4-bwd's long-list warp path, and lane 31 leaving first
LONG_LOAD = "        load_shared<T, NV>(sg + (size_t)list[p] * cc + c, v);"
LONG_LOAD_FAULT = "        if (lane == 31) break;\n" + LONG_LOAD


@functools.cache
def long_lane_library():
    return _cuda.variant("sample_gather", "fault_k4_bwd_long_lane",
                         subs=((LONG_LOAD, LONG_LOAD_FAULT),))


def k4_bwd_long_lane_dropped():
    return _cuda.loaded_as("sample_gather", long_lane_library())


def k7_bwd_dq_dropped():
    launch = chip_smoke.port_attention._launch_backward

    def faulty(kind, q, k, v, do, lse, di, outs, scale):
        launch(kind, q, k, v, do, lse, di, outs, scale)
        if kind == "dq":
            outs[0].zero_()
    return patched(chip_smoke.port_attention, "_launch_backward", faulty)


# the store of K7-bwd-dkv's accumulators (both types), and the blocks of the
# last key tile leaving before it
DKV_STORE = ("    const int key = k0 + warp * 16 + g + 8 * r;\n"
             "    if (key >= N) continue;")
DKV_STORE_FAULT = ("    const int key = k0 + warp * 16 + g + 8 * r;\n"
                   "    if (key >= N || k0 + kTile >= N) continue;")
# the two products of a remainder in K7-bwd's 3xTF32 step
LOW_PRODUCTS = ("  mma::mma_tf32(d, al, bh0, bh1);\n"
                "  mma::mma_tf32(d, ah, bl0, bl1);\n")


@functools.cache
def last_key_tile_library():
    return _cuda.variant("vit_attention", "fault_k7_bwd_last_key_tile",
                         subs=((DKV_STORE, DKV_STORE_FAULT),))


def k7_bwd_last_key_tile_dropped():
    return _cuda.loaded_as("vit_attention", last_key_tile_library())


@functools.cache
def one_tf32_product_library():
    return _cuda.variant("vit_attention", "fault_k7_bwd_one_tf32_product",
                         subs=((LOW_PRODUCTS, ""),))


def k7_bwd_one_tf32_product():
    return _cuda.loaded_as("vit_attention", one_tf32_product_library())


def phase7_k7_bwd_gate() -> bool:
    """Whether phase 7's K7-bwd gates (`check_attention_backward`) fail."""
    try:
        chip_smoke.check_attention_backward(
            torch.Generator().manual_seed(1234))
    except RuntimeError as err:
        print(f"  {err}")
        return True
    return False


def bf16_masters_dropped():
    view = port_trainer.bfloat16_view

    def faulty(model):
        return {k: (v.detach().requires_grad_() if v.is_cuda else v)
                for k, v in view(model).items()}
    return patched(port_trainer, "bfloat16_view", faulty)


def phase6_k4_bwd_gate() -> bool:
    """Whether phase 6's K4/K5-bwd gates (`check_samples_backward`) fail."""
    try:
        chip_smoke.check_samples_backward(torch.Generator().manual_seed(1234))
    except RuntimeError as err:
        print(f"  {err}")
        return True
    return False


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
    ("k4_bwd_long_lane_dropped", k4_bwd_long_lane_dropped, ("CFNet",)),
)
# faults also put to phase 6's kernel gates
KERNEL_GATES = {"k4_bwd_long_lane_dropped": phase6_k4_bwd_gate}
RUNS_DEFOM = (
    ("clean", None),
    ("k7_bwd_dq_dropped", k7_bwd_dq_dropped),
    ("k7_bwd_last_key_tile_dropped", k7_bwd_last_key_tile_dropped),
    ("k7_bwd_one_tf32_product", k7_bwd_one_tf32_product),
)
RUNS_BF16 = (
    ("clean", None, ("GwcNet_G", "CFNet")),
    ("bf16_masters_dropped", bf16_masters_dropped, ("GwcNet_G",)),
    ("k1_bwd_dr_dropped", k1_bwd_dr_dropped, ("GwcNet_G",)),
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
        if fault in KERNEL_GATES:
            print(f"{fault}: phase 6 kernel gates")
            with plant():
                caught = KERNEL_GATES[fault]()
            print(f"  {'caught' if caught else 'within the limits'}")
            rows.append({"fault": fault, "model": "phase 6 kernel gates",
                         "caught": caught})
    for fault, plant in RUNS_DEFOM:
        name = chip_smoke.DEFOM
        print(f"{fault}: {name}")
        with plant() if plant else contextlib.nullcontext():
            row = chip_smoke.compare_defom_train_step()
        within = chip_smoke.defom_step_within_limits(row)
        print(f"  {'within the limits' if within else 'caught'}")
        if fault == "clean":
            clean_ok &= within
        rows.append({"fault": fault, "model": name, "caught": not within,
                     **row})
        if plant:
            print(f"{fault}: phase 7 K7-bwd kernel gates")
            with plant():
                caught = phase7_k7_bwd_gate()
            print(f"  {'caught' if caught else 'within the limits'}")
            rows.append({"fault": fault, "model": "phase 7 K7-bwd gates",
                         "caught": caught})
    for fault, plant, models in RUNS_BF16:
        for name in models:
            print(f"{fault} (bfloat16 step): {name}")
            with plant() if plant else contextlib.nullcontext():
                row = chip_smoke.compare_train_step_bf16(name)
            failed = chip_smoke.bf16_step_failures(row)
            print("  " + ("caught by " + ", ".join(failed) if failed
                          else "within the gates"))
            if fault == "clean":
                clean_ok &= not failed
            rows.append({"fault": fault, "dtype": "bfloat16", "model": name,
                         "caught": bool(failed), "caught_by": failed,
                         **{k: v for k, v in row.items()
                            if k not in ("designs",)}})
    print(json.dumps({"faults": rows}))
    if not clean_ok:
        raise SystemExit("a clean run is outside the limits")


if __name__ == "__main__":
    main()
