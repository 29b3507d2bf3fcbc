"""Evaluation suites: SceneFlow, zero-shot generalization, DrivingStereo
weather, speed & memory (PyTorch).

Counterpart of ``stereo_toolbox_tpu/evaluation/__init__.py``, with its
protocol (the original toolbox's evaluation/*.py):

  * batch 1, valid pixels ``0 < d < maxdisp - 1``;
  * metrics accumulated per image, then divided by the image count
    (sceneflow_test.py:39-47; generalization_eval.py:44-60 counts images
    per region); an image with no valid pixel is skipped and not counted;
  * outlier rates in percent;
  * generalization thresholds [3, 3, 2, 1] px for KITTI15 / KITTI12 /
    MiddEval3 / ETH3D (generalization_eval.py:13);
  * speed test: 20 warm-up and 100 timed forwards
    (speed_and_memory_test.py), on the card timed with CUDA events, its
    peak memory from ``torch.cuda.max_memory_allocated``.

The suites take ``apply_fn(left, right) → [B, H, W]`` float32 on the
model's device; `make_apply` builds one from a model. The metrics are
computed where the prediction lies (the ground truth is moved there), so a
suite runs on the card when the model does. Evaluation pads to multiples of
96 in the dataset (eval mode).

Each suite can write its metrics into a JSON file (the original's
checkpoint write-back, sceneflow_test.py:49-56) through ``write_json``:
the first run records them, later runs compare and raise on drift
(`_write_back`, the JAX package's file layout and keys, so one file serves
both packages).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch

from stereo_toolbox_tpu_torch import metrics as M
from stereo_toolbox_tpu_torch.trainer import make_eval_step

RESOLUTIONS = [(480, 640), (736, 1280), (1088, 1920)]
GENERALIZATION_THRESHOLDS = [3, 3, 2, 1]


def make_apply(model: torch.nn.Module) -> Callable:
    """Eval-mode forward ``apply_fn(left, right) → [B, H, W]`` float32 on
    the model's device, under ``torch.inference_mode()``, a float32 model
    inside ``full_float32`` (`trainer.make_eval_step`, whose prediction is
    cast to float32 here, as the JAX package's `make_apply` casts it)."""
    step = make_eval_step(model)

    def apply_fn(left, right):
        return step(left, right).float()
    return apply_fn


def _write_back(write_json: str | None, key: str, value,
                tolerance: float = 1e-3) -> None:
    """Metric write-back / regression gate (sceneflow_test.py:49-56).

    The first run records the metrics; later runs compare against the
    stored golden values and raise on drift beyond `tolerance` (the
    original only prints old and new)."""
    if not write_json:
        return
    data = {}
    if os.path.exists(write_json):
        with open(write_json) as f:
            data = json.load(f)
    if key in data:
        old = np.asarray(data[key], np.float64)
        new = np.asarray(value, np.float64)
        if old.shape != new.shape:
            raise AssertionError(
                f"{key} metric vector shape changed: golden {old.shape} vs "
                f"current {new.shape} — the metric layout is incompatible "
                f"with the stored goldens in {write_json}; regenerate them")
        drift = float(np.max(np.abs(old - new)))
        print(f"original {key} metrics: {old.tolist()}")
        print(f"current  {key} metrics: {new.tolist()}")
        if drift > tolerance:
            raise AssertionError(
                f"{key} metrics drifted by {drift:.6f} (> {tolerance}) vs "
                f"golden values in {write_json}")
    else:
        data[key] = np.asarray(value).tolist()
        with open(write_json, "w") as f:
            json.dump(data, f, indent=2)


def _eval_loop(apply_fn, loader, maxdisp: int, thresholds=(1, 2, 3),
               progress: str | None = None):
    """Shared inner loop: per-image EPE + outlier accumulation."""
    sums = np.zeros(1 + len(thresholds))
    n_img = 0
    for data in loader:
        gt = torch.as_tensor(data["gt_disp"])
        if not M.valid_mask(gt, maxdisp).any():
            continue
        pred = apply_fn(data["left"], data["right"])
        gt = gt.to(pred.device)
        res = M.epe_and_outliers(pred, gt, M.valid_mask(gt, maxdisp),
                                 thresholds)
        row = torch.stack([res["epe"].sum()] + [
            res[f"out_{int(t)}px"].sum() for t in thresholds])
        row = row.double().cpu().numpy()            # one sync an image
        sums[0] += row[0]
        sums[1:] += row[1:] * 100.0
        n_img += int(gt.shape[0])
        if progress and n_img % 50 == 0:
            print(f"{progress}: {n_img} images, EPE "
                  f"{sums[0] / n_img:.4f}px", flush=True)
    return sums / max(n_img, 1), n_img


def sceneflow_test(apply_fn, loader, maxdisp: int = 192,
                   write_json: str | None = None,
                   write_key: str = "sceneflow") -> np.ndarray:
    """SceneFlow finalpass test: [EPE, >1px%, >2px%, >3px%]
    (evaluation/sceneflow_test.py:13-58)."""
    result, _ = _eval_loop(apply_fn, loader, maxdisp, (1, 2, 3),
                           progress="SceneFlow")
    _write_back(write_json, write_key, result)
    return result


def generalization_eval(apply_fn, loaders: dict,
                        thresholds: dict | None = None, maxdisp: int = 192,
                        write_json: str | None = None,
                        write_key: str = "generalization") -> np.ndarray:
    """Zero-shot transfer eval with the occ/noc decomposition.

    Args:
      loaders: ordered dict name → loader (canonically kitti2015,
        kitti2012, middeval3, eth3d).
      thresholds: name → outlier threshold px; defaults to the original's
        [3, 3, 2, 1] by position (generalization_eval.py:13).

    Returns:
      ``[n_datasets, 4]`` rows [EPE, occ%, noc%, all%]
      (generalization_eval.py:26-60), each region averaged over the images
      where it holds a pixel. A NaN noc mask (no noc file) makes every valid
      pixel occluded, so such an image counts in no noc average
      (`metrics.occ_noc_split`).
    """
    out = np.zeros((len(loaders), 4))
    for idx, (name, loader) in enumerate(loaders.items()):
        default = GENERALIZATION_THRESHOLDS
        t = (thresholds or {}).get(
            name, default[idx] if idx < len(default) else 3)
        sums = np.zeros(4)
        counts = np.zeros(4)
        for data in loader:
            pred = apply_fn(data["left"], data["right"])
            gt = torch.as_tensor(data["gt_disp"]).to(pred.device)
            noc = torch.as_tensor(data["noc_mask"]).to(pred.device)
            all_m, noc_m, occ_m = M.occ_noc_split(M.valid_mask(gt, maxdisp),
                                                  noc)
            err = (pred - torch.where(all_m, gt, torch.zeros_like(gt))).abs()
            regions = (all_m, occ_m, noc_m, all_m)
            nums = torch.stack([m.sum() for m in regions])
            values = [M.masked_mean(err, all_m)] + [
                ((err > t) & m).sum() / nums[j]
                for j, m in enumerate(regions) if j > 0]
            row = torch.cat([nums.double(), torch.stack(values).double()])
            row = row.cpu().numpy()                 # one sync an image
            for j in range(4):
                if row[j] == 0:
                    continue
                counts[j] += 1
                sums[j] += row[4 + j] * (1.0 if j == 0 else 100.0)
        out[idx] = sums / np.maximum(counts, 1)
        print(f"{name} EPE: {out[idx][0]:.4f}px, OCC: {out[idx][1]:.4f}%, "
              f"NOC: {out[idx][2]:.4f}%, ALL: {out[idx][3]:.4f}%.")
    _write_back(write_json, write_key, out)
    return out


def drivingstereo_weather_test(apply_fn, loaders: dict,
                               threshold: float = 3.0, maxdisp: int = 192,
                               write_json: str | None = None,
                               write_key: str = "ds_weather_test"
                               ) -> np.ndarray:
    """Per-weather [EPE, >3px%] (evaluation/drivingstereo_weather_test.py)."""
    out = np.zeros((len(loaders), 2))
    for idx, (name, loader) in enumerate(loaders.items()):
        sums, _ = _eval_loop(apply_fn, loader, maxdisp, (threshold,),
                             progress=name)
        out[idx] = sums[:2]
        print(f"DrivingStereo {name}: EPE: {out[idx][0]:.4f}px, "
              f"Outliers: {out[idx][1]:.4f}%.")
    _write_back(write_json, write_key, out)
    return out


def suite_slack(frames, preds, thresholds, tol: float, epe_tol: float,
                maxdisp: int = 192, regions: bool = False) -> np.ndarray:
    """How far each entry of a suite's metric vector may move when every
    prediction moves by at most `tol` px and its mean error by `epe_tol`:
    each EPE by `epe_tol`; each outlier rate by 100·k/valid, averaged as
    the suite averages, where k counts the valid pixels whose error in
    `preds` lies within `tol` of the threshold (only those can cross it).

    `frames` are the loader's batches and `preds` the predictions on them
    (numpy). ``regions=False``: `_eval_loop`'s [EPE, out(t) for t in
    `thresholds`]; ``regions=True``: a `generalization_eval` row [EPE, occ,
    noc, all] at the one threshold ``thresholds[0]``."""
    thresholds = tuple(thresholds)
    sums = np.zeros(4 if regions else 1 + len(thresholds))
    counts = np.zeros_like(sums)
    for data, pred in zip(frames, preds):
        gt = np.asarray(data["gt_disp"], np.float32)
        with np.errstate(invalid="ignore"):
            valid = np.isfinite(gt) & (gt > 0) & (gt < maxdisp - 1)
        err = np.abs(np.asarray(pred, np.float32) - np.where(valid, gt, 0))
        if regions:
            noc = np.asarray(data["noc_mask"], np.float32)
            with np.errstate(invalid="ignore"):
                noc_m = np.isfinite(noc) & (noc > 0.5) & valid
            near = np.abs(err - thresholds[0]) <= tol
            for j, m in enumerate((valid, valid & ~noc_m, noc_m, valid)):
                if not m.any():
                    continue
                counts[j] += 1
                sums[j] += epe_tol if j == 0 else (
                    100.0 * (near & m).sum() / m.sum())
            continue
        if not valid.any():
            continue
        for b in range(gt.shape[0]):
            v = max(int(valid[b].sum()), 1)
            sums[0] += epe_tol
            for i, t in enumerate(thresholds):
                sums[1 + i] += 100.0 * (
                    (np.abs(err[b] - t) <= tol) & valid[b]).sum() / v
            counts += 1
    return sums / np.maximum(counts, 1)


def count_params(model: torch.nn.Module) -> tuple[int, int]:
    """(total, learnable) parameter counts. BatchNorm running statistics are
    the non-learnable share (speed_and_memory_test.py:30-33), as the JAX
    package counts its ``batch_stats``."""
    learnable = sum(p.numel() for p in model.parameters())
    stats = sum(b.numel() for name, b in model.named_buffers()
                if name.rsplit(".", 1)[-1] in ("running_mean", "running_var"))
    return learnable + stats, learnable


def speed_and_memory_test(apply_fn, model: torch.nn.Module,
                          resolutions=None, batch_size: int = 1,
                          num_iterations: int = 100, warmup: int = 20,
                          dtype: torch.dtype = torch.float32, seed: int = 0):
    """Per-resolution mean latency (s) and peak device memory (MB).

    Parity: evaluation/speed_and_memory_test.py:11-79, the same default
    resolution ladder. The input of each resolution is drawn afresh from a
    ``torch.Generator`` seeded `seed` (the JAX package's ``PRNGKey(0)``
    each resolution) and put on the model's device. On the card: CUDA
    events around the timed forwards, the peak of
    ``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
    over that resolution's runs. On the CPU: ``perf_counter``, memory NaN
    (the JAX package's without device statistics)."""
    total, learnable = count_params(model)
    print(f"Total number of parameters: {total / 1e6:.2f}M")
    print(f"Learnable parameters: {learnable / 1e6:.2f}M")

    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    resolutions = resolutions or RESOLUTIONS
    avg_times, avg_memories = [], []
    for res in resolutions:
        gen = torch.Generator().manual_seed(seed)
        x = torch.randn((batch_size, *res, 3), generator=gen).to(dtype)
        x = x.to(device)
        mem = np.nan
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        for _ in range(warmup):
            apply_fn(x, x)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(num_iterations):
                apply_fn(x, x)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / num_iterations
            mem = torch.cuda.max_memory_allocated(device) / 1024 ** 2
        else:
            t0 = time.perf_counter()
            for _ in range(num_iterations):
                apply_fn(x, x)
            dt = (time.perf_counter() - t0) / num_iterations
        avg_times.append(dt)
        avg_memories.append(mem)
        print(f"Resolution: {res}, Avg Time: {dt:.4f} s, "
              f"Avg Frequency: {1 / dt:.4f} Hz, Peak Memory: {mem:.2f} MB")
    return resolutions, avg_times, avg_memories


__all__ = ["GENERALIZATION_THRESHOLDS", "RESOLUTIONS", "count_params",
           "drivingstereo_weather_test", "generalization_eval", "make_apply",
           "sceneflow_test", "speed_and_memory_test", "suite_slack"]
