"""Where a data-parallel train step at world 1 spends the time that the
one-process step does not: GwcNet_G at 256x512, B 4, max_disp 192, f32 and
bf16 on f32 masters, one NCCL rank on the card.

    python3 chip_dp_overhead.py        # on a machine with a card

Each variant's six steps after two warm ones are timed (host clock to a
synchronize; the median and the six): the one-process step; the mesh's
step; the mesh's step with every `parallel.all_reduce_sum` an identity (no
collective but the valid count's); the mesh's step with BatchNorm on its
one-process path (`parallel.batch_statistics_mesh` returning None: only
the count and the gradient buckets reduced). Then one step of the
one-process and of the mesh's step under `torch.profiler`: the top ops by
host time and by device time.
"""
import statistics
import subprocess
import tempfile
import time

import torch

from stereo_toolbox_tpu_torch import parallel
from stereo_toolbox_tpu_torch.datasets import (DataLoader,
                                               SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.ops import _cuda
from stereo_toolbox_tpu_torch.trainer import (TrainConfig, init_train_state,
                                              make_train_step, to_device)

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60).stdout.strip())
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_cuda.build()
for lib in _cuda.SIGNATURES:
    _cuda.library(lib)
H, W, B = 256, 512, 4
batch = next(iter(DataLoader(SyntheticStereoDataset(
    num_samples=B, height=H + 64, width=W + 64, max_disp=96, training=True,
    crop_size=(H, W), seed=8), batch_size=B, shuffle=True, seed=8,
    drop_last=True, num_workers=0)))
batch = to_device(batch, "cuda")
config = TrainConfig(max_disp=192, loss="multihead",
                     loss_weights=(0.5, 0.5, 0.7, 1.0))
tmp = tempfile.mkdtemp()
parallel.init_distributed(torch.device("cuda", 0),
                          init_method=f"file://{tmp}/store", rank=0,
                          world_size=1)
mesh = parallel.make_mesh()


def run(dtype, use_mesh, iters=6, prof=False):
    model = create_model("GwcNet_G", max_disp=192,
                         generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, config, 100, dtype)
    step = make_train_step(model, config, dtype,
                           mesh=mesh if use_mesh else None)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if prof:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        ka = p.key_averages()
        print("  top by self CPU:")
        print(ka.table(sort_by="self_cpu_time_total", row_limit=14,
                       max_name_column_width=50))
        print("  top by device:")
        print(ka.table(sort_by="self_device_time_total", row_limit=14,
                       max_name_column_width=50))
    return statistics.median(times), times


class patched:
    def __init__(self, obj, attr, value):
        self.obj, self.attr, self.value = obj, attr, value

    def __enter__(self):
        self.saved = getattr(self.obj, self.attr)
        setattr(self.obj, self.attr, self.value)

    def __exit__(self, *a):
        setattr(self.obj, self.attr, self.saved)


for dtype in (torch.float32, torch.bfloat16):
    print(dtype)
    print("  one process", run(dtype, False))
    print("  mesh", run(dtype, True))
    with patched(parallel, "all_reduce_sum", lambda ts, mesh: ts):
        print("  mesh, no all_reduce_sum collectives", run(dtype, True))
    with patched(parallel, "batch_statistics_mesh", lambda: None):
        print("  mesh, BatchNorm on the one-process path", run(dtype, True))
    print("  one process, profiled", run(dtype, False, iters=1, prof=True)[0])
    print("  mesh, profiled", run(dtype, True, iters=1, prof=True)[0])
torch.distributed.destroy_process_group()
