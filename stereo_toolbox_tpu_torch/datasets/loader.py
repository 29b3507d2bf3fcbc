"""Host-side batching data loader with per-host sharding and prefetch.

The port's own copy of ``stereo_toolbox_tpu/datasets/loader.py`` (the same
order for the same seed and epoch), the counterpart of the reference's
`DataLoader` + `DistributedSampler` combo (trainer/trainer_torchrun.py:
126-142):

  * per-epoch seeded permutation shared by all hosts (epoch-seeded like
    `sampler.set_epoch`, trainer_torchrun.py:226-227);
  * each host takes a contiguous stride slice of the permutation with
    `drop_last=True` semantics (DistributedSampler parity);
  * worker threads decode samples ahead of consumption (the torch
    `num_workers=16` analogue — threads, not processes, since decode is
    numpy/PIL which releases the GIL for the heavy parts);
  * yields stacked numpy batches; the trainer moves them to the device
    from pinned memory.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
from typing import Iterator

import numpy as np


class ConcatDataset:
    """Concatenation of map-style datasets (the reference's multi-dataset
    mixed training, tests/train_accelerate.py:97-107: ConcatDataset of
    SceneFlow + Sintel + HR-VS + CREStereo).

    All member datasets must yield compatible sample dicts (same crop size
    in training). `set_epoch` is forwarded to every member.
    """

    def __init__(self, datasets: list):
        assert datasets, "ConcatDataset needs at least one dataset"
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int):
        if index < 0:
            index += len(self)
        k = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[k][index - int(self._offsets[k])]


def collate(samples: list[dict]) -> dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples], axis=0)
    return out


class DataLoader:
    """Map-style dataset → iterator of batched numpy dicts."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 8, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.process_count > 1:
            # DistributedSampler(drop_last=True) parity: equal shards.
            per = n // self.process_count
            order = order[self.process_index * per:(self.process_index + 1)
                          * per]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = self._indices()
        n_batches = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]

        if self.num_workers == 0:
            for idxs in batches:
                yield collate([self.dataset[int(i)] for i in idxs])
            return

        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            batch_iter = iter(batches)
            # prime the pipeline `prefetch` batches deep
            for _ in range(self.prefetch):
                idxs = next(batch_iter, None)
                if idxs is None:
                    break
                pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                for i in idxs])
            while pending:
                batch_futs = pending.popleft()
                idxs = next(batch_iter, None)
                if idxs is not None:
                    pending.append(
                        [pool.submit(self.dataset.__getitem__, int(i))
                         for i in idxs])
                yield collate([f.result() for f in batch_futs])
