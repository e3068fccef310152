"""Sharded, prefetching batch loader (the port's copy of
``dynamo_depth_tpu.data.loader``).

In place of ``DataLoader`` + ``DistributedSampler`` (Trainer.py:519-551):
deterministic host-side index sampling, per-process sharding, a thread pool
for decode/augment, and a small prefetch queue. Batches are plain numpy
dicts with images (B, H, W, 3), exactly as the JAX package's; the trainer
moves them to the device.

Epoch resampling parity: when ``epoch_size > 0`` the reference draws
``batch_size * world_size * epoch_size`` filenames per epoch with replacement
iff the pool is smaller (Trainer.py:519-522); :func:`sample_epoch_filenames`
reproduces that with a seeded numpy RNG shared by all hosts (same draw on
every host, then sharded by index stride).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from dynamo_depth_torch.data.base import BaseDataset


def sample_epoch_filenames(filenames: List[str], epoch_size: int, global_batch: int,
                           seed: int) -> List[str]:
    """Per-epoch resampling of the training file list (Trainer.py:519-522)."""
    if epoch_size <= 0:
        return list(filenames)
    n = global_batch * epoch_size
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(filenames), n, replace=n > len(filenames))
    return [filenames[i] for i in idx]


def make_dataset(cfg, filenames, is_train=False, load_depth=False, load_mask=False,
                 img_type=None, dataset_cls=None):
    """Construct the dataset for cfg (Trainer.py:554-570)."""
    from dynamo_depth_torch.data import DATASETS

    cls = dataset_cls or DATASETS[cfg.dataset]
    return cls(
        data_path=cfg.data_path,
        filenames=filenames,
        height=cfg.height,
        width=cfg.width,
        cam_name=cfg.cam_name,
        img_type=img_type or cfg.train_img_type,
        frame_idxs=cfg.frame_ids,
        num_scales=len(cfg.scales),
        is_train=is_train,
        img_ext=cfg.img_ext,
        load_depth=load_depth,
        load_mask=load_mask,
        seed=cfg.seed,
    )


def collate(items: List[Dict]) -> Dict:
    out = {}
    for k in items[0]:
        out[k] = np.stack([it[k] for it in items], axis=0)
    return out


class BatchLoader:
    """Iterable over collated numpy batches with thread-pool prefetch.

    :param shard: (shard_index, shard_count) — this host's slice of batches.
    """

    def __init__(
        self,
        dataset: BaseDataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        num_workers: int = 2,
        seed: int = 0,
        shard=(0, 1),
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_index, self.shard_count = shard
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batch_indices(self) -> List[List[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + 7919 * self.epoch).shuffle(order)
        # Global batches, strided across hosts so every host sees the same
        # number of equally-sized batches: a whole number of batches per
        # host, or the others would wait in a collective for the last one.
        num_batches = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        num_batches -= num_batches % self.shard_count
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size].tolist()
            for i in range(num_batches)
        ]
        return batches[self.shard_index :: self.shard_count]

    def __len__(self):
        return len(self._batch_indices())

    def __iter__(self):
        batches = self._batch_indices()
        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_batch(idxs):
            rngs = [
                np.random.RandomState((self.seed * 1_000_003 + self.epoch * 97 + i) % (2 ** 31))
                for i in idxs
            ]
            items = [self.dataset.get_item(i, rng=r) for i, r in zip(idxs, rngs)]
            return collate(items)

        def producer():
            try:
                futures = [ex.submit(load_batch, b) for b in batches]
                for f in futures:
                    if stop.is_set():
                        break
                    try:
                        q.put(f.result())
                    except Exception as e:  # propagate to the consumer
                        q.put(e)
                        break
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            ex.shutdown(wait=False, cancel_futures=True)


def padded_eval_batches(dataset, batch_size: int, num_workers: int = 2, prefetch: int = 2,
                        shard=(0, 1)):
    """Yield (batch, real_indices) over a dataset in order, padding the final
    batch to full size by repeating the last item (keeps jit shapes static;
    eval CLIs weight metrics by the real count). Batches are prepared by a
    thread pool and prefetched.

    ``batch_size`` is GLOBAL. Under multi-process eval (``shard=(pid,
    nproc)``) each host materializes only its contiguous row-slice of every
    global batch — rows ``[pid*local : (pid+1)*local]`` — and
    ``Trainer.put_batch`` reassembles the global batch on device
    (DistributedSampler eval semantics, reference Trainer.py:546-551, with
    host-side IO sharded instead of replicated). ``real_indices`` always
    lists the GLOBAL real indices of the batch, identical on every host, so
    metric accumulation needs no cross-host reduction."""
    pid, nproc = shard
    assert batch_size % nproc == 0, (batch_size, nproc)
    local = batch_size // nproc
    n = len(dataset)
    starts = list(range(0, n, batch_size))

    def load(start):
        idxs = list(range(start, min(start + batch_size, n)))
        real = list(idxs)
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        mine = idxs[pid * local:(pid + 1) * local]
        return collate([dataset.get_item(i) for i in mine]), real

    ex = ThreadPoolExecutor(max_workers=max(1, num_workers))
    try:
        futures = [ex.submit(load, s) for s in starts[: prefetch + 1]]
        next_submit = prefetch + 1
        for i in range(len(starts)):
            if next_submit < len(starts):
                futures.append(ex.submit(load, starts[next_submit]))
                next_submit += 1
            yield futures[i].result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
