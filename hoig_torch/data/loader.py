"""Dataset factory and batching loader (port of hoig_tpu/data/loader.py).

Batch, shuffle and drop_last; per-process index sharding with a per-epoch
reseed (DistributedSampler.set_epoch); a background thread prefetches
collated batches, with a thread pool that builds each batch's samples.
Batches stay numpy on the host: the model facade moves them to the card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_DONE = object()


def numpy_collate(samples: list) -> dict:
    """List of sample dicts -> dict of stacked arrays (strings -> lists)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], dict):
            out[key] = numpy_collate(vals)
        elif isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class ShardedSampler:
    """DistributedSampler equivalent: a contiguous per-process shard of a
    per-epoch permutation."""

    def __init__(self, n: int, num_shards: int = 1, shard_index: int = 0, shuffle: bool = True,
                 seed: int = 0):
        self.n = n
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self):
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(self.n)
        else:
            order = np.arange(self.n)
        per = self.n // self.num_shards
        start = self.shard_index * per
        return order[start: start + per]


class DataLoader:
    """Map-style dataset -> iterator of collated numpy batches.

    A producer thread keeps up to `prefetch` batches ready. An exception
    raised while a batch is built reaches the consumer at that batch; a
    consumer that stops early stops the producer."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0, prefetch: int = 2, seed: int = 0,
                 num_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.sampler = ShardedSampler(len(dataset), num_shards, shard_index, shuffle, seed)
        self.prefetch = prefetch
        self.num_threads = max(1, num_threads)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idx = self.sampler.indices()
        batches = [idx[i * self.batch_size: (i + 1) * self.batch_size] for i in range(len(self))]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in batches:
                        if not put(numpy_collate(list(pool.map(self.dataset.__getitem__, b)))):
                            return
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(_DONE)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            producer.join(timeout=10)


class DatasetFactory:
    """Name -> dataset: 'hov3', 'ycb' and the fixture mode 'synthetic'."""

    @staticmethod
    def get_by_name(dataset_name: str, opt, is_for_train: bool):
        if dataset_name == "hov3":
            from hoig_torch.data.hov3_dataset import HOv3Dataset

            ds = HOv3Dataset(opt, is_for_train)
        elif dataset_name == "ycb":
            from hoig_torch.data.ycb_dataset import YCBDataset

            ds = YCBDataset(opt, is_for_train)
        elif dataset_name == "synthetic":
            from hoig_torch.data.synthetic_dataset import SyntheticDataset

            ds = SyntheticDataset(opt, is_for_train)
        else:
            raise ValueError(f"Dataset [{dataset_name}] not recognized.")
        print(f"Dataset {ds.name} was created")
        return ds


class CustomDatasetDataLoader:
    """The reference's loader wrapper: dataset from --dataset_mode, batch
    from --batch_size (per device), threads from --n_threads_train/test."""

    def __init__(self, opt, is_for_train: bool = True, use_ddp: bool = False, num_shards: int = 1,
                 shard_index: int = 0):
        from hoig_torch.parallel import per_process_batch_size

        self._opt = opt
        self._dataset = DatasetFactory.get_by_name(opt.dataset_mode, opt, is_for_train)
        threads = opt.n_threads_train if is_for_train else opt.n_threads_test
        self._dataloader = DataLoader(
            self._dataset,
            batch_size=per_process_batch_size(opt),
            shuffle=not getattr(opt, "serial_batches", False),
            drop_last=use_ddp or is_for_train,
            num_shards=num_shards if use_ddp else 1,
            shard_index=shard_index if use_ddp else 0,
            num_threads=int(threads),
        )

    @property
    def dataset(self):
        return self._dataset

    def load_data(self):
        return self._dataloader

    def load_sampler(self):
        return self._dataloader.sampler

    def __len__(self):
        return len(self._dataset)
