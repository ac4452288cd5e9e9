"""Loader builder: dataset -> batched, prefetched numpy iterator (port of
``dist_tpu/data/builder.py``).

- Deterministic per-process index sharding: each process reads its own
  strided shard of the shuffled index stream (``process_index`` and
  ``process_count`` come from ``torch.distributed`` when it is
  initialised; one process, one card, otherwise). One rank is one data
  shard: its batch is the config's, and the global batch that times the
  world.
- MultiFold: a "fold epoch" concatenates ``NUM_FOLDS`` independently
  shuffled epochs.
- A thread pool decodes samples with a bounded window of per-sample
  futures across batch boundaries, so workers start batch k + 1 while
  batch k is stacked and consumed.
- For a CUDA run the stacked uint8 video goes into pinned host memory,
  so that the step's copy to the card can be asynchronous.

The index stream, the per-sample seeds, the padding of the final batch and
its ``_mask`` are the JAX package's, so both packages load the same
batches.
"""

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dist_tpu_torch.data import datasets  # noqa: F401  (registers them)
from dist_tpu_torch.data.base_dataset import DATASET_REGISTRY
from dist_tpu_torch.parallel.mesh import data_axis_size
from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.registry import Registry

COLLATE_FN_REGISTRY = Registry("CollateFn")

_PROCESS_POOL_TODO = ("DATA_LOADER.WORKER_TYPE: process (a process pool for "
                      "GIL-bound augmentation) is not ported yet (ROADMAP.md "
                      "queue A: data/rand_augment.py); use 'thread'")


@COLLATE_FN_REGISTRY.register()
class ZeroShotCollate:
    """Keep one shared text embedding per batch instead of per sample
    (reference dataset/utils/collate_functions.py:13-20)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, batch):
        if "text_embedding" in batch:
            batch["text_embedding"] = batch["text_embedding"][:1]
        return batch


def build_dataset(cfg, split):
    name = (cfg.TRAIN.DATASET if split in ("train", "val") else cfg.TEST.DATASET)
    if cfg.DATA.get("SYNTHETIC", False):
        name = "synthetic"
    cls = DATASET_REGISTRY.get_strict(str(name).capitalize())
    return cls(cfg, split)


def process_rank():
    """(process_index, process_count): torch.distributed's rank and world
    size when it is initialised, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Loader:
    """Batched iterator with per-epoch shuffling and threaded prefetch."""

    def __init__(self, dataset, batch_size, shuffle, drop_last, num_workers,
                 seed=0, num_folds=1, process_index=0, process_count=1,
                 prefetch=2, collate_fn=None, pin_memory=False):
        self.collate_fn = collate_fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))
        self.seed = seed
        self.num_folds = num_folds
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0
        self.skip_batches = 0
        self._stops = set()     # one event per open iteration

    def close(self):
        """Stop the producer of every iteration still open (one abandoned
        by its consumer); its thread pool shuts down with it."""
        for stop in list(self._stops):
            stop.set()

    def set_epoch(self, epoch):
        self.epoch = epoch

    def set_skip_batches(self, n):
        """One-shot: the NEXT iteration skips its first ``n`` batches.
        The index stream is a pure function of (seed, epoch, folds,
        process), so skipping the consumed prefix resumes a preempted
        epoch exactly."""
        self.skip_batches = int(n)

    def _epoch_indices(self):
        """Global shuffled stream for this (fold-)epoch, process-sharded.
        Returns ``(indices, valid)``: ``valid`` marks true stream entries
        against the pad duplicates that give every process the same
        count, so eval metrics can exclude the pads."""
        n = len(self.dataset)
        chunks = []
        for fold in range(self.num_folds):
            idx = np.arange(n)
            if self.shuffle:
                rng = np.random.default_rng(
                    (self.seed, self.epoch, fold).__hash__() & 0x7FFFFFFF)
                rng.shuffle(idx)
            chunks.append(idx)
        idx = np.concatenate(chunks)
        valid = np.ones(len(idx), np.bool_)
        per_host = int(np.ceil(len(idx) / self.process_count))
        pad = per_host * self.process_count - len(idx)
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
            valid = np.concatenate([valid, np.zeros(pad, np.bool_)])
        sl = slice(self.process_index, None, self.process_count)
        return idx[sl], valid[sl]

    def __len__(self):
        n = len(self._epoch_indices()[0])
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def _sample_seed(self, pos):
        """Per-sample augmentation seed: pure in (loader seed, epoch,
        process, stream position). Position, not index, so MultiFold and
        pad repeats of one sample draw fresh augmentations, and a resume
        that skips whole batches replays the exact stream."""
        return hash((self.seed, self.epoch, self.process_index, int(pos))) \
            & 0x7FFFFFFF

    def _plan(self):
        """[(indices, seeds, mask)] per batch of this iteration: the final
        batch padded by cycling the stream (static shapes), its pads
        marked 0 in the mask; the first ``skip_batches`` dropped."""
        indices, valid = self._epoch_indices()
        batches = []
        pos = 0
        for s in range(0, len(indices), self.batch_size):
            chunk = indices[s:s + self.batch_size]
            mask = valid[s:s + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    continue
                pad = np.resize(indices, self.batch_size - len(chunk))
                chunk = np.concatenate([chunk, pad])
                mask = np.concatenate(
                    [mask, np.zeros(self.batch_size - len(mask), np.bool_)])
            seeds = [self._sample_seed(pos + j) for j in range(len(chunk))]
            pos += len(chunk)
            batches.append((chunk, seeds, mask))
        if self.skip_batches:
            # a skip past the whole epoch means the geometry changed since
            # the checkpoint: fail rather than train zero batches
            if self.skip_batches >= len(batches):
                raise ValueError(
                    f"resume skip {self.skip_batches} >= epoch length "
                    f"{len(batches)}: loader geometry changed since the "
                    "mid-epoch checkpoint")
            batches = batches[self.skip_batches:]
            self.skip_batches = 0
        return batches

    def _stack(self, samples, mask):
        batch = {}
        for k in samples[0]:
            if k == "video" and self.pin_memory:
                first = samples[0][k]
                out = torch.empty((len(samples),) + first.shape,
                                  dtype=torch.from_numpy(first).dtype,
                                  pin_memory=True)
                np.stack([s[k] for s in samples], out=out.numpy())
                batch[k] = out
            else:
                batch[k] = np.stack([s[k] for s in samples])
        if not self.drop_last:
            # validity column for eval metrics: 0.0 marks process-shard
            # and final-batch pad duplicates
            batch["_mask"] = mask.astype(np.float32)
        if self.collate_fn is not None:
            batch = self.collate_fn(batch)
        return batch

    def __iter__(self):
        batches = self._plan()
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        self._stops.add(stop)

        def put(item):
            # never block forever: the consumer may abandon the iterator,
            # whose finally sets `stop`
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = collections.deque(batches)
                    in_flight = collections.deque()
                    count = 0
                    bound = self.batch_size * (max(self.prefetch, 1) + 1)

                    def refill():
                        nonlocal count
                        while pending and count < bound:
                            chunk, seeds, mask = pending.popleft()
                            futs = [pool.submit(self.dataset.__getitem__,
                                                int(i), sd)
                                    for i, sd in zip(chunk, seeds)]
                            count += len(futs)
                            in_flight.append((futs, mask))

                    refill()
                    while in_flight and not stop.is_set():
                        futs, mask = in_flight.popleft()
                        samples = [f.result() for f in futs]
                        count -= len(futs)
                        refill()  # keep workers busy while we stack
                        if not put(self._stack(samples, mask)):
                            break
                    put(None)
            except BaseException as e:  # surface worker failures
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            self._stops.discard(stop)


def build_loader(cfg, split, device=None):
    """The loader of ``split`` for a run on ``device`` (default: the CUDA
    card; raises without one unless ``device="cpu"``). The batch size is
    the config's, per data shard; every process feeds the same number of
    shards, one. On a CUDA device with ``DATA_LOADER.PIN_MEMORY`` the
    video batches are pinned."""
    device = resolve_device(device)
    process_index, process_count = process_rank()
    d = data_axis_size(cfg, process_count)
    if d % process_count:
        raise ValueError(
            f"data axis ({d}) must be a multiple of the process count "
            f"({process_count}): every process feeds the same number of "
            "data shards")
    worker_type = str(cfg.DATA_LOADER.get("WORKER_TYPE", "thread") or "thread")
    if worker_type != "thread":
        raise NotImplementedError(_PROCESS_POOL_TODO)
    dataset = build_dataset(cfg, split)
    if split == "train":
        batch_size = int(cfg.TRAIN.BATCH_SIZE)
        shuffle, drop_last = True, True
        num_folds = int(cfg.TRAIN.get("NUM_FOLDS", 1))
    elif split == "val":
        batch_size = int(cfg.TRAIN.BATCH_SIZE)
        shuffle, drop_last, num_folds = False, False, 1
    else:
        batch_size = int(cfg.TEST.BATCH_SIZE)
        shuffle, drop_last, num_folds = False, False, 1
    collate_fn = None
    if cfg.DATA_LOADER.get("COLLATE_FN"):
        collate_fn = COLLATE_FN_REGISTRY.get_strict(
            cfg.DATA_LOADER.COLLATE_FN)(cfg)
    return Loader(
        dataset, batch_size, shuffle, drop_last,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        seed=int(cfg.RANDOM_SEED), num_folds=num_folds,
        process_index=process_index, process_count=process_count,
        prefetch=int(cfg.DATA_LOADER.get("PREFETCH", 2)),
        collate_fn=collate_fn,
        pin_memory=device.type == "cuda"
        and bool(cfg.DATA_LOADER.get("PIN_MEMORY", False)))


def shuffle_dataset(loader, cur_epoch):
    loader.set_epoch(cur_epoch)
