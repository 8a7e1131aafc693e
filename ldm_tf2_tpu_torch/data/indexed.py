"""The deterministic, resumable input pipeline of the trainers
(``tpu.deterministic_data``; the port's own copy of the Python path of
``ldm_tf2_tpu.data.indexed``).

* ``build_index`` scans each TFRecord's framing once (a 12-byte header:
  the little-endian u64 length and its CRC; the payload; a 4-byte CRC),
  skipping payloads, and records (file, payload offset, length) for every
  record.
* The batch of global step s is a pure function of (seed, s): epoch e's
  order is ``np.random.default_rng([seed, e]).permutation(n)``, an epoch
  has ``n // (batch_size * shard_count)`` steps (the remainder dropped),
  and shard k of step s takes ``perm[local * global_batch + k *
  batch_size:][:batch_size]``.  Resuming is passing ``start_step``; a
  data-parallel rank passes ``shard_index=rank, shard_count=world`` and
  reads its rows of the global batch.
* A record is flipped when ``random.Random(f"{seed}/{epoch}/{index}")``'s
  first draw is below 0.5.

These decide which data a step sees and are copied as definitions.  The
reading is the native reader's where it is taken (``native``: None where
it is available, as in the JAX package, True required, False never):
``build_index`` scans with ``native.scan_index``, a record is fetched with
``native.pread`` and decoded as the streaming loader decodes it
(``dataset.example_maker``: libjpeg and the transform in C++, a record it
rejects in Python; else PIL, then the JAX transform chain).  The batches
are the same either way.  A thread pool decodes, a producer thread stages
``prefetch`` batches ahead, and closing the iterator stops the producer;
an error in decoding is raised by the consumer.
"""

from __future__ import annotations

import queue
import random
import struct
import threading
from typing import Iterator, Sequence

import numpy as np

from ldm_tf2_tpu_torch.data import native as _native
from ldm_tf2_tpu_torch.data.dataset import NUM_WORKERS, PREFETCH, example_maker


def build_index(filenames: Sequence[str], native: bool | None = None) -> np.ndarray:
    """[N, 3] int64 (file index, payload offset, payload length), read from
    the record framing alone (by ``native.scan_index`` where ``native``
    takes the reader)."""
    use_native = _native.use(native)
    entries = []
    for file_idx, path in enumerate(filenames):
        scanned = _native.scan_index(path) if use_native else None
        if scanned is not None:
            if len(scanned):
                col = np.full((len(scanned), 1), file_idx, np.int64)
                entries.append(np.concatenate([col, scanned], axis=1))
            continue
        rows = []
        with open(path, "rb") as f:
            offset = 0
            while True:
                header = f.read(12)
                if len(header) < 12:
                    break
                (length,) = struct.unpack("<Q", header[:8])
                rows.append((file_idx, offset + 12, length))
                offset += 12 + length + 4
                f.seek(offset)
        if rows:
            entries.append(np.asarray(rows, dtype=np.int64))
    if not entries:
        raise ValueError(f"no records found in {len(filenames)} files")
    return np.concatenate(entries, axis=0)


def _read_record(path: str, offset: int, length: int, use_native: bool = False) -> bytes:
    data = _native.pread(path, offset, length) if use_native else None
    if data is not None:
        return data
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def _flip_coin(seed: int, epoch: int, index: int) -> bool:
    return random.Random(f"{seed}/{epoch}/{index}").random() < 0.5


def create_indexed_dataset(
    filenames: Sequence[str],
    batch_size: int = 1,
    image_size: int = 256,
    keys: Sequence[str] = ("image", "caption"),
    flip: bool = False,
    max_seq_len: int = 77,
    random_seed: int | None = None,
    start_step: int = 0,
    prefetch: int = PREFETCH,
    num_workers: int = NUM_WORKERS,
    shard_index: int = 0,
    shard_count: int = 1,
    native: bool | None = None,
) -> Iterator:
    """Infinite deterministic iterator from global step ``start_step``; the
    element spec of ``dataset.create_dataset``.  Shard ``shard_index`` of
    ``shard_count`` yields its ``batch_size`` rows of the global batch of
    ``batch_size * shard_count``: the shards' batches concatenated in shard
    order are the one-shard run's.  ``native``: whether the reader is taken
    (the module docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    if not (0 <= shard_index < shard_count):
        raise ValueError(f"shard {shard_index} not in [0, {shard_count})")
    seed = 0 if random_seed is None else int(random_seed)
    use_native = _native.use(native)
    make = example_maker(use_native)
    index = build_index(filenames, use_native)
    n = len(index)
    global_batch = batch_size * shard_count
    if n < global_batch:
        raise ValueError(f"{n} records < global batch {global_batch}")
    steps_per_epoch = n // global_batch
    with_captions = "caption" in keys
    pool = ThreadPoolExecutor(max_workers=num_workers)

    def load_one(epoch: int, rec_idx: int):
        file_idx, offset, length = (int(v) for v in index[rec_idx])
        record = _read_record(filenames[file_idx], offset, length, use_native)
        do_flip = flip and _flip_coin(seed, epoch, rec_idx)
        return make(record, image_size, do_flip, with_captions, max_seq_len)

    def batches():
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> None:
            """Stage ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            step = start_step
            perm_epoch, perm = -1, None
            try:
                while not stop.is_set():
                    epoch, local = divmod(step, steps_per_epoch)
                    if epoch != perm_epoch:
                        perm = np.random.default_rng([seed, epoch]).permutation(n)
                        perm_epoch = epoch
                    start = local * global_batch + shard_index * batch_size
                    ids = perm[start:start + batch_size]
                    futures = [pool.submit(load_one, epoch, int(i)) for i in ids]
                    items = [f.result() for f in futures]
                    if with_captions:
                        put((np.stack([i[0] for i in items]),
                             np.stack([i[1] for i in items])))
                    else:
                        put(np.stack(items))
                    step += 1
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join(timeout=10)
            pool.shutdown(wait=False, cancel_futures=True)

    return batches()
