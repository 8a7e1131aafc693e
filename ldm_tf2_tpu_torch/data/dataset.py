"""TFRecord writers and the host-side input pipeline of the trainers (the
port's own copy of the Python path of ``ldm_tf2_tpu.data.dataset``).

``convert_images_to_tfrecord`` and ``convert_coco_captions_to_tfrecord``
write the JAX package's round-robin-sharded Example records (same shard
names, same record order, byte for byte), the captions tokenized by the
port's own ``BertTokenizer``, truncated and padded to ``max_length``.

``create_dataset`` keeps the JAX package's transform chain: filename
shuffle + repeat -> per-file record shuffle buffer -> JPEG decode ->
/127.5 - 1 normalize -> centered pad-to-square -> **nearest** resize
(half-pixel centers) -> optional horizontal flip -> drop-remainder
batching, as an infinite generator of numpy batches decoded ahead by a
thread pool (closing it stops the producer thread; a decoding error is
raised by the consumer).  The record order is a function of the seed alone, so the
batches equal the JAX package's Python path batch for batch.  One
difference: the flip coin is drawn in record order in the producer, where
the JAX package draws it in its decode workers (whose order varies with
thread timing), so here flipped runs repeat too.  The JAX package's native
C++ decoder is not used.  ``shard_for_process`` splits the files over the
ranks of a data-parallel run; ``data/indexed.py`` is the deterministic,
resumable loader.
"""

from __future__ import annotations

import glob
import io
import json
import os
import queue
import random
import threading
from typing import Iterator, Sequence

import numpy as np

from ldm_tf2_tpu_torch.data.example_proto import decode_example, encode_example
from ldm_tf2_tpu_torch.data.tfrecord import TFRecordReader, TFRecordWriter

BUFFER_SIZE = 1024
PREFETCH = 2  # batches staged ahead of the consumer
NUM_WORKERS = 8  # decode threads


def _image_example(image_path: str, caption: Sequence[int] | None = None) -> bytes:
    with open(image_path, "rb") as f:
        image_bytes = f.read()
    features: dict[str, object] = {"image": image_bytes}
    if caption is not None:
        features["caption"] = list(caption)
    return encode_example(features)


def convert_images_to_tfrecord(
    filenames: Sequence[str], out_path: str, num_shards: int = 100
) -> None:
    """Round-robin shard raw JPEG bytes into ``num_shards`` TFRecord files
    ``images_<i>-<num_shards>.tfrecord``."""
    os.makedirs(out_path, exist_ok=True)
    writers = [
        TFRecordWriter(
            os.path.join(out_path, f"images_{i:02d}-{num_shards:02d}.tfrecord")
        )
        for i in range(num_shards)
    ]
    for shard, path in enumerate(filenames):
        writers[shard % num_shards].write(_image_example(path))
    for w in writers:
        w.close()


def convert_coco_captions_to_tfrecord(
    root_path: str,
    part: str,
    ann_filename: str,
    tokenizer,
    out_path: str,
    max_length: int = 77,
    num_shards: int = 20,
) -> None:
    """COCO captions -> ``num_shards`` TFRecord files
    ``coco_caption_<i>-<num_shards>.tfrecord``, each record the image's
    bytes and its caption's ids ([CLS] ... [SEP], truncated and padded to
    ``max_length``) from the port's ``BertTokenizer``."""
    with open(os.path.join(root_path, "annotations", ann_filename)) as f:
        raw = json.load(f)
    image_dict = {image["id"]: image for image in raw["images"]}

    os.makedirs(out_path, exist_ok=True)
    writers = [
        TFRecordWriter(
            os.path.join(
                out_path, f"coco_caption_{i:02d}-{num_shards:02d}.tfrecord"
            )
        )
        for i in range(num_shards)
    ]
    for shard, ann in enumerate(raw["annotations"]):
        image_path = os.path.join(
            root_path, part, image_dict[ann["image_id"]]["file_name"]
        )
        ids = tokenizer.encode(ann["caption"], max_length)
        writers[shard % num_shards].write(_image_example(image_path, ids))
    for w in writers:
        w.close()


def _decode_jpeg(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def _pad_to_square(image: np.ndarray) -> np.ndarray:
    """Centered zero-pad to square."""
    h, w = image.shape[:2]
    if h > w:
        pad = h - w
        lo = pad // 2
        return np.pad(image, [(0, 0), (lo, pad - lo), (0, 0)])
    if w > h:
        pad = w - h
        lo = pad // 2
        return np.pad(image, [(lo, pad - lo), (0, 0), (0, 0)])
    return image


def _nearest_resize(image: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor with half-pixel centers."""
    h, w = image.shape[:2]
    rows = np.clip(
        np.floor((np.arange(size) + 0.5) * (h / size)).astype(np.int64), 0, h - 1
    )
    cols = np.clip(
        np.floor((np.arange(size) + 0.5) * (w / size)).astype(np.int64), 0, w - 1
    )
    return image[rows[:, None], cols[None, :]]


def process_image(image: np.ndarray, image_size: int) -> np.ndarray:
    """Normalize + pad-to-square + nearest resize."""
    image = image.astype(np.float32) / 127.5 - 1.0
    image = _pad_to_square(image)
    return _nearest_resize(image, image_size)


def _record_stream(filenames: Sequence[str], seed: int | None,
                   buffer_size: int) -> Iterator[bytes]:
    """Shuffled, repeated record stream: filename shuffle + per-file
    shuffle buffer."""
    rng = random.Random(seed)
    files = list(filenames)
    while True:
        rng.shuffle(files)
        for path in files:
            buffer: list[bytes] = []
            for record in TFRecordReader(path):
                buffer.append(record)
                if len(buffer) >= buffer_size:
                    idx = rng.randrange(len(buffer))
                    buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                    yield buffer.pop()
            rng.shuffle(buffer)
            yield from buffer


def _make_example(record: bytes, image_size: int, flip: bool,
                  with_captions: bool, max_seq_len: int):
    example = decode_example(record)
    image = _decode_jpeg(example["image"][0])
    if flip:
        image = image[:, ::-1]
    image = process_image(image, image_size)
    if not with_captions:
        return image
    caption = np.asarray(example["caption"], dtype=np.int64)[:max_seq_len]
    if caption.shape[0] < max_seq_len:
        caption = np.pad(caption, (0, max_seq_len - caption.shape[0]))
    return image, caption


def create_dataset(
    filenames: Sequence[str],
    batch_size: int = 1,
    image_size: int = 256,
    keys: Sequence[str] = ("image", "caption"),
    flip: bool = False,
    max_seq_len: int = 77,
    random_seed: int | None = None,
) -> Iterator:
    """Infinite iterator of numpy batches: ``images [B, S, S, 3] float32``,
    or ``(images, captions [B, L] int64)`` when "caption" is in ``keys``.
    Decoding runs in a thread pool; ``PREFETCH`` batches are staged ahead
    of the consumer."""
    from concurrent.futures import ThreadPoolExecutor

    rng = random.Random(random_seed)
    with_captions = "caption" in keys
    records = _record_stream(filenames, random_seed, BUFFER_SIZE)
    pool = ThreadPoolExecutor(max_workers=NUM_WORKERS)

    def batches():
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
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
            try:
                while not stop.is_set():
                    futures = [
                        pool.submit(_make_example, next(records), image_size,
                                    flip and rng.random() < 0.5, with_captions,
                                    max_seq_len)
                        for _ in range(batch_size)
                    ]
                    items = [f.result() for f in futures]
                    if with_captions:
                        put((np.stack([i[0] for i in items]),
                             np.stack([i[1] for i in items])))
                    else:
                        put(np.stack(items))
            except StopIteration:
                put(None)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join(timeout=10)
            pool.shutdown(wait=False, cancel_futures=True)

    return batches()


def list_tfrecords(root_path: str) -> list[str]:
    """The ``*.tfrecord`` files under a directory, sorted."""
    return sorted(glob.glob(os.path.join(root_path, "*.tfrecord")))


def shard_for_process(filenames: Sequence[str], mesh=None) -> list[str]:
    """The files this rank streams: a round-robin share by rank over the
    world (``mesh``, else the process group's), or all of them when there
    are fewer files than ranks."""
    from ldm_tf2_tpu_torch.parallel import create_mesh

    mesh = mesh or create_mesh()
    count, index = mesh.world, mesh.rank
    if count == 1 or len(filenames) < count:
        return list(filenames)
    return [f for i, f in enumerate(filenames) if i % count == index]
