"""Batch loader: host pipeline feeding fixed-shape padded device batches
(counterpart of demonet_tpu/data/loader.py, batch for batch bit-equal).

The reference pipeline is DataLoader + tuple(zip(*batch)) list-collation +
GroupedBatchSampler (train.py:123-144, util/misc.py:235). Here, as in the
JAX package, every batch is a dense fixed-shape dict of numpy arrays

    images          (B, H, W, 3) float32 in [0, 1] (or uint8 0..255 with
                    image_dtype="uint8" — 4x cheaper H2D transfer, rescaled
                    on the device by the train and predict steps), resized
                    to the model size
    gt_boxes        (B, MAX_GT, 4) xyxy in resized coords, zero-padded
    gt_labels       (B, MAX_GT) int32, zero-padded
    gt_valid        (B, MAX_GT) bool
    image_ids       (B,) int64
    original_sizes  (B, 2) int32 (h, w)
    batch_valid     (B,) bool — False for the tail padding of the last batch

which the train and predict steps copy to the device.

Parallelism (the reference's num_workers=4 DataLoader, train.py:137-144):

  * num_workers=0 (default): one background prefetch thread.
  * num_workers>0: a spawn-context process pool. Workers write decoded/
    augmented images straight into a shared-memory slab (no 78 MB batch
    pickles); only the small target arrays travel over the result queue.
    Batches are re-ordered by sequence number so iteration order is
    identical to the single-threaded path.

Determinism: every sample's augmentation RNG is derived from
(seed, epoch, dataset_index) — np.random.default_rng([seed, epoch, idx]) —
so augmented batches are bit-identical regardless of num_workers, thread
timing, or batch composition, and reshuffle per epoch like the reference's
DistributedSampler.set_epoch (train.py:188).

cv2 is imported only where a frame is resized (or by the transforms that
use it), so frames already at the network size load without it. The JAX
package's native C++ decode path (`native_decode=True`) waits for ROADMAP
Queue 1 item 8b here and raises.
"""

from __future__ import annotations

import inspect
import multiprocessing
import queue
import threading
from multiprocessing import shared_memory
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _sample_rng(seed: int, epoch: int, ds_idx: int) -> np.random.Generator:
    """Per-sample augmentation stream: a pure function of
    (seed, epoch, dataset index) — worker-count invariant."""
    return np.random.default_rng([seed, epoch, ds_idx])


def _rng_aware(dataset) -> bool:
    """Does dataset.__getitem__ accept an rng argument?"""
    try:
        sig = inspect.signature(dataset.__getitem__)
    except (TypeError, ValueError):
        return False
    return "rng" in sig.parameters


def _load_one(dataset, ds_idx: int, image_size: Tuple[int, int],
              rng: Optional[np.random.Generator], rng_aware: bool,
              image_dtype=np.float32):
    if rng_aware and rng is not None:
        img, target = dataset.__getitem__(int(ds_idx), rng=rng)
    else:
        img, target = dataset[int(ds_idx)]
    h, w = img.shape[:2]
    nh, nw = image_size
    if (h, w) != (nh, nw):
        import cv2

        from demonet_tpu_torch.data.transforms import (
            _resize_masks, _scale_keypoints)

        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        updates = {}
        if len(target.get("boxes", ())):
            updates["boxes"] = target["boxes"] * np.asarray(
                [nw / w, nh / h, nw / w, nh / h], np.float32)
        if len(target.get("masks", ())):
            updates["masks"] = _resize_masks(target["masks"], nh, nw)
        if len(target.get("keypoints", ())):
            updates["keypoints"] = _scale_keypoints(
                target["keypoints"], nw / w, nh / h)
        if updates:
            target = dict(target, **updates)
    if image_dtype == np.uint8:
        if img.dtype != np.uint8:
            # quantize augmented floats back to 8-bit: the H2D transfer then
            # ships 1/4 the bytes and the device rescales to [0,1] in-step
            # (models/detection.py::to_float). ±0.5/255 quantization on
            # pixel values — the same granularity the JPEG source had.
            img = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    elif img.dtype != np.float32:
        # single-pass uint8 -> [0,1] float32 (no intermediate float copy)
        img = np.multiply(img, np.float32(1.0 / 255.0), dtype=np.float32)
    return img, target, (h, w)


def _assemble_batch(dataset, ds_indices: np.ndarray, batch_size: int,
                    image_size: Tuple[int, int], max_gt: int, seed: int,
                    epoch: int, rng_aware: bool,
                    images_out: Optional[np.ndarray] = None,
                    max_kp: int = 0, with_masks: bool = False,
                    image_dtype=np.float32) -> Dict[str, np.ndarray]:
    """Assemble one fixed-shape batch. If images_out is given (a shared-
    memory slab slot), images are written there and omitted from the
    returned dict.

    max_kp > 0 adds "gt_keypoints" (B, G, max_kp, 3); with_masks adds
    "gt_masks" (B, G, H, W) uint8 — padded instance targets carried
    through collation (reference util/misc.py:235 keeps whole target
    dicts; here ragged targets become fixed-shape padded arrays).
    """
    b, g = batch_size, max_gt
    nh, nw = image_size
    images = images_out if images_out is not None \
        else np.zeros((b, nh, nw, 3), image_dtype)
    if images_out is not None:
        images[:] = 0
    out = {
        "gt_boxes": np.zeros((b, g, 4), np.float32),
        "gt_labels": np.zeros((b, g), np.int32),
        "gt_valid": np.zeros((b, g), bool),
        "image_ids": np.zeros((b,), np.int64),
        "original_sizes": np.zeros((b, 2), np.int32),
        "batch_valid": np.zeros((b,), bool),
    }
    if max_kp > 0:
        out["gt_keypoints"] = np.zeros((b, g, max_kp, 3), np.float32)
    if with_masks:
        out["gt_masks"] = np.zeros((b, g, nh, nw), np.uint8)
    for i, ds_idx in enumerate(ds_indices):
        rng = _sample_rng(seed, epoch, int(ds_idx))
        img, target, (h, w) = _load_one(
            dataset, ds_idx, image_size, rng, rng_aware,
            image_dtype=image_dtype)
        images[i] = img
        boxes = np.asarray(target.get("boxes", np.zeros((0, 4))))
        labels = np.asarray(target.get("labels", np.zeros((0,))))
        k = min(len(boxes), g)
        if k:
            out["gt_boxes"][i, :k] = boxes[:k]
            out["gt_labels"][i, :k] = labels[:k]
            out["gt_valid"][i, :k] = True
            if max_kp > 0:
                kps = np.asarray(target.get("keypoints",
                                            np.zeros((0, 0, 3), np.float32)))
                if kps.size:
                    kk = min(kps.shape[1], max_kp)
                    out["gt_keypoints"][i, :min(len(kps), k), :kk] = \
                        kps[:k, :kk]
            if with_masks:
                masks = np.asarray(target.get("masks",
                                              np.zeros((0, nh, nw), np.uint8)))
                if masks.size:
                    out["gt_masks"][i, :min(len(masks), k)] = \
                        masks[:k].astype(np.uint8)
        out["image_ids"][i] = target.get("image_id", int(ds_idx))
        out["original_sizes"][i] = (h, w)
        out["batch_valid"][i] = True
    if images_out is None:
        out["images"] = images
    return out


def _worker_main(dataset, batch_size, image_size, max_gt, seed, rng_aware,
                 shm_name, n_slots, task_q, result_q,
                 max_kp=0, with_masks=False, image_dtype=np.float32):
    """Process-pool worker: assembles batches into shared-memory slots."""
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        nh, nw = image_size
        slab = np.ndarray((n_slots, batch_size, nh, nw, 3), image_dtype,
                          buffer=shm.buf)
        while True:
            task = task_q.get()
            if task is None:
                break
            seq, slot, epoch, indices = task
            try:
                meta = _assemble_batch(
                    dataset, indices, batch_size, image_size, max_gt, seed,
                    epoch, rng_aware, images_out=slab[slot],
                    max_kp=max_kp, with_masks=with_masks,
                    image_dtype=image_dtype)
                result_q.put((seq, slot, meta, None))
            except BaseException as e:  # surface worker errors to the main loop
                result_q.put((seq, slot, None, repr(e)))
    finally:
        shm.close()


class DetectionLoader:
    """Iterable over fixed-shape batches of a detection dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        image_size: Tuple[int, int],
        shuffle: bool = False,
        max_gt: int = 100,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
        pad_last_batch: bool = True,
        native_decode: bool = False,
        native_threads: int = 4,
        batch_sampler=None,
        num_workers: int = 0,
        max_kp: int = 0,
        with_masks: bool = False,
        image_dtype="float32",
    ):
        self.dataset = dataset
        # opt-in padded instance targets: gt_keypoints (B, G, max_kp, 3)
        # and gt_masks (B, G, H, W) — see _assemble_batch
        self.max_kp = max_kp
        self.with_masks = with_masks
        # "uint8" ships quantized 8-bit images (1/4 the H2D bytes; the
        # step rescales on the device — models/detection.py::to_float)
        self.image_dtype = np.dtype(image_dtype).type
        if self.image_dtype not in (np.float32, np.uint8):
            raise ValueError("image_dtype must be float32 or uint8")
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.max_gt = max_gt
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.pad_last_batch = pad_last_batch
        # optional index-batch sampler (e.g. GroupedBatchSampler) replacing
        # the default shuffled/sharded index stream (reference
        # train.py:130-135 aspect-ratio grouping)
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers
        self.epoch = 0
        self._rng_aware = _rng_aware(dataset)
        # the native C++ decode+resize path (cpp/imageio.cc, with
        # native_threads decode threads) is not ported: data/native.py
        # waits for ROADMAP Queue 1 item 8b
        del native_threads
        if native_decode:
            raise NotImplementedError(
                "DetectionLoader(native_decode=True) is not ported yet "
                "(ROADMAP Queue 1, item 8b)")

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (reference DistributedSampler.set_epoch,
        train.py:188)."""
        self.epoch = epoch
        if self.batch_sampler is not None and hasattr(
                self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        # contiguous shard per process (equal sizes via padding, like
        # DistributedSampler's wrap-around)
        if self.num_shards > 1:
            per = -(-n // self.num_shards)
            padded = np.concatenate([idx, idx[: per * self.num_shards - n]])
            idx = padded[self.shard_index::self.num_shards]
        return idx

    def __len__(self) -> int:
        if self.batch_sampler is not None:
            # the sampler must be re-iterable (GroupedBatchSampler is);
            # cache the count per epoch — counting consumes one full
            # iteration (shuffle + bucketing), so don't repeat it per call
            if getattr(self, "_len_cache", (None, 0))[0] != self.epoch:
                self._len_cache = (
                    self.epoch, sum(1 for _ in self._batch_indices()))
            return self._len_cache[1]
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _assemble(self, ds_indices: np.ndarray) -> Dict[str, np.ndarray]:
        return _assemble_batch(
            self.dataset, ds_indices, self.batch_size, self.image_size,
            self.max_gt, self.seed, self.epoch, self._rng_aware,
            max_kp=self.max_kp, with_masks=self.with_masks,
            image_dtype=self.image_dtype)

    def _batch_indices(self) -> Iterator[np.ndarray]:
        if self.batch_sampler is not None:
            batches = [np.asarray(c) for c in self.batch_sampler]
            if self.num_shards > 1:
                # Batch-level sharding: process k takes batches k, k+S,
                # k+2S, ...; the ragged tail is dropped so every shard runs
                # the same number of steps.
                even = (len(batches) // self.num_shards) * self.num_shards
                batches = batches[self.shard_index:even:self.num_shards]
            yield from batches
            return
        idx = self._indices()
        n = len(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if len(chunk) < self.batch_size and not self.pad_last_batch:
                continue
            yield chunk

    # ---- iteration strategies ----

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers > 0:
            return self._iter_pool()
        if self.prefetch <= 0:
            return (self._assemble(c) for c in self._batch_indices())
        return self._iter_thread()

    def _iter_thread(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for chunk in self._batch_indices():
                    q.put(self._assemble(chunk))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item

    def _iter_pool(self) -> Iterator[Dict[str, np.ndarray]]:
        """Process-pool iteration with a shared-memory image slab.

        In-flight window = n_slots = num_workers + prefetch. Workers write
        decoded batches into slab slots; the main process copies each slot
        out before yielding (batches are OWNED arrays — safe to hold across
        steps) and recycles it. Results are re-ordered by sequence number
        so output order matches the serial path.
        """
        nh, nw = self.image_size
        n_slots = self.num_workers + max(1, self.prefetch)
        itemsize = np.dtype(self.image_dtype).itemsize
        slot_bytes = self.batch_size * nh * nw * 3 * itemsize
        ctx = multiprocessing.get_context("spawn")
        shm = shared_memory.SharedMemory(create=True,
                                         size=n_slots * slot_bytes)
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        workers = [
            ctx.Process(
                target=_worker_main,
                args=(self.dataset, self.batch_size, self.image_size,
                      self.max_gt, self.seed, self._rng_aware, shm.name,
                      n_slots, task_q, result_q, self.max_kp,
                      self.with_masks, self.image_dtype),
                daemon=True)
            for _ in range(self.num_workers)]
        for w in workers:
            w.start()

        slab = np.ndarray((n_slots, self.batch_size, nh, nw, 3),
                          self.image_dtype, buffer=shm.buf)
        try:
            batches = iter(self._batch_indices())
            free_slots = list(range(n_slots))
            pending: Dict[int, Tuple[int, Dict]] = {}
            submitted = 0
            done_submitting = False

            def submit():
                nonlocal submitted, done_submitting
                while free_slots and not done_submitting:
                    try:
                        chunk = next(batches)
                    except StopIteration:
                        done_submitting = True
                        break
                    task_q.put((submitted, free_slots.pop(), self.epoch,
                                chunk))
                    submitted += 1

            submit()
            next_seq = 0
            while next_seq < submitted or not done_submitting:
                while next_seq not in pending:
                    try:
                        seq, slot, meta, err = result_q.get(timeout=60.0)
                    except queue.Empty:
                        # distinguish a slow decode from a dead worker
                        # (e.g. OOM-killed: no Python exception reaches
                        # result_q) — without this the loop hangs forever
                        dead = [w for w in workers if not w.is_alive()]
                        if dead:
                            raise RuntimeError(
                                f"{len(dead)} loader worker(s) died "
                                f"(exitcodes {[w.exitcode for w in dead]})")
                        continue
                    if err is not None:
                        raise RuntimeError(f"loader worker failed: {err}")
                    pending[seq] = (slot, meta)
                slot, meta = pending.pop(next_seq)
                batch = dict(meta)
                # copy OUT of the shared slab: the slot is recycled by a
                # worker right after the next request and the mapping is
                # unlinked when iteration ends — yielding the live view
                # corrupts (or segfaults) any batch held across steps
                batch["images"] = np.array(slab[slot])
                yield batch
                free_slots.append(slot)
                next_seq += 1
                submit()
        finally:
            for _ in workers:
                task_q.put(None)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                # a worker's resource tracker may have unlinked the name
                # already (bpo-38119); the mapping itself stays valid
                pass
