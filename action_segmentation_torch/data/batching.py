"""Host-side batching: padded collation with shape bucketing.

Variable-length videos are padded to a small set of geometric length
buckets, and batches are grouped per task so every instance in a batch
shares `valid_classes`. The same buckets as the JAX package keep the two
packages' padded shapes, and so their decodes, identical.
"""

import itertools
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# geometric-ish bucket boundaries; first buckets are fine-grained because
# synthetic/test videos are short, later ones grow ~1.3x
_BUCKET_GROWTH = 1.3
_MIN_BUCKET = 32


def pad_length_to_bucket(T):
    """Smallest bucket >= T; buckets grow geometrically from _MIN_BUCKET."""
    b = _MIN_BUCKET
    while b < T:
        b = int(np.ceil(b * _BUCKET_GROWTH / 8) * 8)
    return b


def pad_class_width(n_sub, class_bucket, max_classes):
    """The class-count bucketing rule: pad to a multiple of
    --sm_class_shape_bucket, but never past the decode kernels' class
    limit when the true count fits in it (the kernel gate checks the
    unpadded count)."""
    bucket = max(1, class_bucket or 1)
    cp = -(-n_sub // bucket) * bucket
    if n_sub <= max_classes:
        cp = min(cp, max_classes)
    return cp


def make_batch_keys(videos_by_task, batch_size, batch_by_task=True, shuffle=False,
                    seed=1, length_of=None):
    """List of batches of (task, video_name) keys.

    Chunks each task's (sorted) video list into batch_size groups, then
    shuffles at batch granularity. When batch_by_task is False the
    chunking is still per task; callers relying on mixed-task batches use
    batch_size=1 anyway.

    `length_of` ((task, name) -> int) groups similar-length videos into the
    same batch (used at decode time: results are keyed by video, so order
    is free, and length grouping cuts padded frames per length bucket).
    """
    batches = []
    for task in sorted(videos_by_task.keys()):
        videos = sorted(videos_by_task[task])
        if length_of is not None:
            videos = sorted(videos, key=lambda v: (length_of((task, v)), v))
        for i in range(0, len(videos), batch_size):
            batches.append([(task, v) for v in videos[i : i + batch_size]])
    if shuffle:
        random.Random(seed).shuffle(batches)
    return batches


def collate(samples, bucket=True):
    """Pad a list of per-video sample dicts into dense numpy arrays.

    Pads 'features' (T, D) -> (B, Tpad, D), 'gt_single' (T,) -> (B, Tpad),
    'constraints' (T, K) -> (B, Tpad, K); passes through names/indices.
    Padding value is 0 everywhere.
    """
    samples = [s for s in samples if s is not None]
    lengths = np.array([s["features"].shape[0] for s in samples], np.int32)
    max_len = int(lengths.max())
    Tpad = pad_length_to_bucket(max_len) if bucket else max_len
    B = len(samples)

    out = {
        "task_name": [s["task_name"] for s in samples],
        "video_name": [s["video_name"] for s in samples],
        "task_indices": [np.asarray(s["task_indices"]) for s in samples],
        "lengths": lengths,
    }
    D = samples[0]["features"].shape[1]
    feats = np.zeros((B, Tpad, D), np.float32)
    for i, s in enumerate(samples):
        feats[i, : lengths[i]] = s["features"]
    out["features"] = feats

    if "gt_single" in samples[0]:
        gt = np.zeros((B, Tpad), np.int64)
        for i, s in enumerate(samples):
            gt[i, : lengths[i]] = s["gt_single"]
        out["gt_single"] = gt
        out["gt"] = [s["gt"] for s in samples]
        if "gt_with_background" in samples[0]:
            out["gt_with_background"] = [s["gt_with_background"] for s in samples]

    # narration coverage can be mixed within a batch (the constraint CSVs
    # are per video): a video without a matrix gets ONES over its real
    # frames, "every step allowed", i.e. no penalty after the model's
    # 1 - x inversion, while its batchmates keep their penalties
    have_cons = [s.get("constraints") is not None for s in samples]
    if any(have_cons):
        Kc = next(
            s["constraints"].shape[1]
            for s, h in zip(samples, have_cons) if h
        )
        cons = np.zeros((B, Tpad, Kc), np.float32)
        for i, (s, h) in enumerate(zip(samples, have_cons)):
            cons[i, : lengths[i]] = s["constraints"] if h else 1.0
        out["constraints"] = cons

    return out


def iter_batches(datasplit, batch_size, batch_by_task, shuffle, seed=1, bucket=True,
                 sort_by_length=False):
    """Yield collated batches from a Datasplit-like object.

    The datasplit must expose `videos_by_task` (task -> {name: ...}) and
    `__getitem__((task, name)) -> sample dict`. A datasplit whose
    `loader_workers` is positive (the command line's --workers) loads and collates batches ahead on that
    many threads, in order (numpy's .npy reads release the GIL).
    """
    length_of = None
    if sort_by_length:
        # sort keys only need relative order: prefer the datasplit's
        # cheap annotation-based estimate (no feature IO) over building
        # every sample twice per pass
        length_of = getattr(datasplit, "approx_length", None)
        if length_of is None:
            cache = {}

            def length_of(key):
                if key not in cache:
                    sample = datasplit[key]
                    cache[key] = 0 if sample is None else sample["features"].shape[0]
                return cache[key]

    keys_batches = make_batch_keys(
        datasplit.videos_by_task, batch_size, batch_by_task, shuffle, seed,
        length_of=length_of,
    )

    def load(keys):
        samples = [datasplit[key] for key in keys]
        samples = [s for s in samples if s is not None]
        return collate(samples, bucket=bucket) if samples else None

    workers = getattr(datasplit, "loader_workers", 0)
    if not workers or workers <= 0:
        for keys in keys_batches:
            batch = load(keys)
            if batch is not None:
                yield batch
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = deque()
        it = iter(keys_batches)
        for keys in itertools.islice(it, 2 * workers):
            pending.append(pool.submit(load, keys))
        while pending:
            batch = pending.popleft().result()
            keys = next(it, None)
            if keys is not None:
                pending.append(pool.submit(load, keys))
            if batch is not None:
                yield batch
