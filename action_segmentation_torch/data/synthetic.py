"""Synthetic segmentation corpus for tests and benchmarks.

Generates class-shifted Gaussian frame features over random-length spans,
mirroring the reference's synthetic_data (src/models/test_semimarkov.py:
42-79): labels cycle through each instance's valid classes with span
lengths uniform in [1, K-1], and features are N(shift * onehot(label), I).
Exposes the minimal Datasplit surface consumed by models and batching.
"""

import numpy as np


class SyntheticCorpus:
    def __init__(self, n_classes):
        self._n_classes = n_classes
        self._background_indices = []
        self.label2index = {str(i): i for i in range(n_classes)}
        self.index2label = {i: str(i) for i in range(n_classes)}
        self._indices_by_task = {"toy": set(range(n_classes))}
        self.annotate_background_with_previous = False

    @property
    def n_classes(self):
        return self._n_classes

    def indices_by_task(self, task):
        return list(sorted(self._indices_by_task[task]))


class SyntheticDatasplit:
    """Toy datasplit: one task, Gaussian features, known segmentations."""

    def __init__(
        self,
        num_videos=100,
        n_classes=3,
        max_len=100,
        span_k=5,
        feature_dim=None,
        shift=1.0,
        seed=0,
        task="toy",
        min_len=None,
    ):
        rng = np.random.RandomState(seed)
        self.corpus = SyntheticCorpus(n_classes)
        self._corpus = self.corpus
        self.task = task
        self.remove_background = False
        self.subsample = 1
        D = feature_dim or n_classes
        self._samples = {}
        self.videos_by_task = {task: {}}
        self._videos_by_task = self.videos_by_task
        self._K_by_task = {task: n_classes}
        lo = span_k if min_len is None else min_len
        for i in range(num_videos):
            length = max_len if i == 0 else rng.randint(lo, max_len + 1)
            labels = []
            step = 0
            while len(labels) < length:
                span_len = rng.randint(1, span_k)
                labels.extend([step % n_classes] * span_len)
                step += 1
            labels = np.array(labels[:length], np.int64)
            feats = rng.randn(length, D).astype(np.float32)
            feats[np.arange(length), labels % D] += shift
            name = f"vid{i:04d}"
            self._samples[name] = {
                "task_name": task,
                "video_name": name,
                "features": feats,
                "task_indices": np.arange(n_classes, dtype=np.int64),
                "gt": [[int(l)] for l in labels],
                "gt_single": labels,
                "gt_with_background": [[int(l)] for l in labels],
            }
            self.videos_by_task[task][name] = name

    @property
    def feature_dim(self):
        first = next(iter(self._samples.values()))
        return first["features"].shape[1]

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, key):
        task, name = key
        return self._samples[name]

    def gt_single(self, name):
        return self._samples[name]["gt_single"]
