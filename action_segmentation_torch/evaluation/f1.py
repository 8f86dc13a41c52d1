"""Segment-sampling F1 (port of src/evaluation/f1.py:8-120, from slim_mallow).

50 sampling experiments x 15 frames per gt segment; precision normalizes
by K (expected segments per video) * n_videos, recall by the number of gt
segment boundaries. Preserves the reference's quirk of omitting each
sequence's final segment from `bound_masks`.
"""

import numpy as np


class F1Score:
    def __init__(self, K, n_videos, verbose=True):
        self.sampling_ratio = 15
        self.n_experiments = 50
        self._K = K
        self._n_videos = n_videos
        self._eps = 1e-8
        self._verbose = verbose

        self.gt = None
        self.pr = None
        self.gt2pr = None
        self.exclude = []
        self.bound_masks = []
        self.f1_scores = []
        self._return = {}
        self._n_true_seg_all = 0

    def set_gt(self, gt):
        assert isinstance(gt, list) and isinstance(gt[0], list)
        self.gt = np.asarray([gt_t[0] for gt_t in gt])

    def set_gt_single(self, gt):
        """Array path for callers that already hold the flattened
        first-label-per-frame array (Accuracy.gt_labels caches exactly
        this in accumulation order, so corpus.accuracy_corpus need not
        rebuild a million-element Python list just to flatten it again)."""
        self.gt = np.asarray(gt)

    def set_pr(self, pr):
        self.pr = np.asarray(pr)

    def set_gt2pr(self, gt2pr):
        self.gt2pr = gt2pr

    def set_exclude(self, label):
        self.bound_masks = []
        self.exclude.append(label)
        mask = self.gt != label
        self.gt = self.gt[mask]
        self.pr = self.pr[mask]

    def _finish_init(self):
        if self.gt is not None and self.pr is not None and self.gt2pr is not None:
            self._pr2gt_convert()
            self._set_boundaries()

    def _pr2gt_convert(self):
        new_pr = np.asarray(self.pr).copy()
        for gt_label, pr_label in self.gt2pr.items():
            if len(pr_label) == 0:
                continue
            new_pr[self.pr == pr_label[0]] = gt_label
        self.pr = new_pr

    def _set_boundaries(self):
        """Vectorized segment bounds from gt label changes.

        bound_masks holds (low, high) inclusive index pairs, one per
        segment in order — equivalent to the reference's list of
        full-length boolean masks (f1.py:69-80) but O(S) instead of
        O(S*T) (the masks were ~100 s per 1e6 frames,
        scripts/metric_scale_check.py). The reference's quirk of
        omitting each sequence's FINAL segment (its loop only appends on
        a label change) is preserved: the last run is dropped.
        """
        gt = np.asarray(self.gt)
        change = np.flatnonzero(gt[1:] != gt[:-1]) + 1
        lows = np.concatenate([[0], change[:-1]]) if len(change) else change
        highs = change - 1
        self.bound_masks = list(zip(lows.tolist(), highs.tolist()))
        self._lows = lows
        self._highs = highs
        # gt/pr agreement per frame, computed ONCE: each of the 50
        # sampling experiments then does a single boolean gather
        # instead of two label gathers + a compare
        self._eq = np.asarray(self.gt) == np.asarray(self.pr)

    def _sampling(self):
        # one broadcast randint call draws the SAME variates in the SAME
        # order as the reference's per-segment randint(low, high+1, 15)
        # calls (row-major fill; verified by
        # tests/test_evaluation.py::test_f1_broadcast_sampling_stream)
        sampled = np.random.randint(
            self._lows[:, None],
            self._highs[:, None] + 1,
            size=(len(self._lows), self.sampling_ratio),
        )
        n_corr = self._eq[sampled].sum(axis=1)
        n_correct_segments = float(np.sum(n_corr / self.sampling_ratio))
        precision = n_correct_segments / (self._K * self._n_videos)
        # QUIRK (reference f1.py:96): a task whose concatenated gt is a
        # single constant run has no boundaries -> ZeroDivisionError,
        # exactly as the reference; not guarded, parity over robustness
        recall = n_correct_segments / len(self.bound_masks)
        f1 = 2 * (precision * recall) / (precision + recall + self._eps)
        self.f1_scores.append(f1)
        self._n_true_seg_all += n_correct_segments

    def f1(self):
        self._finish_init()
        for _ in range(self.n_experiments):
            self._sampling()
        f1_mean = np.mean(self.f1_scores)
        self._n_true_seg_all /= self.n_experiments
        self._return["precision"] = [self._n_true_seg_all, self._K * self._n_videos]
        self._return["recall"] = [self._n_true_seg_all, len(self.bound_masks)]
        self._return["mean_f1"] = [f1_mean, 1]

    def stat(self):
        return self._return
