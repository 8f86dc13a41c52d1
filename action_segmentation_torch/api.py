"""High-level inference API.

A thin serving surface over a fitted ``SemiMarkovModel``: segment raw
feature arrays without constructing corpora. Decoding batches videos,
pads to length buckets, and runs the decode kernels on the card.

Example:
    seg = Segmenter(model)
    labels = seg.segment(features)              # (T, D) -> (T,) int labels
    batches = seg.segment_many([f1, f2, ...])   # list of (T_i, D)

Loading a pickled model, ``segment_with_marginals`` and the per-task end
masks of constrained models come with later slices (ROADMAP.md §1).
"""

import numpy as np
import torch

from action_segmentation_torch.data.batching import pad_length_to_bucket
from action_segmentation_torch.models.semimarkov import SemiMarkovModel, upload
from action_segmentation_torch.utils.drain import DeferredLabelDrain


class Segmenter:
    """Serving wrapper around a fitted SemiMarkovModel."""

    def __init__(self, model, valid_classes=None):
        assert isinstance(model, SemiMarkovModel), type(model)
        self.model = model
        if valid_classes is None:
            valid_classes = np.arange(model.n_classes, dtype=np.int64)
        self.valid_classes = np.asarray(valid_classes, np.int64)

    def segment_many(self, feature_list, batch_size=16):
        """Segment a list of (T_i, D) float arrays -> list of (T_i,) labels.

        Videos are sorted by length and batched; every batch is launched
        without waiting for the previous one, its labels stay on the
        device, and all labels come back in ONE stacked copy at the end.
        Keep batch_size large: the scan kernel runs one block per video
        and direction, so small batches leave most of the card idle.
        """
        model = self.model
        device = model.device
        order = np.argsort([f.shape[0] for f in feature_list])
        C = len(self.valid_classes)
        vc = upload(self.valid_classes, device)

        drain = DeferredLabelDrain()
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            lengths = np.array([feature_list[i].shape[0] for i in idxs], np.int32)
            Tpad = pad_length_to_bucket(int(lengths.max()))
            D = feature_list[idxs[0]].shape[1]
            feats = np.zeros((len(idxs), Tpad, D), np.float32)
            for row, i in enumerate(idxs):
                feats[row, : lengths[row]] = feature_list[i]
            cons = torch.zeros((len(idxs), Tpad, C), dtype=torch.float32, device=device)
            ends = torch.zeros((len(idxs), C), dtype=torch.float32, device=device)
            labels, _ = model._decode(
                upload(feats, device), upload(lengths, device), vc, cons, ends
            )
            drain.add((idxs, lengths), labels)

        results = {}
        for (idxs, lengths), labels in drain.drain():
            for r, i in enumerate(idxs):
                results[i] = labels[r, : lengths[r]]
        return [results[i] for i in range(len(feature_list))]

    def segment(self, features):
        """Segment one (T, D) float array -> (T,) int labels."""
        return self.segment_many([np.asarray(features)])[0]
