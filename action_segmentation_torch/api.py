"""High-level inference API.

A thin serving surface over a fitted ``SemiMarkovModel``: segment raw
feature arrays without constructing corpora. Decoding batches videos,
pads to length buckets, and runs the decode kernels on the card.

Example:
    seg = Segmenter(model)
    labels = seg.segment(features)              # (T, D) -> (T,) int labels
    batches = seg.segment_many([f1, f2, ...])   # list of (T_i, D)
    labels, marginals = seg.segment_with_marginals(features)

A model trained with canonical-order constraints decodes with the same
per-video end masks as ``predict`` (``Segmenter(model, valid_classes,
task=...)``). ``Segmenter.load(path, device=...)`` serves a model the
command line pickled (``--model_output_path``), on the card unless the
caller asks for the CPU.
"""

import numpy as np
import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.checkpoint import load_pickle
from action_segmentation_torch.data.batching import pad_length_to_bucket
from action_segmentation_torch.models.semimarkov import SemiMarkovModel, upload
from action_segmentation_torch.ops.hsmm import hsmm_frame_marginals
from action_segmentation_torch.ops.hsmm_cuda import kernel_path
from action_segmentation_torch.ops.hsmm_grad import (
    centre_emissions,
    hsmm_frame_marginals_fast,
)
from action_segmentation_torch.utils.drain import DeferredLabelDrain


class Segmenter:
    """Serving wrapper around a fitted SemiMarkovModel."""

    def __init__(self, model, valid_classes=None, task=None):
        assert isinstance(model, SemiMarkovModel), type(model)
        self.model = model
        if valid_classes is None:
            valid_classes = np.arange(model.n_classes, dtype=np.int64)
        self.valid_classes = np.asarray(valid_classes, np.int64)
        # a model with canonical-order constraints decodes with predict()'s
        # end masks, whose short-video exception (a video shorter than
        # its step sequence may end mid-order) is per task and per length
        allowed_ends = model.module.allowed_ends
        self._task = task
        self._per_video_ends = (
            allowed_ends is not None and model.ordered_indices_by_task is not None
        )
        if self._per_video_ends and task is None:
            raise ValueError(
                "this model was trained with canonical-ordering constraints; "
                "Segmenter needs task=<task name> to build the per-video end "
                "masks predict() uses"
            )
        self._end_row = np.zeros(len(self.valid_classes), np.float32)
        if allowed_ends is not None:
            mask = np.isin(self.valid_classes, sorted(allowed_ends))
            if not self._per_video_ends and not mask.any():
                raise ValueError(
                    "no allowed end classes within valid_classes: every decode "
                    "would argmax over BIG_NEG-saturated scores"
                )
            self._end_row = np.where(mask, 0.0, BIG_NEG).astype(np.float32)

    @classmethod
    def load(cls, path, valid_classes=None, device=None):
        """A Segmenter over the model pickled at `path`, put on `device`
        (None: the card, which raises when no card is present)."""
        return cls(load_pickle(path, device=device), valid_classes=valid_classes)

    def _end_rows(self, lengths):
        """(B, C) end masks, the rows predict() builds."""
        if self._per_video_ends:
            return np.stack([
                self.model._end_mask_row(self.valid_classes, self._task, L)
                for L in lengths
            ])
        return np.broadcast_to(self._end_row, (len(lengths), len(self.valid_classes))).copy()

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
            labels, _ = model._decode(
                upload(feats, device), upload(lengths, device), vc, cons,
                upload(self._end_rows(lengths), device),
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

    def segment_with_marginals(self, features):
        """Segment one (T, D) array and return posterior frame marginals.

        Returns (labels (T,), marginals (T, n_classes)): marginals[t, c]
        is the posterior probability that frame t belongs to GLOBAL class
        c under the HSMM (zero for classes outside this segmenter's valid
        set), d logZ / d emit through the kernel forward/backward pair
        (ops/hsmm_grad.py) over emissions centred frame by frame. Labels
        come from the decode kernels, as in ``segment_many``, on the same
        potentials (a compound model's z at its mean).
        """
        model = self.model
        device = model.device
        features = np.asarray(features, np.float32)
        T, D = features.shape
        feats = np.zeros((1, pad_length_to_bucket(T), D), np.float32)
        feats[0, :T] = features
        C = len(self.valid_classes)
        feats = upload(feats, device)
        lengths = upload(np.array([T], np.int32), device)
        vc = upload(self.valid_classes, device)
        cons = torch.zeros(feats.shape[:2] + (C,), dtype=torch.float32, device=device)
        ends = upload(self._end_rows([T]), device)
        labels, _ = model._decode(feats, lengths, vc, cons, ends)
        with torch.no_grad():
            pots, _, _ = model.module.compute_potentials(feats, lengths, vc, cons, ends)
        # the marginals gate on the segmenter's width, as JAX's do
        marginals_fn = (
            hsmm_frame_marginals_fast if kernel_path(C, C, device).partition == "kernels"
            else hsmm_frame_marginals
        )
        # the same posteriors, without float32's cancellation in the DP's
        # prefix sums of emissions
        marg_sub = marginals_fn(centre_emissions(pots, lengths)[0], lengths)
        # scatter the subset's columns into global class ids, like labels
        marg = np.zeros((T, model.n_classes), np.float32)
        marg[:, self.valid_classes] = marg_sub[0, :T].cpu().numpy()
        return labels[0, :T].cpu().numpy(), marg
