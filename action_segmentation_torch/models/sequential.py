"""Sequential models.

Twin of the JAX package's ``models/sequential.py``:

* ``SequentialDiscriminative`` — a BiLSTM frame tagger (``models/rnn``'s
  ``LSTMEncoder``, then a linear head) trained with the masked
  cross-entropy, on the device;
* ``SequentialCanonicalBaseline`` — each task's steps in canonical
  order with uniform durations (sequential.py:147-235);
* ``SequentialPredictConstraints`` — the narration constraints decoded
  directly (sequential.py:32-106);
* ``SequentialGroundTruth`` — the oracle (sequential.py:108-145).

The last three run on the host; every model carries ``self.device``
and pickles onto the CPU (``models/base.DeviceModel``).
"""

import numpy as np
import torch
from torch import nn

from action_segmentation_torch import resolve_device
from action_segmentation_torch.data.batching import iter_batches
from action_segmentation_torch.models.base import (
    DeviceModel,
    clip_grads,
    make_optimizer,
    set_lr,
    upload,
)
from action_segmentation_torch.models.framewise import (
    drained_predictions,
    epoch_loss,
    frame_mask,
    mask_to_valid_classes,
    masked_nll,
    valid_class_mask,
)
from action_segmentation_torch.models.nn import linear
from action_segmentation_torch.models.rnn import LSTMEncoder
from action_segmentation_torch.utils.drain import DeferredLabelDrain


def encoder_args(parser):
    parser.add_argument("--seq_num_layers", type=int, default=2)


class SequentialTagger(nn.Module):
    """BiLSTM of ``hidden // 2`` units a direction, then a linear head to
    the classes. State dict: ``encoder.encoder.*`` (the nn.LSTM) and
    ``proj.*``."""

    def __init__(self, input_dim, hidden, n_classes, num_layers, generator, device=None):
        super().__init__()
        self.encoder = LSTMEncoder(input_dim, hidden // 2, generator, num_layers=num_layers,
                                   device=device)
        self.proj = linear(hidden, n_classes, generator, device=device)

    def forward(self, features, lengths, valid_mask):
        """features (B, T, D), lengths (B,) on the CPU, valid_mask (C,) ->
        (B, T, C) logits, -inf outside the valid classes."""
        return mask_to_valid_classes(self.proj(self.encoder(features, lengths)), valid_mask)


class SequentialDiscriminative(DeviceModel):
    @classmethod
    def add_args(cls, parser):
        encoder_args(parser)
        parser.add_argument("--seq_hidden_size", type=int, default=200)

    @classmethod
    def from_args(cls, args, train_data, device=None):
        return cls(args, train_data, device)

    def __init__(self, args, train_data, device=None):
        assert args.seq_hidden_size % 2 == 0
        self.args = args
        self.device = resolve_device(device)
        self.n_classes = train_data._corpus.n_classes
        self.tagger = SequentialTagger(
            train_data.feature_dim, args.seq_hidden_size, self.n_classes,
            args.seq_num_layers, torch.Generator().manual_seed(getattr(args, "seed", 0) or 0),
            self.device,
        )

    def _logits(self, batch):
        """A batch's logits, masked to its FIRST video's task's classes
        (sequential.py:107-108), as the JAX package does."""
        valid = valid_class_mask(self.n_classes, batch["task_indices"][0])
        return self.tagger(upload(batch["features"], self.device),
                           torch.from_numpy(np.asarray(batch["lengths"], np.int64)),
                           upload(valid, self.device))

    def loss(self, batch):
        mask = frame_mask(batch["lengths"], batch["features"].shape[1])
        return masked_nll(self._logits(batch), upload(batch["gt_single"], self.device),
                          upload(mask, self.device))

    def fit(self, train_data, use_labels, callback_fn=None):
        """Adam over batches of --batch_size videos, shuffled with seed
        (--seed or 1) + epoch."""
        assert use_labels
        args = self.args
        assert args.batch_accumulation <= 1
        params = list(self.tagger.parameters())
        optimizer, scheduler = make_optimizer(args, params)
        seed = getattr(args, "seed", 1) or 1
        for epoch in range(args.epochs):
            losses = []
            for batch in iter_batches(train_data, batch_size=args.batch_size,
                                      batch_by_task=False, shuffle=True, seed=seed + epoch):
                loss = self.loss(batch)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_grads(params, args.max_grad_norm)
                optimizer.step()
                losses.append(loss.detach())
            train_loss = epoch_loss(losses)
            if scheduler is not None:
                set_lr(optimizer, scheduler.step(train_loss))
            if callback_fn:
                callback_fn(epoch, {"train_loss": train_loss})

    @torch.no_grad()
    def predict(self, test_data):
        drain = DeferredLabelDrain()
        for batch in iter_batches(test_data, batch_size=1, batch_by_task=False, shuffle=False):
            drain.add((batch["video_name"], batch["lengths"]),
                      torch.argmax(self._logits(batch), dim=-1))
        return drained_predictions(drain)


class _CrosstaskStepMixin:
    def _init_step_indices(self, args, train_data, device):
        from action_segmentation_torch.data.crosstask import CrosstaskDatasplit

        assert isinstance(train_data, CrosstaskDatasplit)
        self.args = args
        self.device = resolve_device(device)
        self.n_classes = train_data._corpus.n_classes
        self.remove_background = train_data.remove_background
        corpus = train_data.corpus
        # step labels through get_label, so --task_specific_steps works too
        # (the reference indexes bare step names, sequential.py:51)
        self.ordered_nonbackground_indices_by_task = {
            task_id: [corpus.label2index[corpus.get_label(task_id, step)]
                      for step in task.steps]
            for task_id, task in train_data._tasks_by_id.items()
        }
        backgrounds = set(corpus._background_indices)
        self.background_indices_by_task = {
            task_id: sorted(ix for ix in corpus.indices_by_task(task_id) if ix in backgrounds)
            for task_id in train_data._tasks_by_id
        }


class SequentialCanonicalBaseline(DeviceModel, _CrosstaskStepMixin):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument(
            "--canonical_baseline_background_fraction", type=float, default=0.0
        )

    @classmethod
    def from_args(cls, args, train_data, device=None):
        return cls(args, train_data, device)

    def __init__(self, args, train_data, device=None):
        self._init_step_indices(args, train_data, device)
        assert all(len(v) == 1 for v in self.background_indices_by_task.values())

    def fit(self, train_data, use_labels, callback_fn=None):
        pass

    def predict_single(self, task_id, num_timesteps):
        """Uniform-duration canonical ordering (sequential.py:178-217)."""
        if self.remove_background:
            num_background_frames = 0
        else:
            num_background_frames = int(
                num_timesteps * self.args.canonical_baseline_background_fraction
            )
            background_index = self.background_indices_by_task[task_id][0]
        nonbackground_indices = self.ordered_nonbackground_indices_by_task[task_id]
        if not self.remove_background:
            assert num_timesteps >= len(nonbackground_indices)
        num_nonbackground_frames = max(
            num_timesteps - num_background_frames, len(nonbackground_indices)
        )
        step_duration = num_nonbackground_frames // len(nonbackground_indices)
        assert step_duration >= 1
        if self.remove_background or num_background_frames == 0:
            background_duration = 0
            pad = nonbackground_indices[-1]
        else:
            background_duration = (
                num_timesteps - step_duration * len(nonbackground_indices)
            ) // (len(nonbackground_indices) + 1)
            assert background_duration >= 0
            pad = background_index
        indices = []
        for step_ix in nonbackground_indices:
            if not self.remove_background:
                indices.extend([background_index] * background_duration)
            indices.extend([step_ix] * step_duration)
        indices.extend([pad] * (num_timesteps - len(indices)))
        return indices[:num_timesteps]

    def predict(self, test_data):
        predictions = {}
        for batch in iter_batches(
            test_data, batch_size=1, batch_by_task=False, shuffle=False, bucket=False
        ):
            predictions[batch["video_name"][0]] = self.predict_single(
                batch["task_name"][0], int(batch["lengths"][0])
            )
        return predictions


class SequentialPredictConstraints(DeviceModel, _CrosstaskStepMixin):
    @classmethod
    def add_args(cls, parser):
        pass

    @classmethod
    def from_args(cls, args, train_data, device=None):
        return cls(args, train_data, device)

    def __init__(self, args, train_data, device=None):
        self._init_step_indices(args, train_data, device)
        assert all(len(v) == 1 for v in self.background_indices_by_task.values())
        self.canonical = (
            SequentialCanonicalBaseline(args, train_data, device)
            if train_data.remove_background
            else None
        )

    def fit(self, train_data, use_labels, callback_fn=None):
        pass

    def predict(self, test_data):
        predictions = {}
        for batch in iter_batches(
            test_data, batch_size=1, batch_by_task=False, shuffle=False, bucket=False
        ):
            task = batch["task_name"][0]
            T = int(batch["lengths"][0])
            constraints = batch["constraints"][0, :T]
            step_indices = self.ordered_nonbackground_indices_by_task[task]
            preds = np.array([step_indices[ix] for ix in constraints.argmax(axis=1)], np.int64)
            no_constraint = constraints.sum(axis=1) == 0
            if not test_data.remove_background:
                preds[no_constraint] = self.background_indices_by_task[task][0]
            else:
                baseline_preds = self.canonical.predict_single(task, T)
                for ix in np.flatnonzero(no_constraint):
                    preds[ix] = baseline_preds[ix]
            predictions[batch["video_name"][0]] = preds
        return predictions


class SequentialGroundTruth(DeviceModel):
    @classmethod
    def add_args(cls, parser):
        pass

    @classmethod
    def from_args(cls, args, train_data, device=None):
        return cls(args, train_data, device)

    def __init__(self, args, train_data, device=None):
        self.args = args
        self.device = resolve_device(device)
        self.n_classes = train_data._corpus.n_classes

    def fit(self, train_data, use_labels, callback_fn=None):
        pass

    def predict(self, test_data):
        predictions = {}
        for batch in iter_batches(
            test_data, batch_size=1, batch_by_task=False, shuffle=False, bucket=False
        ):
            T = int(batch["lengths"][0])
            predictions[batch["video_name"][0]] = batch["gt_single"][0, :T].tolist()
        return predictions
