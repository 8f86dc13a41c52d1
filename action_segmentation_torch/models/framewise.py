"""Framewise classifiers.

Twin of the JAX package's ``models/framewise.py``:

* ``FramewiseDiscriminative`` — a feedforward per-frame tagger (the
  port's ``nn.MLP``) trained with the cross-entropy over the task's
  classes, one video a batch, by Adam with the norm clip and the plateau
  controller of ``models/base.py``;
* ``FramewiseGaussianMixture`` — per-class Gaussians from the
  sufficient statistics, with any of sklearn's four covariance types;
  prediction masks to the task's classes and takes the argmax of the
  posterior on the device;
* ``FramewiseBaseline`` — the majority class or a class sampled from
  the task's training histogram, on the host.

Every model lives on ``self.device`` (the card unless the caller passes
``device="cpu"``) and pickles onto the CPU (``models/base.DeviceModel``).
Predictions stay on the device until one copy at the end of ``predict``.
"""

from collections import Counter

import numpy as np
import torch

from action_segmentation_torch import BIG_NEG, resolve_device
from action_segmentation_torch.data.batching import iter_batches
from action_segmentation_torch.models import nn
from action_segmentation_torch.models.base import (
    DeviceModel,
    batch_generator,
    clip_grads,
    make_optimizer,
    set_lr,
    upload,
)
from action_segmentation_torch.ops.distributions import (
    fullcov_factors,
    gaussian_emission_log_probs,
    gaussian_emission_log_probs_diag,
    gaussian_emission_log_probs_fullcov,
)
from action_segmentation_torch.ops.stats import semimarkov_sufficient_stats
from action_segmentation_torch.utils.drain import DeferredLabelDrain

# the stats key of each --gm_covariance type
GM_COVARIANCE_KEYS = {
    "tied_diag": "gaussian_cov",
    "diag": "gaussian_cov_diag",
    "full": "gaussian_cov_full",
    "tied": "gaussian_cov_tied",
}


def feed_forward_args(parser):
    parser.add_argument("--ff_dropout_p", type=float, default=0.1)
    parser.add_argument("--ff_hidden_layers", type=int, default=0)
    parser.add_argument("--ff_hidden_dim", type=int, default=200)


def feed_forward_init(generator, args, input_dim, output_dim, device=None):
    """The tagger's MLP: linear without --ff_hidden_layers, else that many
    ReLU layers --ff_hidden_dim wide; torch's default init."""
    dims = [input_dim] + [args.ff_hidden_dim] * args.ff_hidden_layers + [output_dim]
    return nn.MLP(dims, generator, device=device)


def feed_forward_apply(mlp, x, dropout_p=0.0, generator=None):
    """The MLP over `x`, with inverted dropout on its input when
    `dropout_p` > 0 and a `generator` is given (training)."""
    if dropout_p > 0.0 and generator is not None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout_p
        x = torch.where(keep, x / (1.0 - dropout_p), 0.0)
    return mlp(x)


def mask_to_valid_classes(logits, valid_mask):
    """-inf over the classes outside `valid_mask` (framewise.py:37-44)."""
    return logits.masked_fill(~valid_mask, -torch.inf)


def masked_nll(logits, gt, mask):
    """Mean NLL of `gt` under the (masked) `logits` over the frames where
    `mask` holds. Padded frames are selected out, not multiplied out:
    their gt may be a class outside the task, whose -inf log-probability
    times 0 is a NaN."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, gt[..., None])[..., 0]
    nll = torch.where(mask, nll, 0.0)
    return nll.sum() / mask.sum().clamp(min=1)


def valid_class_mask(n_classes, task_indices):
    """(C,) bool: the classes of one task."""
    valid = np.zeros((n_classes,), bool)
    valid[np.asarray(task_indices)] = True
    return valid


def frame_mask(lengths, T):
    """(B, T) bool: the frames before each video's length."""
    return np.arange(T)[None, :] < np.asarray(lengths)[:, None]


def drained_predictions(drain):
    """{video: labels up to its length} from a drain of (names, lengths)
    batches: one copy off the device."""
    predictions = {}
    for (names, lengths), labels in drain.drain():
        for i, video in enumerate(names):
            predictions[video] = labels[i, : int(lengths[i])]
    return predictions


def epoch_loss(losses):
    """The epoch's mean batch loss in float64, from one fetch."""
    return float(np.mean(torch.stack(losses).cpu().numpy(), dtype=np.float64))


class FramewiseDiscriminative(DeviceModel):
    @classmethod
    def add_args(cls, parser):
        feed_forward_args(parser)

    @classmethod
    def from_args(cls, args, train_data, device=None):
        return cls(args, train_data, device)

    def __init__(self, args, train_data, device=None):
        self.args = args
        self.device = resolve_device(device)
        self.n_classes = train_data._corpus.n_classes
        self.mlp = feed_forward_init(
            torch.Generator().manual_seed(getattr(args, "seed", 0) or 0), args,
            train_data.feature_dim, self.n_classes, self.device,
        )

    def _inputs(self, batch):
        """(features, the first video's task's classes) on the device."""
        return (
            upload(batch["features"], self.device),
            upload(valid_class_mask(self.n_classes, batch["task_indices"][0]), self.device),
        )

    def loss(self, batch, generator=None):
        """One batch's masked NLL, with dropout when a generator is given."""
        feats, valid = self._inputs(batch)
        mask = frame_mask(batch["lengths"], feats.shape[1])
        logits = feed_forward_apply(self.mlp, feats, self.args.ff_dropout_p, generator)
        return masked_nll(mask_to_valid_classes(logits, valid),
                          upload(batch["gt_single"], self.device), upload(mask, self.device))

    def fit(self, train_data, use_labels, callback_fn=None):
        """Adam over the videos one at a time, shuffled with seed
        (--seed or 1) + epoch; the dropout mask of each step from a
        generator seeded from (--seed, epoch, batch)."""
        assert use_labels
        args = self.args
        params = list(self.mlp.parameters())
        optimizer, scheduler = make_optimizer(args, params)
        seed = getattr(args, "seed", 1) or 1
        for epoch in range(args.epochs):
            losses = []
            for batch_ix, batch in enumerate(iter_batches(
                train_data, batch_size=1, batch_by_task=False, shuffle=True, seed=seed + epoch,
            )):
                generator = None
                if args.ff_dropout_p > 0.0:
                    generator = batch_generator(getattr(args, "seed", 0), epoch, batch_ix,
                                                self.device)
                loss = self.loss(batch, generator)
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
            feats, valid = self._inputs(batch)
            logits = mask_to_valid_classes(feed_forward_apply(self.mlp, feats), valid)
            drain.add((batch["video_name"], batch["lengths"]), torch.argmax(logits, dim=-1))
        return drained_predictions(drain)


class FramewiseGaussianMixture(DeviceModel):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument(
            "--gm_covariance",
            choices=["full", "diag", "tied", "tied_diag"],
            default="tied_diag",
        )

    @classmethod
    def from_args(cls, args, train_data, device=None):
        return cls(args, train_data._corpus.n_classes, train_data.feature_dim, device)

    def __init__(self, args, n_classes, feature_dim, device=None):
        self.args = args
        self.device = resolve_device(device)
        self.n_classes = n_classes
        self.feature_dim = feature_dim
        self.means = None
        self.cov = None
        self.log_priors = None

    @property
    def covariance_type(self):
        return getattr(self.args, "gm_covariance", "tied_diag")

    def fit(self, train_data, use_labels, callback_fn=None):
        """Closed form: the class means and the covariance of
        --gm_covariance from the sufficient statistics (sklearn's
        hard-assignment moments), and the log class priors (BIG_NEG for a
        class with no frames)."""
        feature_list, label_list = [], []
        for batch in iter_batches(
            train_data, batch_size=1, batch_by_task=False, shuffle=False, bucket=False
        ):
            L = int(batch["lengths"][0])
            feature_list.append(batch["features"][0, :L])
            label_list.append(batch["gt_single"][0, :L])
        stats = semimarkov_sufficient_stats(
            feature_list, label_list, n_classes=self.n_classes, max_k=100,
            covariance_type=self.covariance_type,
        )
        counts = np.zeros(self.n_classes)
        for labels in label_list:
            np.add.at(counts, labels, 1.0)
        with np.errstate(divide="ignore"):
            log_priors = np.log(counts / counts.sum())
        log_priors[~np.isfinite(log_priors)] = BIG_NEG
        self.means = upload(stats["gaussian_means"], self.device)
        self.cov = upload(stats[GM_COVARIANCE_KEYS[self.covariance_type]], self.device)
        self.log_priors = upload(log_priors.astype(np.float32), self.device)

    def log_likelihoods(self, features, factors=None):
        """(T, C) emission log-likelihoods of one video's (T, D) features
        under --gm_covariance; `factors` are ``fullcov_factors`` of the
        full types, computed once per predict."""
        kind = self.covariance_type
        if kind == "tied_diag":
            return gaussian_emission_log_probs(features, self.means, self.cov)
        if kind == "diag":
            return gaussian_emission_log_probs_diag(features, self.means, self.cov)
        return gaussian_emission_log_probs_fullcov(features, self.means, self.cov, factors)

    @torch.no_grad()
    def predict(self, test_data):
        """Each frame's argmax of the log posterior over its video's task's
        classes. The per-class full covariance scores only those classes
        (whitening all 342 classes of the CrossTask model is 18 times the
        work): each class's score is its own GEMM, and the argmax over the
        task's classes in class order is the masked argmax over all of
        them, ties and NaNs included. Each task's factors are computed
        once a call."""
        kind = self.covariance_type
        tied = fullcov_factors(self.means, self.cov) if kind == "tied" else None
        by_task = {}
        drain = DeferredLabelDrain()
        for batch in iter_batches(test_data, batch_size=1, batch_by_task=False, shuffle=False):
            feats = upload(batch["features"][0], self.device)
            if kind == "full":
                classes = tuple(np.unique(batch["task_indices"][0]))
                if classes not in by_task:
                    idx = upload(np.array(classes, np.int64), self.device)
                    by_task[classes] = idx, fullcov_factors(self.means[idx], self.cov[idx])
                idx, factors = by_task[classes]
                logp = gaussian_emission_log_probs_fullcov(feats, None, None, factors)
                labels = idx[torch.argmax(logp + self.log_priors[idx], dim=-1)]
            else:
                valid = upload(valid_class_mask(self.n_classes, batch["task_indices"][0]),
                               self.device)
                logp = mask_to_valid_classes(self.log_likelihoods(feats, tied) + self.log_priors,
                                             valid)
                labels = torch.argmax(logp, dim=-1)
            drain.add((batch["video_name"], batch["lengths"]), labels[None])
        return drained_predictions(drain)


class FramewiseBaseline(DeviceModel):
    """Per-task class histograms on the host. Sampling draws from numpy's
    global stream, as the JAX package does, so the two packages' runs
    can be compared."""

    @classmethod
    def add_args(cls, parser):
        parser.add_argument(
            "--framewise_baseline_type",
            choices=["majority_class", "sample_class_distribution"],
        )

    @classmethod
    def from_args(cls, args, train_data, device=None):
        return cls(args, train_data, device)

    def __init__(self, args, train_data, device=None):
        self.args = args
        self.device = resolve_device(device)
        self.n_classes = train_data._corpus.n_classes
        self.class_histograms_by_task = {}

    def fit(self, train_data, use_labels, callback_fn=None):
        assert use_labels
        for batch in iter_batches(
            train_data, batch_size=1, batch_by_task=False, shuffle=True, bucket=False
        ):
            L = int(batch["lengths"][0])
            self.class_histograms_by_task.setdefault(batch["task_name"][0], Counter()).update(
                batch["gt_single"][0, :L].tolist()
            )

    def predict(self, test_data):
        predictions = {}
        probs_by_task = {}
        classes_by_task = {}
        for task, task_distr in self.class_histograms_by_task.items():
            classes, counts = zip(*task_distr.most_common())
            classes_by_task[task] = classes
            probs_by_task[task] = np.array(counts, float) / sum(counts)
        for batch in iter_batches(
            test_data, batch_size=1, batch_by_task=False, shuffle=False, bucket=False
        ):
            task = batch["task_name"][0]
            T = int(batch["lengths"][0])
            if self.args.framewise_baseline_type == "majority_class":
                class_pred, _ = self.class_histograms_by_task[task].most_common()[0]
                preds = np.full(T, class_pred, np.int64)
            else:
                assert self.args.framewise_baseline_type == "sample_class_distribution"
                pred_indices = np.random.multinomial(1, probs_by_task[task], size=T).argmax(axis=1)
                preds = np.array([classes_by_task[task][ix] for ix in pred_indices])
            predictions[batch["video_name"][0]] = preds
        return predictions
